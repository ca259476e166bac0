"""The port's warm-started Darcy misfit (``DarcyMisfitWarm``, plain version)
against ``darcy.make_batched_misfit_warm``: (Φ, x) from a zero start and
from a previous solution, for the Jacobi, ``dst_trunc`` and dense ``dst``
preconditioners; and the dense apply against ``_flat_dst_preconditioner``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ip_mcmc_tpu.models import darcy as jdarcy
from ip_mcmc_tpu_torch.convert import darcy_warm_misfit_from_arrays
from ip_mcmc_tpu_torch.models import darcy
from test_torch_darcy import _aux_pair, _data, _draws, assert_bf16_agreement

torch.set_num_threads(1)

# (precond, cg_iters, precond_modes); dst_trunc-64 at 4 iterations is the
# shipped darcy_pcn_warm misfit
CASES = {"jacobi": ("jacobi", 8, 128), "dst_trunc": ("dst_trunc", 4, 64),
         "dst": ("dst", 4, 128)}
JAX_PRECONDS = ("_flat_dst_preconditioner", "_flat_truncated_dst_preconditioner")


def _both(case, n=16):
    precond, iters, modes = CASES[case]
    aux_j, aux_t = _aux_pair(n, None)
    y, noise = _data()
    phi_j, aux_dim_j = jdarcy.make_batched_misfit_warm(
        aux_j, y, noise, cg_iters=iters, precond=precond, precond_modes=modes)
    phi_t, aux_dim_t = darcy_warm_misfit_from_arrays(
        aux_t, y, noise, cg_iters=iters, precond=precond, precond_modes=modes)
    assert aux_dim_t == aux_dim_j == n * n == phi_t.aux_dim
    return jax.jit(phi_j), phi_t


def _f32_factors(monkeypatch, phi_t):
    """f32 preconditioner factors on both sides."""
    for name in JAX_PRECONDS:
        orig = getattr(jdarcy, name)
        monkeypatch.setattr(
            jdarcy, name,
            lambda *a, _orig=orig, **kw: _orig(
                *a, **{**kw, "precond_dtype": jnp.float32}),
        )
    n = phi_t.n
    if phi_t.precond == "dst_trunc":
        phi_t.V = torch.tensor(darcy.truncated_dst_modes(n, phi_t.modes)[0],
                               dtype=torch.float32)
    if phi_t.precond == "dst":
        phi_t.S = torch.tensor(darcy.dst_factors(n)[0], dtype=torch.float32)


def _two_calls(phi_j, phi_t, U):
    """(Φ, x) from x0 = 0, then from the first call's x on nearby
    coefficients (a pCN-sized move), on both sides."""
    zeros = np.zeros((phi_t.aux_dim, U.shape[1]), np.float32)
    U2 = (np.sqrt(1 - 0.08 ** 2) * U + 0.08 * _draws(seed=3)).astype(np.float32)
    pj1, xj1 = phi_j(jnp.asarray(U), jnp.asarray(zeros))
    pj2, xj2 = phi_j(jnp.asarray(U2), xj1)
    pt1, xt1 = phi_t(torch.from_numpy(U), torch.from_numpy(zeros))
    pt2, xt2 = phi_t(torch.from_numpy(U2), torch.tensor(np.asarray(xj1)))
    want = [np.asarray(v) for v in (pj1, xj1, pj2, xj2)]
    got = [v.numpy() for v in (pt1, xt1, pt2, xt2)]
    return got, want


@pytest.mark.parametrize("case", sorted(CASES))
def test_warm_misfit_f32_factors_match_jax(case, monkeypatch):
    """Every input f32 (Jacobi, or f32 factors on both sides): all draws
    agree to f32 summation-order rounding, Φ within rtol 1e-5 and the
    solution within 1e-5 of its largest cell."""
    phi_j, phi_t = _both(case)
    _f32_factors(monkeypatch, phi_t)
    got, want = _two_calls(phi_j, phi_t, _draws())
    for k in (0, 2):
        assert np.isfinite(got[k]).all()
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5)
    for k in (1, 3):
        assert got[k].shape == want[k].shape == (256, 128)
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=1e-5 * np.abs(want[k]).max())
    # the warm start matters: the second call differs from a cold one
    cold = phi_t(torch.from_numpy(_draws()), torch.zeros(256, 128))[0].numpy()
    assert not np.allclose(cold, got[2], rtol=1e-3)


@pytest.mark.parametrize("case", ["dst_trunc", "dst"])
def test_warm_misfit_bf16_factors_match_jax(case):
    """bf16 factors: an ulp-level difference in summation order flips a
    bf16 rounding of a preconditioner input on some draws (the f32-factor
    test above checks the arithmetic). The warm call, which starts near
    its solution, meets the bounds of test_torch_darcy.py (measured: median
    ≤ 3.3e-7, ≥ 90% within 1e-5, max 8.7e-5). The call from x0 = 0 stops 4
    iterations into an unconverged solve, where a flip is not damped
    (measured on 2 × 128 draws: median ≤ 5e-6, ≥ 63% within 1e-5, ≥ 94%
    within 1e-4, max 7e-4): median ≤ 2e-5, ≥ 90% within 1e-4, all 5e-3."""
    phi_j, phi_t = _both(case)
    got, want = _two_calls(phi_j, phi_t, _draws())
    rel = np.abs(got[0] - want[0]) / np.abs(want[0])
    assert np.median(rel) <= 2e-5
    assert (rel <= 1e-4).mean() >= 0.90
    assert rel.max() <= 5e-3
    assert_bf16_agreement(got[2], want[2])
    for k, median in ((1, 2e-5), (3, 2e-6)):
        err = np.abs(got[k] - want[k]).max(axis=0) / np.abs(want[k]).max(axis=0)
        assert np.median(err) <= median and err.max() <= 5e-3


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_dst_apply_matches_jax(dtype):
    """The row/column sine transforms against the Kronecker-factor matmuls
    of ``_flat_dst_preconditioner`` on the unit vectors (a = 1, so ā = 1)."""
    n = 8
    _, aux_t = _aux_pair(n, None)
    phi_t, _ = darcy_warm_misfit_from_arrays(aux_t, *_data(), precond="dst")
    eye = np.eye(n * n, dtype=np.float32)
    inv_m = jdarcy._flat_dst_preconditioner(
        n, jnp.ones((n * n, n * n), jnp.float32),
        precond_dtype=getattr(jnp, dtype))
    want = np.asarray(inv_m(jnp.asarray(eye)))
    if dtype == "float32":
        phi_t.S = torch.tensor(darcy.dst_factors(n)[0], dtype=torch.float32)
    got = phi_t._precond_dst(torch.from_numpy(eye), torch.ones(n * n)).numpy()
    tol = 1e-6 if dtype == "float32" else 2e-3  # bf16: rounding flips
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())
    if dtype == "float32":  # M⁻¹ is symmetric up to the roundings
        np.testing.assert_allclose(got, got.T, rtol=0,
                                   atol=tol * np.abs(want).max())


def test_warm_misfit_rejects_bad_input():
    _, aux_t = _aux_pair(8, None)
    phi_t, aux_dim = darcy_warm_misfit_from_arrays(aux_t, *_data(), cg_iters=2)
    U = torch.zeros(64, 4)
    with pytest.raises(ValueError, match="x0"):
        phi_t(U, torch.zeros(aux_dim, 3))
    with pytest.raises(ValueError, match="precond"):
        darcy_warm_misfit_from_arrays(aux_t, *_data(), precond="multigrid")
