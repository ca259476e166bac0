"""The port's Darcy pieces (ip_mcmc_tpu_torch/models) against the JAX
package's: KL basis and aux constants, preconditioner modes, and the
batched misfit's plain version against ``darcy.make_batched_misfit``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ip_mcmc_tpu.models import darcy as jdarcy
from ip_mcmc_tpu.models import kl as jkl
from ip_mcmc_tpu_torch.configs import FIXTURE
from ip_mcmc_tpu_torch.convert import darcy_misfit_from_arrays
from ip_mcmc_tpu_torch.models import darcy, kl

torch.set_num_threads(1)

OBS_COARSE = np.load(FIXTURE)["obs_coarse"]  # the 8x8 surrogate's cells
# (n_grid, obs, cg_iters, precond_modes): the exact and surrogate misfits
# of darcy_da_fused
SLICE_SPECS = {"exact16": (16, None, 12, 128), "surrogate8": (8, OBS_COARSE, 3, 64)}


def _aux_pair(n, obs):
    _, aux_j = jdarcy.make_darcy_forward(
        n_grid=n, n_modes_per_dim=8, alpha=2.0, field_scale=10.0, obs_indices=obs
    )
    return aux_j, darcy.darcy_aux(n_grid=n, n_modes_per_dim=8, alpha=2.0,
                                  field_scale=10.0, obs_indices=obs)


def _draws(seed=0, n=64):
    """64 prior draws plus the same draws scaled 3x (rougher fields)."""
    U = np.random.default_rng(seed).standard_normal((64, n)).astype(np.float32)
    return np.concatenate([U, 3.0 * U], axis=1)


def _data(n_obs=16, seed=1):
    r = np.random.default_rng(seed)
    y = (0.05 + 0.01 * r.standard_normal(n_obs)).astype(np.float32)
    noise = (0.002 + 0.001 * r.random(n_obs)).astype(np.float32)
    return y, noise


def _both(n, obs, cg_iters, precond, modes, source=None):
    aux_j, aux_t = _aux_pair(n, obs)
    if source is not None:
        aux_j = {**aux_j, "source": jnp.asarray(source)}
        aux_t = {**aux_t, "source": source}
    y, noise = _data()
    phi_j = jax.jit(jdarcy.make_batched_misfit(
        aux_j, y, noise, cg_iters=cg_iters, precond=precond, precond_modes=modes))
    phi_t = darcy_misfit_from_arrays(aux_t, y, noise, cg_iters=cg_iters,
                                     precond=precond, precond_modes=modes)
    return phi_j, phi_t


def test_kl_basis_matches_jax():
    b_j, ij_j = jkl.sine_basis_2d(8, 16)
    b_t, ij_t = kl.sine_basis_2d(8, 16)
    np.testing.assert_allclose(b_t, b_j, rtol=1e-6, atol=1e-12)
    np.testing.assert_array_equal(ij_t, ij_j)
    np.testing.assert_allclose(
        kl.laplacian_eigenvalues_2d(ij_t, alpha=2.0, scale=10.0),
        jkl.laplacian_eigenvalues_2d(ij_j, alpha=2.0, scale=10.0), rtol=1e-6,
    )


@pytest.mark.parametrize("spec", sorted(SLICE_SPECS))
def test_aux_matches_jax(spec):
    n, obs, _, _ = SLICE_SPECS[spec]
    aux_j, aux_t = _aux_pair(n, obs)
    np.testing.assert_allclose(aux_t["scaled_basis"],
                               np.asarray(aux_j["scaled_basis"]), rtol=1e-6)
    np.testing.assert_allclose(aux_t["eigenvalues"],
                               np.asarray(aux_j["eigenvalues"]), rtol=1e-6)
    np.testing.assert_array_equal(aux_t["obs_indices"],
                                  np.asarray(aux_j["obs_indices"]))
    np.testing.assert_allclose(aux_t["source"], np.asarray(aux_j["source"]))
    assert aux_t["n_grid"] == aux_j["n_grid"]


@pytest.mark.parametrize("n,k_modes", [(16, 128), (8, 64)])
def test_dst_modes_match_jax(n, k_modes):
    """V and λ: the JAX preconditioner at a = 1, D⁻¹ = 0 and f32 factors
    applies Vᵀ diag(1/λ) V; build that operator from the port's modes."""
    a = jnp.ones((n * n, n * n), jnp.float32)
    inv_m = jdarcy._flat_truncated_dst_preconditioner(
        n, a, jnp.zeros_like(a), k_modes, precond_dtype=jnp.float32)
    op_j = np.asarray(inv_m(jnp.eye(n * n, dtype=jnp.float32)))
    V, lam = darcy.truncated_dst_modes(n, k_modes)
    np.testing.assert_allclose(V.T @ np.diag(1.0 / lam) @ V, op_j,
                               rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("n,obs", [(16, None), (8, OBS_COARSE)])
def test_misfit_jacobi_matches_jax(n, obs):
    """With the Jacobi preconditioner every input is f32: all draws agree
    to f32 summation-order rounding (measured ≤ 2e-6 relative)."""
    phi_j, phi_t = _both(n, obs, 48, "jacobi", 128)
    U = _draws()
    want = np.asarray(phi_j(jnp.asarray(U)))
    got = phi_t(torch.from_numpy(U)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("spec", sorted(SLICE_SPECS))
def test_misfit_slice_specs_f32_factors_match_jax(spec, monkeypatch):
    """The dst_trunc misfits with f32 preconditioner factors on both sides
    (JAX: precond_dtype=f32; port: f32 modes): every draw agrees to f32
    summation-order rounding (measured ≤ 6e-7 relative)."""
    orig = jdarcy._flat_truncated_dst_preconditioner
    monkeypatch.setattr(
        jdarcy, "_flat_truncated_dst_preconditioner",
        lambda *a, **kw: orig(*a, **{**kw, "precond_dtype": jnp.float32}),
    )
    n, obs, iters, modes = SLICE_SPECS[spec]
    phi_j, phi_t = _both(n, obs, iters, "dst_trunc", modes)
    phi_t.V = torch.tensor(darcy.truncated_dst_modes(n, modes)[0], dtype=torch.float32)
    U = _draws()
    want = np.asarray(phi_j(jnp.asarray(U)))
    got = phi_t(torch.from_numpy(U)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("spec", sorted(SLICE_SPECS))
def test_misfit_slice_specs_match_jax(spec):
    """With bf16 factors both sides compute the same values, but an
    ulp-level difference in summation order occasionally flips one bf16
    rounding of a preconditioner input, which moves Φ by up to ~1e-3
    relative after 3 CG iterations. Measured on 6144 prior draws of the
    shipped surrogate: median 9e-7, ~90% within 1e-5, max 1.0e-3 (exact
    misfit: all within 5e-6). Hence: median ≤ 2e-6, ≥ 80% within 1e-5,
    all within 5e-3; the f32-factor test above checks the arithmetic."""
    n, obs, iters, modes = SLICE_SPECS[spec]
    phi_j, phi_t = _both(n, obs, iters, "dst_trunc", modes)
    U = _draws()
    want = np.asarray(phi_j(jnp.asarray(U)))
    got = phi_t(torch.from_numpy(U)).numpy()
    assert got.shape == (U.shape[1],) and np.isfinite(got).all()
    assert_bf16_agreement(got, want)


def assert_bf16_agreement(got, want):
    rel = np.abs(got - want) / np.abs(want)
    assert np.median(rel) <= 2e-6
    assert (rel <= 1e-5).mean() >= 0.80
    assert rel.max() <= 5e-3


@pytest.mark.parametrize("case", ["zero_source", "converged"])
def test_cg_zero_guards(case):
    """A zero right-hand side (r = 0 from the start) and a converged solve
    (many iterations) hit the α/β guards; Φ stays finite and equal."""
    if case == "zero_source":
        phi_j, phi_t = _both(8, OBS_COARSE, 3, "dst_trunc", 64,
                             source=np.zeros(64, np.float32))
    else:
        phi_j, phi_t = _both(8, OBS_COARSE, 200, "jacobi", 64)
    U = _draws(seed=2, n=16)
    want = np.asarray(phi_j(jnp.asarray(U)))
    got = phi_t(torch.from_numpy(U)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    if case == "zero_source":  # x = 0: Φ = ½‖y/σ‖² for every draw
        y, noise = _data()
        np.testing.assert_allclose(got, 0.5 * np.sum((y / noise) ** 2), rtol=1e-6)


def test_misfit_rejects_bad_input():
    _, phi_t = _both(8, OBS_COARSE, 3, "dst_trunc", 64)
    with pytest.raises(ValueError):
        phi_t.check_input(torch.zeros(63, 4))
    with pytest.raises(ValueError):
        darcy_misfit_from_arrays(_aux_pair(8, OBS_COARSE)[1], *_data(),
                                 precond="dst")
