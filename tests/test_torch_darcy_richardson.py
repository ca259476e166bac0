"""K17, the Richardson solve of the port's batched Darcy misfit
(``DarcyMisfit(solver="richardson")``, plain version on the CPU), against
``darcy.make_batched_misfit(solver="richardson")``; its checks; the
delayed-acceptance chain with a Richardson surrogate against the JAX Pallas
kernel in interpret mode; and the frozen fixture of
``configs.darcy_da_richardson`` against a fresh JAX build."""

import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ip_mcmc_tpu import ops as jops
from ip_mcmc_tpu.models import darcy as jdarcy
from ip_mcmc_tpu_torch import configs
from ip_mcmc_tpu_torch.convert import (
    darcy_misfit_from_arrays,
    darcy_warm_misfit_from_arrays,
)
from ip_mcmc_tpu_torch.models import darcy
from ip_mcmc_tpu_torch.ops import _scaffold
from ip_mcmc_tpu_torch.ops import fused_da_pcn as da
from test_torch_darcy import OBS_COARSE, _aux_pair, _data

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent / "scripts"))
import freeze_torch_fixtures  # noqa: E402

torch.set_num_threads(1)

# (ω, iterations): both relaxations of benchmarks/darcy_da_richardson.py and
# every iteration count from the bare x₁ (1) to rich4's
SWEEP = ((0.8, 1), (0.9, 2), (0.8, 3), (0.9, 4))
GRIDS = {8: (OBS_COARSE, 64), 16: (None, 128)}  # n -> (obs, dst_trunc modes)


def _draws(seed=0, n=128):
    return np.random.default_rng(seed).standard_normal((64, n)).astype(np.float32)


def _both(n, precond, omega, iters):
    obs, modes = GRIDS[n]
    aux_j, aux_t = _aux_pair(n, obs)
    y, noise = _data()
    kw = dict(cg_iters=iters, precond=precond, precond_modes=modes,
              solver="richardson", omega=omega)
    return (jax.jit(jdarcy.make_batched_misfit(aux_j, y, noise, **kw)),
            darcy_misfit_from_arrays(aux_t, y, noise, **kw))


def _f32_factors(monkeypatch):
    orig = jdarcy._flat_truncated_dst_preconditioner
    monkeypatch.setattr(
        jdarcy, "_flat_truncated_dst_preconditioner",
        lambda *a, **kw: orig(*a, **{**kw, "precond_dtype": jnp.float32}),
    )


@pytest.mark.parametrize("n", sorted(GRIDS))
@pytest.mark.parametrize("precond", ["jacobi", "dst_trunc"])
def test_richardson_f32_matches_jax(n, precond, monkeypatch):
    """Every input f32 (Jacobi, or dst_trunc with f32 factors on both
    sides): all draws agree to f32 summation-order rounding (measured
    ≤ 1.4e-6 relative: Φ divides the residuals by σ = 0.002)."""
    _f32_factors(monkeypatch)
    U = _draws()
    for omega, iters in SWEEP:
        phi_j, phi_t = _both(n, precond, omega, iters)
        if precond == "dst_trunc":
            phi_t.V = torch.tensor(
                darcy.truncated_dst_modes(n, phi_t.modes)[0], dtype=torch.float32)
        want = np.asarray(phi_j(jnp.asarray(U)))
        got = phi_t(torch.from_numpy(U)).numpy()
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=5e-6, err_msg=f"{omega} {iters}")


def assert_richardson_bf16_agreement(got, want):
    """bf16 factors: the same values on both sides, but an ulp-level
    difference flips a bf16 rounding of a preconditioner input now and
    then. Richardson recomputes its residual as b − A x, which loses
    digits to cancellation as x converges, so its roundings sit nearer a
    tie than CG's recursively updated residual and flip more often than
    tests/test_torch_darcy.py's bound allows. Measured on 2048 prior draws
    (8² and 16², ω 0.8–0.9, 2–4 iterations): median ≤ 1.7e-5, ≥ 93.6%
    within 1e-4, max 1.5e-3. Hence: median ≤ 5e-5, ≥ 80% within 1e-4, all
    within 5e-3; the f32-factor test above checks the arithmetic."""
    rel = np.abs(got - want) / np.abs(want)
    assert np.median(rel) <= 5e-5
    assert (rel <= 1e-4).mean() >= 0.80
    assert rel.max() <= 5e-3


@pytest.mark.parametrize("n", sorted(GRIDS))
def test_richardson_bf16_matches_jax(n):
    U = _draws(seed=1)
    for omega, iters in SWEEP:
        phi_j, phi_t = _both(n, "dst_trunc", omega, iters)
        want = np.asarray(phi_j(jnp.asarray(U)))
        got = phi_t(torch.from_numpy(U)).numpy()
        assert got.shape == (U.shape[1],) and np.isfinite(got).all()
        assert_richardson_bf16_agreement(got, want)


def test_richardson_one_iteration_is_the_preconditioned_source():
    """cg_iters ≤ 1 leaves x₁ = ω M⁻¹b (JAX: fori_loop(0, n − 1)), so 0
    iterations give what 1 gives."""
    U = torch.from_numpy(_draws(n=8))
    aux = _aux_pair(8, OBS_COARSE)[1]
    y, noise = _data()
    one, zero = (darcy_misfit_from_arrays(aux, y, noise, cg_iters=k,
                                          solver="richardson", omega=0.9)
                 for k in (1, 0))
    torch.testing.assert_close(zero(U), one(U), rtol=0, atol=0)


def test_richardson_checks():
    aux = _aux_pair(8, OBS_COARSE)[1]
    y, noise = _data()
    with pytest.raises(ValueError, match="solver"):
        darcy_misfit_from_arrays(aux, y, noise, solver="gmres")
    # JAX accepts Richardson under plain Jacobi without a word (ADVICE
    # round 5); mirrored, not fixed
    rich = darcy_misfit_from_arrays(aux, y, noise, cg_iters=3,
                                    solver="richardson", omega=0.9)
    assert rich.precond == "jacobi"
    U = torch.from_numpy(_draws(n=4))
    assert torch.isfinite(rich(U)).all()
    # JAX refuses solver="richardson" with differentiable=True: here the
    # adjoint gradient and the autograd path raise
    with pytest.raises(ValueError, match="solver='cg'"):
        rich.value_and_grad(U)
    with pytest.raises(ValueError, match="solver='cg'"):
        rich(U.clone().requires_grad_(True))
    # the warm builders take no solver
    with pytest.raises(TypeError):
        darcy_warm_misfit_from_arrays(aux, y, noise, solver="richardson")
    with pytest.raises(ValueError, match="solver"):
        darcy.DarcyMisfitWarm(aux["scaled_basis"], aux["obs_indices"],
                              aux["source"], y, noise, 8, solver="richardson")
    # the spec carries the solver to the kernel
    spec = rich.spec()
    assert (spec.solver, spec.omega) == (1, np.float32(0.9))
    assert darcy_misfit_from_arrays(aux, y, noise).spec().solver == 0


def test_cuda_samplers_take_richardson_as_da_surrogate_only():
    """A CUDA kernel is compiled per solve: the DA kernel has a Richardson
    surrogate instantiation, the other samplers solve by CG and refuse it
    before any launch."""
    aux = _aux_pair(8, OBS_COARSE)[1]
    y, noise = _data()
    cg = darcy_misfit_from_arrays(aux, y, noise, cg_iters=3)
    rich = darcy_misfit_from_arrays(aux, y, noise, cg_iters=3,
                                    solver="richardson", omega=0.9)
    pots = {"potential_fn": cg, "surrogate_fn": rich}
    assert _scaffold.require_family(
        pots, families=("darcy", "burgers"), richardson=("surrogate_fn",)) == "darcy"
    with pytest.raises(TypeError, match="by CG"):
        _scaffold.require_family(pots, families=("darcy", "burgers"))
    with pytest.raises(TypeError, match="by CG"):
        _scaffold.require_family({"potential_fn": rich})


@pytest.fixture(scope="module")
def da_pair():
    """The rich3_w0.9 run of benchmarks/darcy_da_richardson.py, JAX and
    port, from the frozen arrays."""
    fx = np.load(configs.RICHARDSON_FIXTURE)
    key = configs.richardson_fixture_key("rich3_w0.9")
    _, aux16 = jdarcy.make_darcy_forward(n_grid=16, n_modes_per_dim=8,
                                         alpha=2.0, field_scale=10.0)
    _, aux8 = jdarcy.make_darcy_forward(n_grid=8, n_modes_per_dim=8, alpha=2.0,
                                        field_scale=10.0, obs_indices=OBS_COARSE)
    jax_pots = (
        jdarcy.make_batched_misfit(aux16, fx["y"], 0.002, cg_iters=12,
                                   precond="dst_trunc", precond_modes=128),
        jdarcy.make_batched_misfit(aux8, fx[f"y_surr_{key}"], fx[f"scale_{key}"],
                                   cg_iters=3, precond="dst_trunc",
                                   precond_modes=64, solver="richardson",
                                   omega=0.9),
    )
    p = configs.darcy_da_richardson("rich3_w0.9", "cpu")
    assert p.batched_surrogate_fn.solver == "richardson"
    return jax_pots, (p.batched_potential_fn, p.batched_surrogate_fn)


def test_da_chain_with_richardson_surrogate_matches_jax(da_pair):
    """Same positions, seed and stream, 64 chains: at least 62 end within
    1e-4 of JAX's (a bf16 rounding flip can turn one MH decision), and those
    took the same decisions."""
    (je, js), (te, ts) = da_pair
    pos = np.random.default_rng(7).standard_normal((64, 64)).astype(np.float32)
    pm, ps = np.zeros(64, np.float32), np.ones(64, np.float32)
    kw = dict(n_steps=2, subchain_len=4, block_chains=32)
    fj, aj, ij = jops.fused_da_pcn_chain(je, js, jnp.asarray(pos), pm, ps,
                                         0.35, 5, **kw)
    ft, at, it = da.fused_da_pcn_chain(te, ts, torch.from_numpy(pos), pm, ps,
                                       0.35, 5, **kw)
    ok = np.abs(ft.numpy() - np.asarray(fj)).max(axis=1) <= 1e-4
    assert ok.sum() >= 62
    np.testing.assert_array_equal(at.numpy()[ok], np.asarray(aj)[ok])
    np.testing.assert_array_equal(it.numpy()[ok], np.asarray(ij)[ok])
    assert 0.0 < float(it.mean()) < 1.0


def test_richardson_fixture_matches_fresh_jax_build():
    fresh = freeze_torch_fixtures.richardson_fixture_arrays()
    frozen = np.load(configs.RICHARDSON_FIXTURE)
    assert set(frozen.files) == set(fresh)
    for k, v in fresh.items():
        assert frozen[k].shape == v.shape, k
        np.testing.assert_allclose(frozen[k], v, rtol=1e-6, err_msg=k)
    assert frozen["y"].shape == (16,) and frozen["u_true"].shape == (64,)
    # one data vector, four calibrations, each with its own solver
    keys = [configs.richardson_fixture_key(v) for v in configs.RICHARDSON_VARIANTS]
    assert len({frozen[f"y_surr_{k}"].tobytes() for k in keys}) == 4
