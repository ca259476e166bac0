"""``darcy64_da_fused`` (delayed-acceptance pCN at 64×64 cells, K = 144,
with a calibrated 32×32 surrogate) against a fresh JAX build: the config
and its fixture, the 32×32 KL basis of 12 modes a dimension, the exact and
the surrogate misfits (plain versions), the plain DA chain against the JAX
Pallas kernel in interpret mode, and a short run through the port's
runner."""

import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ip_mcmc_tpu import configs as jconfigs
from ip_mcmc_tpu import ops as jops
from ip_mcmc_tpu.models import darcy as jdarcy
from ip_mcmc_tpu_torch import configs, runner
from ip_mcmc_tpu_torch.models import darcy
from ip_mcmc_tpu_torch.ops import fused_da_pcn as da

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent / "scripts"))
import freeze_torch_fixtures  # noqa: E402

torch.set_num_threads(1)

NAME = "darcy64_da_fused"
LEVELS = {"exact": (64, "batched_potential_fn"),
          "surrogate": (32, "batched_surrogate_fn")}


@pytest.fixture(scope="module")
def problems():
    return jconfigs.build(NAME), configs.build(NAME, "cpu")


def _draws(K, n, seed=3):
    return np.random.default_rng(seed).standard_normal((K, n)).astype(np.float32)


def _f32_factors(monkeypatch, *pots):
    """f32 preconditioner factors on both sides (JAX traces its misfits
    anew at each call, so the patch reaches the built configs), both
    undone after the test: the port's problems are shared by the module."""
    orig = jdarcy._flat_truncated_dst_preconditioner
    monkeypatch.setattr(
        jdarcy, "_flat_truncated_dst_preconditioner",
        lambda *a, **kw: orig(*a, **{**kw, "precond_dtype": jnp.float32}),
    )
    for pot in pots:
        monkeypatch.setattr(pot, "V", torch.tensor(
            darcy.truncated_dst_modes(pot.n, pot.modes)[0], dtype=torch.float32))


def test_config_and_fixture_match_jax(problems):
    jp, tp = problems
    frozen = np.load(configs.DARCY64_DA_FIXTURE)
    fresh = freeze_torch_fixtures.fixture_arrays(jp)
    assert set(frozen.files) == set(fresh)
    for k, v in fresh.items():
        np.testing.assert_allclose(frozen[k], v, rtol=1e-6, err_msg=k)
    # the data of darcy64_pcn_warm (keys 500 / 501)
    np.testing.assert_array_equal(frozen["y"], np.load(configs.DARCY64_FIXTURE)["y"])
    np.testing.assert_array_equal(tp.data, frozen["y"])
    np.testing.assert_array_equal(tp.truth, frozen["u_true"])
    for attr in ("dim", "kernel", "kernel_params", "n_chains", "n_samples",
                 "burn_in", "thin"):
        assert getattr(tp, attr) == getattr(jp, attr), attr
    exact, surr = tp.batched_potential_fn, tp.batched_surrogate_fn
    assert (exact.n, exact.K, exact.precond, exact.modes, exact.cg_iters) == (
        64, 144, "dst_trunc", 256, 16)
    assert (surr.n, surr.K, surr.precond, surr.modes, surr.cg_iters, surr.solver) == (
        32, 144, "dst_trunc", 128, 3, "cg")
    np.testing.assert_array_equal(surr.obs.numpy(), frozen["obs_coarse"])
    np.testing.assert_array_equal(surr.noise.numpy(), frozen["surr_scale"])


def test_kl_basis_32_with_12_modes_matches_jax():
    """The surrogate's grid: 32×32 cells with 12 sine modes a dimension
    (K = 144; darcy32_pcn_warm has 8)."""
    _, jaux = jdarcy.make_darcy_forward(n_grid=32, n_modes_per_dim=12, alpha=2.0,
                                        field_scale=10.0)
    aux = darcy.darcy_aux(n_grid=32, n_modes_per_dim=12, alpha=2.0, field_scale=10.0)
    assert aux["scaled_basis"].shape == (144, 1024)
    np.testing.assert_allclose(aux["scaled_basis"], np.asarray(jaux["scaled_basis"]),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(aux["eigenvalues"], np.asarray(jaux["eigenvalues"]), rtol=1e-6)


@pytest.mark.parametrize("level", sorted(LEVELS))
def test_misfit_f32_matches_jax(problems, level, monkeypatch):
    """dst_trunc-256 / 16 CG at 64², dst_trunc-128 / 3 CG at 32², f32
    factors on both sides: f32 summation order only (measured ≤ 1.2e-6
    relative on 8 draws)."""
    jp, tp = problems
    attr = LEVELS[level][1]
    pot = getattr(tp, attr)
    assert pot.n == LEVELS[level][0]
    _f32_factors(monkeypatch, pot)
    U = _draws(jp.dim, 8)
    want = np.asarray(getattr(jp, attr)(jnp.asarray(U)))
    got = pot(torch.from_numpy(U)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("level", sorted(LEVELS))
def test_misfit_bf16_matches_jax(problems, level):
    """The shipped bf16 factors: an ulp-level difference can flip a bf16
    rounding of a preconditioner input, and the large grids round many per
    solve. The bounds are chip_smoke.py's LARGE_BF16_TOL, measured on the
    32² and 64² misfits (tests/test_torch_darcy_large.py): median
    ≤ 2e-4, ≥ 90 % of draws within 1e-3, every draw within 5e-3 (measured:
    surrogate median 9.2e-5, max 1.8e-4; exact max 2.3e-6). The 32²
    surrogate stops after 3 iterations, far from converged, where a flip
    is not damped."""
    jp, tp = problems
    attr = LEVELS[level][1]
    U = _draws(jp.dim, 8, seed=4)
    want = np.asarray(getattr(jp, attr)(jnp.asarray(U)))
    got = getattr(tp, attr)(torch.from_numpy(U)).numpy()
    assert np.isfinite(got).all()
    rel = np.abs(got - want) / np.abs(want)
    assert np.median(rel) <= 2e-4
    assert (rel <= 1e-3).mean() >= 0.90
    assert rel.max() <= 5e-3


N, OUTER, K_SUB, SEED = 16, 2, 3, 5


@pytest.mark.parametrize("recorded", [False, True])
def test_da_chain_matches_jax(problems, recorded):
    """16 chains in one block, 2 outer steps of k = 3, the same positions,
    seed and stream as JAX's fused DA-pCN (interpret mode): the chains and
    records within 1e-4 (measured 4.8e-7), the same MH decisions, and so
    the rates within 1e-2."""
    jp, tp = problems
    je, js = jp.batched_potential_fn, jp.batched_surrogate_fn
    te, ts = tp.batched_potential_fn, tp.batched_surrogate_fn
    d, beta = jp.dim, jp.kernel_params["beta"]
    pos = np.random.default_rng(7).standard_normal((N, d)).astype(np.float32)
    pm, ps = np.zeros(d, np.float32), np.ones(d, np.float32)
    kw = dict(n_steps=OUTER, subchain_len=K_SUB, block_chains=N)
    if recorded:
        fj, aj, sj = jops.fused_da_pcn_chain_recorded(
            je, js, jnp.asarray(pos), pm, ps, beta, SEED, thin=1, **kw)
        ft, at, st = da.fused_da_pcn_chain_recorded(
            te, ts, torch.from_numpy(pos), pm, ps, beta, SEED, thin=1, **kw)
        assert st.shape == np.asarray(sj).shape == (OUTER, N, d)
        assert np.abs(st.numpy() - np.asarray(sj)).max() <= 1e-4
    else:
        fj, aj, ij = jops.fused_da_pcn_chain(je, js, jnp.asarray(pos), pm, ps, beta, SEED, **kw)
        ft, at, it = da.fused_da_pcn_chain(te, ts, torch.from_numpy(pos), pm, ps, beta, SEED,
                                           **kw)
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
        assert abs(float(it.mean()) - float(np.mean(ij))) <= 1e-2
        assert 0.0 < float(it.mean()) < 1.0
    assert np.abs(ft.numpy() - np.asarray(fj)).max() <= 1e-4
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
    assert abs(float(at.mean()) - float(np.mean(aj))) <= 1e-2


def test_kernel_names_follow_the_grids(problems):
    """The launch counts tell the 64² cluster kernel from the 16² kernel's
    two surrogate solves."""
    _, tp = problems
    small = configs.build("darcy_da_fused", "cpu")
    rich = configs.darcy_da_richardson("rich3_w0.9", "cpu")
    assert da._darcy_stem(tp.batched_potential_fn, tp.batched_surrogate_fn) == (
        "fused_da_pcn_cluster_kernel")
    assert da._darcy_stem(small.batched_potential_fn, small.batched_surrogate_fn) == (
        "fused_da_pcn_warp_kernel")
    assert da._darcy_stem(rich.batched_potential_fn, rich.batched_surrogate_fn) == (
        "fused_da_pcn_warp_kernel[surrogate=richardson]")


def test_config_runs_on_the_cpu():
    """Through the runner's fused DA branch at one block of 128 chains and
    one outer step of burn-in (the plain versions: CPU tensors)."""
    tp = configs.build(NAME, "cpu")
    tp.burn_in = 1
    m = runner.run_problem(tp, "cpu", n_chains=128, n_samples=4)
    assert m["kernel"] == "da_pcn(fused)" and m["n_chains"] == 128
    assert 0.0 < m["accept_rate"] <= 1.0 and 0.0 < m["inner_accept_rate"] < 1.0
    assert len(m["posterior_mean"]) == tp.dim
    assert all(np.isfinite(m["posterior_mean"]))
