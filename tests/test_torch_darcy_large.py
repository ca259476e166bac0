"""The Darcy configs on the large grids, ``darcy32_pcn_warm`` (32×32,
K = 64) and ``darcy64_pcn_warm`` (64×64, K = 144), against fresh JAX
builds: their constants and fixtures, the cold and warm misfits (plain
versions) on a few draws from x0 = 0 and from a carried solution, the
fused warm pCN at 32² against the JAX Pallas kernel in interpret mode, and
a short run of each through the port's runner."""

import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ip_mcmc_tpu import configs as jconfigs
from ip_mcmc_tpu import ops as jops
from ip_mcmc_tpu.models import darcy as jdarcy
from ip_mcmc_tpu_torch import configs, ops, runner
from ip_mcmc_tpu_torch.models import darcy

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent / "scripts"))
import freeze_torch_fixtures  # noqa: E402

torch.set_num_threads(1)

CONFIGS = {"darcy32_pcn_warm": (32, configs.DARCY32_FIXTURE),
           "darcy64_pcn_warm": (64, configs.DARCY64_FIXTURE)}


@pytest.fixture(scope="module")
def problems():
    return {name: (jconfigs.build(name), configs.build(name, "cpu"))
            for name in CONFIGS}


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
        if pot.modes:
            monkeypatch.setattr(pot, "V", torch.tensor(
                darcy.truncated_dst_modes(pot.n, pot.modes)[0], dtype=torch.float32))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_config_and_fixture_match_jax(problems, name):
    jp, tp = problems[name]
    n, fixture = CONFIGS[name]
    frozen = np.load(fixture)
    fresh = freeze_torch_fixtures.truth_and_data(jp)
    assert set(frozen.files) == set(fresh)
    for k, v in fresh.items():
        np.testing.assert_allclose(frozen[k], v, rtol=1e-6, err_msg=k)
    np.testing.assert_array_equal(tp.data, frozen["y"])
    np.testing.assert_array_equal(tp.truth, frozen["u_true"])
    for attr in ("dim", "kernel", "kernel_params", "n_chains", "n_samples",
                 "burn_in", "thin"):
        assert getattr(tp, attr) == getattr(jp, attr), attr
    warm, aux_dim = tp.batched_warm_potential
    assert aux_dim == jp.batched_warm_potential[1] == n * n == warm.aux_dim
    assert (warm.n, warm.K, warm.precond, warm.cg_iters) == (n, jp.dim, "dst_trunc", 4)
    assert tp.batched_potential_fn.n == n


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_cold_misfit_f32_matches_jax(problems, name, monkeypatch):
    """32²: Jacobi / 96 CG; 64²: dst_trunc-256 / 30 CG with f32 factors
    on both sides: f32 summation order only (measured ≤ 3.6e-6 relative
    on 16 draws; 96 iterations on 1024 cells at 32²)."""
    jp, tp = problems[name]
    _f32_factors(monkeypatch, tp.batched_potential_fn)
    U = _draws(jp.dim, 16)
    want = np.asarray(jp.batched_potential_fn(jnp.asarray(U)))
    got = tp.batched_potential_fn(torch.from_numpy(U)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)


def _warm_twice(jp, tp, n_draws):
    """(Φ, x) from x0 = 0, then from the first call's x after a pCN-sized
    move, on both sides."""
    wj, aux_dim = jp.batched_warm_potential
    wt = tp.batched_warm_potential[0]
    U = _draws(jp.dim, n_draws)
    U2 = (np.sqrt(1 - 0.08 ** 2) * U + 0.08 * _draws(jp.dim, n_draws, seed=4)).astype(np.float32)
    zeros = np.zeros((aux_dim, n_draws), np.float32)
    pj1, xj1 = wj(jnp.asarray(U), jnp.asarray(zeros))
    pj2, xj2 = wj(jnp.asarray(U2), xj1)
    pt1, xt1 = wt(torch.from_numpy(U), torch.from_numpy(zeros))
    pt2, xt2 = wt(torch.from_numpy(U2), torch.tensor(np.asarray(xj1)))
    return ([v.numpy() for v in (pt1, xt1, pt2, xt2)],
            [np.asarray(v) for v in (pj1, xj1, pj2, xj2)])


def _x_err(got, want):
    return (np.abs(got - want).max(axis=0) / np.abs(want).max(axis=0)).max()


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_warm_misfit_f32_matches_jax(problems, name, monkeypatch):
    """dst_trunc-128 (32²) / -256 (64²), 4 CG, f32 factors on both sides:
    Φ within rtol 1e-5 and x within 1e-5 of its largest cell, from zero
    and from a carried solution (measured ≤ 3.5e-6 and 6.7e-7)."""
    jp, tp = problems[name]
    _f32_factors(monkeypatch, tp.batched_warm_potential[0])
    got, want = _warm_twice(jp, tp, 16)
    for k in (0, 2):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5)
    for k in (1, 3):
        assert _x_err(got[k], want[k]) <= 1e-5


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_misfits_bf16_match_jax(problems, name):
    """The shipped bf16 factors: both sides compute the same values, but
    an ulp-level difference can flip a bf16 rounding of a preconditioner
    input. The larger grids round more inputs per solve (4096 cells and
    256 modes at 64²), and 4 iterations from x0 = 0 stop unconverged, where
    a flip is not damped: measured up to 2.3e-4 relative in Φ and 2.6e-5 in
    x on 4 draws. Hence every Φ within 5e-3 and every x within 5e-3 of its
    largest cell, as tests/test_torch_darcy.py's worst-case bound; the f32
    tests above check the arithmetic."""
    jp, tp = problems[name]
    if tp.batched_potential_fn.modes:  # 32²'s cold Jacobi is all f32: above
        U = _draws(jp.dim, 4)
        want = np.asarray(jp.batched_potential_fn(jnp.asarray(U)))
        got = tp.batched_potential_fn(torch.from_numpy(U)).numpy()
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=5e-3)
    got, want = _warm_twice(jp, tp, 4)
    for k in (0, 2):
        assert np.isfinite(got[k]).all()
        np.testing.assert_allclose(got[k], want[k], rtol=5e-3)
    for k in (1, 3):
        assert _x_err(got[k], want[k]) <= 5e-3


@pytest.mark.parametrize("recorded", [False, True])
def test_warm_pcn_32_matches_jax(problems, recorded):
    """The fused warm pCN of darcy32_pcn_warm at 32 chains in one block of
    32 (as JAX's test_darcy32_warm_config_runs sizes it), same positions,
    seed and stream: at least 30 of 32 chains end within 1e-4 of JAX's (a
    bf16 rounding flip can turn one MH decision), and those took the same
    decisions (measured: all 32)."""
    jp, tp = problems["darcy32_pcn_warm"]
    wj, aux_dim = jp.batched_warm_potential
    wt = tp.batched_warm_potential[0]
    K = jp.dim
    pos = np.random.default_rng(7).standard_normal((32, K)).astype(np.float32)
    pm, ps = np.zeros(K, np.float32), np.ones(K, np.float32)
    kw = dict(n_steps=4, aux_dim=aux_dim, block_chains=32)
    if recorded:
        fj, aj, sj = jops.fused_pcn_chain_warm_recorded(
            wj, jnp.asarray(pos), pm, ps, 0.08, 6, thin=2, **kw)
        ft, at, st = ops.fused_pcn_chain_warm_recorded(
            wt, torch.from_numpy(pos), pm, ps, 0.08, 6, thin=2, **kw)
        assert st.shape == np.asarray(sj).shape == (2, 32, K)
    else:
        fj, aj = jops.fused_pcn_chain_warm(wj, jnp.asarray(pos), pm, ps, 0.08, 5, **kw)
        ft, at = ops.fused_pcn_chain_warm(wt, torch.from_numpy(pos), pm, ps, 0.08, 5, **kw)
    ok = np.abs(ft.numpy() - np.asarray(fj)).max(axis=1) <= 1e-4
    if recorded:
        ok &= (np.abs(st.numpy() - np.asarray(sj)).max(axis=2) <= 1e-4).all(axis=0)
    assert ok.sum() >= 30
    np.testing.assert_array_equal(at.numpy()[ok], np.asarray(aj)[ok])
    assert 0.0 < float(at.mean()) < 1.0


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_large_grid_config_runs_on_the_cpu(problems, name):
    """Through the runner's fused warm branch at one block of 128 chains
    and a short burn-in (the plain versions: CPU tensors)."""
    tp = configs.build(name, "cpu")
    tp.burn_in = 3
    m = runner.run_problem(tp, "cpu", n_chains=128, n_samples=4)
    assert m["kernel"] == "pcn(fused)" and m["n_chains"] == 128
    assert 0.0 < m["accept_rate"] <= 1.0
    assert len(m["posterior_mean"]) == tp.dim
    assert all(np.isfinite(m["posterior_mean"]))
