"""The POD surrogates of the port (``models/darcy.py`` ``choose_pod_rank``,
``make_pod_surrogate``, ``make_pod_surrogate_online``; the runner's
``_pod_enrich_burnin``; the configs ``darcy_da_pod`` and
``darcy_da_pod_online``) against the JAX package on the CPU: the frozen
snapshot draws against a fresh JAX draw, the rank, the singular values, the
basis' span and Φ_r on 64 draws, one online enrichment step, and both
configs through the CLI at a reduced size.

Tolerances. The snapshots are 120 dst-preconditioned CG iterations in f32,
summed in other orders: singular values within 1e-5 of the largest. V is
defined up to the sign of each column (and LAPACK builds may rotate
near-degenerate ones), so the basis is compared by its projector V Vᵀ,
within 1e-4, and the ranks must be equal. Φ_r is a 20 × 20 Cholesky solve
in f32 on the projected operator: within 2e-5 relative (measured: 3e-6 at
most); the indicator within 1e-5 relative."""

import dataclasses
import json
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ip_mcmc_tpu import configs as jconfigs
from ip_mcmc_tpu.models import darcy as jdarcy
from ip_mcmc_tpu_torch import configs, run, runner
from ip_mcmc_tpu_torch.models import darcy

torch.set_num_threads(1)

T = lambda x: torch.tensor(np.asarray(x))  # noqa: E731
PHI_RTOL, SV_TOL, PROJ_ATOL, IND_RTOL = 2e-5, 1e-5, 1e-4, 1e-5
DARCY16 = configs.DARCY16


@pytest.fixture(scope="module")
def problems():
    return {name: (jconfigs.build(name), configs.build(name, "cpu"))
            for name in ("darcy_da_pod", "darcy_da_pod_online")}


@pytest.fixture(scope="module")
def auxes():
    return (jdarcy.make_darcy_forward(**DARCY16)[1],
            darcy.make_darcy_forward(device="cpu", **DARCY16)[1])


def test_pod_fixture_matches_fresh_jax_draw():
    """darcy16_pod.npz against scripts/freeze_torch_fixtures.py's draws
    from jax.random.key(777), as make_pod_surrogate{,_online} draw them."""
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent / "scripts"))
    import freeze_torch_fixtures

    fresh = freeze_torch_fixtures.pod_fixture_arrays()
    frozen = np.load(configs.POD_FIXTURE)
    assert set(frozen.files) == set(fresh) == {"draws", "draws_online"}
    assert frozen["draws"].shape == (64, 64) and frozen["draws_online"].shape == (24, 64)
    for k, v in fresh.items():
        np.testing.assert_array_equal(frozen[k], v, err_msg=k)


def test_choose_pod_rank_energy_criterion():
    s = np.sqrt(0.5 ** np.arange(1, 21))  # the tail after r is 2^-r
    for tol, max_rank, want in ((0.3, None, 2), (1e-3, None, 10), (1e-3, 4, 4),
                                (0.9, None, 2)):
        assert darcy.choose_pod_rank(s, tol, max_rank=max_rank) == want
        assert jdarcy.choose_pod_rank(s, tol, max_rank=max_rank) == want
    with pytest.raises(ValueError):
        darcy.choose_pod_rank(np.array([]))


def _closure(fn):
    return dict(zip(fn.__code__.co_freevars, (c.cell_contents for c in fn.__closure__)))


def test_pod_rank_spectrum_and_basis_match_jax(auxes, problems):
    """On the config's 64 snapshot draws: with rank="auto" the same rank
    and singular values; the shipped rank-20 surrogate's projector onto its
    basis and its Φ_r on 64 other draws."""
    jaux, aux = auxes
    jp, p = problems["darcy_da_pod"]
    draws = np.load(configs.POD_FIXTURE)["draws"]
    _, jinfo = jdarcy.make_pod_surrogate(jaux, jp.data, 0.002, jax.random.key(777),
                                         n_snapshots=64, rank="auto", return_info=True)
    _, info = darcy.make_pod_surrogate(aux, p.data, 0.002, draws, rank="auto",
                                       return_info=True)
    assert info["rank"] == jinfo["rank"] and info["n_snapshots"] == 64
    s, js = info["singular_values"], jinfo["singular_values"]
    np.testing.assert_allclose(s, js, atol=SV_TOL * js[0])
    u = np.random.default_rng(0).standard_normal((64, 64)).astype(np.float32)
    np.testing.assert_allclose(
        p.surrogate_potential_fn(T(u)).numpy(),
        np.asarray(jax.vmap(jp.surrogate_potential_fn)(jnp.asarray(u))), rtol=PHI_RTOL)
    # the basis by its projector; JAX's V from its surrogate's closure
    jV = np.asarray(_closure(jp.surrogate_potential_fn)["V"])
    pod = darcy._Pod(aux, p.data, 0.002, 0.0, 1e-6)
    V, _, r = pod.pod(pod.full_solve(T(draws)), 20)
    assert r == jV.shape[1] == 20
    np.testing.assert_allclose((V @ V.T).numpy(), jV @ jV.T, atol=PROJ_ATOL)


def test_online_surrogate_and_enrichment_match_jax(problems):
    """darcy_da_pod_online's surrogate, then one enrich() at 64 positions:
    the indicator's statistics, the rebuilt Φ_r; a second enrich() at the
    same positions lowers the indicator (the basis absorbed them)."""
    (jp, p) = problems["darcy_da_pod_online"]
    u = np.random.default_rng(1).standard_normal((64, 64)).astype(np.float32)
    np.testing.assert_allclose(p.surrogate_potential_fn(T(u)).numpy(),
                               np.asarray(jax.vmap(jp.surrogate_potential_fn)(jnp.asarray(u))),
                               rtol=PHI_RTOL)
    jphi1, jst = jp.surrogate_enrich_fn(u)
    phi1, st = p.surrogate_enrich_fn(T(u))
    assert st["n_snapshots"] == jst["n_snapshots"] == 24
    for k in ("indicator_max", "indicator_mean"):
        assert st[k] == pytest.approx(jst[k], rel=IND_RTOL)
    np.testing.assert_allclose(phi1(T(u)).numpy(), np.asarray(jax.vmap(jphi1)(jnp.asarray(u))),
                               rtol=PHI_RTOL)
    _, st2 = p.surrogate_enrich_fn(T(u))
    assert st2["n_snapshots"] == 32
    assert st2["indicator_max"] < st["indicator_max"]
    assert st2["indicator_mean"] < st["indicator_mean"]


def test_pod_tracks_exact_misfit_and_greedy_enrichment(problems, auxes):
    """The rank-20 surrogate correlates with the exact misfit on prior
    draws (tests/test_da_pcn.py's bounds), and weak-greedy rounds append
    their full solves."""
    _, p = problems["darcy_da_pod"]
    u = p.prior.sample(torch.Generator().manual_seed(11), 16)
    exact, surr = p.potential_fn(u).numpy(), p.surrogate_potential_fn(u).numpy()
    assert np.corrcoef(exact, surr)[0, 1] > 0.95
    assert np.all(surr / exact > 0.3) and np.all(surr / exact < 3.0)
    _, info = darcy.make_pod_surrogate(
        auxes[1], p.data, 0.002, np.load(configs.POD_FIXTURE)["draws"][:32], rank="auto",
        energy_tol=1e-8, greedy_rounds=2, n_candidates=64, greedy_batch=8,
        generator=torch.Generator().manual_seed(5), return_info=True)
    assert info["n_snapshots"] == 48 and len(info["residual_history"]) == 2
    assert 2 <= info["rank"] <= 48


# the JAX runner's keys of the scan da_pcn path (_run_one_dispatch) and
# _pod_enrich_burnin's five (ip_mcmc_tpu/runner.py)
DA_SCAN_KEYS = {
    "accept_rate", "burn_steps", "compile_s", "config", "converged", "dim", "ess_per_s",
    "ess_per_total_wall_s", "first_dispatch_s", "inner_steps_per_s", "kernel", "max_rhat",
    "min_ess", "n_chains", "n_samples", "outer_steps_per_s", "posterior_mean",
    "program_count", "run_s", "sampling_steps", "sampling_steps_per_s", "total_wall_s",
    "trace_s", "unattributed_s", "warm_steps"}
ENRICH_KEYS = {"pod_enrich_epochs", "pod_enrich_segment_steps", "pod_enrich_s",
               "pod_enrich_indicator_max", "pod_enrich_indicator_mean"}


@pytest.mark.parametrize("name", ["darcy_da_pod", "darcy_da_pod_online"])
def test_pod_configs_through_the_cli(name, monkeypatch, capsys):
    """Both configs through the CLI at 32 chains, 4 samples, burn-in 20
    (the online one's three enrichment segments cut to 8 steps): the JAX
    runner's keys, a rate in (0, 1]; the online run records one indicator
    a segment, and the last below the first."""
    build = configs.REGISTRY[name]

    def reduced(device):
        p = dataclasses.replace(build(device), n_chains=32, n_samples=4, burn_in=20)
        if "pod_enrich" in p.kernel_params:
            p.kernel_params["pod_enrich"] = {"epochs": 3, "segment_steps": 8}
        return p

    monkeypatch.setitem(configs.REGISTRY, name, reduced)
    assert run.main(["--config", name, "--device", "cpu"]) == 0
    m = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    online = name == "darcy_da_pod_online"
    want = DA_SCAN_KEYS | (ENRICH_KEYS if online else set())
    assert set(m) - {"setup_s", "cli_total_s", "warning"} == want
    assert m["kernel"] == "da_pcn" and 0.0 < m["accept_rate"] <= 1.0
    assert m["burn_steps"] == (0 if online else 20)
    if online:
        hist = m["pod_enrich_indicator_mean"]
        assert len(hist) == len(m["pod_enrich_indicator_max"]) == 3
        assert hist[-1] < hist[0]


def test_pod_enrichment_keeps_the_callers_problem():
    """A run enriches a copy: the caller's problem keeps its burn-in,
    surrogate and initialiser."""
    p = configs.build("darcy_da_pod_online", "cpu")
    p.n_chains, p.n_samples, p.burn_in = 16, 4, 10
    p.kernel_params = {**p.kernel_params, "pod_enrich": {"epochs": 2, "segment_steps": 4}}
    surr0 = p.surrogate_potential_fn
    m = runner.run_problem(p, "cpu")
    assert p.burn_in == 10 and p.surrogate_potential_fn is surr0
    assert p.init_positions_fn is None and m["burn_steps"] == 2
