"""The derivative-free scan kernels of the port (``kernels/da_pcn.py``,
``kernels/elliptical.py``, ``kernels/ensemble.py``) and the configs they
unlock (``darcy_da_pcn``, ``lingauss_elliptical``, ``lingauss_fes``) against
the JAX package on the CPU: one transition of each from the draws that
JAX's kernel makes from its key (the same states within f32 rounding, the
same decisions), the two linear-Gaussian configs' posterior means against
the conjugate one within Monte Carlo error, their runs' keys against the
JAX runner's, and the runner's refusals of what is not ported.

Tolerances. The linear-Gaussian potential is a small f32 product, summed
in other orders by XLA and PyTorch: positions within 1e-6, potentials
within 1e-5 relative. The ESS angles come from the same [0, 1) floats
through the same f32 operations: 1e-6. Monte Carlo checks: five standard
errors sd/√ESS per coordinate, the port's multi-chain ESS."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ip_mcmc_tpu import configs as jconfigs
from ip_mcmc_tpu import runner as jrunner
from ip_mcmc_tpu.kernels import da_pcn as jda_pcn
from ip_mcmc_tpu.kernels import elliptical as jelliptical
from ip_mcmc_tpu.kernels import ensemble as jensemble
from ip_mcmc_tpu_torch import configs, diagnostics, driver, run, runner
from ip_mcmc_tpu_torch.kernels import da_pcn, elliptical, ensemble
from ip_mcmc_tpu_torch.models import linear

torch.set_num_threads(1)

N = 64
POS_ATOL, PHI_RTOL, ANGLE_ATOL = 1e-6, 1e-5, 1e-6
T = lambda x: torch.tensor(np.asarray(x))  # noqa: E731


@pytest.fixture(scope="module")
def lingauss():
    return jconfigs.build("lingauss_pcn"), configs.build("lingauss_pcn", "cpu")


def _start(jp, seed):
    return np.array(jp.prior.sample(jax.random.key(seed), (N,)))


def _keys(seed):
    return jax.random.split(jax.random.key(seed), N)


# --- delayed acceptance ------------------------------------------------------------


def test_da_pcn_transition_matches_jax(lingauss):
    """lingauss_pcn's misfit as Φ and 1.5 Φ as the surrogate, k = 4, β
    0.3: per chain split(key) → (subchain key split in 4, each split into
    the proposal and the MH key; the correction's key)."""
    jp, p = lingauss
    k = 4
    pos = _start(jp, 1)
    jsurr = lambda u: 1.5 * jp.potential_fn(u)  # noqa: E731
    tsurr = lambda u: 1.5 * p.potential_fn(u)  # noqa: E731
    kj = jda_pcn.build_kernel(jp.potential_fn, jsurr, jp.prior, 0.3, subchain_len=k)
    sj = jax.vmap(lambda x: jda_pcn.init(x, jp.potential_fn, jsurr))(jnp.asarray(pos))
    new_j, info_j = jax.vmap(kj)(_keys(2), sj)

    def draws(key):
        key_sub, key_acc = jax.random.split(key)
        xi, u = [], []
        for kk in jax.random.split(key_sub, k):
            kp, km = jax.random.split(kk)
            xi.append(jp.prior.sample_centered(kp))
            u.append(jax.random.uniform(km, ()))
        return jnp.stack(xi), jnp.stack(u), jax.random.uniform(key_acc, ())

    xi, u_in, u_out = jax.vmap(draws)(_keys(2))
    kt = da_pcn.build_kernel(p.potential_fn, tsurr, p.prior, 0.3, subchain_len=k)
    new_t, info_t = kt.transition(da_pcn.init(T(pos), p.potential_fn, tsurr),
                                  T(xi).transpose(0, 1), T(u_in).T, T(u_out))
    np.testing.assert_array_equal(info_t.accepted.numpy(), np.asarray(info_j.accepted))
    np.testing.assert_array_equal(info_t.moved.numpy(), np.asarray(info_j.moved))
    np.testing.assert_allclose(info_t.inner_accept_rate.numpy(),
                               np.asarray(info_j.inner_accept_rate))
    assert 0 < int(info_t.accepted.sum()) < N
    np.testing.assert_allclose(new_t.position.numpy(), np.asarray(new_j.position),
                               atol=POS_ATOL)
    for f in ("potential", "surrogate"):
        np.testing.assert_allclose(getattr(new_t, f).numpy(), np.asarray(getattr(new_j, f)),
                                   rtol=PHI_RTOL, err_msg=f)
    with pytest.raises(ValueError, match="subchain_len"):
        da_pcn.build_kernel(p.potential_fn, tsurr, p.prior, 0.3, subchain_len=0)


@pytest.fixture(scope="module")
def darcy_da():
    return jconfigs.build("darcy_da_pcn"), configs.build("darcy_da_pcn", "cpu")


def test_darcy_da_pcn_config_matches_jax(darcy_da):
    """Sizes and parameters; the data are darcy_pcn_4096's (the frozen
    darcy16_da.npz); the exact and the 8-CG surrogate potentials against
    JAX's on 8 prior draws (1e-5, tests/test_torch_darcy_forward.py's
    bound)."""
    jp, p = darcy_da
    for attr in ("name", "dim", "kernel", "kernel_params", "n_chains", "n_samples",
                 "burn_in", "thin"):
        assert getattr(p, attr) == getattr(jp, attr), attr
    np.testing.assert_array_equal(np.asarray(jp.data),
                                  np.asarray(jconfigs.build("darcy_pcn_4096").data))
    np.testing.assert_allclose(p.data, np.asarray(jp.data), rtol=1e-6)
    u = np.random.default_rng(3).standard_normal((8, 64)).astype(np.float32)
    for attr in ("potential_fn", "surrogate_potential_fn"):
        want = np.asarray(jax.vmap(getattr(jp, attr))(jnp.asarray(u)))
        got = getattr(p, attr)(torch.tensor(u)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=attr)
    assert p.batched_potential_fn is not None


def test_darcy_da_pcn_run_prints_jax_runner_keys(darcy_da):
    """Through run_problem at 32 chains, 4 samples, 2 outer burn-in steps:
    the JAX one-dispatch keys of a DA run (outer and inner steps per
    second, no steps_per_s), the outer steps counted."""
    from ip_mcmc_tpu_torch.ops import _build

    jp, p = darcy_da
    before = _build.launch_counts["scan_da_pcn_step[cpu]"]
    m = runner.run_problem(dataclasses.replace(p, burn_in=2), "cpu", n_chains=32, n_samples=4)
    jm = jrunner.run_problem(dataclasses.replace(jp, burn_in=2), key=jax.random.key(0),
                             n_chains=32, n_samples=4)
    assert set(m) - {"warning"} == set(jm) - {"warning"}
    assert "steps_per_s" not in m and m["kernel"] == "da_pcn"
    assert m["inner_steps_per_s"] == pytest.approx(4 * m["outer_steps_per_s"])
    assert m["outer_steps_per_s"] == pytest.approx(32 * 6 / m["run_s"])
    assert 0.0 <= m["accept_rate"] <= 1.0
    assert _build.launch_counts["scan_da_pcn_step[cpu]"] == before + 2 * 6


def test_darcy_da_pcn_runs_through_the_cli(darcy_da, capsys):
    """The CLI at 32 chains and 4 samples, the config's 150 outer burn-in
    steps in full: the keys of the run above and the CLI's own, the outer
    steps counted."""
    from ip_mcmc_tpu_torch.ops import _build

    _, p = darcy_da
    before = _build.launch_counts["scan_da_pcn_step[cpu]"]
    assert run.main(["--config", "darcy_da_pcn", "--device", "cpu", "--n-chains", "32",
                     "--n-samples", "4"]) == 0
    m = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    steps = p.burn_in + 4
    assert {"outer_steps_per_s", "inner_steps_per_s", "accept_rate", "setup_s",
            "cli_total_s"} <= set(m)
    assert "steps_per_s" not in m and m["kernel"] == "da_pcn"
    assert m["outer_steps_per_s"] == pytest.approx(32 * steps / m["run_s"])
    assert m["inner_steps_per_s"] == pytest.approx(4 * m["outer_steps_per_s"])
    assert 0.0 <= m["accept_rate"] <= 1.0 and np.isfinite(m["posterior_mean"]).all()
    assert _build.launch_counts["scan_da_pcn_step[cpu]"] == before + 2 * steps


def test_three_level_da_is_refused_on_the_scan_path(darcy_da):
    _, p = darcy_da
    p = dataclasses.replace(p, kernel_params={**p.kernel_params, "k_mid": 2})
    with pytest.raises(ValueError, match="fused-only"):
        runner.run_problem(p, "cpu", n_chains=8, n_samples=2)
    with pytest.raises(ValueError, match="surrogate_potential_fn"):
        runner.run_problem(dataclasses.replace(darcy_da[1], surrogate_potential_fn=None),
                           "cpu", n_chains=8, n_samples=2)


# --- elliptical slice sampling -----------------------------------------------------


@pytest.mark.parametrize("max_shrink", [30, 2])
def test_elliptical_transition_matches_jax(lingauss, max_shrink):
    """Per chain split(key, 3) → (ν, level, first angle), then
    fold_in(key, 7) split once an evaluation for the bracket's uniforms; at
    max_shrink 2 some chains exhaust the budget and stay put."""
    jp, p = lingauss
    pos = _start(jp, 3)
    kj = jelliptical.build_kernel(jp.potential_fn, jp.prior, max_shrink=max_shrink)
    sj = jax.vmap(lambda x: jelliptical.init(x, jp.potential_fn))(jnp.asarray(pos))
    new_j, info_j = jax.vmap(kj)(_keys(4), sj)

    def draws(key):
        key_nu, key_u, key_theta = jax.random.split(key, 3)
        shrink, k = [], jax.random.fold_in(key, 7)
        for _ in range(max_shrink):
            k, sub = jax.random.split(k)
            shrink.append(jax.random.uniform(sub, ()))
        return (jp.prior.sample_centered(key_nu), jax.random.uniform(key_u, ()),
                jax.random.uniform(key_theta, ()), jnp.stack(shrink))

    nu, u_level, u_theta, u_shrink = (T(x) for x in jax.vmap(draws)(_keys(4)))
    kt = elliptical.build_kernel(p.potential_fn, p.prior, max_shrink=max_shrink)
    new_t, info_t = kt.transition(elliptical.init(T(pos), p.potential_fn), nu, u_level,
                                  u_theta, u_shrink.T)
    np.testing.assert_array_equal(info_t.n_evals.numpy(), np.asarray(info_j.n_evals))
    np.testing.assert_allclose(info_t.theta.numpy(), np.asarray(info_j.theta), atol=ANGLE_ATOL)
    np.testing.assert_allclose(new_t.position.numpy(), np.asarray(new_j.position),
                               atol=POS_ATOL)
    np.testing.assert_allclose(new_t.potential.numpy(), np.asarray(new_j.potential),
                               rtol=PHI_RTOL)
    stayed = (info_t.theta == 0).numpy()
    assert stayed.any() == (max_shrink == 2)
    assert info_t.n_evals.max() <= max_shrink


# --- the functional ensemble sampler ----------------------------------------------


def test_fes_transition_matches_jax(lingauss):
    """The whole ensemble of 64 walkers, M = 6, a 2.0, β 0.25: the draws
    of split(key, 4) → (half a, half b, pCN normals, pCN uniforms), a half's
    key split in 3 → (partners, stretch factors, MH)."""
    jp, p = lingauss
    M, a, beta = 6, 2.0, 0.25
    pos = _start(jp, 5)
    key = jax.random.key(6)
    kj = jensemble.build_kernel(jp.potential_fn, jp.prior, M, stretch_a=a, pcn_beta=beta)
    new_j, info_j = kj(key, jensemble.init(jnp.asarray(pos), jp.potential_fn))

    h = N // 2
    key_a, key_b, key_xi, key_u = jax.random.split(key, 4)

    def half(k, n, n_anchors):
        kp, kz, ka = jax.random.split(k, 3)
        return (T(jax.random.randint(kp, (n,), 0, n_anchors)).long(),
                T(jax.random.uniform(kz, (n,))), T(jax.random.uniform(ka, (n,))))

    pa, za, ua = half(key_a, h, N - h)
    pb, zb, ub = half(key_b, N - h, h)
    d = ensemble.FESDraws(pick_a=pa, z_a=za, u_a=ua, pick_b=pb, z_b=zb, u_b=ub,
                          xi=T(jax.random.normal(key_xi, (N, 32))),
                          u_pcn=T(jax.random.uniform(key_u, (N,))))
    kt = ensemble.build_kernel(p.potential_fn, p.prior, M, stretch_a=a, pcn_beta=beta)
    new_t, info_t = kt.transition(ensemble.init(T(pos), p.potential_fn), d)
    np.testing.assert_allclose(new_t.positions.numpy(), np.asarray(new_j.positions),
                               atol=POS_ATOL)
    np.testing.assert_allclose(new_t.potentials.numpy(), np.asarray(new_j.potentials),
                               rtol=PHI_RTOL)
    for f in ("stretch_accept", "pcn_accept"):
        assert float(getattr(info_t, f).mean()) == pytest.approx(float(getattr(info_j, f))), f
    assert 0.0 < float(info_t.stretch_accept.mean()) < 1.0
    with pytest.raises(ValueError, match="n_low_modes"):
        ensemble.build_kernel(p.potential_fn, p.prior, 0)


def test_choose_n_low_modes_lives_in_kernels_ensemble():
    """One copy: the fused sampler's module re-exports the kernel's."""
    from ip_mcmc_tpu_torch.ops import fused_fes

    assert fused_fes.choose_n_low_modes is ensemble.choose_n_low_modes
    assert runner.choose_n_low_modes is ensemble.choose_n_low_modes


# --- the two linear-Gaussian configs -----------------------------------------------


def _conjugate():
    A, lam, y, sigma = configs.lingauss_arrays()
    return linear.conjugate_posterior(A, np.zeros(32), lam, sigma**2 * np.ones(16), y)


def _within_mc_error(samples, k=5.0):
    mean, cov = _conjugate()
    ess = diagnostics.summarize(samples)["ess"].numpy()
    err = np.abs(samples.reshape(-1, 32).mean(0).numpy() - mean)
    bound = k * np.sqrt(np.diag(cov)) / np.sqrt(ess)
    assert np.all(err <= bound), (err / bound).max()


def test_lingauss_elliptical_posterior_mean_is_the_conjugate_one():
    """ESS at 256 chains: 150 steps of burn-in, then 300 samples."""
    p = configs.build("lingauss_elliptical", "cpu")
    g = torch.Generator().manual_seed(11)
    kernel = elliptical.build_kernel(p.potential_fn, p.prior)
    state = elliptical.init(p.init_positions(g, 256), p.potential_fn)
    _, samples, info = driver.sample_chains(kernel, state, g, n_samples=300, burn_in=150)
    _within_mc_error(samples)
    assert 1.0 <= float(info.n_evals.mean()) < 6.0


def test_lingauss_fes_posterior_mean_is_the_conjugate_one():
    """FES with 256 walkers, M = 6, β 0.25: 300 steps of burn-in, then 400
    samples."""
    p = configs.build("lingauss_fes", "cpu")
    g = torch.Generator().manual_seed(12)
    _, samples, info = ensemble.sample_fes(
        p.potential_fn, p.prior, p.init_positions(g, 256), g, 6, pcn_beta=0.25,
        n_samples=400, burn_in=300)
    assert samples.shape == (400, 256, 32)
    _within_mc_error(samples)
    assert 0.05 < float(info.stretch_accept.mean()) < 0.95
    assert 0.05 < float(info.pcn_accept.mean()) < 0.95


@pytest.mark.parametrize("name", ["lingauss_elliptical", "lingauss_fes"])
def test_lingauss_runs_print_jax_runner_keys(name, capsys):
    """Through the CLI at 64 chains and 4 samples (the 500 burn-in steps in
    full) and through JAX's runner at the same size with a 4-step burn-in:
    the same keys (ESS: no accept_rate, mean_error_vs_exact; FES: the
    stretch acceptance as accept_rate and pcn_accept_rate)."""
    assert run.main(["--config", name, "--device", "cpu", "--n-chains", "64",
                     "--n-samples", "4"]) == 0
    m = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    jp = dataclasses.replace(jconfigs.build(name), burn_in=4)
    jm = jrunner.run_problem(jp, key=jax.random.key(0), n_chains=64, n_samples=4)
    assert set(m) - {"warning", "setup_s", "cli_total_s"} == set(jm) - {"warning"}
    assert m["kernel"] == jm["kernel"] and m["n_chains"] == 64
    assert ("accept_rate" in m) == (name == "lingauss_fes")
    assert ("mean_error_vs_exact" in m) == (name == "lingauss_elliptical")
    if name == "lingauss_fes":
        assert 0.0 < m["accept_rate"] < 1.0 and 0.0 < m["pcn_accept_rate"] < 1.0
        assert m["steps_per_s"] == pytest.approx(64 * 504 / m["run_s"])
    else:
        assert m["burn_steps"] == 500 and m["mean_error_vs_exact"] < 1.0
    assert np.isfinite(m["posterior_mean"]).all()


# --- what the runner refuses ---------------------------------------------------------

NOT_PORTED = {  # JAX config -> the kernel and parameters it runs
    "darcy_composed_pcn": ("pcn_composed", {"beta": 0.08}),
    "darcy_composed_mala": ("mala_composed", {"step_size": 0.05}),
    "darcy_composed_ess": ("ess_composed", {"max_shrink": 20}),
}


@pytest.mark.parametrize("name", sorted(NOT_PORTED))
def test_unported_configs_are_refused(name):
    """The CLI and configs.build refuse the JAX config by name, the runner a
    problem that asks for its kernel; each message names what is ported."""
    with pytest.raises(NotImplementedError, match="Ported: .*ode_mala"):
        run.main(["--config", name, "--device", "cpu"])
    kernel, kp = NOT_PORTED[name]
    assert jconfigs.build(name).kernel == kernel
    p = dataclasses.replace(configs.build("ode_mala", "cpu"), kernel=kernel, kernel_params=kp)
    with pytest.raises(NotImplementedError, match="scan rwm, pcn, da_pcn, elliptical, mala"):
        runner.run_problem(p, "cpu", n_chains=8, n_samples=2)


def test_pod_enrichment_is_refused(darcy_da):
    """pod_enrich with fused=True: the JAX runner's ValueError, before any
    enrichment (the fused branch reads batched_surrogate_fn, which
    enrichment does not rebuild)."""
    _, p = darcy_da
    p = dataclasses.replace(p, kernel_params={**p.kernel_params, "fused": True,
                                              "pod_enrich": {"epochs": 3}})
    with pytest.raises(ValueError, match="pod_enrich.*fused=True"):
        runner.run_problem(p, "cpu", n_chains=8, n_samples=2)
