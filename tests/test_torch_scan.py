"""The port's scan path (ip_mcmc_tpu_torch/kernels, driver.py, adapt/,
runner._run_one_dispatch) on the CPU: single steps against the JAX kernels
with JAX's own draws injected, the warm-ups and the two scan configs at a
reduced size against their closed-form posteriors, and the runner's keys
against the JAX runner's (its one-dispatch path, and the fused RWM branch
on gauss2d_rwm's target)."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ip_mcmc_tpu import configs as jconfigs
from ip_mcmc_tpu import runner as jrunner
from ip_mcmc_tpu.adapt import dual_averaging as jda
from ip_mcmc_tpu.kernels import base as jbase
from ip_mcmc_tpu.kernels import pcn as jpcn
from ip_mcmc_tpu.kernels import rwm as jrwm
from ip_mcmc_tpu_torch import configs, diagnostics, driver, run, runner
from ip_mcmc_tpu_torch.adapt import dual_averaging as da
from ip_mcmc_tpu_torch.adapt import warmup_pcn, warmup_rwm
from ip_mcmc_tpu_torch.kernels import base, pcn, rwm
from ip_mcmc_tpu_torch.models import linear

torch.set_num_threads(1)

N = 64


def chain_keys(seed):
    return jax.random.split(jax.random.key(seed), N)


def jax_draws(seed, d, centered=None):
    """Per chain, the normals and the uniform that a JAX kernel step under
    that chain's key draws: split(key) → (proposal key, MH key)."""
    def one(key):
        kp, ka = jax.random.split(key)
        xi = (jax.random.normal(kp, (d,)) if centered is None
              else centered.sample_centered(kp))
        return xi, jax.random.uniform(ka, ())

    xi, u = jax.vmap(one)(chain_keys(seed))
    return torch.tensor(np.asarray(xi)), torch.tensor(np.asarray(u))


def test_mh_select_matches_jax():
    """NaN maps to −∞ and rejects; accepted where log u < min(Δ, 0)."""
    r = np.random.default_rng(0)
    ratio = r.normal(-0.5, 1.5, N).astype(np.float32)
    ratio[:4] = [np.nan, np.inf, -np.inf, 0.0]
    keys = chain_keys(1)
    cur, prop = r.standard_normal((N, 3)).astype(np.float32), r.standard_normal((N, 3)).astype(np.float32)
    out_j = jax.vmap(jbase.mh_select)(keys, jnp.asarray(ratio), jnp.asarray(cur), jnp.asarray(prop))
    u = torch.tensor(np.asarray(jax.vmap(lambda k: jax.random.uniform(k, ()))(keys)))

    @dataclasses.dataclass
    class S:
        position: torch.Tensor

    new, acc, prob = base.mh_select(u, torch.from_numpy(ratio), S(torch.from_numpy(cur)),
                                    S(torch.from_numpy(prop)))
    np.testing.assert_array_equal(acc.numpy(), np.asarray(out_j[1]))
    np.testing.assert_allclose(prob.numpy(), np.asarray(out_j[2]), rtol=1e-6)
    np.testing.assert_array_equal(new.position.numpy(), np.asarray(out_j[0]))
    assert not acc[0] and acc[1] and prob[0] == 0.0


@pytest.mark.parametrize("scale", ["isotropic", "diagonal", "dense"])
def test_rwm_step_matches_jax(scale):
    cov = np.array([[2.0, 0.8], [0.8, 1.0]], np.float32)
    sc = {"isotropic": None, "diagonal": np.array([1.2, 0.6], np.float32),
          "dense": np.linalg.cholesky(cov).astype(np.float32)}[scale]
    prec = np.linalg.inv(cov).astype(np.float32)
    logpi_j = lambda x: -0.5 * x @ jnp.asarray(prec) @ x
    logpi_t = lambda x: -0.5 * torch.sum((x @ torch.from_numpy(prec)) * x, dim=-1)
    pos = np.random.default_rng(2).standard_normal((N, 2)).astype(np.float32)
    kj = jrwm.build_kernel(logpi_j, step_size=0.8, scale=None if sc is None else jnp.asarray(sc))
    kt = rwm.build_kernel(logpi_t, step_size=0.8, scale=None if sc is None else torch.from_numpy(sc))
    sj = jax.vmap(lambda p: jrwm.init(p, logpi_j))(jnp.asarray(pos))
    new_j, info_j = jax.vmap(kj)(chain_keys(3), sj)
    new_t, info_t = kt.transition(rwm.init(torch.from_numpy(pos), logpi_t), *jax_draws(3, 2))
    np.testing.assert_array_equal(info_t.accepted.numpy(), np.asarray(info_j.accepted))
    np.testing.assert_allclose(new_t.position.numpy(), np.asarray(new_j.position), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(new_t.log_density.numpy(), np.asarray(new_j.log_density), rtol=1e-5)
    assert 0 < int(info_t.accepted.sum()) < N


def test_pcn_step_matches_jax():
    """lingauss_pcn's misfit and KL prior; ξ is JAX's own
    prior.sample_centered draw."""
    jp, p = jconfigs.build("lingauss_pcn"), configs.build("lingauss_pcn", "cpu")
    pos = np.array(jp.prior.sample(jax.random.key(4), (N,)))
    kj = jpcn.build_kernel(jp.potential_fn, jp.prior, beta=0.3)
    kt = pcn.build_kernel(p.potential_fn, p.prior, beta=0.3)
    sj = jax.vmap(lambda x: jpcn.init(x, jp.potential_fn))(jnp.asarray(pos))
    new_j, info_j = jax.vmap(kj)(chain_keys(5), sj)
    new_t, info_t = kt.transition(pcn.init(torch.from_numpy(pos), p.potential_fn),
                                  *jax_draws(5, 32, centered=jp.prior))
    np.testing.assert_array_equal(info_t.accepted.numpy(), np.asarray(info_j.accepted))
    np.testing.assert_allclose(new_t.position.numpy(), np.asarray(new_j.position), atol=1e-6)
    np.testing.assert_allclose(info_t.accept_prob.numpy(), np.asarray(info_j.accept_prob),
                               rtol=1e-4, atol=1e-6)
    with pytest.raises(ValueError, match="beta"):
        pcn.build_kernel(p.potential_fn, p.prior, beta=1.5)


def test_dual_averaging_matches_jax():
    sj, st = jda.init(0.5), da.init(0.5)
    for a in np.random.default_rng(6).uniform(0, 1, 40).astype(np.float32):
        sj = jda.update(sj, jnp.float32(a), target=0.234)
        st = da.update(st, torch.tensor(a), target=0.234)
    for f in ("log_x", "log_x_avg", "h_avg", "t", "mu"):
        np.testing.assert_allclose(float(getattr(st, f)), float(getattr(sj, f)), rtol=1e-5)
    np.testing.assert_allclose(float(da.final(st)), float(jda.final(sj)), rtol=1e-5)


def mc_bound(samples, exact_mean, exact_sd, k=5.0):
    """|mean − exact| against k Monte Carlo standard errors sd/√ESS per
    coordinate (the port's multi-chain ESS)."""
    ess = diagnostics.summarize(samples)["ess"].numpy()
    err = np.abs(samples.reshape(-1, samples.shape[-1]).mean(0).numpy() - exact_mean)
    return err, k * exact_sd / np.sqrt(ess)


def test_warmup_rwm_then_sampling_gives_the_gaussian():
    """gauss2d_rwm's target at 256 chains: warm-up (step size by dual
    averaging, a dense proposal from the pooled covariance), then 200
    samples: mean within 5 MC standard errors, the covariance within
    10 %, and the adapted factor close to the target's."""
    p = configs.build("gauss2d_rwm", "cpu")
    g = torch.Generator().manual_seed(7)
    state = rwm.init(p.init_positions(g, 256), p.log_density_fn)
    state, step, chol = warmup_rwm(p.log_density_fn, state, g, num_steps=200,
                                   initial_step_size=1.0)
    kernel = rwm.build_kernel(p.log_density_fn, step_size=step, scale=chol)
    _, samples, info = driver.sample_chains(kernel, state, g, n_samples=200)
    assert samples.shape == (200, 256, 2) and info.accepted.shape == (200,)
    cov = np.array([[2.0, 0.8], [0.8, 1.0]])
    err, bound = mc_bound(samples, [1.0, -0.5], np.sqrt(np.diag(cov)))
    assert np.all(err <= bound), (err, bound)
    np.testing.assert_allclose(np.cov(samples.reshape(-1, 2).numpy().T), cov, rtol=0.1, atol=0.05)
    np.testing.assert_allclose((chol @ chol.T).numpy(), cov, rtol=0.25, atol=0.1)
    assert 0.15 < float(info.accepted.mean()) < 0.5  # target 0.234


def test_warmup_pcn_then_sampling_gives_the_conjugate_posterior():
    """lingauss_pcn at 256 chains, 300 warm-up steps (β adapted toward
    0.234), 300 samples with thin 2: mean within 5 MC standard errors of
    the conjugate posterior's, variances within 20 % on the well-mixed
    leading modes."""
    p = configs.build("lingauss_pcn", "cpu")
    A, lam, y, sigma = configs.lingauss_arrays()
    mean, cov = linear.conjugate_posterior(A, np.zeros(32), lam, sigma**2 * np.ones(16), y)
    g = torch.Generator().manual_seed(8)
    state = pcn.init(p.init_positions(g, 256), p.potential_fn)
    state, beta = warmup_pcn(p.potential_fn, p.prior, state, g, num_steps=300)
    assert 0.05 < float(beta) < 0.6
    kernel = pcn.build_kernel(p.potential_fn, p.prior, beta=beta)
    _, samples, info = driver.sample_chains(kernel, state, g, n_samples=300, thin=2)
    err, bound = mc_bound(samples, mean, np.sqrt(np.diag(cov)))
    assert np.all(err <= bound), (err, bound)
    var = samples.reshape(-1, 32).var(0).numpy()
    np.testing.assert_allclose(var[:4], np.diag(cov)[:4], rtol=0.2)
    assert 0.15 < float(info.accepted.mean()) < 0.4


@pytest.mark.parametrize("name", ["gauss2d_rwm", "lingauss_pcn"])
def test_scan_runs_print_jax_one_dispatch_keys(name, capsys):
    """Through the CLI on the CPU at 64 chains, 4 samples, a 4-step warm-up:
    the keys of the JAX runner's one-dispatch path (mean_error_vs_exact for
    lingauss_pcn only), sane values, and the step composition."""
    p = dataclasses.replace(configs.build(name, "cpu"), burn_in=4)
    m = runner.run_problem(p, "cpu", seed=0, n_chains=64, n_samples=4)
    assert run.main(["--config", name, "--device", "cpu", "--n-chains", "64",
                     "--n-samples", "4"]) == 0
    cli = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(cli) - {"warning", "setup_s", "cli_total_s"} == set(m) - {"warning"}

    jp = dataclasses.replace(jconfigs.build(name), burn_in=4)
    jm = jrunner.run_problem(jp, key=jax.random.key(0), n_chains=64, n_samples=4)
    for metrics in (m, jm):
        assert ("warning" in metrics) == (not metrics["converged"])
    assert set(m) - {"warning"} == set(jm) - {"warning"}
    assert m["kernel"] == jm["kernel"] == p.kernel
    assert (m["program_count"], m["trace_s"], m["compile_s"]) == (1, 0.0, 0.0)
    assert (m["warm_steps"], m["burn_steps"], m["sampling_steps"]) == (4, 0, 4)
    assert m["steps_per_s"] == pytest.approx(64 * 8 / m["run_s"])
    assert m["sampling_steps_per_s"] == pytest.approx(64 * 4 / m["run_s"])
    assert ("mean_error_vs_exact" in m) == (p.exact_mean is not None)
    assert (p.exact_mean is not None) == (name == "lingauss_pcn")
    assert 0.0 <= m["accept_rate"] <= 1.0
    assert len(m["posterior_mean"]) == p.dim and np.isfinite(m["posterior_mean"]).all()


def test_scan_runs_are_reproducible():
    """The two passes of _run_one_dispatch do identical work: a second
    run_problem from the same seed gives the same posterior mean."""
    p = dataclasses.replace(configs.build("gauss2d_rwm", "cpu"), burn_in=10)
    a = runner.run_problem(p, "cpu", seed=3, n_chains=32, n_samples=10)
    b = runner.run_problem(p, "cpu", seed=3, n_chains=32, n_samples=10)
    assert a["posterior_mean"] == b["posterior_mean"]
    assert a["accept_rate"] == b["accept_rate"]


def test_fused_rwm_branch_prints_jax_runner_keys():
    """gauss2d_rwm with its batched potential set by the caller and
    ``fused``: the runner's fused RWM branch (misfit + prior in the step),
    the JAX fused path's keys."""
    p = dataclasses.replace(
        configs.build("gauss2d_rwm", "cpu"), burn_in=4,
        batched_potential_fn=configs.gauss2d_batched_potential(),
        kernel_params={"step_size": 1.0, "adapt": True, "fused": True})
    m = runner.run_problem(p, "cpu", seed=0, n_chains=64, n_samples=4)

    mean = jnp.array([1.0, -0.5])
    prec = jnp.asarray(np.linalg.inv(configs.GAUSS2D_COV.astype(np.float64)), jnp.float32)

    def phi_batched(U):  # the JAX config's closure
        d = U - mean[:, None]
        return 0.5 * jnp.sum(d * (prec @ d), axis=0)

    jp = dataclasses.replace(
        jconfigs.build("gauss2d_rwm"), burn_in=4, batched_potential_fn=phi_batched,
        kernel_params={"step_size": 1.0, "adapt": True, "fused": True,
                       "block_chains": 32})
    jm = jrunner.run_problem(jp, key=jax.random.key(0), n_chains=64, n_samples=4)
    assert set(m) - {"warning"} == set(jm) - {"warning"}
    assert m["kernel"] == jm["kernel"] == "rwm(fused)"
    assert m["steps_per_s"] == pytest.approx(64 * 4 / m["run_s"])
    assert 0.0 < m["accept_rate"] <= 1.0
