"""The port's observation operators (ip_mcmc_tpu_torch/observations.py)
and reference-name API (ip_mcmc_tpu_torch/api.py) against the JAX
package's, on the CPU.

Tolerances:
- the index gathers (point, time-point, the grid subsample) are copies:
  equal exactly;
- the linear observation is one f32 matrix product in another summation
  order: 1e-6 relative;
- one RW and one pCN transition of ``MCMCSampler`` from JAX's draws (the
  proposal's normals and the accept test's uniform of each chain's key):
  the positions within 1e-6 (the same f32 arithmetic; pCN's √(1 − β²) is
  the same Python float on both sides), the log acceptance ratios within
  1e-5 relative (a Gaussian log-density whitened by a triangular solve on
  one side, a Cholesky solve on the other), and the same decisions;
- JAX's seven API cases (tests/test_api.py) run on the port with their
  own tolerances: the Monte Carlo bounds are the JAX test's (its chains
  and sample counts, the port's draws), the density-form ratio within
  1e-5 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ip_mcmc_tpu import api as japi
from ip_mcmc_tpu import driver as jdriver
from ip_mcmc_tpu import observations as jobs
from ip_mcmc_tpu_torch import api, observations
from ip_mcmc_tpu_torch.kernels.base import normals, uniforms
from ip_mcmc_tpu_torch.models import darcy, linear

torch.set_num_threads(1)


def _rng(seed=0):
    return np.random.default_rng(seed)


# --- the observation operators -------------------------------------------------


def test_point_observation_is_the_jax_gather():
    x = _rng(0).standard_normal((5, 40)).astype(np.float32)
    idx = [3, 17, 0, 39, 17]
    got = observations.point_observation(idx)(torch.tensor(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jobs.point_observation(idx)(jnp.asarray(x))))


@pytest.mark.parametrize("space", [None, [1, 4, 6]])
def test_time_point_observation_is_the_jax_gather(space):
    traj = _rng(1).standard_normal((3, 10, 8)).astype(np.float32)
    times = [0, 4, 9]
    got = observations.time_point_observation(times, space)(torch.tensor(traj)).numpy()
    want = np.asarray(jobs.time_point_observation(times, space)(jnp.asarray(traj)))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_linear_observation_matches_jax():
    x = _rng(2).standard_normal((6, 32)).astype(np.float32)
    w = _rng(3).standard_normal((7, 32)).astype(np.float32)
    got = observations.linear_observation(w)(torch.tensor(x)).numpy()
    want = np.asarray(jobs.linear_observation(w)(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("n_grid, per_dim", [(16, 4), (32, 5), (64, 8)])
def test_subsample_grid_2d_matches_jax_and_darcy(n_grid, per_dim):
    got = observations.subsample_grid_2d(n_grid, per_dim)
    np.testing.assert_array_equal(got, jobs.subsample_grid_2d(n_grid, per_dim))
    np.testing.assert_array_equal(got, darcy.default_observation_indices(n_grid, per_dim))


# --- JAX's seven API cases on the port -------------------------------------------


def test_rwm_analytic_experiment_script():
    target = api.GaussianDistribution(np.array([1.0, -0.5]), np.array([[2.0, 0.8], [0.8, 1.0]]),
                                      device="cpu")
    proposer = api.StandardRWProposer(0.8, 2)
    accepter = api.CountedAccepter(api.AnalyticAccepter(log_density_fn=target.log_density))
    sampler = api.MCMCSampler(proposer, accepter, rng=0, device="cpu")
    samples = sampler.run(np.zeros(2), n_samples=2000, burn_in=500)
    assert samples.shape == (2000, 2)
    np.testing.assert_allclose(samples.mean(axis=0), [1.0, -0.5], atol=0.3)
    assert 0.05 < accepter.acceptance_rate < 0.9


def test_pcn_inverse_problem_experiment_script():
    prior = api.GaussianDistribution(np.zeros(2), np.eye(2), device="cpu")
    A = torch.tensor([[1.0, 0.0], [0.0, 1.0], [1.0, 1.0]])
    noise = api.GaussianDistribution(np.zeros(3), 0.25 * np.eye(3), device="cpu")
    y = (A @ torch.tensor([0.7, -0.3])).numpy()  # noiseless data, for determinism
    potential = api.EvolutionPotential(lambda u: u @ A.T, y, noise)
    accepter = api.CountedAccepter(api.pCNAccepter(potential))
    sampler = api.MCMCSampler(api.pCNProposer(0.3, prior), accepter, rng=1, device="cpu")
    samples = sampler.run(np.zeros(2), n_samples=500, burn_in=300, n_chains=64)
    assert samples.shape == (500, 64, 2)
    mean, cov = linear.conjugate_posterior(A.numpy(), np.zeros(2), np.eye(2),
                                           0.25 * np.eye(3), y)
    flat = samples.reshape(-1, 2)
    np.testing.assert_allclose(flat.mean(axis=0), mean, atol=0.05)
    np.testing.assert_allclose(np.cov(flat.T), cov, atol=0.08)
    assert accepter.calls > 0


def test_standard_rw_accepter_posterior():
    prior = api.GaussianDistribution(np.zeros(2), 4.0 * np.eye(2), device="cpu")
    target = api.GaussianDistribution(np.array([1.0, 1.0]), 0.5 * np.eye(2), device="cpu")
    sampler = api.MCMCSampler(api.StandardRWProposer(0.7, 2),
                              api.StandardRWAccepter(api.AnalyticPotential(target.log_density),
                                                     prior), rng=2, device="cpu")
    samples = sampler.run(np.zeros(2), n_samples=500, burn_in=200, n_chains=32)
    prec = np.eye(2) / 0.5 + np.eye(2) / 4.0
    exact_mean = np.linalg.solve(prec, np.array([1.0, 1.0]) / 0.5)
    np.testing.assert_allclose(samples.reshape(-1, 2).mean(axis=0), exact_mean, atol=0.08)


def test_independent_and_lognormal():
    d = api.IndependentDistributions(
        [api.GaussianDistribution(np.zeros(2), np.eye(2), device="cpu"),
         api.LogNormalDistribution(np.zeros(1), np.ones(1), device="cpu")])
    assert d.dim == 3
    s = d.sample(torch.Generator().manual_seed(0), (100,))
    assert s.shape == (100, 3)
    assert bool(torch.all(s[:, 2] > 0))
    x = np.array([0.1, 0.2, 1.0], np.float32)
    got = float(d.log_density(torch.tensor(x)))
    jd = japi.IndependentDistributions([japi.GaussianDistribution(np.zeros(2), np.eye(2)),
                                        japi.LogNormalDistribution(np.zeros(1), np.ones(1))])
    assert np.isfinite(got)
    assert got == pytest.approx(float(jd.log_density(jnp.asarray(x))), rel=1e-6)


def test_analytic_accepter_density_form():
    target = api.GaussianDistribution(np.zeros(1), np.eye(1), device="cpu")
    a1 = api.AnalyticAccepter(density=target.density)
    a2 = api.AnalyticAccepter(log_density_fn=target.log_density)
    u, v = torch.tensor([[0.1]]), torch.tensor([[0.5]])
    r1, _ = a1.log_ratio(a1.init_cache(u), u, v)
    r2, _ = a2.log_ratio(a2.init_cache(u), u, v)
    np.testing.assert_allclose(r1.numpy(), r2.numpy(), rtol=1e-5)


def test_invalid_beta_rejected():
    prior = api.GaussianDistribution(np.zeros(2), np.eye(2), device="cpu")
    with pytest.raises(ValueError):
        api.pCNProposer(1.5, prior)


def test_counted_accepter_exact_vs_python_loop():
    """The count is every MH step of every chain, burn-in included: a
    replay of the kernel step by step from the same generator, counting
    the accepts directly, gives the same number."""
    target = api.GaussianDistribution(np.array([1.0, -0.5]), np.array([[2.0, 0.8], [0.8, 1.0]]),
                                      device="cpu")
    proposer = api.StandardRWProposer(0.9, 2)
    accepter = api.CountedAccepter(api.AnalyticAccepter(log_density_fn=target.log_density))
    n_chains, burn_in, n_samples, thin = 5, 37, 50, 3
    sampler = api.MCMCSampler(proposer, accepter, rng=7, device="cpu")
    u0 = torch.zeros(n_chains, 2)
    sampler.run(u0, n_samples=n_samples, burn_in=burn_in, sample_interval=thin)

    replay = api.MCMCSampler(proposer, accepter, rng=7, device="cpu")
    state = replay.init(u0)
    n_steps = burn_in + n_samples * thin
    count = 0
    for _ in range(n_steps):
        z = normals(replay.generator, (n_chains, 2), "cpu")
        state, info, _ = replay.transition(state, z, uniforms(replay.generator, (n_chains,), "cpu"))
        count += int(info.accepted.sum())
    assert accepter.calls == n_steps * n_chains
    assert accepter.accepts == count
    assert 0 < count < n_steps * n_chains


@pytest.mark.skipif(torch.cuda.is_available(), reason="the card is there to run on")
def test_api_runs_on_the_card_unless_asked_for_the_cpu():
    """As the port's other entry points: with no ``device``, the sampler
    and the distributions ask for the card, and raise without one."""
    prior = api.GaussianDistribution(np.zeros(2), np.eye(2), device="cpu")
    accepter = api.pCNAccepter(api.AnalyticPotential(prior.log_density))
    with pytest.raises(RuntimeError, match="cuda"):
        api.MCMCSampler(api.pCNProposer(0.5, prior), accepter, rng=0)
    with pytest.raises(RuntimeError, match="cuda"):
        api.GaussianDistribution(np.zeros(2), np.eye(2))
    with pytest.raises(RuntimeError, match="cuda"):
        api.LogNormalDistribution(np.zeros(1), np.ones(1))
    sampler = api.MCMCSampler(api.pCNProposer(0.5, prior), accepter, rng=0, device="cpu")
    assert sampler.generator.device.type == "cpu"


# --- one transition from JAX's draws ------------------------------------------------


def _jax_step(jsampler, u0, key):
    """JAX's first step of ``jsampler`` on the chains u0 (n, d): each
    chain's normals and uniform (its key split into the proposal's and the
    accept test's, as ``api.MCMCSampler._kernel`` does), its proposal, new
    position and log ratio."""
    u0 = jnp.asarray(u0)
    n, d = u0.shape
    keys = jdriver.chain_keys(key, 0, n)
    split = jax.vmap(jax.random.split)(keys)
    z = jax.vmap(lambda k: jax.random.normal(k, (d,), dtype=u0.dtype))(split[:, 0])
    u = jax.vmap(lambda k: jax.random.uniform(k, (), dtype=u0.dtype))(split[:, 1])
    state = jax.vmap(lambda p: japi._MHState(position=p,
                                             cache=jsampler.accepter.init_cache(p)))(u0)
    new, info = jax.vmap(jsampler._kernel())(keys, state)
    log_ratio = jax.vmap(lambda c, p, v: jsampler.accepter.log_ratio(c, p, v)[0])(
        state.cache, state.position, info.proposal)
    return (np.asarray(z), np.asarray(u), np.asarray(info.proposal), np.asarray(new.position),
            np.asarray(log_ratio), np.asarray(info.accepted))


@pytest.mark.parametrize("kind", ["rw", "pcn"])
def test_one_transition_from_jax_draws(kind):
    mean, cov = np.array([1.0, -0.5, 0.3]), np.array([[2.0, 0.8, 0.1], [0.8, 1.0, 0.2],
                                                      [0.1, 0.2, 0.5]])
    u0 = (1.5 * _rng(4).standard_normal((64, 3))).astype(np.float32)
    if kind == "rw":
        j = japi.MCMCSampler(japi.StandardRWProposer(0.9, 3), japi.AnalyticAccepter(
            log_density_fn=japi.GaussianDistribution(mean, cov).log_density), rng=3)
        t = api.MCMCSampler(api.StandardRWProposer(0.9, 3), api.AnalyticAccepter(
            log_density_fn=api.GaussianDistribution(mean, cov, device="cpu").log_density), rng=3,
            device="cpu")
    else:
        y = np.array([0.4, -0.2], np.float32)
        G = np.array([[1.0, 0.5, 0.0], [0.0, 1.0, -1.0]], np.float32)
        j = japi.MCMCSampler(
            japi.pCNProposer(0.4, japi.GaussianDistribution(np.zeros(3), cov)),
            japi.pCNAccepter(japi.EvolutionPotential(
                lambda u: jnp.asarray(G) @ u, y, japi.GaussianDistribution(np.zeros(2),
                                                                          0.04 * np.eye(2)))),
            rng=3)
        t = api.MCMCSampler(
            api.pCNProposer(0.4, api.GaussianDistribution(np.zeros(3), cov, device="cpu")),
            api.pCNAccepter(api.EvolutionPotential(
                lambda u: u @ torch.tensor(G).T, y,
                api.GaussianDistribution(np.zeros(2), 0.04 * np.eye(2), device="cpu"))),
            rng=3, device="cpu")
    z, u, prop, pos, log_ratio, accepted = _jax_step(j, u0, jax.random.key(3))
    new, info, got_ratio = t.transition(t.init(torch.tensor(u0)), torch.tensor(z),
                                        torch.tensor(u))
    np.testing.assert_allclose(info.proposal.numpy(), prop, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got_ratio.numpy(), log_ratio, rtol=1e-5,
                               atol=1e-5 * np.abs(log_ratio).max())
    np.testing.assert_array_equal(info.accepted.numpy(), accepted)
    np.testing.assert_allclose(new.position.numpy(), pos, rtol=0, atol=1e-6)
    assert 0 < accepted.sum() < len(accepted)
