"""ADVI of the port (``ip_mcmc_tpu_torch/vi.py``, the runner's ``_run_vi``
and ``_vi_warm_start``, the configs ``lingauss_advi``, ``darcy_advi`` and
``darcy_advi_warmstart``) against the JAX package on the CPU: the packed
Cholesky factor and both samplers from JAX's z, the first five Adam updates
of ``fit`` from JAX's z under the cosine schedule, ``posterior_moments``
and ``warm_start`` of JAX's fitted parameters (``convert.vi_params_from_arrays``),
and the three configs through the CLI with JAX's bounds
(``tests/test_vi_pt_configs.py``).

Tolerances. Samplers and moments are a few f32 operations: 1e-6. The five
updates: Adam divides the first moment by √ν + ε, so where a gradient
entry is near 0 a rounding of the gradient moves the update by up to the
learning rate; the parameters stay within 1e-5 of JAX's after five steps
(the gradient is a mean over 64 samples of f32 sums in another order),
the ELBO estimates within 1e-5 relative."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ip_mcmc_tpu import configs as jconfigs
from ip_mcmc_tpu import runner as jrunner
from ip_mcmc_tpu import vi as jvi
from ip_mcmc_tpu_torch import configs, convert, run, vi

torch.set_num_threads(1)

T = lambda x: torch.tensor(np.asarray(x))  # noqa: E731
D = 32


def jax_params(full_rank, seed):
    rng = np.random.default_rng(seed)
    mu = rng.normal(size=D).astype(np.float32)
    if full_rank:
        return jvi.FullRankParams(
            mu=jnp.asarray(mu),
            chol_flat=jnp.asarray(0.3 * rng.normal(size=D * (D + 1) // 2), jnp.float32))
    return jvi.MeanFieldParams(mu=jnp.asarray(mu),
                               log_sigma=jnp.asarray(0.3 * rng.normal(size=D), jnp.float32))


@pytest.mark.parametrize("full_rank", [False, True])
def test_samplers_moments_and_warm_start_match_jax(full_rank):
    jp = jax_params(full_rank, 0)
    p = convert.vi_params_from_arrays(jax.tree.map(np.asarray, jp))
    assert isinstance(p, vi.FullRankParams if full_rank else vi.MeanFieldParams)
    key = jax.random.key(1)
    z = jax.random.normal(key, (16, D))
    sampler = jvi._sample_and_logq_fullrank if full_rank else jvi._sample_and_logq_meanfield
    ju, jlogq = sampler(jp, key, 16)
    u, logq = vi._sampler(p)(p, T(z))
    np.testing.assert_allclose(u.numpy(), np.asarray(ju), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(logq.numpy(), np.asarray(jlogq), rtol=1e-6)
    for got, want in zip(vi.posterior_moments(p), jvi.posterior_moments(jp)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    if full_rank:
        np.testing.assert_allclose(vi._unpack_chol(p.chol_flat, D).numpy(),
                                   np.asarray(jvi._unpack_chol(jp.chol_flat, D)), rtol=1e-6)
    # warm_start: the family's draws from a generator's normals
    g = torch.Generator().manual_seed(4)
    z = torch.randn((8, D), generator=g)
    np.testing.assert_allclose(vi.warm_start(p, torch.Generator().manual_seed(4), 8).numpy(),
                               vi._sampler(p)(p, z)[0].numpy())


@pytest.mark.parametrize("full_rank", [False, True])
def test_first_five_updates_match_jax(full_rank):
    """fit on lingauss_pcn's log posterior, num_steps = 5 (so the cosine
    schedule runs its whole course), each step's z that JAX draws
    (fold_in(key, t)); learning rate 0.05, 64 samples."""
    jp, p = jconfigs.build("lingauss_pcn"), configs.build("lingauss_pcn", "cpu")
    key = jax.random.key(2)
    jparams, jtrace = jvi.fit(jp.log_density_fn, D, key, num_steps=5, n_samples=64,
                              learning_rate=5e-2, full_rank=full_rank)
    z = torch.stack([T(jax.random.normal(jax.random.fold_in(key, t), (64, D)))
                     for t in range(5)])
    params, trace = vi.fit(p.log_density_fn, D, torch.Generator(), num_steps=5,
                           n_samples=64, learning_rate=5e-2, full_rank=full_rank, z=z)
    np.testing.assert_allclose(trace.numpy(), np.asarray(jtrace), rtol=1e-5)
    for f in dataclasses.fields(params):
        np.testing.assert_allclose(getattr(params, f.name).numpy(),
                                   np.asarray(getattr(jparams, f.name)), atol=1e-5)
    assert [vi.cosine_decay(5e-2, t, 5) for t in (0, 5)] == [
        pytest.approx(5e-2, rel=1e-7), 0.0]


@pytest.fixture(scope="module")
def jax_vi_keys():
    """The keys of the JAX runner's _run_vi (lingauss_advi, 10 steps)."""
    jp = jconfigs.build("lingauss_advi")
    jp.kernel_params["num_steps"] = 10
    return set(jrunner.run_problem(jp, key=jax.random.key(0)))


def _cli(name, capsys):
    assert run.main(["--config", name, "--device", "cpu"]) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_lingauss_advi_matches_exact_posterior(jax_vi_keys, capsys):
    """Full-rank ADVI through the CLI as shipped (3000 steps): the family
    holds the exact posterior, so its moments converge to the closed form."""
    m = _cli("lingauss_advi", capsys)
    assert set(m) - {"setup_s", "cli_total_s"} == jax_vi_keys
    assert m["kernel"] == "vi(full_rank)" and m["num_steps"] == 3000
    assert m["mean_error_vs_exact"] < 0.02 and m["cov_error_vs_exact"] < 0.02
    assert np.isfinite(m["final_elbo"])


def _reduced(monkeypatch, name, cut):
    """The registry's builder of ``name`` with ``cut`` applied to its
    Problem: the CLI at a reduced size."""
    build = configs.REGISTRY[name]

    def reduced(device):
        p = build(device)
        cut(p)
        return p

    monkeypatch.setitem(configs.REGISTRY, name, reduced)


def test_darcy_advi_runs(jax_vi_keys, monkeypatch, capsys):
    """Mean-field ADVI through the Darcy forward's implicit adjoint, the CLI
    cut to 20 steps: _run_vi's keys (no exact covariance)."""
    _reduced(monkeypatch, "darcy_advi", lambda p: p.kernel_params.update(num_steps=20))
    m = _cli("darcy_advi", capsys)
    assert set(m) - {"setup_s", "cli_total_s"} == jax_vi_keys - {"cov_error_vs_exact"}
    assert m["kernel"] == "vi(mean_field)" and m["num_steps"] == 20
    assert np.isfinite(m["final_elbo"]) and len(m["posterior_mean"]) == 64


# the JAX runner's keys of darcy_advi_warmstart: _run_one_dispatch's on the
# adaptive pCN and _vi_warm_start's four (ip_mcmc_tpu/runner.py)
WARMSTART_KEYS = {
    "accept_rate", "burn_steps", "compile_s", "config", "converged", "dim", "ess_per_s",
    "ess_per_total_wall_s", "first_dispatch_s", "init_potential_prior",
    "init_potential_vi", "kernel", "max_rhat", "min_ess", "n_chains", "n_samples",
    "posterior_mean", "program_count", "run_s", "sampling_steps",
    "sampling_steps_per_s", "steps_per_s", "total_wall_s", "trace_s", "unattributed_s",
    "vi_final_elbo", "vi_fit_s", "warm_steps"}


def test_darcy_advi_warmstart_cuts_initial_misfit(monkeypatch, capsys):
    """At tests/test_vi_pt_configs.py's sizes (64 chains, 60 samples,
    burn-in 40, 300 VI steps), through the CLI: the VI-initialised chains
    start at a far lower data misfit than prior draws."""
    def cut(p):
        p.n_chains, p.n_samples, p.burn_in = 64, 60, 40
        p.kernel_params["vi_init"]["num_steps"] = 300

    _reduced(monkeypatch, "darcy_advi_warmstart", cut)
    m = _cli("darcy_advi_warmstart", capsys)
    assert set(m) - {"setup_s", "cli_total_s", "warning"} == WARMSTART_KEYS
    assert m["init_potential_vi"] < 0.2 * m["init_potential_prior"]
    assert m["vi_fit_s"] > 0 and m["n_chains"] == 64 and m["warm_steps"] == 40
