"""Parallel tempering on the scan path (``ip_mcmc_tpu_torch/kernels/
tempering.py``, ``runner._run_pt``) and its configs ``multimodal_pt`` and
``multimodal_pt_mala``, against the JAX package on the CPU: the ladders,
one transition of the pCN and the MALA ladder from the draws JAX's kernels
make from their keys (replicas, potentials, gradients and swaps within f32
rounding, the same decisions), the bimodal potential, the cold chain's mode
balance and the runs' keys.

Tolerances. The bimodal potential is a few f32 operations in the same
order on both sides: positions within 1e-6, potentials and gradients within
1e-5 relative (logaddexp and the prior's autodiff are summed in other
orders)."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ip_mcmc_tpu import configs as jconfigs
from ip_mcmc_tpu import runner as jrunner
from ip_mcmc_tpu.kernels import tempering as jtempering
from ip_mcmc_tpu_torch import configs, run, runner
from ip_mcmc_tpu_torch.kernels import tempering

torch.set_num_threads(1)

N, TEMPS = 32, 8
POS_ATOL, RTOL = 1e-6, 1e-5
PT = ("multimodal_pt", "multimodal_pt_mala")
T = lambda x: torch.tensor(np.asarray(x))  # noqa: E731


@pytest.fixture(scope="module")
def problems():
    return {name: (jconfigs.build(name), configs.build(name, "cpu")) for name in PT}


def test_ladders_match_jax():
    np.testing.assert_allclose(tempering.geometric_ladder(8, 0.05).numpy(),
                               np.asarray(jtempering.geometric_ladder(8, 0.05)), rtol=1e-6)
    rho = np.random.default_rng(0).standard_normal(7).astype(np.float32)
    np.testing.assert_allclose(tempering.betas_from_shares(T(rho), 0.05).numpy(),
                               np.asarray(jtempering.betas_from_shares(jnp.asarray(rho), 0.05)),
                               rtol=1e-6)
    np.testing.assert_allclose(tempering.betas_from_gaps(T(rho)).numpy(),
                               np.asarray(jtempering.betas_from_gaps(jnp.asarray(rho))),
                               rtol=1e-6)
    b = tempering.betas_from_shares(torch.zeros(7), 0.05)
    np.testing.assert_allclose(b.numpy(), tempering.geometric_ladder(8, 0.05).numpy(), rtol=1e-6)


def test_bimodal_potential_and_configs_match_jax(problems):
    jp, p = problems["multimodal_pt"]
    u = (3.0 * np.random.default_rng(1).standard_normal((64, 2))).astype(np.float32)
    np.testing.assert_allclose(p.potential_fn(T(u)).numpy(),
                               np.asarray(jax.vmap(jp.potential_fn)(jnp.asarray(u))), rtol=RTOL)
    for name in PT:
        jp, p = problems[name]
        for attr in ("name", "dim", "kernel", "kernel_params", "n_chains", "n_samples",
                     "burn_in", "thin"):
            assert getattr(p, attr) == getattr(jp, attr), (name, attr)
        np.testing.assert_array_equal(p.truth, np.asarray(jp.truth))


def _ladder_state(jp, seed, mala):
    """A state with its replicas spread over both modes and parities mixed
    across the chains."""
    rng = np.random.default_rng(seed)
    pos = (2.5 * rng.standard_normal((N, TEMPS, 2))).astype(np.float32)
    parity = (np.arange(N) % 2).astype(np.int32)
    flat = jnp.asarray(pos.reshape(-1, 2))
    if mala:
        phi, g = jax.vmap(jax.value_and_grad(jp.potential_fn))(flat)
        return jtempering.PTMalaState(
            positions=jnp.asarray(pos), potentials=phi.reshape(N, TEMPS),
            phi_grads=g.reshape(N, TEMPS, 2), parity=jnp.asarray(parity))
    phi = jax.vmap(jp.potential_fn)(flat)
    return jtempering.PTState(positions=jnp.asarray(pos), potentials=phi.reshape(N, TEMPS),
                              parity=jnp.asarray(parity))


@pytest.mark.parametrize("mutation", ["pcn", "mala"])
def test_transition_matches_jax(problems, mutation):
    """One step of the geometric 8-rung ladder: per chain split(key, 3) →
    (proposal, mutation MH, swaps); pCN step 0.4, MALA step 0.25."""
    jp, p = problems["multimodal_pt" if mutation == "pcn" else "multimodal_pt_mala"]
    mala = mutation == "mala"
    betas = np.asarray(jtempering.geometric_ladder(TEMPS, 0.05))
    sj = _ladder_state(jp, 2, mala)
    if mala:
        kj = jtempering.build_mala_kernel(jp.potential_fn, jp.prior, betas, step_size=0.25)
        kt = tempering.build_mala_kernel(p.potential_fn, p.prior, T(betas), step_size=0.25)
        st = tempering.PTMalaState(positions=T(sj.positions), potentials=T(sj.potentials),
                                   phi_grads=T(sj.phi_grads), parity=T(sj.parity))
    else:
        kj = jtempering.build_kernel(jp.potential_fn, jp.prior, betas, pcn_step=0.4)
        kt = tempering.build_kernel(p.potential_fn, p.prior, T(betas), pcn_step=0.4)
        st = tempering.PTState(positions=T(sj.positions), potentials=T(sj.potentials),
                               parity=T(sj.parity))
    keys = jax.random.split(jax.random.key(3), N)
    new_j, info_j = jax.vmap(kj)(keys, sj)

    def draws(key):
        kp, ka, ks = jax.random.split(key, 3)
        xi = (jax.random.normal(kp, (TEMPS, 2)) if mala
              else jp.prior.sample_centered(kp, (TEMPS,)))
        return xi, jax.random.uniform(ka, (TEMPS,)), jax.random.uniform(ks, (TEMPS,))

    new_t, info_t = kt.transition(st, *(T(x) for x in jax.vmap(draws)(keys)))
    np.testing.assert_allclose(new_t.positions.numpy(), np.asarray(new_j.positions),
                               atol=POS_ATOL)
    np.testing.assert_allclose(new_t.potentials.numpy(), np.asarray(new_j.potentials),
                               rtol=RTOL)
    if mala:
        np.testing.assert_allclose(new_t.phi_grads.numpy(), np.asarray(new_j.phi_grads),
                                   rtol=RTOL, atol=1e-4)
    np.testing.assert_array_equal(new_t.parity.numpy(), np.asarray(new_j.parity))
    np.testing.assert_array_equal(info_t.cold_accepted.numpy(),
                                  np.asarray(info_j.cold_accepted))
    for f in ("accept_rate", "swap_rate", "pair_active"):
        np.testing.assert_array_equal(getattr(info_t, f).numpy(),
                                      np.asarray(getattr(info_j, f)), err_msg=f)
    np.testing.assert_allclose(info_t.pair_swap_prob.numpy(), np.asarray(info_j.pair_swap_prob),
                               rtol=RTOL, atol=1e-6)
    assert 0.0 < float(info_t.swap_rate.mean()) < 1.0


def test_multimodal_pt_balances_the_modes(problems):
    """At the config's size (256 chains, 300 adaptation steps, 800
    samples): the cold chain's share in the positive mode in [0.3, 0.7], the
    adapted ladder pinned at 1 and beta_min and decreasing, every pair
    swapping."""
    _, p = problems["multimodal_pt"]
    m = runner.run_problem(p, "cpu", seed=0)
    assert 0.3 <= m["mode_balance"] <= 0.7, m["mode_balance"]
    b = np.asarray(m["betas"])
    assert b[0] == pytest.approx(1.0) and b[-1] == pytest.approx(0.05, rel=1e-5)
    assert np.all(np.diff(b) < 0)
    assert min(m["swap_rate_per_pair"]) > 0.05 and len(m["adapt_pair_rates"]) == 7


@pytest.mark.parametrize("name", PT)
def test_runs_print_jax_runner_keys(problems, name, capsys):
    """Through the CLI at 64 chains and 4 samples (300 adaptation steps in
    full) beside JAX's runner with 4 adaptation steps: the same keys
    (n_temps, replica_steps_per_s, swap_rate_per_attempt, the per-pair
    rates, betas, mode_balance), and the ladder steps counted."""
    from ip_mcmc_tpu_torch.ops import _build

    step = "scan_pt_mala_step[cpu]" if name.endswith("mala") else "scan_pt_step[cpu]"
    before = _build.launch_counts[step]
    assert run.main(["--config", name, "--device", "cpu", "--n-chains", "64",
                     "--n-samples", "4"]) == 0
    m = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert _build.launch_counts[step] == before + 300 + 2 * 4
    jp = dataclasses.replace(problems[name][0], burn_in=4)
    jm = jrunner.run_problem(jp, key=jax.random.key(0), n_chains=64, n_samples=4)
    assert set(m) - {"warning", "setup_s", "cli_total_s"} == set(jm) - {"warning"}
    assert m["kernel"] == jm["kernel"] and m["n_temps"] == 8 and len(m["betas"]) == 8
    assert m["replica_steps_per_s"] == pytest.approx(8 * m["steps_per_s"])
    assert 0.0 <= m["mode_balance"] <= 1.0 and 0.0 < m["swap_rate_per_attempt"] < 1.0
    assert len(m["swap_rate_per_pair"]) == 7


def test_adapt_ladder_refuses_an_unknown_mutation(problems):
    _, p = problems["multimodal_pt"]
    with pytest.raises(ValueError, match="mutation"):
        tempering.adapt_ladder(p.potential_fn, p.prior, torch.zeros(4, 2),
                               torch.Generator(), mutation="rwm")
    state = tempering.init(torch.ones(4, 2), p.potential_fn, 8)
    assert tempering.cold_chain(state).shape == (4, 2)
    assert tempering.cold_chain(torch.zeros(5, 4, 8, 2)).shape == (5, 4, 2)
