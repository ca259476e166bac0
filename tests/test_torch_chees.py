"""ChEES-HMC on the scan path (``ip_mcmc_tpu_torch/kernels/chees_hmc.py``,
the runner's ``_run_chees``) and the config it unlocks, ``ode_chees``,
against the JAX package on the CPU.

A batch step from the draws JAX's ``batch_step`` makes from its key:
``split(key)`` → (momentum key, MH key), the normals (n, d) and uniforms
(n,) of the whole batch; under the warm-up and the sampling the key of
step i is ``fold_in(base_key, i)``. 16 chains of ``ode_chees``'s log π near
its posterior, with a diagonal mass.

Tolerances: the Halton jitter bit for bit; a step's leapfrog count equal;
the positions within 1e-5, log π within 1e-4 relative, the gradient within
1e-4 of each chain's largest entry, the acceptance probability within 1e-3
relative (``tests/test_torch_ode.py``'s for HMC), the same MH decisions.
The ChEES gradient and Adam on the same inputs within 1e-5 relative. The
warm-up on a Gaussian target from JAX's draws: ε, τ and the inverse mass
within 1e-3 relative (eight steps of f32 leapfrog trajectories whose
summation orders differ; measured below 1e-5)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ip_mcmc_tpu import configs as jconfigs
from ip_mcmc_tpu import runner as jrunner
from ip_mcmc_tpu.kernels import chees_hmc as jchees
from ip_mcmc_tpu_torch import configs, runner
from ip_mcmc_tpu_torch.kernels import chees_hmc

torch.set_num_threads(1)

N = 16


@pytest.fixture(scope="module")
def problems():
    return jconfigs.build("ode_chees"), configs.build("ode_chees", "cpu")


def jax_step_draws(key, n, d):
    """The normals (n, d) and uniforms (n,) of JAX's batch_step under
    ``key``."""
    key_mom, key_acc = jax.random.split(key)
    return (torch.tensor(np.asarray(jax.random.normal(key_mom, (n, d)))),
            torch.tensor(np.asarray(jax.random.uniform(key_acc, (n,)))))


def test_halton_matches_jax():
    idx = list(range(64)) + [299, 300, 1299, 65535, 2**31 - 1]
    got = np.array([chees_hmc.halton(i) for i in idx], np.float32)
    want = np.asarray(jax.vmap(jchees.halton)(jnp.asarray(idx, jnp.uint32)))
    np.testing.assert_array_equal(got, want)


def _close(got, want, rtol):
    err = np.abs(got - want).max(axis=-1)
    assert np.all(err <= rtol * np.abs(want).max(axis=-1)), (err / np.abs(want).max(-1)).max()


def test_batch_step_matches_jax(problems):
    """One step of u·τ = halton(4)·0.8 in steps of at most ε = 0.05 (the
    count ⌈u·τ/ε⌉ = 10), a diagonal mass: 10 of the 16 proposals
    accepted."""
    jp, p = problems
    pos = (np.asarray(jp.truth) + 0.02 * np.random.default_rng(2).standard_normal((N, 4))
           ).astype(np.float32)
    im = np.array([0.3, 0.2, 0.3, 0.1], np.float32)
    eps, tau, u = np.float32(0.05), np.float32(0.8), chees_hmc.halton(4)
    key = jax.random.key(6)
    sj = jchees.init(jnp.asarray(pos), jp.log_density_fn)
    new_j, info_j = jax.jit(lambda s, k: jchees.batch_step(
        jp.log_density_fn, s, k, eps, tau, jnp.float32(u), jnp.asarray(im)))(sj, key)
    st = chees_hmc.init(torch.tensor(pos), p.log_density_fn)
    new_t, info_t = chees_hmc.batch_step(p.log_density_fn, st, torch.tensor(eps),
                                         torch.tensor(tau), u, torch.tensor(im),
                                         *jax_step_draws(key, N, 4))
    assert int(np.ceil(np.float32(u) * tau / eps)) == 10
    np.testing.assert_array_equal(info_t.accepted.numpy(), np.asarray(info_j.accepted))
    assert 0 < int(info_t.accepted.sum()) < N
    np.testing.assert_allclose(info_t.proposal.numpy(), np.asarray(info_j.proposal), atol=1e-5)
    np.testing.assert_allclose(new_t.positions.numpy(), np.asarray(new_j.positions), atol=1e-5)
    np.testing.assert_allclose(new_t.log_densities.numpy(), np.asarray(new_j.log_densities),
                               rtol=1e-4)
    _close(new_t.grads.numpy(), np.asarray(new_j.grads), 1e-4)
    _close(info_t.final_velocity.numpy(), np.asarray(info_j.final_velocity), 1e-4)
    np.testing.assert_allclose(info_t.accept_prob.numpy(), np.asarray(info_j.accept_prob),
                               rtol=1e-3, atol=1e-5)


def test_chees_gradient_and_adam_match_jax():
    """The ChEES gradient on 64 chains with two diverged proposals (NaN and
    inf, masked out), then five Adam ascents."""
    rng = np.random.default_rng(3)
    x, xp, v = (rng.standard_normal((64, 4)).astype(np.float32) for _ in range(3))
    xp[3, 1], v[7, 0] = np.nan, np.inf
    ap = rng.uniform(size=64).astype(np.float32)
    u = chees_hmc.halton(9)
    gj = jchees.chees_gradient(
        jchees.CheesState(positions=jnp.asarray(x), log_densities=None, grads=None),
        jchees.CheesInfo(accept_prob=jnp.asarray(ap), accepted=None,
                         final_velocity=jnp.asarray(v), proposal=jnp.asarray(xp)),
        jnp.float32(u))
    gt = chees_hmc.chees_gradient(
        chees_hmc.CheesState(positions=torch.tensor(x), log_densities=None, grads=None),
        chees_hmc.CheesInfo(accept_prob=torch.tensor(ap), accepted=None,
                            final_velocity=torch.tensor(v), proposal=torch.tensor(xp)), u)
    assert np.isfinite(float(gt))
    np.testing.assert_allclose(float(gt), float(gj), rtol=1e-5)
    sj, st = jchees.adam_init(0.5), chees_hmc.adam_init(0.5)
    for g in (float(gj), -0.3, 0.7, 0.0, 2.5):
        sj, st = jchees.adam_ascend(sj, jnp.float32(g)), chees_hmc.adam_ascend(
            st, torch.tensor(g, dtype=torch.float32))
        for f in ("log_value", "m", "v", "t"):
            np.testing.assert_allclose(float(getattr(st, f)), float(getattr(sj, f)), rtol=1e-5,
                                       atol=1e-12, err_msg=f)


class JaxStepDraws:
    """Stands in for the port's generator draws: step i's normals and
    uniforms from ``fold_in(base_key, i)`` as JAX's batch_step splits it."""

    def __init__(self, base_key):
        self.base_key, self.step, self.u = base_key, 0, None

    def normals(self, generator, shape, device):
        z, self.u = jax_step_draws(jax.random.fold_in(self.base_key, self.step), *shape)
        self.step += 1
        return z

    def uniforms(self, generator, shape, device):
        return self.u


def _gaussian(lib):
    mean = lib.asarray([0.5, -1.0, 2.0, 0.0], dtype=lib.float32)
    scale = lib.asarray([1.0, 0.3, 2.0, 0.7], dtype=lib.float32)
    return lambda x: -0.5 * lib.sum(((x - mean) / scale) ** 2, axis=-1)


def test_warmup_chees_matches_jax(monkeypatch):
    """Eight warm-up steps on a 4-D Gaussian at 32 chains: ε (dual
    averaging, capped at τ), τ (Adam on the ChEES gradient) and the
    inverse mass (the chains' variances) against JAX's."""
    n, steps = 32, 8
    pos = np.random.default_rng(8).standard_normal((n, 4)).astype(np.float32)
    key = jax.random.key(9)
    sj, eps_j, tau_j, im_j = jchees.warmup_chees(_gaussian(jnp), jnp.asarray(pos), key,
                                                 num_steps=steps, initial_step_size=0.3,
                                                 initial_trajectory=1.0)
    draws = JaxStepDraws(key)
    monkeypatch.setattr(chees_hmc, "normals", draws.normals)
    monkeypatch.setattr(chees_hmc, "uniforms", draws.uniforms)
    st, eps_t, tau_t, im_t = chees_hmc.warmup_chees(_gaussian(torch), torch.tensor(pos), None,
                                                    num_steps=steps, initial_step_size=0.3,
                                                    initial_trajectory=1.0)
    assert draws.step == steps
    np.testing.assert_allclose(float(eps_t), float(eps_j), rtol=1e-3)
    np.testing.assert_allclose(float(tau_t), float(tau_j), rtol=1e-3)
    np.testing.assert_allclose(im_t.numpy(), np.asarray(im_j), rtol=1e-3)
    np.testing.assert_allclose(st.positions.numpy(), np.asarray(sj.positions), atol=1e-4)
    assert float(tau_t) != 1.0 and float(eps_t) != 0.3


def test_run_prints_jax_runner_keys(problems):
    """ode_chees through run_problem at 32 chains and 4 samples, the warm-up
    cut to 3 and no Adam iterations (the config's 300 warm-up steps and 300
    Adam iterations are minutes on the CPU; the chees path reports no
    map_init key): the JAX runner's keys (warmup_s, compile_s, run_s,
    diag_s, step_size, trajectory_length), finite values, the steps
    counted."""
    from ip_mcmc_tpu_torch.ops import _build

    jp, p = problems
    kp = {**p.kernel_params, "map_init": 0}
    p = dataclasses.replace(p, burn_in=3, kernel_params=kp)
    before = _build.launch_counts["scan_chees_step[cpu]"]
    m = runner.run_problem(p, "cpu", seed=0, n_chains=32, n_samples=4)
    jp = dataclasses.replace(jp, burn_in=3, kernel_params=kp)
    jm = jrunner.run_problem(jp, key=jax.random.key(0), n_chains=32, n_samples=4)
    assert set(m) - {"warning"} == set(jm) - {"warning"}
    assert m["kernel"] == jm["kernel"] == "chees"
    assert 0.0 < m["accept_rate"] <= 1.0 and 0.0 < m["step_size"] <= m["trajectory_length"]
    assert m["steps_per_s"] == pytest.approx(32 * 4 / m["run_s"])
    assert np.isfinite(m["posterior_mean"]).all()
    assert _build.launch_counts["scan_chees_step[cpu]"] == before + 3 + 2 * 4


def test_config_matches_jax(problems):
    jp, p = problems
    for attr in ("name", "dim", "kernel", "kernel_params", "n_chains", "n_samples",
                 "burn_in", "thin"):
        assert getattr(p, attr) == getattr(jp, attr), attr
    assert "ode_chees" in configs.REGISTRY
