"""NUTS on the scan path (``ip_mcmc_tpu_torch/kernels/nuts.py``,
``adapt/warmup.py`` ``warmup_nuts``, the runner's ``nuts`` branch) and the
config it unlocks, ``ode_nuts`` (BASELINE 3b), against the JAX package on
the CPU.

A transition from the draws JAX's kernel makes from its keys: per chain
``split(key)`` → (momentum key, tree key); per doubling ``split(key, 4)`` →
(key, direction, subtree, merge) with the direction ``bernoulli`` (a uniform
below 0.5); per leaf of the subtree ``split(key)`` → (key, selection).
Rebuilt here for every doubling and leaf up to ``max_depth`` (those JAX
does not reach are not read). 16 chains of ``ode_nuts``'s log π near its
posterior, at max depth 4 (unit mass) and 8 (a diagonal mass).

Tolerances: those of ``tests/test_torch_ode.py`` for MALA and HMC (the
positions within 1e-5, log π within 1e-4 relative, the gradient within
1e-4 of each chain's largest entry, the mean leaf acceptance within 1e-3
relative), and the tree's decisions equal: depth, leapfrog steps, the
divergence and U-turn flags. The warm-up on a Gaussian target, the
chains' draws JAX's (``chain_keys``): over six transitions of up to 31
leaves the two f32 trajectories part by up to 2e-4 of a position (measured
1.9e-4 on positions up to 5.3), so the positions within 5e-4, the step size
within 1e-4 relative (measured 1.8e-6) and the inverse mass, the chains'
variances, within 1e-3 relative (measured 1.1e-4)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ip_mcmc_tpu import configs as jconfigs
from ip_mcmc_tpu import runner as jrunner
from ip_mcmc_tpu.adapt import warmup as jwarmup
from ip_mcmc_tpu.kernels import nuts as jnuts
from ip_mcmc_tpu_torch import configs, runner
from ip_mcmc_tpu_torch.adapt import warmup_nuts
from ip_mcmc_tpu_torch.kernels import nuts

torch.set_num_threads(1)

N = 16
GRAD_RTOL = 1e-4


@pytest.fixture(scope="module")
def problems():
    return jconfigs.build("ode_nuts"), configs.build("ode_nuts", "cpu")


def _one_chain_draws(key, d, max_depth):
    """One chain's draws of a JAX NUTS transition from its key: z (d,),
    the doublings' direction uniforms (bernoulli: u < 0.5) and merge
    uniforms (max_depth,), the leaves' selection uniforms (2^max_depth − 1,)."""
    key_mom, key = jax.random.split(key)
    z = jax.random.normal(key_mom, (d,))
    u_dir, u_merge, u_sel = [], [], []

    def leaf(k, _):
        k, key_sel = jax.random.split(k)
        return k, jax.random.uniform(key_sel, ())

    for j in range(max_depth):
        key, key_dir, key_sub, key_merge = jax.random.split(key, 4)
        u_dir.append(jax.random.uniform(key_dir, ()))
        u_merge.append(jax.random.uniform(key_merge, ()))
        u_sel.append(jax.lax.scan(leaf, key_sub, None, length=1 << j)[1])
    return z, jnp.stack(u_dir), jnp.stack(u_merge), jnp.concatenate(u_sel)


@functools.lru_cache
def _draws_fn(d, max_depth):
    return jax.jit(jax.vmap(lambda k: _one_chain_draws(k, d, max_depth)))


def jax_nuts_draws(keys, d, max_depth):
    """Per chain of ``keys`` the draws of one JAX NUTS transition, as the
    port's ``transition`` takes them: z (n, d), go_right (n, max_depth),
    u_merge (n, max_depth), u_sel (n, 2^max_depth − 1)."""
    z, u_dir, u_merge, u_sel = (torch.tensor(np.asarray(a))
                                for a in _draws_fn(d, max_depth)(keys))
    return z, u_dir < 0.5, u_merge, u_sel


def _close(got, want, rtol):
    err = np.abs(got - want).max(axis=-1)
    assert np.all(err <= rtol * np.abs(want).max(axis=-1)), (err / np.abs(want).max(-1)).max()


@pytest.mark.parametrize("max_depth, eps, inv_mass", [
    (4, 0.01, None),
    (8, 0.01, (1.0, 0.5, 0.8, 0.3)),
])
def test_transition_matches_jax(problems, max_depth, eps, inv_mass):
    jp, p = problems
    im = None if inv_mass is None else np.asarray(inv_mass, np.float32)
    pos = (np.asarray(jp.truth) + 0.02 * np.random.default_rng(2).standard_normal((N, 4))
           ).astype(np.float32)
    keys = jax.random.split(jax.random.key(4), N)
    kj = jnuts.build_kernel(jp.log_density_fn, eps, max_depth,
                            None if im is None else jnp.asarray(im))
    sj = jax.vmap(lambda x: jnuts.init(x, jp.log_density_fn))(jnp.asarray(pos))
    new_j, info_j = jax.jit(jax.vmap(kj))(keys, sj)
    kt = nuts.build_kernel(p.log_density_fn, eps, max_depth,
                           None if im is None else torch.tensor(im))
    new_t, info_t = kt.transition(nuts.init(torch.tensor(pos), p.log_density_fn),
                                  *jax_nuts_draws(keys, 4, max_depth))
    for f in ("depth", "num_steps", "divergent", "turning"):
        np.testing.assert_array_equal(getattr(info_t, f).numpy(), np.asarray(getattr(info_j, f)),
                                      err_msg=f)
    depth = info_t.depth.numpy()
    assert depth.min() < depth.max() and (max_depth == 4 or depth.max() >= 7)  # trees of
    # several depths, and at 8 some near the limit
    np.testing.assert_allclose(new_t.position.numpy(), np.asarray(new_j.position), atol=1e-5)
    np.testing.assert_allclose(new_t.log_density.numpy(), np.asarray(new_j.log_density),
                               rtol=1e-4)
    _close(new_t.grad.numpy(), np.asarray(new_j.grad), GRAD_RTOL)
    np.testing.assert_allclose(info_t.accept_prob.numpy(), np.asarray(info_j.accept_prob),
                               rtol=1e-3, atol=1e-5)
    assert not np.array_equal(new_t.position.numpy(), pos)  # the chains moved


def test_host_reads_do_not_change_the_transition(problems, monkeypatch):
    """A host read every leaf or every 8: the same transition bit for bit
    (a read only stops a loop in which no chain is left)."""
    _, p = problems
    pos = (np.asarray(p.truth) + 0.02 * np.random.default_rng(3).standard_normal((N, 4))
           ).astype(np.float32)
    draws = jax_nuts_draws(jax.random.split(jax.random.key(5), N), 4, 4)
    state = nuts.init(torch.tensor(pos), p.log_density_fn)
    kernel = nuts.build_kernel(p.log_density_fn, 0.01, 4)
    out = []
    for c in (1, 8):
        monkeypatch.setattr(nuts, "CHECK_EVERY", c)
        out.append(kernel.transition(state, *draws))
    for a, b in zip(dataclasses.astuple(out[0][0]) + dataclasses.astuple(out[0][1]),
                    dataclasses.astuple(out[1][0]) + dataclasses.astuple(out[1][1])):
        assert torch.equal(a, b)


def _gaussian(lib):
    mean = lib.asarray([0.5, -1.0, 2.0, 0.0], dtype=lib.float32)
    scale = lib.asarray([1.0, 0.3, 2.0, 0.7], dtype=lib.float32)
    return lambda x: -0.5 * lib.sum(((x - mean) / scale) ** 2, axis=-1)


class JaxDraws:
    """Stands in for the port's generator draws: each NUTS step's normals
    and uniforms from JAX's per-chain keys of that step (``chain_keys``)."""

    def __init__(self, base_key, n, d, max_depth):
        self.base_key, self.n, self.d, self.md = base_key, n, d, max_depth
        self.step, self.queue = 0, []

    def normals(self, generator, shape, device):
        keys = jax.random.split(jax.random.fold_in(self.base_key, self.step), self.n)
        self.step += 1
        z, go_right_u, u_merge, u_sel = self._draws(keys)
        self.queue = [go_right_u, u_merge, u_sel]
        return z

    def uniforms(self, generator, shape, device):
        return self.queue.pop(0)

    def _draws(self, keys):
        return tuple(torch.tensor(np.asarray(a)) for a in _draws_fn(self.d, self.md)(keys))


def test_warmup_nuts_matches_jax(monkeypatch):
    """Six warm-up steps on a 4-D Gaussian, 16 chains, max depth 5: the
    step size (dual averaging on the mean leaf acceptance, target 0.8) and
    the diagonal inverse mass (the chains' variances) against JAX's."""
    n, md, steps = 16, 5, 6
    pos = np.random.default_rng(8).standard_normal((n, 4)).astype(np.float32)
    key = jax.random.key(9)
    lj = _gaussian(jnp)
    sj = jax.vmap(lambda x: jnuts.init(x, lj))(jnp.asarray(pos))
    sj, eps_j, im_j = jwarmup.warmup_nuts(lj, sj, key, num_steps=steps, max_depth=md,
                                          initial_step_size=0.3)
    draws = JaxDraws(key, n, 4, md)
    monkeypatch.setattr(nuts, "normals", draws.normals)
    monkeypatch.setattr(nuts, "uniforms", draws.uniforms)
    lt = _gaussian(torch)
    st, eps_t, im_t = warmup_nuts(lt, nuts.init(torch.tensor(pos), lt), None, num_steps=steps,
                                  max_depth=md, initial_step_size=0.3)
    assert draws.step == steps
    np.testing.assert_allclose(float(eps_t), float(eps_j), rtol=1e-4)
    np.testing.assert_allclose(im_t.numpy(), np.asarray(im_j), rtol=1e-3)
    np.testing.assert_allclose(st.position.numpy(), np.asarray(sj.position), atol=5e-4)
    assert float(eps_t) != 0.3


def test_run_prints_jax_runner_keys(problems):
    """ode_nuts through run_problem at 32 chains and 4 samples, map_init and
    the warm-up cut to 3, max depth to 3 (the config's 300 Adam iterations,
    200 warm-up steps and depth 8 are minutes on the CPU): the JAX runner's
    keys (accept_rate from the leaf acceptance, mean_tree_depth), the steps
    counted, finite values."""
    from ip_mcmc_tpu_torch.ops import _build

    jp, p = problems
    kp = {**p.kernel_params, "map_init": 3, "max_depth": 3}
    p = dataclasses.replace(p, burn_in=3, kernel_params=kp)
    before = _build.launch_counts["scan_nuts_step[cpu]"]
    m = runner.run_problem(p, "cpu", seed=0, n_chains=32, n_samples=4)
    jp = dataclasses.replace(jp, burn_in=3, kernel_params={**jp.kernel_params, **kp})
    jm = jrunner.run_problem(jp, key=jax.random.key(0), n_chains=32, n_samples=4)
    assert set(m) - {"warning"} == set(jm) - {"warning"}
    assert m["kernel"] == jm["kernel"] == "nuts"
    assert (m["map_init_iters"], m["warm_steps"], m["burn_steps"]) == (3, 3, 0)
    assert 0.0 < m["accept_rate"] <= 1.0 and 1.0 <= m["mean_tree_depth"] <= 3.0
    assert np.isfinite(m["posterior_mean"]).all()
    assert _build.launch_counts["scan_nuts_step[cpu]"] == before + 2 * 7  # two passes


def test_config_matches_jax(problems):
    jp, p = problems
    for attr in ("name", "dim", "kernel", "kernel_params", "n_chains", "n_samples",
                 "burn_in", "thin"):
        assert getattr(p, attr) == getattr(jp, attr), attr
    assert "ode_nuts" not in configs.NOT_PORTED and "nuts" in runner.SCAN_KERNELS
