"""The ODE forward model and the gradient samplers of the scan path
(``ip_mcmc_tpu_torch/models/ode.py``, ``kernels/mala.py``, ``kernels/hmc.py``,
``adapt/warmup.py`` ``map_localize`` / ``warmup_mala`` / ``warmup_hmc``) and
the configs they unlock, ``ode_mala`` (BASELINE 3a) and ``ode_hmc``, against
the JAX package on the CPU: RK4 trajectories and the Lotka–Volterra forward
at the configs' 200 steps, ∇log π against ``jax.grad``, Adam against optax,
one MALA and one HMC transition from the draws JAX's kernels make from
their keys, the frozen data against a fresh JAX build, and the runs' keys.

Tolerances. The forward is f32 on both sides, but the port contracts a
multiply and an add into one rounding (``addcmul``, ``add(alpha=)``) where
XLA rounds twice, and over 200 RK4 steps the two sides part by up to 1.4e-5
of an observed value; each lies within 2e-5 of the same forward in float64
(the port's code on float64 tensors: JAX's f32 at 5.7e-6, the port's at
8.6e-6). So the bounds: 1e-5 of each draw's largest value between the two
(measured 3.6e-6), 2e-5 elementwise against float64. ∇log π: 1e-4 of each
draw's largest entry (measured 7.9e-6). Adam's 20 iterations move the
positions by up to 0.66; the two sides' positions agree within 1e-4
(measured 2.8e-6). A transition: the positions within 1e-5, log π within
1e-4 relative, the same MH decisions."""

import dataclasses
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ip_mcmc_tpu import configs as jconfigs
from ip_mcmc_tpu import runner as jrunner
from ip_mcmc_tpu.adapt import warmup as jwarmup
from ip_mcmc_tpu.kernels import hmc as jhmc
from ip_mcmc_tpu.kernels import mala as jmala
from ip_mcmc_tpu.models import ode as jode
from ip_mcmc_tpu_torch import configs, runner
from ip_mcmc_tpu_torch.adapt import map_localize, warmup_hmc, warmup_mala
from ip_mcmc_tpu_torch.kernels import base, hmc, mala
from ip_mcmc_tpu_torch.models import ode

torch.set_num_threads(1)

FWD_RTOL = 1e-5  # port against JAX, of each draw's largest value
F64_RTOL = 2e-5  # either side against float64, elementwise
GRAD_RTOL = 1e-4  # of each draw's largest entry
ADAM_ATOL = 1e-4
N = 32
OBS = np.arange(10, 201, 10)
ODE = ("ode_mala", "ode_hmc")


def _close(got, want, rtol):
    err = np.abs(got - want).max(axis=-1)
    scale = np.abs(want).max(axis=-1)
    assert np.all(err <= rtol * scale), (err / scale).max()


def _thetas(batch=16, seed=0):
    """Log-rates from the configs' prior N(0, 0.3²), half of them doubled."""
    th = (0.3 * np.random.default_rng(seed).standard_normal((batch, 4))).astype(np.float32)
    th[batch // 2:] *= 2.0
    return th


@pytest.mark.parametrize("field", ["lotka_volterra_log_field", "lotka_volterra_field"])
def test_rk4_trajectory_matches_jax(field):
    """200 steps of 0.05 from (1, 0.5) (its log for the log field)."""
    th = _thetas(8)
    y0 = np.array([1.0, 0.5], np.float32)
    if field == "lotka_volterra_log_field":
        y0 = np.log(y0)
    want = jax.vmap(lambda t: jode.rk4_integrate(getattr(jode, field), jnp.asarray(y0), 0.05,
                                                 200, params=t))(jnp.asarray(th))
    got = ode.rk4_integrate(getattr(ode, field), torch.tensor(y0).expand(8, 2), 0.05, 200,
                            params=torch.tensor(th))
    assert got.shape == (201, 8, 2)
    want = np.asarray(want).transpose(1, 0, 2)
    _close(got.numpy().reshape(201, -1), want.reshape(201, -1), FWD_RTOL)


def test_logistic_forward_matches_jax():
    th = np.log(np.array([[0.8, 2.0], [1.3, 1.5], [0.5, 3.0]], np.float32))
    fj = jode.make_logistic_forward(jnp.array([0.1]), 0.1, 50, np.arange(5, 51, 5))
    ft = ode.make_logistic_forward([0.1], 0.1, 50, np.arange(5, 51, 5))
    _close(ft(torch.tensor(th)).numpy(), np.asarray(jax.vmap(fj)(jnp.asarray(th))), FWD_RTOL)


def test_lotka_volterra_forward_matches_jax_and_float64():
    """The configs' forward (200 steps, both species every 10 steps) on 16
    draws: the port against JAX, and each against the port's code on
    float64."""
    th = _thetas()
    fj = jode.make_lotka_volterra_forward(jnp.array([1.0, 0.5]), 0.05, 200, OBS)
    ft = ode.make_lotka_volterra_forward([1.0, 0.5], 0.05, 200, OBS)
    want = np.asarray(jax.vmap(fj)(jnp.asarray(th)))
    got = ft(torch.tensor(th)).numpy()
    assert got.shape == (16, 40) and np.isfinite(got).all()
    _close(got, want, FWD_RTOL)
    exact = ft(torch.tensor(th, dtype=torch.float64)).numpy()
    for side in (got, want):
        np.testing.assert_allclose(side, exact, rtol=F64_RTOL)


def test_remat_gives_the_same_values_and_gradient():
    th = torch.tensor(_thetas(4), requires_grad=True)
    out = []
    for remat in (False, True):
        f = ode.make_lotka_volterra_forward([1.0, 0.5], 0.05, 40, [10, 20, 40], remat=remat)
        y = f(th)
        (g,) = torch.autograd.grad(y.sum(), th)
        out.append((y.detach(), g))
    assert torch.equal(out[0][0], out[1][0]) and torch.equal(out[0][1], out[1][1])


@pytest.fixture(scope="module")
def problems():
    return {name: (jconfigs.build(name), configs.build(name, "cpu")) for name in ODE}


def test_lv_fixture_matches_fresh_jax_build(problems):
    """``lv.npz`` against ``scripts/freeze_torch_fixtures.py``'s arrays of a
    fresh JAX build; both configs read it, as both JAX configs draw the
    same y."""
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent / "scripts"))
    import freeze_torch_fixtures

    fresh = freeze_torch_fixtures.lv_fixture_arrays(problems["ode_mala"][0])
    frozen = np.load(configs.LV_FIXTURE)
    assert set(frozen.files) == set(fresh) == {"theta_true", "y"}
    for k, v in fresh.items():
        np.testing.assert_allclose(frozen[k], v, rtol=1e-6, err_msg=k)
    np.testing.assert_array_equal(np.asarray(problems["ode_hmc"][0].data),
                                  np.asarray(problems["ode_mala"][0].data))


@pytest.mark.parametrize("name", ODE)
def test_config_matches_jax(problems, name):
    jp, p = problems[name]
    for attr in ("name", "dim", "kernel", "kernel_params", "n_chains", "n_samples",
                 "burn_in", "thin"):
        assert getattr(p, attr) == getattr(jp, attr), attr
    np.testing.assert_allclose(p.data, np.asarray(jp.data), rtol=1e-6)
    np.testing.assert_allclose(p.truth, np.asarray(jp.truth), rtol=1e-6)
    np.testing.assert_allclose(p.prior.scale.numpy(), np.asarray(jp.prior.scale))


def test_log_density_and_gradient_match_jax(problems):
    """log π of ode_mala's posterior and ∇log π (autograd through the 200
    RK4 steps) against jax.grad on 16 draws."""
    jp, p = problems["ode_mala"]
    th = _thetas()
    want_v, want_g = jax.vmap(jax.value_and_grad(jp.log_density_fn))(jnp.asarray(th))
    got_v, got_g = base.value_and_grad(p.log_density_fn)(torch.tensor(th))
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), rtol=FWD_RTOL)
    _close(got_g.numpy(), np.asarray(want_g), GRAD_RTOL)


def test_map_localize_matches_optax(problems):
    """20 Adam iterations (lr 0.05) on ode_mala's log π from 16 prior draws."""
    jp, p = problems["ode_mala"]
    pos = (0.3 * np.random.default_rng(1).standard_normal((16, 4))).astype(np.float32)
    want = np.asarray(jwarmup.map_localize(jp.log_density_fn, jnp.asarray(pos), num_steps=20))
    got = map_localize(p.log_density_fn, torch.tensor(pos), num_steps=20).numpy()
    assert np.abs(want - pos).max() > 0.1  # the chains moved
    np.testing.assert_allclose(got, want, atol=ADAM_ATOL)


def jax_draws(seed, d):
    """Per chain, the normals and the uniform of a MALA or HMC step under
    that chain's key: split(key) → (proposal / momentum key, MH key)."""
    def one(key):
        kp, ka = jax.random.split(key)
        return jax.random.normal(kp, (d,)), jax.random.uniform(ka, ())

    xi, u = jax.vmap(one)(jax.random.split(jax.random.key(seed), N))
    return torch.tensor(np.asarray(xi)), torch.tensor(np.asarray(u))


def _positions(truth, seed=2):
    """Near the posterior (the truth, spread 0.02), where the proposals of
    the steps below are accepted and rejected in part."""
    noise = 0.02 * np.random.default_rng(seed).standard_normal((N, 4))
    return (np.asarray(truth) + noise).astype(np.float32)


def _chol():
    a = np.random.default_rng(3).standard_normal((4, 4)) * 0.01
    return np.linalg.cholesky(a @ a.T + 1e-4 * np.eye(4)).astype(np.float32)


@pytest.mark.parametrize("precond", ["none", "diagonal", "dense"])
def test_mala_transition_matches_jax(problems, precond):
    jp, p = problems["ode_mala"]
    pc = {"none": None, "diagonal": np.full(4, 1e-3, np.float32), "dense": _chol()}[precond]
    eps = 0.015 if precond == "none" else 1.0
    pos = _positions(jp.truth)
    kj = jmala.build_kernel(jp.log_density_fn, eps, None if pc is None else jnp.asarray(pc))
    sj = jax.vmap(lambda x: jmala.init(x, jp.log_density_fn))(jnp.asarray(pos))
    new_j, info_j = jax.vmap(kj)(jax.random.split(jax.random.key(4), N), sj)
    kt = mala.build_kernel(p.log_density_fn, eps, None if pc is None else torch.tensor(pc))
    new_t, info_t = kt.transition(mala.init(torch.tensor(pos), p.log_density_fn), *jax_draws(4, 4))
    np.testing.assert_array_equal(info_t.accepted.numpy(), np.asarray(info_j.accepted))
    assert 0 < int(info_t.accepted.sum()) < N
    np.testing.assert_allclose(new_t.position.numpy(), np.asarray(new_j.position), atol=1e-5)
    np.testing.assert_allclose(new_t.log_density.numpy(), np.asarray(new_j.log_density),
                               rtol=1e-4)
    _close(new_t.grad.numpy(), np.asarray(new_j.grad), GRAD_RTOL)


@pytest.mark.parametrize("inv_mass", [None, "diagonal"])
def test_hmc_transition_matches_jax(problems, inv_mass):
    """Four leapfrog steps of 0.02 from JAX's momenta."""
    jp, p = problems["ode_hmc"]
    im = None if inv_mass is None else np.array([1.0, 0.5, 0.8, 0.3], np.float32)
    pos = _positions(jp.truth, 5)
    kj = jhmc.build_kernel(jp.log_density_fn, 0.02, 4, None if im is None else jnp.asarray(im))
    sj = jax.vmap(lambda x: jhmc.init(x, jp.log_density_fn))(jnp.asarray(pos))
    new_j, info_j = jax.vmap(kj)(jax.random.split(jax.random.key(6), N), sj)
    kt = hmc.build_kernel(p.log_density_fn, 0.02, 4, None if im is None else torch.tensor(im))
    new_t, info_t = kt.transition(hmc.init(torch.tensor(pos), p.log_density_fn), *jax_draws(6, 4))
    np.testing.assert_array_equal(info_t.accepted.numpy(), np.asarray(info_j.accepted))
    assert 0 < int(info_t.accepted.sum()) < N
    np.testing.assert_allclose(new_t.position.numpy(), np.asarray(new_j.position), atol=1e-5)
    np.testing.assert_allclose(info_t.accept_prob.numpy(), np.asarray(info_j.accept_prob),
                               rtol=1e-3, atol=1e-5)


def test_warmups_adapt_their_hyper_parameters(problems):
    """warmup_mala (step size towards 0.574 acceptance, a dense Cholesky
    factor of the pooled covariance) and warmup_hmc (a positive diagonal
    inverse mass) at 32 chains from MAP-localised starts, a few steps each:
    finite hyper-parameters of the right shapes, no NaN in the chains."""
    _, p = problems["ode_mala"]
    g = torch.Generator().manual_seed(7)
    pos = map_localize(p.log_density_fn, p.init_positions(g, 32), num_steps=30)
    st, eps, chol = warmup_mala(p.log_density_fn, mala.init(pos, p.log_density_fn), g,
                                num_steps=6)
    assert eps.shape == () and 0.0 < float(eps) < 1.0
    assert chol.shape == (4, 4) and torch.all(torch.triu(chol, 1) == 0)
    assert torch.isfinite(chol).all() and torch.isfinite(st.position).all()
    st, eps, inv_mass = warmup_hmc(p.log_density_fn, hmc.init(pos, p.log_density_fn), g,
                                   num_steps=3, num_integration_steps=2)
    assert inv_mass.shape == (4,) and torch.all(inv_mass > 0) and float(eps) > 0.0
    np.testing.assert_allclose(
        inv_mass.numpy(), 1.0 / (st.position.numpy().var(0) + 1e-6), rtol=1e-5)


@pytest.mark.parametrize("name", ODE)
def test_runs_print_jax_runner_keys(problems, name):
    """Through run_problem at 64 chains and 4 samples, map_init and the
    warm-up cut to 3 (the configs' 300 Adam iterations and 500 warm-up steps
    are minutes on the CPU): the JAX runner's keys (map_init_iters; Adam's
    iterations not in warm_steps), finite values, the steps counted."""
    from ip_mcmc_tpu_torch.ops import _build

    jp, p = problems[name]
    kp = {**p.kernel_params, "map_init": 3}
    p = dataclasses.replace(p, burn_in=3, kernel_params=kp)
    step = f"scan_{p.kernel}_step[cpu]"
    before = _build.launch_counts[step]
    m = runner.run_problem(p, "cpu", seed=0, n_chains=64, n_samples=4)
    jp = dataclasses.replace(jp, burn_in=3, kernel_params={**jp.kernel_params, "map_init": 3})
    jm = jrunner.run_problem(jp, key=jax.random.key(0), n_chains=64, n_samples=4)
    assert set(m) - {"warning"} == set(jm) - {"warning"}
    assert m["kernel"] == jm["kernel"] == p.kernel
    assert (m["map_init_iters"], m["warm_steps"], m["burn_steps"]) == (3, 3, 0)
    assert m["steps_per_s"] == pytest.approx(64 * 7 / m["run_s"])
    assert 0.0 <= m["accept_rate"] <= 1.0 and np.isfinite(m["posterior_mean"]).all()
    assert _build.launch_counts[step] == before + 2 * 7  # two passes
