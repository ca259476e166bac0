"""The port's grid-sharded solve (parallel/grid_shard.py), the composed
('chains', 'model') samplers (parallel/composed.py), the sharded ensemble
sampler (parallel/fes_shard.py) and the three darcy_composed_* configs,
against the port's single-device solve and the JAX package, on gloo worlds
spawned on the CPU: one of 4 ranks (the (4, 1), (2, 2) and (1, 4) meshes)
and one of 1 rank (the (1, 1) mesh, the CLI), started together while the
JAX references compute (tests/torch_composed_worker.py).

Tolerances:
- the sharded operator and solve on 2 and 4 'model' ranks (16 x 16, 150
  Jacobi CG iterations, two chains at once) against the port's
  ``apply_operator`` / ``solve_cg`` and JAX's ``sharded_solve_cg``: 1e-5
  relative to the largest entry (f32 sums in other orders; the solve is
  converged); the sharded forward against the single-device one likewise;
- ``composed_misfit_and_grad`` against JAX's on the (2, 2) mesh (16 x 16,
  150 iterations, noise 0.05): Φ within 1e-5 relative, ∇Φ within 1e-4 of
  each chain's largest entry (the adjoint's right-hand side divides the
  residuals by σ² and amplifies the forward solve's rounding);
- one pCN, MALA and ESS transition from JAX's draws (8 x 8, 16 modes, 40
  iterations, converged): the same decisions and evaluation counts,
  positions within 1e-6 (pCN, MALA: the proposal's f32 arithmetic is the
  same, MALA's drift differs by the gradient's rounding times ε²/2) and
  1e-5 (ESS: cos and sin of the same angles from two libraries);
- the samplers on the (4, 1), (2, 2) and (1, 4) meshes against the (1, 1)
  mesh, as JAX's test_mesh_shape_invariance holds them: positions within
  atol 1e-5 (the solves' sums over 'model' in other orders), the rate
  within 1e-6;
- the sharded ensemble sampler on 4, 2 and 1 chain groups: within 1e-6
  (the walkers' arithmetic does not depend on the groups), and its moments
  on N(0, diag(0.25 I_4, 0.5 I_12)) within JAX's test_fes_shard.py bounds
  (variances 15 % relative, means 0.15);
- the configs: JAX's fields (kernel, parameters, sizes, data, the aux
  constants) equal; the CLI's JSON keys are JAX's ``_run_composed`` keys.
"""

import concurrent.futures
import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ip_mcmc_tpu import configs as jconfigs
from ip_mcmc_tpu import runner as jrunner
from ip_mcmc_tpu.models import darcy as jdarcy
from ip_mcmc_tpu.parallel import composed as jcomposed
from ip_mcmc_tpu.parallel import grid_shard as jgrid
from ip_mcmc_tpu_torch import configs
from ip_mcmc_tpu_torch.models import darcy
from torch_world import ROOT, run_worlds

torch.set_num_threads(1)

WORKER = ROOT / "tests" / "torch_composed_worker.py"
NOISE, CG_SMALL, N_CHAINS, MAX_SHRINK = 0.05, 40, 8, 8
MALA_STEP = 1.0  # one MALA transition that both accepts and rejects (4 of 8)
COMPOSED = ("darcy_composed_pcn", "darcy_composed_mala", "darcy_composed_ess")


def _close(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * np.abs(want).max())


def _jax_draws(n, K, max_shrink):
    """JAX's draws of step 0 of the composed samplers (base key 9),
    chains 0..n-1, as parallel/composed.py derives them."""
    keys = [jax.random.fold_in(jax.random.fold_in(jax.random.key(9), 0), g) for g in range(n)]
    f = lambda fn: np.stack([np.asarray(fn(k)) for k in keys])  # noqa: E731
    normal = f(lambda k: jax.random.normal(jax.random.fold_in(k, 0), (K,)))
    log_u = np.log(f(lambda k: jax.random.uniform(jax.random.fold_in(k, 1))))
    theta0 = f(lambda k: jax.random.uniform(jax.random.fold_in(k, 2), minval=0.0,
                                            maxval=jnp.float32(2.0 * np.pi)))
    shrink = np.stack([f(lambda k, i=i: jax.random.uniform(jax.random.fold_in(k, 3 + i)))
                       for i in range(max_shrink)])
    return dict(xi=normal, log_u=log_u, nu=normal, log_w=log_u, theta0=theta0, shrink=shrink)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("composed")
    rng = np.random.default_rng(0)
    fwd16, aux16 = jdarcy.make_darcy_forward(n_grid=16, n_modes_per_dim=8)
    fwd8, aux8 = jdarcy.make_darcy_forward(n_grid=8, n_modes_per_dim=4)
    u_true16 = rng.standard_normal(64).astype(np.float32)
    u_true8 = rng.standard_normal(16).astype(np.float32)
    inp = {
        "a": np.exp(0.5 * rng.standard_normal((2, 16, 16))).astype(np.float32),
        "p": rng.standard_normal((2, 16, 16)).astype(np.float32),
        "f": np.ones(256, np.float32),
        "u_fwd": (0.5 * rng.standard_normal((3, 16))).astype(np.float32),
        "u16": rng.standard_normal((N_CHAINS, 64)).astype(np.float32),
        "y16": (np.asarray(fwd16(jnp.asarray(u_true16)))
                + NOISE * rng.standard_normal(16)).astype(np.float32),
        "u0": rng.standard_normal((N_CHAINS, 16)).astype(np.float32),
        "y8": (np.asarray(fwd8(jnp.asarray(u_true8)))
               + NOISE * rng.standard_normal(len(aux8["obs_indices"]))).astype(np.float32),
        **_jax_draws(N_CHAINS, 16, MAX_SHRINK),
    }
    np.savez(tmp / "inputs.npz", **inp)
    box = {}

    def worlds():  # the worlds run while JAX computes its references
        try:
            box.update(run_worlds(WORKER, (4, 1), tmp))
        except AssertionError as e:
            box["error"] = e

    thread = threading.Thread(target=worlds)
    thread.start()
    try:
        ref = _jax_references(inp, aux16, aux8)
    finally:
        thread.join()
    if "error" in box:
        raise box["error"]
    return inp, ref, box[4], box[1][0]


def _jax_references(inp, aux16, aux8):
    """JAX's sharded solve, distributed value and gradient and one step of
    each composed sampler, each on one device (JAX's results do not depend
    on its mesh's shape, tests/test_composed.py; a larger mesh only costs
    compile time here), computed in threads beside one another."""
    mesh = jcomposed.make_composed_mesh(1, 1)
    common = dict(mesh=mesh, u0=jnp.asarray(inp["u0"]), base_key=jax.random.key(9), n_samples=1,
                  burn_in=0, cg_iters=CG_SMALL)
    jobs = {
        "solve": lambda: np.asarray(jgrid.sharded_solve_cg(
            jnp.asarray(inp["a"][0]), jnp.asarray(inp["f"]), 16, jgrid.make_model_mesh(1),
            n_iters=150)),
        "value_and_grad": lambda: tuple(np.asarray(x) for x in jcomposed.composed_misfit_and_grad(
            aux16, inp["y16"], NOISE, mesh, jnp.asarray(inp["u16"]), cg_iters=150)),
        "pcn": lambda: jcomposed.sample_composed_pcn(aux8, inp["y8"], NOISE, beta=0.3, **common),
        "mala": lambda: jcomposed.sample_composed_mala(aux8, inp["y8"], NOISE,
                                                       step_size=MALA_STEP, **common),
        "ess": lambda: jcomposed.sample_composed_elliptical(aux8, inp["y8"], NOISE,
                                                            max_shrink=MAX_SHRINK, **common),
    }
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        done = {k: pool.submit(fn) for k, fn in jobs.items()}
        ref = {k: f.result() for k, f in done.items()}
    ref["phi"], ref["grad"] = ref.pop("value_and_grad")
    for name in ("pcn", "mala", "ess"):
        s, stat = ref[name]
        ref[name] = (np.asarray(s)[0], float(stat))
    return ref


# --- the grid-sharded operator, solve and forward ------------------------------------


@pytest.mark.parametrize("m", [2, 4])
def test_sharded_apply_operator_matches_single_device(run, m):
    inp, _, world4, _ = run
    want = darcy.apply_operator(torch.tensor(inp["a"]), torch.tensor(inp["p"]), 16)
    for r in world4:
        _close(r["grid"][f"apply{m}"], want, 1e-5)


@pytest.mark.parametrize("m", [2, 4])
def test_sharded_solve_cg_matches_single_device_and_jax(run, m):
    inp, ref, world4, _ = run
    single = darcy.solve_cg(torch.tensor(inp["a"]), torch.tensor(inp["f"]), 16, n_iters=150)
    for r in world4:
        _close(r["grid"][f"solve{m}"], single, 1e-5)
        _close(r["grid"][f"solve{m}"][0], ref["solve"], 1e-5)


@pytest.mark.parametrize("m", [2, 4])
def test_sharded_forward_matches_cg(run, m):
    inp, _, world4, _ = run
    fwd, _ = darcy.make_darcy_forward(n_grid=16, n_modes_per_dim=4, cg_iters=100, device="cpu")
    want = fwd(torch.tensor(inp["u_fwd"]))
    for r in world4:
        _close(r["grid"][f"forward{m}"], want, 1e-5)
    assert all(r["grid"]["indivisible_refused"] for r in world4)


# --- the distributed value and gradient, one transition from JAX's draws ------------


def test_composed_misfit_and_grad_matches_jax(run):
    _, ref, world4, _ = run
    for r in world4:
        phi, grad = (x.numpy() for x in (r["transitions"]["phi"], r["transitions"]["grad"]))
        np.testing.assert_allclose(phi, ref["phi"], rtol=1e-5)
        scale = np.abs(ref["grad"]).max(axis=1, keepdims=True)
        assert np.all(np.abs(grad - ref["grad"]) <= 1e-4 * scale)


@pytest.mark.parametrize("kind", ["pcn", "mala", "ess"])
def test_one_transition_from_jax_draws(run, kind):
    _, ref, world4, _ = run
    want_pos, want_stat = ref[kind]
    for r in world4:
        pos, stat = r["transitions"][kind]
        np.testing.assert_allclose(pos.numpy(), want_pos, rtol=0,
                                   atol=1e-5 if kind == "ess" else 1e-6)
        # pCN / MALA: the mean of the decisions; ESS: of the evaluations
        assert float(stat.to(torch.float32).mean()) == pytest.approx(want_stat, abs=1e-6)
    if kind != "ess":
        assert 0.0 < want_stat < 1.0  # the step both accepts and rejects


# --- the samplers across mesh shapes ---------------------------------------------------


@pytest.mark.parametrize("shape", [(4, 1), (2, 2), (1, 4)])
@pytest.mark.parametrize("kind", ["pcn", "mala", "ess"])
def test_mesh_shape_invariance(run, kind, shape):
    _, _, world4, world1 = run
    ref_s, ref_stat = world1["samplers"][(1, 1)][kind]
    assert ref_s.shape == (2, N_CHAINS, 16)
    for r in world4:
        s, stat = r["samplers"][shape][kind]
        np.testing.assert_allclose(s.numpy(), ref_s.numpy(), rtol=0, atol=1e-5)
        assert float(stat) == pytest.approx(float(ref_stat), abs=1e-6)
    if kind == "ess":
        assert float(ref_stat) >= 1.0
    else:
        assert 0.0 < float(ref_stat) <= 1.0


def test_fes_sharded_invariance_across_chain_groups(run):
    _, _, world4, _ = run
    for r in world4:
        ref_s, ref_info = r["fes"][(1, 4)]  # one chain group: the unsharded run
        for shape in ((4, 1), (2, 2)):
            s, info = r["fes"][shape]
            np.testing.assert_allclose(s.numpy(), ref_s.numpy(), rtol=0, atol=1e-6)
            for k in ("stretch_accept", "pcn_accept"):
                assert float(info[k]) == pytest.approx(float(ref_info[k]), abs=1e-6)


def test_fes_sharded_gaussian_posterior_moments(run):
    _, _, world4, _ = run
    samples, info = world4[0]["fes"]["moments"]
    assert 0.05 < float(info["stretch_accept"]) < 0.95
    assert 0.05 < float(info["pcn_accept"]) < 0.95
    flat = samples.reshape(-1, 16).numpy()
    var = flat.var(axis=0)
    np.testing.assert_allclose(var[:4].mean(), 0.25, rtol=0.15)
    np.testing.assert_allclose(var[4:].mean(), 0.5, rtol=0.15)
    np.testing.assert_allclose(flat.mean(axis=0), 0.0, atol=0.15)


# --- the three configs -------------------------------------------------------------------


@pytest.mark.parametrize("name", COMPOSED)
def test_config_matches_jax(name):
    jp, p = jconfigs.build(name), configs.build(name, "cpu")
    for attr in ("name", "dim", "kernel", "n_chains", "n_samples", "burn_in", "thin"):
        assert getattr(p, attr) == getattr(jp, attr), attr
    jkp, kp = dict(jp.kernel_params), dict(p.kernel_params)
    jaux, aux = jkp.pop("aux"), kp.pop("aux")
    assert kp == jkp
    for k in ("scaled_basis", "obs_indices", "source"):
        np.testing.assert_allclose(aux[k].numpy(), np.asarray(jaux[k]), rtol=1e-6, atol=1e-7)
    assert aux["n_grid"] == jaux["n_grid"]
    np.testing.assert_allclose(p.data, np.asarray(jp.data), rtol=1e-6)
    np.testing.assert_allclose(p.truth, np.asarray(jp.truth), rtol=1e-6)


def test_runner_takes_the_callers_mesh_else_the_worlds(run):
    """One mesh choice: the caller's (2, 2) mesh when given, else one of
    the world's size by JAX's rule ((1, 4) for 4 ranks and a 16 x 16
    grid)."""
    _, _, world4, _ = run
    for r in world4:
        assert r["runner_mesh"] == {"given": [2, 2], "world": [1, 4]}


@pytest.mark.parametrize("name", COMPOSED)
def test_cli_prints_the_jax_runner_keys(run, name, monkeypatch):
    """The keys of JAX's ``_run_composed``: the JAX runner run with its
    composed samplers replaced by stand-ins of their outputs' shapes (the
    keys are the runner's; compiling the samplers would cost a minute)."""
    _, _, _, world1 = run
    got = world1["cli"][name]

    def stand_in(aux, data, noise_scale, *, u0, n_samples, **kw):
        s = jax.random.normal(jax.random.key(0), (n_samples,) + u0.shape)
        return s, jnp.float32(1.5 if name.endswith("ess") else 0.5)

    for fn in ("sample_composed_pcn", "sample_composed_mala", "sample_composed_elliptical"):
        monkeypatch.setattr(jcomposed, fn, stand_in)
    jp = dataclasses.replace(jconfigs.build(name), burn_in=1)
    want = jrunner.run_problem(jp, n_chains=16, n_samples=5)
    # the CLI adds its own two keys, as JAX's does
    assert set(got) == set(want) | {"setup_s", "cli_total_s"}
    assert got["kernel"] == want["kernel"] and got["mesh_shape"] == [1, 1]
    assert got["n_chains"] == 16 and got["n_samples"] == 5
    stat = "mean_evals_per_step" if name.endswith("ess") else "accept_rate"
    assert np.isfinite(got[stat]) and got[stat] > 0.0
