"""The single-particle Darcy forward of the scan path
(``ip_mcmc_tpu_torch/models/darcy.py``: ``make_darcy_forward``, ``solve_cg``
with its implicit adjoint, the dense method, ``solve_pressure``) against the
JAX package's (``ip_mcmc_tpu/models/darcy.py``) on the CPU, on inputs drawn
with numpy from a seed; the two configs it unlocks, ``darcy_pcn_4096``'s
scan path and ``darcy64_pcn``: their potentials against JAX's ``phi``, the
frozen 64² data against a fresh JAX build, and a short scan run of each.

Tolerances. Both sides compute in f32 in the same order of operations, but
the KL product, the CG dot products, the sine transforms and the Cholesky
factor are summed by other libraries in other orders (Eigen under XLA,
PyTorch's CPU kernels): measured on these draws at most 6.3e-7 of the
largest entry on the solves and forwards (16², Jacobi / 48 CG; 64², dst / 24
CG, 1.8e-7), 1.2e-6 on the Cholesky pressures and 1.3e-6 on the gradients.
The bounds are 1e-5: unconverged iterations (24 dst iterations at 64², 6
Richardson ones) would carry a rounding difference along, and they did not
grow it on these draws, so no bound is looser. The fields are the configs'
KL prior's: on white-noise fields CG run on past convergence wanders, and
the two sides part by up to 3e-3. Element-wise stencil sums are the same
operations in the same order: 1e-6."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ip_mcmc_tpu import configs as jconfigs
from ip_mcmc_tpu.models import darcy as jdarcy
from ip_mcmc_tpu_torch import configs, runner
from ip_mcmc_tpu_torch.models import darcy
from ip_mcmc_tpu_torch.ops import _build

torch.set_num_threads(1)

RTOL = 1e-5  # solves, forwards, potentials, gradients (see the module's note)
STENCIL_RTOL = 1e-6  # element-wise stencil arithmetic in the same order


def _fields(n, batch=4, seed=0):
    """Conductivity fields of the configs' prior, exp(u · scaled basis) for
    u ~ N(0, I) of 8 × 8 modes (batch, n, n), f32."""
    basis = darcy.darcy_aux(n_grid=n, n_modes_per_dim=8)["scaled_basis"]
    u = np.random.default_rng(seed).standard_normal((batch, 64)).astype(np.float32)
    return np.exp(u @ basis).reshape(batch, n, n).astype(np.float32)


def _grids(n, batch=4, seed=1):
    return np.random.default_rng(seed).standard_normal((batch, n, n)).astype(np.float32)


def _close(got, want, rtol):
    """Within rtol of the largest magnitude of each batch entry."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).reshape(len(want), -1).max(axis=1)
    err = np.abs(got - want).reshape(len(want), -1).max(axis=1)
    assert np.all(err <= rtol * scale), (err / scale).max()


# --- the operator and the preconditioner ------------------------------------------


@pytest.mark.parametrize("n", [8, 16])
def test_apply_operator_and_its_diagonal_match_jax(n):
    a, p = _fields(n), _grids(n)
    want = jax.vmap(lambda x, y: jdarcy.apply_operator(x, y, n))(jnp.asarray(a), jnp.asarray(p))
    _close(darcy.apply_operator(torch.tensor(a), torch.tensor(p), n), want, STENCIL_RTOL)
    want = jax.vmap(lambda x: jdarcy._operator_diagonal(x, n))(jnp.asarray(a))
    _close(darcy._operator_diagonal(torch.tensor(a), n), want, STENCIL_RTOL)


def test_dense_operator_matches_jax_and_the_stencil():
    """assemble_operator at 8²: JAX's matrix (the corners' two boundary
    faces both added), and A p equal to apply_operator's."""
    n, a, p = 8, _fields(8), _grids(8)
    idx = darcy._stencil_indices(n)
    for got, want in zip(idx, jdarcy._stencil_indices(n)):
        np.testing.assert_array_equal(got, want)
    A = darcy.assemble_operator(torch.tensor(a), idx, n)
    want = jax.vmap(lambda x: jdarcy.assemble_operator(x, jdarcy._stencil_indices(n), n))(
        jnp.asarray(a))
    _close(A, want, STENCIL_RTOL)
    Ap = (A @ torch.tensor(p).reshape(4, -1, 1))[..., 0]
    _close(Ap, darcy.apply_operator(torch.tensor(a), torch.tensor(p), n).reshape(4, -1), RTOL)


@pytest.mark.parametrize("n", [8, 16])
def test_dst_preconditioner_matches_jax(n):
    """The f32 fast-Poisson apply Sᵀ[(S r Sᵀ)/λ]S, ā per field; S from the
    port's dst_factors, equal to JAX's dst_basis."""
    S, e = darcy.dst_basis(n)
    Sj, ej = jdarcy.dst_basis(n)
    np.testing.assert_array_equal(S.numpy(), np.asarray(Sj))
    np.testing.assert_array_equal(e.numpy(), np.asarray(ej))
    a, r = _fields(n), _grids(n)
    want = jax.vmap(lambda x, y: jdarcy.make_dst_preconditioner(x, n)(y))(
        jnp.asarray(a), jnp.asarray(r))
    _close(darcy.make_dst_preconditioner(torch.tensor(a), n)(torch.tensor(r)), want, RTOL)


# --- the solve -----------------------------------------------------------------------

# (precond, solver, iterations, ω): CG of the configs' depth, Richardson short
SOLVES = [("jacobi", "cg", 48, 1.0), ("dst", "cg", 12, 1.0), ("jacobi", "richardson", 6, 0.9),
          ("dst", "richardson", 6, 0.9)]


@pytest.mark.parametrize("n", [8, 16])
@pytest.mark.parametrize("precond, solver, iters, omega", SOLVES)
def test_solve_cg_matches_jax(n, precond, solver, iters, omega):
    a = _fields(n, seed=2)
    f = np.ones(n * n, np.float32)
    want = jax.vmap(lambda x: jdarcy.solve_cg(x, jnp.asarray(f), n, n_iters=iters,
                                              precond=precond, solver=solver, omega=omega))(
        jnp.asarray(a))
    got = darcy.solve_cg(torch.tensor(a), torch.tensor(f), n, n_iters=iters, precond=precond,
                         solver=solver, omega=omega)
    assert got.shape == (4, n * n)
    _close(got, want, RTOL)


def test_solve_cg_refuses_other_options():
    a, f = torch.ones(8, 8), torch.ones(64)
    with pytest.raises(ValueError, match="precond"):
        darcy.solve_cg(a, f, 8, precond="dst_trunc")
    with pytest.raises(ValueError, match="solver"):
        darcy.solve_cg(a, f, 8, solver="gmres")


# --- the forward ----------------------------------------------------------------------


def _forward_pair(**kw):
    return jdarcy.make_darcy_forward(**kw), darcy.make_darcy_forward(device="cpu", **kw)


def _coeffs(K, batch=8, seed=3):
    return np.random.default_rng(seed).standard_normal((batch, K)).astype(np.float32)


@pytest.mark.parametrize("kw", [
    dict(n_grid=16, n_modes_per_dim=8),                                    # darcy_pcn_4096
    dict(n_grid=64, n_modes_per_dim=12, cg_iters=24, precond="dst"),       # darcy64_pcn
    dict(n_grid=8, n_modes_per_dim=4, method="dense"),                     # Cholesky
    dict(n_grid=8, n_modes_per_dim=4, cg_iters=4, solver="richardson", omega=0.9,
         log_a_mean=0.5, obs_indices=[0, 9, 27, 63]),
], ids=["16-jacobi", "64-dst", "8-dense", "8-richardson"])
def test_forward_matches_jax(kw):
    (jf, jaux), (tf, taux) = _forward_pair(**kw)
    assert set(taux) == set(jaux)
    for k in ("scaled_basis", "eigenvalues", "obs_indices", "source"):
        np.testing.assert_allclose(taux[k].numpy(), np.asarray(jaux[k]), rtol=1e-6, err_msg=k)
    assert taux["n_grid"] == jaux["n_grid"]
    u = _coeffs(kw["n_modes_per_dim"] ** 2)
    got = tf(torch.tensor(u))
    assert got.shape == (8, len(taux["obs_indices"]))
    _close(got, jax.vmap(jf)(jnp.asarray(u)), RTOL)
    _close(tf(torch.tensor(u[0]))[None], jf(jnp.asarray(u[0]))[None], RTOL)  # one particle


@pytest.mark.parametrize("n", [8, 16])
def test_solve_pressure_matches_jax(n):
    (_, jaux), (_, taux) = _forward_pair(n_grid=n, n_modes_per_dim=4)
    u = _coeffs(16, batch=3)
    want = jax.vmap(lambda v: jdarcy.solve_pressure(v, jaux, 0.2))(jnp.asarray(u))
    got = darcy.solve_pressure(torch.tensor(u), taux, 0.2)
    assert got.shape == (3, n, n)
    _close(got, want, RTOL)


@pytest.mark.parametrize("precond, solver, omega", [
    ("jacobi", "cg", 1.0), ("dst", "cg", 1.0), ("jacobi", "richardson", 0.9)])
def test_implicit_adjoint_gradient_matches_jax_grad(precond, solver, omega):
    """∇ of ½‖(y − G(u))/σ‖² by the implicit adjoint (the same solver on
    the cotangent; for Richardson with Jacobi too, as JAX accepts it),
    against jax.grad through custom_linear_solve."""
    kw = dict(n_grid=16, n_modes_per_dim=8, cg_iters=12, precond=precond, solver=solver,
              omega=omega)
    (jf, _), (tf, _) = _forward_pair(**kw)
    r = np.random.default_rng(4)
    u = r.standard_normal(64).astype(np.float32)
    y = (0.01 * r.standard_normal(16)).astype(np.float32)
    want = jax.grad(lambda v: 0.5 * jnp.sum(((y - jf(v)) / 0.002) ** 2))(jnp.asarray(u))
    ut = torch.tensor(u, requires_grad=True)
    (0.5 * torch.sum(((torch.tensor(y) - tf(ut)) / 0.002) ** 2)).backward()
    _close(ut.grad[None], np.asarray(want)[None], RTOL)


def test_sharded_method_is_not_ported():
    """The 'sharded' method, ported since the multi-device layer: in a
    world of one rank (a gloo process group of size 1, started here) its
    forward is the single-device CG forward within 1e-5 relative (the same
    Jacobi CG, its dot products through all_reduce); an unknown method
    raises. Worlds of 2 and 4 ranks: tests/test_torch_composed.py."""
    from ip_mcmc_tpu_torch import parallel

    with pytest.raises(ValueError, match="method"):
        darcy.make_darcy_forward(method="lu", device="cpu")
    try:
        fwd, _ = darcy.make_darcy_forward(n_grid=16, n_modes_per_dim=4, cg_iters=100,
                                          method="sharded", device="cpu")
        ref, _ = darcy.make_darcy_forward(n_grid=16, n_modes_per_dim=4, cg_iters=100,
                                          device="cpu")
        u = torch.tensor(0.5 * np.random.default_rng(3).standard_normal((3, 16)),
                         dtype=torch.float32)
        want = ref(u)
        assert torch.allclose(fwd(u), want, rtol=0, atol=1e-5 * float(want.abs().max()))
    finally:
        parallel.shutdown()


# --- the configs -------------------------------------------------------------------


@pytest.fixture(scope="module")
def problems():
    return {name: (jconfigs.build(name), configs.build(name, "cpu"))
            for name in ("darcy_pcn_4096", "darcy64_pcn")}


@pytest.mark.parametrize("name", ["darcy_pcn_4096", "darcy64_pcn"])
def test_config_matches_jax(problems, name):
    """Sizes, kernel parameters, data and truth of a fresh JAX build (the
    64² ones frozen in darcy64.npz: JAX's darcy64_pcn draws them with the
    same forward and keys as darcy64_pcn_warm)."""
    jp, p = problems[name]
    for attr in ("name", "dim", "kernel", "kernel_params", "n_chains", "n_samples", "burn_in",
                 "thin"):
        assert getattr(p, attr) == getattr(jp, attr), attr
    np.testing.assert_allclose(p.data, np.asarray(jp.data), rtol=1e-6)
    np.testing.assert_allclose(p.truth, np.asarray(jp.truth), rtol=1e-6)
    assert p.potential_fn is not None
    assert (p.batched_potential_fn is None) == (jp.batched_potential_fn is None)


@pytest.mark.parametrize("name", ["darcy_pcn_4096", "darcy64_pcn"])
def test_potential_matches_jax_phi(problems, name):
    """The scan path's Φ on 16 prior draws (half of them tripled: rougher
    fields) against JAX's phi."""
    jp, p = problems[name]
    u = _coeffs(p.dim, batch=16, seed=5)
    u[8:] *= 3.0
    want = np.asarray(jax.vmap(jp.potential_fn)(jnp.asarray(u)))
    got = p.potential_fn(torch.tensor(u)).numpy()
    assert got.shape == (16,) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=RTOL)


@pytest.mark.parametrize("name", ["darcy_pcn_4096", "darcy64_pcn"])
def test_short_scan_run(problems, name):
    """The scan pCN with warmup_pcn through the runner at 32 chains (the
    warm-up cut to 20 steps, 10 samples): the JAX runner's keys, finite R̂
    and posterior mean, the steps counted on the CPU."""
    _, p = problems[name]
    p = dataclasses.replace(p, burn_in=20)
    before = _build.launch_counts["scan_pcn_step[cpu]"]
    m = runner.run_problem(p, "cpu", n_chains=32, n_samples=10)
    assert m["kernel"] == "pcn" and m["n_chains"] == 32 and m["warm_steps"] == 20
    assert np.isfinite(m["max_rhat"]) and np.isfinite(m["posterior_mean"]).all()
    assert len(m["posterior_mean"]) == p.dim and 0.0 <= m["accept_rate"] <= 1.0
    # two passes of the pipeline (the first untimed), 30 steps each
    assert _build.launch_counts["scan_pcn_step[cpu]"] == before + 60
