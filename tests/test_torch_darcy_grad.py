"""The port's adjoint gradient of the Darcy misfit
(ip_mcmc_tpu_torch/models/darcy.py: DarcyMisfit.value_and_grad, the
autograd function, DarcyMisfitMalaWarm; plain versions on the CPU) against
the JAX package's custom_vjp adjoint and make_batched_misfit_mala_warm on
an 8×8 Darcy problem, and against a float64 finite difference."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ip_mcmc_tpu.models import darcy as jdarcy
from ip_mcmc_tpu_torch.convert import (
    darcy_mala_warm_misfit_from_arrays,
    darcy_misfit_from_arrays,
)
from ip_mcmc_tpu_torch.models.darcy import DarcyMisfitMalaWarm
from test_torch_fused_pcn import K, NOISE, small_darcy

torch.set_num_threads(1)

B = 24


@pytest.fixture(scope="module")
def problem():
    return small_darcy()


def draws(seed=0, scale=0.4, b=B):
    return (scale * np.random.default_rng(seed).standard_normal((K, b))).astype(
        np.float32)


def assert_f32_gradient(got, want):
    """Two f32 adjoints of the same Jacobi solve: the median draw within
    1e-5, every draw within 1e-4. The residuals are divided by σ² = 4e-6 on
    their way into the adjoint's right-hand side, so rounding in the forward
    solution is amplified: on the worst of these draws the JAX gradient and
    the port's each lie about 2e-5 from the float64 gradient."""
    err = col_err(got, want)
    assert np.median(err) <= 1e-5 and err.max() <= 1e-4, (np.median(err), err.max())


def col_err(got, want):
    """Per draw: largest deviation over the rows, relative to the draw's
    largest reference entry."""
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max(axis=0) / np.abs(want).max(axis=0)


@pytest.mark.parametrize("cg_iters", [12, 60])
def test_value_and_grad_matches_jax_adjoint(problem, cg_iters):
    """Jacobi, every input f32: Φ within 1e-5 of jax.value_and_grad of the
    custom_vjp misfit and ∇Φ within the f32 bound above, converged or not;
    and the port's gradient is as close to the float64 one as JAX's."""
    aux_j, aux_t, y = problem
    pj = jdarcy.make_batched_misfit(aux_j, y, NOISE, cg_iters=cg_iters,
                                    differentiable=True)
    pt = darcy_misfit_from_arrays(aux_t, y, NOISE, cg_iters=cg_iters)
    U = draws()
    want_g = jax.grad(lambda u: jnp.sum(pj(u)))(jnp.asarray(U))
    phi, g = pt.value_and_grad(torch.from_numpy(U))
    np.testing.assert_allclose(phi.numpy(), np.asarray(pj(jnp.asarray(U))), rtol=1e-5)
    assert g.shape == (K, B)
    assert_f32_gradient(g.numpy(), want_g)
    p64 = darcy_misfit_from_arrays(aux_t, y, NOISE, cg_iters=cg_iters).double()
    g64 = p64._value_and_grad_plain(torch.from_numpy(U).double())[1].numpy()
    assert col_err(g.numpy(), g64).max() <= 3e-5


def test_autograd_function_matches_jax_vjp(problem):
    """A tensor that requires grad goes through the autograd function: its
    backward is the adjoint, cotangent included (jax.vjp with the same t)."""
    aux_j, aux_t, y = problem
    pj = jdarcy.make_batched_misfit(aux_j, y, NOISE, cg_iters=12,
                                    differentiable=True)
    pt = darcy_misfit_from_arrays(aux_t, y, NOISE, cg_iters=12)
    U = draws(1)
    t = np.random.default_rng(2).standard_normal(B).astype(np.float32)
    want_phi, vjp = jax.vjp(pj, jnp.asarray(U))
    (want_g,) = vjp(jnp.asarray(t))
    Ut = torch.from_numpy(U).requires_grad_(True)
    phi = pt(Ut)
    assert phi.requires_grad
    (g,) = torch.autograd.grad(phi, Ut, torch.from_numpy(t))
    np.testing.assert_allclose(phi.detach().numpy(), np.asarray(want_phi), rtol=1e-5)
    assert_f32_gradient(g.numpy(), want_g)
    # without grad the same module is the plain misfit
    with torch.no_grad():
        assert not pt(Ut).requires_grad
    assert torch.equal(pt(Ut.detach()), phi.detach())


def test_gradient_matches_float64_finite_difference(problem):
    """At 2 draws, with a converged solve (the adjoint differentiates the
    exact solution, not the CG iterates): central differences of the
    float64 plain misfit along every coordinate."""
    _, aux_t, y = problem
    p64 = darcy_misfit_from_arrays(aux_t, y, NOISE, cg_iters=100).double()
    p32 = darcy_misfit_from_arrays(aux_t, y, NOISE, cg_iters=100)
    U = torch.from_numpy(draws(3, b=2)).double()
    h = 1e-6
    steps = h * torch.eye(K, dtype=torch.float64)
    fd = torch.empty(K, 2, dtype=torch.float64)
    for b in range(2):
        col = U[:, b:b + 1]
        up = p64._solve_plain(col + steps)[0]
        down = p64._solve_plain(col - steps)[0]
        fd[:, b] = (up - down) / (2 * h)
    g64 = p64._value_and_grad_plain(U)[1]
    assert col_err(g64.numpy(), fd.numpy()).max() <= 1e-5
    g32 = p32.value_and_grad(U.float())[1]
    assert col_err(g32.numpy(), fd.numpy()).max() <= 1e-3


def warm_pair(problem, precond, cg_iters):
    aux_j, aux_t, y = problem
    kw = dict(cg_iters=cg_iters, precond=precond, precond_modes=32)
    return (jdarcy.make_batched_misfit_mala_warm(aux_j, y, NOISE, **kw),
            darcy_mala_warm_misfit_from_arrays(aux_t, y, NOISE, **kw))


def two_calls(problem, precond, cg_iters):
    """(JAX outputs, port outputs) of a call from aux0 = 0 and of a call at
    a MALA-sized move away from JAX's aux: (Φ, ∇Φ, aux) each."""
    (wj, ad_j), (wt, ad_t) = warm_pair(problem, precond, cg_iters)
    assert isinstance(wt, DarcyMisfitMalaWarm) and ad_j == ad_t == wt.aux_dim == 128
    U = draws(4)
    U2 = (U + 0.02 * draws(5, scale=1.0)).astype(np.float32)
    zeros = np.zeros((ad_j, B), np.float32)
    j1 = wj(jnp.asarray(U), jnp.asarray(zeros))
    j2 = wj(jnp.asarray(U2), j1[2])
    t1 = wt(torch.from_numpy(U), torch.from_numpy(zeros))
    t2 = wt(torch.from_numpy(U2), torch.tensor(np.asarray(j1[2])))
    return ([np.asarray(o) for o in j1], [np.asarray(o) for o in j2],
            [o.numpy() for o in t1], [o.numpy() for o in t2])


def test_mala_warm_misfit_matches_jax_jacobi(problem):
    """Every input f32: Φ and the forward solution within 1e-5, ∇Φ and the
    adjoint solution (which inherit the amplified rounding) within the f32
    gradient bound."""
    j1, j2, t1, t2 = two_calls(problem, "jacobi", 6)
    for want, got in ((j1, t1), (j2, t2)):
        np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
        assert_f32_gradient(got[1], want[1])
        assert got[2].shape == want[2].shape == (128, B)
        assert col_err(got[2][:64], want[2][:64]).max() <= 1e-5
        assert_f32_gradient(got[2][64:], want[2][64:])


@pytest.mark.parametrize("precond", ["dst", "dst_trunc"])
def test_mala_warm_misfit_matches_jax_bf16(problem, precond):
    """bf16 preconditioner inputs: an ulp-level difference can flip one
    rounding, which a few CG iterations do not damp, and the gradient
    inherits it through both solutions. So the bound is statistical: the
    median draw within 2e-5 (Φ) / 1e-4 (∇Φ, aux), every draw within 5e-3
    (Φ, x) / 2e-2 (∇Φ, λ)."""
    j1, j2, t1, t2 = two_calls(problem, precond, 4)
    for want, got in ((j1, t1), (j2, t2)):
        rel = np.abs(got[0] - want[0]) / np.abs(want[0])
        assert np.median(rel) <= 2e-5 and rel.max() <= 5e-3
        for rows, worst in ((slice(0, 64), 5e-3), (slice(64, 128), 2e-2)):
            err = col_err(got[2][rows], want[2][rows])
            assert np.median(err) <= 1e-4 and err.max() <= worst
        err = col_err(got[1], want[1])
        assert np.median(err) <= 1e-4 and err.max() <= 2e-2


def test_explicit_adjoint_matches_autograd_function(problem):
    """The carried-aux form from zeros is the cold value-and-grad
    (tests/test_pallas_ops.py test_explicit_adjoint_matches_custom_vjp)."""
    _, aux_t, y = problem
    pag, ad = darcy_mala_warm_misfit_from_arrays(aux_t, y, NOISE, cg_iters=60,
                                                 precond="jacobi")
    cold = darcy_misfit_from_arrays(aux_t, y, NOISE, cg_iters=60)
    U = torch.from_numpy(draws(6, b=4))
    phi1, g1, aux_out = pag(U, torch.zeros(ad, 4))
    phi2, g2 = cold.value_and_grad(U)
    assert torch.equal(phi1, phi2) and torch.equal(g1, g2)
    assert aux_out.shape == (ad, 4)


def test_argument_checks(problem):
    _, aux_t, y = problem
    pag, ad = darcy_mala_warm_misfit_from_arrays(aux_t, y, NOISE, cg_iters=2,
                                                 precond="jacobi")
    with pytest.raises(ValueError, match="aux0"):
        pag(torch.zeros(K, 4), torch.zeros(ad // 2, 4))
    with pytest.raises(ValueError, match="expected f32"):
        pag(torch.zeros(K + 1, 4), torch.zeros(ad, 4))
    with pytest.raises(ValueError, match="precond"):
        darcy_misfit_from_arrays(aux_t, y, NOISE, precond="dst")
