"""The port's fused MALA, cold (K10) and warm-started (K11)
(ip_mcmc_tpu_torch/ops/fused_mala.py, plain scaffold on the CPU), against
the JAX Pallas kernels in interpret mode on an 8×8 Darcy problem; and the
properties tests/test_pallas_ops.py asserts for the warm kernel."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ip_mcmc_tpu import ops as jops
from ip_mcmc_tpu.models import darcy as jdarcy
from ip_mcmc_tpu_torch import ops
from ip_mcmc_tpu_torch.convert import (
    darcy_mala_warm_misfit_from_arrays,
    darcy_misfit_from_arrays,
)
from ip_mcmc_tpu_torch.ops import fused_mala
from test_torch_fused_pcn import (
    BLOCK, K, N, NOISE, PM, PS, agreeing, positions, small_darcy)

torch.set_num_threads(1)

STEPS, EPS = 6, 0.06
# a prior that is not standard: the fold is (u − m)/s and z/s
PM2 = (0.1 * np.random.default_rng(8).standard_normal(K)).astype(np.float32)
PS2 = (1.0 + 0.5 * np.random.default_rng(9).random(K)).astype(np.float32)


@pytest.fixture(scope="module")
def problem():
    return small_darcy()


def cold_pair(problem, pm, ps, cg_iters=12, **kw):
    """(JAX closure misfit + prior, as the JAX runner builds it; the port's
    misfit, which gets the prior as arguments)."""
    aux_j, aux_t, y = problem
    phi_b = jdarcy.make_batched_misfit(aux_j, y, NOISE, cg_iters=cg_iters,
                                       differentiable=True, **kw)
    pm_j, ps_j = jnp.asarray(pm), jnp.asarray(ps)

    def phi_full(U):
        z = (U - pm_j[:, None]) / ps_j[:, None]
        return phi_b(U) + 0.5 * jnp.sum(z * z, axis=0)

    return phi_full, darcy_misfit_from_arrays(aux_t, y, NOISE, cg_iters=cg_iters, **kw)


def warm_pair(problem, precond="jacobi", cg_iters=6):
    aux_j, aux_t, y = problem
    kw = dict(cg_iters=cg_iters, precond=precond)
    return (jdarcy.make_batched_misfit_mala_warm(aux_j, y, NOISE, **kw),
            darcy_mala_warm_misfit_from_arrays(aux_t, y, NOISE, **kw))


def assert_strict(out_j, out_t, steps=STEPS):
    """Every input f32: at least 62 of 64 chains end (and record) within
    1e-4 of JAX's, and those accepted the same number of steps."""
    out_j = [np.asarray(o) for o in out_j]
    out_t = [o.numpy() for o in out_t]
    ok = agreeing(out_t[0], out_j[0])
    if len(out_j) == 3:
        assert out_t[2].shape == out_j[2].shape
        ok &= agreeing(out_t[2], out_j[2]).all(axis=0)
    assert ok.sum() >= 62
    np.testing.assert_array_equal(np.rint(out_t[1][ok] * steps),
                                  np.rint(out_j[1][ok] * steps))
    assert 0.0 < out_t[1].mean() < 1.0


@pytest.mark.parametrize("recorded", [False, True])
def test_mala_chain_matches_jax(problem, recorded):
    phi_full, pot = cold_pair(problem, PM2, PS2)
    pos = positions()
    kw = dict(n_steps=STEPS, block_chains=BLOCK)
    if recorded:
        out_j = jops.fused_mala_chain_recorded(phi_full, jnp.asarray(pos), EPS, 5,
                                               thin=2, **kw)
        out_t = ops.fused_mala_chain_recorded(
            pot, torch.from_numpy(pos), EPS, 5, thin=2, prior_mean=PM2,
            prior_scale=PS2, **kw)
        assert out_t[2].shape == (STEPS // 2, N, K)
    else:
        out_j = jops.fused_mala_chain(phi_full, jnp.asarray(pos), EPS, 5, **kw)
        out_t = ops.fused_mala_chain(pot, torch.from_numpy(pos), EPS, 5,
                                     prior_mean=PM2, prior_scale=PS2, **kw)
    assert_strict(out_j, out_t)


@pytest.mark.parametrize("recorded", [False, True])
def test_mala_warm_chain_matches_jax(problem, recorded):
    (pag_j, aux_dim), (pag_t, aux_dim_t) = warm_pair(problem)
    assert aux_dim == aux_dim_t == 128
    pos = positions()
    kw = dict(n_steps=STEPS, aux_dim=aux_dim, block_chains=BLOCK)
    if recorded:
        out_j = jops.fused_mala_chain_warm_recorded(
            pag_j, jnp.asarray(pos), PM2, PS2, EPS, 6, thin=3, **kw)
        out_t = ops.fused_mala_chain_warm_recorded(
            pag_t, torch.from_numpy(pos), PM2, PS2, EPS, 6, thin=3, **kw)
    else:
        out_j = jops.fused_mala_chain_warm(pag_j, jnp.asarray(pos), PM2, PS2, EPS,
                                           6, **kw)
        out_t = ops.fused_mala_chain_warm(pag_t, torch.from_numpy(pos), PM2, PS2,
                                          EPS, 6, **kw)
    assert_strict(out_j, out_t)


def test_mala_warm_dst_chain_matches_jax(problem):
    """bf16 preconditioner inputs: a rounding flip moves Φ and ∇Φ of one
    proposal, can turn its MH decision and parts the chain from JAX's, so
    the check is statistical: most chains within 1e-4, mean acceptance
    within 0.05."""
    (pag_j, aux_dim), (pag_t, _) = warm_pair(problem, "dst", cg_iters=4)
    pos = positions()
    kw = dict(n_steps=STEPS, aux_dim=aux_dim, block_chains=BLOCK)
    out_j = jops.fused_mala_chain_warm(pag_j, jnp.asarray(pos), PM, PS, EPS, 7, **kw)
    out_t = ops.fused_mala_chain_warm(pag_t, torch.from_numpy(pos), PM, PS, EPS, 7,
                                      **kw)
    assert agreeing(out_t[0].numpy(), np.asarray(out_j[0])).sum() >= 56
    assert abs(float(out_t[1].mean()) - float(np.asarray(out_j[1]).mean())) <= 0.05


@pytest.mark.parametrize("warm", [False, True])
def test_records_are_the_states_of_the_plain_chain(problem, warm):
    """Recorded final equals plain final; record r is the state after
    (r + 1)·thin steps (TestFusedMalaWarm.test_recorded_matches_endpoint)."""
    pos = torch.from_numpy(positions(2))
    if warm:
        pot, aux_dim = warm_pair(problem)[1]
        plain = lambda **kw: ops.fused_mala_chain_warm(
            pot, pos, PM, PS, EPS, 9, aux_dim=aux_dim, block_chains=BLOCK, **kw)
        rec = lambda **kw: ops.fused_mala_chain_warm_recorded(
            pot, pos, PM, PS, EPS, 9, aux_dim=aux_dim, block_chains=BLOCK, **kw)
    else:
        pot = cold_pair(problem, PM, PS)[1]
        plain = lambda **kw: ops.fused_mala_chain(
            pot, pos, EPS, 9, block_chains=BLOCK, prior_mean=PM, prior_scale=PS, **kw)
        rec = lambda **kw: ops.fused_mala_chain_recorded(
            pot, pos, EPS, 9, block_chains=BLOCK, prior_mean=PM, prior_scale=PS, **kw)
    f, a, s = rec(n_steps=6, thin=2)
    assert s.shape == (3, N, K) and torch.equal(s[-1], f)
    for r in range(3):
        fr, ar = plain(n_steps=2 * (r + 1))
        assert torch.equal(fr, s[r])
    assert torch.equal(ar, a)


def test_warm_matches_cold_mala_acceptance(problem):
    """Same seed, same streams: the warm kernel (4 + 4 dst iterations from
    the carried solutions) accepts as the cold one (40 + 40 Jacobi);
    TestFusedMalaWarm.test_warm_matches_cold_mala_acceptance."""
    cold = cold_pair(problem, PM, PS, cg_iters=40)[1]
    pag, aux_dim = warm_pair(problem, "dst", cg_iters=4)[1]
    pos = torch.from_numpy(positions(3))
    _, ac = ops.fused_mala_chain(cold, pos, 0.05, 5, n_steps=30, block_chains=64,
                                 prior_mean=PM, prior_scale=PS)
    _, aw = ops.fused_mala_chain_warm(pag, pos, PM, PS, 0.05, 5, n_steps=30,
                                      aux_dim=aux_dim, block_chains=64)
    assert 0.0 < float(ac.mean()) < 1.0
    assert abs(float(ac.mean()) - float(aw.mean())) <= 0.06


def test_no_prior_targets_the_potential_alone():
    """Under a flat prior (scale 1e4) the target is exp(−potential): MALA
    on an analytic Gaussian through the shared scaffold, gradient by
    autograd."""
    prec = torch.linspace(0.5, 2.0, 4)
    phi = lambda U: 0.5 * torch.sum(prec[:, None] * U * U, dim=0)
    pos = torch.randn(512, 4, generator=torch.Generator().manual_seed(0))
    _, acc, s = ops.fused_mala_chain_recorded(phi, pos, 0.7, 3, n_steps=200,
                                              thin=1, block_chains=256,
                                              prior_mean=torch.zeros(4),
                                              prior_scale=torch.full((4,), 1e4))
    flat = s[50:].reshape(-1, 4).numpy()
    np.testing.assert_allclose(flat.mean(axis=0), np.zeros(4), atol=0.06)
    np.testing.assert_allclose(flat.var(axis=0), 1.0 / prec.numpy(), rtol=0.12)
    assert 0.3 < float(acc.mean()) < 1.0


def test_argument_checks_and_kernel_potential_types(problem):
    pag, aux_dim = warm_pair(problem)[1]
    cold = cold_pair(problem, PM, PS)[1]
    pos = torch.zeros(64, K)
    for fn in (ops.fused_mala_chain_warm, ops.fused_mala_chain_warm_recorded):
        with pytest.raises(ValueError, match="aux_dim"):
            fn(pag, pos, PM, PS, EPS, 0, n_steps=2, block_chains=64)
    with pytest.raises(ValueError, match="multiple of block_chains"):
        ops.fused_mala_chain(cold, pos, EPS, 0, n_steps=2, block_chains=48)
    with pytest.raises(ValueError, match="multiple of thin"):
        ops.fused_mala_chain_recorded(cold, pos, EPS, 0, n_steps=3, thin=2,
                                      block_chains=64)
    with pytest.raises(ValueError, match="both prior_mean and prior_scale"):
        ops.fused_mala_chain(cold, pos, EPS, 0, n_steps=2, block_chains=64,
                             prior_mean=PM)
    # the CUDA kernels take Darcy misfit modules only, the cold kernel a
    # cold one and the warm kernel a MALA-warm one; refused before any device
    with pytest.raises(TypeError, match="DarcyMisfit"):
        fused_mala._launch(lambda U: U.sum(0), pos, PM, PS, EPS, 0, 2, 64)
    with pytest.raises(TypeError, match="DarcyMisfit potentials"):
        fused_mala._launch(pag, pos, PM, PS, EPS, 0, 2, 64)
    with pytest.raises(TypeError, match="DarcyMisfitMalaWarm"):
        fused_mala._launch(cold, pos, PM, PS, EPS, 0, 2, 64, aux_dim=aux_dim)


def test_mala_dst_trunc_chain_matches_jax(problem):
    """A cold 8×8 dst_trunc misfit (32 modes, 4 + 4 CG), a spec the card runs
    one chain a CTA (fused_mala_kernel): bf16 preconditioner inputs, so a
    rounding flip can turn an MH decision and part a chain from JAX's; most
    chains within 1e-4, mean acceptance within 0.05."""
    phi_full, pot = cold_pair(problem, PM2, PS2, cg_iters=4, precond="dst_trunc",
                              precond_modes=32)
    pos = positions(3)
    kw = dict(n_steps=3, block_chains=BLOCK)
    out_j = jops.fused_mala_chain(phi_full, jnp.asarray(pos), EPS, 4, **kw)
    out_t = ops.fused_mala_chain(pot, torch.from_numpy(pos), EPS, 4, prior_mean=PM2,
                                 prior_scale=PS2, **kw)
    assert agreeing(out_t[0].numpy(), np.asarray(out_j[0])).sum() >= 56
    assert abs(float(out_t[1].mean()) - float(np.asarray(out_j[1]).mean())) <= 0.05
    assert fused_mala.route(False, **pot.spec_fields, d=K) == "cta"


# the takes-rule (``mala_route``'s mirror): warm, a spec's fields, d, the
# kernel
ROUTES = [
    (False, dict(n=16, K=64, precond="jacobi", modes=0, solver="cg"), 64, "warp"),
    (True, dict(n=16, K=64, precond="dst", modes=0, solver="cg"), 64, "warp"),
    (False, dict(n=16, K=64, precond="dst_trunc", modes=128, solver="cg"), 64, "cta"),
    (True, dict(n=16, K=64, precond="jacobi", modes=0, solver="cg"), 64, "cta"),
    (True, dict(n=16, K=64, precond="dst_trunc", modes=64, solver="cg"), 64, "cta"),
    (False, dict(n=16, K=64, precond="dst", modes=0, solver="cg"), 64, "cta"),
    (False, dict(n=8, K=16, precond="dst_trunc", modes=32, solver="cg"), 16, "cta"),
    (False, dict(n=16, K=64, precond="jacobi", modes=0, solver="cg"), 63, None),  # K != d
    (True, dict(n=32, K=64, precond="dst", modes=0, solver="cg"), 64, None),
    (False, dict(n=20, K=64, precond="jacobi", modes=0, solver="cg"), 64, None),
]


@pytest.mark.parametrize("warm, fields, d, kernel", ROUTES)
def test_route_sends_each_spec_to_its_kernel(warm, fields, d, kernel):
    """Shipped specs go to the warp kernel, the rest of the 16² class to the
    one-chain-a-CTA kernels, larger grids nowhere; ``warp_takes`` is the
    warp route."""
    assert fused_mala.route(warm, **fields, d=d) == kernel
    assert fused_mala.warp_takes(warm, **fields, d=d) == (kernel == "warp")
