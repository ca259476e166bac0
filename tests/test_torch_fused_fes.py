"""The port's fused functional ensemble sampler (K9)
(ip_mcmc_tpu_torch/ops/fused_fes.py, plain scaffold on the CPU) against the
JAX Pallas kernel in interpret mode on an 8×8 Darcy problem; and the
properties tests/test_pallas_ops.py asserts for it (TestFusedFES)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ip_mcmc_tpu import ops as jops
from ip_mcmc_tpu.kernels import ensemble as jensemble
from ip_mcmc_tpu.models import darcy as jdarcy
from ip_mcmc_tpu.ops import fused_mcmc as jfused
from ip_mcmc_tpu_torch import ops
from ip_mcmc_tpu_torch.convert import darcy_misfit_from_arrays
from ip_mcmc_tpu_torch.models import kl
from ip_mcmc_tpu_torch.ops import _scaffold, fused_fes
from test_torch_fused_pcn import (
    BLOCK, K, N, NOISE, agreeing, positions, small_darcy)

torch.set_num_threads(1)

STEPS, M = 6, 4
# a prior that is not standard: w = (pos − m)/s is not the identity
PM2 = (0.1 * np.random.default_rng(8).standard_normal(K)).astype(np.float32)
PS2 = (1.0 + 0.5 * np.random.default_rng(9).random(K)).astype(np.float32)


@pytest.fixture(scope="module")
def pots():
    aux_j, aux_t, y = small_darcy()
    return (jdarcy.make_batched_misfit(aux_j, y, NOISE, cg_iters=12),
            darcy_misfit_from_arrays(aux_t, y, NOISE, cg_iters=12))


@pytest.mark.parametrize("recorded", [False, True])
def test_fes_chain_matches_jax(pots, recorded):
    """Every input f32: at least 62 of 64 chains end (and record) within
    1e-4 of JAX's, with the same pCN acceptance counts and, from the plain
    entry point, the same stretch acceptance counts. This also settles the
    partner's direction (lane i reads lane i − shift): the other one gives
    other chains."""
    pot_j, pot_t = pots
    pos = positions()
    kw = dict(pcn_beta=0.1, stretch_a=2.0, n_steps=STEPS, block_chains=BLOCK)
    if recorded:
        out_j = jops.fused_fes_chain_recorded(pot_j, jnp.asarray(pos), PM2, PS2, M,
                                              5, thin=2, **kw)
        out_t = ops.fused_fes_chain_recorded(pot_t, torch.from_numpy(pos), PM2,
                                             PS2, M, 5, thin=2, **kw)
    else:
        out_j = jops.fused_fes_chain(pot_j, jnp.asarray(pos), PM2, PS2, M, 5, **kw)
        out_t = ops.fused_fes_chain(pot_t, torch.from_numpy(pos), PM2, PS2, M, 5,
                                    **kw)
    assert len(out_j) == len(out_t) == 3
    out_j = [np.asarray(o) for o in out_j]
    out_t = [o.numpy() for o in out_t]
    ok = agreeing(out_t[0], out_j[0])
    if recorded:
        assert out_t[2].shape == out_j[2].shape == (STEPS // 2, N, K)
        ok &= agreeing(out_t[2], out_j[2]).all(axis=0)
    assert ok.sum() >= 62
    rates = (1,) if recorded else (1, 2)
    for r in rates:
        np.testing.assert_array_equal(np.rint(out_t[r][ok] * STEPS),
                                      np.rint(out_j[r][ok] * STEPS))
        assert 0.0 < out_t[r].mean() < 1.0


def test_block_draw_matches_jax():
    """A (rows, 1) draw on the plain scaffold is element 0.. of the block's
    own stream, the same for every chain of the block (rand_u((1, 1), tag)
    of the JAX kernel)."""
    seen = {}

    def builder(pot):
        def init(pos):
            return (pos,)

        def step(carry, rand_n, rand_u):
            seen["u"] = rand_u((1, 1), 32)
            return carry, torch.zeros((1, carry[0].shape[1]), dtype=torch.bool)

        return init, step

    _scaffold.run_plain(builder, None, torch.zeros(64, 2), [], 11, 3, 32)
    assert seen["u"].shape == (1, 64)
    for blk in range(2):
        key = jfused._mix_key(jnp.uint32(11 + 7919 * blk), jnp.uint32(2), 32)
        want = float(jfused._uniform01(key, (1, 1))[0, 0])
        np.testing.assert_array_equal(seen["u"][0, 32 * blk:32 * (blk + 1)].numpy(),
                                      np.full(32, want, np.float32))


def _target():
    C = np.array([[1.0, 0.9], [0.9, 1.0]], np.float32)
    P = torch.tensor(np.linalg.inv(C))
    mu = torch.tensor([0.7, -0.3])

    def phi(x):  # posterior N(mu, C) under prior N(0, 9I)
        d = x - mu[:, None]
        return (0.5 * torch.sum(d * (P @ d), dim=0)
                - 0.5 * torch.sum(x * x, dim=0) / 9.0)

    return phi, mu.numpy(), C


def test_correlated_posterior_no_tuning():
    """Affine invariance: the correlated posterior is matched with no
    covariance adaptation, including the 0.9 cross-correlation
    (TestFusedFES.test_correlated_posterior_no_tuning)."""
    phi, mu, C = _target()
    pos = 3.0 * torch.randn(512, 2, generator=torch.Generator().manual_seed(0))
    kw = dict(prior_mean=np.zeros(2), prior_scale=3.0 * np.ones(2),
              n_low_modes=2, block_chains=128)
    for seed in (1, 2):
        pos, acc, stretch_acc = ops.fused_fes_chain(phi, pos, seed=seed,
                                                    n_steps=600, **kw)
    p = pos.numpy()
    np.testing.assert_allclose(p.mean(axis=0), mu, atol=0.08)
    np.testing.assert_allclose(np.cov(p.T), C, atol=0.15)
    assert stretch_acc.shape == (512,)
    assert 0.05 < float(stretch_acc.mean()) < 0.95


def test_odd_block_rejected():
    phi, *_ = _target()
    for fn in (ops.fused_fes_chain, ops.fused_fes_chain_recorded):
        with pytest.raises(ValueError, match="even"):
            fn(phi, torch.zeros(254, 2), prior_mean=np.zeros(2),
               prior_scale=3.0 * np.ones(2), n_low_modes=2, seed=1, n_steps=2,
               block_chains=127)


def test_recorded_matches_endpoint():
    phi, *_ = _target()
    f, acc, s = ops.fused_fes_chain_recorded(
        phi, torch.zeros(256, 2), prior_mean=np.zeros(2),
        prior_scale=3.0 * np.ones(2), n_low_modes=2, seed=5, n_steps=12, thin=3,
        block_chains=128)
    assert s.shape == (4, 256, 2) and torch.equal(s[-1], f)
    f2, acc2, _ = ops.fused_fes_chain(
        phi, torch.zeros(256, 2), prior_mean=np.zeros(2),
        prior_scale=3.0 * np.ones(2), n_low_modes=2, seed=5, n_steps=12,
        block_chains=128)
    assert torch.equal(f2, f) and torch.equal(acc2, acc)


@pytest.mark.parametrize("frac", [0.5, 0.9, 0.99])
def test_choose_n_low_modes_matches_jax(frac):
    _, ij = kl.sine_basis_2d(8, 16)
    lam = kl.laplacian_eigenvalues_2d(ij, alpha=2.0, scale=10.0)
    for spectrum in (lam, lam[::-1], np.ones(5), 1.0 / np.arange(1, 40) ** 3):
        for kw in ({}, {"max_modes": 3}, {"min_modes": 7}):
            assert fused_fes.choose_n_low_modes(spectrum, frac, **kw) == \
                jensemble.choose_n_low_modes(spectrum, frac, **kw)
    with pytest.raises(ValueError, match="spectrum"):
        fused_fes.choose_n_low_modes([])


def test_kernel_takes_darcy_misfits_only(pots):
    with pytest.raises(TypeError, match="DarcyMisfit"):
        fused_fes._launch(lambda U: U.sum(0), torch.zeros(64, K), PM2, PS2, M, 0,
                          0.1, 2.0, 2, 64)


def test_fes_dst_trunc_chain_matches_jax():
    """An 8×8 dst_trunc misfit (32 modes, 4 CG), a spec the card runs one
    chain a CTA (fused_fes_kernel): bf16 preconditioner inputs, so a
    rounding flip can turn a decision and part a chain (and its partners)
    from JAX's; most chains within 1e-4, mean rates within 0.05."""
    aux_j, aux_t, y = small_darcy()
    kw = dict(cg_iters=4, precond="dst_trunc", precond_modes=32)
    pot_j = jdarcy.make_batched_misfit(aux_j, y, NOISE, **kw)
    pot_t = darcy_misfit_from_arrays(aux_t, y, NOISE, **kw)
    pos = positions(7)
    kw = dict(pcn_beta=0.1, stretch_a=2.0, n_steps=3, block_chains=BLOCK)
    out_j = [np.asarray(o) for o in jops.fused_fes_chain(pot_j, jnp.asarray(pos), PM2, PS2,
                                                         M, 6, **kw)]
    out_t = [o.numpy() for o in ops.fused_fes_chain(pot_t, torch.from_numpy(pos), PM2, PS2,
                                                    M, 6, **kw)]
    assert agreeing(out_t[0], out_j[0]).sum() >= 56
    for r in (1, 2):
        assert abs(out_t[r].mean() - out_j[r].mean()) <= 0.05
    assert fused_fes.route(**pot_t.spec_fields, d=K) == "cta"


# the takes-rule (``fes_route``'s mirror, elliptical slice sampling's rule):
# a spec's fields, d, the kernel
ROUTES = [
    (dict(n=16, K=64, precond="jacobi", modes=0, solver="cg"), 64, "warp"),  # darcy_fes_fused
    (dict(n=16, K=64, precond="dst_trunc", modes=128, solver="cg"), 64, "cta"),
    (dict(n=8, K=16, precond="dst_trunc", modes=32, solver="cg"), 16, "cta"),
    (dict(n=8, K=16, precond="jacobi", modes=0, solver="cg"), 16, "cta"),
    (dict(n=16, K=64, precond="jacobi", modes=0, solver="cg"), 32, None),  # K != d
    (dict(n=24, K=64, precond="dst_trunc", modes=128, solver="cg"), 64, None),
]


@pytest.mark.parametrize("fields, d, kernel", ROUTES)
def test_route_sends_each_spec_to_its_kernel(fields, d, kernel):
    """Shipped specs go to the warp kernel, the rest of the 16² class to the
    one-chain-a-CTA kernel, larger grids nowhere; ``warp_takes`` is the
    warp route."""
    assert fused_fes.route(**fields, d=d) == kernel
    assert fused_fes.warp_takes(**fields, d=d) == (kernel == "warp")
