"""The port's fused elliptical slice sampling (K8;
ip_mcmc_tpu_torch/ops/fused_ess.py, plain scaffold on the CPU) against the
JAX Pallas kernel in interpret mode on an 8×8 Darcy problem; and the
properties tests/test_pallas_ops.py asserts for it (TestFusedESS)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ip_mcmc_tpu import ops as jops
from ip_mcmc_tpu_torch import ops
from ip_mcmc_tpu_torch.ops import fused_ess
from test_torch_fused_pcn import (
    BLOCK, K, N, PM, PS, agreeing, cold_pair, positions, small_darcy,
)

torch.set_num_threads(1)

STEPS, SHRINK = 4, 4


@pytest.fixture(scope="module")
def potentials():
    return cold_pair(small_darcy(), cg_iters=12)


@pytest.mark.parametrize("recorded", [False, True])
def test_ess_chain_matches_jax(potentials, recorded):
    """Jacobi misfit, every input f32: at least 62 of 64 chains end (and
    record) within 1e-4 of JAX's with the same within-budget acceptance."""
    pot_j, pot_t = potentials
    pos = positions(4)
    kw = dict(n_steps=STEPS, max_shrink=SHRINK, block_chains=BLOCK)
    if recorded:
        kw["thin"] = 2
        jfn, tfn = jops.fused_ess_chain_recorded, ops.fused_ess_chain_recorded
    else:
        jfn, tfn = jops.fused_ess_chain, ops.fused_ess_chain
    out_j = [np.asarray(o) for o in jfn(pot_j, jnp.asarray(pos), PM, PS, 8, **kw)]
    out_t = [o.numpy() for o in tfn(pot_t, torch.from_numpy(pos), PM, PS, 8, **kw)]
    ok = agreeing(out_t[0], out_j[0])
    if recorded:
        assert out_t[2].shape == out_j[2].shape == (STEPS // 2, N, K)
        ok &= agreeing(out_t[2], out_j[2]).all(axis=0)
    assert ok.sum() >= 62
    np.testing.assert_array_equal(out_t[1][ok], out_j[1][ok])
    assert not np.allclose(out_t[0], pos)


def test_records_are_the_states_of_the_plain_chain(potentials):
    _, pot = potentials
    args = (pot, torch.from_numpy(positions(5)), PM, PS, 9)
    kw = dict(max_shrink=SHRINK, block_chains=BLOCK)
    f, a, s = ops.fused_ess_chain_recorded(*args, n_steps=4, thin=2, **kw)
    assert s.shape == (2, N, K) and torch.equal(s[-1], f)
    for r in range(2):
        fr, ar = ops.fused_ess_chain(*args, n_steps=2 * (r + 1), **kw)
        assert torch.equal(fr, s[r])
    assert torch.equal(ar, a)


def test_conjugate_posterior():
    """N(0, I) prior, y = (1, 1) observed with unit noise: posterior
    N(½, ½I); the default budget of 8 shrinks suffices."""
    y = torch.tensor([1.0, 1.0])
    phi = lambda x: 0.5 * torch.sum((y[:, None] - x) ** 2, dim=0)
    pos = torch.zeros(1024, 2)
    for seed in (0, 1):
        pos, acc = ops.fused_ess_chain(phi, pos, np.zeros(2), np.ones(2),
                                       seed, n_steps=300, block_chains=128)
    p = pos.numpy()
    np.testing.assert_allclose(p.mean(axis=0), [0.5, 0.5], atol=0.07)
    np.testing.assert_allclose(p.var(axis=0), [0.5, 0.5], atol=0.12)
    assert float(acc.mean()) > 0.95


def test_exhausted_budget_and_nan_stay_put():
    """A chain whose bracket has not accepted by the budget stays where it
    was and counts as not accepted; a NaN potential never accepts."""
    sharp = lambda x: 50.0 * torch.sum((x - 1.0) ** 2, dim=0)
    pos = torch.ones(256, 2)
    f, acc = ops.fused_ess_chain(sharp, pos, np.zeros(2), np.ones(2), 2,
                                 n_steps=1, max_shrink=1, block_chains=128)
    stayed = acc == 0.0
    assert 0 < int(stayed.sum()) < 256
    assert torch.equal(f[stayed], pos[stayed])
    assert not torch.equal(f[~stayed], pos[~stayed])

    nan_off_start = lambda x: torch.where(
        (x == 1.0).all(dim=0), 0.0, float("nan"))
    f, acc = ops.fused_ess_chain(nan_off_start, pos, np.zeros(2), np.ones(2),
                                 3, n_steps=3, max_shrink=4, block_chains=128)
    assert torch.equal(f, pos) and float(acc.max()) == 0.0


def test_argument_checks_and_kernel_potential_type():
    phi = lambda x: 0.5 * torch.sum(x * x, dim=0)
    pos = torch.zeros(48, 2)
    with pytest.raises(ValueError, match="multiple of block_chains"):
        ops.fused_ess_chain(phi, pos, np.zeros(2), np.ones(2), 0, n_steps=2,
                            block_chains=32)
    with pytest.raises(ValueError, match="multiple of thin"):
        ops.fused_ess_chain_recorded(phi, pos, np.zeros(2), np.ones(2), 0,
                                     n_steps=3, thin=2, block_chains=16)
    # the CUDA kernel refuses a callable before touching any device
    with pytest.raises(TypeError, match="DarcyMisfit"):
        fused_ess._launch(phi, pos, np.zeros(2), np.ones(2), 0, 2, 4, 16)


def test_ess_dst_trunc_chain_matches_jax():
    """An 8×8 dst_trunc misfit (32 modes, 4 CG), a spec the card runs one
    chain a CTA (fused_ess_kernel): bf16 preconditioner inputs, so a
    rounding flip can move a slice and part a chain from JAX's; most chains
    within 1e-4, mean acceptance within 0.05."""
    pot_j, pot_t = cold_pair(small_darcy(), cg_iters=4, precond="dst_trunc",
                             precond_modes=32)
    pos = positions(6)
    kw = dict(n_steps=3, max_shrink=SHRINK, block_chains=BLOCK)
    out_j = [np.asarray(o) for o in jops.fused_ess_chain(pot_j, jnp.asarray(pos), PM, PS, 8,
                                                         **kw)]
    out_t = [o.numpy() for o in ops.fused_ess_chain(pot_t, torch.from_numpy(pos), PM, PS, 8,
                                                    **kw)]
    assert agreeing(out_t[0], out_j[0]).sum() >= 56
    assert abs(out_t[1].mean() - out_j[1].mean()) <= 0.05
    assert fused_ess.route(**pot_t.spec_fields, d=K) == "cta"


# the takes-rule (``ess_route``'s mirror): a spec's fields, d, the kernel
ROUTES = [
    (dict(n=16, K=64, precond="jacobi", modes=0, solver="cg"), 64, "warp"),  # darcy_ess_fused
    (dict(n=16, K=64, precond="dst_trunc", modes=128, solver="cg"), 64, "cta"),
    (dict(n=16, K=64, precond="dst", modes=0, solver="cg"), 64, "cta"),
    (dict(n=12, K=36, precond="jacobi", modes=0, solver="cg"), 36, "cta"),
    (dict(n=8, K=16, precond="dst_trunc", modes=32, solver="cg"), 16, "cta"),
    (dict(n=16, K=64, precond="jacobi", modes=0, solver="cg"), 48, None),  # K != d
    (dict(n=17, K=64, precond="jacobi", modes=0, solver="cg"), 64, None),  # above 16²
    (dict(n=32, K=64, precond="jacobi", modes=0, solver="cg"), 64, None),
    (dict(n=16, K=64, precond="jacobi", modes=0, solver="richardson"), 64, None),
]


@pytest.mark.parametrize("fields, d, kernel", ROUTES)
def test_route_sends_each_spec_to_its_kernel(fields, d, kernel):
    """Shipped specs go to the warp kernel, the rest of the 16² class to the
    one-chain-a-CTA kernel, larger grids nowhere; ``warp_takes`` is the
    warp route."""
    assert fused_ess.route(**fields, d=d) == kernel
    assert fused_ess.warp_takes(**fields, d=d) == (kernel == "warp")
