"""The three-level Burgers DA one chain a warp (``fused_da3_pcn_warp_kernel``):
its launch geometry's Python mirror (``ops/fused_da3_pcn.py``
``warp_geometry``; the card tests hold it against the C function), the
order in which its warp-level Burgers solve adds the squared residuals, and
the plain twin on a ragged width, which the kernel's spare warps must match
on the card."""

import numpy as np
import pytest
import torch

from ip_mcmc_tpu_torch import configs
from ip_mcmc_tpu_torch.ops import _scaffold, fused_da3_pcn as da3

torch.set_num_threads(1)

# the staged levels: (K + 1) rows (basis and mean) of 128 + 128 + 64 cells, f32
STAGED = 4 * 17 * (128 + 128 + 64)
SLICE = 4 * (4 * 16 + 128)  # a warp's four positions and gather buffer


@pytest.mark.parametrize("n, block, ctas, w", [
    (2048, 512, 128, 16),  # burgers_da3_pcn
    (13, 8, 2, 8),        # a ragged last CTA of 3 spare warps
    (13, 13, 13, 1),      # an odd block: one chain a CTA
    (20, 4, 5, 4),
    (0, 512, 0, 16),
])
def test_warp_geometry(n, block, ctas, w):
    """(CTAs, chains a CTA, bytes): W is the largest power of two up to 16
    that divides block_chains, and the bytes are the three staged levels
    and W warps' slices."""
    assert da3.warp_geometry(n, block) == (ctas, w, STAGED + w * SLICE)


def test_warp_geometry_of_the_shipped_config():
    p = configs.build("burgers_da3_pcn", "cpu")
    levels = (p.batched_potential_fn, p.batched_mid_fn, p.batched_surrogate_fn)
    got = da3.warp_geometry(p.n_chains, p.kernel_params.get("block_chains", 512),
                            cells=tuple(lv.n for lv in levels), d=p.dim, K=levels[0].K)
    assert got == (128, 16, 34_048) and got[2] <= da3.MAX_SMEM_BYTES


@pytest.mark.parametrize("kw, why", [
    (dict(cells=(128, 96, 64)), "cells"), (dict(cells=(256, 128, 64)), "cells"),
    (dict(d=8, K=8), "d = K = 16"), (dict(block_chains=0), "block_chains 0"),
])
def test_warp_geometry_refuses_what_the_kernel_does_not_take(kw, why):
    block = kw.pop("block_chains", 512)
    with pytest.raises(ValueError, match=why):
        da3.warp_geometry(64, block, **kw)


# --- the order of Phi's sum ---------------------------------------------------


def _warp_sum(v):
    """warp_sum (block_reduce.cuh) on 32 lanes' f32 values: the butterfly
    v += shfl_xor(v, o) for o = 16, 8, 4, 2, 1; every lane's result."""
    v = v.astype(np.float32)
    for o in (16, 8, 4, 2, 1):
        v = (v + v[np.arange(32) ^ o]).astype(np.float32)
    return v


def _block_sum(per_thread):
    """block_sum over the one-chain-a-CTA kernel's 128 threads: each warp's
    warp_sum, then 0 + warp 0 + ... + warp 3 in order."""
    total = np.float32(0.0)
    for w in range(4):
        total = np.float32(total + _warp_sum(per_thread[32 * w:32 * w + 32])[0])
    return total


def _warp_level_sum(per_thread, m):
    """burgers_phi_warp's sum: lane l keeps old thread 32 w + l's partial for
    each old warp w, runs each through the butterfly, and adds 0 + w0 + ...
    over the old warps up to the last residual. Every lane's result."""
    partials = per_thread.reshape(4, 32).astype(np.float32)  # [w][lane]
    old_warps = (m + 31) // 32 if m < 128 else 4
    total = np.zeros(32, np.float32)
    for w in range(old_warps):
        total = (total + _warp_sum(partials[w])).astype(np.float32)
    return total


def _per_thread(m, seed):
    """Each old thread's sum of squared residuals o = t, t + 128, ... (0 for
    a thread with none), of widely spread magnitude."""
    rng = np.random.default_rng(seed)
    res = (rng.standard_normal(m) * 10.0 ** rng.uniform(-4, 4, m)).astype(np.float32)
    sq = np.zeros(128, np.float32)
    for o in range(m):
        sq[o % 128] = np.float32(sq[o % 128] + np.float32(res[o] * res[o]))
    return sq


@pytest.mark.parametrize("m, seed", [(16, 0), (16, 1), (48, 2), (100, 3), (128, 4), (300, 5)])
def test_warp_level_sum_adds_in_block_sums_order(m, seed):
    """The warp solve's Phi sum gives the bits of block_sum over the
    one-chain-a-CTA kernel's 128 threads, in every lane, for the configs'
    16 observations and for more (the old warps with no residual add +0,
    which the warp skips)."""
    sq = _per_thread(m, seed)
    got = _warp_level_sum(sq, m)
    assert np.all(got == got[0])
    assert got[0] == _block_sum(sq)


def test_another_order_gives_other_bits():
    """Summing the old warps first and the lanes last rounds otherwise on
    these values: the order is not free."""
    sq = _per_thread(128, 4)
    lane_last = np.float32(_warp_sum(sq.reshape(4, 32).sum(axis=0, dtype=np.float32))[0])
    assert lane_last != _block_sum(sq)


# --- the plain twin -------------------------------------------------------------


def test_da3_twin_on_a_ragged_width_gives_the_first_chains():
    """The three-level twin on 13 chains in blocks of 8 (two CTAs of 8 warps
    on the card, 3 of them spare) gives the first 13 chains of the 16-chain
    run, plain and recorded: a chain's draws depend on its block and lane
    alone."""
    p = configs.build("burgers_da3_pcn", "cpu")
    levels = tuple(f._forward_plain for f in
                   (p.batched_potential_fn, p.batched_mid_fn, p.batched_surrogate_fn))
    pos = p.init_positions(torch.Generator().manual_seed(41), 16)
    args = (p.prior.mean, p.prior.scale, 0.25, 9, 2, 2, 2, 8)
    for thin in (None, 1):
        ref = da3._run_plain(*levels, pos, *args, thin=thin)
        got = da3._run_plain(*levels, pos[:13], *args, thin=thin)
        assert (got[0] - ref[0][:13]).abs().max() <= 1e-5
        assert torch.equal(got[1], ref[1][:13])
        if thin is None:
            assert torch.equal(got[2], ref[2][:13])
        else:
            assert (got[2] - ref[2][:, :13]).abs().max() <= 1e-5


def test_kernel_name():
    assert _scaffold.kernel_name(da3.KERNEL, False) == "fused_da3_pcn_warp_kernel<false>"
    assert _scaffold.kernel_name(da3.KERNEL, True) == "fused_da3_pcn_warp_kernel<true>"
