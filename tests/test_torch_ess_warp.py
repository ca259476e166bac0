"""Elliptical slice sampling one chain a warp (``fused_ess_warp_kernel``):
its launch geometry's Python mirror (``ops/fused_ess.py`` ``warp_geometry``;
the card tests hold it against the C function), the order of its dot
products and its shared-memory layout, the plain twin on a ragged width,
which the kernel's spare warps must match on the card, and the launch
counts' names of this slice's two kernels."""

import numpy as np
import pytest
import torch

from ip_mcmc_tpu_torch import configs
from ip_mcmc_tpu_torch.ops import _scaffold, fused_ess, fused_pcn

torch.set_num_threads(1)

# the cells in shared memory, padded by 4 after every 32 (8 × 36 floats)
CELLS = 288
BASIS = 4 * 64 * CELLS  # the staged KL basis: 64 modes, f32
SLICE = 4 * (2 * 64 + 3 * CELLS)  # a warp's pos, prop and p, th, tv


@pytest.mark.parametrize("n, block, ctas, w", [
    (4096, 256, 256, 16),  # darcy_ess_fused
    (13, 8, 2, 8),         # a ragged last CTA of 3 spare warps
    (13, 13, 13, 1),       # an odd block: one chain a CTA
    (20, 4, 5, 4),
    (0, 256, 0, 16),
])
def test_warp_geometry(n, block, ctas, w):
    """(CTAs, chains a CTA, bytes): W is the largest power of two up to 16
    that divides block_chains, and the bytes are the staged basis and W
    warps' slices."""
    assert fused_ess.warp_geometry(n, block) == (ctas, w, BASIS + w * SLICE)


def test_warp_geometry_of_the_shipped_config():
    p = configs.build("darcy_ess_fused", "cpu")
    pot = p.batched_potential_fn
    got = fused_ess.warp_geometry(p.n_chains, p.kernel_params["block_chains"], n=pot.n,
                                  d=p.dim, precond=pot.precond, modes=pot.modes)
    assert got == (256, 16, 137_216) and got[2] <= fused_ess.MAX_SMEM_BYTES
    assert (fused_ess.BASIS_BYTES, fused_ess.WARP_SLICE_BYTES) == (BASIS, SLICE)


@pytest.mark.parametrize("kw, why", [
    (dict(n=8), "16x16 grid"), (dict(d=36), "d = 64"),
    (dict(precond="dst_trunc", modes=64), "Jacobi"), (dict(block_chains=0), "block_chains 0"),
])
def test_warp_geometry_refuses_what_the_kernel_does_not_take(kw, why):
    block = kw.pop("block_chains", 256)
    with pytest.raises(ValueError, match=why):
        fused_ess.warp_geometry(64, block, **kw)


# --- the order of the dot products ------------------------------------------


def _warp_sum(v):
    """warp_sum (block_reduce.cuh) on 32 lanes' f32 values: the butterfly
    v += shfl_xor(v, o) for o = 16, 8, 4, 2, 1; every lane's result."""
    v = v.astype(np.float32)
    for o in (16, 8, 4, 2, 1):
        v = (v + v[np.arange(32) ^ o]).astype(np.float32)
    return v


def _block_sum(cells):
    """block_sum over a CTA of 256 threads, one cell a thread: each warp's
    warp_sum, then 0 + warp 0 + ... + warp 7 in order."""
    total = np.float32(0.0)
    for w in range(8):
        total = np.float32(total + _warp_sum(cells[32 * w:32 * w + 32])[0])
    return total


def _slice_level_dot(cells):
    """WarpSliceLevel::dot (darcy_misfit.cuh) on a warp whose lane l holds
    cells 32 (l // 4) + l % 4 + 4 k, k = 0..7, as the kernel runs it: the
    three in-lane levels, two shuffle levels, then the eight slice sums
    from lanes 4 c in order. Returns every lane's result."""
    lanes = np.arange(32)
    v = cells[32 * (lanes[:, None] // 4) + lanes[:, None] % 4 + 4 * np.arange(8)]
    v = v.astype(np.float32)
    b0 = (v[:, 0] + v[:, 4]) + (v[:, 2] + v[:, 6])
    b1 = (v[:, 1] + v[:, 5]) + (v[:, 3] + v[:, 7])
    t = (b0 + b1).astype(np.float32)
    for o in (2, 1):
        t = (t + t[lanes ^ o]).astype(np.float32)
    total = np.zeros(32, np.float32)
    for c in range(8):
        total = (total + t[4 * c]).astype(np.float32)
    return total


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_slice_level_dot_adds_in_block_sums_order(seed):
    """The warp kernel's dot product gives the bits of block_sum over the
    one-chain-a-CTA kernel's threads, in every lane, on values of widely
    spread magnitude (where another order would round otherwise)."""
    rng = np.random.default_rng(seed)
    cells = (rng.standard_normal(256) * 10.0 ** rng.uniform(-6, 6, 256)).astype(np.float32)
    got = _slice_level_dot(cells)
    assert np.all(got == got[0])
    assert got[0] == _block_sum(cells)
    lane_first = np.float32(_warp_sum(cells.reshape(8, 32).T.sum(axis=1, dtype=np.float32))[0])
    assert seed != 0 or lane_first != got[0]  # the lane's own cells first: other bits


def test_slice_level_layout_is_free_of_bank_conflicts():
    """The padded index 36 (l // 4) + l % 4 + 4 k of each lane's k-th cell,
    and of its neighbours (± 1; below: + 16 for k < 4, + 20 else; above:
    - 20, - 16), puts the 32 lanes in 32 distinct banks."""
    lanes = np.arange(32)
    for k in range(8):
        at = 36 * (lanes // 4) + lanes % 4 + 4 * k
        for shift in (0, 1, -1, 16 if k < 4 else 20, -20 if k < 4 else -16):
            assert len(set((at + shift) % 32)) == 32


# --- the plain twin and the names --------------------------------------------


def test_ess_twin_on_a_ragged_width_gives_the_first_chains():
    """The ESS twin on 13 chains in blocks of 8 (two CTAs of 8 warps on the
    card, 3 of them spare) gives the first 13 chains of the 16-chain run:
    a chain's draws depend on its block and lane alone."""
    p = configs.build("darcy_ess_fused", "cpu")
    pot = p.batched_potential_fn._forward_plain
    pos = p.init_positions(torch.Generator().manual_seed(31), 16)
    args = (p.prior.mean, p.prior.scale, 9, 2, p.kernel_params["max_shrink"], 8)
    ref = fused_ess._run_plain(pot, pos, *args, thin=1)
    got = fused_ess._run_plain(pot, pos[:13], *args, thin=1)
    assert (got[0] - ref[0][:13]).abs().max() <= 1e-5
    assert torch.equal(got[1], ref[1][:13])
    assert (got[2] - ref[2][:, :13]).abs().max() <= 1e-5


def test_kernel_names_of_the_two_new_kernels():
    """The launch counts' names of the warp ESS kernel and of the 32² warm
    pCN cluster kernel, plain and recorded."""
    warm = configs.build("darcy32_pcn_warm", "cpu").batched_warm_potential[0]
    assert _scaffold.kernel_name(fused_ess.KERNEL, False) == "fused_ess_warp_kernel<false>"
    assert _scaffold.kernel_name(fused_ess.KERNEL, True) == "fused_ess_warp_kernel<true>"
    stem = fused_pcn._darcy_stem(warm, True)
    assert _scaffold.kernel_name(stem, False) == "fused_pcn_warm_cluster32_kernel<false>"
    assert _scaffold.kernel_name(stem, True) == "fused_pcn_warm_cluster32_kernel<true>"
