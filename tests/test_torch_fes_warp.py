"""The functional ensemble sampler one chain a warp (``fused_fes_warp_kernel``):
its launch geometry's Python mirror (``ops/fused_fes.py`` ``warp_geometry``;
the card tests hold it against the C function), the order in which it adds
the stretch move's prior term, and the plain twin on a ragged count of
ensembles, which the kernel's spare warps must match on the card."""

import numpy as np
import pytest
import torch

from ip_mcmc_tpu_torch import configs
from ip_mcmc_tpu_torch.ops import _scaffold, fused_fes
from ip_mcmc_tpu_torch.runner import _resolve_n_low_modes

torch.set_num_threads(1)

# the cells in shared memory, padded by 4 after every 32 (8 × 36 floats)
CELLS = 288
BASIS = 4 * 64 * CELLS  # the staged KL basis: 64 modes, f32
SLICE = 4 * (64 + 3 * CELLS)  # a warp's prop and p, th, tv


@pytest.mark.parametrize("n, block, ctas, w", [
    (4096, 256, 128, 16),  # darcy_fes_fused: 2048 chains of one parity a launch
    (24, 8, 2, 8),         # three ensembles: a ragged last CTA of 4 spare warps
    (12, 6, 3, 2),         # an ensemble of 6: two chains a CTA
    (0, 256, 0, 16),
])
def test_warp_geometry(n, block, ctas, w):
    """(CTAs, chains a CTA, bytes) of a launch, which runs the n / 2 chains
    of one parity: W is the largest power of two up to 16 that divides
    block_chains, and the bytes are the staged basis and W warps' slices."""
    assert fused_fes.warp_geometry(n, block) == (ctas, w, BASIS + w * SLICE)


def test_warp_geometry_of_the_shipped_config():
    p = configs.build("darcy_fes_fused", "cpu")
    pot = p.batched_potential_fn
    got = fused_fes.warp_geometry(p.n_chains, p.kernel_params["block_chains"], n=pot.n,
                                  d=p.dim, precond=pot.precond, modes=pot.modes)
    assert got == (128, 16, 133_120) and got[2] <= fused_fes.MAX_SMEM_BYTES
    assert (fused_fes.BASIS_BYTES, fused_fes.WARP_SLICE_BYTES) == (BASIS, SLICE)


@pytest.mark.parametrize("args, kw, why", [
    ((64, 16), dict(n=8), "16x16 grid"), ((64, 16), dict(d=36), "d = 64"),
    ((64, 16), dict(precond="dst_trunc", modes=64), "Jacobi"),
    ((63, 7), {}, "even block_chains"), ((40, 16), {}, "whole ensembles"),
    ((64, 0), {}, "block_chains 0"),
])
def test_warp_geometry_refuses_what_the_kernel_does_not_take(args, kw, why):
    with pytest.raises(ValueError, match=why):
        fused_fes.warp_geometry(*args, **kw)


# --- the order of the prior term -----------------------------------------------


def _warp_sum(v):
    """warp_sum (block_reduce.cuh) on 32 lanes' f32 values: the butterfly
    v += shfl_xor(v, o) for o = 16, 8, 4, 2, 1; every lane's result."""
    v = v.astype(np.float32)
    for o in (16, 8, 4, 2, 1):
        v = (v + v[np.arange(32) ^ o]).astype(np.float32)
    return v


def _block_sum_256(coords):
    """block_sum over the one-chain-a-CTA kernel's 256 threads, thread t
    holding coordinate t's term (t < 64) or 0: each warp's warp_sum, then
    0 + warp 0 + ... + warp 7 in order."""
    threads = np.zeros(256, np.float32)
    threads[:64] = coords
    total = np.float32(0.0)
    for w in range(8):
        total = np.float32(total + _warp_sum(threads[32 * w:32 * w + 32])[0])
    return total


def _warp_d_prior_sum(coords):
    """The warp kernel's sum: lane l holds coordinates l and l + 32, each
    goes through the butterfly, then 0 + r0 + r1. Every lane's result."""
    r0, r1 = _warp_sum(coords[:32]), _warp_sum(coords[32:])
    return ((np.float32(0.0) + r0).astype(np.float32) + r1).astype(np.float32)


@pytest.mark.parametrize("n_low, seed", [(8, 0), (8, 1), (40, 2), (64, 3), (0, 4)])
def test_d_prior_adds_in_block_sums_order(n_low, seed):
    """The prior term of the stretch move (w'² − w² on rows < M, 0 on the
    rest) gives the bits of block_sum over 256 threads in every lane: the
    six warps of zeros add +0, which changes nothing."""
    rng = np.random.default_rng(seed)
    w, wp = (rng.standard_normal(64) * 10.0 ** rng.uniform(-3, 3, 64) for _ in range(2))
    terms = np.where(np.arange(64) < n_low,
                     (np.float32(wp) ** 2 - np.float32(w) ** 2), 0.0).astype(np.float32)
    got = _warp_d_prior_sum(terms)
    assert np.all(got == got[0])
    assert got[0] == _block_sum_256(terms)


# --- the plain twin -------------------------------------------------------------


def test_fes_twin_on_a_ragged_count_of_ensembles_gives_the_first_chains():
    """The ensemble twin on three ensembles of 8 (on the card: 12 chains a
    launch in two CTAs of 8 warps, 4 of them spare) gives the 16 chains of
    the first two ensembles as a run of those two alone, plain and
    recorded: ensembles do not read one another."""
    p = configs.build("darcy_fes_fused", "cpu")
    pot = p.batched_potential_fn._forward_plain
    n_low = _resolve_n_low_modes(p.kernel_params, p)
    pos = p.init_positions(torch.Generator().manual_seed(43), 24)
    args = (p.prior.mean, p.prior.scale, n_low, 11, 0.08, 2.0, 2, 8)
    for thin in (None, 1):
        got = fused_fes._run_plain(pot, pos, *args, thin=thin)
        ref = fused_fes._run_plain(pot, pos[:16], *args, thin=thin)
        assert (got[0][:16] - ref[0]).abs().max() <= 1e-5
        assert torch.equal(got[1][:16], ref[1])
        if thin is None:
            assert torch.equal(got[2][:16], ref[2])
        else:
            assert (got[2][:, :16] - ref[2]).abs().max() <= 1e-5


def test_kernel_name():
    assert _scaffold.kernel_name(fused_fes.KERNEL, False) == "fused_fes_warp_kernel<false>"
    assert _scaffold.kernel_name(fused_fes.KERNEL, True) == "fused_fes_warp_kernel<true>"
