"""MALA one chain a warp (``fused_mala_warp_kernel<RECORD, PRECOND>``): its
launch geometry's Python mirror (``ops/fused_mala.py`` ``warp_geometry``;
the card tests hold it against the C function) and its refusals, NumPy
mirrors of the orders in which the warp adds what the one-chain-a-CTA
kernel's threads added (Σ log a, the prior fold and the proposal sums, the
KL product of the gradient, the dense dst preconditioner's four stages),
and the plain twins on a ragged width, which the kernel's spare warps must
match on the card."""

import numpy as np
import pytest
import torch

from ip_mcmc_tpu_torch import configs
from ip_mcmc_tpu_torch.ops import _scaffold, fused_mala

torch.set_num_threads(1)

# the cells in shared memory, padded by 4 after every 32 (8 × 36 floats)
CELLS = 288
BASIS = 4 * 64 * CELLS  # the staged KL basis: 64 modes, f32
DST = 2 * 2 * 16 * 24 + 4 * CELLS  # S and Sᵀ, bf16 rows of 24; λ, f32
COLD_SLICE = 4 * (2 * 64 + 5 * CELLS)  # pos, prop; a, x, p, th, tv
WARM_SLICE = 4 * (2 * 64 + 8 * CELLS)  # and the dst stage buffer, the carried x, λ


@pytest.mark.parametrize("n, block, ctas, w", [
    (4096, 256, 256, 16),  # darcy_mala_fused, darcy_mala_warm
    (13, 8, 2, 8),         # a ragged last CTA of 3 spare warps
    (13, 13, 13, 1),       # an odd block: one chain a CTA
    (20, 4, 5, 4),
    (0, 256, 0, 16),
])
@pytest.mark.parametrize("warm", [False, True])
def test_warp_geometry(n, block, ctas, w, warm):
    """(CTAs, chains a CTA, bytes): W is the largest power of two up to 16
    that divides block_chains, and the bytes are the staged factors and W
    warps' slices."""
    smem = BASIS + (DST + w * WARM_SLICE if warm else w * COLD_SLICE)
    assert fused_mala.warp_geometry(n, block, warm=warm) == (ctas, w, smem)


@pytest.mark.parametrize("config, warm, smem", [
    ("darcy_mala_fused", False, 174_080), ("darcy_mala_warm", True, 232_064)])
def test_warp_geometry_of_the_shipped_configs(config, warm, smem):
    p = configs.build(config, "cpu")
    pot = p.batched_warm_potential[0] if warm else p.batched_potential_fn
    got = fused_mala.warp_geometry(p.n_chains, p.kernel_params["block_chains"], warm=warm,
                                   n=pot.n, d=p.dim, precond=pot.precond, modes=pot.modes,
                                   solver=pot.solver)
    assert got == (256, 16, smem) and smem <= fused_mala.MAX_SMEM_BYTES
    assert fused_mala.BASIS_BYTES + fused_mala.DST_BYTES == BASIS + DST
    assert fused_mala.warp_slice_bytes(warm) == (WARM_SLICE if warm else COLD_SLICE)


@pytest.mark.parametrize("kw, why", [
    (dict(n=32), "16x16"), (dict(d=36), "d = 64"),
    (dict(precond="dst_trunc", modes=64), "jacobi preconditioner"),
    (dict(warm=True, precond="dst_trunc", modes=64), "dst preconditioner"),
    (dict(warm=True, precond="jacobi"), "dst preconditioner"),
    (dict(precond="dst"), "jacobi preconditioner"),
    (dict(solver="richardson"), "CG"),
    (dict(block_chains=0), "block_chains 0"),
])
def test_warp_geometry_refuses_what_the_kernel_does_not_take(kw, why):
    block = kw.pop("block_chains", 256)
    with pytest.raises(ValueError, match=why):
        fused_mala.warp_geometry(64, block, **kw)


@pytest.mark.parametrize("warm, smem", [(False, 274_432), (True, 387_712)])
def test_warp_geometry_refuses_shared_memory_over_the_limit(monkeypatch, warm, smem):
    """32 warps a CTA would need more shared memory than a CTA may have."""
    monkeypatch.setattr(fused_mala, "WARP_CHAINS", 32)
    with pytest.raises(ValueError, match=f"{smem} bytes of shared memory"):
        fused_mala.warp_geometry(4096, 256, warm=warm)


def test_card_entry_points_refuse_before_any_launch():
    """The launch calls the takes-rule first: a misfit on a 20×20 grid, which
    no MALA kernel takes, raises its ValueError before any misfit or sampler
    kernel runs (here on CPU tensors, which the launch never gets further
    with); darcy_da_fused's 16×16 dst_trunc misfit, which the one-chain-a-CTA
    kernel takes, passes the rule."""
    from ip_mcmc_tpu_torch.convert import darcy_misfit_from_arrays
    from ip_mcmc_tpu_torch.models import darcy

    p = configs.build("darcy_da_fused", "cpu")
    aux = darcy.darcy_aux(n_grid=20, n_modes_per_dim=8, alpha=2.0, field_scale=10.0)
    pot = darcy_misfit_from_arrays(aux, np.zeros(16, np.float32), 0.01, cg_iters=2)
    with pytest.raises(ValueError, match="MALA kernels take"):
        fused_mala._launch(pot, torch.zeros(16, 64), p.prior.mean, p.prior.scale, 0.01, 0, 1,
                           16)
    assert fused_mala.route(False, **p.batched_potential_fn.spec_fields, d=64) == "cta"


# --- the orders of the sums ---------------------------------------------------


def _f32(x):
    return np.float32(x)


def _warp_sum(v):
    """warp_sum (block_reduce.cuh) on 32 lanes' f32 values: the butterfly
    v += shfl_xor(v, o) for o = 16, 8, 4, 2, 1; every lane's result."""
    v = v.astype(np.float32)
    for o in (16, 8, 4, 2, 1):
        v = (v + v[np.arange(32) ^ o]).astype(np.float32)
    return v


def _block_sum(threads):
    """block_sum over a CTA of 256 threads: each warp's warp_sum, then
    0 + warp 0 + ... + warp 7 in order."""
    total = np.float32(0.0)
    for w in range(8):
        total = np.float32(total + _warp_sum(threads[32 * w:32 * w + 32])[0])
    return total


def _slice_level_sum(cells):
    """WarpSliceLevel::sum (darcy_misfit.cuh) on a warp whose lane l holds
    cells 32 (l // 4) + l % 4 + 4 k, k = 0..7: three in-lane levels, two
    shuffle levels, then the eight slice sums from lanes 4 c in order.
    Returns every lane's result."""
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
def test_sum_of_log_a_adds_in_block_sums_order(seed):
    """a_bar's Σ log a on the warp (WarpSliceLevel::sum, no products) gives
    the bits of block_sum over the parent's 256 threads, in every lane."""
    rng = np.random.default_rng(seed)
    log_a = (rng.standard_normal(256) * 10.0 ** rng.uniform(-3, 3, 256)).astype(np.float32)
    got = _slice_level_sum(log_a)
    assert np.all(got == got[0]) and got[0] == _block_sum(log_a)


def _sum64(v0, v1):
    """MalaWarpStep::sum64: 0 + warp_sum(coordinates 0..31) + warp_sum(32..63)."""
    return _f32(_f32(_f32(0.0) + _warp_sum(v0)[0]) + _warp_sum(v1)[0])


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_prior_and_proposal_sums_add_in_block_sums_order(seed):
    """½Σz², Σd_rev² and Σξ² on the warp, lane l holding coordinates l and
    l + 32, give the bits of block_sum over the parent's 256 threads, of
    which threads t < 64 held coordinate t and the rest 0."""
    rng = np.random.default_rng(seed)
    z = (rng.standard_normal(64) * 10.0 ** rng.uniform(-4, 4, 64)).astype(np.float32)
    sq = (z * z).astype(np.float32)
    threads = np.zeros(256, np.float32)
    threads[:64] = sq
    assert _sum64(sq[:32], sq[32:]) == _block_sum(threads)


def _pad(c):
    """WarpSliceLevel::pad: cell c's place in a slice of shared memory."""
    return c + 4 * (c // 32)


def _grad_parent(basis, w):
    """The one-chain-a-CTA kernel's g (darcy_value_and_grad): a warp a mode,
    lane L adding cells L, L + 32, ..., L + 224 in order, then a warp_sum;
    lane 0's value."""
    part = np.zeros((64, 32), np.float32)
    for j in range(8):
        part = (part + basis[:, 32 * j:32 * j + 32] * w[32 * j:32 * j + 32]).astype(np.float32)
    return np.array([_warp_sum(part[k])[0] for k in range(64)], np.float32)


def _grad_warp(basis, w):
    """darcy_value_and_grad_warp's g: the basis staged as 64 rows of a slice
    (288 floats) and w in a slice, the pads NaN; lane L reads w[36 j + L]
    and basis[m, 36 j + L], j = 0..7, and adds them in order; then per 32
    modes the reduce-and-scatter (scatter_level): level O = 16, 8, 4, 2, 1
    keeps in lane L the modes of its half (v[e + O] when bit O of L is set)
    plus lane L ^ O's sums of them; lane L ends with mode L."""
    staged = np.full((64, 288), np.nan, np.float32)
    slice_w = np.full(288, np.nan, np.float32)
    cells = np.arange(256)
    staged[:, _pad(cells)] = basis
    slice_w[_pad(cells)] = w
    lanes = np.arange(32)
    part = np.zeros((64, 32), np.float32)
    for j in range(8):
        part = (part + staged[:, 36 * j + lanes] * slice_w[36 * j + lanes]).astype(np.float32)
    g = np.zeros(64, np.float32)
    for hb in range(2):
        v = [part[32 * hb:32 * hb + 32, lane].copy() for lane in range(32)]  # v[lane][mode]
        for o in (16, 8, 4, 2, 1):
            nxt = []
            for lane in range(32):
                keep = v[lane][o:2 * o] if lane & o else v[lane][:o]
                other = v[lane ^ o]
                send = other[:o] if (lane ^ o) & o else other[o:2 * o]
                nxt.append((keep + send).astype(np.float32))
            v = nxt
        for lane in range(32):
            g[32 * hb + lane] = v[lane][0]
    return g


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gradient_product_orders_give_the_parents_bits(seed):
    """g = basis (a (-dPhi/da)) from the warp's padded slices, reduced and
    scattered over the warp, gives the bits of the parent's order (a warp a
    mode, lane-strided cells, a warp_sum), and an order that adds each
    mode's cells in sequence gives others."""
    rng = np.random.default_rng(seed)
    basis = (rng.standard_normal((64, 256)) * 10.0 ** rng.uniform(-2, 2, (64, 256))).astype(
        np.float32)
    w = (rng.standard_normal(256) * 10.0 ** rng.uniform(-3, 3, 256)).astype(np.float32)
    parent = _grad_parent(basis, w)
    assert np.array_equal(_grad_warp(basis, w), parent)
    seq = np.zeros(64, np.float32)
    for c in range(256):
        seq = (seq + basis[:, c] * w[c]).astype(np.float32)
    assert not np.array_equal(seq, parent)


def _bf16(x):
    return torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16).float().numpy()


def _dot16(a, b):
    """16 terms q = 0..15 in sequence, f32."""
    acc = np.float32(0.0)
    for q in range(16):
        acc = np.float32(acc + np.float32(a[q] * b[q]))
    return acc


def _apply_dst_parent(S, lam, a_bar, r):
    """apply_dst (darcy_misfit.cuh) per output cell, as the one-chain-a-CTA
    kernel's thread of cell (i, j) computes it: four stages, the inputs of
    each rounded to bf16."""
    x = _bf16(r.reshape(16, 16))
    y = _bf16([[_dot16(S[j], x[i]) for j in range(16)] for i in range(16)])
    rt = _bf16([[np.float32(_dot16(S[i], y[:, j]) / np.float32(lam[16 * i + j] * a_bar))
                 for j in range(16)] for i in range(16)])
    w = _bf16([[_dot16(S[:, i], rt[:, j]) for j in range(16)] for i in range(16)])
    return np.array([[_dot16(S[:, j], w[i]) for j in range(16)] for i in range(16)],
                    np.float32).reshape(-1)


def _apply_dst_warp(S, lam, a_bar, r):
    """WarpDstSliceLevel::precond as the warp runs it: lane l computes the
    cells (i0 + h, j0 + 4 m), i0 = 2 (l // 4), j0 = l % 4, from rows of bf16
    buffers of 24 elements (the column stages' inputs stored transposed,
    S^T staged beside S), each output's 16 terms in two halves of 8."""
    kr = 24

    def buf():
        return np.full(16 * kr, np.nan, np.float32)

    def row(b, i):
        return b[kr * i:kr * i + 16]

    Sb, Stb = buf(), buf()
    for j in range(16):
        Sb[kr * j:kr * j + 16] = S[j]
        Stb[kr * j:kr * j + 16] = S[:, j]
    q, y = buf(), buf()
    z = np.zeros(256, np.float32)
    for ln in range(32):  # stage 0: each lane its own cells
        i0, j0 = 2 * (ln // 4), ln % 4
        for h in range(2):
            for m in range(4):
                q[kr * (i0 + h) + j0 + 4 * m] = _bf16(r[16 * (i0 + h) + j0 + 4 * m])

    def stage(A, B, f):
        for ln in range(32):
            i0, j0 = 2 * (ln // 4), ln % 4
            for h in range(2):
                for m in range(4):
                    f(i0, j0, h, m, _dot16(row(A, i0 + h), row(B, j0 + 4 * m)))

    stage(q, Sb, lambda i0, j0, h, m, v: y.__setitem__(kr * (j0 + 4 * m) + i0 + h, _bf16(v)))
    stage(Sb, y, lambda i0, j0, h, m, v: q.__setitem__(
        kr * (j0 + 4 * m) + i0 + h,
        _bf16(np.float32(v / np.float32(lam[16 * (i0 + h) + j0 + 4 * m] * a_bar)))))
    stage(Stb, q, lambda i0, j0, h, m, v: y.__setitem__(kr * (i0 + h) + j0 + 4 * m, _bf16(v)))
    stage(y, Stb, lambda i0, j0, h, m, v: z.__setitem__(16 * (i0 + h) + j0 + 4 * m, v))
    return z


@pytest.mark.parametrize("seed", [0, 1])
def test_warp_dst_apply_gives_apply_dsts_bits(seed):
    """The warp's dense dst apply (transposed bf16 buffers, rows of 24, the
    lane's 2 × 4 cells) gives apply_dst's per-cell bits on the config's S
    and λ, with the four bf16 roundings in sequence; within bf16 rounding
    of the misfit's plain preconditioner."""
    p = configs.build("darcy_mala_warm", "cpu")
    pag = p.batched_warm_potential[0]
    S = pag.S.float().numpy()
    lam = pag.lam.numpy()
    rng = np.random.default_rng(seed)
    r = (rng.standard_normal(256) * 10.0 ** rng.uniform(-2, 2, 256)).astype(np.float32)
    a_bar = np.float32(np.exp(rng.uniform(-1, 1)))
    got = _apply_dst_warp(S, lam, a_bar, r)
    assert np.array_equal(got, _apply_dst_parent(S, lam, a_bar, r))
    plain = pag._precond_dst(torch.from_numpy(r)[:, None], torch.tensor([a_bar]))[:, 0].numpy()
    assert np.abs(got - plain).max() <= 2e-2 * np.abs(plain).max()


# --- the plain twins and the names --------------------------------------------


@pytest.mark.parametrize("warm", [False, True])
def test_mala_twin_on_a_ragged_width_gives_the_first_chains(warm):
    """The MALA twin on 13 chains in blocks of 8 (two CTAs of 8 warps on the
    card, 3 of them spare) gives the first 13 chains of the 16-chain run: a
    chain's draws depend on its block and lane alone."""
    p = configs.build("darcy_mala_warm", "cpu")
    if warm:
        pot, aux_dim = p.batched_warm_potential
        plain, kw = pot._forward_warm_plain, {"aux_dim": aux_dim, "thin": 1}
    else:
        plain, kw = p.batched_potential_fn._forward_plain, {"thin": 1}
    pos = p.init_positions(torch.Generator().manual_seed(33), 16)
    args = (p.prior.mean, p.prior.scale, p.kernel_params["step_size"], 9, 2, 8)
    ref = fused_mala._run_plain(plain, pos, *args, **kw)
    got = fused_mala._run_plain(plain, pos[:13], *args, **kw)
    assert (got[0] - ref[0][:13]).abs().max() <= 1e-5
    assert torch.equal(got[1], ref[1][:13])
    assert (got[2] - ref[2][:, :13]).abs().max() <= 1e-5


def test_kernel_names():
    """The launch counts' names of the cold and the warm instantiation,
    plain and recorded."""
    assert _scaffold.kernel_name(fused_mala.stem(False), False) == (
        "fused_mala_warp_kernel[jacobi]<false>")
    assert _scaffold.kernel_name(fused_mala.stem(True), True) == (
        "fused_mala_warp_kernel[dst]<true>")
