"""pCN one chain a warp (``fused_pcn_warp_kernel<RECORD, PRECOND>``): which
specs the card sends to it and which to the one-chain-a-CTA kernels, its
launch geometry's Python mirror (``ops/fused_pcn.py`` ``warp_geometry``;
chip_smoke.py holds it against the C function), the plain twins on a
ragged width and on the warp kernel's specs against JAX, and the kernel
names. The warm kernel runs the dst_trunc products on the tensor cores;
its alternative on the warp's CUDA cores, which ``scripts/
measure_pcn_warp_design.py`` times, adds them in the one-chain-a-CTA
kernel's order: a NumPy mirror of that order against the parent's, and its
staged V's banks."""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ip_mcmc_tpu import ops as jops
from ip_mcmc_tpu.models import darcy as jdarcy
from ip_mcmc_tpu_torch import configs
from ip_mcmc_tpu_torch.convert import darcy_misfit_from_arrays, darcy_warm_misfit_from_arrays
from ip_mcmc_tpu_torch.models import darcy
from ip_mcmc_tpu_torch.ops import _scaffold, fused_pcn

torch.set_num_threads(1)

# the cells in shared memory, padded by 4 after every 32 (8 × 36 floats)
CELLS = 288
BASIS = 4 * 64 * CELLS  # the staged KL basis: 64 modes, f32
SLICE = 4 * (2 * 64 + 3 * CELLS)  # a warp's: pos, prop; p, th, tv
# warm: the CTA's exchange of the dst_trunc products, 16 rows (chains) of
# bf16(r) and the bf16 coefficients (264 bf16 each), the back products
# (260 f32) and a_bar; then V staged, a row of 264 bf16 a mode
XCHG = 16 * (2 * (264 + 264) + 4 * (260 + 1))


def v_rows(modes):
    return 2 * 264 * modes
DESIGN_SCRIPT = pathlib.Path(__file__).resolve().parent.parent / "scripts" / (
    "measure_pcn_warp_design.py")


@pytest.mark.parametrize("n, block, ctas, w", [
    (4096, 512, 256, 16),  # darcy_pcn_4096
    (4096, 256, 256, 16),  # darcy_pcn_warm
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
    staged = XCHG + v_rows(64) if warm else 0
    assert fused_pcn.warp_geometry(n, block, warm=warm) == (ctas, w, BASIS + staged + w * SLICE)


@pytest.mark.parametrize("config, warm, smem", [
    ("darcy_pcn_4096", False, 137_216), ("darcy_pcn_warm", True, 204_608)])
def test_warp_geometry_of_the_shipped_configs(config, warm, smem):
    """The two CLI paths' launches: 4096 chains, blocks of 512 (the runner's
    default) and of 256, 16 chains a CTA, one CTA an SM by shared memory."""
    p = configs.build(config, "cpu")
    pot = p.batched_warm_potential[0] if warm else p.batched_potential_fn
    block = p.kernel_params.get("block_chains", 512)
    got = fused_pcn.warp_geometry(p.n_chains, block, warm=warm, n=pot.n, d=p.dim,
                                  precond=pot.precond, modes=pot.modes, solver=pot.solver)
    assert got == (256, 16, smem) and smem <= fused_pcn.MAX_SMEM_BYTES
    assert (fused_pcn.BASIS_BYTES, fused_pcn.XCHG_BYTES, fused_pcn.WARP_SLICE_BYTES) == (
        BASIS, XCHG, SLICE)


@pytest.mark.parametrize("modes, smem", [(16, 179_264), (64, 204_608), (112, 229_952)])
def test_warp_geometry_by_modes(modes, smem):
    """The warm kernel stages V, a row a mode (a multiple of 16): 112 modes
    are the most whose rows fit beside the basis, the exchange and 16
    warps' slices; 128 would need 238,400 bytes."""
    assert fused_pcn.warp_geometry(4096, 256, warm=True, modes=modes) == (256, 16, smem)
    assert smem == BASIS + XCHG + v_rows(modes) + 16 * SLICE <= fused_pcn.MAX_SMEM_BYTES
    assert BASIS + XCHG + v_rows(128) + 16 * SLICE == 238_400 > fused_pcn.MAX_SMEM_BYTES


@pytest.mark.parametrize("kw, why", [
    (dict(n=32), "16x16"), (dict(n=8), "16x16"), (dict(d=36), "d = 64"),
    (dict(precond="dst_trunc", modes=64), "Jacobi"),
    (dict(warm=True, precond="jacobi", modes=0), "dst_trunc"),
    (dict(warm=True, precond="dst", modes=0), "dst_trunc"),
    (dict(warm=True, modes=40), "a multiple of 16 modes up to 112"),
    (dict(warm=True, modes=128), "a multiple of 16 modes up to 112"),
    (dict(warm=True, modes=0), "a multiple of 16 modes up to 112"),
    (dict(solver="richardson"), "CG"),
    (dict(block_chains=0), "block_chains 0"),
])
def test_warp_geometry_refuses_what_the_kernel_does_not_take(kw, why):
    block = kw.pop("block_chains", 256)
    with pytest.raises(ValueError, match=why):
        fused_pcn.warp_geometry(64, block, **kw)


def test_warp_geometry_refuses_shared_memory_over_the_limit(monkeypatch):
    """32 warps a CTA would need more shared memory than a CTA may have."""
    monkeypatch.setattr(fused_pcn, "WARP_CHAINS", 32)
    with pytest.raises(ValueError, match="bytes of shared memory"):
        fused_pcn.warp_geometry(4096, 256, warm=True)


# --- which kernel the card runs -------------------------------------------------


def _misfit(n, warm, precond, modes=128, cg_iters=4):
    aux = darcy.darcy_aux(n_grid=n, n_modes_per_dim=8, alpha=2.0, field_scale=10.0)
    y = np.zeros(len(aux["obs_indices"]), np.float32)
    make = darcy_warm_misfit_from_arrays if warm else darcy_misfit_from_arrays
    pot = make(aux, y, 0.002, cg_iters=cg_iters, precond=precond, precond_modes=modes)
    return pot[0] if warm else pot


@pytest.mark.parametrize("which, warm, d, stem", [
    ("darcy_pcn_4096", False, 64, "fused_pcn_warp_kernel[jacobi]"),
    ("darcy_pcn_warm", True, 64, "fused_pcn_warp_kernel[dst_trunc]"),
    ((16, "dst_trunc", 112), True, 64, "fused_pcn_warp_kernel[dst_trunc]"),
    ((16, "dst_trunc", 128), True, 64, "fused_pcn_warm_kernel"),  # more rows than fit
    ((16, "dst_trunc", 40), True, 64, "fused_pcn_warm_kernel"),  # not whole mma tiles
    ((16, "jacobi", 0), True, 64, "fused_pcn_warm_kernel"),
    ((16, "dst", 0), True, 64, "fused_pcn_warm_kernel"),
    ((16, "dst_trunc", 128), False, 64, "fused_pcn_kernel"),  # cold dst_trunc
    ((16, "jacobi", 0), False, 32, "fused_pcn_kernel"),  # another d
    ((8, "jacobi", 0), False, 64, "fused_pcn_kernel"),  # a grid below 16²
    ((8, "dst_trunc", 64), True, 64, "fused_pcn_warm_kernel"),
    ("darcy32_pcn_warm", True, 64, "fused_pcn_warm_cluster32_kernel"),
    ("darcy64_pcn_warm", True, 144, "fused_pcn_warm_cluster_kernel"),
])
def test_darcy_stem_names_the_kernel_the_spec_picks(which, warm, d, stem):
    """The warp kernel takes 16², d = K = 64, Jacobi cold and dst_trunc of a
    multiple of 16 modes up to 112 warm; every other spec stays on the
    kernel that took it before (no spec is refused for the warp kernel's
    sake)."""
    if isinstance(which, str):
        p = configs.build(which, "cpu")
        pot = p.batched_warm_potential[0] if warm else p.batched_potential_fn
    else:
        n, precond, modes = which
        pot = _misfit(n, warm, precond, modes)
    assert fused_pcn._darcy_stem(pot, warm, d) == stem
    takes = fused_pcn.warp_takes(warm, n=pot.n, d=d, precond=pot.precond, modes=pot.modes,
                                 solver=pot.solver)
    assert takes == stem.startswith(fused_pcn.KERNEL)


# --- the alternative's order of the dst_trunc products ---------------------------


def _bf16(x):
    return torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16).float().numpy()


def _warp_sum(v):
    """warp_sum (block_reduce.cuh) on 32 lanes' f32 values: the butterfly
    v += shfl_xor(v, o) for o = 16, 8, 4, 2, 1; every lane's result."""
    v = v.astype(np.float32)
    for o in (16, 8, 4, 2, 1):
        v = (v + v[np.arange(32) ^ o]).astype(np.float32)
    return v


def _pad(c):
    """WarpSliceLevel::pad: cell c's place in a slice of shared memory."""
    return c + 4 * (c // 32)


def _trunc_parent(V, lam, a_bar, r, inv_diag):
    """apply_precond's dst_trunc (darcy_misfit.cuh) as the one-chain-a-CTA
    kernel runs it: a warp a mode, lane L adding the products of cells L,
    L + 32, ..., L + 224 in order, then a warp_sum, lane 0's value over
    lam a_bar rounded to bf16; each cell's thread adding its back product
    over the modes in order to D⁻¹r."""
    rb = _bf16(r)
    part = np.zeros((V.shape[0], 32), np.float32)
    for j in range(8):
        part = (part + V[:, 32 * j:32 * j + 32] * rb[32 * j:32 * j + 32]).astype(np.float32)
    coef = _bf16([np.float32(_warp_sum(part[m])[0] / np.float32(lam[m] * a_bar))
                  for m in range(V.shape[0])])
    back = np.zeros(256, np.float32)
    for m in range(V.shape[0]):
        back = (back + V[m] * coef[m]).astype(np.float32)
    return (np.float32(inv_diag * r).astype(np.float32) + back).astype(np.float32)


def _trunc_warp(V, lam, a_bar, r, inv_diag):
    """The design script's alternative (its ``ON_THE_WARP`` level) as the
    warp runs it: V staged transposed
    (lane L's column of mode m at L·row + 8 m, row = 8 M + 8 for M modes
    rounded up to 32s, the padding modes zero with λ 1, the pads NaN);
    bf16(r) in the padded slice, lane L reading its column's cells L + 32 j;
    the partials of modes e and e + 16 of each 32 reduced a first level as
    they come (lane L keeps its half's, plus lane L ^ 16's), then levels 8,
    4, 2, 1 of the reduce and scatter; lane L's mode over λ a_bar rounded to
    bf16; lane L's back products of cells L + 32 j over the M modes in order,
    handed to the owners through the slice."""
    modes = V.shape[0]
    M = -(-modes // 32) * 32
    row = 8 * M + 8
    Vs = np.full(32 * row, np.nan, np.float32)
    lam_s = np.ones(M, np.float32)
    lam_s[:modes] = lam
    for m in range(M):
        for c in range(256):
            Vs[(c % 32) * row + 8 * m + c // 32] = V[m, c] if m < modes else 0.0
    p = np.full(CELLS, np.nan, np.float32)
    p[_pad(np.arange(256))] = _bf16(r)
    lanes = np.arange(32)
    b = np.stack([p[36 * j + lanes] for j in range(8)], axis=1)  # (lane, j)

    def partial(m):
        acc = np.zeros(32, np.float32)
        for j in range(8):
            acc = (acc + Vs[lanes * row + 8 * m + j] * b[:, j]).astype(np.float32)
        return acc

    coef = np.zeros(M, np.float32)
    upper = (lanes & 16) != 0
    for g in range(M // 32):
        v = np.zeros((32, 16), np.float32)  # v[lane][e]
        for e in range(16):
            lo, hi = partial(32 * g + e), partial(32 * g + e + 16)
            send = np.where(upper, lo, hi)
            v[:, e] = (np.where(upper, hi, lo) + send[lanes ^ 16]).astype(np.float32)
        for o in (8, 4, 2, 1):
            up = ((lanes & o) != 0)[:, None]
            keep = np.where(up, v[:, o:2 * o], v[:, :o])
            send = np.where(up, v[:, :o], v[:, o:2 * o])
            v[:, :o] = (keep + send[lanes ^ o]).astype(np.float32)
        m = 32 * g + lanes
        coef[m] = _bf16((v[:, 0] / (lam_s[m] * np.float32(a_bar)).astype(np.float32)).astype(
            np.float32))
    acc = np.zeros((32, 8), np.float32)
    for m in range(M):
        cols = Vs[lanes[:, None] * row + 8 * m + np.arange(8)]
        acc = (acc + cols * coef[m]).astype(np.float32)
    p[36 * np.arange(8)[None, :] + lanes[:, None]] = acc
    return (np.float32(inv_diag * r).astype(np.float32)
            + p[_pad(np.arange(256))]).astype(np.float32)


@pytest.mark.parametrize("modes", [64, 40, 128])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_trunc_products_on_the_warp_give_apply_preconds_bits(seed, modes):
    """The dst_trunc apply on the warp's CUDA cores (lane partials over
    l + 32 j from the padded slice, reduced and scattered in warp_sum's
    pairs, back products over the modes in order) gives apply_precond's
    bits on the config's bf16 modes and λ; within bf16 rounding of the
    misfit's plain preconditioner. 40 modes run as 64, the padding modes
    adding zeros. The mirror follows the design script's alternative, whose
    layout expressions it checks are there."""
    text = DESIGN_SCRIPT.read_text()
    for expr in ("256 * groups + 8", "(c & 31) * row + 8 * m + (c >> 5)", "rb[36 * j + l]",
                 "(upper ? hi : lo) + __shfl_xor_sync(0xffffffffu, upper ? lo : hi, 16)"):
        assert expr in text, expr
    pot = _misfit(16, True, "dst_trunc", modes)
    V, lam = pot.V.float().numpy(), pot.lam.numpy()
    assert V.shape == (modes, 256)
    rng = np.random.default_rng(seed)
    r = (rng.standard_normal(256) * 10.0 ** rng.uniform(-2, 2, 256)).astype(np.float32)
    inv_diag = (10.0 ** rng.uniform(-4, -2, 256)).astype(np.float32)
    a_bar = np.float32(np.exp(rng.uniform(-1, 1)))
    got = _trunc_warp(V, lam, a_bar, r, inv_diag)
    assert np.array_equal(got, _trunc_parent(V, lam, a_bar, r, inv_diag))
    plain = pot._precond(torch.from_numpy(r)[:, None], torch.from_numpy(inv_diag)[:, None],
                         torch.tensor([a_bar]))[:, 0].numpy()
    assert np.abs(got - plain).max() <= 2e-2 * np.abs(plain).max()


@pytest.mark.parametrize("modes", [32, 64, 96, 128])
def test_staged_v_layout_is_free_of_bank_conflicts(modes):
    """The alternative's staged V: lane l's 16-byte load of its column of
    mode m, at l (16 M + 16) + 16 m bytes: the eight lanes of each quarter
    warp (a 16-byte load's phase) fall in distinct groups of four banks.
    bf16(r) and the back products at 36 j + l: 32 distinct banks."""
    lanes = np.arange(32)
    for m in (0, 1, modes - 1):
        words = (lanes * (16 * modes + 16) + 16 * m) // 4
        for q in range(4):
            assert len(set((words[8 * q:8 * q + 8] // 4) % 8)) == 8
    for j in range(8):
        assert len(set((36 * j + lanes) % 32)) == 32


# --- the plain twins and the names --------------------------------------------


@pytest.mark.parametrize("warm", [False, True])
def test_pcn_twin_on_a_ragged_width_gives_the_first_chains(warm):
    """The pCN twin on 13 chains in blocks of 8 (two CTAs of 8 warps on the
    card, 3 of them spare) gives the first 13 chains of the 16-chain run: a
    chain's draws depend on its block and lane alone."""
    p = configs.build("darcy_pcn_warm", "cpu")
    if warm:
        pot, aux_dim = p.batched_warm_potential
        plain, kw = pot._forward_warm_plain, {"aux_dim": aux_dim, "thin": 1}
    else:
        plain, kw = p.batched_potential_fn._forward_plain, {"thin": 1}
    pos = p.init_positions(torch.Generator().manual_seed(35), 16)
    args = (p.prior.mean, p.prior.scale, 0.08, 9, 2, 8)
    ref = fused_pcn._run_plain(plain, pos, *args, **kw)
    got = fused_pcn._run_plain(plain, pos[:13], *args, **kw)
    assert (got[0] - ref[0][:13]).abs().max() <= 1e-5
    assert torch.equal(got[1], ref[1][:13])
    assert (got[2] - ref[2][:, :13]).abs().max() <= 1e-5


@pytest.mark.parametrize("warm", [False, True])
def test_twin_on_the_warp_kernels_specs_matches_jax(warm):
    """On the specs the warp kernel takes (16², d = 64; Jacobi / 48 CG
    cold, dst_trunc-64 / 4 CG warm, as darcy_pcn_4096 and darcy_pcn_warm),
    the same numpy-drawn positions through the JAX Pallas kernel (interpret
    mode) and the port's twin: 16 chains, 3 steps, blocks of 8. bf16 factors
    can flip an MH decision, so: at least 15 chains within 1e-4, mean
    acceptance within 0.05."""
    _, aux_j = jdarcy.make_darcy_forward(n_grid=16, n_modes_per_dim=8, alpha=2.0,
                                         field_scale=10.0)
    aux_t = darcy.darcy_aux(n_grid=16, n_modes_per_dim=8, alpha=2.0, field_scale=10.0)
    y = np.asarray(configs.build("darcy_pcn_warm", "cpu").data, np.float32)
    pos = (0.3 * np.random.default_rng(37).standard_normal((16, 64))).astype(np.float32)
    pm, ps = np.zeros(64, np.float32), np.ones(64, np.float32)
    common = dict(n_steps=3, block_chains=8)
    if warm:
        kw = dict(cg_iters=4, precond="dst_trunc", precond_modes=64)
        pot_j, aux_dim = jdarcy.make_batched_misfit_warm(aux_j, y, 0.002, **kw)
        pot_t, _ = darcy_warm_misfit_from_arrays(aux_t, y, 0.002, **kw)
        out_j = jops.fused_pcn_chain_warm(pot_j, jnp.asarray(pos), pm, ps, 0.08, 5,
                                          aux_dim=aux_dim, **common)
        out_t = fused_pcn.fused_pcn_chain_warm(pot_t, torch.from_numpy(pos), pm, ps, 0.08, 5,
                                               aux_dim=aux_dim, **common)
    else:
        pot_j = jdarcy.make_batched_misfit(aux_j, y, 0.002, cg_iters=48)
        pot_t = darcy_misfit_from_arrays(aux_t, y, 0.002, cg_iters=48)
        out_j = jops.fused_pcn_chain(pot_j, jnp.asarray(pos), pm, ps, 0.08, 5, **common)
        out_t = fused_pcn.fused_pcn_chain(pot_t, torch.from_numpy(pos), pm, ps, 0.08, 5,
                                          **common)
    assert fused_pcn.warp_takes(warm, n=pot_t.n, d=64, precond=pot_t.precond,
                                modes=pot_t.modes, solver=pot_t.solver)
    dev = np.abs(np.asarray(out_j[0]) - out_t[0].numpy()).max(axis=1)
    assert (dev <= 1e-4).sum() >= 15
    assert abs(float(np.asarray(out_j[1]).mean()) - float(out_t[1].mean())) <= 0.05
    assert 0.0 < float(out_t[1].mean()) < 1.0


def test_kernel_names():
    """The launch counts' names of the cold and the warm instantiation,
    plain and recorded."""
    assert _scaffold.kernel_name(fused_pcn.stem(False), False) == (
        "fused_pcn_warp_kernel[jacobi]<false>")
    assert _scaffold.kernel_name(fused_pcn.stem(True), True) == (
        "fused_pcn_warp_kernel[dst_trunc]<true>")
