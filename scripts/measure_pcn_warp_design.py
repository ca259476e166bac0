"""The design of the 16x16 pCN kernel, one chain a warp, on one card: chains
a CTA, where the warm kernel reads the dst_trunc modes V from, and whether
its preconditioner's products run on the tensor cores or on the warp.

    python scripts/measure_pcn_warp_design.py

``fused_pcn_warp_kernel<RECORD, PRECOND>`` (``csrc/fused_pcn.cu``) takes W
and its launch bound from one line, ``PcnWarpDesign``: ``kWarps`` chains a
CTA at most (W), ``kSmWarps`` warps an SM for the launch bound. The warm
kernel's dst_trunc apply (``WarpTruncSliceLevel`` in
``csrc/darcy_misfit.cuh``) runs both products over the CTA's chains by bf16
``mma.sync``, V staged in shared memory once a CTA (rows of 264 bf16, read
by ``ldmatrix``), three CTA barriers an apply. The alternatives here:

- W 8 (``PcnWarpDesign``);
- V read through L2 (``load_a_v<false>``), as the 16x16 DA kernel reads its
  exact level's;
- both products on the warp's CUDA cores in the one-chain-a-CTA kernel's
  order: V staged once a CTA, transposed (lane L's
  column of the cells L + 32 j of a mode is one 16-byte load, a column's
  stride 8 M + 8 bf16 for M modes rounded up to 32s, so the eight lanes of
  a load phase fall in distinct banks), lane L's partials of every mode
  over its column from bf16(r) in the warp's padded slice, each 32 modes'
  partials reduced and scattered over the warp in the pairs of
  ``warp_sum``'s butterfly (the first level as the partials come), lane L
  keeping mode L of each 32 in a slice of the warp's coefficients; then
  lane L's back products of its column's cells over the modes in order,
  handed to the owners through the slice p. No CTA barrier.

This builds ``fused_pcn.cu`` once for each alternative with that line (or
that code) patched, all compilers started together; prints the registers
and spills that ptxas reports for the cold and the warm kernel; and times
one step of ``darcy_pcn_4096 --fused`` (Jacobi / 48 CG, blocks of 512) and
of ``darcy_pcn_warm`` (dst_trunc-64 / 4 CG from the carried solution,
blocks of 256), 4096 chains, under each, as the slope between two launch
lengths, in the order shipped, alternatives, shipped. Every design runs the
same chains from the same start and seed; beside each time, whether its
chains (8 steps, final state and records) equal the shipped design's bit
for bit, and the share within 1e-4 of the plain twin's (chip_smoke.py's
tolerance: the tensor cores add in another order than the CUDA cores).
Prints the card's name and power limit and one JSON line.
"""

from __future__ import annotations

import json
import pathlib
import re
import sys

import torch

from _kernel_variants import build_patch_sets, card_line, load_with, ptxas_row, slope_ms

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

SOURCE, SOLVE = "fused_pcn.cu", "darcy_misfit.cuh"
LINE = re.compile(r"struct PcnWarpDesign \{ static constexpr int kWarps = (\d+), "
                  r"kSmWarps = (\d+); \};")
# the mangled names of <false, kPrecondJacobi> and <false, kPrecondDstTrunc>
KERNELS = {"cold": "fused_pcn_warp_kernelILb0ELi0E", "warm": "fused_pcn_warp_kernelILb0ELi1E"}
# (W, warps an SM for the launch bound)
LINES = [(16, 16), (8, 16)]
CHAIN_ATOL = 1e-4  # chip_smoke.py's

# V through L2: nothing staged but the exchange, the level's V the misfit's
# (modes, cells) rows: (text once in the level, its replacement)
V_THROUGH_L2 = [
    ("    return xchg_bytes(kRows) + sizeof(__nv_bfloat16) * modes * kVRow;\n",
     "    return xchg_bytes(kRows);\n"),
    ("    for (int e = threadIdx.x; e < s.modes * kCells; e += blockDim.x)\n"
     "      Vs[(e / kCells) * kVRow + e % kCells] = gV[e];\n"
     "    return {base, carve_xchg(staged, kRows), Vs, 1.0f};\n",
     "    return {base, carve_xchg(staged, kRows), gV, 1.0f};\n"),
    ("load_a_v<true>(a, V, kVRow, mt * 16, k0);", "load_a_v<false>(a, V, kCells, mt * 16, k0);"),
    ("load_a_vt<true>(a, V, kVRow, ct * 16, k0);", "load_a_vt<false>(a, V, kCells, ct * 16, k0);"),
]
# the products on the warp in the parent's order: the level up to its
# phi_warm, which stays, and a slice of coefficients a warp (64 modes)
LEVEL_START = "struct WarpTruncSliceLevel : WarpSliceLevel {\n"
LEVEL_KEEP = "  // Phi(u) for the chain of this warp from the lane's cells x of a previous"
COEF_SLICE = [
    ("constexpr int kPcnWarpFloats = 2 * kPcnD + 3 * WarpSliceLevel::kStride;",
     "constexpr int kPcnWarpFloats = 2 * kPcnD + 3 * WarpSliceLevel::kStride + 64;"),
    ("    lv = WarpTruncSliceLevel::make(lv0, base + WarpSliceLevel::staged_bytes());",
     "    lv = WarpTruncSliceLevel::make(lv0, base + WarpSliceLevel::staged_bytes(),\n"
     "                                   slice + 3 * kStride);"),
]
ON_THE_WARP = r"""struct WarpTruncSliceLevel : WarpSliceLevel {
  static constexpr int kPrecond = kPrecondDstTrunc;
  static constexpr int kRows = 16, kModeTile = 16, kMaxModes = 256;
  const __nv_bfloat16* V;  // staged, transposed: lane L's column of mode m at L row + 8 m
  const float* lam;        // (32 groups,) staged, 1 past the modes
  float* coef;             // the warp's (32 groups,) bf16(V bf16(r) / (lam a_bar))
  int groups;              // the modes in 32s, rounded up
  float a_bar;

  __host__ __device__ static constexpr int groups_of(int modes) { return (modes + 31) / 32; }
  __host__ __device__ static constexpr int row_of(int groups) { return 256 * groups + 8; }
  __host__ __device__ static size_t staged_bytes(int modes) {
    return sizeof(__nv_bfloat16) * 32 * row_of(groups_of(modes)) +
           sizeof(float) * 32 * groups_of(modes);
  }
  static __device__ WarpTruncSliceLevel make(const WarpSliceLevel& base, unsigned char* staged,
                                             float* extra) {
    const IpxMisfitSpec& s = *base.s;
    const int g = groups_of(s.modes), row = row_of(g);
    const __nv_bfloat16* gV = static_cast<const __nv_bfloat16*>(s.V);
    __nv_bfloat16* Vs = reinterpret_cast<__nv_bfloat16*>(staged);
    for (int e = threadIdx.x; e < 32 * g * kCells; e += blockDim.x) {
      const int m = e / kCells, c = e % kCells;
      Vs[(c & 31) * row + 8 * m + (c >> 5)] = m < s.modes ? gV[e] : __float2bfloat16(0.0f);
    }
    float* lb = reinterpret_cast<float*>(Vs + 32 * row);
    for (int m = threadIdx.x; m < 32 * g; m += blockDim.x) lb[m] = m < s.modes ? s.lam[m] : 1.0f;
    return {base, Vs, lb, extra, g, 1.0f};
  }

  // V[m][l + 32 j], j = 0..7: the lane's column of mode m
  __device__ __forceinline__ void column(int m, float (&v)[8]) const {
    unpack_bf16x8(*reinterpret_cast<const uint4*>(V + (threadIdx.x & 31) * row_of(groups) + 8 * m),
                  v);
  }
  __device__ __forceinline__ float partial(int m, const float (&b)[8]) const {
    float v[8];
    column(m, v);
    float acc = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc += v[j] * b[j];
    return acc;
  }
  template <int O>
  static __device__ __forceinline__ void scatter16(float (&v)[16]) {
    const bool upper = (threadIdx.x & O) != 0;
#pragma unroll
    for (int e = 0; e < O; ++e) {
      const float keep = upper ? v[e + O] : v[e];
      const float send = upper ? v[e] : v[e + O];
      v[e] = keep + __shfl_xor_sync(0xffffffffu, send, O);
    }
  }

  __device__ void precond(const float (&r)[kC], const float (&inv_diag)[kC],
                          float (&z)[kC]) const {
    const int l = threadIdx.x & 31;
    float* const rb = ws.p;
    __builtin_assume(__isShared(V) && __isShared(lam) && __isShared(coef) && __isShared(rb));
#pragma unroll
    for (int k = 0; k < kC; ++k) {
      z[k] = __fmul_rn(inv_diag[k], r[k]);
      rb[at(k)] = bf16_round(r[k]);
    }
    __syncwarp();
    float b[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) b[j] = rb[36 * j + l];
    const bool upper = (l & 16) != 0;
    for (int g = 0; g < groups; ++g) {
      float v[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const float lo = partial(32 * g + e, b), hi = partial(32 * g + e + 16, b);
        v[e] = (upper ? hi : lo) + __shfl_xor_sync(0xffffffffu, upper ? lo : hi, 16);
      }
      scatter16<8>(v);
      scatter16<4>(v);
      scatter16<2>(v);
      scatter16<1>(v);
      const int m = 32 * g + l;
      coef[m] = bf16_round(v[0] / (lam[m] * a_bar));
    }
    __syncwarp();
    float acc[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] = 0.0f;
    for (int m = 0; m < 32 * groups; m += 4) {
      const float4 c4 = *reinterpret_cast<const float4*>(coef + m);
      const float cm[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float v[8];
        column(m + q, v);
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[j] += v[j] * cm[q];
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) rb[36 * j + l] = acc[j];
    __syncwarp();
#pragma unroll
    for (int k = 0; k < kC; ++k) z[k] = z[k] + rb[at(k)];
    __syncwarp();
  }

"""


def design_line(w, sm_warps) -> str:
    return (f"struct PcnWarpDesign {{ static constexpr int kWarps = {w}, kSmWarps = "
            f"{sm_warps}; }};")


def label(d) -> str:
    return f"W={d[0]}, {d[1]} warps/SM bound" + (f", {d[2]}" if len(d) > 2 else "")


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    from ip_mcmc_tpu_torch import configs
    from ip_mcmc_tpu_torch.ops import _build, fused_pcn

    card = card_line()
    print(f"card: {card}")
    shipped_lib = _build.library()
    m = LINE.search((_build.CSRC / SOURCE).read_text())
    shipped = (int(m.group(1)), int(m.group(2)))
    solve = (_build.CSRC / SOLVE).read_text()
    patches = {d: [(SOURCE, m.group(0), design_line(*d))] for d in LINES if d != shipped}
    patches[(*shipped, "V through L2")] = [(SOLVE, a, b) for a, b in V_THROUGH_L2]
    start = solve.index(LEVEL_START)
    level = solve[start:solve.index(LEVEL_KEEP, start)]
    patches[(*shipped, "products on the warp in the parent's order")] = [
        (SOLVE, level, ON_THE_WARP), *((SOURCE, a, b) for a, b in COEF_SLICE)]
    alternatives = list(patches)
    builds = build_patch_sets(_build, (SOURCE,), patches, "pcn_warp")
    rows, libs = [], {shipped: shipped_lib}
    ptxas = {shipped: {k: ptxas_row(_build.BUILD_DIR, v) for k, v in KERNELS.items()}}
    for d in alternatives:
        if isinstance(builds[d], str):
            print(f"{label(d)}: not built ({builds[d]})", flush=True)
            rows.append({"design": label(d), "refused": builds[d]})
            continue
        libs[d] = load_with(_build, builds[d][0])
        ptxas[d] = {k: ptxas_row(builds[d][1], v) for k, v in KERNELS.items()}
    for d in libs:
        print(f"({label(d)}) registers, spill stores, spill loads: cold {ptxas[d]['cold']}, "
              f"warm {ptxas[d]['warm']}", flush=True)

    cold_p, warm_p = (configs.build(c, "cuda") for c in ("darcy_pcn_4096", "darcy_pcn_warm"))
    pm, ps = warm_p.prior.mean, warm_p.prior.scale
    n = warm_p.n_chains
    pos = warm_p.init_positions(torch.Generator().manual_seed(5), n).cuda()
    jacobi = cold_p.batched_potential_fn
    warm, aux_dim = warm_p.batched_warm_potential
    cases = {"cold": (jacobi, jacobi._forward_plain, {}, 512),
             "warm": (warm, warm._forward_warm_plain, {"aux_dim": aux_dim}, 256)}

    def runner(pot, kw, block, thin=None):
        extra = dict(kw, thin=thin) if thin else kw
        return lambda steps: fused_pcn._launch(pot, pos, pm, ps, 0.08, 7, steps, block, **extra)

    twin = {kind: fused_pcn._run_plain(plain, pos, pm, ps, 0.08, 7, 8, block, thin=1, **kw)
            for kind, (_, plain, kw, block) in cases.items()}
    ref = {}
    for d in (*libs, shipped):
        _build._lib = libs[d]
        row = {"design": label(d), "ptxas": ptxas[d]}
        for kind, (pot, _, kw, block) in cases.items():
            if kind == "cold" and len(d) > 2:  # the alternatives of the warm apply
                continue
            got = runner(pot, kw, block, thin=1)(8)
            ref.setdefault(kind, got)
            equal = all(torch.equal(a, b) for a, b in zip(got, ref[kind]))
            dev = torch.maximum((got[0] - twin[kind][0]).abs().amax(dim=1),
                                (got[2] - twin[kind][2]).abs().amax(dim=(0, 2)))
            frac = float((dev <= CHAIN_ATOL).double().mean())
            ms = slope_ms(runner(pot, kw, block), 4, 36)
            row[kind] = {"ms_per_step": ms, "accept_8_steps": float(got[1].mean()),
                         "equal_to_shipped": equal, "frac_within_atol_of_twin": frac}
            print(f"{label(d)}: {kind} {ms:.4f} ms a step ({n} chains; acceptance over 8 steps "
                  f"{float(got[1].mean()):.4f}; chains equal to the shipped design's {equal}; "
                  f"{frac:.4f} within {CHAIN_ATOL} of the plain twin)", flush=True)
        rows.append(row)
    _build._lib = shipped_lib
    print(json.dumps({"card": card, "n_chains": n, "designs": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
