"""The design of the linear-Gaussian group kernels, RWM (K14) and dense-prior
pCN (K15), on one card: lanes a chain, warps a CTA, and where K15 reads L.

    python scripts/measure_linear_group_design.py

``fused_rwm_group_kernel`` (``csrc/fused_rwm.cu``) and
``fused_pcn_dense_group_kernel`` (``csrc/fused_pcn_dense.cu``) take their
design from one line, ``GaussianGroupDesign`` in
``csrc/gaussian_potential.cuh``: warps a CTA of both kernels (W) and at
least ``kMinWidth`` lanes a chain (G = max(d, kMinWidth): at d = 2,
kMinWidth 2 runs 16 chains a warp, 32 one). K15 keeps row t of L in lane
t's registers; the alternatives stage L in shared memory once a CTA, or
read it through L1 at every step as the one-chain-a-CTA kernel does. The
coordinates (K15: and z) reach the rows through the warp's shared memory,
float4 reads at d = 32; the alternatives gather them by shuffles (at W 4,
the shipped W and 16) or read them one float at a time. The one-chain-a-CTA kernels
themselves (the takes-rule patched to take nothing) run as one more
design. This builds the two sources once for each alternative (all
compilers started together, ``scripts/_kernel_variants.py``), prints the
registers and spills that ptxas reports, and times one step of K14 on the
compare_paths target (8192 chains, blocks of 1024), of K14 on the
gauss2d_rwm target with its prior (1024, blocks of 512) and of K15 on
lingauss_pcn's misfit with L = diag √λ and with a dense lower-triangular L
(2048, blocks of 256), as the slope between launches of 20 and 2020 steps
(five of each), in the order shipped, alternatives, shipped. Every design
runs the same chains from the same start and seed; beside each time,
whether its chains (final state, acceptance and records over 20 steps)
equal the shipped design's bit for bit, and the share within 1e-4 of the
plain twin's. Prints the card's name and power limit and one JSON line.
"""

from __future__ import annotations

import json
import pathlib
import re
import sys

import torch

from _kernel_variants import build_patch_sets, card_line, load_with, ptxas_row, slope_ms

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

CHAIN_ATOL = 1e-4  # chip_smoke.py's
STEPS, SHORT, LONG, REPS = 20, 20, 2020, 5
HEADER = "gaussian_potential.cuh"
UNITS = ("fused_rwm.cu", "fused_pcn_dense.cu")
LINE = re.compile(r"struct GaussianGroupDesign \{\n  static constexpr int kWarps = (\d+), "
                  r"kMinWidth = (\d+);\n\};")
# (W, kMinWidth)
LINES = [(8, 2), (2, 2), (4, 2), (16, 2), (8, 32)]
# K15's L staged in shared memory once a CTA, or read through L1 each step
XI = "for (int k = 0; k < D; ++k) xi += l[k] * z[k];"
L_FROM = {
    "L staged in shared memory": [
        ("fused_pcn_dense.cu", "  float pos, phi;\n", "  float pos, phi;\n  const float* ls;\n"),
        ("fused_pcn_dense.cu", "  step.load();\n",
         "  __shared__ float chol_s[D * D];\n"
         "  for (int i = threadIdx.x; i < D * D; i += blockDim.x) chol_s[i] = a.chol_t[i];\n"
         "  __syncthreads();\n"
         "  step.ls = chol_s;\n"),
        ("fused_pcn_dense.cu", XI, "for (int k = 0; k < D; ++k) "
         "xi += (Ctx::holds() ? ls[k * D + Ctx::t()] : 0.0f) * z[k];"),
    ],
    "L through L1": [
        ("fused_pcn_dense.cu", "  step.load();\n", ""),
        ("fused_pcn_dense.cu", XI, "for (int k = 0; k < D; ++k) "
         "xi += (Ctx::holds() ? a.chol_t[k * D + Ctx::t()] : 0.0f) * z[k];"),
    ],
}
# gather by D shuffles (at W 4 and 8), or through the warp's shared memory
# with scalar reads, in place of float4 reads where D % 4 == 0
FLOAT4 = """  if constexpr (D % 4 == 0) {
#pragma unroll
    for (int q = 0; q < D / 4; ++q) {
      const float4 f = reinterpret_cast<const float4*>(buf + base)[q];
      x[4 * q] = f.x;
      x[4 * q + 1] = f.y;
      x[4 * q + 2] = f.z;
      x[4 * q + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < D; ++j) x[j] = buf[base + j];
  }
"""
TO_SHARED = """  __shared__ __align__(16) float xch[32 * GaussianGroupDesign::kWarps];
  float* buf = xch + (threadIdx.x & ~31);
  __syncwarp();
  buf[threadIdx.x & 31] = v;
  __syncwarp();
"""
GATHER = {
    "gather by shuffles": [(HEADER, TO_SHARED + FLOAT4, "#pragma unroll\n  for (int j = 0; j < D; "
                            "++j) x[j] = __shfl_sync(0xffffffffu, v, base + j);\n")],
    "scalar reads": [(HEADER, FLOAT4,
                      "#pragma unroll\n  for (int j = 0; j < D; ++j) x[j] = buf[base + j];\n")],
}
ONE_A_CTA = "one chain a CTA (the parent's kernels)"
TAKES = "  return (d == 2 || d == 32) && s.K == d && s.m >= 0 && s.m <= d;\n"


def design_line(warps, min_width) -> str:
    return (f"struct GaussianGroupDesign {{\n  static constexpr int kWarps = {warps}, "
            f"kMinWidth = {min_width};\n}};")


def label(d) -> str:
    if isinstance(d, str):
        return d
    return f"W={d[0]}, kMinWidth={d[1]}" + (f", {d[2]}" if len(d) > 2 else "")


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from ip_mcmc_tpu_torch import configs
    from ip_mcmc_tpu_torch.ops import _build, fused_pcn_dense, fused_rwm

    card = card_line()
    print(f"card: {card}")
    shipped_lib = _build.library()
    gen = torch.Generator().manual_seed(5)
    cp = chip_smoke.compare_paths_potential()
    pos_cp = torch.randn(chip_smoke.CP_CHAINS, 2, generator=gen).cuda()
    g2 = configs.gauss2d_batched_potential().cuda()
    p2 = configs.build("gauss2d_rwm", "cuda")
    pos_g2 = p2.init_positions(gen, p2.n_chains).cuda()
    prior = dict(prior_mean=p2.prior.mean, prior_scale=p2.prior.scale)
    lg, scale, chol = chip_smoke.lingauss_potential()
    n_l = configs.build("lingauss_pcn", "cuda").n_chains
    pos_l = (torch.randn(n_l, lg.K, generator=gen).cuda() * scale).contiguous()
    zeros = torch.zeros(lg.K, device="cuda")
    dense = chip_smoke.dense_cholesky(scale.double().cpu().numpy() ** 2)

    # case -> (run(steps, thin), its plain twin over STEPS recorded steps)
    cases = {
        "compare_paths": (
            lambda s, thin=None: fused_rwm._launch(cp, pos_cp, 0.9, 41, s, chip_smoke.CP_BLOCK,
                                                   thin=thin),
            lambda: fused_rwm._run_plain(cp._forward_plain, pos_cp, 0.9, 41, STEPS,
                                         chip_smoke.CP_BLOCK, thin=1)),
        "gauss2d": (
            lambda s, thin=None: fused_rwm._launch(g2, pos_g2, 1.0, 43, s, 512, thin=thin,
                                                   **prior),
            lambda: fused_rwm._run_plain(g2._forward_plain, pos_g2, 1.0, 43, STEPS, 512, thin=1,
                                         **prior)),
        "lingauss": (
            lambda s, thin=None: fused_pcn_dense._launch(lg, pos_l, zeros, chol, 0.2, 53, s,
                                                         chip_smoke.LINGAUSS_BLOCK, thin=thin),
            lambda: fused_pcn_dense._run_plain(lg._forward_plain, pos_l, zeros, chol, 0.2, 53,
                                               STEPS, chip_smoke.LINGAUSS_BLOCK, thin=1)),
        "lingauss, dense L": (
            lambda s, thin=None: fused_pcn_dense._launch(lg, pos_l, zeros, dense, 0.2, 53, s,
                                                         chip_smoke.LINGAUSS_BLOCK, thin=thin),
            lambda: fused_pcn_dense._run_plain(lg._forward_plain, pos_l, zeros, dense, 0.2, 53,
                                               STEPS, chip_smoke.LINGAUSS_BLOCK, thin=1)),
    }
    twins = {case: plain() for case, (_, plain) in cases.items()}

    m = LINE.search((_build.CSRC / HEADER).read_text())
    shipped = tuple(int(m.group(i)) for i in (1, 2))
    patches = {d: [(HEADER, m.group(0), design_line(*d))] for d in LINES if d != shipped}
    for name, p in L_FROM.items():
        patches[(*shipped, name)] = p
    for name, p in GATHER.items():
        for w in ((4, shipped[0], 16) if name.endswith("shuffles") else (shipped[0],)):
            line = ([] if w == shipped[0]
                    else [(HEADER, m.group(0), design_line(w, shipped[1]))])
            patches[(w, shipped[1], name)] = line + p
    patches[ONE_A_CTA] = [(HEADER, TAKES, "  return false;\n")]
    builds = build_patch_sets(_build, UNITS, patches, "linear_group")
    libs, ptxas = {shipped: shipped_lib}, {shipped: _build.BUILD_DIR}
    rows = []
    for d in patches:
        if isinstance(builds[d], str):
            print(f"{label(d)}: not built ({builds[d]})", flush=True)
            rows.append({"design": label(d), "refused": builds[d]})
            continue
        libs[d], ptxas[d] = load_with(_build, builds[d][0]), builds[d][1]
    for d, where in ptxas.items():
        min_width = shipped[1] if isinstance(d, str) else d[1]
        g2w = max(min_width, 2)
        needles = {"K14 d=2": (f"fused_rwm_group_kernelILb1ELi2ELi{g2w}E",),
                   "K15 d=32": ("fused_pcn_dense_group_kernelILb1ELi32ELi32E",)}
        if d == ONE_A_CTA:
            needles = {k: (f"{name}_kernelI", "LinearGaussianPotential", "Lb1E")
                       for k, name in (("K14", "fused_rwm"), ("K15", "fused_pcn_dense"))}
        print(f"({label(d)}) ptxas, <true>: " + ", ".join(
            f"{k} {ptxas_row(where, *v)}" for k, v in needles.items()), flush=True)

    ref = {}
    for d in (*libs, shipped):
        _build._lib = libs[d]
        row = {"design": label(d)}
        for case, (run, _) in cases.items():
            got = run(STEPS, 1)
            ref.setdefault(case, got)
            equal = all(torch.equal(a, b) for a, b in zip(got, ref[case]))
            twin = twins[case]
            dev = torch.maximum((got[0] - twin[0]).abs().amax(dim=1),
                                (got[2] - twin[2]).abs().amax(dim=(0, 2)))
            frac = float((dev <= CHAIN_ATOL).double().mean())
            ms = slope_ms(run, SHORT, LONG, REPS)
            row[case] = {"ms_per_step": ms, "accept": float(got[1].mean()),
                         "equal_to_shipped": equal, "frac_within_atol_of_twin": frac}
            print(f"{label(d)}: {case} {1e3 * ms:.4f} us a step ({got[0].shape[0]} chains; "
                  f"acceptance over {STEPS} steps {float(got[1].mean()):.4f}; chains equal to "
                  f"the shipped design's {equal}; {frac:.4f} within {CHAIN_ATOL} of the plain "
                  f"twin)", flush=True)
        rows.append(row)
    _build._lib = shipped_lib
    print(json.dumps({"card": card, "designs": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
