"""The designs of two standalone misfits on their samplers' solves, on one
card: the warm value and gradient of ``darcy_mala_warm`` a draw a warp, and
``darcy64_da_fused``'s 32x32 surrogate on the 64x64 DA kernel's level.

    python scripts/measure_misfit_warm_surr_design.py

``darcy_misfit_grad_warm_warp_kernel`` (``csrc/fused_mala.cu``) runs one
draw a warp on ``WarpDstSliceLevel``, the solve of the warm MALA kernel, and
takes its design from one line, ``MisfitGradWarmWarpDesign``: ``kWarps``
draws a CTA (W) and ``kSmWarps`` warps an SM for the launch bound (which
caps a thread's registers at 65536 / (32 kSmWarps)). aux0 and aux move
through the warps' slices, W consecutive columns a row, behind a CTA
barrier at each end; the alternative has each lane read its cells of aux0
and write those of the two solutions straight from its registers, with no
CTA barrier after the staging.

``darcy_misfit_surr_cluster_kernel`` (``csrc/fused_da_pcn.cu``) runs one
draw a CTA, G a thread-block cluster, on ``ClusterSurr`` in the design of
the DA kernel (the line ``ClusterDesign`` in ``csrc/darcy_misfit.cuh``): G
= ``kG``, and the surrogate's V^T coef on the CUDA cores from this CTA's
columns of V staged in shared memory (``kSurrMmaBack`` false), or on the
tensor cores from V through L2 (true: another order of the sums, so other
bits; a timing only). At G = 4 a CTA's columns of V do not fit the free
floats of the layout, so that design does not build with the columns
staged.

The alternatives are patches in copies of ``csrc/``. This builds the unit
once for each alternative, all compilers started together; prints the
registers and spills that ptxas reports for the kernel; and times one call
under each (the warm kernel on ``darcy_mala_warm``'s pair at 4096 draws
from aux0 = 0; the surrogate at darcy64_da_fused's 1024 draws), in the
order shipped, alternatives, shipped, each design's outputs compared with
the shipped design's bit for bit.

Then the surrogate's bits against the sampler's own solve: a copy of
``fused_da_pcn_cluster_kernel`` patched to write its first inner step's
Phi* to the inner-acceptance output, run for one outer step of one inner
step with beta = 0 (contraction 1, and prop = pos under the zero prior
mean), so that it solves the surrogate at the start positions: its Phi*
must equal the standalone kernel's bit for bit. Prints the card's name and
power limit and one JSON line.
"""

from __future__ import annotations

import json
import pathlib
import re
import sys

import torch

from _kernel_variants import build_patch_sets, card_line, event_ms, load_with, ptxas_row

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

SOLVE = "darcy_misfit.cuh"
WARM_SOURCE, SURR_SOURCE = "fused_mala.cu", "fused_da_pcn.cu"
WARM_KERNEL, SURR_KERNEL = "darcy_misfit_grad_warm_warp_kernel", "darcy_misfit_surr_cluster_kernel"
WARM_LINE = re.compile(r"struct MisfitGradWarmWarpDesign \{ static constexpr int kWarps = "
                       r"(\d+), kSmWarps = (\d+); \};")
SURR_LINE = re.compile(r"struct ClusterDesign \{ static constexpr int kG = (\d+), kCells = 8, "
                       r"kThreads = 512, kMinCtas = 2; static constexpr bool kSurrMmaCoef = "
                       r"true, kSurrMmaBack = (\w+); \};")
# (W, warps an SM, aux through the warps' slices)
WARM_DESIGNS = [(16, 16, True), (16, 16, False), (8, 16, True), (4, 16, True), (4, 8, True),
                (8, 24, True), (8, 16, False)]
# (G, the surrogate's V^T coef on the tensor cores)
SURR_DESIGNS = [(8, False), (8, True), (4, False), (4, True)]

# the warm kernel's body after the staging with each lane reading its cells
# of aux0 and writing those of aux from its registers: no CTA barrier after
# the staging, so a spare warp leaves
WARM_LANES_IO_BODY = """  __syncthreads();  // the staged factors and every warp's u
  const int l = threadIdx.x & 31, b = b0 + (threadIdx.x >> 5);
  if (b >= B) return;  // a spare warp: no CTA barrier follows
  float* u = slices + (threadIdx.x >> 5) * kMisfitGradWarmWarpFloats;
  float* slice = u + kMalaD;  // af, xf, p, th, tv, q
  const __nv_bfloat16* S = WarpDstSliceLevel::staged_S(dst);
  WarpDstSliceLevel lv{
      WarpSliceLevel{&a.s, basis, {slice + 2 * kStride, slice + 3 * kStride, slice + 4 * kStride}},
      S,
      S + WarpSliceLevel::kN * WarpDstSliceLevel::kRow,
      WarpDstSliceLevel::staged_lam(dst),
      reinterpret_cast<__nv_bfloat16*>(slice + 5 * kStride),
      1.0f};
  float x0[8], l0[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const size_t t = WarpSliceLevel::cell(k);
    x0[k] = a.aux0[t * B + b];
    l0[k] = a.aux0[(kCells + t) * B + b];
  }
  float g[2];
  const float v = darcy_value_and_grad_warp<true>(lv, u, slice, slice + kStride, x0, l0, g);
  if (l == 0) a.phi[b] = v;
  a.grad[static_cast<size_t>(l) * B + b] = g[0];
  a.grad[static_cast<size_t>(l + 32) * B + b] = g[1];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const size_t t = WarpSliceLevel::cell(k);
    a.aux[t * B + b] = slice[kStride + WarpSliceLevel::at(k)];
    a.aux[(kCells + t) * B + b] = lv.ws.th[WarpSliceLevel::at(k)];
  }
}"""
# the shipped body after the staging (aux through the warps' slices)
WARM_BODY = re.compile(r"  // the draws' aux0, rows \[0, cells\) to the slice a.*?\n\}"
                       r"(?=\n\n// Launches darcy_misfit_grad_warm_warp_kernel)", re.S)

# the DA kernel's first inner step's Phi* to the inner-acceptance output
FIRST_SP = [
    (SURR_SOURCE, "      const float sp = darcy_solve_cluster<false>(surr, prop, xs);\n",
     "      const float sp = darcy_solve_cluster<false>(surr, prop, xs);\n"
     "      if (i == 0u && j == 0 && threadIdx.x == 0 && live) a.inner[blockIdx.x] = sp;\n"),
    (SURR_SOURCE, "  if (threadIdx.x == 0 && live)\n    a.inner[blockIdx.x] = step.in_acc",
     "  if (false)\n    a.inner[blockIdx.x] = step.in_acc"),
]


def warm_label(d) -> str:
    w, smw, smem_io = d
    return f"W={w}, {smw} warps/SM, aux {'through the slices' if smem_io else 'from the lanes'}"


def surr_label(d) -> str:
    g, mma_back = d
    return f"G={g}, V^T coef {'on the tensor cores (V via L2)' if mma_back else 'on the CUDA cores (V staged)'}"


def warm_patches(d, line, source):
    w, smw, smem_io = d
    out = [(WARM_SOURCE, line, f"struct MisfitGradWarmWarpDesign {{ static constexpr int kWarps = "
                               f"{w}, kSmWarps = {smw}; }};")]
    if not smem_io:
        out.append((WARM_SOURCE, WARM_BODY.search(source).group(0), WARM_LANES_IO_BODY))
    return out


def surr_patches(d, line):
    g, mma_back = d
    return [(SOLVE, line, f"struct ClusterDesign {{ static constexpr int kG = {g}, kCells = 8, "
                          f"kThreads = 512, kMinCtas = 2; static constexpr bool kSurrMmaCoef = "
                          f"true, kSurrMmaBack = {'true' if mma_back else 'false'}; }};")]


def time_designs(name, shipped, others, builds, shipped_lib, kernel, run, label, _build):
    """Each design's call in turns (shipped, alternatives, shipped) and its
    outputs against the shipped design's; the rows."""
    libs, rows = {shipped: shipped_lib}, []
    regs = {shipped: ptxas_row(_build.BUILD_DIR, kernel)}
    for d in others:
        if isinstance(builds[d], str):
            print(f"{name} ({label(d)}): does not build ({builds[d]})", flush=True)
            rows.append({"design": label(d), "ms": None, "refused": builds[d]})
            continue
        libs[d] = load_with(_build, builds[d][0])
        regs[d] = ptxas_row(builds[d][1], kernel)
    _build._lib = shipped_lib
    ref = run()
    torch.cuda.synchronize()
    for d in (shipped, *[d for d in others if d in libs], shipped):
        _build._lib = libs[d]
        try:
            out = run()
        except RuntimeError as e:  # a launch the card refuses
            print(f"{name} ({label(d)}): not run ({e})", flush=True)
            rows.append({"design": label(d), "ms": None, "refused": str(e)})
            continue
        ms = event_ms(run, 20)
        equal = all(bool(torch.equal(a, b)) for a, b in zip(out, ref))
        r = regs.get(d)
        rows.append({"design": label(d), "ms": ms, "bit_equal_to_shipped": equal,
                     "registers": r and r[0], "spill_stores": r and r[1], "spill_loads": r and r[2]})
        print(f"{name} ({label(d)}; ptxas registers, spill stores, loads {r}): {ms:.4f} ms a "
              f"call; equal to the shipped design's bit for bit {equal}", flush=True)
    _build._lib = shipped_lib
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    from ip_mcmc_tpu_torch import configs
    from ip_mcmc_tpu_torch.ops import _build
    from ip_mcmc_tpu_torch.ops import fused_da_pcn as da

    card = card_line()
    print(f"card: {card}")
    shipped_lib = _build.library()
    report = {"card": card}

    # the warm value and gradient, darcy_mala_warm's pair at 4096 draws
    p = configs.build("darcy_mala_warm", "cuda")
    pag, aux_dim = p.batched_warm_potential
    assert pag.grad_warm_kernel_label == f"{WARM_KERNEL}[n=16]", pag.grad_warm_kernel_label
    U = p.prior.sample(torch.Generator().manual_seed(5), 4096).T.contiguous()
    zeros = torch.zeros(aux_dim, 4096, device="cuda")
    source = (_build.CSRC / WARM_SOURCE).read_text()
    m = WARM_LINE.search(source)
    shipped = (int(m.group(1)), int(m.group(2)), True)
    others = [d for d in WARM_DESIGNS if d != shipped]
    builds = build_patch_sets(_build, (WARM_SOURCE,),
                              {d: warm_patches(d, m.group(0), source) for d in others},
                              "misfit_warm_design")
    report["warm"] = time_designs("warm gradient, darcy_mala_warm's dst / 6 + 6 CG, 4096 draws",
                                  shipped, others, builds, shipped_lib, WARM_KERNEL,
                                  lambda: pag(U, zeros), warm_label, _build)

    # the 32x32 surrogate, darcy64_da_fused's at 1024 draws
    p64 = configs.build("darcy64_da_fused", "cuda")
    exact, surr = p64.batched_potential_fn, p64.batched_surrogate_fn
    assert surr.kernel_label == f"{SURR_KERNEL}[n=32]", surr.kernel_label
    n = p64.n_chains
    U144 = p64.prior.sample(torch.Generator().manual_seed(6), n).T.contiguous()
    m = SURR_LINE.search((_build.CSRC / SOLVE).read_text())
    shipped = (int(m.group(1)), m.group(2) == "true")
    others = [d for d in SURR_DESIGNS if d != shipped]
    sets = {d: surr_patches(d, m.group(0)) for d in others}
    sets["first_sp"] = FIRST_SP
    builds = build_patch_sets(_build, (SURR_SOURCE,), sets, "misfit_surr_design")
    report["surrogate"] = time_designs(
        f"surrogate, darcy64_da_fused's 32x32 dst_trunc-128 / 3 CG, {n} draws", shipped, others,
        builds, shipped_lib, SURR_KERNEL, lambda: (surr(U144),), surr_label, _build)

    # the surrogate's Phi* against the DA kernel's own solve at the same u
    standalone = surr(U144)
    if isinstance(builds["first_sp"], str):
        raise AssertionError(f"the patched DA kernel does not build: {builds['first_sp']}")
    _build._lib = load_with(_build, builds["first_sp"][0])
    pos = U144.T.contiguous()
    _, _, sp = da._launch(exact, surr, pos, p64.prior.mean, p64.prior.scale, 0.0, 3, 1, 1,
                          p64.kernel_params["block_chains"])
    torch.cuda.synchronize()
    _build._lib = shipped_lib
    equal = bool(torch.equal(sp, standalone))
    rel = float(((sp - standalone).abs() / standalone.abs()).max())
    print(f"surrogate at {n} draws: the standalone kernel's Phi* equal to the DA kernel's first "
          f"surrogate solve (beta = 0) bit for bit {equal} (largest relative difference "
          f"{rel:.3e})", flush=True)
    report["surrogate_equals_da_kernel_solve"] = equal
    report["surrogate_max_rel_to_da_kernel_solve"] = rel
    print(json.dumps(report))
    return 0 if equal else 1


if __name__ == "__main__":
    sys.exit(main())
