"""The design of the standalone 16x16 Jacobi misfits a draw a warp on one
card: draws a CTA, the launch bound, where the KL basis lies, and how the
gradient is written.

    python scripts/measure_misfit_slice_design.py

``darcy_misfit_slice_kernel`` (``csrc/fused_da_pcn.cu``: Phi) and
``darcy_misfit_grad_warp_kernel`` (``csrc/fused_mala.cu``: Phi and its
adjoint gradient) run one draw a warp on ``WarpSliceLevel``, the solve of
the ESS, cold pCN, FES and cold MALA kernels. Each takes its design from one
line: ``MisfitSliceDesign`` / ``MisfitGradWarpDesign``, ``kWarps`` draws a
CTA (W) and ``kSmWarps`` warps an SM for the launch bound (which caps a
thread's registers at 65536 / (32 kSmWarps)). Each lane of the gradient
kernel writes its two coordinates to its draw's column; the alternative
hands the rows through shared memory and, after a CTA barrier, writes W
consecutive columns a row. The KL basis is staged in shared memory once a
CTA, padded as the level reads it; the alternative reads it through L2 in
global memory's layout. The alternatives are patches of the kernel (and of
the level's two reads of the basis) in copies of ``csrc/``. This builds the unit once
for each alternative, all compilers started together; prints the
registers and spills that ptxas reports for the kernel; and times one call
on the Jacobi / 48 CG misfit of ``darcy_ess_fused`` at 4096 draws under
each, in the order shipped, alternatives, shipped. Each design's outputs
are compared with the shipped design's bit for bit (the same sums in the
same order: all should agree). At W = 32 the gradient's slices do not fit a
CTA's shared memory with the basis staged (266 KB), so it is not built.
Prints the card's name and power limit and one JSON line.
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
VALUE = dict(
    source="fused_da_pcn.cu", kernel="darcy_misfit_slice_kernel",
    line=re.compile(r"struct MisfitSliceDesign \{ static constexpr int kWarps = (\d+), "
                    r"kSmWarps = (\d+); \};"),
    # (W, warps an SM, basis staged)
    designs=[(16, 16, True), (8, 16, True), (32, 32, True), (16, 32, True), (8, 24, True),
             (16, 16, False), (8, 16, False), (32, 32, False)],
    staging=[("const float* basis = WarpSliceLevel::stage(a.s, staged);\n"
              "  float* slices = staged + WarpSliceLevel::staged_bytes() / sizeof(float);",
              "const float* basis = a.s.basis;\n  float* slices = staged;"),
             ("    WarpSliceLevel::staged_bytes() + sizeof(float) * kMisfitSliceFloats",
              "    sizeof(float) * kMisfitSliceFloats")],
)
GRAD = dict(
    source="fused_mala.cu", kernel="darcy_misfit_grad_warp_kernel",
    line=re.compile(r"struct MisfitGradWarpDesign \{ static constexpr int kWarps = (\d+), "
                    r"kSmWarps = (\d+); \};"),
    # (W, warps an SM, basis staged, rows of the gradient through shared memory)
    designs=[(16, 16, True, True), (16, 16, True, False), (8, 16, True, True),
             (8, 16, True, False), (16, 32, True, True), (8, 24, True, True),
             (16, 16, False, True), (8, 16, False, True)],
    staging=[("const float* basis = WarpSliceLevel::stage(a.s, staged);\n"
              "  float* slices = staged + WarpSliceLevel::staged_bytes() / sizeof(float);",
              "const float* basis = a.s.basis;\n  float* slices = staged;"),
             ("    WarpSliceLevel::staged_bytes() + sizeof(float) * kMisfitGradWarpFloats",
              "    sizeof(float) * kMisfitGradWarpFloats")],
    # the gradient's rows through shared memory: each warp's into its u
    # (free after the set-up), then the CTA writes W consecutive columns a row
    staged_out=("""    a.grad[static_cast<size_t>(l) * B + b] = g[0];
    a.grad[static_cast<size_t>(l + 32) * B + b] = g[1];
  }
}""", """    u[l] = g[0];
    u[l + 32] = g[1];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < kMalaD * W; e += blockDim.x) {
    const int k = e / W, j = e % W;
    if (b0 + j < B) a.grad[static_cast<size_t>(k) * B + b0 + j] = slices[j * kMisfitGradWarpFloats + k];
  }
}"""),
)
# the level's reads of the basis, staged (padded rows of kStride) and through
# L2 (global memory's rows of kCells)
SETUP_READ = ("    __builtin_assume(__isShared(basis));\n",
              "        acc[k] += basis[m * kStride + at(k)] * um;",
              "        acc[k] += basis[m * kCells + cell(k)] * um;")
GRAD_READ = ("  __builtin_assume(__isShared(lv.basis));\n",
             "acc += lv.basis[(32 * hb + m) * kStride + 36 * j + l] * w[j];",
             "acc += lv.basis[(32 * hb + m) * L::kCells + 32 * j + l] * w[j];")


def value_line(w, smw, staged) -> str:
    return (f"struct MisfitSliceDesign {{ static constexpr int kWarps = {w}, kSmWarps = "
            f"{smw}; }};")


def grad_line(w, smw, staged, out) -> str:
    return (f"struct MisfitGradWarpDesign {{ static constexpr int kWarps = {w}, kSmWarps = "
            f"{smw}; }};")


def label(design) -> str:
    w, smw, staged, *out = design
    text = f"W={w}, {smw} warps/SM, basis {'staged' if staged else 'via L2'}"
    if out:
        text += f", gradient rows {'through shared memory' if out[0] else 'from the lanes'}"
    return text


def patches(which, design, shipped_text):
    """The patches of one design: its line, the basis through L2, the
    gradient's rows through shared memory."""
    line = (value_line if which is VALUE else grad_line)(*design)
    out = [(which["source"], shipped_text, line)]
    if which is GRAD and design[3]:
        out.append((which["source"], *which["staged_out"]))
    if not design[2]:
        out += [(which["source"], old, new) for old, new in which["staging"]]
        out.append((SOLVE, SETUP_READ[0], ""))
        out.append((SOLVE, SETUP_READ[1], SETUP_READ[2]))
        if which is GRAD:
            out.append((SOLVE, GRAD_READ[0], ""))
            out.append((SOLVE, GRAD_READ[1], GRAD_READ[2]))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    from ip_mcmc_tpu_torch import configs
    from ip_mcmc_tpu_torch.ops import _build

    card = card_line()
    print(f"card: {card}")
    shipped_lib = _build.library()
    pot = configs.build("darcy_ess_fused", "cuda").batched_potential_fn
    assert pot.kernel_label == "darcy_misfit_slice_kernel[n=16]", pot.kernel_label
    assert pot.grad_kernel_label == "darcy_misfit_grad_warp_kernel[n=16]"
    n = 4096
    U = torch.randn(pot.K, n, generator=torch.Generator().manual_seed(5)).cuda()
    report = {"card": card, "draws": n}
    for which, name, run in ((VALUE, "value", lambda: (pot(U),)),
                             (GRAD, "gradient", lambda: pot.value_and_grad(U))):
        m = which["line"].search((_build.CSRC / which["source"]).read_text())
        shipped = (int(m.group(1)), int(m.group(2)), True, *([False] if which is GRAD else []))
        others = [d for d in which["designs"] if d != shipped]
        builds = build_patch_sets(_build, (which["source"],),
                                  {d: patches(which, d, m.group(0)) for d in others},
                                  f"misfit_slice_{name}")
        libs, rows = {shipped: shipped_lib}, []
        regs = {shipped: ptxas_row(_build.BUILD_DIR, which["kernel"])}
        for d in others:
            if isinstance(builds[d], str):
                print(f"{name} ({label(d)}): does not build ({builds[d]})", flush=True)
                rows.append({"design": label(d), "ms": None, "refused": builds[d]})
                continue
            libs[d] = load_with(_build, builds[d][0])
            regs[d] = ptxas_row(builds[d][1], which["kernel"])
        _build._lib = shipped_lib
        ref = run()
        torch.cuda.synchronize()
        for d in (shipped, *[d for d in others if d in libs], shipped):
            _build._lib = libs[d]
            try:
                out = run()
            except RuntimeError as e:  # shared memory the card cannot give a CTA
                print(f"{name} ({label(d)}): not run ({e})", flush=True)
                rows.append({"design": label(d), "ms": None, "refused": str(e)})
                continue
            ms = event_ms(run, 20)
            equal = all(bool(torch.equal(a, b)) for a, b in zip(out, ref))
            r = regs.get(d)
            rows.append({"design": label(d), "ms": ms, "bit_equal_to_shipped": equal,
                         "registers": r and r[0], "spill_stores": r and r[1],
                         "spill_loads": r and r[2]})
            print(f"{name}, darcy_ess_fused's Jacobi / 48 CG misfit, {n} draws ({label(d)}; "
                  f"ptxas registers, spill stores, loads {r}): {ms:.4f} ms a call; equal to the "
                  f"shipped design's bit for bit {equal}", flush=True)
        _build._lib = shipped_lib
        report[name] = rows
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
