"""The design of the elliptical slice sampling kernel, one chain a warp, on
one card: chains a CTA and registers.

    python scripts/measure_ess_warp_design.py

``fused_ess_warp_kernel`` (``csrc/fused_ess.cu``) takes its design from one
line, ``EssWarpDesign``: ``kWarps`` chains a CTA at most (W), ``kSmWarps``
warps an SM for the launch bound (which caps a thread's registers at
65536 / (32 kSmWarps), or 64 when a CTA has 32 warps). Its solve,
``WarpSliceLevel``, stages the KL basis in shared memory once a CTA and
adds its dot products in block_sum's order. This builds ``fused_ess.cu``
once for each alternative with that line patched, all compilers started
together; prints the registers and spills that ptxas reports; and times
one step of ``darcy_ess_fused`` (4096 chains, blocks of 256, max_shrink 6)
under each, as the slope between two launch lengths, in the order shipped,
alternatives, shipped. Every design runs the same chains from the same
start and seed; beside each time, whether its chains (16 steps, final
state and records) equal the shipped design's bit for bit, and the
acceptance. Prints the card's name and power limit and one JSON line.
"""

from __future__ import annotations

import json
import pathlib
import re
import sys

import torch

from _kernel_variants import build_designs, card_line, load_with, ptxas_row, slope_ms

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

SOURCE = "fused_ess.cu"
LINE = re.compile(r"struct EssWarpDesign \{ static constexpr int kWarps = (\d+), "
                  r"kSmWarps = (\d+); \};")
KERNEL = "fused_ess_warp_kernelILb0"  # the mangled name of <false>
# (W, warps an SM for the launch bound)
DESIGNS = [(16, 16), (32, 32), (8, 16), (8, 24), (8, 32), (4, 16)]


def design_line(w, sm_warps) -> str:
    return (f"struct EssWarpDesign {{ static constexpr int kWarps = {w}, kSmWarps = "
            f"{sm_warps}; }};")


def label(d) -> str:
    return f"W={d[0]}, {d[1]} warps/SM bound"


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    from ip_mcmc_tpu_torch import configs, ops
    from ip_mcmc_tpu_torch.ops import _build, fused_ess

    card = card_line()
    print(f"card: {card}")
    shipped_lib = _build.library()
    m = LINE.search((_build.CSRC / SOURCE).read_text())
    shipped = (int(m.group(1)), int(m.group(2)))
    alternatives = [d for d in DESIGNS if d != shipped]
    builds = build_designs(_build, SOURCE, (SOURCE,), m.group(0),
                           {d: design_line(*d) for d in alternatives}, "ess_warp")
    rows, libs, ptxas = [], {shipped: shipped_lib}, {shipped: ptxas_row(_build.BUILD_DIR, KERNEL)}
    for d in alternatives:
        if isinstance(builds[d], str):
            print(f"{label(d)}: not built ({builds[d]})", flush=True)
            rows.append({"design": label(d), "refused": builds[d]})
            continue
        libs[d], ptxas[d] = load_with(_build, builds[d][0]), ptxas_row(builds[d][1], KERNEL)
    for d in libs:
        smem = fused_ess.BASIS_BYTES + d[0] * fused_ess.WARP_SLICE_BYTES
        print(f"({label(d)}) {KERNEL}: registers, spill stores, spill loads {ptxas[d]}; "
              f"{smem} bytes of shared memory a CTA", flush=True)

    p = configs.build("darcy_ess_fused", "cuda")
    pot, shrink = p.batched_potential_fn, p.kernel_params["max_shrink"]
    pos = p.init_positions(torch.Generator().manual_seed(5), p.n_chains).cuda()

    def run(steps):
        return ops.fused_ess_chain(pot, pos, p.prior.mean, p.prior.scale, 7, n_steps=steps,
                                   max_shrink=shrink, block_chains=256)

    ref = None
    for d in (*libs, shipped):
        _build._lib = libs[d]
        got = ops.fused_ess_chain_recorded(pot, pos, p.prior.mean, p.prior.scale, 7, n_steps=16,
                                           thin=1, max_shrink=shrink, block_chains=256)
        ref = ref or got
        equal = all(torch.equal(a, b) for a, b in zip(got, ref))
        ms = slope_ms(run, 8, 40)
        rows.append({"design": label(d), "ms_per_step": ms, "accept_16_steps":
                     float(got[1].mean()), "equal_to_shipped": equal, "ptxas": ptxas[d]})
        print(f"{label(d)}: darcy_ess_fused {ms:.4f} ms a step (4096 chains; acceptance over 16 "
              f"steps {float(got[1].mean()):.4f}; chains equal to the shipped design's {equal})",
              flush=True)
    _build._lib = shipped_lib
    print(json.dumps({"card": card, "n_chains": p.n_chains, "designs": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
