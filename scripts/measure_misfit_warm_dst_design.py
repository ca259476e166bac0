"""The design of the 16x16 dense-dst warm misfit a draw a warp, on one card.

    python scripts/measure_misfit_warm_dst_design.py

``darcy_misfit_warm_dst_warp_kernel`` (``csrc/fused_pcn.cu``) runs
``darcy_smc_warm``'s mutation misfit (16x16, K 64, dense dst / 6 CG) one draw
a warp on warm MALA's level, ``WarpDstSliceLevel``. It takes its design from
one line, ``MisfitWarmDstWarpDesign``: ``kWarps`` draws a CTA (W) and
``kSmWarps`` warps an SM for the launch bound (which caps a thread's
registers at 65536 / (32 kSmWarps)). The alternatives: W 8 (two CTAs an SM
if the registers allow), W 8 with a bound of 32 warps an SM, W 4; and the
one-draw-a-CTA ``darcy_misfit_warm_kernel`` that ran the spec before
(``DarcyMisfitWarm.forward_layout``). The alternatives are patches in copies
of ``csrc/``; each builds once, the compilers started together; ptxas's
registers and spills are printed for each.

At 4096 draws, from x0 = 0 and from the solution of 8 sweeps after a
mutation-sized move (the two inputs of ``darcy_smc_warm``'s stages), in the
order shipped, alternatives, the one-draw-a-CTA kernel, shipped: CUDA events
around 20 calls through the wrapper and the device time the profiler records
in the kernel; each design's (Phi, x) against the shipped design's and the
one-draw-a-CTA kernel's, bit for bit (the count of draws that differ). Prints
the card's name and power limit and one JSON line; exit status 1 if a design
that builds differs from the one-draw-a-CTA kernel.
"""

from __future__ import annotations

import json
import math
import pathlib
import re
import sys

import torch

from _kernel_variants import build_patch_sets, card_line, device_ms, event_ms, load_with, ptxas_row

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

SOURCE = "fused_pcn.cu"
KERNEL = "darcy_misfit_warm_dst_warp_kernel"
PARENT = "darcy_misfit_warm_kernelINS_8DarcyPotINS_8Layout16"
LINE = re.compile(r"struct MisfitWarmDstWarpDesign \{ static constexpr int kWarps = (\d+), "
                  r"kSmWarps = (\d+); \};")
DESIGNS = [(16, 16), (8, 16), (8, 32), (4, 16)]  # (W, warps an SM)


def differing(out, ref) -> int:
    """Draws whose Phi or any cell of x differs from ``ref``'s."""
    return int(((out[0] != ref[0]) | (out[1] != ref[1]).any(dim=0)).sum())


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    from ip_mcmc_tpu_torch import configs
    from ip_mcmc_tpu_torch.ops import _build

    card = card_line()
    print(f"card: {card}", flush=True)
    shipped_lib = _build.library()
    p = configs.build("darcy_smc_warm", "cuda")
    warm, aux_dim = p.batched_warm_potential
    assert warm.warm_kernel_label == f"{KERNEL}[n=16]", warm.warm_kernel_label
    n = 4096
    g = torch.Generator().manual_seed(7)
    U = p.prior.sample(g, n).T.contiguous()
    U2 = (math.sqrt(1 - 0.15 ** 2) * U + 0.15 * p.prior.sample(g, n).T).contiguous()
    zeros = torch.zeros(aux_dim, n, device="cuda")
    x = zeros
    for _ in range(8):
        _, x = warm(U, x)
    inputs = {"x0 = 0": (U, zeros), "8 sweeps' solution": (U2, x)}
    parent = {k: warm.forward_layout(*v) for k, v in inputs.items()}

    src = (_build.CSRC / SOURCE).read_text()
    m = LINE.search(src)
    shipped = (int(m.group(1)), int(m.group(2)))
    others = [d for d in DESIGNS if d != shipped]
    builds = build_patch_sets(_build, (SOURCE,), {
        d: [(SOURCE, m.group(0), f"struct MisfitWarmDstWarpDesign {{ static constexpr int "
                                 f"kWarps = {d[0]}, kSmWarps = {d[1]}; }};")] for d in others},
        "warm_dst")
    libs = {shipped: shipped_lib}
    regs = {shipped: ptxas_row(_build.BUILD_DIR, KERNEL), "parent": ptxas_row(_build.BUILD_DIR,
                                                                               PARENT)}
    rows = []
    for d in others:
        if isinstance(builds[d], str):
            print(f"W={d[0]}, {d[1]} warps/SM: does not build ({builds[d]})", flush=True)
            rows.append({"design": f"W={d[0]}, {d[1]} warps/SM", "refused": builds[d]})
            continue
        libs[d] = load_with(_build, builds[d][0])
        regs[d] = ptxas_row(builds[d][1], KERNEL)

    ok = True
    for name, (u, x0) in inputs.items():
        ref = None
        for d in (shipped, *[d for d in others if d in libs], "parent", shipped):
            if d == "parent":
                _build._lib = shipped_lib
                run = lambda u=u, x0=x0: warm.forward_layout(u, x0)  # noqa: E731
                label = "one draw a CTA (darcy_misfit_warm_kernel)"
                needle = "darcy_misfit_warm_kernel<"
            else:
                _build._lib = libs[d]
                run = lambda u=u, x0=x0: warm(u, x0)  # noqa: E731
                label, needle = f"W={d[0]}, {d[1]} warps/SM", KERNEL
            out = run()
            torch.cuda.synchronize()
            ref = out if ref is None else ref
            ms, dev = event_ms(run, 20), device_ms(run, 20, (needle,))
            diff_parent, diff_shipped = differing(out, parent[name]), differing(out, ref)
            ok = ok and diff_parent == 0
            row = {"input": name, "design": label, "ms": ms, "device_ms": dev,
                   "ptxas": regs.get(d), "draws_differing_from_parent": diff_parent,
                   "draws_differing_from_shipped": diff_shipped}
            rows.append(row)
            print(json.dumps(row), flush=True)
        _build._lib = shipped_lib
    print(json.dumps({"card": card, "draws": n, "shipped": shipped, "rows": rows}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
