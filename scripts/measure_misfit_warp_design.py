"""The design of the standalone 16x16 exact misfit on one card: draws a
CTA, the launch bound, and where the level's factors lie.

    python scripts/measure_misfit_warp_design.py

``darcy_misfit_warp_kernel`` (``csrc/fused_da_pcn.cu``) runs one draw a
warp on the exact level of the 16x16 DA kernel and takes its design from
one line, ``MisfitWarpDesign``: ``kWarps`` draws a CTA (W), ``kSmWarps``
warps an SM for the launch bound (which caps a thread's registers at
65536 / (32 kSmWarps)) and ``kStaged`` (the KL basis, the modes and their
eigenvalues staged in shared memory once a CTA, else read through L2, as
the DA kernel reads them). This builds ``fused_da_pcn.cu`` once for each
alternative, with that line patched, all compilers started together;
prints the registers and spills that ptxas reports for the kernel; and
times one call on ``darcy_da_fused``'s exact misfit (dst_trunc-128 / 12 CG,
4096 draws) under each, in the order shipped, alternatives, shipped. Each
design's Φ is compared with the shipped design's bit for bit (a draw's
column of the tensor-core products depends on that draw alone, and staged
or not the same values are loaded, so all should agree). Prints the card's
name and power limit and one JSON line.
"""

from __future__ import annotations

import json
import pathlib
import re
import sys

import torch

from _kernel_variants import build_designs, card_line, event_ms, load_with, print_ptxas

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

SOURCE = "fused_da_pcn.cu"
# (W, warps an SM, factors staged)
DESIGNS = [(w, 16, staged) for w in (4, 8, 16) for staged in (False, True)] + [
    (8, 24, False), (8, 32, False), (8, 8, True)]
LINE = re.compile(r"struct MisfitWarpDesign \{ static constexpr int kWarps = (\d+), "
                  r"kSmWarps = (\d+); static constexpr bool kStaged = (\w+); \};")


def design_line(w, sm_warps, staged) -> str:
    return (f"struct MisfitWarpDesign {{ static constexpr int kWarps = {w}, kSmWarps = "
            f"{sm_warps}; static constexpr bool kStaged = {'true' if staged else 'false'}; }};")


def label(design) -> str:
    w, smw, staged = design
    return f"W={w}, {smw} warps/SM, factors {'staged' if staged else 'via L2'}"


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    from ip_mcmc_tpu_torch import configs
    from ip_mcmc_tpu_torch.ops import _build

    card = card_line()
    print(f"card: {card}")
    shipped_lib = _build.library()
    m = LINE.search((_build.CSRC / SOURCE).read_text())
    shipped = (int(m.group(1)), int(m.group(2)), m.group(3) == "true")
    exact = configs.build("darcy_da_fused", "cuda").batched_potential_fn
    assert exact.kernel_label == "darcy_misfit_warp_kernel[n=16]", (
        "darcy_da_fused's exact misfit is not on the warp kernel")
    n = 4096
    U = torch.randn(exact.K, n, generator=torch.Generator().manual_seed(5)).cuda()
    others = [d for d in DESIGNS if d != shipped]
    builds = build_designs(_build, SOURCE, (SOURCE,), m.group(0),
                           {d: design_line(*d) for d in others}, "misfit_warp")
    libs, rows = {shipped: shipped_lib}, []
    print_ptxas(_build.BUILD_DIR, label(shipped), "darcy_misfit_warp_kernelILi16E")
    for d in others:
        if isinstance(builds[d], str):
            print(f"{label(d)}: does not build ({builds[d]})", flush=True)
            rows.append({"design": label(d), "ms": None, "refused": builds[d]})
            continue
        libs[d] = load_with(_build, builds[d][0])
        print_ptxas(builds[d][1], label(d), "darcy_misfit_warp_kernelILi16E")
    ref = exact(U)
    torch.cuda.synchronize()
    for d in (shipped, *[d for d in others if d in libs], shipped):
        _build._lib = libs[d]
        try:
            phi = exact(U)
        except RuntimeError as e:  # shared memory the card cannot give a CTA
            print(f"{label(d)}: not run ({e})", flush=True)
            rows.append({"design": label(d), "ms": None, "refused": str(e)})
            continue
        ms = event_ms(lambda: exact(U), 20)
        equal = bool(torch.equal(phi, ref))
        rows.append({"design": label(d), "ms": ms, "bit_equal_to_shipped": equal})
        print(f"darcy_da_fused exact misfit, 4096 draws ({label(d)}): {ms:.4f} ms a call; "
              f"Phi equal to the shipped design's bit for bit {equal}", flush=True)
    _build._lib = shipped_lib
    print(json.dumps({"card": card, "draws": n, "designs": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
