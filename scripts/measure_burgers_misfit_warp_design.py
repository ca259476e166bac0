"""The design of K12's standalone Burgers misfit a draw a warp on one card:
draws a CTA and the launch bound, beside the one-draw-a-CTA kernel it
replaced on the configs' levels.

    python scripts/measure_burgers_misfit_warp_design.py

``burgers_misfit_warp_kernel`` (``csrc/fused_da3_pcn.cu``) takes its design
from the line ``MisfitBurgersWarpDesign``: ``kWarps`` draws a CTA (W),
``kSmWarps`` warps an SM for the launch bound (which caps a thread's
registers at 65536 / (32 kSmWarps)). This builds ``fused_da3_pcn.cu`` once
for each alternative with that line patched, and once with the rule off
(``ipx_burgers_misfit`` then sends every level to ``burgers_misfit_kernel``,
one draw a CTA, as the parent tree did), all compilers started together;
prints the registers and spills that ptxas reports; and times Φ at the four
levels of the Burgers configs (fine 128 cells / 154 steps, middle 128 / 52,
coarse 64 / 26, multi-time 128 / 54 + 54 + 46) at their 2048 draws under
each, in the order shipped, alternatives, one draw a CTA, shipped: one call
through the wrapper (CUDA events), its device time (what torch.profiler
records in the misfit kernel) and the time per 2048 draws of one call of
16384 (CUDA events; ``PERF.md``'s earlier column). Beside each, whether Φ
equals the shipped design's bit for bit. Prints the card's name and power
limit and one JSON line.
"""

from __future__ import annotations

import json
import pathlib
import re
import sys

import torch

from _kernel_variants import (build_patch_sets, card_line, device_ms, event_ms, load_with,
                              ptxas_row)

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

SOURCE, NAME = "fused_da3_pcn.cu", "MisfitBurgersWarpDesign"
# (W, warps an SM for the launch bound)
LINES = [(16, 32), (16, 16), (8, 32), (8, 16), (4, 32), (4, 16), (32, 32)]
CTA = "one draw a CTA (rule off)"
RULE_OFF = [(SOURCE, "  if (ipx::burgers_warp_takes(*s, s->K)) {\n", "  if (false) {\n")]
# the kernels as ptxas names them: <C, T> at 128 and at 64 cells, the old one
PTXAS = {128: "burgers_misfit_warp_kernelILi4ELi128E", 64: "burgers_misfit_warp_kernelILi2ELi64E"}
PTXAS_CTA = "21burgers_misfit_kernel"


def line_re():
    return re.compile(rf"struct {NAME} \{{ static constexpr int kWarps = (\d+), "
                      r"kSmWarps = (\d+); \};")


def design_line(w, sm_warps) -> str:
    return f"struct {NAME} {{ static constexpr int kWarps = {w}, kSmWarps = {sm_warps}; }};"


def label(d) -> str:
    return d if isinstance(d, str) else f"W={d[0]}, {d[1]} warps/SM bound"


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    from ip_mcmc_tpu_torch import configs
    from ip_mcmc_tpu_torch.ops import _build

    card = card_line()
    print(f"card: {card}")
    shipped_lib = _build.library()
    da3, multi = (configs.build(c, "cuda") for c in ("burgers_da3_pcn", "burgers_multitime_pcn"))
    levels = {"fine": da3.batched_potential_fn, "middle": da3.batched_mid_fn,
              "coarse": da3.batched_surrogate_fn, "multi-time": multi.batched_potential_fn}
    n = da3.n_chains
    U = da3.prior.sample(torch.Generator().manual_seed(11), n).T.contiguous()
    wide = U.repeat(1, 8)

    m = line_re().search((_build.CSRC / SOURCE).read_text())
    shipped = (int(m.group(1)), int(m.group(2)))
    patches = {d: [(SOURCE, m.group(0), design_line(*d))] for d in LINES if d != shipped}
    patches[CTA] = RULE_OFF
    builds = build_patch_sets(_build, (SOURCE,), patches, "burgers_misfit_warp")
    libs = {shipped: shipped_lib}
    ptxas = {shipped: {c: ptxas_row(_build.BUILD_DIR, k) for c, k in PTXAS.items()}}
    rows = []
    for d in patches:
        if isinstance(builds[d], str):
            print(f"{label(d)}: not built ({builds[d]})", flush=True)
            rows.append({"design": label(d), "refused": builds[d]})
            continue
        libs[d] = load_with(_build, builds[d][0])
        ptxas[d] = ({"cta": ptxas_row(builds[d][1], PTXAS_CTA)} if d == CTA else
                    {c: ptxas_row(builds[d][1], k) for c, k in PTXAS.items()})
    for d in libs:
        print(f"({label(d)}) registers, spill stores, spill loads: {ptxas[d]}", flush=True)

    ref = {}
    for d in (*libs, shipped):
        _build._lib = libs[d]
        row = {"design": label(d), "ptxas": {str(k): v for k, v in ptxas[d].items()}}
        for name, pot in levels.items():
            phi = pot(U)
            ref.setdefault(name, phi)
            equal = torch.equal(phi, ref[name])
            call = event_ms(lambda: pot(U), 200)
            dev = device_ms(lambda: pot(U), 50, ("burgers_misfit",))
            per_2048 = event_ms(lambda: pot(wide), 50) / 8
            row[name] = {"call_ms": call, "device_ms": dev, "ms_per_2048_of_16384": per_2048,
                         "equal_to_shipped": equal}
            dev_s = "not recorded" if dev is None else f"{dev:.5f}"
            print(f"{label(d)}: {name} ({pot.n} cells, steps {pot.segments}) one call of {n} "
                  f"{call:.5f} ms, device {dev_s} ms, per {n} of {8 * n} {per_2048:.5f} ms; "
                  f"Phi equal to the shipped design's {equal}", flush=True)
        rows.append(row)
    _build._lib = shipped_lib
    print(json.dumps({"card": card, "n_draws": n, "designs": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
