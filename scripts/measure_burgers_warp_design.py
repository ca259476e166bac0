"""The design of the Burgers DA and pCN kernels, one chain a warp, on one
card: chains a CTA, registers, and (DA) where the exact level's basis is
read from.

    python scripts/measure_burgers_warp_design.py

``fused_da_pcn_burgers_warp_kernel`` (``csrc/fused_da_pcn.cu``) and
``fused_pcn_burgers_warp_kernel`` (``csrc/fused_pcn.cu``) take their design
from one line each, ``DaBurgersWarpDesign`` and ``PcnBurgersWarpDesign``:
``kWarps`` chains a CTA at most (W), ``kSmWarps`` warps an SM for the
launch bound (which caps a thread's registers at 65536 / (32 kSmWarps)).
The DA kernel stages both levels' bases and means in shared memory once a
CTA; the alternative reads the exact (128-cell) level's through L2. This
builds the kernel's source once for each alternative with that line (or
that code) patched, all compilers started together; prints the registers
and spills that ptxas reports; and times one outer step of
``burgers_da_pcn`` (128 / 64 cells, k = 16) and one step of
``burgers_pcn`` and of ``burgers_multitime_pcn`` (2048 chains, blocks of
512) under each, as the slope between two launch lengths, in the order
shipped, alternatives, shipped. Every design runs the same chains from the
same start and seed; beside each time, whether its chains (final state and
records) equal the shipped design's bit for bit, the share within 1e-4 of
the plain twin's and the acceptance. Prints the card's name and power
limit and one JSON line.
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
# sampler -> (source, design line, the mangled name of <false>)
KERNELS = {
    "da": ("fused_da_pcn.cu", "DaBurgersWarpDesign", "fused_da_pcn_burgers_warp_kernelILb0E"),
    "pcn": ("fused_pcn.cu", "PcnBurgersWarpDesign", "fused_pcn_burgers_warp_kernelILb0E"),
}
# (W, warps an SM for the launch bound)
LINES = [(16, 16), (8, 16), (4, 16), (16, 32)]
# the DA kernel's exact level through L2: nothing of it staged
EXACT_THROUGH_L2 = [
    ("  float* w = surr.stage(exact.stage(staged)) + (threadIdx.x >> 5) * kDaBurgersWarpFloats;\n",
     "  exact.basis = a.exact.basis;\n"
     "  exact.mean = a.exact.mean;\n"
     "  float* w = surr.stage(staged) + (threadIdx.x >> 5) * kDaBurgersWarpFloats;\n"),
    ("  geo->smem = sizeof(float) * (BurgersWarpLevel::staged_floats(exact.n_cells) +\n"
     "                               BurgersWarpLevel::staged_floats(surr.n_cells) +\n",
     "  geo->smem = sizeof(float) * (BurgersWarpLevel::staged_floats(surr.n_cells) +\n"),
]


def line_re(name):
    return re.compile(rf"struct {name} \{{ static constexpr int kWarps = (\d+), "
                      r"kSmWarps = (\d+); \};")


def design_line(name, w, sm_warps) -> str:
    return f"struct {name} {{ static constexpr int kWarps = {w}, kSmWarps = {sm_warps}; }};"


def label(d) -> str:
    return f"W={d[0]}, {d[1]} warps/SM bound" + (f", {d[2]}" if len(d) > 2 else "")


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    from ip_mcmc_tpu_torch import configs
    from ip_mcmc_tpu_torch.ops import _build, fused_pcn
    from ip_mcmc_tpu_torch.ops import fused_da_pcn as da

    card = card_line()
    print(f"card: {card}")
    shipped_lib = _build.library()
    da_p, pcn_p, multi_p = (configs.build(c, "cuda") for c in (
        "burgers_da_pcn", "burgers_pcn", "burgers_multitime_pcn"))
    n, block = da_p.n_chains, 512
    pm, ps = da_p.prior.mean, da_p.prior.scale
    pos = da_p.init_positions(torch.Generator().manual_seed(5), n).cuda()
    exact, surr = da_p.batched_potential_fn, da_p.batched_surrogate_fn
    k = da_p.kernel_params["subchain_len"]

    def da_run(steps, thin=None):
        kw = {"thin": thin} if thin else {}
        return da._launch(exact, surr, pos, pm, ps, 0.15, 7, steps, k, block, **kw)

    def pcn_run(pot):
        def run(steps, thin=None):
            kw = {"thin": thin} if thin else {}
            return fused_pcn._launch(pot, pos, pm, ps, 0.15, 7, steps, block, **kw)
        return run

    # sampler -> [(case, run, its plain twin over `steps` recorded steps,
    # steps compared, short and long launch for the slope)]
    cases = {
        "da": [("burgers_da_pcn", da_run,
                lambda s: da._run_plain_recorded(exact._forward_plain, surr._forward_plain, pos,
                                                 pm, ps, 0.15, 7, s, 1, k, block), 4, 4, 68)],
        "pcn": [(name, pcn_run(pot),
                 lambda s, pot=pot: fused_pcn._run_plain(pot._forward_plain, pos, pm, ps, 0.15,
                                                         7, s, block, thin=1), 8, 8, 264)
                for name, pot in (("burgers_pcn", pcn_p.batched_potential_fn),
                                  ("burgers_multitime_pcn", multi_p.batched_potential_fn))],
    }
    rows = []
    for sampler, (source, name, kernel) in KERNELS.items():
        m = line_re(name).search((_build.CSRC / source).read_text())
        shipped = (int(m.group(1)), int(m.group(2)))
        patches = {d: [(source, m.group(0), design_line(name, *d))]
                   for d in LINES if d != shipped}
        if sampler == "da":
            patches[(*shipped, "exact level through L2")] = [(source, a, b)
                                                             for a, b in EXACT_THROUGH_L2]
        builds = build_patch_sets(_build, (source,), patches, f"burgers_{sampler}_warp")
        libs, ptxas = {shipped: shipped_lib}, {shipped: ptxas_row(_build.BUILD_DIR, kernel)}
        for d in patches:
            if isinstance(builds[d], str):
                print(f"{sampler} {label(d)}: not built ({builds[d]})", flush=True)
                rows.append({"sampler": sampler, "design": label(d), "refused": builds[d]})
                continue
            libs[d], ptxas[d] = load_with(_build, builds[d][0]), ptxas_row(builds[d][1], kernel)
        for d in libs:
            print(f"({sampler} {label(d)}) {kernel}: registers, spill stores, spill loads "
                  f"{ptxas[d]}", flush=True)
        twins = {case: plain(steps) for case, _, plain, steps, _, _ in cases[sampler]}
        ref = {}
        for d in (*libs, shipped):
            _build._lib = libs[d]
            row = {"sampler": sampler, "design": label(d), "ptxas": ptxas[d]}
            for case, run, _, steps, short, long in cases[sampler]:
                got = run(steps, thin=1)
                ref.setdefault(case, got)
                equal = all(torch.equal(a, b) for a, b in zip(got, ref[case]))
                twin = twins[case]
                dev = torch.maximum((got[0] - twin[0]).abs().amax(dim=1),
                                    (got[2] - twin[2]).abs().amax(dim=(0, 2)))
                frac = float((dev <= CHAIN_ATOL).double().mean())
                ms = slope_ms(run, short, long)
                row[case] = {"ms_per_step": ms, "accept": float(got[1].mean()),
                             "equal_to_shipped": equal, "frac_within_atol_of_twin": frac}
                print(f"{label(d)}: {case} {ms:.4f} ms a step ({n} chains; acceptance over "
                      f"{steps} steps {float(got[1].mean()):.4f}; chains equal to the shipped "
                      f"design's {equal}; {frac:.4f} within {CHAIN_ATOL} of the plain twin)",
                      flush=True)
            rows.append(row)
        _build._lib = shipped_lib
    print(json.dumps({"card": card, "n_chains": n, "designs": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
