"""The design of the functional ensemble sampler's kernel, one chain a warp,
on one card: chains a CTA, registers, and what the host loop costs.

    python scripts/measure_fes_warp_design.py

``fused_fes_warp_kernel`` (``csrc/fused_fes.cu``) takes its design from one
line, ``FesWarpDesign``: ``kWarps`` chains a CTA at most (W), ``kSmWarps``
warps an SM for the launch bound (which caps a thread's registers at
65536 / (32 kSmWarps), or 64 when a CTA has 32 warps). A launch runs the
chains of one lane parity, two launches a step from the host, stream order
being the barrier between the sub-steps. This builds ``fused_fes.cu`` once
for each alternative with that line patched, all compilers started
together; prints the registers and spills that ptxas reports; and times one
step of ``darcy_fes_fused`` (4096 chains, blocks of 256) under each, as the
slope between two launch lengths, in the order shipped, alternatives,
shipped. Every design runs the same chains from the same start and seed;
beside each time, whether its chains (4 steps, final state and records)
equal the shipped design's bit for bit, and the acceptance.

Then, for the shipped design, the device time of the kernel's launches in
a profiled run of 20 steps (``torch.profiler``) beside the step's slope:
their difference is what the two launches a step cost beyond the kernels'
own time (gaps between launches, the host loop), the most that one launch
for all steps could save before it pays its own barriers. Prints the
card's name and power limit and one JSON line.
"""

from __future__ import annotations

import json
import pathlib
import re
import sys

import torch

from _kernel_variants import build_designs, card_line, load_with, ptxas_row, slope_ms

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

SOURCE = "fused_fes.cu"
LINE = re.compile(r"struct FesWarpDesign \{ static constexpr int kWarps = (\d+), "
                  r"kSmWarps = (\d+); \};")
KERNEL = "fused_fes_warp_kernelILb0"  # the mangled name of <false>
# (W, warps an SM for the launch bound)
DESIGNS = [(16, 16), (8, 16), (4, 16), (8, 24), (8, 32), (32, 32)]


def design_line(w, sm_warps) -> str:
    return (f"struct FesWarpDesign {{ static constexpr int kWarps = {w}, kSmWarps = "
            f"{sm_warps}; }};")


def label(d) -> str:
    return f"W={d[0]}, {d[1]} warps/SM bound"


def device_ms_per_step(run, steps):
    """The device time of the ensemble kernel's launches in one run of
    ``steps`` steps, per step, from torch.profiler's events (None if the
    profiler saw no device time)."""
    from torch.profiler import ProfilerActivity, profile

    run(2)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run(steps)
        torch.cuda.synchronize()
    us = sum(e.device_time_total for e in prof.key_averages()
             if "fused_fes_warp_kernel" in e.key)
    return us / 1e3 / steps if us > 0 else None


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    from ip_mcmc_tpu_torch import configs, ops
    from ip_mcmc_tpu_torch.ops import _build, fused_fes
    from ip_mcmc_tpu_torch.runner import _resolve_n_low_modes

    card = card_line()
    print(f"card: {card}")
    shipped_lib = _build.library()
    m = LINE.search((_build.CSRC / SOURCE).read_text())
    shipped = (int(m.group(1)), int(m.group(2)))
    alternatives = [d for d in DESIGNS if d != shipped]
    builds = build_designs(_build, SOURCE, (SOURCE,), m.group(0),
                           {d: design_line(*d) for d in alternatives}, "fes_warp")
    rows, libs, ptxas = [], {shipped: shipped_lib}, {shipped: ptxas_row(_build.BUILD_DIR, KERNEL)}
    for d in alternatives:
        if isinstance(builds[d], str):
            print(f"{label(d)}: not built ({builds[d]})", flush=True)
            rows.append({"design": label(d), "refused": builds[d]})
            continue
        libs[d], ptxas[d] = load_with(_build, builds[d][0]), ptxas_row(builds[d][1], KERNEL)
    for d in libs:
        smem = fused_fes.BASIS_BYTES + d[0] * fused_fes.WARP_SLICE_BYTES
        print(f"({label(d)}) {KERNEL}: registers, spill stores, spill loads {ptxas[d]}; "
              f"{smem} bytes of shared memory a CTA", flush=True)

    p = configs.build("darcy_fes_fused", "cuda")
    kp = p.kernel_params
    pot, n_low = p.batched_potential_fn, _resolve_n_low_modes(kp, p)
    pos = p.init_positions(torch.Generator().manual_seed(5), p.n_chains).cuda()
    args = (pot, pos, p.prior.mean, p.prior.scale, n_low, 7)
    kw = dict(pcn_beta=kp["pcn_beta"], stretch_a=kp.get("stretch_a", 2.0),
              block_chains=kp["block_chains"])

    def run(steps):
        return ops.fused_fes_chain(*args, n_steps=steps, **kw)

    ref = None
    for d in (*libs, shipped):
        _build._lib = libs[d]
        got = ops.fused_fes_chain_recorded(*args, n_steps=4, thin=1, **kw)
        ref = ref or got
        equal = all(torch.equal(a, b) for a, b in zip(got, ref))
        ms = slope_ms(run, 4, 20)
        rows.append({"design": label(d), "ms_per_step": ms, "accept_4_steps":
                     float(got[1].mean()), "equal_to_shipped": equal, "ptxas": ptxas[d]})
        print(f"{label(d)}: darcy_fes_fused {ms:.4f} ms a step (4096 chains, two launches; "
              f"pCN acceptance over 4 steps {float(got[1].mean()):.4f}; chains equal to the "
              f"shipped design's {equal})", flush=True)
    _build._lib = shipped_lib
    device = device_ms_per_step(run, 20)
    slope = slope_ms(run, 4, 20)
    loop = {"slope_ms": slope, "device_ms": device,
            "beyond_kernels_ms": None if device is None else slope - device}
    print(f"{label(shipped)}: a step {slope:.4f} ms (slope), the two launches' device time "
          + ("not measured (the profiler saw no device time)" if device is None else
             f"{device:.4f} ms: {slope - device:.4f} ms a step beyond the kernels' own time"),
          flush=True)
    print(json.dumps({"card": card, "n_chains": p.n_chains, "designs": rows,
                      "host_loop": loop}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
