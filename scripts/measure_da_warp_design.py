"""The design of the 16x16 delayed-acceptance kernel on one card: chains a
CTA, where the exact level's factors lie, and what runs the
preconditioner's products.

    python scripts/measure_da_warp_design.py

``fused_da_pcn_warp_kernel`` (``csrc/fused_da_pcn.cu``) runs one chain a
warp and takes its design from one line, ``DaWarpDesign``: ``kWarps``
chains a CTA (W), ``kSmWarps`` warps an SM for the launch bound (which caps
a thread's registers at 65536 / (32 kSmWarps)), ``kExactStaged`` (the exact
level's KL basis and modes staged in shared memory, else read through L2)
and ``kMma`` (the dst_trunc products as bf16 ``mma.sync`` on the tensor
cores, else as f32 loops on the CUDA cores). This builds
``fused_da_pcn.cu`` once for each alternative, with that line patched, all
compilers started together; prints the registers and spills that ptxas
reports for the kernel; and times one outer step of ``darcy_da_fused``
(4096 chains, blocks of 512, k = 48) under each, as the slope between two
launch lengths, in the order shipped, alternatives, shipped. Each run's
outer acceptance over 2 steps is printed beside its time: the designs sum
in other orders, so chains agree to rounding, not to the bit. A design
whose shared memory a CTA cannot have (W = 16 with the exact factors
staged) is reported and not run. Last, the shipped design at k = 0 (the
exact correction alone) against k = 48 splits an outer step between the
two levels. Prints the card's name and power limit and one JSON line.
"""

from __future__ import annotations

import json
import pathlib
import re
import sys

import torch

from _kernel_variants import build_designs, card_line, load_with, print_ptxas, slope_ms

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

SOURCE = "fused_da_pcn.cu"
# (W, warps an SM, exact factors staged, mma.sync)
DESIGNS = [(w, 24, staged, mma) for w in (4, 8, 16) for staged in (False, True)
           for mma in (True, False)] + [(8, 16, False, True), (8, 8, False, True)]
LINE = re.compile(r"struct DaWarpDesign \{ static constexpr int kWarps = (\d+), "
                  r"kSmWarps = (\d+); static constexpr bool kExactStaged = (\w+), "
                  r"kMma = (\w+); \};")


def design_line(w, sm_warps, staged, mma) -> str:
    b = lambda v: "true" if v else "false"  # noqa: E731
    return (f"struct DaWarpDesign {{ static constexpr int kWarps = {w}, kSmWarps = "
            f"{sm_warps}; static constexpr bool kExactStaged = {b(staged)}, kMma = {b(mma)}; }};")


def label(design) -> str:
    w, smw, staged, mma = design
    return (f"W={w}, {smw} warps/SM, exact factors {'staged' if staged else 'via L2'}, "
            f"{'mma.sync' if mma else 'CUDA-core loops'}")


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    from ip_mcmc_tpu_torch import configs, ops
    from ip_mcmc_tpu_torch.ops import _build
    from ip_mcmc_tpu_torch.ops import fused_da_pcn as da

    card = card_line()
    print(f"card: {card}")
    shipped_lib = _build.library()
    m = LINE.search((_build.CSRC / SOURCE).read_text())
    shipped = (int(m.group(1)), int(m.group(2)), m.group(3) == "true", m.group(4) == "true")
    p = configs.build("darcy_da_fused", "cuda")
    exact, surr = p.batched_potential_fn, p.batched_surrogate_fn
    n, block, k = 4096, 512, p.kernel_params["subchain_len"]
    fits, rows = [], []
    for d in [shipped] + [d for d in DESIGNS if d != shipped]:
        try:
            da.warp_geometry(n, block, chains=d[0], exact_staged=d[2])
            fits.append(d)
        except ValueError as e:
            print(f"{label(d)}: not run ({e})", flush=True)
            rows.append({"design": label(d), "ms_per_outer_step": None, "refused": str(e)})
    builds = build_designs(_build, SOURCE, (SOURCE,), m.group(0),
                           {d: design_line(*d) for d in fits[1:]}, "da_warp")
    failed = {label(d): b for d, b in builds.items() if isinstance(b, str)}
    if failed:
        raise RuntimeError(f"nvcc failed: {failed}")
    libs = {shipped: shipped_lib}
    print_ptxas(_build.BUILD_DIR, label(shipped), "fused_da_pcn_warp_kernel")
    for d in fits[1:]:
        libs[d] = load_with(_build, builds[d][0])
        print_ptxas(builds[d][1], label(d), "fused_da_pcn_warp_kernel")
    pos = p.init_positions(torch.Generator().manual_seed(5), n).cuda()

    def run(steps, sub=k):
        return ops.fused_da_pcn_chain(exact, surr, pos, p.prior.mean, p.prior.scale,
                                      p.kernel_params["beta"], 7, n_steps=steps,
                                      subchain_len=sub, block_chains=block)

    for d in (*fits, shipped):
        _build._lib = libs[d]
        acc = float(run(2)[1].mean())
        ms = slope_ms(run, 2, 6)
        rows.append({"design": label(d), "ms_per_outer_step": ms, "accept_2_steps": acc})
        print(f"darcy_da_fused 16x16 DA ({label(d)}): {ms:.4f} ms an outer step, "
              f"acceptance over 2 steps {acc:.4f}", flush=True)
    _build._lib = shipped_lib
    # where an outer step's time goes in the shipped design: the exact
    # correction alone (k = 0), then each surrogate solve's share
    split = {sub: slope_ms(lambda s: run(s, sub), 2, 6) for sub in (0, k)}
    per_surr = (split[k] - split[0]) / k
    print(f"shipped design: {split[0]:.4f} ms an outer step at k = 0 (the exact "
          f"correction), {split[k]:.4f} at k = {k}: {per_surr:.5f} ms a "
          f"surrogate step (4096 chains)", flush=True)
    print(json.dumps({"card": card, "n_chains": n, "block_chains": block, "k": k,
                      "designs": rows, "exact_only_ms": split[0],
                      "surrogate_step_ms": per_surr}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
