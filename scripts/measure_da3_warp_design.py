"""The design of the three-level Burgers DA kernel, one chain a warp, on one
card: chains a CTA, registers, and how a lane reaches its neighbours' cells.

    python scripts/measure_da3_warp_design.py

``fused_da3_pcn_warp_kernel`` (``csrc/fused_da3_pcn.cu``) takes its design
from one line, ``Da3WarpDesign``: ``kWarps`` chains a CTA at most (W),
``kSmWarps`` warps an SM for the launch bound (which caps a thread's
registers at 65536 / (32 kSmWarps)). Its solve (``burgers_phi_warp`` in
``csrc/burgers_misfit.cuh``) fetches the edge cells of the neighbouring
lanes by two shuffles (``edge_cells``); the alternative here writes them to
64 floats of shared memory a warp (a static 8 KB a CTA for each of the two
cell counts) and reads them back behind ``__syncwarp``. This
builds ``fused_da3_pcn.cu`` once for each alternative with that line (or
that function) patched, all compilers started together; prints the
registers and spills that ptxas reports; and times one outer step of
``burgers_da3_pcn`` (2048 chains, blocks of 512, k_inner 8, k_mid 24) under
each, as the slope between two launch lengths, in the order shipped,
alternatives, shipped. Every design runs the same chains from the same
start and seed; beside each time, whether its chains (2 outer steps, final
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

SOURCE, SOLVE = "fused_da3_pcn.cu", "burgers_misfit.cuh"
LINE = re.compile(r"struct Da3WarpDesign \{ static constexpr int kWarps = (\d+), "
                  r"kSmWarps = (\d+); \};")
KERNEL = "fused_da3_pcn_warp_kernelILb0"  # the mangled name of <false>
# (W, warps an SM for the launch bound)
DESIGNS = [(16, 16), (8, 16), (4, 16), (16, 32), (8, 32)]
# the shipped exchange of edge cells, and the alternative through 64 floats
# of shared memory a warp (each lane's first and last cell)
SHUFFLES = """  left = __shfl_sync(0xffffffffu, v[C - 1], (l + 31) & 31);
  right = __shfl_sync(0xffffffffu, v[0], (l + 1) & 31);
"""
SHARED = """  __shared__ float xch_cta[32][64];
  float* xch = xch_cta[threadIdx.x >> 5];
  xch[l] = v[0];
  xch[32 + l] = v[C - 1];
  __syncwarp();
  left = xch[32 + ((l + 31) & 31)];
  right = xch[(l + 1) & 31];
  __syncwarp();  // the reads end before the next step's writes
"""


def design_line(w, sm_warps) -> str:
    return (f"struct Da3WarpDesign {{ static constexpr int kWarps = {w}, kSmWarps = "
            f"{sm_warps}; }};")


def label(d) -> str:
    return f"W={d[0]}, {d[1]} warps/SM bound" + (", edge cells via shared memory"
                                                  if len(d) > 2 else "")


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    from ip_mcmc_tpu_torch import configs, ops
    from ip_mcmc_tpu_torch.ops import _build, fused_da3_pcn

    card = card_line()
    print(f"card: {card}")
    shipped_lib = _build.library()
    m = LINE.search((_build.CSRC / SOURCE).read_text())
    shipped = (int(m.group(1)), int(m.group(2)))
    alternatives = [d for d in DESIGNS if d != shipped]
    builds = build_designs(_build, SOURCE, (SOURCE,), m.group(0),
                           {d: design_line(*d) for d in alternatives}, "da3_warp")
    shared = (*shipped, "shared")
    builds.update(build_designs(_build, SOLVE, (SOURCE,), SHUFFLES, {shared: SHARED},
                                "da3_xchg"))
    alternatives.append(shared)
    rows, libs, ptxas = [], {shipped: shipped_lib}, {shipped: ptxas_row(_build.BUILD_DIR, KERNEL)}
    for d in alternatives:
        if isinstance(builds[d], str):
            print(f"{label(d)}: not built ({builds[d]})", flush=True)
            rows.append({"design": label(d), "refused": builds[d]})
            continue
        libs[d], ptxas[d] = load_with(_build, builds[d][0]), ptxas_row(builds[d][1], KERNEL)
    p = configs.build("burgers_da3_pcn", "cuda")
    levels = (p.batched_potential_fn, p.batched_mid_fn, p.batched_surrogate_fn)
    kp = p.kernel_params
    for d in libs:
        smem = (4 * fused_da3_pcn.LEVEL_FLOATS * sum(lv.n for lv in levels)
                + d[0] * fused_da3_pcn.WARP_SLICE_BYTES + (16384 if len(d) > 2 else 0))
        print(f"({label(d)}) {KERNEL}: registers, spill stores, spill loads {ptxas[d]}; "
              f"{smem} bytes of shared memory a CTA", flush=True)

    pos = p.init_positions(torch.Generator().manual_seed(5), p.n_chains).cuda()
    kw = dict(k_inner=kp["k_inner"], k_mid=kp["k_mid"], block_chains=512)

    def run(steps):
        return ops.fused_da3_pcn_chain(*levels, pos, p.prior.mean, p.prior.scale, kp["beta"], 7,
                                       n_steps=steps, **kw)

    ref = None
    for d in (*libs, shipped):
        _build._lib = libs[d]
        got = ops.fused_da3_pcn_chain_recorded(*levels, pos, p.prior.mean, p.prior.scale,
                                               kp["beta"], 7, n_steps=2, thin=1, **kw)
        ref = ref or got
        equal = all(torch.equal(a, b) for a, b in zip(got, ref))
        ms = slope_ms(run, 2, 10)
        rows.append({"design": label(d), "ms_per_outer_step": ms, "accept_2_steps":
                     float(got[1].mean()), "equal_to_shipped": equal, "ptxas": ptxas[d]})
        print(f"{label(d)}: burgers_da3_pcn {ms:.4f} ms an outer step (2048 chains; fine "
              f"acceptance over 2 steps {float(got[1].mean()):.4f}; chains equal to the shipped "
              f"design's {equal})", flush=True)
    _build._lib = shipped_lib
    print(json.dumps({"card": card, "n_chains": p.n_chains, "designs": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
