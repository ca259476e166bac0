"""The design of K16's one-launch burn-in (``fused_pcn_adapt_group_kernel``)
on one card: chains a CTA, CTAs a cluster, how the block's p travel, and
what the host loop costs.

    python scripts/measure_pcn_adapt_design.py

``fused_pcn_adapt_group_kernel`` (``csrc/fused_pcn_adapt.cu``) runs the
whole adaptive burn-in in one launch, each block of chains on one
thread-block cluster, a chain on each group of d lanes; it takes its design
from one line, ``PcnAdaptGroupDesign``: warps a CTA (W), chains that each
group runs in turn (T), CTAs a cluster at most, CTAs an SM for the launch
bound. Once a step each chain stores its p into every CTA of its cluster
(distributed shared memory), one cluster barrier, and every warp folds the
block's p from its own CTA's copy ("push"). At the shipped shape
(lingauss_pcn's misfit, d = 32, m = 16, 2048 chains in blocks of 256) the
alternatives are

    (a) 16 CTAs of 16 warps a cluster, a chain a warp (a non-portable
        cluster size; also with 2 CTAs an SM at 64 registers, and as 16
        CTAs of 8 warps running 2 chains each in turn, 2 CTAs an SM);
    (b) a portable cluster of 8 CTAs: 32 warps a CTA under the 64-register
        bound that 1024 threads give, or 16 warps each running 2 chains in
        turn;
    (c) one CTA a block, 8 of 132 SMs busy: 32 warps running 8 chains each
        in turn, or 16 warps running 16 each (the chains' state in
        registers, spilled where it does not fit);
    pull: (a) and (b) with each chain's p stored in its own CTA only and
        read after the barrier through distributed shared memory, by one
        warp a CTA that hands log beta on behind a CTA barrier, or (e) by
        every warp (256 remote reads a warp and a step, no CTA barrier);
    (d) the parent's host loop, two launches a step, captured for the
        whole burn-in in one CUDA graph (``torch.cuda.graphs``): how much
        of the loop's cost is the host alone. Not a design of the kernel.

Two more rows take the shipped design apart (their beta is not the
block's, so their bits differ): without the fold (the stores and the
barrier kept, log beta left as it is), and the chain's step alone (no
store, no barrier, no fold).

This builds ``fused_pcn_adapt.cu`` once for each alternative with the
design line or the code patched, all compilers started together
(``scripts/_kernel_variants.py``); prints the registers and spills that
ptxas reports and how many such clusters the card holds at once
(``cudaOccupancyMaxActiveClusters``); and times one step of each as the
slope between burn-ins of 20 and 2020 steps (five of each), in the order
shipped, alternatives, shipped, then the host loop without and with the
graph. Every design runs the same chains from the same start and seed;
beside each time, whether its outputs (final state, acceptance rates and
beta after 20 steps) equal the shipped design's and the host loop's bit
for bit. Prints the card's name and power limit and one JSON line.
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import re
import sys

import torch

from _kernel_variants import build_patch_sets, card_line, event_ms, load_with, ptxas_row, slope_ms

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

SOURCE = "fused_pcn_adapt.cu"
STEPS, SHORT, LONG, REPS = 20, 20, 2020, 5
LINE = re.compile(r"struct PcnAdaptGroupDesign \{\n  static constexpr int kWarps = (\d+), "
                  r"kTurns = (\d+), kMaxCluster = (\d+), kMinCtas = (\d+);\n\};")
# (W, T, CTAs a cluster at most, CTAs an SM for the launch bound)
LINES = {
    "(a) 16 CTAs x 16 warps": (16, 1, 16, 1),
    "(a) 16 CTAs x 16 warps, 2 CTAs an SM (64 registers)": (16, 1, 16, 2),
    "(a) 16 CTAs x 8 warps x 2 chains, 2 CTAs an SM": (8, 2, 16, 2),
    "(b) 8 CTAs x 32 warps (64 registers)": (32, 1, 8, 1),
    "(b) 8 CTAs x 16 warps x 2 chains": (16, 2, 8, 1),
    "(b) 8 CTAs x 8 warps x 4 chains": (8, 4, 8, 1),
    "(c) one CTA a block, 32 warps x 8 chains": (32, 8, 1, 1),
    "(c) one CTA a block, 16 warps x 16 chains": (16, 16, 1, 1),
}
# how the block's p travel and who folds them: the source holds one of the
# two push folds (each chain stores its p into every CTA of the cluster;
# after the barrier every warp folds its CTA's copy, or one warp does and a
# CTA barrier hands log beta on); the pull variants store p in the chain's
# own CTA only and read the block's through distributed shared memory
PUSH = """      if (x[turn].live)  // into every CTA of the cluster: lane t stores into CTAs t, t + G, ...
        for (int r = Ctx::t(); r < ctas; r += G)
          *cg::this_cluster().map_shared_rank(&pooled[i & 1u][x[turn].lane], r) = p;
"""
PULL_STORE = "      if (Ctx::t() == 0) pooled[i & 1u][x[turn].lane] = p;\n"
LOCAL = "pooled[i & 1u][e]"
REMOTE = "*cg::this_cluster().map_shared_rank(&pooled[i & 1u][e], e / kChains)"
READS = """#pragma unroll
    for (int k = 0; k < kFoldSlots; ++k) {
      const int e = static_cast<int>(threadIdx.x & 31) + 32 * k;
      v[k] = e < bc ? pooled[i & 1u][e] : 0.0f;
    }
"""
FOLD_CALL = """    // a block of kBlock (the shipped 256) folds with every round known at
    // compile time: a few adds and shuffles, no loop
    const float lb = bc == kBlock ? next_log_beta(fold_sum(v, kBlock), kBlock, gamma)
                                  : next_log_beta(fold_sum(v, bc), bc, gamma);
"""
FOLDS = {
    "every warp folds": ("    float v[kFoldSlots];  // every warp folds the block's p from its CTA's copy\n"
                         + READS + FOLD_CALL + "    set_beta(__shfl_sync(0xffffffffu, lb, 0));\n"),
    "one warp folds": ("    __shared__ float shared_log_beta;\n"
                       "    if (threadIdx.x < 32) {  // one warp folds the block's p from its CTA's copy\n"
                       "      float v[kFoldSlots];\n" + READS.replace("\n    ", "\n      ")
                       + FOLD_CALL.replace("\n    ", "\n      ").replace("    //", "      //", 1)
                       + "      if (threadIdx.x == 0) shared_log_beta = lb;\n    }\n"
                       "    __syncthreads();  // hands log beta on\n    set_beta(shared_log_beta);\n"),
}
BARRIER = ('    asm volatile("barrier.cluster.arrive.aligned;\\n" ::: "memory");\n',
           '    asm volatile("barrier.cluster.wait.aligned;\\n" ::: "memory");\n')
KERNEL = "fused_pcn_adapt_group_kernelILi32ELi32E"


def design_line(warps, turns, cluster, min_ctas) -> str:
    return (f"struct PcnAdaptGroupDesign {{\n  static constexpr int kWarps = {warps}, "
            f"kTurns = {turns}, kMaxCluster = {cluster}, kMinCtas = {min_ctas};\n}};")


def max_clusters(lib, pot, pos, block) -> int:
    """How many clusters of the design the card holds at once, from
    ``ipx_pcn_adapt_group_geometry``."""
    from ip_mcmc_tpu_torch.ops import _build, _scaffold

    d = pos.shape[1]
    args, _ = _scaffold.chain_args(pos, torch.zeros(d), torch.ones(d), 0, 1, block)
    out, spec = (ctypes.c_int * 5)(), pot.spec()
    _build.check(lib.ipx_pcn_adapt_group_geometry(ctypes.byref(spec), ctypes.byref(args), out),
                 "ipx_pcn_adapt_group_geometry")
    return int(out[4])


def graph_of(run, steps):
    """``run(steps)`` captured in one CUDA graph (after a warm-up on a side
    stream, as torch.cuda.graphs asks): (graph, its outputs)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run(steps)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = run(steps)
    return graph, out


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from ip_mcmc_tpu_torch import configs
    from ip_mcmc_tpu_torch.ops import _build, fused_pcn_adapt

    card = card_line()
    print(f"card: {card}", flush=True)
    shipped_lib = _build.library()
    pot, scale, _ = chip_smoke.lingauss_potential()
    n = configs.build("lingauss_pcn", "cuda").n_chains
    block = chip_smoke.LINGAUSS_BLOCK
    gen = torch.Generator().manual_seed(5)
    pos = (torch.randn(n, pot.K, generator=gen).cuda() * scale).contiguous()
    zeros = torch.zeros(pot.K, device="cuda")
    args = lambda s: (pos, zeros, scale, 0.5, 59, s, 0.3, 0.5, block)  # noqa: E731
    group = lambda s: fused_pcn_adapt._launch_group(pot, *args(s))  # noqa: E731
    steps = lambda s: fused_pcn_adapt._launch_steps(pot, *args(s))  # noqa: E731

    text = (_build.CSRC / SOURCE).read_text()
    m = LINE.search(text)
    shipped = tuple(int(m.group(i)) for i in range(1, 5))
    fold = next(k for k, v in FOLDS.items() if v in text)
    other = next(k for k in FOLDS if k != fold)
    labels = {v: k for k, v in LINES.items()}
    shipped_label = f"shipped: {labels.get(shipped, shipped)}, push, {fold}"

    def line(key):
        return [] if LINES[key] == shipped else [(SOURCE, m.group(0), design_line(*LINES[key]))]

    patches = {}
    for key in LINES:
        if LINES[key] != shipped:
            patches[f"{key}, push, {fold}"] = line(key)
        if not key.startswith("(c)"):
            patches[f"{key}, push, {other}"] = line(key) + [(SOURCE, FOLDS[fold], FOLDS[other])]
    for key in ("(a) 16 CTAs x 16 warps", "(b) 8 CTAs x 16 warps x 2 chains"):
        for how in FOLDS:
            fold_patch = [] if how == fold else [(SOURCE, FOLDS[fold], FOLDS[how])]
            patches[f"{key}, pull, {how}"] = line(key) + fold_patch + [
                (SOURCE, PUSH, PULL_STORE), (SOURCE, f"v[k] = e < bc ? {LOCAL}", f"v[k] = e < bc ? {REMOTE}")]
    patches["shipped, the fold's rounds at run time for every block"] = [
        (SOURCE, FOLD_CALL, "    const float lb = next_log_beta(fold_sum(v, bc), bc, gamma);\n")]
    # take the shipped design apart (not the block's beta: other bits)
    no_fold = (SOURCE, FOLDS[fold], "    (void)gamma;\n    (void)bc;\n")
    patches["shipped without the fold"] = [no_fold]
    patches["shipped, the chains' moves alone"] = [
        (SOURCE, PUSH, ""), (SOURCE, BARRIER[0], ""), (SOURCE, BARRIER[1], ""), no_fold]
    builds = build_patch_sets(_build, (SOURCE,), patches, "pcn_adapt")
    libs, logs = {shipped_label: shipped_lib}, {shipped_label: _build.BUILD_DIR}
    rows = []
    for key, built in builds.items():
        if isinstance(built, str):
            print(f"{key}: not built ({built})", flush=True)
            rows.append({"design": key, "refused": built})
            continue
        libs[key], logs[key] = load_with(_build, built[0]), built[1]

    two = steps(STEPS)
    order = [shipped_label, *(k for k in libs if k != shipped_label), shipped_label]
    ref = None
    for key in order:
        _build._lib = libs[key]
        row = {"design": key, "ptxas": ptxas_row(logs[key], KERNEL)}
        try:
            row["max_active_clusters"] = max_clusters(libs[key], pot, pos, block)
            got = group(STEPS)
            ref = ref or got
            row["equal_to_shipped"] = all(torch.equal(a, b) for a, b in zip(got, ref))
            row["equal_to_two_launches"] = all(torch.equal(a, b) for a, b in zip(got, two))
            row["ms_per_step"] = slope_ms(group, SHORT, LONG, REPS)
        except RuntimeError as err:  # a cluster that does not fit, a refused launch
            row["refused"] = str(err)
        row["accept"] = float(got[1].mean()) if "refused" not in row else None
        print(json.dumps(row), flush=True)
        rows.append(row)
    _build._lib = shipped_lib

    # the host loop (two launches a step), then the same captured in a graph
    row = {"design": "the host loop, two launches a step",
           "equal_to_shipped": all(torch.equal(a, b) for a, b in zip(two, ref)),
           "ms_per_step": slope_ms(steps, SHORT, 220, 3)}
    print(json.dumps(row), flush=True)
    rows.append(row)
    graphs = {s: graph_of(steps, s) for s in (SHORT, LONG)}
    t_short, t_long = (event_ms(graphs[s][0].replay, REPS) for s in (SHORT, LONG))
    row = {"design": "(d) the host loop captured in one CUDA graph",
           "equal_to_shipped": all(torch.equal(a, b) for a, b in zip(graphs[SHORT][1], ref)),
           "ms_per_step": (t_long - t_short) / (LONG - SHORT)}
    print(json.dumps(row), flush=True)
    rows.append(row)
    print(json.dumps({"card": card, "n_chains": n, "block": block, "designs": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
