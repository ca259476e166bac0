"""The design of the 32x32 warm pCN kernel that runs in thread-block
clusters, on one card: chains a cluster and the CTA's layout.

    python scripts/measure_pcn32_cluster_design.py

``fused_pcn_warm_cluster32_kernel`` (``darcy32_pcn_warm``) takes its
design from one line of ``csrc/darcy_misfit.cuh``, ``Cluster32Design``:
``kG`` chains (CTAs) a cluster, ``kCells`` cells a thread on ``kThreads``
threads, ``kMinCtas`` CTAs an SM for the launch bound. Every design reads
the factors through L2 and runs both of the preconditioner's products as
bf16 ``mma.sync`` on the tensor cores. This builds ``fused_pcn.cu`` once
for each alternative with that line patched, all compilers started
together; prints the registers and spills that ptxas reports and the
shared memory of a CTA; and times one step of ``darcy32_pcn_warm`` (4096
chains, blocks of 128) under each, as the slope between two launch
lengths, in the order shipped, alternatives, shipped. Beside each time:
the share of the chains (8 steps, final state and records) within 1e-4 of
the plain twin's, which ``chip_smoke.py`` holds at 0.99 or more, and the
acceptance. A design that does not build or whose cluster the card cannot
place is reported and not run. Prints the card's name and power limit and
one JSON line.
"""

from __future__ import annotations

import json
import pathlib
import re
import sys

import torch

from _kernel_variants import build_designs, card_line, load_with, ptxas_row, slope_ms

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

HEADER = "darcy_misfit.cuh"
LINE = re.compile(r"struct Cluster32Design \{ static constexpr int kG = (\d+), kCells = (\d+), "
                  r"kThreads = (\d+), kMinCtas = (\d+); \};")
KERNEL = "fused_pcn_warm_cluster32_kernelILb0"  # the mangled name of <false>
# (G, cells a thread, threads, CTAs an SM for the launch bound)
DESIGNS = [(8, 8, 128, 8), (8, 8, 128, 7), (8, 8, 128, 6), (8, 4, 256, 4), (8, 4, 256, 5),
           (8, 4, 256, 3), (4, 4, 256, 4), (16, 4, 256, 4), (8, 2, 512, 2), (8, 1, 1024, 1)]


def design_line(g, cells, threads, ctas) -> str:
    return (f"struct Cluster32Design {{ static constexpr int kG = {g}, kCells = {cells}, "
            f"kThreads = {threads}, kMinCtas = {ctas}; }};")


def label(d) -> str:
    g, cells, threads, ctas = d
    return f"G={g}, {cells} cells x {threads} threads, launch bound {ctas} CTA/SM"


def smem_bytes(d) -> int:
    from ip_mcmc_tpu_torch.ops import _cluster

    return _cluster.smem_bytes32(d[0], d[2])


def ctas_per_sm(d, registers) -> int:
    """CTAs an SM by the launch's threads, registers (in units of 256 a
    warp) and shared memory (228 KB an SM, 1 KB of it reserved a CTA)."""
    threads = d[2]
    regs = -(-registers * 32 // 256) * 256 * (threads // 32)
    return min(2048 // threads, 65536 // regs, 233_472 // (smem_bytes(d) + 1024))


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    from ip_mcmc_tpu_torch import configs, ops
    from ip_mcmc_tpu_torch.ops import _build, fused_pcn

    card = card_line()
    print(f"card: {card}")
    shipped_lib = _build.library()
    m = LINE.search((_build.CSRC / HEADER).read_text())
    shipped = tuple(int(v) for v in m.groups())
    alternatives = [d for d in DESIGNS if d != shipped]
    builds = build_designs(_build, HEADER, ("fused_pcn.cu",), m.group(0),
                           {d: design_line(*d) for d in alternatives}, "pcn32")
    rows, libs, ptxas = [], {shipped: shipped_lib}, {shipped: ptxas_row(_build.BUILD_DIR, KERNEL)}
    for d in alternatives:
        if isinstance(builds[d], str):
            print(f"{label(d)}: not built ({builds[d]})", flush=True)
            rows.append({"design": label(d), "refused": builds[d]})
            continue
        libs[d], ptxas[d] = load_with(_build, builds[d][0]), ptxas_row(builds[d][1], KERNEL)
    for d in libs:
        print(f"({label(d)}) {KERNEL}: registers, spill stores, spill loads {ptxas[d]}; "
              f"{smem_bytes(d)} bytes of shared memory a CTA, "
              f"{ctas_per_sm(d, ptxas[d][0])} CTAs an SM", flush=True)

    p = configs.build("darcy32_pcn_warm", "cuda")
    warm, aux_dim = p.batched_warm_potential
    pos = p.init_positions(torch.Generator().manual_seed(6), p.n_chains).cuda()
    args = (pos, p.prior.mean, p.prior.scale, p.kernel_params["beta"], 7)

    def run(steps):
        return ops.fused_pcn_chain_warm(warm, *args, n_steps=steps, aux_dim=aux_dim,
                                        block_chains=128)

    twin = fused_pcn._run_plain(warm._forward_warm_plain, *args, 8, 128, thin=1,
                                aux_dim=aux_dim)
    for d in (*libs, shipped):
        _build._lib = libs[d]
        try:
            got = ops.fused_pcn_chain_warm_recorded(warm, *args, n_steps=8, thin=1,
                                                    aux_dim=aux_dim, block_chains=128)
        except RuntimeError as e:  # a cluster the card cannot place
            print(f"{label(d)}: not run ({e})", flush=True)
            rows.append({"design": label(d), "refused": str(e)})
            continue
        dev = torch.maximum((got[0] - twin[0]).abs().amax(dim=1),
                            (got[2] - twin[2]).abs().amax(dim=(0, 2)))
        frac = float((dev <= 1e-4).double().mean())
        ms = slope_ms(run, 4, 36)
        rows.append({"design": label(d), "ms_per_step": ms, "accept_8_steps": float(got[1].mean()),
                     "frac_within_1e-4_of_twin": frac, "ptxas": ptxas[d],
                     "smem_bytes": smem_bytes(d), "ctas_per_sm": ctas_per_sm(d, ptxas[d][0])})
        print(f"{label(d)}: darcy32_pcn_warm {ms:.4f} ms a step (4096 chains; acceptance over 8 "
              f"steps {float(got[1].mean()):.4f}, {frac:.4f} of chains within 1e-4 of the plain "
              f"twin)", flush=True)
    _build._lib = shipped_lib
    print(json.dumps({"card": card, "n_chains": p.n_chains, "designs": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
