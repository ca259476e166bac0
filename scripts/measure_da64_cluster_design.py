"""The design of the two 64x64 Darcy kernels that run in thread-block
clusters, on one card: chains a cluster, the CTA's layout, and what runs
the preconditioner's products.

    python scripts/measure_da64_cluster_design.py

``fused_da_pcn_cluster_kernel`` (``darcy64_da_fused``) and
``fused_pcn_warm_cluster_kernel`` (``darcy64_pcn_warm``) take their design
from one line of ``csrc/darcy_misfit.cuh``, ``ClusterDesign``: ``kG``
chains (CTAs) a cluster, the CTA's layout (``kCells`` cells a thread at
64x64 on ``kThreads`` threads, ``kMinCtas`` CTAs an SM for the launch
bound) and where the surrogate's dst_trunc products run
(``kSurrMmaCoef``, ``kSurrMmaBack``: its V·r and Vᵀ·coef as bf16
``mma.sync`` on the tensor cores, else as f32 FMAs on the CUDA cores; the
exact level's run on the tensor cores). This builds the two
sources once for each alternative with that line patched, all compilers
started together; prints the registers and spills that ptxas reports for
both kernels; and times one outer step of ``darcy64_da_fused`` (1024
chains, blocks of 128, k = 48) and one step of ``darcy64_pcn_warm`` (2048
chains, blocks of 128) under each, as the slope between two launch
lengths, in the order shipped, alternatives, shipped. Beside each time:
the share of the DA chains (1024, 2 outer steps) within 1e-4 of the plain
twin's, which ``chip_smoke.py`` holds at 0.99 or more (the designs sum in
other orders, so chains agree to rounding, not to the bit), and both
kernels' acceptance. A design whose shared memory a
CTA cannot have, or whose cluster the card cannot place, is reported and
not run; so is keeping each CTA's slices of the modes resident in shared
memory (counted here, not built). Last, the shipped design at k = 0 (the
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

HEADER = "darcy_misfit.cuh"
UNITS = ("fused_da_pcn.cu", "fused_pcn.cu")
# (G, cells a thread, threads, CTAs an SM; on mma.sync: the surrogate's
# V.r, its V^T.coef)
DESIGNS = [(8, 8, 512, 2, True, True), (8, 8, 512, 2, False, True),
           (8, 8, 512, 2, False, False), (2, 8, 512, 2, True, False),
           (4, 8, 512, 2, True, False), (16, 8, 512, 2, True, False),
           (8, 4, 1024, 1, True, False), (8, 8, 512, 1, True, False)]
LINE = re.compile(r"struct ClusterDesign \{ static constexpr int kG = (\d+), kCells = (\d+), "
                  r"kThreads = (\d+), kMinCtas = (\d+); static constexpr bool "
                  r"kSurrMmaCoef = (\w+), kSurrMmaBack = (\w+); \};")
KERNELS = ("fused_da_pcn_cluster_kernel", "fused_pcn_warm_cluster_kernel")


def design_line(g, cells, threads, ctas, coef_mma, back_mma) -> str:
    b = lambda v: "true" if v else "false"  # noqa: E731
    return (f"struct ClusterDesign {{ static constexpr int kG = {g}, kCells = {cells}, "
            f"kThreads = {threads}, kMinCtas = {ctas}; static constexpr bool "
            f"kSurrMmaCoef = {b(coef_mma)}, kSurrMmaBack = {b(back_mma)}; }};")


def label(d) -> str:
    g, cells, threads, ctas, coef_mma, back_mma = d
    what = lambda v: "mma.sync" if v else "CUDA cores"  # noqa: E731
    return (f"G={g}, {cells} cells x {threads} threads x {ctas} CTA/SM, surrogate V.r "
            f"{what(coef_mma)}, V^T.coef {what(back_mma)}")


def resident_v_bytes(g, threads=512):
    """Shared memory of a CTA that kept its slices of both levels' modes for
    the launch: V.r needs a rows slice (modes / G rows of every cell), V^T
    coef a columns slice (every mode on cells / G cells), at 64x64 (256
    modes) and 32x32 (128), beside the geometry's own bytes."""
    from ip_mcmc_tpu_torch.ops import _cluster

    v = sum(2 * (modes // g) * cells + 2 * modes * (cells // g)
            for cells, modes in ((4096, 256), (1024, 128)))
    return v + _cluster.cluster_geometry(1024, 128, G=g, threads=threads)[3]


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    from ip_mcmc_tpu_torch import configs, ops
    from ip_mcmc_tpu_torch.ops import _build, _cluster

    card = card_line()
    print(f"card: {card}")
    shipped_lib = _build.library()
    m = LINE.search((_build.CSRC / HEADER).read_text())
    shipped = tuple(int(v) for v in m.groups()[:4]) + tuple(v == "true" for v in m.groups()[4:])
    rows = []
    for g in (16, 8):
        b = resident_v_bytes(g)
        why = f"{b} bytes of shared memory a CTA: the card gives {_cluster.MAX_SMEM_BYTES}"
        print(f"G={g}, modes resident in shared memory: "
              f"{'not run (' + why + ')' if b > _cluster.MAX_SMEM_BYTES else why}", flush=True)
        rows.append({"design": f"G={g}, modes resident", "smem_bytes": b, "refused":
                     b > _cluster.MAX_SMEM_BYTES})
    alternatives = [d for d in DESIGNS if d != shipped]
    builds = build_designs(_build, HEADER, UNITS, m.group(0),
                           {d: design_line(*d) for d in alternatives}, "cluster")
    for d in [d for d in alternatives if isinstance(builds[d], str)]:
        print(f"{label(d)}: not built ({builds[d]})", flush=True)
        rows.append({"design": label(d), "refused": builds[d]})
        alternatives.remove(d)
    libs = {shipped: shipped_lib}
    for k in KERNELS:
        print_ptxas(_build.BUILD_DIR, label(shipped), k)
    for d in alternatives:
        libs[d] = load_with(_build, builds[d][0])
        for k in KERNELS:
            print_ptxas(builds[d][1], label(d), k)

    da_p = configs.build("darcy64_da_fused", "cuda")
    exact, surr = da_p.batched_potential_fn, da_p.batched_surrogate_fn
    k = da_p.kernel_params["subchain_len"]
    da_pos = da_p.init_positions(torch.Generator().manual_seed(5), da_p.n_chains).cuda()
    pcn_p = configs.build("darcy64_pcn_warm", "cuda")
    warm, aux_dim = pcn_p.batched_warm_potential
    pcn_pos = pcn_p.init_positions(torch.Generator().manual_seed(6), pcn_p.n_chains).cuda()

    def da(steps, sub=k):
        return ops.fused_da_pcn_chain(exact, surr, da_pos, da_p.prior.mean, da_p.prior.scale,
                                      da_p.kernel_params["beta"], 7, n_steps=steps,
                                      subchain_len=sub, block_chains=128)

    def pcn(steps):
        return ops.fused_pcn_chain_warm(warm, pcn_pos, pcn_p.prior.mean, pcn_p.prior.scale,
                                        pcn_p.kernel_params["beta"], 7, n_steps=steps,
                                        aux_dim=aux_dim, block_chains=128)

    # the plain twin of the DA kernel on the same start, seed and steps
    from ip_mcmc_tpu_torch.ops import fused_da_pcn
    twin = fused_da_pcn._run_plain(exact._forward_plain, surr._forward_plain, da_pos,
                                   da_p.prior.mean, da_p.prior.scale,
                                   da_p.kernel_params["beta"], 7, 2, k, 128)[0]
    for d in (shipped, *alternatives, shipped):
        _build._lib = libs[d]
        try:
            got = da(2)
            pcn_acc = float(pcn(8)[1].mean())
        except RuntimeError as e:  # a cluster the card cannot place
            print(f"{label(d)}: not run ({e})", flush=True)
            rows.append({"design": label(d), "refused": str(e)})
            continue
        da_acc = float(got[1].mean())
        frac = float(((got[0] - twin).abs().amax(dim=1) <= 1e-4).double().mean())
        da_ms, pcn_ms = slope_ms(da, 2, 6), slope_ms(pcn, 4, 36)
        rows.append({"design": label(d), "da_ms_per_outer_step": da_ms, "da_accept_2_steps":
                     da_acc, "da_frac_within_1e-4_of_twin": frac, "pcn_ms_per_step": pcn_ms,
                     "pcn_accept_8_steps": pcn_acc})
        print(f"{label(d)}: darcy64_da_fused {da_ms:.4f} ms an outer step (acceptance over 2 "
              f"steps {da_acc:.4f}, {frac:.4f} of chains within 1e-4 of the plain twin); "
              f"darcy64_pcn_warm {pcn_ms:.4f} ms a step (acceptance over 8 steps "
              f"{pcn_acc:.4f})", flush=True)
    _build._lib = shipped_lib
    split = {sub: slope_ms(lambda s: da(s, sub), 2, 6) for sub in (0, k)}
    per_surr = (split[k] - split[0]) / k
    print(f"shipped design: {split[0]:.4f} ms an outer step at k = 0 (the exact correction), "
          f"{split[k]:.4f} at k = {k}: {per_surr:.5f} ms a surrogate step "
          f"({da_p.n_chains} chains)", flush=True)
    print(json.dumps({"card": card, "designs": rows, "exact_only_ms": split[0],
                      "da_ms": split[k], "surrogate_step_ms": per_surr}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
