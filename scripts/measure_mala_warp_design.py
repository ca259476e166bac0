"""The design of the MALA kernel, one chain a warp, on one card: chains a
CTA, registers, the order of the gradient's KL product, and where the warm
kernel keeps its carried solutions.

    python scripts/measure_mala_warp_design.py

``fused_mala_warp_kernel<RECORD, PRECOND>`` (``csrc/fused_mala.cu``) takes
W and its launch bound from one line, ``MalaWarpDesign``: ``kWarps``
chains a CTA at most (W), ``kSmWarps`` warps an SM for the launch bound
(which caps a thread's registers at 65536 / (32 kSmWarps), or 64 when a
CTA has 32 warps). Its gradient (``darcy_value_and_grad_warp`` in
``csrc/darcy_misfit.cuh``) takes each lane's partial sums of g = basis (a
(-dPhi/da)) in the one-chain-a-CTA kernel's order and reduces and
scatters them over the warp (lane L keeps mode L of each 32: the pairs of
``warp_sum``'s butterfly, 31 shuffles for 32 modes); the alternative here
is the one-chain-a-CTA kernel's own, a ``warp_sum`` a mode (160
shuffles for 32 modes). Both give the same bits. The warm kernel carries the
accepted state's forward and adjoint solutions in two slices of its
warp's shared memory; the alternative keeps them in 8 + 8 registers a lane
(the two slices stay allocated and unused, so the shared memory and the
CTAs an SM are the shipped ones). This builds ``fused_mala.cu`` once for
each alternative with that line (or that code) patched, all compilers
started together; prints the registers and spills that ptxas reports for
the cold and the warm kernel; and times one step of ``darcy_mala_fused``
(Jacobi / 48 + 48 CG) and of ``darcy_mala_warm`` (dense dst / 6 + 6 CG),
4096 chains in blocks of 256, under each, as the slope between two launch
lengths, in the order shipped, alternatives, shipped. Every design runs
the same chains from the same start and seed; beside each time, whether
its chains (8 steps, final state and records) equal the shipped design's
bit for bit, and the acceptance. Prints the card's name and power limit
and one JSON line.
"""

from __future__ import annotations

import json
import pathlib
import re
import sys

import torch

from _kernel_variants import build_patch_sets, card_line, load_with, ptxas_row, slope_ms

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

SOURCE, SOLVE = "fused_mala.cu", "darcy_misfit.cuh"
LINE = re.compile(r"struct MalaWarpDesign \{ static constexpr int kWarps = (\d+), "
                  r"kSmWarps = (\d+); \};")
# the mangled names of <false, kPrecondJacobi> and <false, kPrecondDst>
KERNELS = {"cold": "fused_mala_warp_kernelILb0ELi0E", "warm": "fused_mala_warp_kernelILb0ELi2E"}
# (W, warps an SM for the launch bound)
LINES = [(16, 16), (8, 16), (8, 24), (8, 32), (16, 32)]
# the shipped KL product's reduce-and-scatter, and a warp_sum a mode
SCATTER = """#pragma unroll
  for (int hb = 0; hb < 2; ++hb) {
    float v[32];
#pragma unroll
    for (int m = 0; m < 32; ++m) {
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) acc += lv.basis[(32 * hb + m) * kStride + 36 * j + l] * w[j];
      v[m] = acc;
    }
    scatter_level<16>(v);
    scatter_level<8>(v);
    scatter_level<4>(v);
    scatter_level<2>(v);
    scatter_level<1>(v);
    g[hb] = v[0];
  }
"""
SHUFFLE = """  for (int m = 0; m < 2 * 32; ++m) {
    float acc = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc += lv.basis[m * kStride + 36 * j + l] * w[j];
    acc = warp_sum(acc);
    if (m == l) g[0] = acc;
    if (m == l + 32) g[1] = acc;
  }
"""
# the warm carry in registers: cx, cl in place of the slices xs, ls
REGISTERS = [
    (SOURCE, "  float phi, g[2];\n", "  float phi, g[2];\n  float cx[8], cl[8];\n"),
    (SOURCE, "xs[Level::at(k)] = x.live ?", "cx[k] = x.live ?"),
    (SOURCE, "ls[Level::at(k)] = x.live ?", "cl[k] = x.live ?"),
    (SOURCE, "kWarm ? xs[Level::at(k)] : 0.0f", "kWarm ? cx[k] : 0.0f"),
    (SOURCE, "kWarm ? ls[Level::at(k)] : 0.0f", "kWarm ? cl[k] : 0.0f"),
    (SOURCE, "xs[Level::at(k)] = xf[Level::at(k)];", "cx[k] = xf[Level::at(k)];"),
    (SOURCE, "ls[Level::at(k)] = lv.ws.th[Level::at(k)];", "cl[k] = lv.ws.th[Level::at(k)];"),
]


def design_line(w, sm_warps) -> str:
    return (f"struct MalaWarpDesign {{ static constexpr int kWarps = {w}, kSmWarps = "
            f"{sm_warps}; }};")


def label(d) -> str:
    return f"W={d[0]}, {d[1]} warps/SM bound" + (f", {d[2]}" if len(d) > 2 else "")


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    from ip_mcmc_tpu_torch import configs
    from ip_mcmc_tpu_torch.ops import _build, fused_mala

    card = card_line()
    print(f"card: {card}")
    shipped_lib = _build.library()
    m = LINE.search((_build.CSRC / SOURCE).read_text())
    shipped = (int(m.group(1)), int(m.group(2)))
    patches = {d: [(SOURCE, m.group(0), design_line(*d))] for d in LINES if d != shipped}
    patches[(*shipped, "KL product a warp_sum a mode")] = [(SOLVE, SCATTER, SHUFFLE)]
    patches[(*shipped, "warm carry in registers")] = REGISTERS
    alternatives = list(patches)
    builds = build_patch_sets(_build, (SOURCE,), patches, "mala_warp")
    rows, libs = [], {shipped: shipped_lib}
    ptxas = {shipped: {k: ptxas_row(_build.BUILD_DIR, v) for k, v in KERNELS.items()}}
    for d in alternatives:
        if isinstance(builds[d], str):
            print(f"{label(d)}: not built ({builds[d]})", flush=True)
            rows.append({"design": label(d), "refused": builds[d]})
            continue
        libs[d] = load_with(_build, builds[d][0])
        ptxas[d] = {k: ptxas_row(builds[d][1], v) for k, v in KERNELS.items()}
    for d in libs:
        print(f"({label(d)}) registers, spill stores, spill loads: cold {ptxas[d]['cold']}, "
              f"warm {ptxas[d]['warm']}", flush=True)

    p = configs.build("darcy_mala_warm", "cuda")
    pm, ps = p.prior.mean, p.prior.scale
    eps, block = p.kernel_params["step_size"], p.kernel_params["block_chains"]
    pos = p.init_positions(torch.Generator().manual_seed(5), p.n_chains).cuda()
    jacobi = p.batched_potential_fn
    pag, aux_dim = p.batched_warm_potential
    cases = {"cold": (jacobi, {}), "warm": (pag, {"aux_dim": aux_dim})}

    def runner(pot, kw, thin=None):
        extra = dict(kw, thin=thin) if thin else kw
        return lambda steps: fused_mala._launch(pot, pos, pm, ps, eps, 7, steps, block, **extra)

    ref = {}
    for d in (*libs, shipped):
        _build._lib = libs[d]
        row = {"design": label(d), "ptxas": ptxas[d]}
        for kind, (pot, kw) in cases.items():
            got = runner(pot, kw, thin=1)(8)
            ref.setdefault(kind, got)
            equal = all(torch.equal(a, b) for a, b in zip(got, ref[kind]))
            ms = slope_ms(runner(pot, kw), 4, 36)
            row[kind] = {"ms_per_step": ms, "accept_8_steps": float(got[1].mean()),
                         "equal_to_shipped": equal}
            print(f"{label(d)}: {kind} {ms:.4f} ms a step ({p.n_chains} chains; acceptance "
                  f"over 8 steps {float(got[1].mean()):.4f}; chains equal to the shipped "
                  f"design's {equal})", flush=True)
        rows.append(row)
    _build._lib = shipped_lib
    print(json.dumps({"card": card, "n_chains": p.n_chains, "designs": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
