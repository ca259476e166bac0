"""The CTA layouts of the large Darcy grids on one card: cells per thread,
threads per CTA and the launch bound's CTAs per SM.

    python scripts/measure_darcy_layouts.py

``csrc/darcy_misfit.cuh`` ships one layout per grid class (``Layout32``,
``Layout64``). This builds a copy of ``csrc/`` for each alternative with
that one line patched (``_kernel_variants.build_patched``), prints the
registers and spills that ptxas reports for the warm pCN kernel, and times
one step of ``darcy32_pcn_warm`` (4096 chains) and ``darcy64_pcn_warm``
(2048 chains) at full width under each, as the slope between two launch
lengths, in the order shipped, alternatives, shipped. Each run's acceptance
is printed beside its time: the layouts sum in other orders, so the chains
agree to rounding, not to the bit. Prints the card's name and power limit
and one JSON line.
"""

from __future__ import annotations

import json
import pathlib
import sys

import torch

from _kernel_variants import build_patched, card_line, print_ptxas, slope_ms

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

# grid class -> (config, the shipped line, alternatives (cells, threads, CTAs))
LAYOUTS = {
    "Layout32": ("darcy32_pcn_warm", ((2, 512, 2), (4, 256, 2))),
    "Layout64": ("darcy64_pcn_warm", ((8, 512, 1), (4, 1024, 1), (16, 256, 4))),
}


def layout_line(cells: int, threads: int, ctas: int) -> str:
    return (f"static constexpr int kCells = {cells}, kThreads = {threads}, "
            f"kMinCtas = {ctas};")


def shipped_layout(csrc: pathlib.Path, name: str) -> tuple:
    text = (csrc / "darcy_misfit.cuh").read_text()
    line = text[text.index(f"struct {name} {{"):].splitlines()[1].strip()
    vals = [int(part.split("=")[1]) for part in line.rstrip(";").split(",")]
    return tuple(vals)


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    from ip_mcmc_tpu_torch import configs, ops
    from ip_mcmc_tpu_torch.ops import _build

    card = card_line()
    print(f"card: {card}")
    shipped_lib = _build.library()
    out = {"card": card}
    for name, (config, alternatives) in LAYOUTS.items():
        p = configs.build(config, "cuda")
        warm, aux_dim = p.batched_warm_potential
        pos = p.init_positions(torch.Generator().manual_seed(5), p.n_chains).cuda()
        beta, block = p.kernel_params["beta"], p.kernel_params["block_chains"]

        def run(steps):
            return ops.fused_pcn_chain_warm(warm, pos, p.prior.mean, p.prior.scale, beta, 7,
                                            n_steps=steps, aux_dim=aux_dim,
                                            block_chains=block)

        shipped = shipped_layout(_build.CSRC, name)
        libs = {shipped: shipped_lib}
        print_ptxas(_build.BUILD_DIR, f"{name} {shipped}", "fused_pcn_warm_kernel")
        for alt in alternatives:
            tag = f"{name}_{'_'.join(map(str, alt))}"
            libs[alt], build_dir = build_patched(_build, tag, "darcy_misfit.cuh",
                                                 layout_line(*shipped), layout_line(*alt))
            print_ptxas(build_dir, f"{name} {alt}", "fused_pcn_warm_kernel")
        rows = []
        for layout in (shipped, *alternatives, shipped):
            _build._lib = libs[layout]
            acc = float(run(8)[1].mean())
            ms = slope_ms(run, 4, 36)
            rows.append({"layout": list(layout), "ms_per_step": ms, "accept_8_steps": acc})
            print(f"{config} {name} (cells, threads, CTAs) = {layout}: {ms:.4f} ms a step, "
                  f"acceptance over 8 steps {acc:.4f}", flush=True)
        _build._lib = shipped_lib
        out[config] = rows
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
