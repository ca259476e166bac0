"""The CTA layout of the 32x32 Darcy kernels on one card: cells per
thread, threads per CTA and the launch bound's CTAs per SM.

    python scripts/measure_darcy_layouts.py [Layout32]

``csrc/darcy_misfit.cuh`` ships one layout per grid class. This builds a
copy of ``csrc/`` for each alternative of ``Layout32`` with that one line
patched (``_kernel_variants.build_patched``), prints the registers and
spills that ptxas reports for the kernel timed, and times one step of
``darcy32_pcn_warm`` (4096 chains) at full width under each, as the slope
between two launch lengths, in the order shipped, alternatives, shipped.
Each run's acceptance is printed beside its time: the layouts sum in other
orders, so the chains agree to rounding, not to the bit. The 64x64
samplers run in thread-block clusters, whose design (layout included) is
one line of its own: ``scripts/measure_da64_cluster_design.py`` times it.
Prints the card's name and power limit and one JSON line.
"""

from __future__ import annotations

import json
import pathlib
import sys

import torch

from _kernel_variants import build_patched, card_line, print_ptxas, slope_ms

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

# layout -> (config, alternatives (cells, threads, CTAs))
LAYOUTS = {
    "Layout32": ("darcy32_pcn_warm", ((2, 512, 2), (4, 256, 2))),
}


def layout_line(cells: int, threads: int, ctas: int) -> str:
    return (f"static constexpr int kCells = {cells}, kThreads = {threads}, "
            f"kMinCtas = {ctas};")


def _values(line: str) -> tuple:
    line = line[line.index("kCells"):line.index(";")]
    return tuple(int(part.split("=")[1]) for part in line.split(","))


def shipped_layout(csrc: pathlib.Path, name: str) -> tuple:
    """(the shipped values, the file and line that a variant replaces)."""
    text = (csrc / "darcy_misfit.cuh").read_text()
    line = text[text.index(f"struct {name} {{"):].splitlines()[1].strip()
    return _values(line), ("darcy_misfit.cuh", line)


def variant_line(name: str, layout: tuple) -> str:
    return layout_line(*layout)


def runner_of(name, p):
    """One launch of ``steps`` steps of the config's fused kernel, and the
    name of that kernel in ptxas' report."""
    from ip_mcmc_tpu_torch import ops

    pos = p.init_positions(torch.Generator().manual_seed(5), p.n_chains).cuda()
    kp = p.kernel_params
    warm, aux_dim = p.batched_warm_potential

    def run(steps):
        return ops.fused_pcn_chain_warm(warm, pos, p.prior.mean, p.prior.scale, kp["beta"], 7,
                                        n_steps=steps, aux_dim=aux_dim,
                                        block_chains=kp["block_chains"])
    return run, "fused_pcn_warm_kernel", (8, 4, 36)


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    from ip_mcmc_tpu_torch import configs
    from ip_mcmc_tpu_torch.ops import _build

    which = sys.argv[1:] or list(LAYOUTS)
    if not set(which) <= set(LAYOUTS):
        raise SystemExit(f"usage: {sys.argv[0]} [{'] ['.join(LAYOUTS)}]")
    card = card_line()
    print(f"card: {card}")
    shipped_lib = _build.library()
    out = {"card": card}
    for name in which:
        config, alternatives = LAYOUTS[name]
        p = configs.build(config, "cuda")
        run, kernel, (acc_steps, short, long) = runner_of(name, p)
        shipped, (source, line) = shipped_layout(_build.CSRC, name)
        alternatives = [alt for alt in alternatives if alt != shipped]
        libs = {shipped: shipped_lib}
        print_ptxas(_build.BUILD_DIR, f"{name} {shipped}", kernel)
        for alt in alternatives:
            tag = f"{name}_{'_'.join(map(str, alt))}"
            libs[alt], build_dir = build_patched(_build, tag, source, line,
                                                 variant_line(name, alt))
            print_ptxas(build_dir, f"{name} {alt}", kernel)
        rows = []
        for layout in (shipped, *alternatives, shipped):
            _build._lib = libs[layout]
            acc = float(run(acc_steps)[1].mean())
            ms = slope_ms(run, short, long)
            rows.append({"layout": list(layout), "ms_per_step": ms,
                         f"accept_{acc_steps}_steps": acc})
            print(f"{config} {name} (cells, threads, CTAs) = {layout}: {ms:.4f} ms a step, "
                  f"acceptance over {acc_steps} steps {acc:.4f}", flush=True)
        _build._lib = shipped_lib
        out[config] = rows
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
