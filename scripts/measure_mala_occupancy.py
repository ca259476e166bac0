"""Warm MALA (fused_mala_warm_kernel) at 3 and at 4 CTAs per SM on one card.

    python scripts/measure_mala_occupancy.py

The kernel ships under ``__launch_bounds__(256, 4)`` (at most 64 registers
a thread). This builds a copy of ``csrc/`` with that one bound patched to
``(256, 3)`` (80 registers), as the package builds its own sources, and
times one step of each at the shipped size of ``darcy_mala_warm`` (4096
chains, dst / 6 + 6 CG) as the slope between two launch lengths, in the
order 4, 3, 3, 4. It checks that both give the same chains, and prints the
card's name and power limit, the registers and spills that ptxas reports,
and one JSON line.
"""

from __future__ import annotations

import json
import pathlib
import sys

import torch

from _kernel_variants import build_patched, card_line, print_ptxas, slope_ms

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

SHIPPED = "__launch_bounds__(kFusedThreads, 4) fused_mala_warm_kernel"


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    from ip_mcmc_tpu_torch import configs, ops
    from ip_mcmc_tpu_torch.ops import _build

    card = card_line()
    print(f"card: {card}")
    p = configs.build("darcy_mala_warm", "cuda")
    pag, aux_dim = p.batched_warm_potential
    pos = p.init_positions(torch.Generator().manual_seed(5), p.n_chains).cuda()
    eps, block = p.kernel_params["step_size"], p.kernel_params["block_chains"]
    libs = {4: _build.library()}
    print_ptxas(_build.BUILD_DIR, "4 CTAs", "fused_mala_warm_kernel")
    libs[3], out = build_patched(_build, "occupancy_ctas3", "fused_mala.cu", SHIPPED,
                                 SHIPPED.replace(", 4)", ", 3)"))
    print_ptxas(out, "3 CTAs", "fused_mala_warm_kernel")

    def run(steps):
        return ops.fused_mala_chain_warm(
            pag, pos, p.prior.mean, p.prior.scale, eps, 7, n_steps=steps,
            aux_dim=aux_dim, block_chains=block)[0]

    finals, times = {}, []
    for ctas in (4, 3, 3, 4):
        _build._lib = libs[ctas]
        finals.setdefault(ctas, run(16))
        times.append((ctas, slope_ms(run, 8, 136)))
    _build._lib = libs[4]
    torch.cuda.synchronize()
    same = bool(torch.equal(finals[3], finals[4]))
    print(json.dumps({"card": card, "ms_per_step": times, "same_chains": same}))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
