"""The Burgers kernels on one card: the samplers at 16, 8 and 4 CTAs per SM,
and the device's busy share in one CLI run. (The misfit kernel's own times
are ``chip_smoke.py``'s.)

    python scripts/measure_burgers_kernels.py

1. The samplers ship under ``__launch_bounds__(128, 16)`` (32 registers a
   thread; 2048 chains resident at once). This copies ``csrc/`` twice with
   ``BurgersPotential::kMinCtasPerSm`` patched to 8 (64 registers) and 4,
   builds each copy as the package builds its own, and times one step of
   three-level DA, DA and pCN at the shipped sizes as the slope between two
   launch lengths, in the order 16, 8, 4, 4, 8, 16. All must give the same
   chains. Prints what ptxas reports for each.
2. ``burgers_da3_pcn`` through the runner under ``torch.profiler``: device
   time by kernel, and the share of the runner's ``total_wall_s`` in which
   the device was idle.

Prints the card's name and power limit and one JSON line.
"""

from __future__ import annotations

import json
import pathlib
import sys

import torch

from _kernel_variants import build_patched, card_line, print_ptxas, slope_ms

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

SHIPPED = "static constexpr int kMinCtasPerSm = 16;"


def build_variants(_build):
    """{CTAs per SM: the loaded kernels of a tree built with that bound}."""
    libs = {16: _build.library()}
    print_ptxas(_build.BUILD_DIR, "16 CTAs", "BurgersPotential")
    for ctas in (8, 4):
        libs[ctas], out = build_patched(
            _build, f"occupancy_ctas{ctas}", "burgers_misfit.cuh", SHIPPED,
            SHIPPED.replace("16", str(ctas)))
        print_ptxas(out, f"{ctas} CTAs", "BurgersPotential")
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    from ip_mcmc_tpu_torch import configs, ops, runner
    from ip_mcmc_tpu_torch.ops import _build

    card = card_line()
    print(f"card: {card}")
    da3 = configs.build("burgers_da3_pcn", "cuda")
    fine, mid, coarse = (da3.batched_potential_fn, da3.batched_mid_fn,
                         da3.batched_surrogate_fn)
    gen = torch.Generator().manual_seed(7)
    n = da3.n_chains
    out = {"card": card}

    # 1. the samplers at three launch bounds
    libs = build_variants(_build)
    pos = da3.init_positions(gen, n).cuda()
    pm, ps, kp = da3.prior.mean, da3.prior.scale, da3.kernel_params
    runs = {
        "da3": (lambda s: ops.fused_da3_pcn_chain(
            fine, mid, coarse, pos, pm, ps, kp["beta"], 3, n_steps=s,
            k_inner=kp["k_inner"], k_mid=kp["k_mid"], block_chains=512), 2, 18),
        "da": (lambda s: ops.fused_da_pcn_chain(
            fine, coarse, pos, pm, ps, 0.15, 3, n_steps=s, subchain_len=16,
            block_chains=512), 4, 68),
        "pcn": (lambda s: ops.fused_pcn_chain(
            fine, pos, pm, ps, 0.15, 3, n_steps=s, block_chains=512), 8, 264),
    }
    finals, steps_ms = {}, []
    for ctas in (16, 8, 4, 4, 8, 16):
        _build._lib = libs[ctas]
        row = {"ctas_per_sm": ctas}
        for name, (run, short, long) in runs.items():
            finals.setdefault((name, ctas), run(short)[0])
            row[name] = slope_ms(run, short, long)
        steps_ms.append(row)
        print("ms per step: " + json.dumps(row), flush=True)
    _build._lib = libs[16]
    same = all(torch.equal(finals[(name, c)], finals[(name, 16)])
               for name in runs for c in (8, 4))
    out["ms_per_step"], out["same_chains"] = steps_ms, same

    # 2. the device's share of one CLI-sized run
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    runner.run_problem(da3, "cuda", seed=0)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        metrics = runner.run_problem(da3, "cuda", seed=0)
        torch.cuda.synchronize()
    device_us = {}
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA:  # kernels and copies
            device_us[ev.key[:60]] = (getattr(ev, "self_device_time_total", 0)
                                      or getattr(ev, "self_cuda_time_total", 0))
    busy_s = sum(device_us.values()) / 1e6
    top = dict(sorted(device_us.items(), key=lambda kv: -kv[1])[:6])
    wall = metrics["total_wall_s"]  # with the profiler on
    out["da3_run"] = {"run_s": metrics["run_s"], "total_wall_s": wall,
                      "device_busy_s": busy_s, "device_idle_share": 1 - busy_s / wall,
                      "device_us_by_kernel": top}
    print(json.dumps(out))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
