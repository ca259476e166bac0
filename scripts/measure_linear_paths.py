"""Where the time goes on the linear-Gaussian paths, on one NVIDIA GPU.

    python scripts/measure_linear_paths.py

Each path runs once to warm up (build, cuFFT plans), then once under
``torch.profiler`` (CPU and CUDA activities): the device time of every
kernel and copy, summed, against the host wall of the same run, gives the
device's idle share; the kernels' own device time per launch is read from
the same trace. Paths, at the sizes of ``chip_smoke.py``:

1. ``gauss2d_rwm`` and ``lingauss_pcn`` on the scan path (``runner``);
2. the burn-in of the fused pCN with β adaptation on lingauss_pcn's
   misfit (2048 chains, 500 steps, one launch of
   ``fused_pcn_adapt_group_kernel``);
3. dense-prior pCN on it, 1000 recorded steps;
4. fused RWM on ``benchmarks/compare_paths.py``'s target, 8192 chains x
   2000 steps;
5. the two fused paths whole, as ``chip_smoke.py`` drives them:
   ``gauss2d_rwm --fused`` (the runner's fused RWM branch) and
   ``lingauss_pcn fused`` (K16 burn-in, then K15: 500 steps and 1000
   recorded).

Prints the card's name and power limit and one JSON line.
"""

from __future__ import annotations

import json
import pathlib
import sys
import time

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402


def profiled(fn):
    """(host wall s, device busy s, {kernel: (device us, calls)}) of one
    ``fn()`` under the profiler, after a warm-up call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = {}
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA:  # kernels and copies
            us = getattr(ev, "self_device_time_total", 0) or getattr(ev, "self_cuda_time_total", 0)
            kernels[ev.key[:70]] = (us, ev.count)
    busy = sum(us for us, _ in kernels.values()) / 1e6
    return wall, busy, kernels


def summary(wall, busy, kernels, top=5):
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:top]
    return {"wall_s": wall, "device_busy_s": busy, "device_idle_share": 1 - busy / wall,
            "device_us_calls_by_kernel": {k: [us, n] for k, (us, n) in ranked}}


def main() -> int:
    if not torch.cuda.is_available():
        print("measure_linear_paths: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    card = chip_smoke.card_line()
    print(f"card: {card}", flush=True)
    from ip_mcmc_tpu_torch import configs, ops, runner

    out = {"card": card}
    for name in chip_smoke.CLOSED_FORM:  # the linear-Gaussian scan paths
        p = configs.build(name, "cuda")
        out[name] = summary(*profiled(lambda: runner.run_problem(p, "cuda", seed=0)))
        print(name + ": " + json.dumps(out[name]), flush=True)

    lp = configs.build("lingauss_pcn", "cuda")
    pot, scale, chol = chip_smoke.lingauss_potential()
    zeros = torch.zeros(lp.dim, device="cuda")
    pos = lp.init_positions(torch.Generator().manual_seed(5), lp.n_chains).cuda()
    block = chip_smoke.LINGAUSS_BLOCK
    runs = {
        "lingauss K16 burn-in": lambda: ops.fused_pcn_chain_adapt(
            pot, pos, zeros, scale, 0.2, 7, n_steps=lp.burn_in, target_accept=0.234,
            block_chains=block),
        "lingauss K15 recorded": lambda: ops.fused_pcn_chain_dense_recorded(
            pot, pos, zeros, chol, 0.28, 8, n_steps=chip_smoke.LINGAUSS_SAMPLES, thin=1,
            block_chains=block),
        "compare_paths K14": lambda: ops.fused_rwm_chain(
            chip_smoke.compare_paths_potential(),
            torch.zeros(chip_smoke.CP_CHAINS, 2, device="cuda"), 0.9, 1,
            n_steps=chip_smoke.CP_STEPS, block_chains=chip_smoke.CP_BLOCK),
        "gauss2d_rwm --fused": lambda: chip_smoke.run_gauss2d_fused(
            configs.build("gauss2d_rwm", "cuda")),
        "lingauss_pcn fused": lambda: chip_smoke.run_lingauss_fused(lp),
    }
    for name, fn in runs.items():
        out[name] = summary(*profiled(fn))
        print(name + ": " + json.dumps(out[name]), flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
