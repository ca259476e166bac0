"""Where the time goes on CLI paths, by default the two 64x64 Darcy ones, on
one NVIDIA GPU.

    python scripts/measure_darcy64_paths.py [--fused] [--burn-in N] [--n-samples N] [config ...]

Each config (by default ``darcy64_da_fused`` and ``darcy64_pcn_warm``) runs
once through the runner as the CLI runs it, ``--fused`` as the CLI's flag
sets it (``darcy_pcn_4096`` and the Burgers pCN configs need it; the metrics
of that run are printed; ``--burn-in`` and ``--n-samples`` shorten the run,
as a scan path of some thousand launches a step needs under the profiler),
then
once more under ``torch.profiler`` (``measure_linear_paths.profiled``):
the device time of every kernel and copy, summed, against the host wall
of the same run gives the device's idle share, and the trace gives each
kernel's device time and calls. Prints the card's name and power limit and
one JSON line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402
from measure_linear_paths import profiled, summary  # noqa: E402

KEYS = ("run_s", "ess_per_s", "min_ess", "max_rhat", "accept_rate", "inner_accept_rate",
        "mid_accept_rate", "stretch_accept_rate", "steps_per_s", "outer_steps_per_s",
        "total_wall_s")


def main() -> int:
    if not torch.cuda.is_available():
        print("measure_darcy64_paths: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    card = chip_smoke.card_line()
    print(f"card: {card}", flush=True)
    from ip_mcmc_tpu_torch import configs, runner

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("configs", nargs="*", default=["darcy64_da_fused", "darcy64_pcn_warm"])
    ap.add_argument("--fused", action="store_true", help="the CLI's --fused")
    ap.add_argument("--burn-in", type=int, default=None, help="in place of the config's")
    ap.add_argument("--n-samples", type=int, default=None, help="in place of the config's")
    args = ap.parse_args()
    out = {"card": card}
    for name in args.configs:
        p = configs.build(name, "cuda")
        if args.fused:  # as ip_mcmc_tpu_torch/run.py sets it
            p.kernel_params = {**p.kernel_params, "fused": True}
        if args.burn_in is not None:
            p = dataclasses.replace(p, burn_in=args.burn_in)
        runs = []
        row = summary(*profiled(lambda: runs.append(
            runner.run_problem(p, "cuda", n_samples=args.n_samples))))
        row["metrics_unprofiled"] = {k: runs[0][k] for k in KEYS if k in runs[0]}
        row["metrics_profiled"] = {k: runs[1][k] for k in KEYS if k in runs[1]}
        out[name] = row
        print(name + ": " + json.dumps(row), flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
