"""The spread of ``burgers_da3_pcn``'s acceptance over the seed of its
initial positions, through the port's CLI on one card.

    python scripts/burgers_da3_seed_spread.py [--seeds 5]

Runs ``python -m ip_mcmc_tpu_torch.run --config burgers_da3_pcn --seed s``
in-process for s = 0 .. seeds - 1 (the config as shipped: 2048 chains,
100 outer steps of burn-in, 400 recorded; the kernels' own seeds are the
runner's), and prints each run's outer and middle acceptance, ESS per
record and R-hat, their mean and standard deviation over the seeds, and
where the TPU's outer acceptance (0.7747, BASELINE.md) falls in that
spread. Prints the card's name and power limit and one JSON line.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import pathlib
import statistics
import sys

import torch

from _kernel_variants import card_line

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

TPU_OUTER_ACCEPT = 0.7747  # the JAX CLI on a TPU v5e (BASELINE.md)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    from ip_mcmc_tpu_torch import run

    card = card_line()
    print(f"card: {card}")
    rows = []
    for seed in range(args.seeds):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = run.main(["--config", "burgers_da3_pcn", "--device", "cuda",
                           "--seed", str(seed)])
        if rc != 0:
            return rc
        m = json.loads(buf.getvalue().strip().splitlines()[-1])
        row = {"seed": seed, "outer_accept": m["accept_rate"],
               "mid_accept": m["mid_accept_rate"],
               "ess_per_record": m["min_ess"] / (m["n_chains"] * m["n_samples"]),
               "max_rhat": m["max_rhat"]}
        rows.append(row)
        print(json.dumps(row), flush=True)
    outer = [r["outer_accept"] for r in rows]
    mean, sd = statistics.mean(outer), statistics.stdev(outer)
    summary = {"card": card, "runs": rows, "outer_accept_mean": mean, "outer_accept_sd": sd,
               "outer_accept_range": [min(outer), max(outer)],
               "tpu_outer_accept": TPU_OUTER_ACCEPT,
               "tpu_gap_in_sd": (mean - TPU_OUTER_ACCEPT) / sd if sd > 0 else None}
    print(f"outer acceptance over {len(rows)} seeds: mean {mean:.4f}, sd {sd:.5f}, range "
          f"{min(outer):.4f}-{max(outer):.4f}; the TPU's {TPU_OUTER_ACCEPT} lies "
          f"{mean - TPU_OUTER_ACCEPT:.4f} below the mean", flush=True)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
