"""CLI entry: ``python -m ip_mcmc_tpu_torch.run --config darcy_da_fused``
(``--list`` names the configs). The fused configs run their CUDA kernels;
``darcy_pcn_4096``, ``burgers_pcn`` and ``burgers_multitime_pcn`` run the
scan path, or with ``--fused`` their fused kernel; ``gauss2d_rwm``,
``lingauss_pcn``, ``lingauss_elliptical``, ``lingauss_fes``,
``darcy64_pcn``, ``darcy_da_pcn``, ``ode_mala``, ``ode_hmc``,
``ode_nuts``, ``ode_chees``, ``multimodal_pt`` and ``multimodal_pt_mala``
run the scan path (plain PyTorch over the chains; the ODE configs' misfit
and gradient one kernel on the card), as do ``darcy_da_pod`` and ``darcy_da_pod_online``
(delayed acceptance on a POD surrogate) and ``darcy_advi_warmstart`` (with
``--fused``, the fused kernel); ``darcy_smc`` and ``darcy_smc_warm`` run
tempered SMC (the warm one's mutation on the warm misfit's kernel),
``lingauss_advi`` and ``darcy_advi`` ADVI. A JAX config not ported yet
(the three composed ones) raises ``NotImplementedError``.

Prints one JSON line of metrics (the keys of ``ip_mcmc_tpu.run``). Runs on
the card by default; ``--device cpu`` runs the kernels' plain versions.
``--metrics-log FILE`` appends the run's records as JSON lines (the
``run_complete`` summary; on the scan path also the acceptance trace);
``--tensorboard LOGDIR`` exports this run's records as a TensorBoard event
file under LOGDIR (``utils/tensorboard.py``, no package needed; without
``--metrics-log`` the log is ``LOGDIR/metrics.jsonl``) and names it under
``tensorboard_events``; ``--profile-dir DIR`` traces the scan path's timed
run with ``torch.profiler`` into a Chrome trace under DIR.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main(argv=None):
    t_main = time.perf_counter()
    ap = argparse.ArgumentParser(description="ip_mcmc_tpu_torch runner")
    ap.add_argument("--config")
    ap.add_argument("--n-chains", type=int, default=None)
    ap.add_argument("--n-samples", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the initial positions' torch.Generator")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; fails without a card) or 'cpu'")
    ap.add_argument(
        "--fused", action="store_true",
        help="use the fully fused path (darcy_pcn_4096, burgers_pcn and "
        "burgers_multitime_pcn, which run the scan path without it; the other "
        "fused configs set it themselves, and the configs with no batched "
        "potential run the scan path)",
    )
    ap.add_argument("--profile-dir", default=None,
                    help="torch.profiler trace dir (the scan path's timed run)")
    ap.add_argument(
        "--metrics-log", default=None,
        help="write JSON-lines metric records (run summary + accept trace)",
    )
    ap.add_argument(
        "--tensorboard", default=None, metavar="LOGDIR",
        help="export the run's metric records as a TensorBoard event file "
        "under LOGDIR (scalar dashboard; utils/tensorboard.py — no "
        "tensorboard package needed to write)",
    )
    ap.add_argument("--list", action="store_true", help="list configs and exit")
    args = ap.parse_args(argv)

    from ip_mcmc_tpu_torch import configs, resolve_device, runner

    if args.list:
        for name in sorted(configs.REGISTRY):
            doc = (configs.REGISTRY[name].__doc__ or "").strip().splitlines()[0]
            print(f"{name:22s} {doc}")
        return 0
    if args.config is None:
        ap.error("--config is required (or use --list)")
    if args.config not in configs.REGISTRY and args.config not in configs.NOT_PORTED:
        ap.error(
            f"unknown config {args.config!r} (choose from "
            f"{', '.join(sorted(configs.REGISTRY))})"
        )
    device = resolve_device(args.device)
    problem = configs.build(args.config, device)
    if args.fused:
        problem.kernel_params = {**problem.kernel_params, "fused": True}
    metrics_log = args.metrics_log
    if args.tensorboard and metrics_log is None:
        # the export reads the JSON-lines records: a log beside the events
        os.makedirs(args.tensorboard, exist_ok=True)
        metrics_log = os.path.join(args.tensorboard, "metrics.jsonl")
    # MetricsLogger appends: where this run's records start, so that the
    # export below leaves out an earlier run's records in the same file
    log_offset = (os.path.getsize(metrics_log)
                  if metrics_log and os.path.exists(metrics_log) else 0)
    setup_s = time.perf_counter() - t_main
    metrics = runner.run_problem(
        problem, device, seed=args.seed, n_chains=args.n_chains,
        n_samples=args.n_samples, profile_dir=args.profile_dir,
        metrics_log=metrics_log,
    )
    metrics["setup_s"] = setup_s
    metrics["cli_total_s"] = time.perf_counter() - t_main
    if args.tensorboard:
        from ip_mcmc_tpu_torch.utils.tensorboard import export_jsonl

        metrics["tensorboard_events"] = export_jsonl(
            metrics_log, args.tensorboard, start_offset=log_offset)
    json.dump(metrics, sys.stdout)
    sys.stdout.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
