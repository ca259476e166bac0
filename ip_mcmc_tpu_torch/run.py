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
``lingauss_advi`` and ``darcy_advi`` ADVI; ``darcy_composed_pcn``,
``darcy_composed_mala`` and ``darcy_composed_ess`` run on a ('chains',
'model') mesh whose shape follows the number of processes.

Several devices are several processes, one a device, in one
``torch.distributed`` world (NCCL on the card, gloo with ``--device
cpu``): start each with ``--num-processes N --process-id i --coordinator
HOST:PORT`` (or ``IPX_NUM_PROCESSES``, ``IPX_PROCESS_ID``,
``IPX_COORDINATOR``); rank i takes ``cuda:<local rank>``. The chains are
sharded over the world (on the fused, the one-dispatch scan and the
composed paths; the others refuse a world of more than one rank);
process 0 alone writes ``--metrics-log`` /
``--tensorboard`` and prints the JSON line, with ``process_count``,
``process_id`` and ``global_devices`` added. ``--devices 1`` runs a
world of one process (its collectives included); ``--devices N`` with
N > 1 needs N processes and raises in one (the port starts no workers).

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
        "--devices", type=int, default=None,
        help="shard the chains over a world of N processes, one a device (N = 1: "
        "this process alone; more: launch N with --num-processes); by default no "
        "sharding, or with --num-processes all of the world's ranks")
    # several processes, one a device: the flags fall back to the
    # environment, for schedulers that template it
    ap.add_argument(
        "--coordinator", default=os.environ.get("IPX_COORDINATOR"), metavar="HOST:PORT",
        help="the address of process 0 (torch.distributed's tcp:// rendezvous)")
    ap.add_argument(
        "--num-processes", type=int,
        default=int(os.environ["IPX_NUM_PROCESSES"])
        if "IPX_NUM_PROCESSES" in os.environ else None)
    ap.add_argument(
        "--process-id", type=int,
        default=int(os.environ["IPX_PROCESS_ID"])
        if "IPX_PROCESS_ID" in os.environ else None)
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

    import torch.distributed as dist

    multiproc = args.coordinator is not None or (args.num_processes or 0) > 1
    was_running = dist.is_initialized()
    if (multiproc or args.devices) and not args.list:
        # the world first, before any config puts a tensor on a device
        from ip_mcmc_tpu_torch.parallel import mesh as pmesh

        pmesh.distributed_init(args.coordinator, args.num_processes, args.process_id,
                               device=args.device)
    try:
        return _main(ap, args, t_main, multiproc)
    finally:
        # a world this call started (here, or the composed path's world of
        # one) ends with it
        if dist.is_initialized() and not was_running:
            from ip_mcmc_tpu_torch.parallel import shutdown

            shutdown()


def _main(ap, args, t_main, multiproc):
    import torch.distributed as dist

    from ip_mcmc_tpu_torch import configs, parallel, resolve_device, runner

    if args.list:
        for name in sorted(configs.REGISTRY):
            doc = (configs.REGISTRY[name].__doc__ or "").strip().splitlines()[0]
            print(f"{name:22s} {doc}")
        return 0
    if args.config is None:
        ap.error("--config is required (or use --list)")
    if args.config not in configs.REGISTRY:
        ap.error(
            f"unknown config {args.config!r} (choose from "
            f"{', '.join(sorted(configs.REGISTRY))})"
        )
    mesh = None
    if args.devices or multiproc:
        parallel.check_world_size(args.devices)
        device = parallel.mesh_device()
    else:
        device = resolve_device(args.device)
    problem = configs.build(args.config, device)
    if args.fused:
        problem.kernel_params = {**problem.kernel_params, "fused": True}
    if (args.devices or multiproc) and problem.kernel not in runner.COMPOSED_KERNELS:
        # the chains over the world; the composed configs make their
        # ('chains', 'model') mesh from the world's size themselves
        mesh = parallel.make_chain_mesh()
    if multiproc and dist.get_rank() != 0:
        # one writer: the records are the same on every rank
        args.metrics_log = args.tensorboard = None
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
        metrics_log=metrics_log, mesh=mesh,
    )
    metrics["setup_s"] = setup_s
    metrics["cli_total_s"] = time.perf_counter() - t_main
    if multiproc:
        metrics["process_count"] = dist.get_world_size()
        metrics["process_id"] = dist.get_rank()
        metrics["global_devices"] = dist.get_world_size()
        if dist.get_rank() != 0:
            return 0  # one JSON line for the whole world: process 0's
    if args.tensorboard:
        from ip_mcmc_tpu_torch.utils.tensorboard import export_jsonl

        metrics["tensorboard_events"] = export_jsonl(
            metrics_log, args.tensorboard, start_offset=log_offset)
    json.dump(metrics, sys.stdout)
    sys.stdout.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
