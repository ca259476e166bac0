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
"""

from __future__ import annotations

import argparse
import json
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
    setup_s = time.perf_counter() - t_main
    metrics = runner.run_problem(
        problem, device, seed=args.seed, n_chains=args.n_chains,
        n_samples=args.n_samples,
    )
    metrics["setup_s"] = setup_s
    metrics["cli_total_s"] = time.perf_counter() - t_main
    json.dump(metrics, sys.stdout)
    sys.stdout.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
