"""Time the scan paths' steps and the ODE gradient on the card.

    python scripts/measure_scan_paths.py [--reps N] [--runs CONFIG[:CUTS] ...] [--out FILE]
        [--only-smc-vi-pod | --only-ode]

At each config's full width, on the card: one ``ode_mala`` gradient of
log π at 1024 chains (the 200-step RK4 solve and its backward), the
Burgers potential at 2048 chains (one and three observation times), one
step of each scan kernel of ``darcy_da_pcn``, ``lingauss_elliptical``,
``lingauss_fes``, ``multimodal_pt``, ``multimodal_pt_mala``, ``ode_mala`` and ``ode_hmc``;
the first stage of ``darcy_smc`` and of ``darcy_smc_warm`` at 4096
particles, one ADVI step of ``lingauss_advi`` and of ``darcy_advi``, the
POD surrogate of ``darcy_da_pod`` at 4096 chains and one outer step of its
delayed acceptance.
For each: milliseconds a call (host clock around a synchronised loop,
after a warm-up), the operations the call dispatches (``aten`` ops, counted
by a dispatch mode), the CUDA activities the profiler records for one call
and their summed device time, and the device's idle share of that call.
Prints one JSON line per row (and with ``--out`` writes them all to that
JSON file). ``--runs`` then runs whole
configs through ``runner.run_problem`` on the card, as the CLI does, and
prints each one's metrics: ``ode_hmc:burn_in=20,map_init=300,n_samples=40``
cuts those fields (``n_samples`` the run's, the others the config's); a bare
name runs as shipped. ``--runs`` alone skips the step rows (``--reps 0``);
``--only-smc-vi-pod`` keeps only the SMC, ADVI and POD rows; ``--only-ode``
only the ODE rows: the Lotka–Volterra kernel alone (``lv_misfit_grad_kernel``)
at 256, 512 and 1024 chains (also timed by CUDA events over back-to-back
launches through its C entry, the wrapper's host path left out:
``chip_smoke.lv_launch_ms``), one gradient of log π at 1024 chains through it
and through the plain version (autograd through the RK4 loop), one step of
``ode_mala`` and ``ode_hmc``, and one NUTS transition of ``ode_nuts`` (256
chains, after 100 Adam iterations and 30 warm-up transitions; the same
draws each call) at the shipped spacing of the host reads
(``nuts.CHECK_EVERY``), then every 1, 2, 4, 8 and 16 leaves in turns (up
and down, three rounds; four transitions of distinct draws a turn, the
median, least and largest turn), and one
ChEES step of ``ode_chees`` (512 chains, after 100 Adam iterations and 30
warm-up steps).
Needs a card; exits 1 without.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def _ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def _profile(fn):
    """(CUDA activities, their summed device µs, wall µs) of one call."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    n, us = 0, 0.0
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA:  # kernels and copies
            n += ev.count
            us += (getattr(ev, "self_device_time_total", 0)
                   or getattr(ev, "self_cuda_time_total", 0))
    return n, us, wall_us


def row(name, fn, reps, **extra):
    counter = _CountOps()
    with counter:
        fn()
    n_act, dev_us, wall_us = _profile(fn)
    out = {"name": name, "ms": _ms(fn, reps), "aten_ops": counter.n,
           "cuda_activities": n_act, "device_ms": dev_us / 1e3,
           "idle_share": 1.0 - dev_us / wall_us if wall_us else None, **extra}
    print(json.dumps(out), flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5, help="0: no step rows")
    ap.add_argument("--runs", nargs="*", default=[], metavar="CONFIG[:CUTS]")
    ap.add_argument("--out", default=None, help="a JSON file for every row and run")
    ap.add_argument("--only-smc-vi-pod", action="store_true",
                    help="of the step rows, only the SMC, ADVI and POD ones")
    ap.add_argument("--only-ode", action="store_true",
                    help="of the step rows, only the ODE ones (the LV kernel, NUTS, ChEES)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("measure_scan_paths: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=False).stdout.strip()
    print(f"card: {card}", flush=True)

    from ip_mcmc_tpu_torch import configs
    from ip_mcmc_tpu_torch.kernels import (
        base, da_pcn, elliptical, ensemble, hmc, mala, pcn, tempering)

    dev = "cuda"
    rows = []
    runs = [run_config(spec) for spec in args.runs]
    if args.reps < 1:
        write_out(args.out, card, rows, runs)
        return 0

    def start(p, n, seed=0):
        return p.init_positions(torch.Generator().manual_seed(seed), n).to(dev)

    if args.only_smc_vi_pod:
        smc_vi_pod_rows(rows, start, args.reps)
        write_out(args.out, card, rows, runs)
        return 0
    if args.only_ode:
        ode_rows(rows, start, args.reps)
        write_out(args.out, card, rows, runs)
        return 0

    ode = configs.build("ode_mala", dev)
    x = start(ode, 1024)
    vg = base.value_and_grad(ode.log_density_fn)
    rows.append(row("ode_mala gradient of log pi, 1024 chains", lambda: vg(x), args.reps))
    rows.append(row("ode_mala log pi alone, 1024 chains",
                    lambda: ode.log_density_fn(x), args.reps))

    for name in ("burgers_pcn", "burgers_multitime_pcn"):
        p = configs.build(name, dev)
        u = start(p, 2048)
        rows.append(row(f"{name} scan potential, 2048 chains",
                        lambda p=p, u=u: p.potential_fn(u), args.reps))

    def step_row(name, kernel, state, reps, **extra):
        g = torch.Generator(dev).manual_seed(1)
        return row(name, lambda: kernel(g, state), reps, **extra)

    p = configs.build("darcy_da_pcn", dev)
    kp = p.kernel_params
    st = da_pcn.init(start(p, p.n_chains), p.potential_fn, p.surrogate_potential_fn)
    rows.append(step_row("darcy_da_pcn outer step, 4096 chains",
                         da_pcn.build_kernel(p.potential_fn, p.surrogate_potential_fn,
                                             p.prior, kp["beta"], kp["subchain_len"]),
                         st, args.reps))

    p = configs.build("lingauss_elliptical", dev)
    st = elliptical.init(start(p, p.n_chains), p.potential_fn)
    k = elliptical.build_kernel(p.potential_fn, p.prior)
    _, info = k(torch.Generator(dev).manual_seed(1), st)
    rows.append(step_row(
        "lingauss_elliptical step, 2048 chains", k, st, args.reps,
        mean_evals=float(info.n_evals.float().mean()), max_evals=int(info.n_evals.max())))

    p = configs.build("lingauss_fes", dev)
    st = ensemble.init(start(p, p.n_chains), p.potential_fn)
    rows.append(step_row("lingauss_fes step, 2048 walkers",
                         ensemble.build_kernel(p.potential_fn, p.prior, 6, pcn_beta=0.25),
                         st, args.reps))

    for name, mala_pt in (("multimodal_pt", False), ("multimodal_pt_mala", True)):
        p = configs.build(name, dev)
        betas = tempering.geometric_ladder(8, 0.05)
        if mala_pt:
            st = tempering.init_mala(start(p, p.n_chains), p.potential_fn, 8)
            k = tempering.build_mala_kernel(p.potential_fn, p.prior, betas, step_size=0.25)
        else:
            st = tempering.init(start(p, p.n_chains), p.potential_fn, 8)
            k = tempering.build_kernel(p.potential_fn, p.prior, betas, pcn_step=0.4)
        rows.append(step_row(f"{name} step, 256 chains x 8 replicas", k, st, args.reps))

    p = configs.build("ode_mala", dev)
    st = mala.init(start(p, p.n_chains), p.log_density_fn)
    rows.append(step_row("ode_mala step, 1024 chains",
                         mala.build_kernel(p.log_density_fn, 0.05), st, args.reps))
    p = configs.build("ode_hmc", dev)
    st = hmc.init(start(p, p.n_chains), p.log_density_fn)
    rows.append(step_row("ode_hmc step (8 leapfrog steps), 512 chains",
                         hmc.build_kernel(p.log_density_fn, 0.05, 8), st,
                         max(1, args.reps // 2)))
    p = configs.build("burgers_pcn", dev)
    st = pcn.init(start(p, p.n_chains), p.potential_fn)
    rows.append(step_row("burgers_pcn scan step, 2048 chains",
                         pcn.build_kernel(p.potential_fn, p.prior, 0.15), st, args.reps))

    smc_vi_pod_rows(rows, start, args.reps)
    write_out(args.out, card, rows, runs)
    return 0


def smc_vi_pod_rows(rows, start, reps):
    """Tempered SMC's first stage (cold and warm), an ADVI step and the POD
    surrogate's delayed acceptance, each at its config's width."""
    from ip_mcmc_tpu_torch import configs, smc, vi
    from ip_mcmc_tpu_torch.kernels import base, da_pcn

    dev = "cuda"
    p = configs.build("darcy_smc", dev)
    kp = p.kernel_params
    x = start(p, p.n_chains)
    zero = torch.zeros((), device=dev)
    st = smc.SMCState(particles=x, potentials=p.potential_fn(x), beta=zero, log_z=zero,
                      stage=0)
    g = torch.Generator(dev).manual_seed(1)

    def draws(_, m):
        return (p.prior.scale_apply(base.normals(g, (m, p.dim), dev)),
                base.uniforms(g, (m,), dev))

    rows.append(row("darcy_smc first stage (bisection, resampling, 5 pCN steps), 4096",
                    lambda: smc.stage(st, p.potential_fn, p.prior,
                                      smc.draw_u0(g, p.n_chains, dev), draws,
                                      mutation_steps=kp["mutation_steps"],
                                      pcn_step=kp["pcn_step"]), reps))

    p = configs.build("darcy_smc_warm", dev)
    warm, aux_dim = p.batched_warm_potential
    U = start(p, p.n_chains).T.contiguous()
    X = torch.zeros(aux_dim, p.n_chains, device=dev)
    for _ in range(8):
        phi, X = warm(U, X)
    st = smc.SMCState(particles=U, potentials=phi, beta=zero, log_z=zero, stage=0,
                      warm_aux=X)
    pm, ps = p.prior.mean[:, None], p.prior.scale[:, None]
    k = kp["mutation_steps"]

    def warm_stage():
        xi = base.normals(g, (k, p.dim, p.n_chains), dev)
        log_u = torch.log(base.uniforms(g, (k, p.n_chains), dev))
        return smc.stage_batched(st, warm, pm, ps, smc.draw_u0(g, p.n_chains, dev), xi,
                                 log_u, pcn_step=kp["pcn_step"])

    rows.append(row("darcy_smc_warm first stage (5 warm dense-dst 6-CG misfits), 4096",
                    warm_stage, reps))

    for name in ("lingauss_advi", "darcy_advi"):
        p = configs.build(name, dev)
        kp = p.kernel_params
        rows.append(row(f"{name} ADVI step, {kp['n_mc_samples']} samples",
                        lambda p=p, kp=kp: vi.fit(
                            p.log_density_fn, p.dim, g, num_steps=1,
                            n_samples=kp["n_mc_samples"],
                            learning_rate=kp["learning_rate"],
                            full_rank=kp["full_rank"]), reps))

    p = configs.build("darcy_da_pod", dev)
    kp = p.kernel_params
    x = start(p, p.n_chains)
    rows.append(row("darcy_da_pod POD surrogate (rank 20), 4096",
                    lambda: p.surrogate_potential_fn(x), reps))
    st = da_pcn.init(x, p.potential_fn, p.surrogate_potential_fn)
    kernel = da_pcn.build_kernel(p.potential_fn, p.surrogate_potential_fn, p.prior,
                                 kp["beta"], kp["subchain_len"])
    rows.append(row("darcy_da_pod outer step: 4 POD + 48-CG exact, 4096",
                    lambda: kernel(g, st), reps))


# the NUTS host-read spacings of --only-ode: transitions a turn, rounds of turns
NUTS_SEEDS, NUTS_ROUNDS = 4, 3


def ode_rows(rows, start, reps):
    """The ODE rows of ``--only-ode``."""
    from chip_smoke import lv_launch_ms
    from ip_mcmc_tpu_torch import configs
    from ip_mcmc_tpu_torch.adapt import map_localize, warmup_nuts
    from ip_mcmc_tpu_torch.kernels import base, chees_hmc, hmc, mala, nuts
    from ip_mcmc_tpu_torch.ops import lv_rk4

    p = configs.build("ode_mala", "cuda")
    pot = p.potential_fn
    for n in (256, 512, 1024):
        th = start(p, n)
        rows.append(row(f"lv_misfit_grad_kernel alone, {n} chains",
                        lambda th=th: lv_rk4.misfit_and_grad(th, pot.spec), reps,
                        back_to_back_ms=lv_launch_ms(th, pot.spec)))
    x = start(p, 1024)
    rows.append(row("ode_mala gradient of log pi through the kernel, 1024 chains",
                    lambda: base.value_and_grad(p.log_density_fn)(x), reps))
    plain = base.value_and_grad(lambda t: -pot.plain(t) - p.prior.potential(t))
    rows.append(row("ode_mala gradient of log pi, the plain version, 1024 chains",
                    lambda: plain(x), reps))

    def step_row(name, kernel, state, **extra):
        g = torch.Generator("cuda").manual_seed(1)
        return row(name, lambda: kernel(g, state), reps, **extra)

    st = mala.init(x, p.log_density_fn)
    rows.append(step_row("ode_mala step, 1024 chains", mala.build_kernel(p.log_density_fn, 0.05),
                         st))
    p = configs.build("ode_hmc", "cuda")
    st = hmc.init(start(p, p.n_chains), p.log_density_fn)
    rows.append(step_row("ode_hmc step (8 leapfrog steps), 512 chains",
                         hmc.build_kernel(p.log_density_fn, 0.05, 8), st))

    p = configs.build("ode_nuts", "cuda")
    logpi = p.log_density_fn
    pos = map_localize(logpi, start(p, p.n_chains), num_steps=100)
    st, eps, inv_mass = warmup_nuts(logpi, nuts.init(pos, logpi),
                                    torch.Generator("cuda").manual_seed(2), num_steps=30,
                                    max_depth=8, initial_step_size=0.05)
    kernel = nuts.build_kernel(logpi, eps, 8, inv_mass)
    infos = [kernel(torch.Generator("cuda").manual_seed(seed), st)[1]
             for seed in range(1, NUTS_SEEDS + 1)]
    tree = dict(step_size=float(eps),
                mean_depth=float(torch.cat([i.depth for i in infos]).float().mean()),
                max_depth=int(torch.cat([i.depth for i in infos]).max()),
                mean_leaves=float(torch.cat([i.num_steps for i in infos]).float().mean()))
    rows.append(row(f"ode_nuts transition, 256 chains, a host read every {nuts.CHECK_EVERY} "
                    "leaves (shipped)", lambda: kernel(torch.Generator("cuda").manual_seed(1), st),
                    reps, **tree))

    def transitions():  # NUTS_SEEDS transitions from st, the draws of seeds 1, 2, ...
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for seed in range(1, NUTS_SEEDS + 1):
            kernel(torch.Generator("cuda").manual_seed(seed), st)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / NUTS_SEEDS * 1e3

    # the spacing of the host reads in turns (up, then down, NUTS_ROUNDS
    # times): every spacing meets the same trees, and the host's drift
    # within the call falls on all of them alike
    spacings, shipped = (1, 2, 4, 8, 16), nuts.CHECK_EVERY
    times = {e: [] for e in spacings}
    try:
        for every in (spacings + spacings[::-1]) * NUTS_ROUNDS:
            nuts.CHECK_EVERY = every
            times[every].append(transitions())
    finally:
        nuts.CHECK_EVERY = shipped
    for every in spacings:
        ms = sorted(times[every])
        out = {"name": f"ode_nuts transition, 256 chains, a host read every {every} leaves, "
                       f"in turns ({NUTS_SEEDS} transitions a turn)",
               "ms": ms[len(ms) // 2], "ms_min": ms[0], "ms_max": ms[-1], "ms_turns": times[every],
               **tree}
        print(json.dumps(out), flush=True)
        rows.append(out)

    p = configs.build("ode_chees", "cuda")
    logpi = p.log_density_fn
    pos = map_localize(logpi, start(p, p.n_chains), num_steps=100)
    st, eps, tau, inv_mass = chees_hmc.warmup_chees(
        logpi, pos, torch.Generator("cuda").manual_seed(2), num_steps=30,
        initial_step_size=0.05, initial_trajectory=0.5)
    n_leap = int(torch.clamp(torch.ceil(chees_hmc.halton(30) * tau / eps), min=1))
    rows.append(row("ode_chees step, 512 chains",
                    lambda: chees_hmc.step(logpi, st, torch.Generator("cuda").manual_seed(1), 30,
                                           eps, tau, inv_mass), reps,
                    step_size=float(eps), trajectory_length=float(tau), n_leap=n_leap))


def run_config(spec):
    """One config through runner.run_problem on the card, optionally cut
    (``name:field=value,...``); prints and returns its metrics."""
    import dataclasses

    from ip_mcmc_tpu_torch import configs, runner

    name, _, cuts = spec.partition(":")
    p = configs.build(name, "cuda")
    fields = dict(kv.split("=") for kv in cuts.split(",")) if cuts else {}
    n_samples = int(fields.pop("n_samples", p.n_samples))
    kp = dict(p.kernel_params)
    for k in [k for k in fields if k in kp]:
        kp[k] = int(fields.pop(k))
    p = dataclasses.replace(p, kernel_params=kp, **{k: int(v) for k, v in fields.items()})
    m = runner.run_problem(p, "cuda", seed=0, n_samples=n_samples)
    m["cuts"] = cuts
    print(f"{name} metrics: " + json.dumps(m), flush=True)
    return m


def write_out(path, card, rows, runs):
    if path:
        pathlib.Path(path).write_text(json.dumps(
            {"card": card, "rows": rows, "runs": runs}, indent=1))


if __name__ == "__main__":
    sys.exit(main())
