"""Problem runner: config → (warm-up) → sampling → diagnostics (mirrors
``ip_mcmc_tpu/runner.py``: ``run_problem``; ``_run_fused_mcmc``'s ``da_pcn``
(two- and three-level), ``pcn`` (cold and warm), ``elliptical``, ``fes``,
``mala`` (cold and warm) and ``rwm`` branches; the scan path's
``_setup_kernel_state`` (``rwm``, ``pcn``, ``da_pcn``, ``elliptical``,
``mala``, ``hmc``, ``nuts``, with ``map_init``) and ``_run_one_dispatch``;
``_run_chees``, ``_run_fes``, ``_run_pt`` and ``_pt_pair_metrics``;
``_run_smc``, ``_run_vi``, ``_vi_warm_start`` and ``_pod_enrich_burnin``;
``_resolve_n_low_modes``, ``_finalize``) and ``_run_composed`` (the
three ``darcy_composed_*`` configs on a ('chains', 'model') mesh). Returns
the JAX runner's JSON-able metrics dict, key for key.

With a chain ``mesh`` (``parallel.make_chain_mesh``: a ``torch.distributed``
world, one process a device) the fused path launches each rank's shard
through ``parallel.sharded_fused_chain`` and the scan path samples each
rank's rows through ``parallel.sample_chains_sharded`` after a warm-up
(and a VI or POD warm start) run whole on every rank (as the JAX runner
keeps it eager and replicated), so a sharded run gives the
single-process run's chains; every rank ends with the same metrics. The
composed configs shard over the mesh they are given, else one of the
world's size. The other paths (SMC, VI, ChEES, PT, the scan FES) do not
shard: a mesh of more than one rank is refused there, rather than every
rank running the whole problem.

Fused timing protocol (as the JAX runner's): the burn launch uses seed 1
and is timed as ``warmup_s`` (on the card it also pays the kernels' build
at first use); the recorded launch uses seed 2 and runs twice — the first
call builds and runs, the identical second call is timed as ``run_s``, and
the difference is ``compile_s``. ``first_dispatch_s`` is the time of the
first device synchronisation. The scan path's protocol is
``_run_one_dispatch``'s; ``_run_chees`` times its warm-up, then, as
``_run_fes`` and ``_run_pt``, runs its sampling twice and times the second
run, as ``_run_smc`` runs the sampler; ``_run_vi`` times its one fit.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ip_mcmc_tpu_torch import diagnostics, driver, ops, parallel, smc, vi
from ip_mcmc_tpu_torch.adapt import (
    map_localize,
    warmup_hmc,
    warmup_mala,
    warmup_nuts,
    warmup_pcn,
    warmup_rwm,
)
from ip_mcmc_tpu_torch.kernels import (
    chees_hmc,
    da_pcn,
    elliptical,
    ensemble,
    hmc,
    mala,
    nuts,
    pcn,
    rwm,
    tempering,
)
from ip_mcmc_tpu_torch.kernels.ensemble import choose_n_low_modes
from ip_mcmc_tpu_torch.parallel import composed
from ip_mcmc_tpu_torch.utils.logging import MetricsLogger, profile_region

# metric keys that name wall-time phases (attribution in _finalize)
_PHASE_KEYS = ("warmup_s", "trace_s", "compile_s", "first_dispatch_s", "run_s",
               "diag_s", "fit_s", "vi_fit_s", "pod_enrich_s")
# the kernels with a fused path, those of the one-dispatch scan path, and
# those of the composed ('chains', 'model') mesh
FUSED_KERNELS = ("pcn", "elliptical", "da_pcn", "fes", "mala", "rwm")
SCAN_KERNELS = ("rwm", "pcn", "da_pcn", "elliptical", "mala", "hmc", "nuts")
COMPOSED_KERNELS = ("pcn_composed", "mala_composed", "ess_composed")


def _barrier(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _summarize_timed(samples):
    t0 = time.perf_counter()
    summ = diagnostics.summarize(samples)
    summ = {k: v.cpu() for k, v in summ.items()}
    return summ, time.perf_counter() - t0


def _finalize(metrics, t_start, metrics_log=None, accept_trace=None):
    """End-to-end wall, unattributed remainder, the per-invocation ESS rate
    and the R̂ convergence flag (``runner._finalize``); with ``metrics_log``
    the ``run_complete`` record of the metrics, then, for the scan path,
    the chain-mean acceptance of about 50 retained steps
    (``accept_trace`` records, at JAX's spacing)."""
    metrics["total_wall_s"] = time.perf_counter() - t_start
    metrics["unattributed_s"] = metrics["total_wall_s"] - sum(
        metrics.get(k, 0.0) for k in _PHASE_KEYS
    )
    if "min_ess" in metrics:
        metrics["ess_per_total_wall_s"] = (
            metrics["min_ess"] / metrics["total_wall_s"]
        )
    rhat = metrics.get("max_rhat")
    if rhat is not None:
        metrics["converged"] = bool(rhat < 1.1)
        if not metrics["converged"]:
            metrics["warning"] = (
                f"max_rhat {rhat:.2f} > 1.1: chains not converged — treat "
                "posterior_mean as unreliable; increase n_samples/burn_in"
            )
    if metrics_log is not None:
        logger = MetricsLogger(path=metrics_log)
        logger.log({"event": "run_complete", **metrics})
        if accept_trace is not None:
            acc = accept_trace.detach().cpu().numpy()
            for i in range(0, len(acc), max(1, len(acc) // 50)):
                logger.log({"event": "accept_trace", "step": int(i),
                            "accept": float(acc[i])})
        logger.close()
    return metrics


def _resolve_n_low_modes(kp, problem):
    """The stretch dimension of the ensemble sampler: an int, or "auto" →
    the spectral-energy criterion over the KL spectrum that the config
    supplies as ``kernel_params["kl_eigenvalues"]`` (the whitened prior
    scale is isotropic and carries no mode preference)."""
    m = kp.get("n_low_modes")
    if m == "auto":
        lam = kp.get("kl_eigenvalues")
        if lam is None:
            raise ValueError(
                'n_low_modes="auto" needs kernel_params["kl_eigenvalues"] '
                "(the field's KL spectrum)"
            )
        return choose_n_low_modes(
            lam, energy_frac=kp.get("energy_frac", 0.9),
            max_modes=problem.dim,
        )
    if m is None:
        return min(8, problem.dim)
    return int(m)


def _run_fused_mcmc(problem, generator, n_chains, n_samples, device, mesh=None):
    """The fused path: burn-in launch + recorded sampling launch,
    diagnostics on the recorded series. pCN, ESS and the ensemble sampler
    are prior-reversible and consume the data misfit alone; MALA and RWM
    target the full posterior, so the whitened prior goes to the sampler,
    which adds it in its step. With a chain ``mesh`` each launch runs on
    every rank's shard (``parallel.sharded_fused_chain``, rank r's seed
    offset by r · ``SEED_STRIDE``) and its outputs are gathered."""
    kp = dict(problem.kernel_params)
    block = min(int(kp.get("block_chains", 512)), n_chains)
    run_kw = dict(prior_mean=problem.prior.mean,
                  prior_scale=problem.prior.scale, block_chains=block)
    phi = problem.batched_potential_fn
    if problem.kernel == "fes":
        run_kw.update(n_low_modes=_resolve_n_low_modes(kp, problem),
                      pcn_beta=kp.get("pcn_beta", 0.2),
                      stretch_a=kp.get("stretch_a", 2.0))
        chain, chain_rec = ops.fused_fes_chain, ops.fused_fes_chain_recorded
    elif problem.kernel == "mala":
        run_kw["step_size"] = kp.get("step_size", 0.05)
        if kp.get("warm") and problem.batched_warm_potential is not None:
            phi, run_kw["aux_dim"] = problem.batched_warm_potential
            chain = ops.fused_mala_chain_warm
            chain_rec = ops.fused_mala_chain_warm_recorded
        else:
            chain, chain_rec = ops.fused_mala_chain, ops.fused_mala_chain_recorded
    elif problem.kernel == "elliptical":
        run_kw["max_shrink"] = kp.get("max_shrink", 8)
        chain, chain_rec = ops.fused_ess_chain, ops.fused_ess_chain_recorded
    elif problem.kernel == "da_pcn":
        surr = problem.batched_surrogate_fn
        if surr is None:
            raise ValueError(
                f"config {problem.name}: fused 'da_pcn' needs "
                "batched_surrogate_fn"
            )
        run_kw["beta"] = kp.get("beta", 0.2)
        if kp.get("k_mid"):
            # three levels: inner pCN on the coarse surrogate, middle
            # corrections against batched_mid_fn, one fine correction
            mid = problem.batched_mid_fn
            if mid is None:
                raise ValueError(
                    f"config {problem.name}: fused 3-level 'da_pcn' needs "
                    "batched_mid_fn"
                )
            run_kw.update(k_inner=kp.get("k_inner", 8), k_mid=kp["k_mid"])
            chain = lambda p, pos, **kw: ops.fused_da3_pcn_chain(
                p, mid, surr, pos, **kw)
            chain_rec = lambda p, pos, **kw: ops.fused_da3_pcn_chain_recorded(
                p, mid, surr, pos, **kw)
        else:
            run_kw["subchain_len"] = kp.get("subchain_len", 4)
            chain = lambda p, pos, **kw: ops.fused_da_pcn_chain(
                p, surr, pos, **kw)
            chain_rec = lambda p, pos, **kw: ops.fused_da_pcn_chain_recorded(
                p, surr, pos, **kw)
    elif problem.kernel == "pcn":
        # kernel_params["adapt"] is ignored here, as on the JAX fused path
        run_kw["beta"] = kp.get("beta", 0.2)
        if kp.get("warm") and problem.batched_warm_potential is not None:
            phi, run_kw["aux_dim"] = problem.batched_warm_potential
            chain = ops.fused_pcn_chain_warm
            chain_rec = ops.fused_pcn_chain_warm_recorded
        else:
            chain, chain_rec = ops.fused_pcn_chain, ops.fused_pcn_chain_recorded
    elif problem.kernel == "rwm":
        # misfit + prior, as the JAX runner's phi_full; kernel_params["adapt"]
        # is ignored here, as on the JAX fused path
        run_kw["step_size"] = kp.get("step_size", 0.05)
        chain, chain_rec = ops.fused_rwm_chain, ops.fused_rwm_chain_recorded
    else:
        raise NotImplementedError(
            f"config {problem.name}: fused '{problem.kernel}' is not ported"
        )
    if mesh is not None:
        # bind the sampler now: `chain` and `chain_rec` are rebound below
        def sharded(fn):
            return lambda p, pos, **kw: parallel.sharded_fused_chain(fn, mesh, p, pos, **kw)

        chain, chain_rec = sharded(chain), sharded(chain_rec)
    positions = problem.init_positions(generator, n_chains).to(device)

    t0 = time.perf_counter()
    _barrier(device)
    first_dispatch_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    burn_out = chain(phi, positions, seed=1, n_steps=problem.burn_in, **run_kw)
    positions = burn_out[0]
    # third output: the kernel's extra_out channel (DA: inner acceptance,
    # three-level DA: middle-correction acceptance, the ensemble sampler:
    # stretch-move acceptance)
    extra_acc = burn_out[2].cpu() if len(burn_out) > 2 else None
    burn_out[1].cpu()  # transfer barrier
    burn_s = time.perf_counter() - t0

    rec_kw = dict(seed=2, n_steps=n_samples * problem.thin, thin=problem.thin,
                  **run_kw)
    t0 = time.perf_counter()
    out1 = chain_rec(phi, positions, **rec_kw)
    out1[1].cpu()
    first_rec_s = time.perf_counter() - t0
    del out1  # the first call's record buffer, before the second allocates
    t0 = time.perf_counter()
    _, acc, samples = chain_rec(phi, positions, **rec_kw)
    acc = acc.cpu()
    run_s = time.perf_counter() - t0

    summ, diag_s = _summarize_timed(samples)
    rate = n_chains * n_samples * problem.thin / run_s
    if problem.kernel == "da_pcn":
        # an outer DA step hides k (or k_inner·k_mid) surrogate proposals:
        # name the units. The three-level kernel reports its middle rate
        # (its inner rate is the two-level kernel's at the same β).
        if kp.get("k_mid"):
            extra_key = "mid_accept_rate"
            k_total = int(kp.get("k_inner", 8)) * int(kp["k_mid"])
        else:
            extra_key = "inner_accept_rate"
            k_total = int(kp.get("subchain_len", 4))
        extra = {extra_key: float(extra_acc.mean())}
        rate_keys = {
            "outer_steps_per_s": rate,
            "inner_steps_per_s": rate * k_total,
        }
    else:
        extra = ({} if extra_acc is None
                 else {"stretch_accept_rate": float(extra_acc.mean())})
        rate_keys = {"steps_per_s": rate}
    return {
        **extra,
        "config": problem.name,
        "kernel": f"{problem.kernel}(fused)",
        "n_chains": int(n_chains),
        "n_samples": int(n_samples),
        "dim": int(problem.dim),
        "first_dispatch_s": first_dispatch_s,
        "warmup_s": burn_s,
        "compile_s": max(first_rec_s - run_s, 0.0),
        "run_s": run_s,
        **rate_keys,
        "diag_s": diag_s,
        "min_ess": float(summ["min_ess"]),
        "ess_per_s": float(summ["min_ess"]) / run_s,
        "max_rhat": float(summ["max_rhat"]),
        "accept_rate": float(acc.mean()),
        "posterior_mean": summ["mean"].tolist(),
    }


# --- the scan path -------------------------------------------------------------


def _setup_kernel_state(problem, positions, generator):
    """(kernel, state, warm_steps) of the scan path. With
    ``kernel_params["adapt"]`` the warm-up (``problem.burn_in`` steps,
    drawn from ``generator``) replaces the burn-in, and ``warm_steps``
    counts its chain steps; ``map_init`` (MALA, HMC, NUTS) first moves the
    positions by that many Adam iterations, which are not chain steps."""
    kp = dict(problem.kernel_params)
    adapt = kp.pop("adapt", False)
    map_init = kp.pop("map_init", 0)
    kp.pop("fused", None)
    kp.pop("block_chains", None)
    kp.pop("vi_init", None)  # the warm starts: consumed by run_problem
    kp.pop("pod_enrich", None)
    warm_steps = 0
    num_warm = problem.burn_in or 300
    if map_init and problem.kernel in ("mala", "hmc", "nuts"):
        positions = map_localize(problem.log_density_fn, positions,
                                 num_steps=map_init)
    if problem.kernel == "rwm":
        logpi = problem.log_density_fn
        state = driver.init_chains(rwm.init, positions, logpi)
        if adapt:
            warm_steps += num_warm
            state, step_size, chol = warmup_rwm(
                logpi, state, generator, num_steps=num_warm,
                initial_step_size=kp.get("step_size", 0.5))
            kernel = rwm.build_kernel(logpi, step_size=step_size, scale=chol)
        else:
            kernel = rwm.build_kernel(logpi, **kp)
    elif problem.kernel == "pcn":
        phi, prior = problem.potential_fn, problem.prior
        state = driver.init_chains(pcn.init, positions, phi)
        if adapt:
            warm_steps += num_warm
            state, beta = warmup_pcn(
                phi, prior, state, generator, num_steps=num_warm,
                initial_beta=kp.get("beta", 0.2))
            kernel = pcn.build_kernel(phi, prior, beta=beta)
        else:
            kernel = pcn.build_kernel(phi, prior, **kp)
    elif problem.kernel == "da_pcn":
        phi, prior = problem.potential_fn, problem.prior
        surr = problem.surrogate_potential_fn
        if surr is None:
            raise ValueError(
                f"config {problem.name}: kernel 'da_pcn' needs surrogate_potential_fn")
        if "k_mid" in kp or "k_inner" in kp:
            raise ValueError(
                f"config {problem.name}: 3-level delayed acceptance "
                "(k_inner/k_mid) is fused-only — set kernel_params"
                "['fused']=True and provide batched potential/mid/surrogate "
                "functions (see burgers_da3_pcn)")
        state = driver.init_chains(da_pcn.init, positions, phi, surr)
        kernel = da_pcn.build_kernel(phi, surr, prior, **kp)
    elif problem.kernel == "elliptical":
        phi, prior = problem.potential_fn, problem.prior
        state = driver.init_chains(elliptical.init, positions, phi)
        kernel = elliptical.build_kernel(phi, prior, **kp)
    elif problem.kernel == "mala":
        logpi = problem.log_density_fn
        state = driver.init_chains(mala.init, positions, logpi)
        if adapt:
            warm_steps += num_warm
            state, eps, precond = warmup_mala(
                logpi, state, generator, num_steps=num_warm,
                initial_step_size=kp.get("step_size", 0.05))
            kernel = mala.build_kernel(logpi, step_size=eps, precond=precond)
        else:
            kernel = mala.build_kernel(logpi, **kp)
    elif problem.kernel == "hmc":
        logpi = problem.log_density_fn
        state = driver.init_chains(hmc.init, positions, logpi)
        nint = kp.get("num_integration_steps", 8)
        if adapt:
            warm_steps += num_warm
            state, eps, inv_mass = warmup_hmc(
                logpi, state, generator, num_steps=num_warm,
                num_integration_steps=nint,
                initial_step_size=kp.get("step_size", 0.1))
            kernel = hmc.build_kernel(logpi, step_size=eps,
                                      num_integration_steps=nint, inv_mass=inv_mass)
        else:
            kernel = hmc.build_kernel(logpi, **kp)
    elif problem.kernel == "nuts":
        logpi = problem.log_density_fn
        state = driver.init_chains(nuts.init, positions, logpi)
        md = kp.get("max_depth", 8)
        if adapt:
            num_warm = problem.burn_in or 200
            warm_steps += num_warm
            state, eps, inv_mass = warmup_nuts(
                logpi, state, generator, num_steps=num_warm, max_depth=md,
                initial_step_size=kp.get("step_size", 0.1))
            kernel = nuts.build_kernel(logpi, step_size=eps, max_depth=md,
                                       inv_mass=inv_mass)
        else:
            kernel = nuts.build_kernel(logpi, **kp)
    else:
        raise ValueError(f"unknown scan kernel {problem.kernel}")
    return kernel, state, warm_steps


def _run_one_dispatch(problem, seed, n_chains, n_samples, device, profile_dir=None,
                      mesh=None):
    """The scan path (the JAX runner's ``_run_one_dispatch``): warm-up +
    burn-in + sampling + ESS/R̂ diagnostics, run twice from the same seed;
    the second, identical run is timed as ``run_s`` and the first one's
    excess is ``first_dispatch_s``. The JAX package traces and compiles all
    of it into one program; PyTorch runs it eagerly, so nothing is traced or
    compiled (``trace_s`` and ``compile_s`` are 0.0), and the scan path
    launches no kernel of the port, so nothing is built. ``program_count``
    stays 1: one pass of the pipeline per run. The initial positions come
    from a host generator seeded with ``seed``; the warm-up and the sampling
    draw from two generators on ``device``, seeded with ``seed`` + 1 and
    ``seed`` + 2. ``steps_per_s`` counts every chain step of a run (warm-up,
    burn-in, sampling); ``sampling_steps_per_s`` the sampling steps. With
    ``profile_dir`` the timed run is traced by ``torch.profiler`` (host
    and card) into the Chrome trace ``{profile_dir}/{config}_run.trace.json``
    (``utils.logging.profile_region``), where the JAX runner traces it.
    With a chain ``mesh`` the warm-up runs whole on every rank and the
    sampling on each rank's rows (``parallel.sample_chains_sharded``): the
    single-process run's samples and statistics, bit for bit. Returns
    (metrics, the chain-mean acceptance of each retained step, or None)."""
    kp = problem.kernel_params
    burn = 0 if kp.get("adapt", False) else problem.burn_in
    thin = problem.thin
    positions = problem.init_positions(
        torch.Generator().manual_seed(int(seed)), n_chains).to(device)

    def pipeline():
        gen_warm = torch.Generator(device).manual_seed(int(seed) + 1)
        gen_run = torch.Generator(device).manual_seed(int(seed) + 2)
        kernel, state, warm_steps = _setup_kernel_state(problem, positions,
                                                        gen_warm)
        if mesh is None:
            _, samples, info_means = driver.sample_chains(
                kernel, state, gen_run, n_samples=n_samples, burn_in=burn,
                thin=thin)
        else:
            _, samples, info_means = parallel.sample_chains_sharded(
                kernel, state, gen_run, mesh, n_samples=n_samples, burn_in=burn,
                thin=thin)
        summ = diagnostics.summarize(samples)
        float(summ["min_ess"])  # the device's work is done
        return summ, info_means, warm_steps

    t0 = time.perf_counter()
    pipeline()
    first_call_s = time.perf_counter() - t0
    with profile_region(f"{problem.name}_run", profile=bool(profile_dir),
                        profile_dir=profile_dir):
        t0 = time.perf_counter()
        summ, info_means, warm_steps = pipeline()
        run_s = time.perf_counter() - t0

    total_steps = (warm_steps + burn + n_samples * thin) * n_chains
    flat_mean = summ["mean"].cpu().numpy()
    metrics = {
        "config": problem.name,
        "kernel": problem.kernel,
        "n_chains": int(n_chains),
        "n_samples": int(n_samples),
        "dim": int(problem.dim),
        "program_count": 1,
        "trace_s": 0.0,
        "compile_s": 0.0,
        "first_dispatch_s": max(first_call_s - run_s, 0.0),
        "run_s": run_s,
        "warm_steps": int(warm_steps),
        "burn_steps": int(burn),
        "sampling_steps": int(n_samples * thin),
        "sampling_steps_per_s": n_samples * thin * n_chains / run_s,
        "min_ess": float(summ["min_ess"]),
        "ess_per_s": float(summ["min_ess"]) / run_s,
        "max_rhat": float(summ["max_rhat"]),
        "posterior_mean": flat_mean.tolist(),
    }
    if kp.get("map_init"):
        metrics["map_init_iters"] = int(kp["map_init"])
    if problem.kernel == "da_pcn":
        # an outer step hides subchain_len surrogate steps: name the unit
        k_total = int(kp.get("subchain_len", 4))
        metrics["outer_steps_per_s"] = total_steps / run_s
        metrics["inner_steps_per_s"] = total_steps * k_total / run_s
    else:
        metrics["steps_per_s"] = total_steps / run_s
    if hasattr(info_means, "accepted"):  # ESS has no accept/reject
        metrics["accept_rate"] = float(info_means.accepted.mean())
    if problem.kernel == "nuts":  # the mean leaf acceptance, and the tree depth
        metrics["accept_rate"] = float(info_means.accept_prob.mean())
        metrics["mean_tree_depth"] = float(info_means.depth.mean())
    if problem.exact_mean is not None:
        metrics["mean_error_vs_exact"] = float(
            np.abs(flat_mean - problem.exact_mean).max())
    trace = getattr(info_means, "accepted", getattr(info_means, "accept_prob", None))
    return metrics, trace


def _run_composed(problem, seed, n_chains, n_samples, device, mesh=None):
    """The composed ('chains', 'model') mesh path (the JAX runner's
    ``_run_composed``): pCN, MALA or ESS with the chains sharded over
    'chains' and every chain's Darcy solve row-sharded over 'model'
    (``parallel/composed.py``). The mesh is the caller's ``mesh`` (any
    (c, m) shape of the world), else one of shape
    ``kernel_params["mesh_shape"]``, else, from the world's size w (a world
    of one on ``device`` if none runs), (w / m, m) with m the first of 4, 2
    that divides both w and the grid, else 1. Positions from a host
    generator seeded with ``seed``; the draws from the counter-hash stream
    of seed + 2. Samples twice; the second run is ``run_s``."""
    kp = dict(problem.kernel_params)
    aux = kp.pop("aux")
    noise_scale = kp.pop("noise_scale")
    cg_iters = kp.get("cg_iters", 150)
    if mesh is None:
        mesh_shape = kp.get("mesh_shape")
        if mesh_shape is None:
            parallel.distributed_init(device=device)
            n_dev = torch.distributed.get_world_size()
            n_grid = int(aux["n_grid"])
            m = next((c for c in (4, 2) if n_dev % c == 0 and n_grid % c == 0), 1)
            mesh_shape = (n_dev // m, m)
        mesh = composed.make_composed_mesh(*mesh_shape, device=device)
        _check_mesh_device(mesh, device)
    u0 = problem.init_positions(torch.Generator().manual_seed(int(seed)), n_chains)
    common = dict(mesh=mesh, u0=u0, seed=int(seed) + 2, n_samples=n_samples,
                  burn_in=problem.burn_in, thin=problem.thin, cg_iters=cg_iters)
    if problem.kernel == "ess_composed":
        def sample():
            return composed.sample_composed_elliptical(
                aux, problem.data, noise_scale, max_shrink=kp.get("max_shrink", 20), **common)
    elif problem.kernel == "mala_composed":
        def sample():
            return composed.sample_composed_mala(
                aux, problem.data, noise_scale, step_size=kp.get("step_size", 0.05), **common)
    else:
        def sample():
            return composed.sample_composed_pcn(
                aux, problem.data, noise_scale, beta=kp.get("beta", 0.2), **common)

    t0 = time.perf_counter()
    float(sample()[1])
    compile_and_run_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    samples, stat = sample()
    stat = float(stat)
    run_s = time.perf_counter() - t0

    summ, diag_s = _summarize_timed(samples)
    total_steps = problem.burn_in + n_samples * problem.thin
    return {
        "config": problem.name,
        "kernel": f"{problem.kernel.split('_')[0]}(composed chains x model)",
        "mesh_shape": list(mesh.shape),
        "n_chains": int(n_chains),
        "n_samples": int(n_samples),
        "dim": int(problem.dim),
        "compile_s": max(compile_and_run_s - run_s, 0.0),
        "run_s": run_s,
        "steps_per_s": n_chains * total_steps / run_s,
        "diag_s": diag_s,
        "min_ess": float(summ["min_ess"]),
        "ess_per_s": float(summ["min_ess"]) / run_s,
        "max_rhat": float(summ["max_rhat"]),
        # elliptical slice sampling rejects nothing: its statistic is the
        # mean number of forward evaluations a step
        ("mean_evals_per_step" if problem.kernel == "ess_composed"
         else "accept_rate"): stat,
        "posterior_mean": summ["mean"].tolist(),
    }


def _check_mesh_device(mesh, device):
    """A mesh's world runs on one kind of device, the one asked for: a
    gloo world never stands in for the card, nor NCCL for the CPU."""
    if mesh.device.type != torch.device(device).type:
        raise ValueError(
            f"the mesh's world runs on {mesh.device.type} "
            f"({torch.distributed.get_backend()}), the run asked for {device}")


def _run_chees(problem, seed, n_chains, n_samples, device):
    """ChEES-HMC (the JAX runner's ``_run_chees``): the batch kernel's own
    warm-up (``problem.burn_in`` steps, timed as ``warmup_s``), then the
    sampling with (ε, τ) frozen, run twice from the same seed; the second
    run is ``run_s``. Positions from a host generator seeded with ``seed``,
    moved by ``map_init`` Adam iterations; the warm-up and the sampling
    draw from generators on ``device`` seeded with ``seed`` + 1 and + 2."""
    kp = dict(problem.kernel_params)
    logpi = problem.log_density_fn
    positions = problem.init_positions(
        torch.Generator().manual_seed(int(seed)), n_chains).to(device)
    map_init = kp.pop("map_init", 0)
    if map_init:
        positions = map_localize(logpi, positions, num_steps=map_init)

    t0 = time.perf_counter()
    state, eps, traj, inv_mass = chees_hmc.warmup_chees(
        logpi, positions, torch.Generator(device).manual_seed(int(seed) + 1),
        num_steps=problem.burn_in or 400, initial_step_size=kp.get("step_size", 0.1),
        initial_trajectory=kp.get("trajectory_length", 1.0))
    _barrier(device)
    warm_s = time.perf_counter() - t0

    def sample():
        out = chees_hmc.sample_chees(
            logpi, state, torch.Generator(device).manual_seed(int(seed) + 2), eps, traj,
            inv_mass, n_samples=n_samples, burn_in=0, thin=problem.thin)
        _barrier(device)
        return out

    t0 = time.perf_counter()
    sample()
    compile_and_run_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, samples, infos = sample()
    run_s = time.perf_counter() - t0

    summ, diag_s = _summarize_timed(samples)
    return {
        "config": problem.name,
        "kernel": "chees",
        "n_chains": int(n_chains),
        "n_samples": int(n_samples),
        "dim": int(problem.dim),
        "warmup_s": warm_s,
        "compile_s": max(compile_and_run_s - run_s, 0.0),
        "run_s": run_s,
        "steps_per_s": n_samples * problem.thin * n_chains / run_s,
        "diag_s": diag_s,
        "min_ess": float(summ["min_ess"]),
        "ess_per_s": float(summ["min_ess"]) / run_s,
        "max_rhat": float(summ["max_rhat"]),
        "accept_rate": float(infos.accept_prob.mean()),
        "step_size": float(eps),
        "trajectory_length": float(traj),
        "posterior_mean": summ["mean"].tolist(),
    }


def _run_fes(problem, seed, n_chains, n_samples, device):
    """The functional ensemble sampler's scan path (the JAX runner's
    ``_run_fes``): the walker ensemble is the chain axis; sampling runs
    twice from the same seed and the second run is ``run_s``. Positions
    from a host generator seeded with ``seed``, the run from one on
    ``device`` seeded with ``seed`` + 2."""
    kp = dict(problem.kernel_params)
    positions = problem.init_positions(
        torch.Generator().manual_seed(int(seed)), n_chains).to(device)

    def sample():
        out = ensemble.sample_fes(
            problem.potential_fn, problem.prior, positions,
            torch.Generator(device).manual_seed(int(seed) + 2),
            _resolve_n_low_modes(kp, problem),
            stretch_a=kp.get("stretch_a", 2.0), pcn_beta=kp.get("pcn_beta", 0.2),
            n_samples=n_samples, burn_in=problem.burn_in, thin=problem.thin)
        _barrier(device)
        return out

    t0 = time.perf_counter()
    sample()
    compile_and_run_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, samples, infos = sample()
    run_s = time.perf_counter() - t0

    summ, diag_s = _summarize_timed(samples)
    return {
        "config": problem.name,
        "kernel": "fes",
        "n_chains": int(n_chains),
        "n_samples": int(n_samples),
        "dim": int(problem.dim),
        "compile_s": max(compile_and_run_s - run_s, 0.0),
        "run_s": run_s,
        "steps_per_s": (problem.burn_in + n_samples * problem.thin) * n_chains / run_s,
        "diag_s": diag_s,
        "min_ess": float(summ["min_ess"]),
        "ess_per_s": float(summ["min_ess"]) / run_s,
        "max_rhat": float(summ["max_rhat"]),
        "accept_rate": float(infos.stretch_accept.mean()),
        "pcn_accept_rate": float(infos.pcn_accept.mean()),
        "posterior_mean": summ["mean"].tolist(),
    }


def _pt_pair_metrics(infos, n_temps, adapt_pair_rates):
    """Per-pair swap acceptance per attempt: the chain means of
    pair_swap_prob (0 when inactive) over those of pair_active, summed over
    the retained steps."""
    prob = infos.pair_swap_prob[:, : n_temps - 1].cpu().numpy()
    act = infos.pair_active[:, : n_temps - 1].cpu().numpy()
    rates = prob.sum(axis=0) / np.maximum(act.sum(axis=0), 1e-9)
    out = {
        "swap_rate_per_pair": rates.tolist(),
        "swap_spread": float(rates.max() - rates.min()),
    }
    if adapt_pair_rates is not None:
        out["adapt_pair_rates"] = adapt_pair_rates.cpu().tolist()
    return out


def _run_pt(problem, seed, n_chains, n_samples, device):
    """Parallel tempering (the JAX runner's ``_run_pt``): equi-acceptance
    ladder adaptation (doubling as burn-in, timed as ``warmup_s``), then the
    frozen-ladder kernel, sampled twice from the same seed with the cold
    replica recorded; the second run is ``run_s``. ``mode_balance`` is the
    share of cold samples with a positive first coordinate. Positions from
    a host generator seeded with ``seed``; the adaptation and the sampling
    draw from generators on ``device`` seeded with ``seed`` + 1 and + 2."""
    kp = dict(problem.kernel_params)
    n_temps = kp.get("n_temps", 8)
    beta_min = kp.get("beta_min", 0.05)
    pcn_step = kp.get("pcn_step", 0.25)
    mutation = kp.get("mutation", "pcn")
    phi, prior = problem.potential_fn, problem.prior
    positions = problem.init_positions(
        torch.Generator().manual_seed(int(seed)), n_chains).to(device)

    t0 = time.perf_counter()
    adapt_pair_rates = None
    if kp.get("adapt_ladder", True):
        states, betas, adapt_pair_rates = tempering.adapt_ladder(
            phi, prior, positions, torch.Generator(device).manual_seed(int(seed) + 1),
            n_temps=n_temps, num_steps=problem.burn_in or 300,
            swap_center=kp.get("swap_center", 0.4),
            pcn_step=pcn_step, beta_min=beta_min, mutation=mutation,
            step_size=kp.get("step_size", 0.05))
        burn = 0
    else:
        betas = tempering.geometric_ladder(n_temps, beta_min)
        init = tempering.init_mala if mutation == "mala" else tempering.init
        states = init(positions, phi, n_temps)
        burn = problem.burn_in
    if mutation == "mala":
        kernel = tempering.build_mala_kernel(phi, prior, betas,
                                             step_size=kp.get("step_size", 0.05))
    else:
        kernel = tempering.build_kernel(phi, prior, betas, pcn_step=pcn_step)
    _barrier(device)
    warm_s = time.perf_counter() - t0

    def sample():
        out = driver.sample_chains(
            kernel, states, torch.Generator(device).manual_seed(int(seed) + 2),
            n_samples=n_samples, burn_in=burn, thin=problem.thin,
            record_fn=tempering.cold_chain)
        _barrier(device)
        return out

    t0 = time.perf_counter()
    sample()
    compile_and_run_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, samples, infos = sample()
    run_s = time.perf_counter() - t0

    summ, diag_s = _summarize_timed(samples)
    steps = (burn + n_samples * problem.thin) * n_chains
    return {
        "config": problem.name,
        "kernel": f"pt({mutation})",
        "n_chains": int(n_chains),
        "n_temps": int(n_temps),
        "n_samples": int(n_samples),
        "dim": int(problem.dim),
        "warmup_s": warm_s,
        "compile_s": max(compile_and_run_s - run_s, 0.0),
        "run_s": run_s,
        # one PT step = n_temps replica mutations + a swap round
        "steps_per_s": steps / run_s,
        "replica_steps_per_s": steps * n_temps / run_s,
        "diag_s": diag_s,
        "min_ess": float(summ["min_ess"]),
        "ess_per_s": float(summ["min_ess"]) / run_s,
        "max_rhat": float(summ["max_rhat"]),
        "accept_rate": float(infos.accept_rate.mean()),
        "swap_rate_per_attempt": float(infos.swap_rate.mean()),
        **_pt_pair_metrics(infos, n_temps, adapt_pair_rates),
        "betas": torch.as_tensor(betas).cpu().tolist(),
        "mode_balance": float((samples[..., 0] > 0).to(torch.float32).mean()),
        "posterior_mean": summ["mean"].tolist(),
    }


def _run_smc(problem, seed, n_particles, device):
    """Tempered SMC (the JAX runner's ``_run_smc``): ``smc.run`` on the
    single-particle potential, or with ``kernel_params["batched"]``
    ``smc.run_batched`` on the batched one (with ``warm``, the warm misfit
    carrying each particle's solve). Runs twice, each from a generator on
    ``device`` seeded with ``seed``; the second run is ``run_s``, the first
    one's excess ``compile_s`` (the kernels' build at first use)."""
    kp = dict(problem.kernel_params)
    if kp.pop("batched", False):
        extra = {}
        if kp.pop("warm", False) and problem.batched_warm_potential is not None:
            phi2, aux_dim = problem.batched_warm_potential
            extra = dict(warm_potential_fn=phi2, aux_dim=aux_dim)
        kernel_name = "smc(batched" + ("+warm)" if extra else ")")

        def go():
            return smc.run_batched(
                problem.batched_potential_fn, problem.prior.mean, problem.prior.scale,
                torch.Generator(device).manual_seed(int(seed)), n_particles=n_particles,
                **extra, **kp)

        particle_axis = 1
    else:
        kernel_name = "smc"

        def go():
            return smc.run(problem.potential_fn, problem.prior,
                           torch.Generator(device).manual_seed(int(seed)),
                           n_particles=n_particles, **kp)

        particle_axis = 0

    t0 = time.perf_counter()
    go()
    _barrier(device)
    compile_and_run = time.perf_counter() - t0
    t0 = time.perf_counter()
    state, info = go()
    _barrier(device)
    run_s = time.perf_counter() - t0
    n_stages = int(info.n_stages)
    return {
        "config": problem.name,
        "kernel": kernel_name,
        "n_particles": int(n_particles),
        "dim": int(problem.dim),
        "compile_s": max(compile_and_run - run_s, 0.0),
        "run_s": run_s,
        "n_stages": n_stages,
        "log_evidence": float(state.log_z),
        "log_evidence_ti": smc.thermodynamic_log_z(info),
        "final_beta": float(state.beta),
        "mean_mutation_accept": float(np.nanmean(info.accept_rates[:n_stages].cpu().numpy())),
        "posterior_mean": state.particles.mean(dim=particle_axis).cpu().tolist(),
        "particles_per_s": n_particles * n_stages / run_s,
    }


def _run_vi(problem, seed, device):
    """ADVI (the JAX runner's ``_run_vi``): fit once, from a generator on
    ``device`` seeded with ``seed``; the fitted moments, and their errors
    against the exact posterior where the config has one (the truth as the
    mean, ``kernel_params["exact_cov"]``)."""
    kp = dict(problem.kernel_params)
    exact_cov = kp.pop("exact_cov", None)
    num_steps = kp.get("num_steps", 2000)
    t0 = time.perf_counter()
    params, elbo = vi.fit(
        problem.log_density_fn, problem.dim, torch.Generator(device).manual_seed(int(seed)),
        num_steps=num_steps, n_samples=kp.get("n_mc_samples", 64),
        learning_rate=kp.get("learning_rate", 5e-2), full_rank=kp.get("full_rank", False))
    _barrier(device)
    fit_s = time.perf_counter() - t0
    mean, cov = (t.cpu().numpy() for t in vi.posterior_moments(params))
    elbo = elbo.cpu().numpy()
    metrics = {
        "config": problem.name,
        "kernel": "vi" + ("(full_rank)" if kp.get("full_rank") else "(mean_field)"),
        "dim": int(problem.dim),
        "num_steps": int(num_steps),
        "fit_s": fit_s,
        "elbo_steps_per_s": num_steps / fit_s,
        "final_elbo": float(elbo[-100:].mean()),  # the tail, averaged over MC noise
        "posterior_mean": mean.tolist(),
    }
    if problem.truth is not None:
        metrics["mean_error_vs_exact"] = float(np.abs(mean - np.asarray(problem.truth)).max())
    if exact_cov is not None:
        metrics["cov_error_vs_exact"] = float(np.abs(cov - np.asarray(exact_cov)).max())
    return metrics


def _vi_warm_start(problem, seed, device):
    """``kernel_params["vi_init"]``: a short ADVI fit (generator on
    ``device`` seeded with ``seed`` + 71) whose family becomes the chains'
    initialiser (``init_positions_fn``). Returns what the warm start buys:
    the mean misfit of VI draws beside prior draws, both from the same
    standard normals (host generators seeded with ``seed`` + 72)."""
    cfg = problem.kernel_params["vi_init"]
    cfg = cfg if isinstance(cfg, dict) else {}
    t0 = time.perf_counter()
    params, elbo = vi.fit(
        problem.log_density_fn, problem.dim,
        torch.Generator(device).manual_seed(int(seed) + 71),
        num_steps=cfg.get("num_steps", 800), n_samples=cfg.get("n_mc_samples", 32),
        learning_rate=cfg.get("learning_rate", 5e-2), full_rank=cfg.get("full_rank", False))
    _barrier(device)
    fit_s = time.perf_counter() - t0
    problem.init_positions_fn = lambda g, n: vi.warm_start(params, g, n)

    n_cmp = min(256, problem.n_chains or 256)
    vi_pos = vi.warm_start(params, torch.Generator().manual_seed(int(seed) + 72), n_cmp)
    prior_pos = problem.prior.sample(torch.Generator().manual_seed(int(seed) + 72), n_cmp)
    return {
        "vi_fit_s": fit_s,
        "vi_final_elbo": float(elbo[-50:].mean()),
        "init_potential_vi": float(problem.potential_fn(vi_pos).mean()),
        "init_potential_prior": float(problem.potential_fn(prior_pos).mean()),
    }


def _pod_enrich_burnin(problem, seed, n_chains, device):
    """Online POD enrichment during burn-in (the JAX runner's
    ``_pod_enrich_burnin``): ``epochs`` segments of ``segment_steps`` scan
    DA-pCN steps; after each, ``problem.surrogate_enrich_fn`` full-solves
    the positions with the worst reduced residual and rebuilds the basis.
    The surrogate is then frozen on ``problem`` with the positions as the
    chains' start and the burn-in shortened by the steps taken, so the
    recorded chain is a time-homogeneous DA kernel. Positions from a host
    generator seeded with ``seed`` + 72, segment e's draws from one on
    ``device`` seeded with ``seed`` + 73 + e. Returns the indicator
    history."""
    if problem.surrogate_enrich_fn is None:
        raise ValueError(
            f"config {problem.name}: kernel_params['pod_enrich'] needs "
            "surrogate_enrich_fn (see darcy.make_pod_surrogate_online)")
    spec = problem.kernel_params["pod_enrich"]
    spec = spec if isinstance(spec, dict) else {}
    epochs, seg = int(spec.get("epochs", 3)), int(spec.get("segment_steps", 40))
    kp = {k: v for k, v in problem.kernel_params.items() if k in ("beta", "subchain_len")}
    phi, prior, surr = problem.potential_fn, problem.prior, problem.surrogate_potential_fn
    t0 = time.perf_counter()
    positions = problem.init_positions(
        torch.Generator().manual_seed(int(seed) + 72), n_chains).to(device)
    history = []
    for e in range(epochs):
        kernel = da_pcn.build_kernel(phi, surr, prior, **kp)
        state = driver.init_chains(da_pcn.init, positions, phi, surr)
        state, _, _ = driver.sample_chains(
            kernel, state, torch.Generator(device).manual_seed(int(seed) + 73 + e),
            n_samples=1, burn_in=seg - 1)
        positions = state.position
        surr, stats = problem.surrogate_enrich_fn(positions)
        history.append(stats)

    problem.surrogate_potential_fn = surr
    problem.init_positions_fn = lambda g, n: positions[:n]
    problem.burn_in = max(problem.burn_in - epochs * seg, 0)
    return {
        "pod_enrich_epochs": epochs,
        "pod_enrich_segment_steps": seg,
        "pod_enrich_s": time.perf_counter() - t0,
        "pod_enrich_indicator_max": [h["indicator_max"] for h in history],
        "pod_enrich_indicator_mean": [h["indicator_mean"] for h in history],
    }


def _refuse(problem, what):
    raise NotImplementedError(
        f"config {problem.name}: {what} is not ported. Ported are the fused "
        f"{', '.join(FUSED_KERNELS)} paths (kernel_params['fused'] and a "
        "batched potential; pass --fused to a pCN config that has one), the "
        f"scan {', '.join(SCAN_KERNELS)} paths and the scan chees, fes and pt paths "
        "of the configs with a potential_fn, tempered SMC (smc; batched and "
        "warm with kernel_params['batched']), ADVI (vi), the vi_init warm "
        "start and pod_enrich on the scan da_pcn path, and the composed "
        f"{', '.join(COMPOSED_KERNELS)} paths")


def run_problem(problem, device, seed: int = 0, n_chains=None,
                n_samples=None, profile_dir=None, metrics_log=None, mesh=None):
    """Execute a Problem end-to-end on ``device``; returns a metrics dict.
    ``seed`` seeds the host-side ``torch.Generator`` of the initial
    positions (and, on the scan paths, the device generators of the
    warm-up and the sampling; SMC and VI draw from a device generator
    seeded with it). ``profile_dir``: trace the scan path's timed run into
    it (``_run_one_dispatch``); ``metrics_log``: append the run's records
    to that JSON-lines file (``_finalize``), on every path. ``mesh``: a
    chain mesh (``parallel.make_chain_mesh``) whose ranks share the chains
    of the fused and the one-dispatch scan paths, or the composed configs'
    mesh; its world must run on ``device``'s kind of device. A mesh of more
    than one rank on a path that does not shard raises ``ValueError``."""
    t_start = time.perf_counter()
    device = torch.device(device)
    n_chains = n_chains or problem.n_chains
    n_samples = n_samples or problem.n_samples
    kp = problem.kernel_params
    if mesh is not None:
        _check_mesh_device(mesh, device)
        device = mesh.device
    if problem.kernel in COMPOSED_KERNELS:
        return _finalize(_run_composed(problem, seed, n_chains, n_samples, device, mesh),
                         t_start, metrics_log)
    fused = (problem.kernel in FUSED_KERNELS and kp.get("fused")
             and problem.batched_potential_fn is not None)
    sharded = fused or (problem.kernel in SCAN_KERNELS and problem.potential_fn is not None)
    if mesh is not None and mesh.size > 1 and not sharded:
        raise ValueError(
            f"config {problem.name}: the '{problem.kernel}' path does not shard, so "
            f"each of the mesh's {mesh.size} ranks would run the whole problem; the "
            f"paths that shard are the fused ({', '.join(FUSED_KERNELS)}), the "
            f"one-dispatch scan ({', '.join(SCAN_KERNELS)}) and the composed "
            f"({', '.join(COMPOSED_KERNELS)}) ones (run this config in one process)")
    if problem.kernel == "vi":
        return _finalize(_run_vi(problem, seed, device), t_start, metrics_log)

    trace = None  # the scan path's acceptance trace
    extra = {}
    pod_enrich = problem.kernel == "da_pcn" and kp.get("pod_enrich")
    if kp.get("vi_init") or pod_enrich:
        # the warm starts install init_positions_fn, a surrogate and a
        # shorter burn-in: on a shallow copy, so that the caller's problem
        # starts from its configured state on a second run
        problem = dataclasses.replace(problem)
    if kp.get("vi_init"):
        extra = _vi_warm_start(problem, seed, device)
    if pod_enrich:
        if kp.get("fused"):
            # the fused branch reads batched_surrogate_fn, which enrichment
            # does not rebuild
            raise ValueError(
                f"config {problem.name}: kernel_params['pod_enrich'] is not "
                "supported with fused=True — enrichment rebuilds the unfused "
                "surrogate_potential_fn only (use the scan da_pcn path, or "
                "drop pod_enrich)")
        extra.update(_pod_enrich_burnin(problem, seed, n_chains, device))

    if problem.kernel == "smc":
        return _finalize(_run_smc(problem, seed, n_chains, device), t_start, metrics_log)
    if fused:
        generator = torch.Generator().manual_seed(int(seed))
        metrics = _run_fused_mcmc(problem, generator, n_chains, n_samples,
                                  device, mesh=mesh)
    elif problem.potential_fn is None:
        _refuse(problem, f"the scan '{problem.kernel}' path without a "
                "single-particle potential_fn")
    elif problem.kernel == "chees":
        metrics = _run_chees(problem, seed, n_chains, n_samples, device)
    elif problem.kernel == "fes":
        metrics = _run_fes(problem, seed, n_chains, n_samples, device)
    elif problem.kernel == "pt":
        metrics = _run_pt(problem, seed, n_chains, n_samples, device)
    elif problem.kernel in SCAN_KERNELS:
        metrics, trace = _run_one_dispatch(problem, seed, n_chains, n_samples, device,
                                           profile_dir=profile_dir, mesh=mesh)
    else:
        _refuse(problem, f"the '{problem.kernel}' kernel")
    metrics.update(extra)
    return _finalize(metrics, t_start, metrics_log, trace)
