"""Problem runner: config → burn-in launch → recorded sampling launch →
diagnostics (mirrors ``ip_mcmc_tpu/runner.py``: ``run_problem``,
``_run_fused_mcmc``'s ``da_pcn`` (two- and three-level), ``pcn`` (cold and
warm), ``elliptical``, ``fes`` and ``mala`` (cold and warm) branches,
``_resolve_n_low_modes``, ``_finalize``). Returns the JAX runner's JSON-able metrics dict, key for
key.

Timing protocol (as the JAX runner's): the burn launch uses seed 1 and
is timed as ``warmup_s`` (on the card it also pays the kernels' build at
first use); the recorded launch uses seed 2 and runs twice — the first
call builds and runs, the identical second call is timed as ``run_s``, and
the difference is ``compile_s``. ``first_dispatch_s`` is the time of the
first device synchronisation.
"""

from __future__ import annotations

import time

import torch

from ip_mcmc_tpu_torch import diagnostics
from ip_mcmc_tpu_torch import ops
from ip_mcmc_tpu_torch.ops.fused_fes import choose_n_low_modes

# metric keys that name wall-time phases (attribution in _finalize)
_PHASE_KEYS = ("warmup_s", "compile_s", "first_dispatch_s", "run_s", "diag_s")


def _barrier(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _summarize_timed(samples):
    t0 = time.perf_counter()
    summ = diagnostics.summarize(samples)
    summ = {k: v.cpu() for k, v in summ.items()}
    return summ, time.perf_counter() - t0


def _finalize(metrics, t_start):
    """End-to-end wall, unattributed remainder, the per-invocation ESS rate
    and the R̂ convergence flag (``runner._finalize``)."""
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


def _run_fused_mcmc(problem, generator, n_chains, n_samples, device):
    """The fused path: burn-in launch + recorded sampling launch,
    diagnostics on the recorded series. pCN, ESS and the ensemble sampler
    are prior-reversible and consume the data misfit alone; MALA targets
    the full posterior, so the whitened prior goes to the sampler, which
    folds it in."""
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
    else:
        raise NotImplementedError(
            f"config {problem.name}: fused '{problem.kernel}' is not ported"
        )
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


def run_problem(problem, device, seed: int = 0, n_chains=None,
                n_samples=None):
    """Execute a Problem end-to-end on ``device``; returns a metrics dict.
    ``seed`` seeds the host-side ``torch.Generator`` of the initial
    positions."""
    t_start = time.perf_counter()
    device = torch.device(device)
    n_chains = n_chains or problem.n_chains
    n_samples = n_samples or problem.n_samples
    if not (problem.kernel in ("pcn", "elliptical", "da_pcn", "fes", "mala")
            and problem.kernel_params.get("fused")
            and problem.batched_potential_fn is not None):
        raise NotImplementedError(
            f"config {problem.name}: only the fused pcn, elliptical, da_pcn, "
            "fes and mala paths are ported (pass --fused to a pCN config "
            "with a batched potential)"
        )
    generator = torch.Generator().manual_seed(int(seed))
    metrics = _run_fused_mcmc(problem, generator, n_chains, n_samples, device)
    return _finalize(metrics, t_start)
