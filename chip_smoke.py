"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Builds the CUDA kernels from ``ip_mcmc_tpu_torch/csrc``, holds each kernel
against its plain PyTorch version on the card at the main path's shapes,
times both, then drives ``darcy_da_fused`` (4096 chains, 40 burn-in outer
steps, 400 samples at thin 4) through the port's CLI in-process and checks
that it went through the kernels. Every phase raises on failure. Prints
the card's name and power limit, a JSON line of per-kernel results, and as
the last line ``{"ok": true, "device": {...}}``. Without CUDA it exits
non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import subprocess
import sys
import time

import torch

# Misfit kernel vs plain version: the same f32 arithmetic in different
# summation orders. The preconditioner rounds its inputs to bf16, so an
# ulp-level difference occasionally flips one rounding; with 3 CG
# iterations (surrogate) such a flip moves Phi by up to ~1e-3 relative
# (measured on the CPU against JAX; with f32 factors every draw agrees
# within 6e-7). Hence the bounds of tests/test_torch_darcy.py: median
# within MEDIAN_RTOL, a share MIN_FRAC within RTOL, all within RTOL_FLIP.
MEDIAN_RTOL, RTOL, MIN_FRAC, RTOL_FLIP = 2e-6, 1e-5, 0.80, 5e-3
# Fused kernel vs plain loop: chains within CHAIN_ATOL, mean rates within
# RATE_ATOL (a rounding flip can turn one MH decision and part a chain).
CHAIN_ATOL, MIN_CHAIN_FRAC, RATE_ATOL = 1e-4, 0.99, 1e-2
N_CHAINS, BLOCK, K, OUTER = 4096, 512, 48, 2
RUN_BUDGET_S = 600.0  # the CLI phase's share of the 1200 s limit


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def cuda_time_ms(fn, reps: int) -> float:
    fn()  # warm-up
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check_misfits(problem, gen, results):
    from ip_mcmc_tpu_torch.ops import _build

    U = problem.prior.sample(gen, N_CHAINS).T.contiguous()
    for label, pot in (("exact", problem.batched_potential_fn),
                       ("surrogate", problem.batched_surrogate_fn)):
        name = f"darcy_misfit_kernel[n={pot.n}]"
        before = _build.launch_counts[name]
        got = pot(U)
        assert _build.launch_counts[name] == before + 1, f"{name} did not launch"
        ref = pot._forward_plain(U)
        torch.cuda.synchronize()
        assert got.shape == ref.shape == (N_CHAINS,)
        assert bool(torch.isfinite(got).all()), f"{name}: non-finite Phi"
        rel = ((got - ref).abs() / ref.abs()).cpu()
        frac = float((rel <= RTOL).double().mean())
        print(f"{name} ({label}, {N_CHAINS} prior draws): {frac:.4f} within "
              f"rtol {RTOL}, median rel {float(rel.median()):.3e}, max rel "
              f"{float(rel.max()):.3e}", flush=True)
        if (float(rel.median()) > MEDIAN_RTOL or frac < MIN_FRAC
                or float(rel.max()) > RTOL_FLIP):
            raise AssertionError(f"{name} disagrees with its plain version")
        ms = cuda_time_ms(lambda: pot(U), 20)
        plain_ms = cuda_time_ms(lambda: pot._forward_plain(U), 3)
        print(f"  time per call: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms", flush=True)
        results.append({
            "name": name, "route": "cuda",
            "source": "ip_mcmc_tpu_torch/csrc/fused_da_pcn.cu",
            "replaces": "ip_mcmc_tpu/models/darcy.py:542",
            "max_abs_err": float((got - ref).abs().max()),
            "max_rel_err": float(rel.max()), "frac_within_rtol": frac,
            "ms": ms, "plain_ms": plain_ms,
        })


def check_fused(problem, gen, results):
    from ip_mcmc_tpu_torch.ops import fused_da_pcn as da

    pos = problem.init_positions(gen, N_CHAINS).cuda()
    exact, surr = problem.batched_potential_fn, problem.batched_surrogate_fn
    args = (exact, surr, pos, problem.prior.mean, problem.prior.scale, 0.35, 11)
    for record in (False, True):
        name = f"fused_da_pcn_kernel<{'true' if record else 'false'}>"
        if record:
            kern = lambda: da.fused_da_pcn_chain_recorded(
                *args, n_steps=OUTER, thin=1, subchain_len=K, block_chains=BLOCK)
            plain = lambda: da._run_plain_recorded(
                *args, n_steps=OUTER, thin=1, subchain_len=K, block_chains=BLOCK)
        else:
            kern = lambda: da.fused_da_pcn_chain(
                *args, n_steps=OUTER, subchain_len=K, block_chains=BLOCK)
            plain = lambda: da._run_plain(
                *args, n_steps=OUTER, subchain_len=K, block_chains=BLOCK)
        got, ref = kern(), plain()
        torch.cuda.synchronize()
        assert got[0].shape == ref[0].shape == pos.shape
        assert bool(torch.isfinite(got[0]).all()), f"{name}: non-finite state"
        dev = (got[0] - ref[0]).abs().max(dim=1).values
        frac = float((dev <= CHAIN_ATOL).double().mean())
        rate_err = [abs(float(g.mean()) - float(r.mean()))
                    for g, r in zip(got[1:], ref[1:]) if g.dim() == 1]
        line = (f"{name} ({N_CHAINS} chains, block {BLOCK}, k={K}, {OUTER} outer "
                f"steps): {frac:.4f} of chains within {CHAIN_ATOL}, mean "
                f"acceptance kernel {float(got[1].mean()):.4f} plain "
                f"{float(ref[1].mean()):.4f}")
        if record:
            assert got[2].shape == ref[2].shape == (OUTER, N_CHAINS, pos.shape[1])
            rec_frac = float(((got[2] - ref[2]).abs().max(dim=2).values
                              <= CHAIN_ATOL).double().mean())
            line += f", records {rec_frac:.4f} within {CHAIN_ATOL}"
            frac = min(frac, rec_frac)
        else:
            line += (f", inner kernel {float(got[2].mean()):.4f} plain "
                     f"{float(ref[2].mean()):.4f}")
        print(line, flush=True)
        if frac < MIN_CHAIN_FRAC or max(rate_err) > RATE_ATOL:
            raise AssertionError(f"{name} disagrees with its plain version")
        ms = cuda_time_ms(kern, 3) / OUTER
        plain_ms = cuda_time_ms(plain, 1) / OUTER
        print(f"  one outer step at full width: kernel {ms:.3f} ms, plain "
              f"{plain_ms:.3f} ms", flush=True)
        results.append({
            "name": name, "route": "cuda",
            "source": "ip_mcmc_tpu_torch/csrc/fused_da_pcn.cu",
            "replaces": ("ip_mcmc_tpu/ops/fused_mcmc.py:950" if record
                         else "ip_mcmc_tpu/ops/fused_mcmc.py:260"),
            "max_abs_err": float(dev.max()), "frac_chains_within_atol": frac,
            "ms": ms, "plain_ms": plain_ms, "ms_unit": "one outer step",
        })


def run_main_path(n_samples):
    """The port's CLI in-process; returns its metrics dict."""
    from ip_mcmc_tpu_torch import run

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = run.main(["--config", "darcy_da_fused", "--device", "cuda",
                       "--n-samples", str(n_samples)])
    assert rc == 0, f"run.main returned {rc}"
    lines = [ln for ln in buf.getvalue().splitlines() if ln.strip()]
    assert len(lines) == 1, f"expected one JSON line, got {len(lines)}"
    return json.loads(lines[0])


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    from ip_mcmc_tpu_torch import configs
    from ip_mcmc_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.library()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s "
          f"(nvcc {_build.build_seconds if _build.build_seconds is not None else 0.0:.1f} s)",
          flush=True)

    problem = configs.build("darcy_da_fused", "cuda")
    gen = torch.Generator().manual_seed(1234)
    results = []
    check_misfits(problem, gen, results)
    check_fused(problem, gen, results)

    # the main path, as shipped unless its predicted time exceeds the budget
    step_ms = max(r["ms"] for r in results if r["name"].startswith("fused"))
    n_samples = problem.n_samples
    outer = lambda ns: problem.burn_in + 2 * ns * problem.thin
    if outer(n_samples) * step_ms / 1e3 > RUN_BUDGET_S:
        n_samples = max(8, int((RUN_BUDGET_S * 1e3 / step_ms - problem.burn_in)
                               / (2 * problem.thin)))
        print(f"n_samples cut from {problem.n_samples} to {n_samples} to fit "
              f"the time limit (width unchanged: {problem.n_chains} chains)",
              flush=True)
    _build.launch_counts.clear()
    metrics = run_main_path(n_samples)
    counts = dict(_build.launch_counts)
    print("darcy_da_fused metrics: " + json.dumps(metrics), flush=True)
    print("launch counts: " + json.dumps(counts), flush=True)
    for r in results:
        r["launches"] = counts.get(r["name"], 0)
        if r["launches"] < 1:
            raise AssertionError(f"{r['name']} was not launched by the main path")
    plain = {k: v for k, v in counts.items() if "plain" in k and v}
    if plain:
        raise AssertionError(f"plain versions ran on the main path: {plain}")
    assert metrics["n_chains"] == problem.n_chains
    assert math.isfinite(metrics["max_rhat"]), "max_rhat is not finite"
    for key in ("accept_rate", "inner_accept_rate"):
        assert 0.0 < metrics[key] <= 1.0, f"{key} = {metrics[key]}"
    assert all(math.isfinite(v) for v in metrics["posterior_mean"])
    assert len(metrics["posterior_mean"]) == problem.dim

    print(json.dumps({"kernels": results, "card": card}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
