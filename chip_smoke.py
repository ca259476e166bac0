"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Builds the CUDA kernels from ``ip_mcmc_tpu_torch/csrc`` (one nvcc per
``.cu``, in parallel), holds each kernel against its plain PyTorch version
on the card at the shapes of the ported paths (4096 chains on the Darcy
problem, 2048 on Burgers and lingauss_pcn, 8192 and 1024 on the 2-D
Gaussians), times both, then drives the ported paths at full width:

    darcy_da_fused           delayed-acceptance pCN     (K1-K5); the exact
                             misfit and the surrogate at the start
                             positions a draw a warp on the DA kernel's
                             exact and 8 x 8 levels
    darcy_da_richardson      the same with each surrogate of
                             benchmarks/darcy_da_richardson.py: three solved
                             by Richardson (K17), the CG one beside them
    darcy_pcn_warm           warm-started pCN           (K7), a chain a warp;
                             the warm misfit at the start positions a draw
                             a warp on its solve
    darcy32_pcn_warm         warm pCN on 32 x 32 cells  (K5, K7), G chains
                             a thread-block cluster, 7 CTAs an SM, the
                             factors read through L2; the warm misfit at
                             the start positions on the same cluster level
    darcy64_pcn_warm         warm pCN on 64 x 64 cells  (K5, K7), G chains
                             a thread-block cluster; the warm misfit at the
                             start positions on the same cluster level
    darcy64_da_fused         delayed acceptance on 64 x 64 cells with a
                             32 x 32 surrogate (K4, K5), G chains a
                             thread-block cluster; the exact misfit and the
                             surrogate at the start positions on the same
                             cluster levels
    darcy_ess_fused          elliptical slice sampling  (K8), a chain a warp
    darcy_pcn_4096 --fused   cold pCN                   (K6), a chain a warp
    darcy_mala_fused         MALA, adjoint gradient     (K10), a chain a warp
    darcy_mala_warm          warm-started MALA          (K11), a chain a warp;
                             the value and gradient at the start positions
                             a draw a warp on the same solve
    darcy_fes_fused          functional ensemble sampler (K9), a chain a warp
    (no path)                the one-chain-a-CTA kernels that the samplers'
                             takes-rules send the specs their Hopper designs
                             leave (ESS, FES, cold and warm MALA, DA at 16 x 16
                             and 48 x 48 + 24 x 24, warm pCN at 24 x 24, 32 x 32
                             and 48 x 48, three-level Burgers DA at 96 / 96 /
                             48 cells), each held against its plain twin at
                             its family's chain count; no path may launch
                             them (RESTORED)
    burgers_da3_pcn          three-level delayed acceptance (K12, K13), a
                             chain a warp; the misfits at the start
                             positions a draw a warp on the same solve (as
                             on the three Burgers paths below)
    burgers_da_pcn           delayed acceptance on Burgers  (K4, K12), a
                             chain a warp
    burgers_pcn --fused      cold pCN on Burgers            (K6, K12), a
                             chain a warp
    burgers_multitime_pcn --fused   the same, three observation times
    compare_paths            fused RWM on benchmarks/compare_paths.py's target,
                             8192 chains x 2000 steps, beside the scan path (K14),
                             16 chains a warp
    gauss2d_rwm --fused      the runner's fused RWM branch, the config's
                             phi_batched set by the caller (K14), 16 chains
                             a warp
    lingauss_pcn fused       burn-in with in-kernel beta adaptation (K16)
                             in one launch, a block of chains a thread-block
                             cluster, then dense-prior pCN (K15), a chain a
                             warp
    lingauss_elliptical fused, lingauss_fes fused, lingauss_pcn fused pcn /
    mala / da_pcn / da3_pcn   the runner's fused branch on lingauss_pcn's
                             problem at 2048 chains, the config's burn-in and
                             samples, the misfit a LinearGaussianPotential
                             (the DA levels sigma x 1.25 and x 1.1): ESS,
                             FES, cold pCN, MALA, DA and three-level DA, one
                             chain a CTA (check_linear_family_fused holds each
                             kernel to its twin first); each posterior mean
                             within 4 Monte Carlo standard errors of the
                             conjugate one in every coordinate
    gauss2d_rwm, lingauss_pcn   the scan path through the CLI (no kernel)
    darcy_pcn_4096 scan, darcy64_pcn   the scan path on the single-particle
                             Darcy forward (plain PyTorch, no kernel), its
                             potential first held to the same on the CPU
    burgers_pcn scan, burgers_multitime_pcn scan   the scan path on the
                             single-particle Burgers forward
    darcy_da_pcn             scan delayed acceptance (an 8-CG surrogate
                             subchain, a 48-CG correction)
    lingauss_elliptical, lingauss_fes   elliptical slice sampling and the
                             functional ensemble sampler on the scan path
    ode_mala, ode_hmc        MALA and HMC on the RK4 Lotka-Volterra forward;
                             each gradient one launch of
                             lv_misfit_grad_kernel (its discrete adjoint from
                             the stage exponentials kept in shared memory),
                             the kernel first held against its plain
                             version (autograd through the RK4 loop) at 256,
                             512 and 1024 chains and against the states
                             kernel it replaced, bit for bit, timed beside
                             it and the latency floor; the states kernel on
                             a spec the rule leaves; one gradient at 1024
                             chains timed beside the plain path's
    ode_nuts, ode_chees      BASELINE config 3b, NUTS, and ChEES-HMC on the
                             same kernel, at 256 and 512 chains
    multimodal_pt, multimodal_pt_mala   parallel tempering, pCN and MALA
                             mutations
    darcy_smc                BASELINE config 5: tempered SMC, the mutation
                             pCN on the single-particle Darcy forward
    darcy_smc_warm           the same on the batched warm misfit (dense dst,
                             6 CG), a draw a warp on warm MALA's level
                             (darcy_misfit_warm_dst_warp_kernel); the kernel
                             first held against its plain version at that
                             spec, from x0 = 0 and from a previous solution,
                             and against the one-draw-a-CTA kernel it
                             replaces, bit for bit
    lingauss_advi, darcy_advi   full-rank and mean-field ADVI (gradients by
                             autograd, the Darcy one through the implicit
                             adjoint; darcy_advi's steps cut)
    darcy_advi_warmstart     a cut ADVI fit, then the scan pCN of
                             darcy_pcn_4096 from its draws
    darcy_da_pod, darcy_da_pod_online   scan delayed acceptance on a POD
                             surrogate (batched Cholesky), the second
                             enriched during burn-in
    checkpoint ode_mala      checkpoint.CheckpointingDriver and the in-scan
                             checkpoints over ode_mala's MALA kernel at 1024
                             chains: a run interrupted and resumed from disk
                             equals the uninterrupted one bit for bit
    ode_mala --metrics-log --tensorboard --profile-dir   the CLI's three
                             observability flags at 50 samples: the metrics
                             log, its TensorBoard events read back, and the
                             Chrome trace's device events of the LV kernel
    darcy_da_fused --devices 1   the multi-device layer in a world of one
                             NCCL rank: darcy_da_fused at 4096 chains
                             through the CLI with --devices 1 (the runner
                             on the chain mesh, parallel.sharded_fused_chain),
                             bit for bit the unsharded run (its recorded
                             launch and its statistics)
    darcy_composed_pcn, darcy_composed_mala, darcy_composed_ess   the
                             composed ('chains', 'model') mesh at 512
                             chains through the CLI with --devices 1 (a
                             (1, 1) mesh; the burn-in and samples cut)
    examples/darcy_inversion the port's example script on the card, cut

The fourteen fused configs, the scan, SMC and VI paths run through the
port's CLI (the slow scan paths with their samples cut, darcy_da_pcn to 25
and the POD paths to 20), but for the ODE paths, which run through
``runner.run_problem`` with their Adam iterations and burn-in cut,
darcy_pcn_4096's scan path and darcy_da_pod, likewise with their warm-up
or burn-in cut, and darcy_advi and darcy_advi_warmstart, with their ADVI
steps cut; the other paths run through the entry points (``runner``,
``ops``).
Before each path the launch counts are set to 0; after it they must show
that the path went through its kernels (the scan path: its steps on the
card) and through no plain version. Every phase raises on failure. Prints
the card's name and power limit, the registers and spills that ptxas
reported for every Darcy, Burgers and linear-Gaussian group sampler kernel, a JSON
line of per-kernel results (time, plain time, roofline bound, launches),
and as the last line
``{"ok": true, "device": {...}}``. Without CUDA it exits non-zero and prints
no result.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

# --- tolerances ---------------------------------------------------------------
# Misfit kernel vs plain version: the same f32 arithmetic in different
# summation orders. The spectral preconditioners round their inputs to
# bf16, so an ulp-level difference occasionally flips one rounding; after a
# few CG iterations such a flip moves Phi by up to ~1e-3 relative (measured
# on the CPU against JAX; with f32 factors every draw agrees within 6e-7).
# Each bound is (median rel, rtol, least share within rtol, max rel):
BF16_TOL = (2e-6, 1e-5, 0.80, 5e-3)   # the bounds of tests/test_torch_darcy.py
# 4 iterations from x0 = 0 stop in an unconverged solve, where a flip is
# not damped (tests/test_torch_darcy_warm.py: median <= 5e-6, >= 94% within
# 1e-4, max 7e-4 against JAX). There f32 summation order alone moves Phi:
# at 4096 draws of darcy_pcn_warm's spec the f32 plain version lies a
# median 1.8-1.9e-5 from itself in f64 with the same bf16 roundings, and a
# kernel that adds in another order (the tensor cores' products) 1.9-2.1e-5
# from the f32 one (PERF.md). The warm misfit a draw a warp on K7's level is
# held against the f64 version (float64_twin), which takes the twin's own
# rounding out of the distance:
BF16_COLD_START_TOL = (2e-5, 1e-4, 0.90, 5e-3)
# every input f32 (Jacobi): summation order only
F32_TOL = (2e-6, 1e-5, 0.99, 1e-4)
# K17: Richardson recomputes its residual as b - Ax, which loses digits to
# cancellation as x converges, so more bf16 roundings sit near a tie than
# in CG (on the CPU against JAX, 2048 draws of 8x8 and 16x16, 2-4
# iterations: median <= 1.7e-5, >= 93.6% within 1e-4, max 1.5e-3;
# tests/test_torch_darcy_richardson.py)
RICH_BF16_TOL = (5e-5, 1e-4, 0.80, 5e-3)
# 32x32 and 64x64: four times and sixteen times the cells of 16x16 and 128
# or 256 modes, so more bf16 roundings per solve; 4 iterations from x0 = 0
# stop unconverged (on the CPU against JAX: up to 2.3e-4 from x0 = 0, 3.6e-5
# from a carried solution; tests/test_torch_darcy_large.py)
LARGE_BF16_TOL = (2e-4, 1e-3, 0.90, 5e-3)
# 16 Jacobi CG iterations at 32x32 stop far from convergence, where f32
# rounding is not damped: from x0 = 0 the plain version in f32 differs from
# itself in f64 by a median over ten times F32_TOL's
# (tests/test_torch_cluster.py), so summation order alone moves Phi as
# bf16 flips do on the 32x32 grids; their bounds hold
UNCONVERGED_32_TOL = LARGE_BF16_TOL
# Gradients and adjoint solutions, per draw relative to the draw's largest
# entry. The residuals are divided by sigma^2 = 4e-6 on their way into the
# adjoint's right-hand side, which amplifies rounding in the forward
# solution (on the CPU two f32 adjoints each lie ~2e-5 from the float64
# gradient on the worst of 24 draws, tests/test_torch_darcy_grad.py); with
# bf16 preconditioner inputs a rounding flip in either solve carries over.
GRAD_F32_TOL = (1e-5, 1e-4, 0.99, 2e-3)
GRAD_BF16_TOL = (1e-4, 1e-3, 0.90, 5e-2)
# Fused kernel vs plain loop (whose solves are the misfits' plain versions):
# chains within CHAIN_ATOL, mean rates within RATE_ATOL (a rounding flip can
# turn one MH decision and part a chain; measured: >= 99.98% of chains).
CHAIN_ATOL, MIN_CHAIN_FRAC, RATE_ATOL = 1e-4, 0.99, 1e-2
# The Burgers misfit is all f32 and its update is not contracted into an
# FMA: from equal initial states kernel and plain version give equal bits.
# The KL sum runs in another order, so an initial state may differ by an
# ulp, which the monotone scheme does not grow (on the CPU against JAX: at
# most 1.6e-6 relative, tests/test_torch_burgers.py).
BURGERS_TOL = (2e-6, 1e-5, 0.99, 1e-4)
N_CHAINS = 4096  # the Darcy configs; the Burgers configs ship 2048
RUN_BUDGET_S = 600.0  # the CLI phase's share of the 1200 s limit

# Published peaks of one H100 SXM (NVIDIA's data sheet, dense rates): f32
# outside the tensor cores, bf16 inputs with f32 accumulation on them, and
# HBM3 bandwidth. The spectral preconditioners' products take bf16 inputs;
# every other operation of the kernels is f32.
PEAK_F32_FLOPS, PEAK_BF16_FLOPS, PEAK_BYTES_PER_S = 67e12, 989e12, 3.35e12

SRC = "ip_mcmc_tpu_torch/csrc/"
JAX_OPS = "ip_mcmc_tpu/ops/fused_mcmc.py:"
JAX_DARCY = "ip_mcmc_tpu/models/darcy.py:"
# the pallas_call sites of the plain and the recorded scaffold
SCAFFOLD = {False: JAX_OPS + "260", True: JAX_OPS + "950"}


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


def device_ms(fn, reps: int, needle: str):
    """Device time of one call of ``fn``: what torch.profiler (CUPTI)
    records in the kernels whose names hold ``needle`` over ``reps`` calls
    after a warm-up, divided by ``reps``; None when three profiles in a row
    record none (a profile has come back without its device records). A
    small call's CUDA-event time can be the host's time to issue it."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0.0)
                 for e in prof.key_averages() if needle in e.key)
        if us:
            return us / reps / 1e3
    return None


def ms_text(ms, digits=4) -> str:
    return "not recorded" if ms is None else f"{ms:.{digits}f}"


def slope_ms(run, short: int, long: int, reps: int) -> float:
    """Time of one step as the slope between launches of ``short`` and of
    ``long`` steps: what a launch pays once (the start misfit, the output
    allocation, a transpose) cancels."""
    t_long = cuda_time_ms(lambda: run(long), reps)
    return (t_long - cuda_time_ms(lambda: run(short), reps)) / (long - short)


# --- the least time the card could take -------------------------------------


class Ops:
    """Operations by type (a multiply-add is two): ``f32``, and ``bf16``
    for products of bf16 inputs accumulated in f32."""

    def __init__(self, f32=0.0, bf16=0.0):
        self.f32, self.bf16 = float(f32), float(bf16)

    def __add__(self, other):
        return Ops(self.f32 + other.f32, self.bf16 + other.bf16)

    def __rmul__(self, k):
        return Ops(k * self.f32, k * self.bf16)


def setup_ops(pot) -> Ops:
    """KL reconstruction, exp and log, transmissibilities and diagonal."""
    N = pot.n * pot.n
    return Ops(2 * pot.K * N + 2 * N + 18 * N)


def cg_ops(pot, warm: bool) -> Ops:
    """One CG solve for one chain: per iteration one stencil apply (13 N),
    two dot products, three vector updates and one preconditioner apply.
    The spectral preconditioners' products (V^T r and V rt of dst_trunc,
    the four sine stages of dst) are the bf16 operations; all else is
    f32."""
    N = pot.n * pot.n
    start = 2 * N + (14 * N if warm else 0)
    return Ops(start + pot.cg_iters * 23 * N) + (1 + pot.cg_iters) * precond_ops(pot)


def precond_ops(pot) -> Ops:
    n, N = pot.n, pot.n * pot.n
    return {"jacobi": Ops(N),
            "dst_trunc": Ops(N + pot.modes, 4 * pot.modes * N),
            "dst": Ops(N, 8 * n * N)}[pot.precond]


def richardson_ops(pot) -> Ops:
    """K17 for one chain: x_1 = omega M^-1 b, then per further iteration one
    stencil apply (13 N), the residual (N), the update (2 N) and one
    preconditioner apply; no dot products."""
    N, updates = pot.n * pot.n, max(pot.cg_iters - 1, 0)
    return Ops(N + updates * 16 * N) + (1 + updates) * precond_ops(pot)


def solve_ops(pot, warm: bool) -> Ops:
    """Operations of one Darcy solve for one chain, counted from the
    misfit's shapes: set-up, one CG (or Richardson) solve, the residuals."""
    solve = richardson_ops(pot) if pot.solver == "richardson" else cg_ops(pot, warm)
    return setup_ops(pot) + solve + Ops(3 * int(pot.obs.numel()))


def grad_ops(pot, warm: bool) -> Ops:
    """Value and adjoint gradient for one chain: one set-up, two CG solves,
    the residuals and their scatter, the face terms of dPhi/da (about 30
    per cell) and the second KL product."""
    N, m = pot.n * pot.n, int(pot.obs.numel())
    return (setup_ops(pot) + 2 * cg_ops(pot, warm)
            + Ops(5 * m + 30 * N + 2 * pot.K * N))


def constant_bytes(pot) -> int:
    if hasattr(pot, "segments"):  # a Burgers misfit
        tensors = (pot.basis, pot.mean, pot.obs, pot.data, pot.noise)
    elif hasattr(pot, "center"):  # a linear-Gaussian potential
        tensors = (pot.At, pot.center, pot.data, pot.noise)
    else:
        tensors = (pot.basis, pot.V, pot.lam, pot.S, pot.source, pot.obs,
                   pot.data, pot.noise)
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(ops: Ops, nbytes: float) -> dict:
    """max(f32 operations / f32 peak + bf16 operations / bf16 peak,
    bytes / memory rate), in ms."""
    t_ops = ops.f32 / PEAK_F32_FLOPS + ops.bf16 / PEAK_BF16_FLOPS
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return {"bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "f32_ops": ops.f32, "bf16_ops": ops.bf16, "bytes": nbytes}


def misfit_bound(pot, B, warm):
    N = pot.n * pot.n
    io_bytes = 4 * B * (pot.K + 1 + (2 * N if warm else 0))
    return bound(B * solve_ops(pot, warm), io_bytes + constant_bytes(pot))


def burgers_solve_ops(pot) -> Ops:
    """Operations that one Burgers solve for one chain needs, all f32: the
    KL reconstruction (K multiply-adds and the mean per cell); per Godunov
    step and cell 8 (one face flux: a max, a min, two squares and a max;
    then subtract, multiply, subtract); per observation a subtract, a
    divide, a multiply-add. The kernel of ``csrc/burgers_misfit.cuh``
    spends 13 per step and cell, since each thread computes both of its
    faces' fluxes instead of fetching its neighbour's; the second flux is
    the kernel's choice and not work the function needs, so the bound does
    not count it."""
    n, m = pot.n, int(pot.obs.numel())
    return Ops(2 * pot.K * n + n + 8 * n * sum(pot.segments)
               + 4 * m * len(pot.segments))


def burgers_misfit_bound(pot, B):
    return bound(B * burgers_solve_ops(pot),
                 4 * B * (pot.K + 1) + constant_bytes(pot))


def chain_bound(pots, n, d, per_step_ops, recorded, *, launch_a_step=False):
    """One step of a sampler: the step's solves and draws, and one record
    when recording. A fused launch runs the whole n_steps loop, so the
    state and the constants can stay on the chip from step to step: the
    positions in and out, the start values, the acceptance and the
    constants are the launch's bytes, which the slope between two launches
    cancels, and a step moves none of them. Where each step is a launch
    (``launch_a_step``: K16's host loop), a step moves them all."""
    nbytes = 4 * n * d if recorded else 0
    if launch_a_step:
        nbytes += 4 * n * (2 * d + 2) + sum(constant_bytes(p) for p in pots)
    return bound(n * per_step_ops, nbytes)


RNG_OPS_PER_DRAW = 40  # f32: hash, log, sqrt, sin/cos per normal coordinate


def linear_ops(pot) -> Ops:
    """Φ of a linear-Gaussian potential for one chain, all f32: U − c (d),
    per row d multiply-adds, a subtract, a divide and a multiply-add."""
    return Ops(pot.K + pot.m * (2 * pot.K + 4))


# --- kernel against plain version ---------------------------------------------


def plain_potential(pot, warm=False):
    """The misfit's plain version as a callable. A misfit module given CUDA
    tensors launches its kernel, so the plain loops below get this instead:
    their every solve is plain PyTorch."""
    return pot._forward_warm_plain if warm else pot._forward_plain


def compare_misfit(results, pot, U, *, variant, paths, tol, x0=None,
                   replaces, f64=False):
    """One misfit kernel launch against its plain version on the same
    inputs; appends the result row. ``paths``: the configs whose CLI runs
    launch this variant (none for an option that no shipped config uses).
    ``f64``: hold it against the plain version in f64 with the same bf16
    roundings (``float64_twin``) rather than in f32, and print the f32
    twin's distance beside. Returns the kernel's output."""
    from ip_mcmc_tpu_torch.ops import _build

    warm = x0 is not None
    # the kernel the spec is sent to (at 64x64 and 32x32 on dst_trunc CG
    # the cluster kernels, at 16x16 on the DA kernel's exact level the warp
    # kernel, in the same sources as the one-draw-a-CTA kernels)
    name = pot.warm_kernel_label if warm else pot.kernel_label
    kern = (lambda: pot(U, x0)) if warm else (lambda: pot(U))
    plain = ((lambda: pot._forward_warm_plain(U, x0)) if warm
             else (lambda: pot._forward_plain(U)))
    before = _build.launch_counts[name]
    got, ref = kern(), plain()
    torch.cuda.synchronize()
    assert _build.launch_counts[name] == before + 1, f"{name} did not launch"
    twin32 = None
    if f64:
        twin32, twin = ref, pot.float64_twin()
        ref = (twin._forward_warm_plain(U.double(), x0.double()) if warm
               else twin._forward_plain(U.double()))
    phi, phi_ref = (got[0], ref[0]) if warm else (got, ref)
    B = U.shape[1]
    assert phi.shape == phi_ref.shape == (B,)
    assert bool(torch.isfinite(phi).all()), f"{name}: non-finite Phi"
    rel = ((phi - phi_ref).abs() / phi_ref.abs()).cpu()
    median, rtol, min_frac, rtol_max = tol
    frac = float((rel <= rtol).double().mean())
    line = (f"{name} ({variant}, {B} draws): {frac:.4f} within rtol {rtol}, "
            f"median rel {float(rel.median()):.3e}, max rel {float(rel.max()):.3e}")
    if f64:
        phi32 = twin32[0] if warm else twin32
        rel32 = ((phi32 - phi_ref).abs() / phi_ref.abs()).cpu()
        rel_k32 = ((phi - phi32).abs() / phi32.abs()).cpu()
        line += (f" against the plain version in f64 (the f32 twin against it: median "
                 f"{float(rel32.median()):.3e}, {float((rel32 <= rtol).double().mean()):.4f} "
                 f"within rtol, max {float(rel32.max()):.3e}; the kernel against the f32 twin: "
                 f"median {float(rel_k32.median()):.3e}, max {float(rel_k32.max()):.3e})")
    max_abs = float((phi - phi_ref).abs().max())
    bad = float(rel.median()) > median or frac < min_frac or float(rel.max()) > rtol_max
    if warm:
        assert got[1].shape == ref[1].shape == x0.shape
        x_err = ((got[1] - ref[1]).abs().max(dim=0).values
                 / ref[1].abs().max(dim=0).values).cpu()
        line += (f"; solution: median {float(x_err.median()):.3e}, max "
                 f"{float(x_err.max()):.3e} of its largest cell")
        bad = bad or float(x_err.median()) > 10 * median or float(x_err.max()) > rtol_max
    print(line, flush=True)
    if bad:
        raise AssertionError(f"{name} ({variant}) disagrees with its plain version")
    ms, plain_ms = cuda_time_ms(kern, 20), cuda_time_ms(plain, 3)
    row = {
        "name": name, "variant": variant, "route": "cuda",
        # every warm misfit kernel is in fused_pcn.cu, every cold one in
        # fused_da_pcn.cu
        "source": SRC + ("fused_pcn.cu" if warm else "fused_da_pcn.cu"),
        "replaces": replaces, "paths": paths, "max_abs_err": max_abs,
        "reference": "plain version in f64" if f64 else "plain version",
        "max_rel_err": float(rel.max()), "frac_within_rtol": frac,
        "ms": ms, "plain_ms": plain_ms, "ms_unit": f"one call, {B} draws",
        **misfit_bound(pot, B, warm), "library_ms": None,
    }
    print(f"  time per call: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
          f"{row['bound_ms']:.4f} ms ({row['bound_by']})", flush=True)
    results.append(row)
    return got


def compare_chain(results, stem, recorded, kern, plain, *, steps, kernel_long,
                  plain_long, variant, paths, source, pots, per_step_ops,
                  replaces=None, rate_atol=None):
    """One fused launch of ``steps`` steps against the plain loop from the
    same start and seed, then the time of one step of each as the slope up
    to a longer launch; appends the result row. ``kern`` and ``plain`` take
    the number of steps. ``rate_atol``: the mean rates' tolerance, if not
    RATE_ATOL."""
    name = f"{stem}<{'true' if recorded else 'false'}>"
    got, ref = kern(steps), plain(steps)
    torch.cuda.synchronize()
    n, d = got[0].shape
    assert got[0].shape == ref[0].shape
    assert bool(torch.isfinite(got[0]).all()), f"{name}: non-finite state"
    dev = (got[0] - ref[0]).abs().max(dim=1).values
    frac = float((dev <= CHAIN_ATOL).double().mean())
    rate_err = [abs(float(g.mean()) - float(r.mean()))
                for g, r in zip(got[1:], ref[1:]) if g.dim() == 1]
    line = (f"{name} ({variant}, {n} chains, {steps} steps): {frac:.4f} of "
            f"chains within {CHAIN_ATOL}, mean acceptance kernel "
            f"{float(got[1].mean()):.4f} plain {float(ref[1].mean()):.4f}")
    if recorded:
        assert got[2].shape == ref[2].shape and got[2].shape[1:] == (n, d)
        rec_frac = float(((got[2] - ref[2]).abs().max(dim=2).values
                          <= CHAIN_ATOL).double().mean())
        line += f", records {rec_frac:.4f} within {CHAIN_ATOL}"
        frac = min(frac, rec_frac)
    elif len(got) > 2:  # DA: inner acceptance; ensemble sampler: stretch
        line += (f", third output kernel {float(got[2].mean()):.4f} plain "
                 f"{float(ref[2].mean()):.4f}")
    print(line, flush=True)
    if frac < MIN_CHAIN_FRAC or max(rate_err) > (rate_atol or RATE_ATOL):
        raise AssertionError(f"{name} disagrees with its plain version")
    del got, ref
    ms = slope_ms(kern, steps, kernel_long, 3)
    plain_ms = slope_ms(plain, steps, plain_long, 1)
    row = {
        "name": name, "variant": variant, "route": "cuda", "source": SRC + source,
        "replaces": replaces or SCAFFOLD[recorded], "paths": paths,
        "max_abs_err": float(dev.max()), "frac_chains_within_atol": frac,
        "ms": ms, "plain_ms": plain_ms,
        "ms_unit": (f"one step: the slope between launches of {steps} and of "
                    f"{kernel_long} steps (plain: {steps} and {plain_long})"),
        **chain_bound(pots, n, d, per_step_ops, recorded), "library_ms": None,
    }
    print(f"  one step at full width: kernel {ms:.3f} ms, plain {plain_ms:.3f} "
          f"ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']})", flush=True)
    results.append(row)


# the 16x16 DA kernel: one warp per chain, the preconditioner's products
# on the tensor cores over a CTA's chains
DA16 = "fused_da_pcn_warp_kernel"
# its exact misfit and its 8x8 surrogate (CG or Richardson) at the start
# positions, a draw a warp on its exact and surrogate levels
MISFIT16 = "darcy_misfit_warp_kernel[n=16]"
MISFIT8 = "darcy_misfit_warp_kernel[n=8]"
MISFIT8_RICH = "darcy_misfit_warp_kernel[n=8,richardson]"
# darcy_pcn_warm's warm misfit at the start positions, a draw a warp on the
# warm pCN's solve (WarpTruncSliceLevel)
MISFIT_WARM16 = "darcy_misfit_warm_warp_kernel[n=16]"
# darcy_smc_warm's dense-dst warm misfit, a draw a warp on warm MALA's solve
# (WarpDstSliceLevel), and the one-draw-a-CTA kernel it replaces
MISFIT_WARM_DST = "darcy_misfit_warm_dst_warp_kernel[n=16]"
MISFIT_WARM_CTA = "darcy_misfit_warm_kernel"
# the 16x16 Jacobi misfit of ESS, cold pCN and FES at the start positions,
# and its value and gradient for cold MALA: a draw a warp on their samplers'
# solve (WarpSliceLevel)
MISFIT_SLICE = "darcy_misfit_slice_kernel[n=16]"
GRAD_WARP = "darcy_misfit_grad_warp_kernel[n=16]"
# the warm value and gradient of warm MALA at the start positions: a draw a
# warp on its sampler's solve (WarpDstSliceLevel)
GRAD_WARM_WARP = "darcy_misfit_grad_warm_warp_kernel[n=16]"
# elliptical slice sampling: one warp per chain, Jacobi solves
ESS = "fused_ess_warp_kernel"
# the ensemble sampler and the three-level Burgers DA: one warp per chain
FES = "fused_fes_warp_kernel"
DA3 = "fused_da3_pcn_warp_kernel"
# MALA: one warp per chain, the adjoint gradient on the warp; cold (Jacobi)
# and warm (dense dst) instantiations (ops/fused_mala.py stem)
MALA_COLD = "fused_mala_warp_kernel[jacobi]"
MALA_WARM = "fused_mala_warp_kernel[dst]"
# single-level pCN on 16x16, d = 64: one warp per chain; cold (Jacobi) and
# warm (dst_trunc) instantiations (ops/fused_pcn.py stem); the other specs
# on the one-chain-a-CTA kernels
PCN_COLD = "fused_pcn_warp_kernel[jacobi]"
PCN_WARM = "fused_pcn_warp_kernel[dst_trunc]"
# the Burgers DA and pCN: one warp per chain on the configs' specs, the
# other specs on the one-chain-a-CTA kernels
DA_BURGERS = "fused_da_pcn_burgers_warp_kernel"
PCN_BURGERS = "fused_pcn_burgers_warp_kernel"
# K12, the Burgers misfit at the start positions: a draw a warp on the
# samplers' solve at the configs' levels (ops/_burgers_warp.py
# misfit_takes), a draw a CTA at any other; the levels' tags
BURGERS_MISFIT = "burgers_misfit_warp_kernel"
BURGERS_MISFIT_CTA = "burgers_misfit_kernel"
FINE, MID, COARSE, MULTI = ("[n=128,steps=154]", "[n=128,steps=52]", "[n=64,steps=26]",
                            "[n=128,steps=54+54+46]")
# K14 and K15 on the shipped linear-Gaussian specs: a chain on each group of
# d lanes (ops/_gaussian_group.py); the other specs on the one-chain-a-CTA
# kernels
RWM_GROUP = "fused_rwm_group_kernel"
PCN_DENSE_GROUP = "fused_pcn_dense_group_kernel"
# K16's whole burn-in in one launch, a block a thread-block cluster
ADAPT_GROUP = "fused_pcn_adapt_group_kernel"


def check_da(problem, gen, results):
    from ip_mcmc_tpu_torch.ops import fused_da_pcn as da

    exact, surr = problem.batched_potential_fn, problem.batched_surrogate_fn
    U = problem.prior.sample(gen, N_CHAINS).T.contiguous()
    compare_misfit(results, exact, U, variant="exact: dst_trunc-128, 12 CG",
                   paths=["darcy_da_fused", PARALLEL_DA], tol=BF16_TOL,
                   replaces="ip_mcmc_tpu/models/darcy.py:542")
    assert (exact.kernel_label, surr.kernel_label) == (MISFIT16, MISFIT8)
    compare_misfit(results, surr, U,
                   variant=(f"surrogate: dst_trunc-64, 3 CG, a draw a warp, "
                            f"{da.MISFIT_SURR_WARP_DRAWS} a CTA"),
                   paths=["darcy_da_fused", PARALLEL_DA, richardson_path("cg3")],
                   tol=BF16_TOL,
                   replaces="ip_mcmc_tpu/models/darcy.py:542")
    # the one-draw-a-CTA kernel on an 8x8 spec the warp rule leaves (no
    # config): K 36
    k36 = misfit8_left()
    assert k36.kernel_label == "darcy_misfit_kernel[n=8]", k36.kernel_label
    compare_misfit(results, k36, torch.randn(k36.K, N_CHAINS, generator=gen).cuda(),
                   variant="8x8 K 36, dst_trunc-64, 3 CG: a spec the warp rule leaves, one draw "
                   "a CTA (no path)", paths=[], tol=BF16_TOL, replaces=JAX_DARCY + "542")
    pos = problem.init_positions(gen, N_CHAINS).cuda()
    block, k, outer = 512, 48, 2
    args = (exact, surr, pos, problem.prior.mean, problem.prior.scale, 0.35, 11)
    plain_args = (plain_potential(exact), plain_potential(surr), *args[2:])
    d = pos.shape[1]
    ops = (k * (solve_ops(surr, False) + Ops(RNG_OPS_PER_DRAW * d))
           + solve_ops(exact, False))
    for recorded in (False, True):
        kw = dict(subchain_len=k, block_chains=block)
        if recorded:
            kern = lambda s: da.fused_da_pcn_chain_recorded(*args, n_steps=s, thin=1, **kw)
            plain = lambda s: da._run_plain_recorded(*plain_args, n_steps=s, thin=1, **kw)
        else:
            kern = lambda s: da.fused_da_pcn_chain(*args, n_steps=s, **kw)
            plain = lambda s: da._run_plain(*plain_args, n_steps=s, **kw)
        compare_chain(results, DA16, recorded, kern, plain,
                      steps=outer, kernel_long=outer + 8, plain_long=2 * outer,
                      variant=f"block {block}, k={k}",
                      paths=["darcy_da_fused", PARALLEL_DA], source="fused_da_pcn.cu",
                      pots=(exact, surr), per_step_ops=ops)


def check_warm_misfit(problem, gen, results):
    """The warm misfit kernels: the shipped dst_trunc-64 / 4 CG a draw a warp
    on the warm pCN's solve, from x0 = 0 (against the plain version in f64)
    and from a previous solution; the dense dst / 4 CG, which the warm warp
    rule leaves to the dense-dst one (a draw a warp), and Jacobi / 16 CG,
    which both leave to the one-draw-a-CTA kernel."""
    from ip_mcmc_tpu_torch.convert import darcy_warm_misfit_from_arrays
    from ip_mcmc_tpu_torch.models import darcy
    from ip_mcmc_tpu_torch.ops import fused_pcn

    warm, aux_dim = problem.batched_warm_potential
    assert warm.warm_kernel_label == MISFIT_WARM16, warm.warm_kernel_label
    U = problem.prior.sample(gen, N_CHAINS).T.contiguous()
    step = problem.prior.sample(gen, N_CHAINS).T.contiguous()
    U2 = (math.sqrt(1 - 0.08 ** 2) * U + 0.08 * step).contiguous()  # a pCN move
    zeros = torch.zeros(aux_dim, N_CHAINS, device="cuda")
    replaces = "ip_mcmc_tpu/models/darcy.py:669"
    what = f"dst_trunc-64, 4 CG, a draw a warp, {fused_pcn.MISFIT_WARM_WARP_DRAWS} a CTA"
    _, x1 = compare_misfit(
        results, warm, U, x0=zeros, variant=f"{what}, x0 = 0",
        paths=["darcy_pcn_warm"], tol=BF16_COLD_START_TOL, replaces=replaces, f64=True)
    compare_misfit(
        results, warm, U2, x0=x1, variant=f"{what}, x0 = previous solution",
        paths=["darcy_pcn_warm"], tol=BF16_TOL, replaces=replaces)
    aux = darcy.darcy_aux(n_grid=16, n_modes_per_dim=8, alpha=2.0, field_scale=10.0)
    # options of the warm misfit that no shipped config uses, which the warm
    # warp rule leaves to the dense-dst warp kernel and to the one-draw-a-CTA
    # kernel: no path launches them
    for precond, iters, tol, label in (("dst", 4, BF16_TOL, MISFIT_WARM_DST),
                                       ("jacobi", 16, F32_TOL, MISFIT_WARM_CTA)):
        other = darcy_warm_misfit_from_arrays(
            aux, problem.data, 0.002, cg_iters=iters, precond=precond)[0].cuda()
        assert other.warm_kernel_label == label, other.warm_kernel_label
        compare_misfit(
            results, other, U2, x0=x1,
            variant=f"{precond}, {iters} CG, x0 = previous solution",
            paths=[], tol=tol, replaces=replaces)


def check_smc_warm_misfit(problem, gen, results):
    """darcy_smc_warm's mutation misfit, dense dst / 6 CG, at 4096 draws, a
    draw a warp on warm MALA's level (darcy_misfit_warm_dst_warp_kernel):
    against its plain version from x0 = 0, as the first of the run's 8
    initial sweeps starts (against the plain version in f64 with the same
    bf16 roundings), and from the solution of the 8 sweeps after a pCN
    move, as a mutation step starts; on both inputs against the
    one-draw-a-CTA darcy_misfit_warm_kernel it replaces, bit for bit (the
    draws that differ counted), the two timed in turns (parent, new, new,
    parent: CUDA events through the wrapper and the profiler's device
    time). Returns the comparison."""
    warm, _ = problem.batched_warm_potential
    assert (warm.precond, warm.cg_iters) == ("dst", 6), (warm.precond, warm.cg_iters)
    assert warm.warm_kernel_label == MISFIT_WARM_DST, warm.warm_kernel_label
    U = problem.prior.sample(gen, N_CHAINS).T.contiguous()
    step = problem.prior.sample(gen, N_CHAINS).T.contiguous()
    U2 = (math.sqrt(1 - 0.15 ** 2) * U + 0.15 * step).contiguous()  # a mutation move
    zeros = torch.zeros(warm.aux_dim, N_CHAINS, device="cuda")
    replaces = "ip_mcmc_tpu/models/darcy.py:669"
    what = "dense dst, 6 CG, a draw a warp, 16 a CTA"
    _, x = compare_misfit(results, warm, U, x0=zeros, variant=f"{what}, x0 = 0",
                          paths=["darcy_smc_warm"], tol=BF16_COLD_START_TOL,
                          replaces=replaces, f64=True)
    rows = [results[-1]]
    for _ in range(7):
        _, x = warm(U, x)
    compare_misfit(results, warm, U2, x0=x,
                   variant=f"{what}, x0 = the solution of the 8 initial sweeps",
                   paths=["darcy_smc_warm"], tol=BF16_TOL, replaces=replaces)
    rows.append(results[-1])
    out = {}
    for row, (u, x0) in zip(rows, ((U, zeros), (U2, x))):
        new = lambda u=u, x0=x0: warm(u, x0)  # noqa: E731
        parent = lambda u=u, x0=x0: warm.forward_layout(u, x0)  # noqa: E731
        (phi, xs), (phi_p, xs_p) = new(), parent()
        differ = int(((phi != phi_p) | (xs != xs_p).any(dim=0)).sum())
        turns = [cuda_time_ms(f, 20) for f in (parent, new, new, parent)]
        dev = [device_ms(f, 20, n) for f, n in ((parent, "darcy_misfit_warm_kernel<"),
                                                 (new, "darcy_misfit_warm_dst_warp_kernel"))]
        row.update(parent_kernel=MISFIT_WARM_CTA, draws_differing_from_parent=differ,
                   in_turns_ms=turns, device_ms=dev[1], parent_device_ms=dev[0])
        out[row["variant"]] = {"draws_differing": differ, "in_turns_ms": turns,
                               "device_ms_parent_new": dev}
        print(f"{MISFIT_WARM_DST} ({row['variant']}) against {MISFIT_WARM_CTA}: {differ} of "
              f"{N_CHAINS} draws differ; in turns parent / new / new / parent "
              + " / ".join(f"{t:.4f}" for t in turns)
              + f" ms; device {dev[0]} / {dev[1]} ms", flush=True)
    return out


class CountingPotential:
    """The plain cold misfit under the plain ESS loop, counting the
    evaluations each step's slices need. The plain loop (as the TPU kernel)
    evaluates every chain ``max_shrink`` times per step behind done masks;
    a chain that is done keeps its angle, so its proposal no longer moves,
    and a chain still searching draws a new one. An evaluation is needed
    where the proposal differs from the round before (all of them in a
    step's first round). ``per_step[i]``: mean evaluations per chain in
    step i."""

    def __init__(self, pot, max_shrink):
        self.pot, self.max_shrink = pot, max_shrink
        self.calls, self.last, self.per_step = -1, None, []  # call 0 is init

    def __call__(self, U):
        if self.calls >= 0:
            if self.calls % self.max_shrink == 0:
                self.per_step.append(1.0)
            else:
                moved = (U != self.last).any(dim=0)
                self.per_step[-1] += float(moved.double().mean())
            self.last = U
        self.calls += 1
        return self.pot._forward_plain(U)


def misfit16_dst(problem, modes, cg_iters=12):
    """A cold 16x16 dst_trunc CG misfit on the DA configs' prior geometry
    and ``problem``'s data (no config at 160 modes; at 128, the DA exact
    level's spec)."""
    from ip_mcmc_tpu_torch.convert import darcy_misfit_from_arrays
    from ip_mcmc_tpu_torch.models import darcy

    aux = darcy.darcy_aux(n_grid=16, n_modes_per_dim=8)
    return darcy_misfit_from_arrays(aux, problem.data, 0.002, cg_iters=cg_iters,
                                    precond="dst_trunc", precond_modes=modes).cuda()


def check_single_level(problems, gen, results):
    """The 16x16 Jacobi misfit of ESS, cold pCN and FES (a draw a warp) and
    the one-draw-a-CTA kernel on a 16x16 spec the rules leave; then K6, K7,
    K8 at their configs' blocks, each plain and recorded: the pCN warp
    kernels on the two configs' misfits, and the one-chain-a-CTA pCN
    kernels on two 16x16 specs the warp kernel does not take (a cold
    dst_trunc and a warm Jacobi misfit; no shipped config)."""
    from ip_mcmc_tpu_torch.convert import darcy_warm_misfit_from_arrays
    from ip_mcmc_tpu_torch.models import darcy
    from ip_mcmc_tpu_torch.ops import fused_da_pcn, fused_ess, fused_pcn

    warm_p, ess_p, cold_p = (problems[k] for k in
                             ("darcy_pcn_warm", "darcy_ess_fused", "darcy_pcn_4096"))
    jacobi = cold_p.batched_potential_fn
    U = cold_p.prior.sample(gen, N_CHAINS).T.contiguous()
    assert jacobi.kernel_label == MISFIT_SLICE, jacobi.kernel_label
    compare_misfit(results, jacobi, U,
                   variant=(f"cold: jacobi, 48 CG, a draw a warp, "
                            f"{fused_da_pcn.MISFIT_SLICE_DRAWS} a CTA"),
                   paths=["darcy_ess_fused", "darcy_pcn_4096", "darcy_fes_fused"],
                   tol=F32_TOL,
                   replaces="ip_mcmc_tpu/models/darcy.py:542")
    # the one-draw-a-CTA kernel on a 16x16 spec the warp and slice rules
    # leave (no config): dst_trunc-160, more modes than the warp kernel stages
    dst160 = misfit16_dst(problems["darcy_da_fused"], 160)
    assert dst160.kernel_label == "darcy_misfit_kernel[n=16]", dst160.kernel_label
    compare_misfit(results, dst160, U, variant="16x16 dst_trunc-160, 12 CG: a spec the warp and "
                   "slice rules leave, one draw a CTA (no path)", paths=[], tol=BF16_TOL,
                   replaces=JAX_DARCY + "542")
    pos = cold_p.init_positions(gen, N_CHAINS).cuda()
    d = pos.shape[1]
    pm, ps = cold_p.prior.mean, cold_p.prior.scale
    warm, aux_dim = warm_p.batched_warm_potential
    draws = Ops(RNG_OPS_PER_DRAW * d)
    cta_cold = problems["darcy_da_fused"].batched_potential_fn
    aux = darcy.darcy_aux(n_grid=16, n_modes_per_dim=8, alpha=2.0, field_scale=10.0)
    cta_warm = darcy_warm_misfit_from_arrays(aux, warm_p.data, 0.002, cg_iters=16,
                                             precond="jacobi")[0].cuda()
    w_cold, w_warm = (fused_pcn.warp_geometry(N_CHAINS, b, warm=h)[1]
                      for b, h in ((512, False), (256, True)))
    pcn_cases = (
        (PCN_COLD, fused_pcn.fused_pcn_chain,
         fused_pcn.fused_pcn_chain_recorded, jacobi, 512, 4, {},
         solve_ops(jacobi, False) + draws, ["darcy_pcn_4096"],
         f"jacobi, 48 CG, block 512, {w_cold} chains a CTA"),
        (PCN_WARM, fused_pcn.fused_pcn_chain_warm,
         fused_pcn.fused_pcn_chain_warm_recorded, warm, 256, 8,
         {"aux_dim": aux_dim}, solve_ops(warm, True) + draws,
         ["darcy_pcn_warm"], f"dst_trunc-64 (its products by mma.sync over a CTA's chains), "
         f"4 CG, block 256, {w_warm} chains a CTA"),
        # the specs the warp kernel leaves to the one-chain-a-CTA kernels
        ("fused_pcn_kernel", fused_pcn.fused_pcn_chain,
         fused_pcn.fused_pcn_chain_recorded, cta_cold, 256, 2, {},
         solve_ops(cta_cold, False) + draws, [], "dst_trunc-128, 12 CG, block 256"),
        ("fused_pcn_warm_kernel", fused_pcn.fused_pcn_chain_warm,
         fused_pcn.fused_pcn_chain_warm_recorded, cta_warm, 256, 4,
         {"aux_dim": aux_dim}, solve_ops(cta_warm, True) + draws, [],
         "jacobi, 16 CG, block 256"),
    )
    for (stem, chain, chain_rec, pot, block, steps, kw, ops, paths,
         variant) in pcn_cases:
        assert fused_pcn._darcy_stem(pot, bool(kw), d) == stem, f"{variant}: not on {stem}"
        args = (pot, pos, pm, ps, 0.08, 13)
        plain_args = (plain_potential(pot, warm=bool(kw)), *args[1:])
        for recorded in (False, True):
            fn, kw_r = (chain_rec, dict(kw, thin=1)) if recorded else (chain, kw)
            compare_chain(
                results, stem, recorded,
                lambda s: fn(*args, n_steps=s, block_chains=block, **kw_r),
                lambda s: fused_pcn._run_plain(*plain_args, s, block, **kw_r),
                steps=steps, kernel_long=steps + 64, plain_long=3 * steps,
                variant=variant, paths=paths, source="fused_pcn.cu",
                pots=(pot,), per_step_ops=ops)

    shrink, block, steps, long = ess_p.kernel_params["max_shrink"], 256, 3, 67
    w = fused_ess.warp_geometry(N_CHAINS, block)[1]
    args = (pos, pm, ps, 17)
    # what this run's data needs: the evaluations that the slices of the
    # timed steps (after the first ``steps``, up to ``long``) take, counted
    # on the plain loop from the same start and seed
    counting = CountingPotential(jacobi, shrink)
    fused_ess._run_plain(counting, *args, long, shrink, block)
    assert len(counting.per_step) == long
    first = sum(counting.per_step[:steps]) / steps
    per_step = sum(counting.per_step[steps:]) / (long - steps)
    print(f"{ESS}: {per_step:.3f} misfit evaluations per step of a "
          f"budget of {shrink} in steps {steps + 1}-{long} ({first:.3f} in the "
          f"first {steps})", flush=True)
    for recorded in (False, True):
        fn, kw_r = ((fused_ess.fused_ess_chain_recorded, {"thin": 1}) if recorded
                    else (fused_ess.fused_ess_chain, {}))
        compare_chain(
            results, ESS, recorded,
            lambda s: fn(jacobi, *args, n_steps=s, max_shrink=shrink,
                         block_chains=block, **kw_r),
            lambda s: fused_ess._run_plain(plain_potential(jacobi), *args, s,
                                           shrink, block, **kw_r),
            steps=steps, kernel_long=long, plain_long=3 * steps,
            variant=f"jacobi, 48 CG, max_shrink {shrink}, block {block}, {w} chains a CTA",
            paths=["darcy_ess_fused"], source="fused_ess.cu", pots=(jacobi,),
            per_step_ops=per_step * solve_ops(jacobi, False) + draws)
        results[-1]["solves_per_step"] = per_step


def col_err(got, ref):
    """Per draw: largest deviation over the rows, relative to the draw's
    largest reference entry."""
    return ((got - ref).abs().max(dim=0).values / ref.abs().max(dim=0).values).cpu()


def within(err, tol, what):
    """(line, bad) for per-draw errors under a (median, rtol, least share
    within rtol, max) bound."""
    median, rtol, min_frac, worst = tol
    frac = float((err <= rtol).double().mean())
    line = (f"{what}: {frac:.4f} within {rtol}, median {float(err.median()):.3e}, "
            f"max {float(err.max()):.3e}")
    bad = float(err.median()) > median or frac < min_frac or float(err.max()) > worst
    return line, bad, frac


def compare_grad_misfit(results, pot, U, *, variant, paths, phi_tol, grad_tol,
                        aux0=None):
    """One value-and-gradient kernel launch against its plain version on
    the same inputs: Phi, the gradient and (warm) the two carried solutions
    each under its own bound; appends the result row. Returns the kernel's
    output."""
    from ip_mcmc_tpu_torch.ops import _build

    warm = aux0 is not None
    N = pot.n * pot.n
    if warm:
        name = pot.grad_warm_kernel_label
        kern = lambda: pot(U, aux0)
        plain = lambda: pot._value_and_grad_plain(U, aux0[:N], aux0[N:])
        replaces = "ip_mcmc_tpu/models/darcy.py:783"
    else:
        name = pot.grad_kernel_label
        kern = lambda: pot.value_and_grad(U)
        plain = lambda: pot._value_and_grad_plain(U)
        replaces = "ip_mcmc_tpu/models/darcy.py:629"
    before = _build.launch_counts[name]
    got, ref = kern(), plain()
    torch.cuda.synchronize()
    assert _build.launch_counts[name] == before + 1, f"{name} did not launch"
    B = U.shape[1]
    assert got[0].shape == ref[0].shape == (B,) and got[1].shape == ref[1].shape == U.shape
    assert all(bool(torch.isfinite(g).all()) for g in got), f"{name}: non-finite output"
    rel = ((got[0] - ref[0]).abs() / ref[0].abs()).cpu()
    checks = [within(rel, phi_tol, "Phi"), within(col_err(got[1], ref[1]), grad_tol, "gradient")]
    if warm:
        assert got[2].shape == aux0.shape
        checks.append(within(col_err(got[2][:N], ref[2]), grad_tol, "forward solution"))
        checks.append(within(col_err(got[2][N:], ref[3]), grad_tol, "adjoint solution"))
    print(f"{name} ({variant}, {B} draws): " + "; ".join(c[0] for c in checks), flush=True)
    if any(c[1] for c in checks):
        raise AssertionError(f"{name} ({variant}) disagrees with its plain version")
    ms, plain_ms = cuda_time_ms(kern, 20), cuda_time_ms(plain, 3)
    io_bytes = 4 * B * (2 * pot.K + 1 + (4 * N if warm else 0))
    row = {
        "name": name, "variant": variant, "route": "cuda", "source": SRC + "fused_mala.cu",
        "replaces": replaces, "paths": paths,
        "max_abs_err": float((got[0] - ref[0]).abs().max()),
        "max_rel_err": float(rel.max()), "frac_within_rtol": checks[0][2],
        "grad_max_rel_err": float(col_err(got[1], ref[1]).max()),
        "grad_frac_within_rtol": checks[1][2],
        "ms": ms, "plain_ms": plain_ms, "ms_unit": f"one call, {B} draws",
        **bound(B * grad_ops(pot, warm), io_bytes + constant_bytes(pot)),
        "library_ms": None,
    }
    print(f"  time per call: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
          f"{row['bound_ms']:.4f} ms ({row['bound_by']})", flush=True)
    results.append(row)
    return got


def mala_warm_jacobi(problem, cg_iters=48):
    """A warm 16x16 Jacobi CG value-and-gradient pair on the MALA configs'
    prior and data: a warm spec the warp rule leaves (no config), on
    darcy_misfit_grad_kernel<true>."""
    from ip_mcmc_tpu_torch.convert import darcy_mala_warm_misfit_from_arrays
    from ip_mcmc_tpu_torch.models import darcy

    aux = darcy.darcy_aux(n_grid=16, n_modes_per_dim=8, alpha=2.0, field_scale=10.0)
    return darcy_mala_warm_misfit_from_arrays(aux, problem.data, 0.002, cg_iters=cg_iters,
                                              precond="jacobi")[0].cuda()


def check_gradient_and_ensemble(problems, gen, results):
    """The two value-and-gradient misfit kernels, then K10, K11 and K9 at
    their configs' blocks, each plain and recorded."""
    from ip_mcmc_tpu_torch.ops import _build, fused_fes, fused_mala
    from ip_mcmc_tpu_torch.runner import _resolve_n_low_modes

    cold_p, warm_p, fes_p = (problems[k] for k in
                             ("darcy_mala_fused", "darcy_mala_warm", "darcy_fes_fused"))
    jacobi = cold_p.batched_potential_fn
    pag, aux_dim = warm_p.batched_warm_potential
    eps = cold_p.kernel_params["step_size"]
    U = cold_p.prior.sample(gen, N_CHAINS).T.contiguous()
    U2 = (U + eps * cold_p.prior.sample(gen, N_CHAINS).T).contiguous()  # a MALA-sized move
    assert jacobi.grad_kernel_label == GRAD_WARP, jacobi.grad_kernel_label
    compare_grad_misfit(results, jacobi, U,
                        variant=(f"cold: jacobi, 48 + 48 CG, a draw a warp, "
                                 f"{fused_mala.GRAD_WARP_DRAWS} a CTA"),
                        paths=["darcy_mala_fused"], phi_tol=F32_TOL,
                        grad_tol=GRAD_F32_TOL)
    # the one-draw-a-CTA kernel on a 16x16 gradient spec the rule leaves
    # (no config): the DA exact level's dst_trunc-128, 12 CG
    dst128 = misfit16_dst(problems["darcy_da_fused"], 128)
    assert dst128.grad_kernel_label == "darcy_misfit_grad_kernel[n=16]"
    compare_grad_misfit(results, dst128, U, variant="16x16 dst_trunc-128, 12 + 12 CG: a spec "
                        "the warp rule leaves, one draw a CTA (no path)", paths=[],
                        phi_tol=BF16_TOL, grad_tol=GRAD_BF16_TOL)
    zeros = torch.zeros(aux_dim, N_CHAINS, device="cuda")
    assert pag.grad_warm_kernel_label == GRAD_WARM_WARP, pag.grad_warm_kernel_label
    what = f"dst, 6 + 6 CG, a draw a warp, {fused_mala.GRAD_WARM_WARP_DRAWS} a CTA"
    out = compare_grad_misfit(results, pag, U, aux0=zeros, variant=f"{what}, aux0 = 0",
                              paths=["darcy_mala_warm"], phi_tol=BF16_COLD_START_TOL,
                              grad_tol=GRAD_BF16_TOL)
    compare_grad_misfit(results, pag, U2, aux0=out[2],
                        variant=f"{what}, aux0 = previous solutions",
                        paths=["darcy_mala_warm"], phi_tol=BF16_TOL,
                        grad_tol=GRAD_BF16_TOL)
    # the one-draw-a-CTA warm kernel on a 16x16 warm spec the rule leaves (no
    # config): Jacobi / 48 + 48 CG, from aux0 = 0 the cold pair's arithmetic
    jacobi_warm = mala_warm_jacobi(warm_p)
    assert jacobi_warm.grad_warm_kernel_label == "darcy_misfit_grad_warm_kernel"
    compare_grad_misfit(results, jacobi_warm, U, aux0=zeros,
                        variant="16x16 jacobi, 48 + 48 CG, aux0 = 0: a spec the warp rule "
                        "leaves, one draw a CTA (no path)", paths=[], phi_tol=F32_TOL,
                        grad_tol=GRAD_F32_TOL)

    pos = cold_p.init_positions(gen, N_CHAINS).cuda()
    d = pos.shape[1]
    pm, ps = cold_p.prior.mean, cold_p.prior.scale
    block = cold_p.kernel_params["block_chains"]
    draws = Ops(RNG_OPS_PER_DRAW * d)
    w = {warm: fused_mala.warp_geometry(N_CHAINS, block, warm=warm)[1]
         for warm in (False, True)}
    mala_cases = (
        (MALA_COLD, jacobi, plain_potential(jacobi), {}, 4,
         grad_ops(jacobi, False) + draws, "darcy_mala_fused",
         f"jacobi, 48 + 48 CG, block {block}, {w[False]} chains a CTA"),
        (MALA_WARM, pag, plain_potential(pag, warm=True),
         {"aux_dim": aux_dim}, 8, grad_ops(pag, True) + draws, "darcy_mala_warm",
         f"dst, 6 + 6 CG, block {block}, {w[True]} chains a CTA"),
    )
    for stem, pot, plain_pot, kw, steps, ops, path, variant in mala_cases:
        for recorded in (False, True):
            kw_r = dict(kw, thin=1) if recorded else kw
            compare_chain(
                results, stem, recorded,
                lambda s: fused_mala._launch(pot, pos, pm, ps, eps, 19, s, block, **kw_r),
                lambda s: fused_mala._run_plain(plain_pot, pos, pm, ps, eps, 19, s,
                                                block, **kw_r),
                steps=steps, kernel_long=steps + 64, plain_long=3 * steps,
                variant=variant, paths=[path], source="fused_mala.cu", pots=(pot,),
                per_step_ops=ops)

    kp = fes_p.kernel_params
    n_low = _resolve_n_low_modes(kp, fes_p)
    fes_pot = fes_p.batched_potential_fn
    args = (pos, pm, ps, n_low, 23, kp["pcn_beta"], kp.get("stretch_a", 2.0))
    # A launch runs the chains of one lane parity, each through its stretch
    # and its pCN solve: one solve per chain of the width, so a step costs
    # as many solves per chain as it has launches. The launches are counted
    # on every launch made here (the plain loop, as the TPU kernel,
    # evaluates every chain three times behind the parity mask).
    for recorded in (False, True):
        kw_r = {"thin": 1} if recorded else {}
        name = f"{FES}<{'true' if recorded else 'false'}>"
        per_step = set()

        def kern(s):
            before = _build.launch_counts[name]
            out = fused_fes._launch(fes_pot, *args, s, block, **kw_r)
            per_step.add((_build.launch_counts[name] - before) / s)
            return out

        kern(1)
        (launches_per_step,) = per_step
        compare_chain(
            results, FES, recorded, kern,
            lambda s: fused_fes._run_plain(plain_potential(fes_pot), *args, s, block,
                                           **kw_r),
            steps=4, kernel_long=36, plain_long=12,
            variant=(f"jacobi, 48 CG, M = {n_low}, block {block}; one launch "
                     "per lane parity and step, two solves per chain and step, "
                     f"{fused_fes.warp_geometry(N_CHAINS, block)[1]} chains a CTA"),
            paths=["darcy_fes_fused"], source="fused_fes.cu", pots=(fes_pot,),
            per_step_ops=launches_per_step * solve_ops(fes_pot, False) + draws)
        assert per_step == {2.0}, f"{name}: launches per step {per_step}"
        results[-1]["launches_per_step"] = launches_per_step


def compare_small_misfit(results, pot, U, *, variant, paths, tol, source, replaces,
                         bound_row):
    """One launch of a misfit kernel whose call at B draws is a few
    microseconds (``burgers_misfit_kernel``, ``linear_gaussian_misfit_kernel``)
    against its plain version on the same draws, and a NaN draw, which must
    come back NaN and alone; appends the result row. ``tol``: (median rel,
    rtol, least share within rtol, max rel); ``bound_row``: the bound."""
    from ip_mcmc_tpu_torch.ops import _build

    name = pot.kernel_label
    kern, plain = (lambda: pot(U)), (lambda: pot._forward_plain(U))
    before = _build.launch_counts[name]
    got, ref = kern(), plain()
    torch.cuda.synchronize()
    assert _build.launch_counts[name] == before + 1, f"{name} did not launch"
    B = U.shape[1]
    assert got.shape == ref.shape == (B,)
    assert bool(torch.isfinite(got).all()), f"{name}: non-finite Phi"
    rel = ((got - ref).abs() / ref.abs()).cpu()
    line, bad, frac = within(rel, tol, "Phi")
    print(f"{name} ({variant}, {B} draws): {line}, equal bits on "
          f"{float((got == ref).double().mean()):.4f}", flush=True)
    U_nan = U[:, :64].clone()
    U_nan[min(3, U.shape[0] - 1), 5] = float("nan")
    nan_out = pot(U_nan)
    if bad or not bool(torch.isnan(nan_out[5])) or int(torch.isnan(nan_out).sum()) != 1:
        raise AssertionError(f"{name} ({variant}) disagrees with its plain version")
    # A call at B draws is tens of microseconds, most of them the launch
    # path through the wrapper, so the kernel's own time is read at a width
    # where the device dominates: per B draws of one call of 8 B. The time
    # of one call at B (many, so that one hiccup of the host does not show)
    # stays beside it as ``call_ms``.
    wide = U.repeat(1, 8)
    ms = cuda_time_ms(lambda: pot(wide), 50) / 8
    call_ms, plain_ms = cuda_time_ms(kern, 200), cuda_time_ms(plain, 3)
    dev_ms = device_ms(kern, 50, name.split("[")[0])
    row = {
        "name": name, "variant": variant, "route": "cuda", "source": SRC + source,
        "replaces": replaces, "paths": paths, "max_abs_err": float((got - ref).abs().max()),
        "max_rel_err": float(rel.max()), "frac_within_rtol": frac,
        "ms": ms, "call_ms": call_ms, "device_ms": dev_ms, "plain_ms": plain_ms,
        "ms_unit": (f"{B} draws: ms per {B} of one call of {8 * B}, call_ms and "
                    f"plain_ms one call of {B}, device_ms the profiler's kernel time "
                    f"of one call of {B}"),
        **bound_row, "library_ms": None,
    }
    dev = "not recorded" if dev_ms is None else f"{dev_ms:.5f}"
    print(f"  time per {B} draws: kernel {ms:.5f} ms (one call of {B} through the "
          f"wrapper {call_ms:.4f}, on the device {dev}), plain {plain_ms:.3f} ms, bound "
          f"{row['bound_ms']:.6f} ms ({row['bound_by']})", flush=True)
    results.append(row)


def check_burgers(problems, gen, results):
    """K12 at the four specs of the Burgers configs, then K13 and the
    Burgers warp kernels of K4 and K6 at the configs' sizes (2048 chains
    in blocks of 512), each plain and recorded. The plain loops run one
    small PyTorch call per Godunov operation (a DA3 outer step is 6394 time
    steps), so they take few steps."""
    from ip_mcmc_tpu_torch.ops import fused_da3_pcn as da3
    from ip_mcmc_tpu_torch.ops import fused_da_pcn as da
    from ip_mcmc_tpu_torch.ops import fused_pcn

    da3_p, da_p, pcn_p, multi_p = (problems[k] for k in (
        "burgers_da3_pcn", "burgers_da_pcn", "burgers_pcn", "burgers_multitime_pcn"))
    fine, mid, coarse = (da3_p.batched_potential_fn, da3_p.batched_mid_fn,
                         da3_p.batched_surrogate_fn)
    multi = multi_p.batched_potential_fn
    n = da3_p.n_chains
    U = da3_p.prior.sample(gen, n).T.contiguous()
    for pot, variant, paths in (
            (fine, "fine: 128 cells, 154 steps",
             ["burgers_da3_pcn", "burgers_da_pcn", "burgers_pcn"]),
            (mid, "middle: 128 cells, 52 steps, calibrated", ["burgers_da3_pcn"]),
            (coarse, "coarse: 64 cells, 26 steps, calibrated",
             ["burgers_da3_pcn", "burgers_da_pcn"]),
            (multi, "multi-time: 128 cells, 54 + 54 + 46 steps, 48 observations",
             ["burgers_multitime_pcn"])):
        compare_small_misfit(results, pot, U, variant=variant, paths=paths,
                             tol=BURGERS_TOL, source="fused_da3_pcn.cu",
                             replaces="ip_mcmc_tpu/models/burgers.py:153",
                             bound_row=burgers_misfit_bound(pot, U.shape[1]))

    pos = da3_p.init_positions(gen, n).cuda()
    d, block = pos.shape[1], 512
    pm, ps = da3_p.prior.mean, da3_p.prior.scale
    draws = Ops(RNG_OPS_PER_DRAW * d)
    ops_of = burgers_solve_ops

    kp = da3_p.kernel_params
    k1, k2 = kp["k_inner"], kp["k_mid"]
    levels = (fine, mid, coarse)
    plain_levels = tuple(plain_potential(p) for p in levels)
    tail = lambda s: (pos, pm, ps, kp["beta"], 29, s, k1, k2, block)
    for recorded in (False, True):
        kw = {"thin": 1} if recorded else {}
        compare_chain(
            results, DA3, recorded,
            lambda s: da3._launch(*levels, *tail(s), **kw),
            lambda s: da3._run_plain(*plain_levels, *tail(s), **kw),
            steps=2, kernel_long=18, plain_long=3,
            variant=(f"128 / 128 / 64 cells, k_inner {k1}, k_mid {k2}, block {block}, "
                     f"{da3.warp_geometry(n, block)[1]} chains a CTA"),
            paths=["burgers_da3_pcn"], source="fused_da3_pcn.cu", pots=levels,
            per_step_ops=(k1 * k2 * (ops_of(coarse) + draws) + k2 * ops_of(mid)
                          + ops_of(fine)),
            replaces=JAX_OPS + "391")

    k = da_p.kernel_params["subchain_len"]
    exact, surr = da_p.batched_potential_fn, da_p.batched_surrogate_fn
    args = (pos, pm, ps, da_p.kernel_params["beta"], 31)
    stem = da._burgers_stem(exact, surr, d)
    assert stem == da.BURGERS_KERNEL, f"burgers_da_pcn runs on {stem}"
    for recorded in (False, True):
        kw = dict(subchain_len=k, block_chains=block, **({"thin": 1} if recorded else {}))
        plain_fn = da._run_plain_recorded if recorded else da._run_plain
        compare_chain(
            results, stem, recorded,
            lambda s: da._launch(exact, surr, *args, n_steps=s, **kw),
            lambda s: plain_fn(plain_potential(exact), plain_potential(surr), *args,
                               n_steps=s, **kw),
            steps=4, kernel_long=68, plain_long=8,
            variant=(f"128 / 64 cells, k={k}, block {block}, "
                     f"{da.burgers_warp_geometry(n, block)[1]} chains a CTA"),
            paths=["burgers_da_pcn"], source="fused_da_pcn.cu", pots=(exact, surr),
            per_step_ops=k * (ops_of(surr) + draws) + ops_of(exact))

    for pot, path, variant in (
            (pcn_p.batched_potential_fn, "burgers_pcn", "128 cells, 154 steps"),
            (multi, "burgers_multitime_pcn", "128 cells, 54 + 54 + 46 steps")):
        beta = problems[path].kernel_params["beta"]
        stem = fused_pcn._burgers_stem(pot, d)
        assert stem == fused_pcn.BURGERS_KERNEL, f"{path} runs on {stem}"
        for recorded in (False, True):
            kw = {"thin": 1} if recorded else {}
            compare_chain(
                results, stem, recorded,
                lambda s: fused_pcn._launch(pot, pos, pm, ps, beta, 37, s, block, **kw),
                lambda s: fused_pcn._run_plain(plain_potential(pot), pos, pm, ps, beta,
                                               37, s, block, **kw),
                steps=8, kernel_long=264, plain_long=24,
                variant=(f"{variant}, block {block}, "
                         f"{fused_pcn.burgers_warp_geometry(n, block)[1]} chains a CTA"),
                paths=[path],
                source="fused_pcn.cu", pots=(pot,), per_step_ops=ops_of(pot) + draws)


def burgers_level(n_cells, *, n_modes=16, seed):
    """A Burgers misfit on the card at ``n_cells`` cells (t = 0.2, 16
    observed cells; a spec no config ships), its data the plain forward at
    coefficients drawn from ``seed`` plus noise of 0.02 (numpy): levels of
    one seed observe the same truth."""
    from ip_mcmc_tpu_torch.configs import burgers_misfit_from_arrays
    from ip_mcmc_tpu_torch.models import burgers

    obs = np.linspace(0, n_cells - 1, 16).round().astype(int)
    aux = burgers.burgers_aux(n_cells=n_cells, n_modes=n_modes, alpha=1.5, field_scale=1.0,
                              t_final=0.2, obs_indices=obs,
                              mean_profile=np.sin(2 * np.pi * (np.arange(n_cells) + 0.5)
                                                  / n_cells))
    r = np.random.default_rng(seed)
    truth = burgers_misfit_from_arrays(aux, np.zeros(16), 0.02)
    (state,) = truth.final_states(torch.from_numpy(
        r.standard_normal((n_modes, 1)).astype(np.float32)))
    y = (state[obs, 0].numpy() + 0.02 * r.standard_normal(16)).astype(np.float32)
    return burgers_misfit_from_arrays(aux, y, 0.02).cuda()


def check_burgers_warp(problems, gen, results):
    """What the Burgers DA and pCN warp kernels add beside their twins: the
    Python mirrors of the launch geometry against the C functions, and of
    which specs they take (the C functions refuse the others with
    cudaErrorNotSupported: they run on the one-chain-a-CTA kernels); a
    ragged width, 13 chains in blocks of 8 (two CTAs of 8 warps, 3 of them
    spare), equal bit for bit to the first 13 of the kernel's own 16-chain
    run and within CHAIN_ATOL of the plain twin's, plain and recorded (pCN
    on one and on three segments); then the one-chain-a-CTA kernels on a
    96-cell level (DA: with a 64-cell surrogate) that the warp kernels
    leave, each against its twin at 2048 chains, plain and recorded, so
    that their path stays driven (no shipped config takes it)."""
    import ctypes

    from ip_mcmc_tpu_torch.ops import _build, _scaffold, fused_pcn
    from ip_mcmc_tpu_torch.ops import fused_da_pcn as da

    da_p, pcn_p, multi_p = (problems[k] for k in (
        "burgers_da_pcn", "burgers_pcn", "burgers_multitime_pcn"))
    exact, surr = da_p.batched_potential_fn, da_p.batched_surrogate_fn
    fine, multi = pcn_p.batched_potential_fn, multi_p.batched_potential_fn
    k = da_p.kernel_params["subchain_len"]
    lib = _build.library()
    cases = ((da_p.n_chains, 512), (13, 8), (13, 13), (20, 4), (1, 512))
    check_geometry("Burgers DA", cases,
                   c_geometry_of(lib.ipx_da_pcn_burgers_warp_geometry,
                                 [exact.spec(), surr.spec()], [k], da_p),
                   da.burgers_warp_geometry)
    check_geometry("Burgers pCN", cases,
                   c_geometry_of(lib.ipx_pcn_burgers_warp_geometry, [fine.spec()], [], pcn_p),
                   fused_pcn.burgers_warp_geometry)

    # specs that go to the one-chain-a-CTA kernels: C refuses them, the
    # Python mirror names the one-chain-a-CTA kernel
    wide, wide_surr = burgers_level(96, seed=5), burgers_level(64, seed=5)
    others = (((wide, wide_surr), 16),
              ((burgers_level(128, n_modes=8, seed=6), burgers_level(64, n_modes=8, seed=6)), 8))
    for (lv, lv_surr), d in others:
        pos = torch.zeros(64, d, device="cuda")
        args, _ = _scaffold.chain_args(pos, torch.zeros(d, device="cuda"),
                                       torch.ones(d, device="cuda"), 0, 1, 32)
        out = (ctypes.c_int * 3)()
        status = (lib.ipx_da_pcn_burgers_warp_geometry(
                      ctypes.byref(lv.spec()), ctypes.byref(lv_surr.spec()),
                      ctypes.byref(args), k, out),
                  lib.ipx_pcn_burgers_warp_geometry(ctypes.byref(lv.spec()),
                                                    ctypes.byref(args), out))
        stems = da._burgers_stem(lv, lv_surr, d), fused_pcn._burgers_stem(lv, d)
        if status != (801, 801) or stems != ("fused_da_pcn_burgers_kernel",
                                             "fused_pcn_burgers_kernel"):
            raise AssertionError(f"Burgers warp kernels on {lv.n} / {lv_surr.n} cells, d = {d}: "
                                 f"C status {status}, Python {stems}")
    print(f"Burgers warp kernels: C and Python leave the same {len(others)} other spec "
          "pairs to the one-chain-a-CTA kernels", flush=True)

    pm, ps = da_p.prior.mean, da_p.prior.scale
    pos = da_p.init_positions(torch.Generator().manual_seed(82), 16).cuda()
    for recorded in (False, True):
        kw = {"thin": 1} if recorded else {}
        rec = "true" if recorded else "false"
        da_kw = dict(n_steps=3, subchain_len=4, block_chains=8, **kw)
        got, full = (da._launch(exact, surr, pos[:n], pm, ps, 0.15, 83, **da_kw)
                     for n in (13, 16))
        plain_fn = da._run_plain_recorded if recorded else da._run_plain
        ref = plain_fn(plain_potential(exact), plain_potential(surr), pos, pm, ps, 0.15, 83,
                       **da_kw)
        check_ragged(f"{DA_BURGERS}<{rec}>", "13 chains, 8 warps a CTA, 3 steps of k 4",
                     got, full, ref, recorded)
        for pot, what in ((fine, "one segment"), (multi, "three segments")):
            got, full = (fused_pcn._launch(pot, pos[:n], pm, ps, 0.15, 85, 3, 8, **kw)
                         for n in (13, 16))
            ref = fused_pcn._run_plain(plain_potential(pot), pos, pm, ps, 0.15, 85, 3, 8, **kw)
            check_ragged(f"{PCN_BURGERS}<{rec}>", f"13 chains, 8 warps a CTA, 3 steps, {what}",
                         got, full, ref, recorded)

    n, block = da_p.n_chains, 512
    pos = da_p.init_positions(gen, n).cuda()
    draws = Ops(RNG_OPS_PER_DRAW * pos.shape[1])
    ops_of = burgers_solve_ops
    for recorded in (False, True):
        kw = {"thin": 1} if recorded else {}
        plain_fn = da._run_plain_recorded if recorded else da._run_plain
        da_kw = dict(subchain_len=k, block_chains=block, **kw)
        compare_chain(
            results, "fused_da_pcn_burgers_kernel", recorded,
            lambda s: da._launch(wide, wide_surr, pos, pm, ps, 0.15, 87, n_steps=s, **da_kw),
            lambda s: plain_fn(plain_potential(wide), plain_potential(wide_surr), pos, pm, ps,
                               0.15, 87, n_steps=s, **da_kw),
            steps=2, kernel_long=34, plain_long=4,
            variant=f"96 / 64 cells (a pair the warp kernel leaves), k={k}, block {block}",
            paths=[], source="fused_da_pcn.cu", pots=(wide, wide_surr),
            per_step_ops=k * (ops_of(wide_surr) + draws) + ops_of(wide))
        compare_chain(
            results, "fused_pcn_burgers_kernel", recorded,
            lambda s: fused_pcn._launch(wide, pos, pm, ps, 0.15, 89, s, block, **kw),
            lambda s: fused_pcn._run_plain(plain_potential(wide), pos, pm, ps, 0.15, 89, s,
                                           block, **kw),
            steps=4, kernel_long=132, plain_long=12,
            variant=f"96 cells (a spec the warp kernel leaves), block {block}",
            paths=[], source="fused_pcn.cu", pots=(wide,), per_step_ops=ops_of(wide) + draws)


def padded_burgers(pot):
    """``pot`` with a 17th KL mode of zeros: a level that the warp rule
    leaves (K != 16), so its kernel is the one-draw-a-CTA
    burgers_misfit_kernel. Fed U with a row of zeros added, it adds an exact
    zero to each cell's KL sum, so its Phi has the bits of that kernel on
    ``pot`` itself."""
    import copy

    padded = copy.deepcopy(pot)
    padded.basis = torch.cat([pot.basis, torch.zeros_like(pot.basis[:1])])
    padded.K = pot.K + 1
    return padded


def check_burgers_misfit_warp(problems, gen, results):
    """K12 a draw a warp (burgers_misfit_warp_kernel) beside the kernel it
    replaced on the configs' levels (burgers_misfit_kernel, one draw a CTA):
    the Python mirrors of the rule and the geometry against
    ipx_burgers_misfit_warp_geometry at 2048, 2047, 13, 1 and 0 draws on
    the four levels, and on levels the rule leaves (96 cells, 8 modes, 17
    modes) C's cudaErrorNotSupported against the mirror's refusal; then at
    each level Phi at 2048 draws equal bit for bit to burgers_misfit_kernel's
    on the same level padded by a mode of zeros (``padded_burgers``), and
    on 2047 and 13 draws to the first of the 2048; last, burgers_misfit_kernel
    on a 96-cell level against its plain version and timed (no config has
    such a level: 0 launches on the paths)."""
    import ctypes

    from ip_mcmc_tpu_torch.ops import _build, _burgers_warp

    lib = _build.library()
    da3_p, multi_p = problems["burgers_da3_pcn"], problems["burgers_multitime_pcn"]
    levels = (da3_p.batched_potential_fn, da3_p.batched_mid_fn, da3_p.batched_surrogate_fn,
              multi_p.batched_potential_fn)
    wide = burgers_level(96, seed=5)
    leaves = (wide, burgers_level(128, n_modes=8, seed=6), padded_burgers(levels[0]))
    out = (ctypes.c_int * 3)()
    n = da3_p.n_chains
    for pot in levels:
        for B in (n, n - 1, 13, 1, 0):
            status = lib.ipx_burgers_misfit_warp_geometry(ctypes.byref(pot.spec()), B, out)
            want = _burgers_warp.misfit_geometry(B, pot.n, pot.K)
            if status != 0 or tuple(out) != want or not _burgers_warp.misfit_takes(pot.n, pot.K):
                raise AssertionError(f"{pot.kernel_label} geometry at {B} draws: C {tuple(out)} "
                                     f"(status {status}), Python {want}")
    for pot in leaves:
        status = lib.ipx_burgers_misfit_warp_geometry(ctypes.byref(pot.spec()), 64, out)
        if (status != 801 or _burgers_warp.misfit_takes(pot.n, pot.K)  # cudaErrorNotSupported
                or not pot.kernel_label.startswith(BURGERS_MISFIT_CTA + "[")):
            raise AssertionError(f"{pot.kernel_label} ({pot.n} cells, K {pot.K}): C status "
                                 f"{status}")
    print(f"{BURGERS_MISFIT} geometry: Python mirror equals the C function on the "
          f"{len(levels)} levels (at {n}: {_burgers_warp.misfit_geometry(n, 128)} at 128 cells, "
          f"{_burgers_warp.misfit_geometry(n, 64)} at 64); C and Python leave the same "
          f"{len(leaves)} other levels to {BURGERS_MISFIT_CTA}", flush=True)

    U = da3_p.prior.sample(gen, n).T.contiguous()
    U17 = torch.cat([U, torch.zeros_like(U[:1])])
    for pot in levels:
        padded = padded_burgers(pot)
        before = _build.launch_counts[padded.kernel_label]
        full, old = pot(U), padded(U17)
        torch.cuda.synchronize()
        assert _build.launch_counts[padded.kernel_label] == before + 1
        equal = torch.equal(full, old)
        print(f"{pot.kernel_label} ({n} draws): Phi equal to {padded.kernel_label}'s on the "
              f"level padded by a zero mode {equal}", flush=True)
        if not equal:
            raise AssertionError(f"{pot.kernel_label} is not {BURGERS_MISFIT_CTA}'s bit for bit")
        for B in (n - 1, 13):
            got = pot(U[:, :B].contiguous())
            torch.cuda.synchronize()
            if not torch.equal(got, full[:B]):
                raise AssertionError(f"{pot.kernel_label} on {B} draws disagrees")
        print(f"{pot.kernel_label} ragged ({n - 1} and 13 draws): equal to the first of {n}",
              flush=True)
    compare_small_misfit(
        results, wide, U, variant="96 cells, 116 steps (a level the warp kernel leaves)",
        paths=[], tol=BURGERS_TOL, source="fused_da3_pcn.cu",
        replaces="ip_mcmc_tpu/models/burgers.py:153",
        bound_row=burgers_misfit_bound(wide, U.shape[1]))


# --- K17 (Richardson) and the large Darcy grids ----------------------------------

# benchmarks/darcy_da_richardson.json (the JAX package on a TPU v5e): what of
# each surrogate's run does not depend on the hardware
TPU_RICHARDSON = {
    "cg3": {"outer_accept": 0.6422, "inner_accept": 0.2353, "ess_per_outer_step_chain": 0.18039},
    "rich3_w0.9": {"outer_accept": 0.6719, "inner_accept": 0.2262,
                   "ess_per_outer_step_chain": 0.02912},
    "rich4_w0.8": {"outer_accept": 0.5822, "inner_accept": 0.2328,
                   "ess_per_outer_step_chain": 0.07008},
    "rich2_w0.9": {"outer_accept": 0.1411, "inner_accept": 0.2468,
                   "ess_per_outer_step_chain": 0.0062},
}


def richardson_path(variant):
    return f"darcy_da_richardson[{variant}]"


def misfit8_left(**kw):
    """An 8x8 cold misfit on darcy_da_fused's surrogate observations and data
    with K 36 (dst_trunc-64 / 3 CG unless ``kw`` says otherwise): a spec the
    warp rule leaves to the one-draw-a-CTA kernel (no config)."""
    from ip_mcmc_tpu_torch import configs
    from ip_mcmc_tpu_torch.convert import darcy_misfit_from_arrays
    from ip_mcmc_tpu_torch.models import darcy

    fx = np.load(configs.FIXTURE)
    aux = darcy.darcy_aux(n_grid=8, n_modes_per_dim=6, alpha=2.0, field_scale=10.0,
                          obs_indices=fx["obs_coarse"])
    kw = {"cg_iters": 3, "precond": "dst_trunc", "precond_modes": 64, **kw}
    return darcy_misfit_from_arrays(aux, fx["y_surr"], fx["surr_scale"], **kw).cuda()


def misfits_left_by_warp_rules(problem):
    """Cold misfits that no rule of the 16x16 DA kernel's levels takes (on
    the card): 8x8 with K 36 by CG and by Richardson, 12x12 dst_trunc-64 / 3
    CG and 16x16 Richardson on ``problem``'s data (no config)."""
    from ip_mcmc_tpu_torch.convert import darcy_misfit_from_arrays
    from ip_mcmc_tpu_torch.models import darcy

    def misfit(n_grid, **kw):
        aux = darcy.darcy_aux(n_grid=n_grid, n_modes_per_dim=8, alpha=2.0, field_scale=10.0)
        return darcy_misfit_from_arrays(aux, problem.data, 0.002, cg_iters=3,
                                        precond="dst_trunc", **kw).cuda()

    return (misfit8_left(), misfit8_left(solver="richardson", omega=0.9),
            misfit(12, precond_modes=64),
            misfit(16, precond_modes=128, solver="richardson", omega=0.9))


def check_richardson(richardson, gen, results):
    """K17 in the standalone misfit kernel a draw a warp on the DA kernel's
    8x8 level at each Richardson surrogate of
    benchmarks/darcy_da_richardson.py, and in the one-draw-a-CTA kernel on an
    8x8 spec the warp rule leaves (K 36); then the DA kernel's Richardson
    surrogate instantiation against its plain loop at 4096 chains."""
    from ip_mcmc_tpu_torch.ops import fused_da_pcn as da

    rich = [v for v, p in richardson.items() if p.batched_surrogate_fn.solver == "richardson"]
    for variant in rich:
        p = richardson[variant]
        surr = p.batched_surrogate_fn
        assert surr.kernel_label == MISFIT8_RICH, surr.kernel_label
        U = p.prior.sample(gen, N_CHAINS).T.contiguous()
        compare_misfit(results, surr, U,
                       variant=(f"{variant}: 8x8 dst_trunc-64, {surr.cg_iters} Richardson "
                                f"iterations, omega {surr.omega:.1f}, a draw a warp, "
                                f"{da.MISFIT_SURR_WARP_DRAWS} a CTA"),
                       paths=[richardson_path(variant)], tol=RICH_BF16_TOL,
                       replaces=JAX_DARCY + "401")
    k36 = misfit8_left(solver="richardson", omega=0.9)
    assert k36.kernel_label == "darcy_misfit_kernel[n=8,richardson]", k36.kernel_label
    compare_misfit(results, k36, torch.randn(k36.K, N_CHAINS, generator=gen).cuda(),
                   variant="8x8 K 36, dst_trunc-64, 3 Richardson iterations, omega 0.9: a spec "
                   "the warp rule leaves, one draw a CTA (no path)", paths=[],
                   tol=RICH_BF16_TOL, replaces=JAX_DARCY + "401")
    p = richardson["rich3_w0.9"]
    exact, surr = p.batched_potential_fn, p.batched_surrogate_fn
    pos = p.init_positions(gen, N_CHAINS).cuda()
    kp = p.kernel_params
    block, k = kp["block_chains"], kp["subchain_len"]
    args = (exact, surr, pos, p.prior.mean, p.prior.scale, kp["beta"], 11)
    plain_args = (plain_potential(exact), plain_potential(surr), *args[2:])
    ops = (k * (solve_ops(surr, False) + Ops(RNG_OPS_PER_DRAW * p.dim))
           + solve_ops(exact, False))
    for recorded in (False, True):
        kw = dict(subchain_len=k, block_chains=block)
        if recorded:
            kern = lambda s: da.fused_da_pcn_chain_recorded(*args, n_steps=s, thin=1, **kw)
            plain = lambda s: da._run_plain_recorded(*plain_args, n_steps=s, thin=1, **kw)
        else:
            kern = lambda s: da.fused_da_pcn_chain(*args, n_steps=s, **kw)
            plain = lambda s: da._run_plain(*plain_args, n_steps=s, **kw)
        compare_chain(results, f"{DA16}[surrogate=richardson]", recorded, kern,
                      plain, steps=2, kernel_long=10, plain_long=4,
                      variant=f"rich3_w0.9 surrogate (3 Richardson iterations), block "
                              f"{block}, k={k}",
                      paths=[richardson_path(v) for v in rich], source="fused_da_pcn.cu",
                      pots=(exact, surr), per_step_ops=ops)


def check_large_grids(problems, gen, results):
    """K5 and K7 on the 32x32 and 64x64 grids at their configs' widths: the
    cold misfit kernel (no path launches it: the warm runs start from the
    warm misfit), the warm misfit kernel from x0 = 0 and from a previous
    solution, and the warm pCN kernel (the cluster kernel of each grid),
    plain and recorded; the warm misfits, and at 64x64 the cold one, run on
    the samplers' cluster level. Then the 32x32 cluster level's cold
    misfit on a dst_trunc CG spec, the Layout32 warm kernel on a 32x32
    spec the cluster level leaves (Jacobi / 16 CG), and the Layout64
    kernels on a 64x64 spec the cluster level leaves (K 196, cold and
    warm); no path launches these."""
    from ip_mcmc_tpu_torch.convert import darcy_misfit_from_arrays, darcy_warm_misfit_from_arrays
    from ip_mcmc_tpu_torch.models import darcy
    from ip_mcmc_tpu_torch.ops import fused_pcn

    for config in ("darcy32_pcn_warm", "darcy64_pcn_warm"):
        p = problems[config]
        n_chains, beta = p.n_chains, p.kernel_params["beta"]
        cold = p.batched_potential_fn
        warm, aux_dim = p.batched_warm_potential
        grid = f"{cold.n}x{cold.n}"
        U = p.prior.sample(gen, n_chains).T.contiguous()
        cold_pc = "jacobi" if cold.precond == "jacobi" else f"dst_trunc-{cold.modes}"
        compare_misfit(results, cold, U, variant=f"{grid} cold: {cold_pc}, {cold.cg_iters} CG",
                       paths=[], tol=F32_TOL if cold.precond == "jacobi" else LARGE_BF16_TOL,
                       replaces=JAX_DARCY + "542")
        step = p.prior.sample(gen, n_chains).T.contiguous()
        U2 = (math.sqrt(1 - beta ** 2) * U + beta * step).contiguous()  # a pCN move
        zeros = torch.zeros(aux_dim, n_chains, device="cuda")
        what = f"{grid}: dst_trunc-{warm.modes}, {warm.cg_iters} CG"
        _, x1 = compare_misfit(results, warm, U, x0=zeros, variant=f"{what}, x0 = 0",
                               paths=[config], tol=LARGE_BF16_TOL,
                               replaces=JAX_DARCY + "669")
        compare_misfit(results, warm, U2, x0=x1, variant=f"{what}, x0 = previous solution",
                       paths=[config], tol=LARGE_BF16_TOL, replaces=JAX_DARCY + "669")
        pos = p.init_positions(gen, n_chains).cuda()
        block = p.kernel_params["block_chains"]
        args = (warm, pos, p.prior.mean, p.prior.scale, beta, 13)
        plain_args = (plain_potential(warm, warm=True), *args[1:])
        ops = solve_ops(warm, True) + Ops(RNG_OPS_PER_DRAW * p.dim)
        for recorded in (False, True):
            kw = dict(aux_dim=aux_dim, **({"thin": 1} if recorded else {}))
            compare_chain(
                results, fused_pcn._darcy_stem(warm, True), recorded,
                lambda s: fused_pcn._launch(*args, s, block, **kw),
                lambda s: fused_pcn._run_plain(*plain_args, s, block, **kw),
                steps=4, kernel_long=36, plain_long=8,
                variant=f"{what}, block {block}", paths=[config], source="fused_pcn.cu",
                pots=(warm,), per_step_ops=ops)

    # the cold twin of darcy32_pcn_warm's warm misfit on the 32x32 cluster
    # level (no path: the config's cold misfit is Jacobi)
    p32 = problems["darcy32_pcn_warm"]
    cold = misfit32_cold(p32)
    assert cold.kernel_label == MISFIT32
    U = p32.prior.sample(gen, p32.n_chains).T.contiguous()
    compare_misfit(results, cold, U, variant=f"32x32 cold: dst_trunc-128, {cold.cg_iters} CG, K 64",
                   paths=[], tol=LARGE_BF16_TOL, replaces=JAX_DARCY + "542")
    # a 32x32 warm spec the cluster level leaves (Jacobi): the Layout32
    # warm kernel, from x0 = 0 and from the previous solution
    aux = darcy.darcy_aux(n_grid=32, n_modes_per_dim=8, alpha=2.0, field_scale=10.0)
    warm, aux_dim = darcy_warm_misfit_from_arrays(aux, p32.data, 0.002, cg_iters=16,
                                                  precond="jacobi")
    warm = warm.cuda()
    assert not warm.on_cluster and warm.warm_kernel_label == "darcy_misfit_warm_kernel"
    step = p32.prior.sample(gen, p32.n_chains).T.contiguous()
    beta = p32.kernel_params["beta"]
    U2 = (math.sqrt(1 - beta ** 2) * U + beta * step).contiguous()  # a pCN move
    what = "32x32 jacobi, 16 CG, K 64: a spec the cluster level leaves"
    _, x1 = compare_misfit(results, warm, U, x0=torch.zeros(aux_dim, p32.n_chains, device="cuda"),
                           variant=f"{what}, x0 = 0", paths=[], tol=UNCONVERGED_32_TOL,
                           replaces=JAX_DARCY + "669")
    compare_misfit(results, warm, U2, x0=x1, variant=f"{what}, x0 = previous solution",
                   paths=[], tol=UNCONVERGED_32_TOL, replaces=JAX_DARCY + "669")

    # a finer prior than the layout of the cluster level holds (K 196)
    aux = darcy.darcy_aux(n_grid=64, n_modes_per_dim=14, alpha=2.0, field_scale=10.0)
    data, kw = problems["darcy64_pcn_warm"].data, dict(precond="dst_trunc", precond_modes=256)
    cold = darcy_misfit_from_arrays(aux, data, 0.002, cg_iters=16, **kw).cuda()
    warm, aux_dim = darcy_warm_misfit_from_arrays(aux, data, 0.002, cg_iters=4, **kw)
    warm = warm.cuda()
    assert not cold.on_cluster and not warm.on_cluster
    U = torch.randn(cold.K, LAYOUT64_DRAWS, generator=gen).cuda()
    what = f"64x64 dst_trunc-256, K {cold.K}: a spec the cluster level leaves"
    compare_misfit(results, cold, U, variant=f"{what}, 16 CG", paths=[], tol=LARGE_BF16_TOL,
                   replaces=JAX_DARCY + "542")
    compare_misfit(results, warm, U, x0=torch.zeros(aux_dim, LAYOUT64_DRAWS, device="cuda"),
                   variant=f"{what}, 4 CG, x0 = 0", paths=[], tol=LARGE_BF16_TOL,
                   replaces=JAX_DARCY + "669")


# the draws of the Layout64 rows (a spec the cluster level leaves)
LAYOUT64_DRAWS = 256


def misfit32_cold(problem, cg_iters=16):
    """A cold 32x32 dst_trunc-128 CG misfit on darcy32_pcn_warm's prior and
    data: a spec of the 32x32 cluster level that no config's cold misfit
    has (darcy_misfit_cluster32_kernel, the warm misfit's twin)."""
    from ip_mcmc_tpu_torch.convert import darcy_misfit_from_arrays
    from ip_mcmc_tpu_torch.models import darcy

    aux = darcy.darcy_aux(n_grid=32, n_modes_per_dim=8, alpha=2.0, field_scale=10.0)
    return darcy_misfit_from_arrays(aux, problem.data, 0.002, cg_iters=cg_iters,
                                    precond="dst_trunc", precond_modes=128).cuda()

# darcy64_da_fused on the JAX package on a TPU v5e (config comment, l.861-867
# and l.907-912; BASELINE.md round 5, item 7): what does not depend on the
# hardware
TPU_DARCY64_DA = {"outer_accept": 0.82, "inner_accept": 0.184,
                  "ess_per_outer_step_chain": 0.277, "max_rhat": 1.010}
# the 64x64 kernels and the 32x32 warm pCN: one chain a CTA, the chains of a
# thread-block cluster sharing each read of the factors
DA64 = "fused_da_pcn_cluster_kernel"
PCN64 = "fused_pcn_warm_cluster_kernel"
PCN32 = "fused_pcn_warm_cluster32_kernel"
# the 64x64 misfits at the start positions of the two 64x64 configs, on the
# samplers' cluster level; at 32x32 darcy32_pcn_warm's warm misfit and its
# cold twin (no path), on the 32x32 warm pCN's level
MISFIT64 = "darcy_misfit_cluster_kernel[n=64]"
MISFIT64_WARM = "darcy_misfit_warm_cluster_kernel"
MISFIT32 = "darcy_misfit_cluster32_kernel[n=32]"
MISFIT32_WARM = "darcy_misfit_warm_cluster32_kernel"
# darcy64_da_fused's 32x32 surrogate at its start positions, on the 64x64 DA
# kernel's surrogate level
MISFIT_SURR = "darcy_misfit_surr_cluster_kernel[n=32]"
# ... these and the 16x16 warp misfit as ptxas names them, mangled and
# demangled (each name is in no other kernel's)
MISFIT_PTXAS = {MISFIT8: ("darcy_misfit_warp_kernelILi8ELi0E", "darcy_misfit_warp_kernel<8, 0>"),
                MISFIT8_RICH: ("darcy_misfit_warp_kernelILi8ELi1E",
                               "darcy_misfit_warp_kernel<8, 1>"),
                MISFIT_WARM16: ("darcy_misfit_warm_warp_kernel",),
                MISFIT_WARM_DST: ("darcy_misfit_warm_dst_warp_kernel",),
                MISFIT64: ("darcy_misfit_cluster_kernel",),
                MISFIT64_WARM: ("darcy_misfit_warm_cluster_kernel",),
                MISFIT32: ("darcy_misfit_cluster32_kernel",),
                MISFIT32_WARM: ("darcy_misfit_warm_cluster32_kernel",),
                MISFIT16: ("darcy_misfit_warp_kernelILi16ELi0E", "darcy_misfit_warp_kernel<16, 0>"),
                MISFIT_SLICE: ("darcy_misfit_slice_kernel",),
                MISFIT_SURR: ("darcy_misfit_surr_cluster_kernel",)}


def check_da64(problem, gen, results):
    """darcy64_da_fused at its width (1024 chains, blocks of 128, k = 48):
    the exact (64 x 64) and surrogate (32 x 32) misfit kernels, each on the
    DA kernel's cluster level, then the DA kernel's 64 x 64 instantiation,
    plain and recorded, against the plain loop."""
    from ip_mcmc_tpu_torch.ops import fused_da_pcn as da

    exact, surr = problem.batched_potential_fn, problem.batched_surrogate_fn
    n_chains, kp = problem.n_chains, problem.kernel_params
    U = problem.prior.sample(gen, n_chains).T.contiguous()
    assert (exact.kernel_label, surr.kernel_label) == (MISFIT64, MISFIT_SURR)
    for pot, level in ((exact, "exact"), (surr, "surrogate")):
        compare_misfit(results, pot, U,
                       variant=(f"{level}: {pot.n}x{pot.n} dst_trunc-{pot.modes}, "
                                f"{pot.cg_iters} CG, K {pot.K}"),
                       paths=["darcy64_da_fused"], tol=LARGE_BF16_TOL,
                       replaces=JAX_DARCY + "542")
    pos = problem.init_positions(gen, n_chains).cuda()
    block, k = kp["block_chains"], kp["subchain_len"]
    args = (exact, surr, pos, problem.prior.mean, problem.prior.scale, kp["beta"], 11)
    plain_args = (plain_potential(exact), plain_potential(surr), *args[2:])
    ops = (k * (solve_ops(surr, False) + Ops(RNG_OPS_PER_DRAW * problem.dim))
           + solve_ops(exact, False))
    for recorded in (False, True):
        kw = dict(subchain_len=k, block_chains=block)
        if recorded:
            kern = lambda s: da.fused_da_pcn_chain_recorded(*args, n_steps=s, thin=1, **kw)
            plain = lambda s: da._run_plain_recorded(*plain_args, n_steps=s, thin=1, **kw)
        else:
            kern = lambda s: da.fused_da_pcn_chain(*args, n_steps=s, **kw)
            plain = lambda s: da._run_plain(*plain_args, n_steps=s, **kw)
        compare_chain(results, DA64, recorded, kern, plain, steps=2, kernel_long=6,
                      plain_long=4, variant=f"64x64 exact, 32x32 surrogate, block {block}, k={k}",
                      paths=["darcy64_da_fused"], source="fused_da_pcn.cu",
                      pots=(exact, surr), per_step_ops=ops)


# --- the specs the Hopper designs leave: one chain a CTA ------------------------
#
# Each sampler's takes-rule (the C ``*_route``, mirrored by the wrapper's
# ``route``) sends the specs its Hopper design takes to that design and the
# rest of its domain to a one-chain-a-CTA kernel; no shipped config sends
# one there (RETIRED lists them for every path). The specs below hold each
# such kernel against its plain twin at the chain counts of its family's
# configs: 4096 on the 16x16 class and at 24x24 and 32x32, 2048 at 48x48
# (darcy64_pcn_warm's) and on Burgers, 1024 for the DA pair of the 64x64
# class (darcy64_da_fused's).
ESS_CTA, FES_CTA = "fused_ess_kernel", "fused_fes_kernel"
MALA_CTA, MALA_WARM_CTA = "fused_mala_kernel", "fused_mala_warm_kernel"
DA16_CTA, DA64_CTA = "fused_da_pcn_kernel[layout16]", "fused_da_pcn_kernel[layout64]"
PCN32_CTA, PCN64_CTA = "fused_pcn_warm_kernel[layout32]", "fused_pcn_warm_kernel[layout64]"
DA3_CTA = "fused_da3_pcn_kernel"
RESTORED = (ESS_CTA, FES_CTA, MALA_CTA, MALA_WARM_CTA, DA16_CTA, DA64_CTA, PCN32_CTA, PCN64_CTA,
            DA3_CTA)
# the step builders of ip_mcmc_tpu/ops/fused_mcmc.py the kernels replace
RESTORED_REPLACES = {ESS_CTA: "680", FES_CTA: "571", MALA_CTA: "784", MALA_WARM_CTA: "732",
                     DA16_CTA: "325", DA64_CTA: "325", PCN32_CTA: "486", PCN64_CTA: "486",
                     DA3_CTA: "391"}


# ... their instantiations as ptxas names them, mangled and demangled
_DARCY16 = ("8DarcyPotINS_8Layout16ELi0EEE", "DarcyPot<ipx::Layout16, 0>")
_DA_POTS = {DA16_CTA: ("8Layout16ELi0EEELb{b}ES3_E", "Layout16, 0>, {r}, ipx::DarcyPot<ipx::Layout16, 0>"),
            DA64_CTA: ("10DaLayout64ELi0EEELb{b}E", "DaLayout64, 0>, {r}, ")}
# (ESS, FES, cold MALA and three-level DA are templates on the potential
# type since the linear-Gaussian family took them)
_CTA_POTS = {ESS_CTA: _DARCY16, FES_CTA: _DARCY16, MALA_CTA: _DARCY16,
             DA3_CTA: ("16BurgersPotentialE", "BurgersPotential")}
RESTORED_PTXAS = {
    **{f"{stem}<{r}>": (f"{len(stem)}{stem}INS_{m}Lb{b}E", f"ipx::{stem}<ipx::{p}, {r}>")
       for stem, (m, p) in _CTA_POTS.items() for b, r in ((0, "false"), (1, "true"))},
    **{f"{MALA_WARM_CTA}<{r}>": (f"{len(MALA_WARM_CTA)}{MALA_WARM_CTA}ILb{b}E",
                                 f"ipx::{MALA_WARM_CTA}<{r}>")
       for b, r in ((0, "false"), (1, "true"))},
    **{f"{stem}<{r}>": (f"fused_da_pcn_kernelINS_8DarcyPotINS_{m.format(b=b)}",
                        f"fused_da_pcn_kernel<ipx::DarcyPot<ipx::{d.format(r=r)}")
       for stem, (m, d) in _DA_POTS.items() for b, r in ((0, "false"), (1, "true"))},
    **{f"{stem}<{r}>": (f"fused_pcn_warm_kernelINS_8DarcyPotINS_8{lay}ELi0EEELb{b}E",
                        f"fused_pcn_warm_kernel<ipx::DarcyPot<ipx::{lay}, 0>, {r}>")
       for stem, lay in ((PCN32_CTA, "Layout32"), (PCN64_CTA, "Layout64"))
       for b, r in ((0, "false"), (1, "true"))}}


def synthetic_darcy(n, per_dim, *, seed, kind="cold", noise=0.01, **kw):
    """A Darcy misfit on the card on an n x n grid with per_dim^2 KL modes,
    its data its own converged plain solve (300 Jacobi CG) at a numpy draw of
    the prior plus numpy noise; ``kind``: cold (DarcyMisfit), warm
    (DarcyMisfitWarm) or mala (DarcyMisfitMalaWarm); ``kw``: the solve."""
    from ip_mcmc_tpu_torch import convert
    from ip_mcmc_tpu_torch.models import darcy

    aux = darcy.darcy_aux(n_grid=n, n_modes_per_dim=per_dim, alpha=2.0, field_scale=10.0)
    r = np.random.default_rng(seed)
    truth = convert.darcy_misfit_from_arrays(aux, np.zeros(len(aux["obs_indices"])), noise,
                                             cg_iters=300)
    u = torch.from_numpy(r.standard_normal((per_dim * per_dim, 1)).astype(np.float32))
    x = truth._solve_plain(u)[1][:, 0].numpy()
    y = (x[aux["obs_indices"]] + noise * r.standard_normal(len(aux["obs_indices"])))
    build = {"cold": convert.darcy_misfit_from_arrays,
             "warm": convert.darcy_warm_misfit_from_arrays,
             "mala": convert.darcy_mala_warm_misfit_from_arrays}[kind]
    pot = build(aux, y.astype(np.float32), noise, **kw)
    return (pot[0] if kind != "cold" else pot).cuda()


def synthetic_burgers(cells, K, *, seed, noise=0.02):
    """Three Burgers levels on the card, (fine, middle, coarse): ``cells``
    cells fine (t = 0.2 at the conservative CFL bound) and middle (CFL 1),
    cells / 2 coarse (CFL 1, observed at the nearest cells), K KL modes, the
    data the fine model at a numpy prior draw plus numpy noise."""
    from ip_mcmc_tpu_torch.convert import burgers_misfit_from_arrays
    from ip_mcmc_tpu_torch.models import burgers

    def sine_mean(n):
        return (0.5 * np.sin(2 * np.pi * (np.arange(n) + 0.5) / n)).astype(np.float32)

    fine = burgers.burgers_aux(n_cells=cells, n_modes=K, alpha=1.5, field_scale=1.0,
                               t_final=0.2, mean_profile=sine_mean(cells))
    obs = fine["obs_indices"]
    obs_c = np.clip(np.round((obs + 0.5) / 2 - 0.5).astype(int), 0, cells // 2 - 1)
    levels = [fine, burgers.burgers_aux(n_cells=cells, n_modes=K, alpha=1.5, field_scale=1.0,
                                        t_final=0.2, mean_profile=sine_mean(cells),
                                        cfl_amax=1.0),
              burgers.burgers_aux(n_cells=cells // 2, n_modes=K, alpha=1.5, field_scale=1.0,
                                  t_final=0.2, mean_profile=sine_mean(cells // 2),
                                  obs_indices=obs_c, cfl_amax=1.0)]
    r = np.random.default_rng(seed)
    truth = burgers_misfit_from_arrays(fine, np.zeros(len(obs)), noise)
    (state,) = truth.final_states(torch.from_numpy(r.standard_normal((K, 1)).astype(np.float32)))
    y = (state[obs, 0].numpy() + noise * r.standard_normal(len(obs))).astype(np.float32)
    return tuple(burgers_misfit_from_arrays(a, y, noise).cuda() for a in levels)


def launched(name, fn, per_step=None):
    """``fn`` that asserts that each call launched the kernel ``name`` (the
    one the rule picked) once, or ``per_step`` times a step it runs."""
    from ip_mcmc_tpu_torch.ops import _build

    def run(steps):
        before = _build.launch_counts[name]
        out = fn(steps)
        got = _build.launch_counts[name] - before
        assert got == (per_step * steps if per_step else 1), f"{name}: {got} launches"
        return out
    return run


def check_restored(problems, gen, results):
    """Each one-chain-a-CTA kernel that a takes-rule sends the specs its
    Hopper design leaves, plain and recorded, against the plain loop on the
    same start and seed (compare_chain's tolerances), at its family's chain
    counts; the C rule and its Python mirror agree on every spec."""
    import ctypes

    from ip_mcmc_tpu_torch.ops import _build, _scaffold
    from ip_mcmc_tpu_torch.ops import fused_da3_pcn as da3
    from ip_mcmc_tpu_torch.ops import fused_da_pcn as da
    from ip_mcmc_tpu_torch.ops import fused_ess, fused_fes, fused_mala, fused_pcn

    lib = _build.library()
    t0 = time.perf_counter()
    ROUTE = {v: k for k, v in _scaffold.ROUTES.items()}

    def case(stem, recorded, kern, plain, *, steps, long, plain_long, variant, source, pots,
             ops, per_step=None):
        name = f"{stem}<{'true' if recorded else 'false'}>"
        compare_chain(results, stem, recorded, launched(name, kern, per_step), plain,
                      steps=steps, kernel_long=long, plain_long=plain_long,
                      variant=f"{variant} (a spec the Hopper design leaves; no path)",
                      paths=[], source=source, pots=pots, per_step_ops=ops,
                      replaces=JAX_OPS + RESTORED_REPLACES[stem])

    def agree(what, c_route, py_route):
        if c_route != ROUTE[py_route]:
            raise AssertionError(f"{what}: C route {c_route}, Python {py_route}")

    darcy16 = problems["darcy_da_fused"].batched_potential_fn  # dst_trunc-128, 12 CG
    prior16 = problems["darcy_da_fused"].prior
    n16 = N_CHAINS
    pos16 = prior16.sample(gen, n16).contiguous()
    pm16, ps16 = prior16.mean, prior16.scale

    # K8: the DA exact level's dst_trunc-128 at 16x16, and 12x12 Jacobi, d = 36
    jac12 = synthetic_darcy(12, 6, seed=41, cg_iters=48)
    shrink, block = problems["darcy_ess_fused"].kernel_params["max_shrink"], 128
    for pot in (darcy16, jac12):
        d = pot.K
        agree("ESS", lib.ipx_ess_route(ctypes.byref(pot.spec()), d),
              fused_ess.route(**pot.spec_fields, d=d))
        assert fused_ess.route(**pot.spec_fields, d=d) == "cta"
        pos = pos16 if d == 64 else torch.randn(n16, d, generator=gen).to(pos16.device)
        pm, ps = torch.zeros_like(pos[0]), torch.ones_like(pos[0])
        counting = CountingPotential(pot, shrink)
        fused_ess._run_plain(counting, pos, pm, ps, 17, 6, shrink, block)
        per_step = sum(counting.per_step[2:]) / 4
        for recorded in (False, True):
            kw = {"thin": 1} if recorded else {}
            fn = fused_ess.fused_ess_chain_recorded if recorded else fused_ess.fused_ess_chain
            case(ESS_CTA, recorded,
                 lambda s: fn(pot, pos, pm, ps, 17, n_steps=s, max_shrink=shrink,
                              block_chains=block, **kw),
                 lambda s: fused_ess._run_plain(plain_potential(pot), pos, pm, ps, 17, s,
                                                shrink, block, **kw),
                 steps=2, long=6, plain_long=4,
                 variant=(f"{pot.n}x{pot.n} {pot.precond}-{pot.modes}, {pot.cg_iters} CG, "
                          f"d = {d}, max_shrink {shrink}, block {block}"),
                 source="fused_ess.cu", pots=(pot,),
                 ops=per_step * solve_ops(pot, False) + Ops(RNG_OPS_PER_DRAW * d))

    # K9 on the same 16x16 dst_trunc-128
    d = 64
    agree("FES", lib.ipx_fes_route(ctypes.byref(darcy16.spec()), d),
          fused_fes.route(**darcy16.spec_fields, d=d))
    args = (pos16, pm16, ps16, 8, 23, 0.08, 2.0)
    for recorded in (False, True):
        kw = {"thin": 1} if recorded else {}
        case(FES_CTA, recorded,
             lambda s: fused_fes._launch(darcy16, *args, s, block, **kw),
             lambda s: fused_fes._run_plain(plain_potential(darcy16), *args, s, block, **kw),
             steps=2, long=6, plain_long=4, per_step=2,
             variant=f"16x16 dst_trunc-128, 12 CG, M = 8, block {block}, two launches a step",
             source="fused_fes.cu", pots=(darcy16,),
             ops=2 * solve_ops(darcy16, False) + Ops(RNG_OPS_PER_DRAW * d))

    # K10 cold on the 16x16 dst_trunc-128 (12 + 12 CG); K11 warm on 16x16
    # Jacobi / 48 + 48 CG
    eps = problems["darcy_mala_warm"].kernel_params["step_size"]
    mala_warm = mala_warm_jacobi(problems["darcy_mala_warm"])
    for stem, pot, warm in ((MALA_CTA, darcy16, False), (MALA_WARM_CTA, mala_warm, True)):
        agree("MALA", lib.ipx_mala_route(ctypes.byref(pot.spec()), d, int(warm)),
              fused_mala.route(warm, **pot.spec_fields, d=d))
        extra = {"aux_dim": pot.aux_dim} if warm else {}
        for recorded in (False, True):
            kw = dict(extra, thin=1) if recorded else extra
            case(stem, recorded,
                 lambda s: fused_mala._launch(pot, pos16, pm16, ps16, eps, 19, s, block, **kw),
                 lambda s: fused_mala._run_plain(plain_potential(pot, warm=warm), pos16, pm16,
                                                 ps16, eps, 19, s, block, **kw),
                 steps=2, long=6, plain_long=4,
                 variant=(f"16x16 {pot.precond}{'-' + str(pot.modes) if pot.modes else ''}, "
                          f"{pot.cg_iters} + {pot.cg_iters} CG, block {block}"),
                 source="fused_mala.cu", pots=(pot,),
                 ops=grad_ops(pot, warm) + Ops(RNG_OPS_PER_DRAW * d))

    # K4 / K5: 16x16 exact with a 12x12 Jacobi surrogate, d = 64, 4096
    # chains; 48x48 dst_trunc exact with a 24x24 CG surrogate, K = 144, 1024
    k = 8
    surr12 = synthetic_darcy(12, 8, seed=42, cg_iters=3)
    exact48 = synthetic_darcy(48, 12, seed=43, cg_iters=16, precond="dst_trunc",
                              precond_modes=256)
    surr24 = synthetic_darcy(24, 12, seed=44, cg_iters=3, precond="dst_trunc",
                             precond_modes=128)
    p64 = problems["darcy64_da_fused"]
    for stem, exact, surr, prior, n, beta in (
            (DA16_CTA, darcy16, surr12, prior16, n16, 0.35),
            (DA64_CTA, exact48, surr24, p64.prior, p64.n_chains, 0.3)):
        dd = exact.K
        agree("DA", lib.ipx_da_pcn_route(ctypes.byref(exact.spec()), ctypes.byref(surr.spec()),
                                         dd),
              da.route(exact.spec_fields, surr.spec_fields, dd))
        assert da._darcy_stem(exact, surr) == stem
        pos = prior.sample(gen, n).contiguous()
        a = (exact, surr, pos, prior.mean, prior.scale, beta, 11)
        pa = (plain_potential(exact), plain_potential(surr), *a[2:])
        kw = dict(subchain_len=k, block_chains=128)
        small = n < n16
        for recorded in (False, True):
            if recorded:
                kern = lambda s: da.fused_da_pcn_chain_recorded(*a, n_steps=s, thin=1, **kw)
                plain = lambda s: da._run_plain_recorded(*pa, n_steps=s, thin=1, **kw)
            else:
                kern = lambda s: da.fused_da_pcn_chain(*a, n_steps=s, **kw)
                plain = lambda s: da._run_plain(*pa, n_steps=s, **kw)
            case(stem, recorded, kern, plain, steps=1 if small else 2, long=3 if small else 4,
                 plain_long=2 if small else 4,
                 variant=(f"{exact.n}x{exact.n} {exact.precond} / {exact.cg_iters} CG exact, "
                          f"{surr.n}x{surr.n} {surr.precond} / {surr.cg_iters} CG surrogate, "
                          f"K = {dd}, k = {k}, block 128"),
                 source="fused_da_pcn.cu", pots=(exact, surr),
                 ops=(k * (solve_ops(surr, False) + Ops(RNG_OPS_PER_DRAW * dd))
                      + solve_ops(exact, False)))

    # K7 warm above 16x16 off the cluster levels: 24x24 dst_trunc, 32x32
    # Jacobi / 16 CG (4096 chains), 48x48 dst_trunc (2048, K = 144)
    n48 = problems["darcy64_pcn_warm"].n_chains
    for stem, pot, n, beta in (
            (PCN32_CTA, synthetic_darcy(24, 8, seed=45, kind="warm", cg_iters=4,
                                        precond="dst_trunc", precond_modes=128), n16, 0.08),
            (PCN32_CTA, synthetic_darcy(32, 8, seed=46, kind="warm", cg_iters=16), n16, 0.08),
            (PCN64_CTA, synthetic_darcy(48, 12, seed=47, kind="warm", cg_iters=4,
                                        precond="dst_trunc", precond_modes=256), n48, 0.06)):
        dd = pot.K
        agree("pCN", lib.ipx_pcn_route(ctypes.byref(pot.spec()), dd, 1),
              fused_pcn.route(True, **pot.spec_fields, d=dd))
        assert fused_pcn._darcy_stem(pot, True) == stem
        pos = torch.randn(n, dd, generator=gen).to(pos16.device)
        pm, ps = torch.zeros_like(pos[0]), torch.ones_like(pos[0])
        a = (pot, pos, pm, ps, beta, 13)
        for recorded in (False, True):
            kw = {"aux_dim": pot.aux_dim, **({"thin": 1} if recorded else {})}
            fn = fused_pcn.fused_pcn_chain_warm_recorded if recorded else \
                fused_pcn.fused_pcn_chain_warm
            case(stem, recorded,
                 lambda s: fn(*a, n_steps=s, block_chains=128, **kw),
                 lambda s: fused_pcn._run_plain(plain_potential(pot, warm=True), *a[1:], s,
                                                128, **kw),
                 steps=2, long=10, plain_long=6,
                 variant=(f"{pot.n}x{pot.n} {pot.precond}"
                          f"{'-' + str(pot.modes) if pot.modes else ''}, {pot.cg_iters} CG "
                          f"warm, K = {dd}, block 128"),
                 source="fused_pcn.cu", pots=(pot,),
                 ops=solve_ops(pot, True) + Ops(RNG_OPS_PER_DRAW * dd))

    # K13: levels of 96 / 96 / 48 cells, K = d = 32, 2048 chains
    levels = synthetic_burgers(96, 32, seed=48)
    dd, n = 32, problems["burgers_da3_pcn"].n_chains
    agree("DA3", lib.ipx_da3_route(*(ctypes.byref(lv.spec()) for lv in levels), dd),
          da3.route([(lv.n, lv.K) for lv in levels], dd))
    pos = torch.randn(n, dd, generator=gen).to(pos16.device)
    pm, ps = torch.zeros_like(pos[0]), torch.ones_like(pos[0])
    k_inner, k_mid = 4, 2
    a = (*levels, pos, pm, ps, 0.25, 29)
    pa = (*(plain_potential(lv) for lv in levels), *a[3:])
    draws = Ops(RNG_OPS_PER_DRAW * dd)
    ops = (k_mid * (k_inner * (burgers_solve_ops(levels[2]) + draws)
                    + burgers_solve_ops(levels[1])) + burgers_solve_ops(levels[0]))
    for recorded in (False, True):
        kw = dict(k_inner=k_inner, k_mid=k_mid, block_chains=128,
                  **({"thin": 1} if recorded else {}))
        fn = da3.fused_da3_pcn_chain_recorded if recorded else da3.fused_da3_pcn_chain
        case(DA3_CTA, recorded, lambda s: fn(*a, n_steps=s, **kw),
             lambda s: da3._run_plain(*pa, s, k_inner, k_mid, 128,
                                      thin=1 if recorded else None),
             steps=2, long=6, plain_long=4,
             variant=(f"96 / 96 / 48 cells, K = d = 32, k_inner {k_inner}, k_mid {k_mid}, "
                      "block 128"),
             source="fused_da3_pcn.cu", pots=levels, ops=ops)
    print(f"restored one-chain-a-CTA kernels: {time.perf_counter() - t0:.1f} s", flush=True)


def check_cluster(problems):
    """What the cluster kernels add beside their twins: the Python mirror of
    the launch geometry against the C function, and a ragged width, 13
    chains (two clusters of 8 CTAs, 3 of them spare, running on zeros):
    equal bit for bit to the first 13 of the kernel's own 16-chain run, and
    within CHAIN_ATOL of the plain twin's 16-chain run, plain and recorded,
    for the 64x64 DA and warm pCN kernels and the 32x32 warm pCN kernel."""
    import ctypes

    from ip_mcmc_tpu_torch.ops import _build, _cluster, _scaffold, fused_pcn
    from ip_mcmc_tpu_torch.ops import fused_da_pcn as da

    lib = _build.library()
    da_p, pcn_p = problems["darcy64_da_fused"], problems["darcy64_pcn_warm"]
    p32 = problems["darcy32_pcn_warm"]
    exact, surr = da_p.batched_potential_fn, da_p.batched_surrogate_fn
    levels = ((da_p, exact, surr), (pcn_p, pcn_p.batched_warm_potential[0], None),
              (p32, p32.batched_warm_potential[0], None))
    shipped = []
    for p, e, s in levels:
        for n, block in ((p.n_chains, p.kernel_params["block_chains"]), (13, 8), (16, 4),
                         (1, 128)):
            pos = torch.zeros(n, p.dim, device="cuda")
            args, _ = _scaffold.chain_args(pos, p.prior.mean, p.prior.scale, 0, 1, block)
            out = (ctypes.c_int * 4)()
            status = lib.ipx_darcy_cluster_geometry(
                ctypes.byref(e.spec()), None if s is None else ctypes.byref(s.spec()),
                ctypes.byref(args), out)
            want = _cluster.cluster_geometry(
                n, block, d=p.dim, exact_n=e.n, exact_modes=e.modes,
                surr_n=None if s is None else s.n, surr_modes=128 if s is None else s.modes)
            if status != 0 or tuple(out) != want:
                raise AssertionError(f"cluster geometry of {p.name} at {n} chains, block "
                                     f"{block}: C {tuple(out)} (status {status}), Python {want}")
            if n == p.n_chains:
                shipped.append(want)
    print(f"cluster geometry: Python mirror equals the C function for {DA64}, {PCN64} and "
          f"{PCN32} (shipped: {shipped[0]}, {shipped[1]} and {shipped[2]})", flush=True)
    check_misfit_cluster_geometry(problems)

    block, steps = 8, 3
    for p, stem in ((da_p, DA64), (pcn_p, PCN64), (p32, PCN32)):
        pos = p.init_positions(torch.Generator().manual_seed(71), 16).cuda()
        beta = p.kernel_params["beta"]
        warm, aux_dim = p.batched_warm_potential or (None, None)
        for recorded in (False, True):
            thin = 1 if recorded else None
            if stem == DA64:
                kern = lambda n: da._launch(exact, surr, pos[:n], p.prior.mean, p.prior.scale,  # noqa: E731
                                            beta, 73, steps, 4, block, thin=thin)
                plain = (plain_potential(exact), plain_potential(surr))
                tail = (p.prior.mean, p.prior.scale, beta, 73, steps)
                ref = (da._run_plain_recorded(*plain, pos, *tail, 1, 4, block) if recorded
                       else da._run_plain(*plain, pos, *tail, 4, block))
            else:
                kern = lambda n: fused_pcn._launch(warm, pos[:n], p.prior.mean, p.prior.scale,  # noqa: E731
                                                   beta, 73, steps, block, thin=thin,
                                                   aux_dim=aux_dim)
                ref = fused_pcn._run_plain(plain_potential(warm, warm=True), pos, p.prior.mean,
                                           p.prior.scale, beta, 73, steps, block, thin=thin,
                                           aux_dim=aux_dim)
            got, full = kern(13), kern(16)
            torch.cuda.synchronize()
            equal = all(torch.equal(g, f[:, :13] if g.dim() == 3 else f[:13])
                        for g, f in zip(got, full))
            dev = (got[0] - ref[0][:13]).abs().max(dim=1).values
            frac = float((dev <= CHAIN_ATOL).double().mean())
            if recorded:
                rec = (got[2] - ref[2][:, :13]).abs().amax(dim=(0, 2))
                frac = min(frac, float((rec <= CHAIN_ATOL).double().mean()))
            rate = abs(float(got[1].mean()) - float(ref[1][:13].mean()))
            name = f"{stem}<{'true' if recorded else 'false'}>"
            g = _cluster.CLUSTER32_G if stem == PCN32 else _cluster.CLUSTER_G
            print(f"{name} ragged (13 chains in clusters of {g}, {steps} steps): equal to the "
                  f"first 13 of 16 {equal}; {frac:.4f} of chains within {CHAIN_ATOL} of the "
                  f"plain twin, acceptance {float(got[1].mean()):.4f} plain "
                  f"{float(ref[1][:13].mean()):.4f}", flush=True)
            if not equal or frac < MIN_CHAIN_FRAC or rate > RATE_ATOL:
                raise AssertionError(f"{name} on a ragged width disagrees")


def check_misfit_cluster_geometry(problems):
    """The standalone cluster misfits' geometry: for the two 64x64 configs'
    misfits (darcy64_da_fused's 32x32 surrogate, K 144, on the DA kernel's
    surrogate level), darcy32_pcn_warm's warm misfit and its cold twin the
    Python mirror against the C function at their widths, a ragged 13, 1
    and 0 draws; for specs the cluster levels leave (darcy32_pcn_warm's cold
    Jacobi misfit; a 64x64 Jacobi misfit; 32x32 surrogates with K 196,
    Jacobi, Richardson or 144 modes), C's cudaErrorNotSupported against the
    mirror's refusal."""
    import ctypes

    from ip_mcmc_tpu_torch.convert import darcy_misfit_from_arrays
    from ip_mcmc_tpu_torch.models import darcy
    from ip_mcmc_tpu_torch.ops import _build, _cluster

    lib = _build.library()
    da_p, pcn_p = problems["darcy64_da_fused"], problems["darcy64_pcn_warm"]
    p32 = problems["darcy32_pcn_warm"]
    aux = darcy.darcy_aux(n_grid=64, n_modes_per_dim=12, alpha=2.0, field_scale=10.0)
    taken = ((da_p.batched_potential_fn, da_p.n_chains),
             (pcn_p.batched_warm_potential[0], pcn_p.n_chains),
             (pcn_p.batched_potential_fn, pcn_p.n_chains),
             (p32.batched_warm_potential[0], p32.n_chains),
             (misfit32_cold(p32), p32.n_chains),
             (da_p.batched_surrogate_fn, da_p.n_chains))
    left = (p32.batched_potential_fn,
            darcy_misfit_from_arrays(aux, pcn_p.data, 0.002, cg_iters=30).cuda(),
            *surrogates_left().values())

    def geometry(pot, B):
        out = (ctypes.c_int * 4)()
        return lib.ipx_darcy_misfit_cluster_geometry(ctypes.byref(pot.spec()), B, out), tuple(out)

    shipped = []
    for pot, width in taken:
        kw = pot.spec_fields
        for B in (width, 13, 1, 0):
            status, out = geometry(pot, B)
            want = _cluster.misfit_cluster_geometry(B, **kw)
            if status != 0 or out != want:
                raise AssertionError(f"misfit cluster geometry at {B} draws: C {out} (status "
                                     f"{status}), Python {want}")
        shipped.append(_cluster.misfit_cluster_geometry(width, **kw))
    for pot in left:
        status, _ = geometry(pot, 64)
        takes = _cluster.misfit_cluster_takes(**pot.spec_fields)
        if status != 801 or takes:  # cudaErrorNotSupported
            raise AssertionError(f"cluster misfit on {pot.n}x{pot.n} {pot.precond}: C status "
                                 f"{status}, Python takes {takes}")
    print(f"misfit cluster geometry: Python mirror equals the C function for {MISFIT64}, "
          f"{MISFIT64_WARM}, {MISFIT32_WARM}, {MISFIT32} and {MISFIT_SURR} (shipped: "
          f"{shipped[0]}, {shipped[1]}, {shipped[3]}, {shipped[5]}); C and Python leave the same "
          f"{len(left)} other specs to the layouts' kernels", flush=True)


def surrogates_left():
    """32x32 cold misfits on darcy64_da_fused's surrogate prior and data
    that no cluster level takes: K 196, Jacobi / 16 CG, K17's Richardson,
    144 modes ({name: misfit}, on the card)."""
    from ip_mcmc_tpu_torch import configs
    from ip_mcmc_tpu_torch.convert import darcy_misfit_from_arrays
    from ip_mcmc_tpu_torch.models import darcy

    fx = np.load(configs.DARCY64_DA_FIXTURE)

    def misfit(modes_per_dim=12, **kw):
        aux = darcy.darcy_aux(n_grid=32, n_modes_per_dim=modes_per_dim, alpha=2.0,
                              field_scale=10.0, obs_indices=fx["obs_coarse"])
        kw = {"cg_iters": 3, "precond": "dst_trunc", "precond_modes": 128, **kw}
        return darcy_misfit_from_arrays(aux, fx["y_surr"], fx["surr_scale"], **kw).cuda()

    return {"K196": misfit(14), "jacobi": misfit(precond="jacobi", cg_iters=16),
            "richardson": misfit(solver="richardson", omega=0.9),
            "modes144": misfit(precond_modes=144)}


def check_misfit_levels(problems, richardson):
    """What the standalone misfits on the samplers' levels add beside their
    twins. For darcy_misfit_warp_kernel on the 16x16 DA kernel's exact
    level: the Python mirror of its rule and geometry against the C
    function, for darcy_da_fused's exact misfit and the Richardson runs' at
    4096, a ragged 13, 1 and 0 draws; for the specs no level takes (the
    16x16 Jacobi / 48 CG misfit of ESS, cold pCN and FES; a 32x32 misfit;
    misfits_left_by_warp_rules), C's cudaErrorNotSupported against the
    mirror's refusal (its 8x8 level: check_warm16_surr8). Then a ragged width
    for it and for the 32x32 cluster misfits, warm and cold: Φ (and x) on
    13 draws equal bit for bit to the first 13 of the kernel's own 16-draw
    run."""
    import ctypes

    from ip_mcmc_tpu_torch.ops import _build
    from ip_mcmc_tpu_torch.ops import fused_da_pcn as da

    lib = _build.library()
    da_p, p32 = problems["darcy_da_fused"], problems["darcy32_pcn_warm"]
    rich = richardson["rich3_w0.9"]
    taken = (da_p.batched_potential_fn, rich.batched_potential_fn)
    surr8 = (da_p.batched_surrogate_fn, rich.batched_surrogate_fn)
    left = (problems["darcy_ess_fused"].batched_potential_fn, misfit32_cold(p32),
            *misfits_left_by_warp_rules(da_p))

    def geometry(pot, B):
        out = (ctypes.c_int * 3)()
        return lib.ipx_darcy_misfit_warp_geometry(ctypes.byref(pot.spec()), B, out), tuple(out)

    for pot in taken:
        for B in (N_CHAINS, 13, 1, 0):
            status, out = geometry(pot, B)
            want = da.misfit_warp_geometry(B, **pot.spec_fields)
            if status != 0 or out != want:
                raise AssertionError(f"misfit warp geometry at {B} draws: C {out} (status "
                                     f"{status}), Python {want}")
    for pot in left:
        status, _ = geometry(pot, 64)
        if status != 801 or da.misfit_warp_takes(**pot.spec_fields):  # cudaErrorNotSupported
            raise AssertionError(f"warp misfit on {pot.n}x{pot.n} {pot.precond} {pot.solver}: "
                                 f"C status {status}")
    print(f"misfit warp geometry: Python mirror equals the C function for {MISFIT16} "
          f"(shipped: {da.misfit_warp_geometry(N_CHAINS)}); C and Python leave the same "
          f"{len(left)} other specs to the other kernels", flush=True)
    check_warm16_surr8(problems, richardson, left)

    g = torch.Generator().manual_seed(33)
    exact, cold32 = da_p.batched_potential_fn, misfit32_cold(p32)
    warm32, aux_dim = p32.batched_warm_potential
    for pot, prior, what in ((exact, da_p.prior, "16 draws a CTA, 3 spare warps"),
                             (cold32, p32.prior, "8 draws a cluster, 3 spare CTAs")):
        U = prior.sample(g, 16).T.contiguous()
        got, full = pot(U[:, :13].contiguous()), pot(U)
        torch.cuda.synchronize()
        equal = torch.equal(got, full[:13])
        print(f"{pot.kernel_label} ragged (13 draws, {what}): equal to the first 13 of 16 "
              f"{equal}", flush=True)
        if not equal:
            raise AssertionError(f"{pot.kernel_label} on a ragged width disagrees")
    U = p32.prior.sample(g, 16).T.contiguous()
    x0 = torch.zeros(aux_dim, 16, device="cuda")
    for start in ("x0 = 0", "x0 = previous solution"):
        (phi, x), (phi16, x16) = warm32(U[:, :13].contiguous(), x0[:, :13].contiguous()), warm32(U, x0)
        torch.cuda.synchronize()
        equal = torch.equal(phi, phi16[:13]) and torch.equal(x, x16[:, :13])
        print(f"{MISFIT32_WARM} ragged (13 draws, 8 a cluster, 3 spare CTAs, {start}): (Phi, x) "
              f"equal to the first 13 of 16 {equal}", flush=True)
        if not equal:
            raise AssertionError(f"{MISFIT32_WARM} on a ragged width disagrees")
        U = (0.9968 * U + 0.08 * p32.prior.sample(g, 16).T).contiguous()  # a pCN move
        x0 = x16
    check_slice_misfits(problems, surr8 + taken + left[1:2])
    check_warm_surr_misfits(problems, surr8 + left[:1] + taken)


def check_warm16_surr8(problems, richardson, left):
    """What the two misfits a draw a warp on the 16x16 samplers' levels add
    beside their twins: for darcy_misfit_warm_warp_kernel (darcy_pcn_warm's
    warm misfit) and darcy_misfit_warp_kernel on the 8x8 level (the
    surrogates of darcy_da_fused and the three Richardson runs), the Python
    mirrors of their rules and geometries against the C functions at 4096,
    4091, 13, 1 and 0 draws; for the specs each rule leaves (the warm: dense
    dst, Jacobi, 128 modes, the 32x32 level's, the cold misfits; the 8x8:
    ``left``), C's cudaErrorNotSupported against the mirror's refusal. Then
    ragged widths: the outputs on 4091 and 13 draws equal bit for bit to the
    first of the kernel's own 4096-draw run (warm: from x0 = 0 and from the
    previous solution)."""
    import ctypes

    from ip_mcmc_tpu_torch.convert import darcy_warm_misfit_from_arrays
    from ip_mcmc_tpu_torch.models import darcy
    from ip_mcmc_tpu_torch.ops import _build, fused_pcn
    from ip_mcmc_tpu_torch.ops import fused_da_pcn as da

    lib = _build.library()
    warm_p, da_p = problems["darcy_pcn_warm"], problems["darcy_da_fused"]
    warm, aux_dim = warm_p.batched_warm_potential
    surrs = (da_p.batched_surrogate_fn,
             *(p.batched_surrogate_fn for v, p in richardson.items() if v != "cg3"))
    aux = darcy.darcy_aux(n_grid=16, n_modes_per_dim=8, alpha=2.0, field_scale=10.0)
    warm_left = (*(darcy_warm_misfit_from_arrays(aux, warm_p.data, 0.002, cg_iters=it,
                                                 precond=pc, precond_modes=128)[0].cuda()
                   for pc, it in (("dst", 4), ("jacobi", 16), ("dst_trunc", 4))),
                 problems["darcy32_pcn_warm"].batched_warm_potential[0],
                 warm_p.batched_potential_fn, da_p.batched_potential_fn, *surrs)
    rules = ((MISFIT_WARM16, lib.ipx_darcy_misfit_warm_warp_geometry,
              fused_pcn.misfit_warm_warp_takes, fused_pcn.misfit_warm_warp_geometry,
              (warm,), warm_left),
             (f"{MISFIT8} / {MISFIT8_RICH}", lib.ipx_darcy_misfit_warp_geometry,
              da.misfit_warp_takes, da.misfit_warp_geometry, surrs, left))
    for name, c_geometry, takes, geometry, taken, leaves in rules:
        out = (ctypes.c_int * 3)()
        for pot in taken:
            for B in (N_CHAINS, N_CHAINS - 5, 13, 1, 0):
                status = c_geometry(ctypes.byref(pot.spec()), B, out)
                want = geometry(B, **pot.spec_fields)
                if status != 0 or tuple(out) != want or not takes(**pot.spec_fields):
                    raise AssertionError(f"{name} geometry at {B} draws: C {tuple(out)} "
                                         f"(status {status}), Python {want}")
        for pot in leaves:
            status = c_geometry(ctypes.byref(pot.spec()), 64, out)
            if status != 801 or takes(**pot.spec_fields):  # cudaErrorNotSupported
                raise AssertionError(f"{name} on {pot.n}x{pot.n} {pot.precond} ({pot.modes} "
                                     f"modes) {pot.solver}, K {pot.K}: C status {status}")
        print(f"{name} geometry: Python mirror equals the C function on {len(taken)} shipped "
              f"specs (at {N_CHAINS}: {geometry(N_CHAINS, **taken[0].spec_fields)}); C and "
              f"Python leave the same {len(leaves)} other specs to the other kernels",
              flush=True)

    g = torch.Generator().manual_seed(36)
    U = warm_p.prior.sample(g, N_CHAINS).T.contiguous()
    x0 = torch.zeros(aux_dim, N_CHAINS, device="cuda")
    for start in ("x0 = 0", "x0 = previous solution"):
        full = warm(U, x0)
        for B in (N_CHAINS - 5, 13):
            got = warm(U[:, :B].contiguous(), x0[:, :B].contiguous())
            torch.cuda.synchronize()
            equal = torch.equal(got[0], full[0][:B]) and torch.equal(got[1], full[1][:, :B])
            print(f"{MISFIT_WARM16} ragged ({B} draws, {start}): (Phi, x) equal to the first "
                  f"{B} of {N_CHAINS} {equal}", flush=True)
            if not equal:
                raise AssertionError(f"{MISFIT_WARM16} on a ragged width disagrees")
        U = (0.9968 * U + 0.08 * warm_p.prior.sample(g, N_CHAINS).T).contiguous()  # a pCN move
        x0 = full[1]
    for surr in surrs:
        full = surr(U)
        for B in (N_CHAINS - 5, 13):
            got = surr(U[:, :B].contiguous())
            torch.cuda.synchronize()
            equal = torch.equal(got, full[:B])
            print(f"{surr.kernel_label} ragged ({B} draws, {surr.solver} {surr.cg_iters}): "
                  f"equal to the first {B} of {N_CHAINS} {equal}", flush=True)
            if not equal:
                raise AssertionError(f"{surr.kernel_label} on a ragged width disagrees")


def check_warm_surr_misfits(problems, others):
    """For darcy_misfit_grad_warm_warp_kernel (warm MALA's value and
    gradient a draw a warp): the Python mirror of its rule and geometry
    against the C function at 4096, a ragged 13, 1 and 0 draws; for
    ``others`` and the 16x16 warm Jacobi and dst_trunc-128 pairs (specs the
    rule leaves), C's cudaErrorNotSupported against the mirror's refusal.
    Then a ragged width for it, from aux0 = 0 and from the previous aux, and
    for darcy_misfit_surr_cluster_kernel (darcy64_da_fused's 32x32
    surrogate, 8 draws a cluster): the outputs on 13 draws equal bit for bit
    to the first 13 of the kernel's own 16-draw run."""
    import ctypes

    from ip_mcmc_tpu_torch.convert import darcy_mala_warm_misfit_from_arrays
    from ip_mcmc_tpu_torch.models import darcy
    from ip_mcmc_tpu_torch.ops import _build, fused_mala

    lib = _build.library()
    p = problems["darcy_mala_warm"]
    pag, aux_dim = p.batched_warm_potential
    aux16 = darcy.darcy_aux(n_grid=16, n_modes_per_dim=8, alpha=2.0, field_scale=10.0)
    dst_trunc = darcy_mala_warm_misfit_from_arrays(aux16, p.data, 0.002, cg_iters=6,
                                                   precond="dst_trunc")[0].cuda()
    left = (*others, mala_warm_jacobi(p), dst_trunc, p.batched_potential_fn)

    def c_call(pot, B):
        out = (ctypes.c_int * 3)()
        return (lib.ipx_darcy_misfit_grad_warm_warp_geometry(ctypes.byref(pot.spec()), B, out),
                tuple(out))

    for B in (N_CHAINS, 13, 1, 0):
        status, out = c_call(pag, B)
        want = fused_mala.misfit_grad_warm_warp_geometry(B, **pag.spec_fields)
        if status != 0 or out != want:
            raise AssertionError(f"{GRAD_WARM_WARP} geometry at {B} draws: C {out} (status "
                                 f"{status}), Python {want}")
    for pot in left:
        status, _ = c_call(pot, 64)
        if status != 801 or fused_mala.misfit_grad_warm_warp_takes(**pot.spec_fields):
            raise AssertionError(f"{GRAD_WARM_WARP} on {pot.n}x{pot.n} {pot.precond} "
                                 f"({pot.modes} modes) {pot.solver}, K {pot.K}: C status {status}")
    print(f"{GRAD_WARM_WARP} geometry: Python mirror equals the C function (shipped: "
          f"{fused_mala.misfit_grad_warm_warp_geometry(N_CHAINS)}); C and Python leave the same "
          f"{len(left)} other specs to the other kernels", flush=True)

    g = torch.Generator().manual_seed(35)
    U = p.prior.sample(g, 16).T.contiguous()
    aux0 = torch.zeros(aux_dim, 16, device="cuda")
    for start in ("aux0 = 0", "aux0 = previous solutions"):
        got, full = pag(U[:, :13].contiguous(), aux0[:, :13].contiguous()), pag(U, aux0)
        torch.cuda.synchronize()
        equal = torch.equal(got[0], full[0][:13]) and all(
            torch.equal(a, b[:, :13]) for a, b in zip(got[1:], full[1:]))
        print(f"{GRAD_WARM_WARP} ragged (13 draws, one CTA, 3 spare warps, {start}): (Phi, "
              f"grad, aux) equal to the first 13 of 16 {equal}", flush=True)
        if not equal:
            raise AssertionError(f"{GRAD_WARM_WARP} on a ragged width disagrees")
        U = (U + 0.012 * p.prior.sample(g, 16).T).contiguous()  # a MALA-sized move
        aux0 = full[2]
    da64 = problems["darcy64_da_fused"]
    surr = da64.batched_surrogate_fn
    U = da64.prior.sample(g, 16).T.contiguous()
    got, full = surr(U[:, :13].contiguous()), surr(U)
    torch.cuda.synchronize()
    equal = torch.equal(got, full[:13])
    print(f"{MISFIT_SURR} ragged (13 draws, 8 a cluster, 3 spare CTAs): equal to the first 13 "
          f"of 16 {equal}", flush=True)
    if not equal:
        raise AssertionError(f"{MISFIT_SURR} on a ragged width disagrees")


def check_slice_misfits(problems, others):
    """For darcy_misfit_slice_kernel and darcy_misfit_grad_warp_kernel (the
    16x16 Jacobi misfit of ESS, cold pCN, FES and cold MALA, a draw a warp):
    the Python mirror of each rule and geometry against the C function at
    4096, a ragged 13, 1 and 0 draws; for ``others`` (specs the rules leave)
    and a 16x16 dst_trunc-160 and a K 36 Jacobi misfit, C's
    cudaErrorNotSupported against the mirrors' refusal; then a ragged
    width: Φ (and the gradient) on 13 draws equal bit for bit to the first
    13 of the kernel's own 16-draw run (one CTA, its other warps spare)."""
    import ctypes

    from ip_mcmc_tpu_torch.convert import darcy_misfit_from_arrays
    from ip_mcmc_tpu_torch.models import darcy
    from ip_mcmc_tpu_torch.ops import _build, fused_mala
    from ip_mcmc_tpu_torch.ops import fused_da_pcn as da

    lib = _build.library()
    p = problems["darcy_ess_fused"]
    jacobi = p.batched_potential_fn
    aux36 = darcy.darcy_aux(n_grid=16, n_modes_per_dim=6, alpha=2.0, field_scale=10.0)
    k36 = darcy_misfit_from_arrays(aux36, p.data, 0.002).cuda()
    left = (*others, misfit16_dst(problems["darcy_da_fused"], 160), k36)
    rules = ((MISFIT_SLICE, lib.ipx_darcy_misfit_slice_geometry, da.misfit_slice_takes,
              da.misfit_slice_geometry),
             (GRAD_WARP, lib.ipx_darcy_misfit_grad_warp_geometry,
              fused_mala.misfit_grad_warp_takes, fused_mala.misfit_grad_warp_geometry))
    for name, c_geometry, takes, geometry in rules:
        def c_call(pot, B):
            out = (ctypes.c_int * 3)()
            return c_geometry(ctypes.byref(pot.spec()), B, out), tuple(out)

        for B in (N_CHAINS, 13, 1, 0):
            status, out = c_call(jacobi, B)
            want = geometry(B, **jacobi.spec_fields)
            if status != 0 or out != want:
                raise AssertionError(f"{name} geometry at {B} draws: C {out} (status {status}), "
                                     f"Python {want}")
        for pot in left:
            status, _ = c_call(pot, 64)
            if status != 801 or takes(**pot.spec_fields):  # cudaErrorNotSupported
                raise AssertionError(f"{name} on {pot.n}x{pot.n} {pot.precond} ({pot.modes} "
                                     f"modes) {pot.solver}, K {pot.K}: C status {status}")
        print(f"{name} geometry: Python mirror equals the C function (shipped: "
              f"{geometry(N_CHAINS)}); C and Python leave the same {len(left)} other specs to "
              f"the other kernels", flush=True)

    U = p.prior.sample(torch.Generator().manual_seed(34), 16).T.contiguous()
    got, full = jacobi(U[:, :13].contiguous()), jacobi(U)
    (phi, grad), (phi16, grad16) = (jacobi.value_and_grad(U[:, :13].contiguous()),
                                    jacobi.value_and_grad(U))
    torch.cuda.synchronize()
    for name, equal in ((MISFIT_SLICE, torch.equal(got, full[:13])),
                        (GRAD_WARP, torch.equal(phi, phi16[:13])
                         and torch.equal(grad, grad16[:, :13]))):
        print(f"{name} ragged (13 draws, one CTA, its other warps spare): equal to the first "
              f"13 of 16 {equal}", flush=True)
        if not equal:
            raise AssertionError(f"{name} on a ragged width disagrees")


def check_geometry(what, cases, c_geometry, py_geometry):
    """A warp kernel's launch geometry: for each (n, block) of ``cases`` the
    C function (``c_geometry(n, block)`` -> (status, (warps, CTAs, bytes)))
    against the Python mirror (``py_geometry(n, block)`` -> (CTAs, warps,
    bytes))."""
    for n, block in cases:
        status, out = c_geometry(n, block)
        ctas, w, smem = py_geometry(n, block)
        if status != 0 or tuple(out) != (w, ctas, smem):
            raise AssertionError(f"{what} geometry at {n} chains, block {block}: C {tuple(out)} "
                                 f"(status {status}), Python {(w, ctas, smem)}")
    print(f"{what} geometry: Python mirror equals the C function (shipped: "
          f"{py_geometry(*cases[0])})", flush=True)


def check_ragged(name, what, got, full, ref, recorded):
    """A warp kernel's run on some chains, ``got``, against its own run on
    more, ``full``, cut to got's chains (bit for bit; one of the two runs has
    a ragged last CTA), and against the plain twin's, ``ref``, cut likewise
    (within CHAIN_ATOL); outputs as the entry points return them, recorded
    with samples third."""
    torch.cuda.synchronize()
    n = got[0].shape[0]
    cut = lambda t: t[:, :n] if t.dim() == 3 else t[:n]
    equal = all(torch.equal(g, cut(f)) for g, f in zip(got, full))
    frac = float(((got[0] - cut(ref[0])).abs().amax(dim=1) <= CHAIN_ATOL).double().mean())
    if recorded:
        rec = (got[2] - cut(ref[2])).abs().amax(dim=(0, 2))
        frac = min(frac, float((rec <= CHAIN_ATOL).double().mean()))
    rate = abs(float(got[1].mean()) - float(cut(ref[1]).mean()))
    print(f"{name} ragged ({what}): equal to the kernel's wider run {equal}; {frac:.4f} of "
          f"chains within {CHAIN_ATOL} of the plain twin, acceptance {float(got[1].mean()):.4f} "
          f"plain {float(cut(ref[1]).mean()):.4f}", flush=True)
    if not equal or frac < MIN_CHAIN_FRAC or rate > RATE_ATOL:
        raise AssertionError(f"{name} on a ragged width disagrees")


def c_geometry_of(fn, specs, extra, problem):
    """``fn`` (an ``ipx_*_warp_geometry`` C function) of ``specs`` and
    ``extra`` as a function of (n, block), for ``check_geometry``, on
    chains of the problem's dimension."""
    import ctypes

    from ip_mcmc_tpu_torch.ops import _scaffold

    pm, ps = problem.prior.mean, problem.prior.scale

    def call(n, block):
        pos = torch.zeros(n, problem.dim, device="cuda")
        args, _ = _scaffold.chain_args(pos, pm, ps, 0, 1, block)
        out = (ctypes.c_int * 3)()
        return fn(*(ctypes.byref(s) for s in specs), ctypes.byref(args), *extra, out), out
    return call


def check_ess_warp(problem):
    """What the ESS kernel's warps add beside its twin: the Python mirror of
    the launch geometry against the C function, and a ragged width, 13
    chains in blocks of 8 (two CTAs of 8 warps, 3 of them spare): equal bit
    for bit to the first 13 of the kernel's own 16-chain run, and within
    CHAIN_ATOL of the plain twin's 16-chain run, plain and recorded."""
    from ip_mcmc_tpu_torch.ops import _build, fused_ess

    pot, shrink = problem.batched_potential_fn, problem.kernel_params["max_shrink"]
    pm, ps = problem.prior.mean, problem.prior.scale
    check_geometry("ESS", ((problem.n_chains, problem.kernel_params["block_chains"]), (13, 8),
                           (13, 13), (20, 4), (1, 256)),
                   c_geometry_of(_build.library().ipx_ess_warp_geometry, [pot.spec()],
                                 [shrink], problem), fused_ess.warp_geometry)
    pos = problem.init_positions(torch.Generator().manual_seed(72), 16).cuda()
    for recorded in (False, True):
        thin = 1 if recorded else None
        got, full = (fused_ess._launch(pot, pos[:n], pm, ps, 73, 3, shrink, 8, thin=thin)
                     for n in (13, 16))
        ref = fused_ess._run_plain(plain_potential(pot), pos, pm, ps, 73, 3, shrink, 8,
                                   thin=thin)
        check_ragged(f"{ESS}<{'true' if recorded else 'false'}>",
                     "13 chains, 8 warps a CTA, 3 steps", got, full, ref, recorded)


def check_da3_warp(problem):
    """What the three-level Burgers DA kernel's warps add beside its twin:
    the Python mirror of the launch geometry against the C function, and a
    ragged width, 13 chains in blocks of 8 (two CTAs of 8 warps, 3 of them
    spare): equal bit for bit to the first 13 of the kernel's own 16-chain
    run, and within CHAIN_ATOL of the plain twin's 16-chain run, plain and
    recorded."""
    from ip_mcmc_tpu_torch.ops import _build
    from ip_mcmc_tpu_torch.ops import fused_da3_pcn as da3

    levels = (problem.batched_potential_fn, problem.batched_mid_fn,
              problem.batched_surrogate_fn)
    pm, ps = problem.prior.mean, problem.prior.scale
    kp = problem.kernel_params
    check_geometry("DA3", ((problem.n_chains, 512), (13, 8), (13, 13), (20, 4), (1, 512)),
                   c_geometry_of(_build.library().ipx_da3_warp_geometry,
                                 [lv.spec() for lv in levels], [kp["k_inner"], kp["k_mid"]],
                                 problem), da3.warp_geometry)
    pos = problem.init_positions(torch.Generator().manual_seed(74), 16).cuda()
    tail = (pm, ps, kp["beta"], 75, 3, 2, 3, 8)
    for recorded in (False, True):
        thin = 1 if recorded else None
        got, full = (da3._launch(*levels, pos[:n], *tail, thin=thin) for n in (13, 16))
        ref = da3._run_plain(*(plain_potential(lv) for lv in levels), pos, *tail, thin=thin)
        check_ragged(f"{DA3}<{'true' if recorded else 'false'}>",
                     "13 chains, 8 warps a CTA, 3 steps of k_inner 2, k_mid 3", got, full, ref,
                     recorded)


def check_fes_warp(problem):
    """What the ensemble sampler's warps add beside its twin: the Python
    mirror of the launch geometry against the C function, and a ragged count
    of ensembles, three of 8 chains (a launch runs the 12 chains of one
    parity in two CTAs of 8 warps, 4 of them spare): its first two ensembles
    equal bit for bit a run of those two alone, which lies within
    CHAIN_ATOL of the plain twin's run of three, plain and recorded."""
    from ip_mcmc_tpu_torch.ops import _build, fused_fes
    from ip_mcmc_tpu_torch.runner import _resolve_n_low_modes

    pot = problem.batched_potential_fn
    pm, ps = problem.prior.mean, problem.prior.scale
    kp = problem.kernel_params
    n_low = _resolve_n_low_modes(kp, problem)
    check_geometry("FES", ((problem.n_chains, kp["block_chains"]), (24, 8), (12, 6), (2, 2)),
                   c_geometry_of(_build.library().ipx_fes_warp_geometry, [pot.spec()], [n_low],
                                 problem), fused_fes.warp_geometry)
    pos = problem.init_positions(torch.Generator().manual_seed(76), 24).cuda()
    tail = (pm, ps, n_low, 77, kp["pcn_beta"], kp.get("stretch_a", 2.0), 3, 8)
    for recorded in (False, True):
        kw = {"thin": 1} if recorded else {}
        got, full = (fused_fes._launch(pot, pos[:n], *tail, **kw) for n in (16, 24))
        ref = fused_fes._run_plain(plain_potential(pot), pos, *tail, **kw)
        check_ragged(f"{FES}<{'true' if recorded else 'false'}>",
                     "the first 16 of 3 ensembles of 8, 8 warps a CTA, 3 steps", got, full, ref,
                     recorded)


def check_mala_warp(problem):
    """What the MALA kernel's warps add beside its twin, cold and warm: the
    Python mirror of the launch geometry against the C function, and a
    ragged width, 13 chains in blocks of 8 (two CTAs of 8 warps, 3 of them
    spare): equal bit for bit to the first 13 of the kernel's own 16-chain
    run, and within CHAIN_ATOL of the plain twin's 16-chain run, plain and
    recorded."""
    from ip_mcmc_tpu_torch.ops import _build, fused_mala

    pm, ps = problem.prior.mean, problem.prior.scale
    eps, block = problem.kernel_params["step_size"], problem.kernel_params["block_chains"]
    pos = problem.init_positions(torch.Generator().manual_seed(78), 16).cuda()
    jacobi = problem.batched_potential_fn
    pag, aux_dim = problem.batched_warm_potential
    for warm, pot, plain, kw in ((False, jacobi, plain_potential(jacobi), {}),
                                 (True, pag, plain_potential(pag, warm=True),
                                  {"aux_dim": aux_dim})):
        check_geometry(f"MALA ({'warm, dst' if warm else 'cold, jacobi'})",
                       ((problem.n_chains, block), (13, 8), (13, 13), (20, 4), (1, 256)),
                       c_geometry_of(_build.library().ipx_mala_warp_geometry, [pot.spec()],
                                     [int(warm)], problem),
                       lambda n, b, warm=warm: fused_mala.warp_geometry(n, b, warm=warm))
        for recorded in (False, True):
            kw_r = dict(kw, thin=1) if recorded else kw
            got, full = (fused_mala._launch(pot, pos[:n], pm, ps, eps, 79, 3, 8, **kw_r)
                         for n in (13, 16))
            ref = fused_mala._run_plain(plain, pos, pm, ps, eps, 79, 3, 8, **kw_r)
            check_ragged(f"{fused_mala.stem(warm)}<{'true' if recorded else 'false'}>",
                         "13 chains, 8 warps a CTA, 3 steps", got, full, ref, recorded)


def check_pcn_warp(problems):
    """What the pCN warp kernel's warps add beside its twin, cold and warm:
    the Python mirror of the launch geometry against the C function, and of
    which specs it takes (the C function refuses the others with
    cudaErrorNotSupported: they run on the one-chain-a-CTA kernels); and a
    ragged width, 13 chains in blocks of 8 (two CTAs of 8 warps, 3 of them
    spare): equal bit for bit to the first 13 of the kernel's own 16-chain
    run, and within CHAIN_ATOL of the plain twin's 16-chain run, plain and
    recorded."""
    from ip_mcmc_tpu_torch.ops import _build, fused_pcn

    cold_p, warm_p = problems["darcy_pcn_4096"], problems["darcy_pcn_warm"]
    pm, ps = warm_p.prior.mean, warm_p.prior.scale
    jacobi = cold_p.batched_potential_fn
    warm, aux_dim = warm_p.batched_warm_potential
    geometry = _build.library().ipx_pcn_warp_geometry
    for is_warm, pot, block in ((False, jacobi, 512), (True, warm, 256)):
        check_geometry(f"pCN ({'warm, dst_trunc' if is_warm else 'cold, jacobi'})",
                       ((N_CHAINS, block), (13, 8), (13, 13), (20, 4), (1, 256)),
                       c_geometry_of(geometry, [pot.spec()], [int(is_warm)], warm_p),
                       lambda n, b, w=is_warm: fused_pcn.warp_geometry(n, b, warm=w))
    # specs that go to another kernel: C refuses them, Python's mirror too
    others = ((False, problems["darcy_da_fused"].batched_potential_fn),
              (False, problems["darcy_da_fused"].batched_surrogate_fn),
              (True, problems["darcy_mala_warm"].batched_warm_potential[0]),
              (True, problems["darcy32_pcn_warm"].batched_warm_potential[0]))
    for is_warm, pot in others:
        status, _ = c_geometry_of(geometry, [pot.spec()], [int(is_warm)], warm_p)(64, 64)
        takes = fused_pcn.warp_takes(is_warm, n=pot.n, d=warm_p.dim, precond=pot.precond,
                                     modes=pot.modes, solver=pot.solver)
        if status != 801 or takes:  # cudaErrorNotSupported
            raise AssertionError(f"pCN warp kernel on {pot.n}x{pot.n} {pot.precond}: C status "
                                 f"{status}, Python takes {takes}")
    print(f"pCN warp kernel: C and Python leave the same {len(others)} other specs to the "
          "one-chain-a-CTA kernels", flush=True)
    pos = warm_p.init_positions(torch.Generator().manual_seed(80), 16).cuda()
    for is_warm, pot, plain, kw in ((False, jacobi, plain_potential(jacobi), {}),
                                    (True, warm, plain_potential(warm, warm=True),
                                     {"aux_dim": aux_dim})):
        for recorded in (False, True):
            kw_r = dict(kw, thin=1) if recorded else kw
            got, full = (fused_pcn._launch(pot, pos[:n], pm, ps, 0.08, 81, 3, 8, **kw_r)
                         for n in (13, 16))
            ref = fused_pcn._run_plain(plain, pos, pm, ps, 0.08, 81, 3, 8, **kw_r)
            check_ragged(f"{fused_pcn.stem(is_warm)}<{'true' if recorded else 'false'}>",
                         "13 chains, 8 warps a CTA, 3 steps", got, full, ref, recorded)


def attach_ptxas(results, ptxas, names):
    """Adds to each result row named in ``names`` (count name -> the
    kernel's instantiation as ptxas names it, mangled and demangled) the
    registers and spill bytes of that instantiation; raises if the build
    reported none for it (nothing without an nvcc.log)."""
    if not ptxas:
        return
    for r in results:
        if r["name"] not in names:
            continue
        needles = names[r["name"]]
        rows = [p for p in ptxas if any(k in p["kernel"] for k in needles)]
        if len(rows) != 1:
            raise AssertionError(f"ptxas: {len(rows)} rows for {r['name']} ({needles})")
        r.update(registers=rows[0]["registers"], spill_stores=rows[0]["spill_stores"],
                 spill_loads=rows[0]["spill_loads"])
        print(f"{r['name']}: {r['registers']} registers, {r['spill_stores']} / "
              f"{r['spill_loads']} bytes spill stores / loads", flush=True)


# the instantiations of fused_mala_warp_kernel<RECORD, PRECOND> (PRECOND:
# kPrecondJacobi 0, kPrecondDst 2), mangled and demangled
MALA_PTXAS = {
    f"{stem}<{rec}>": (f"fused_mala_warp_kernelILb{int(rec == 'true')}ELi{pc}E",
                       f"fused_mala_warp_kernel<{rec}, {pc}>")
    for stem, pc in ((MALA_COLD, 0), (MALA_WARM, 2)) for rec in ("false", "true")}
# ... and the cold and warm gradient misfits a draw a warp, and the warm one
# a draw a CTA (darcy_misfit_grad_kernel<true>)
MALA_PTXAS[GRAD_WARP] = ("darcy_misfit_grad_warp_kernel",)
MALA_PTXAS[GRAD_WARM_WARP] = ("darcy_misfit_grad_warm_warp_kernel",)
MALA_PTXAS["darcy_misfit_grad_warm_kernel"] = ("darcy_misfit_grad_kernelILb1E",
                                               "darcy_misfit_grad_kernel<true>")
# ... of fused_pcn_warp_kernel<RECORD, PRECOND> (kPrecondJacobi 0,
# kPrecondDstTrunc 1)
PCN_PTXAS = {
    f"{stem}<{rec}>": (f"fused_pcn_warp_kernelILb{int(rec == 'true')}ELi{pc}E",
                       f"fused_pcn_warp_kernel<{rec}, {pc}>")
    for stem, pc in ((PCN_COLD, 0), (PCN_WARM, 1)) for rec in ("false", "true")}
# ... of the Burgers DA and pCN kernels, a chain a warp and a chain a CTA
BURGERS_PTXAS = {
    **{f"{stem}<{rec}>": (f"{stem}ILb{int(rec == 'true')}E", f"{stem}<{rec}>")
       for stem in (DA_BURGERS, PCN_BURGERS) for rec in ("false", "true")},
    **{f"{name}_burgers_kernel<{rec}>": (
        f"{name}_kernelIN3ipx16BurgersPotentialELb{int(rec == 'true')}E",
        f"{name}_kernel<ipx::BurgersPotential, {rec}")
       for name in ("fused_da_pcn", "fused_pcn") for rec in ("false", "true")},
    # the standalone misfit: <C, T> = <4, 128> at 128 cells, <2, 64> at 64
    **{BURGERS_MISFIT + tag: (f"{BURGERS_MISFIT}ILi{c}ELi{32 * c}E",
                              f"{BURGERS_MISFIT}<{c}, {32 * c}>")
       for tag, c in ((FINE, 4), (MID, 4), (MULTI, 4), (COARSE, 2))},
    BURGERS_MISFIT_CTA + "[n=96,steps=116]": ("21burgers_misfit_kernel",
                                              "ipx::burgers_misfit_kernel(")}


def report_da64(problem, metrics):
    """darcy64_da_fused's CLI run beside the TPU's figures that do not
    depend on the hardware."""
    row = {"outer_accept": metrics["accept_rate"], "inner_accept": metrics["inner_accept_rate"],
           "ess_per_outer_step_chain": metrics["min_ess"] / (problem.n_chains
                                                             * metrics["n_samples"]),
           "max_rhat": metrics["max_rhat"], "run_s": metrics["run_s"],
           "outer_steps_per_s": metrics["outer_steps_per_s"], "ess_per_s": metrics["ess_per_s"],
           "tpu": TPU_DARCY64_DA}
    tpu = TPU_DARCY64_DA
    print(f"darcy64_da_fused: outer accept {row['outer_accept']:.4f} (TPU {tpu['outer_accept']}), "
          f"inner {row['inner_accept']:.4f} (TPU {tpu['inner_accept']}), ESS per outer step per "
          f"chain {row['ess_per_outer_step_chain']:.5f} (TPU {tpu['ess_per_outer_step_chain']}), "
          f"R-hat {row['max_rhat']:.4f} (TPU {tpu['max_rhat']}); "
          f"{row['outer_steps_per_s']:,.0f} outer steps/s, {row['ess_per_s']:,.0f} ESS/s",
          flush=True)
    return row


def run_richardson_da(richardson):
    """benchmarks/darcy_da_richardson.py on the port: each surrogate's DA run
    through the runner at 4096 chains (40 outer steps of burn-in, 200
    recorded), each as a ``drive_phase``; prints outer and inner acceptance
    and ESS per outer step per chain beside the TPU's figures. Returns (the
    counts of each run, a row per surrogate)."""
    from ip_mcmc_tpu_torch import runner

    counts, rows = {}, {}
    for variant, p in richardson.items():
        surr = p.batched_surrogate_fn
        da = DA16 if surr.solver == "cg" else f"{DA16}[surrogate={surr.solver}]"
        kernels = (p.batched_potential_fn.kernel_label, surr.kernel_label,
                   f"{da}<false>", f"{da}<true>")
        counts[p.name], m = drive_phase(p.name, kernels, lambda: runner.run_problem(p, "cuda"))
        # the one-draw-a-CTA 8x8 kernel, which the surrogate left for its
        # DA kernel's level a draw a warp
        retired = {k: v for k, v in counts[p.name].items()
                   if k.startswith("darcy_misfit_kernel[n=8") and v}
        if retired:
            raise AssertionError(f"{p.name} launched {retired}")
        assert m["n_chains"] == p.n_chains and math.isfinite(m["max_rhat"])
        assert all(math.isfinite(v) for v in m["posterior_mean"])
        assert 0.0 < m["accept_rate"] <= 1.0 and 0.0 < m["inner_accept_rate"] <= 1.0
        row = {"outer_accept": m["accept_rate"], "inner_accept": m["inner_accept_rate"],
               "ess_per_outer_step_chain": m["min_ess"] / (p.n_chains * m["n_samples"]),
               "outer_steps_per_s": m["outer_steps_per_s"], "ess_per_s": m["ess_per_s"],
               "max_rhat": m["max_rhat"], "run_s": m["run_s"],
               "tpu": TPU_RICHARDSON[variant]}
        rows[variant] = row
        tpu = row["tpu"]
        print(f"{p.name}: outer accept {row['outer_accept']:.4f} (TPU {tpu['outer_accept']}), "
              f"inner {row['inner_accept']:.4f} (TPU {tpu['inner_accept']}), ESS per outer "
              f"step per chain {row['ess_per_outer_step_chain']:.5f} (TPU "
              f"{tpu['ess_per_outer_step_chain']}); {row['outer_steps_per_s']:,.0f} outer "
              f"steps/s, {row['ess_per_s']:,.0f} ESS/s, R-hat {row['max_rhat']:.4f}",
              flush=True)
    return counts, rows


# the sources of the Darcy and Burgers kernels and of the linear-Gaussian
# group kernels (the one-chain-a-CTA linear-Gaussian instantiations are left
# out by name)
SAMPLER_UNITS = ("lv_rk4.cu", "fused_da_pcn.cu", "fused_pcn.cu", "fused_ess.cu", "fused_fes.cu",
                 "fused_mala.cu", "fused_rwm.cu", "fused_da3_pcn.cu", "fused_pcn_dense.cu",
                 "fused_pcn_adapt.cu")
# the units whose kernels on LinearGaussianPotential are the six fused
# samplers of check_linear_family_fused (their rows are printed too)
LINEAR_FUSED_UNITS = ("fused_pcn.cu", "fused_da_pcn.cu", "fused_ess.cu", "fused_fes.cu",
                      "fused_mala.cu", "fused_da3_pcn.cu")


def sampler_ptxas_report():
    """Registers and spill bytes of every Darcy and Burgers kernel and of
    the linear-Gaussian group kernels in this process's build
    (``_build.ptxas_report``), printed one kernel a line, so that a spill
    in a sampler (one cost the Darcy DA kernel 6 % once) shows in every
    run."""
    from ip_mcmc_tpu_torch.ops import _build

    rows = [r for r in _build.ptxas_report() if r["unit"] in SAMPLER_UNITS
            and ("_group_kernel" in r["kernel"] or r["unit"] in LINEAR_FUSED_UNITS
                 or "misfit_grad_kernel" in r["kernel"] or not any(
                     k in r["kernel"].lower() for k in ("lineargaussian", "linear_gaussian")))]
    if not rows:
        print("ptxas: no nvcc.log (the kernels were built by another process)", flush=True)
        return rows
    if shutil.which("c++filt"):
        names = subprocess.run(["c++filt"], input="\n".join(r["kernel"] for r in rows),
                               capture_output=True, text=True, timeout=60).stdout.splitlines()
        if len(names) == len(rows):
            for r, name in zip(rows, names):
                r["kernel"] = name
    for r in rows:
        print(f"ptxas ({r['unit']}): {r['kernel']}: {r['registers']} registers, "
              f"{r['spill_stores']} bytes spill stores, {r['spill_loads']} bytes spill loads",
              flush=True)
    spilled = [r["kernel"] for r in rows if r["spill_stores"] or r["spill_loads"]]
    print(f"ptxas: {len(rows)} Darcy, Burgers, linear-Gaussian group and LV kernels, "
          f"{len(spilled)} with spills", flush=True)
    return rows


# --- the linear-Gaussian family: RWM (K14), dense pCN (K15), adaptive pCN (K16)

# benchmarks/compare_paths.py: RWM on N([1, -0.5], diag(2, 0.5)) from zeros,
# step 0.9, 8192 chains x 2000 steps in blocks of 1024
CP_MEAN, CP_VAR = (1.0, -0.5), (2.0, 0.5)
CP_CHAINS, CP_STEPS, CP_BLOCK = 8192, 2000, 1024
# Linear-Gaussian Φ, kernel vs plain version: all f32, the row sums in
# another order (on the CPU against JAX: within 1e-6,
# tests/test_torch_linear.py). (median rel, rtol, least share, max rel):
LINEAR_TOL = (1e-6, 1e-5, 1.0, 1e-5)
# K16's β, kernel vs plain loop: the pooled sum in the same order and the
# update without FMA, so β differs only where Φ does
BETA_RTOL = 1e-5
LINGAUSS_BLOCK, LINGAUSS_BURN, LINGAUSS_SAMPLES = 256, 500, 1000


def compare_paths_potential():
    from ip_mcmc_tpu_torch.convert import linear_gaussian_from_arrays

    return linear_gaussian_from_arrays(np.eye(2), np.zeros(2), np.sqrt(CP_VAR),
                                       center=CP_MEAN).cuda()


def lingauss_potential():
    """lingauss_pcn's misfit as a LinearGaussianPotential, its prior scale
    √λ and its prior's Cholesky factor as a (d, d) matrix (diagonal: diag
    √λ)."""
    from ip_mcmc_tpu_torch import configs
    from ip_mcmc_tpu_torch.convert import linear_gaussian_from_arrays

    A, lam, y, sigma = configs.lingauss_arrays()
    scale = torch.tensor(lam, dtype=torch.float32, device="cuda").sqrt()
    return linear_gaussian_from_arrays(A, y, sigma).cuda(), scale, torch.diag(scale)


def dense_cholesky(lam, seed=7):
    """A lower-triangular L with every entry below the diagonal nonzero:
    the Cholesky factor of D (G Gᵀ / d + I / 2) D, D = diag √λ, G a seeded
    normal (d, d). Reading L where Lᵀ is meant changes ξ = L z."""
    d = len(lam)
    g = np.random.default_rng(seed).standard_normal((d, d))
    D = np.diag(np.sqrt(np.asarray(lam, dtype=np.float64)))
    L = np.linalg.cholesky(D @ (g @ g.T / d + 0.5 * np.eye(d)) @ D)
    assert np.all(np.tril(L, -1)[np.tril_indices(d, -1)] != 0.0)
    return torch.tensor(L, dtype=torch.float32, device="cuda")


def linear_misfit(m, d, seed):
    """A linear-Gaussian misfit of m seeded rows on d coordinates, σ 0.05
    (lingauss_pcn's shape, with other m and d)."""
    from ip_mcmc_tpu_torch.convert import linear_gaussian_from_arrays

    r = np.random.default_rng(seed)
    return linear_gaussian_from_arrays(r.standard_normal((m, d)) / np.sqrt(d),
                                       0.1 * r.standard_normal(m), 0.05).cuda()


def check_linear_family(problems, gen, results):
    """K14 on the compare_paths target and on gauss2d_rwm's with the prior
    (the group kernel, 16 chains a warp), on a d = 3 target the group rule
    leaves (one chain a CTA) and on Darcy (an instantiation no shipped path
    launches); the linear-Gaussian misfit kernel, K15 (the group kernel, a
    chain a warp; on an m = 40 misfit the rule leaves, one chain a CTA) and
    K16 on lingauss_pcn's misfit at 2048 chains (the group kernel, a block
    a cluster, also bit for bit against the host loop of two launches a
    step, which is timed too); each against its plain version, timed."""
    from ip_mcmc_tpu_torch import configs
    from ip_mcmc_tpu_torch.convert import linear_gaussian_from_arrays
    from ip_mcmc_tpu_torch.ops import fused_pcn_adapt, fused_pcn_dense, fused_rwm

    cp = compare_paths_potential()
    pos = torch.randn(CP_CHAINS, 2, generator=gen).cuda()
    per_step = linear_ops(cp) + Ops(RNG_OPS_PER_DRAW * 2)
    assert fused_rwm.stem(cp, 2) == RWM_GROUP, fused_rwm.stem(cp, 2)
    compare_chain(
        results, RWM_GROUP, False,
        lambda s: fused_rwm._launch(cp, pos, 0.9, 41, s, CP_BLOCK),
        lambda s: fused_rwm._run_plain(cp._forward_plain, pos, 0.9, 41, s, CP_BLOCK),
        steps=20, kernel_long=2020, plain_long=40,
        variant=f"compare_paths target (d = 2, A = I), no prior, block {CP_BLOCK}",
        paths=["compare_paths"], source="fused_rwm.cu", pots=(cp,),
        per_step_ops=per_step, replaces=JAX_OPS + "284")

    g2 = configs.gauss2d_batched_potential().cuda()
    p2 = problems["gauss2d_rwm"]
    pos2 = p2.init_positions(gen, p2.n_chains).cuda()
    prior = dict(prior_mean=p2.prior.mean, prior_scale=p2.prior.scale)
    step = p2.kernel_params["step_size"]
    # a 3-D target the group rule leaves: one chain a CTA (no path)
    g3 = linear_gaussian_from_arrays(np.eye(3), np.zeros(3), [1.4, 0.7, 1.0],
                                     center=[1.0, -0.5, 0.25]).cuda()
    pos3 = torch.randn(p2.n_chains, 3, generator=gen).cuda()
    prior3 = dict(prior_mean=torch.zeros(3), prior_scale=torch.full((3,), 10.0))
    for pot, d, ps, kernel, variant, paths in (
            (g2, 2, pos2, RWM_GROUP,
             "gauss2d_rwm target (A = L^T, P = L L^T) + prior N(0, 10^2), block 512",
             ["gauss2d_rwm --fused"]),
            (g3, 3, pos3, "fused_rwm_kernel",
             "a d = 3 Gaussian (A = I) + prior N(0, 10^2), block 512, which the group rule "
             "leaves to one chain a CTA (no shipped path)", [])):
        kw0 = prior if d == 2 else prior3
        assert fused_rwm.stem(pot, d) == kernel, (d, fused_rwm.stem(pot, d))
        for recorded in (False, True):
            kw = dict(kw0, **({"thin": 1} if recorded else {}))
            compare_chain(
                results, kernel, recorded,
                lambda s, pot=pot, ps=ps, kw=kw: fused_rwm._launch(pot, ps, step, 43, s, 512,
                                                                   **kw),
                lambda s, pot=pot, ps=ps, kw=kw: fused_rwm._run_plain(
                    pot._forward_plain, ps, step, 43, s, 512, **kw),
                steps=20, kernel_long=2020, plain_long=40, variant=variant, paths=paths,
                source="fused_rwm.cu", pots=(pot,),
                per_step_ops=linear_ops(pot) + Ops((RNG_OPS_PER_DRAW + 4) * d),
                replaces=JAX_OPS + "284")

    darcy_p = problems["darcy_pcn_4096"]
    jacobi = darcy_p.batched_potential_fn
    pos_d = darcy_p.init_positions(gen, N_CHAINS).cuda()
    dprior = dict(prior_mean=darcy_p.prior.mean, prior_scale=darcy_p.prior.scale)
    for recorded in (False, True):
        kw = dict(dprior, **({"thin": 1} if recorded else {}))
        compare_chain(
            results, "fused_rwm_darcy_kernel", recorded,
            lambda s: fused_rwm._launch(jacobi, pos_d, 0.01, 47, s, 256, **kw),
            lambda s: fused_rwm._run_plain(jacobi._forward_plain, pos_d, 0.01, 47, s, 256,
                                           **kw),
            steps=4, kernel_long=68, plain_long=12,
            variant="Darcy jacobi, 48 CG + whitened prior, block 256 (the runner's fused "
                    "RWM branch on a Darcy config; no shipped config)",
            paths=[], source="fused_rwm.cu", pots=(jacobi,),
            per_step_ops=solve_ops(jacobi, False) + Ops((RNG_OPS_PER_DRAW + 4) * 64),
            replaces=JAX_OPS + "284")

    pot, scale, chol = lingauss_potential()
    n, d = problems["lingauss_pcn"].n_chains, pot.K
    U = (torch.randn(d, n, generator=gen).cuda() * scale[:, None]).contiguous()
    # K14-K16 form Φ at the start in their own kernels; the six samplers of
    # LINEAR_FUSED but MALA get it from this one
    compare_small_misfit(results, pot, U, variant="lingauss_pcn misfit, m = 16, d = 32 (the "
                         "start positions of the fused samplers of LINEAR_FUSED but MALA)",
                         paths=[p for p, c in LINEAR_FUSED.items() if c[3] != LIN_MALA],
                         tol=LINEAR_TOL, source="fused_rwm.cu",
                         replaces=JAX_OPS + "99",
                         bound_row=bound(n * linear_ops(pot),
                                         4 * n * (pot.K + 1) + constant_bytes(pot)))
    pos_l = (torch.randn(n, d, generator=gen).cuda() * scale).contiguous()
    zeros = torch.zeros(d, device="cuda")
    # the main path's L is diag √λ, symmetric; a dense L also tests that the
    # kernel forms L z and not Lᵀ z. The bound counts L's nonzeros.
    dense = dense_cholesky(scale.double().cpu().numpy() ** 2)
    m40 = linear_misfit(40, d, seed=67)  # 40 rows: the group rule leaves it
    for p, L, kernel, variant, paths in (
            (pot, chol, PCN_DENSE_GROUP,
             "lingauss_pcn misfit, prior's L = diag sqrt(lambda) (32 x 32, diagonal)",
             ["lingauss_pcn fused"]),
            (pot, dense, PCN_DENSE_GROUP,
             "lingauss_pcn misfit, a dense lower-triangular 32 x 32 L (no shipped path)", []),
            (m40, chol, "fused_pcn_dense_kernel",
             "an m = 40, d = 32 misfit, which the group rule leaves to one chain a CTA, "
             "L = diag sqrt(lambda) (no shipped path)", [])):
        assert fused_pcn_dense.stem(p, d) == kernel, (p.m, fused_pcn_dense.stem(p, d))
        for recorded in (False, True):
            kw = {"thin": 1} if recorded else {}
            compare_chain(
                results, kernel, recorded,
                lambda s, p=p, L=L, kw=kw: fused_pcn_dense._launch(
                    p, pos_l, zeros, L, 0.2, 53, s, LINGAUSS_BLOCK, **kw),
                lambda s, p=p, L=L, kw=kw: fused_pcn_dense._run_plain(
                    p._forward_plain, pos_l, zeros, L, 0.2, 53, s, LINGAUSS_BLOCK, **kw),
                steps=20, kernel_long=2020, plain_long=40,
                variant=f"{variant}, block {LINGAUSS_BLOCK}",
                paths=paths, source="fused_pcn_dense.cu", pots=(p,),
                per_step_ops=linear_ops(p) + Ops((RNG_OPS_PER_DRAW + 4) * d
                                                 + 2 * int(torch.count_nonzero(L))),
                replaces=JAX_OPS + "653")

    # K16 on the shipped spec: the whole burn-in in one launch, a block a
    # cluster; against the plain loop, and bit for bit against the host loop
    # (two launches a step) that every spec the group rule leaves takes
    args = lambda s: (pos_l, zeros, scale, 0.5, 59, s, 0.3, 0.5, LINGAUSS_BLOCK)  # noqa: E731
    assert fused_pcn_adapt.stem(pot, d, LINGAUSS_BLOCK, n) == ADAPT_GROUP
    geo = fused_pcn_adapt.group_geometry(n, LINGAUSS_BLOCK, d=d, m=pot.m)
    k16_ops = linear_ops(pot) + Ops((RNG_OPS_PER_DRAW + 4) * d + 8)
    got = fused_pcn_adapt._launch_group(pot, *args(20))
    ref = fused_pcn_adapt._run_plain(pot._forward_plain, *args(20))
    two = fused_pcn_adapt._launch_steps(pot, *args(20))
    torch.cuda.synchronize()
    same = [bool(torch.equal(a, b)) for a, b in zip(got, two)]
    print(f"{ADAPT_GROUP} ({n} chains, 20 steps, block {LINGAUSS_BLOCK}) against the two "
          f"launches a step: chains, acceptance, beta bit for bit {same}", flush=True)
    if not all(same):
        raise AssertionError(f"{ADAPT_GROUP} differs from the two-launch burn-in")
    errs = {}  # name -> (max abs, share of chains within CHAIN_ATOL, beta max rel)
    for name, out in ((ADAPT_GROUP, got), ("fused_pcn_adapt_kernel", two)):
        dev = (out[0] - ref[0]).abs().max(dim=1).values
        frac = float((dev <= CHAIN_ATOL).double().mean())
        beta_rel = float(((out[2] - ref[2]).abs() / ref[2]).max())
        errs[name] = (float(dev.max()), frac, beta_rel)
        print(f"{name} ({n} chains, 20 steps, block {LINGAUSS_BLOCK}): {frac:.4f} of chains "
              f"within {CHAIN_ATOL} of the plain loop, beta max rel {beta_rel:.3e} (equal on "
              f"{float((out[2] == ref[2]).double().mean()):.4f}), acceptance kernel "
              f"{float(out[1].mean()):.4f} plain {float(ref[1].mean()):.4f}", flush=True)
        if (frac < MIN_CHAIN_FRAC or beta_rel > BETA_RTOL
                or abs(float(out[1].mean()) - float(ref[1].mean())) > RATE_ATOL):
            raise AssertionError(f"{name} disagrees with its plain version")
    del got, ref, two
    plain_ms = slope_ms(lambda s: fused_pcn_adapt._run_plain(pot._forward_plain, *args(s)),
                        20, 40, 1)
    ms = slope_ms(lambda s: fused_pcn_adapt._launch_group(pot, *args(s)), 20, 2020, 3)
    row = {
        "name": ADAPT_GROUP, "variant": f"lingauss_pcn misfit, diagonal prior, block "
        f"{LINGAUSS_BLOCK} (a block a cluster of {geo[2]} CTAs of {geo[1]} warps)",
        "route": "cuda",
        "source": SRC + "fused_pcn_adapt.cu", "replaces": JAX_OPS + "520",
        "paths": ["lingauss_pcn fused"], **dict(zip(
            ("max_abs_err", "frac_chains_within_atol", "beta_max_rel_err"), errs[ADAPT_GROUP])),
        "equal_to_two_launches": True, "ms": ms, "plain_ms": plain_ms,
        "ms_unit": ("one step: the slope between one-launch burn-ins of 20 and 2020 steps "
                    "(plain: 20 and 40)"),
        **chain_bound((pot,), n, d, k16_ops, False), "library_ms": None,
    }
    print(f"  one step at full width: {ms:.5f} ms, plain {plain_ms:.3f} ms, bound "
          f"{row['bound_ms']:.6f} ms ({row['bound_by']})", flush=True)
    results.append(row)

    # the host loop on the same spec: what a spec the group rule leaves runs
    # (m > d, d not 2 or 32, a block above 256); the slope over whole calls
    ms = slope_ms(lambda s: fused_pcn_adapt._launch_steps(pot, *args(s)), 20, 220, 3)
    row = {
        "name": "fused_pcn_adapt_kernel", "variant": f"a spec the rule leaves: the host loop, "
        f"timed on the lingauss_pcn misfit, diagonal prior, block {LINGAUSS_BLOCK}",
        "route": "cuda", "source": SRC + "fused_pcn_adapt.cu", "replaces": JAX_OPS + "520",
        "paths": [], **dict(zip(("max_abs_err", "frac_chains_within_atol", "beta_max_rel_err"),
                                errs["fused_pcn_adapt_kernel"])),
        "ms": ms, "plain_ms": plain_ms,
        "ms_unit": ("one step, both launches and the host loop: the slope between "
                    "launches of 20 and 220 steps (plain: 20 and 40)"),
        **chain_bound((pot,), n, d, k16_ops, False, launch_a_step=True),
        "library_ms": None,
    }
    print(f"  the host loop, one step at full width: {ms:.4f} ms, bound "
          f"{row['bound_ms']:.6f} ms ({row['bound_by']})", flush=True)
    results.append(row)

    # the update kernel alone, on this run's acceptance probabilities: from
    # the same p, log beta to the bit
    p = torch.rand(n, generator=gen).cuda()
    lb0 = torch.full((n // LINGAUSS_BLOCK,), fused_pcn_adapt.initial_log_beta(0.5),
                     device="cuda")
    gamma, target = fused_pcn_adapt.gain_at(0.5, 3), 0.3
    lb, beta = lb0.clone(), torch.empty(n, device="cuda")
    fused_pcn_adapt._update_kernel(p, lb, beta, LINGAUSS_BLOCK, gamma, target)
    lb_ref, beta_ref = fused_pcn_adapt._update_plain(p, lb0, LINGAUSS_BLOCK, gamma, target)
    torch.cuda.synchronize()
    b_rel = float(((beta - beta_ref).abs() / beta_ref).max())
    b_abs = float((beta - beta_ref).abs().max())
    print(f"pcn_adapt_update_kernel ({n // LINGAUSS_BLOCK} blocks of {LINGAUSS_BLOCK}): "
          f"log beta equal bits {bool(torch.equal(lb, lb_ref))}, beta max rel {b_rel:.3e}",
          flush=True)
    if not torch.equal(lb, lb_ref) or b_rel > 2.4e-7:
        raise AssertionError("pcn_adapt_update_kernel disagrees with its plain version")
    # in place, call after call: the values drift, the work does not
    ms = cuda_time_ms(lambda: fused_pcn_adapt._update_kernel(
        p, lb, beta, LINGAUSS_BLOCK, gamma, target), 200)
    plain_ms = cuda_time_ms(
        lambda: fused_pcn_adapt._update_plain(p, lb0, LINGAUSS_BLOCK, gamma, target), 20)
    nb = n // LINGAUSS_BLOCK
    row = {
        "name": "pcn_adapt_update_kernel", "variant": f"a spec the rule leaves: {nb} blocks "
        f"of {LINGAUSS_BLOCK}", "route": "cuda", "source": SRC + "fused_pcn_adapt.cu",
        "replaces": JAX_OPS + "552", "paths": [], "max_abs_err": b_abs,
        "ms": ms, "plain_ms": plain_ms, "ms_unit": "one call",
        **bound(Ops(n + 8 * nb), 4 * (2 * n + 2 * nb)), "library_ms": None,
    }
    print(f"  one call: {ms:.5f} ms, plain {plain_ms:.4f} ms, bound {row['bound_ms']:.6f} ms "
          f"({row['bound_by']})", flush=True)
    results.append(row)


def group_ptxas():
    """The instantiations of the group kernels on the shipped specs
    (fused_rwm_group_kernel<RECORD, 2, 2>, fused_pcn_dense_group_kernel<RECORD,
    32, 32>) and at d = 2 (the rows ``check_linear_d2`` names by their
    template arguments), mangled and demangled, for ``attach_ptxas``."""
    from ip_mcmc_tpu_torch.ops import _gaussian_group

    return {**{f"{stem}<{rec}>": (f"{stem}ILb{int(rec == 'true')}ELi{d}ELi{g}E",
                                  f"{stem}<{rec}, {d}, {g}>")
               for stem, d in ((RWM_GROUP, 2), (PCN_DENSE_GROUP, 32))
               for g in (_gaussian_group.width(d),)
               for rec in ("false", "true")},
            **{f"{PCN_DENSE_GROUP}<{rec}, 2, 2>": (
                f"{PCN_DENSE_GROUP}ILb{int(rec == 'true')}ELi2ELi2E",
                f"{PCN_DENSE_GROUP}<{rec}, 2, 2>") for rec in ("false", "true")},
            ADAPT_GROUP: (f"{ADAPT_GROUP}ILi32ELi32E", f"{ADAPT_GROUP}<32, 32>"),
            f"{ADAPT_GROUP}<2, 2>": (f"{ADAPT_GROUP}ILi2ELi2E", f"{ADAPT_GROUP}<2, 2>")}


# the d = 2 rows of K15 and K16: chains and block
D2_CHAINS, D2_BLOCK = 2048, 256


def check_linear_d2(gen, results):
    """K15's and K16's group kernels at d = 2 (no shipped path: every
    shipped K15 / K16 run is lingauss_pcn's d = 32), on the gauss2d target
    with L = I and a unit prior scale, 2048 chains in blocks of 256: each
    against its plain loop and timed, the rows named by the instantiation
    (<RECORD, 2, 2>, <2, 2>)."""
    from ip_mcmc_tpu_torch import configs
    from ip_mcmc_tpu_torch.ops import fused_pcn_adapt, fused_pcn_dense

    g2 = configs.gauss2d_batched_potential().cuda()
    pos = (3.0 * torch.randn(D2_CHAINS, 2, generator=gen)).cuda()
    zeros, ones, eye = (torch.zeros(2, device="cuda"), torch.ones(2, device="cuda"),
                        torch.eye(2, device="cuda"))
    assert fused_pcn_dense.stem(g2, 2) == PCN_DENSE_GROUP, fused_pcn_dense.stem(g2, 2)
    for recorded in (False, True):
        kw = {"thin": 1} if recorded else {}
        compare_chain(
            results, PCN_DENSE_GROUP, recorded,
            lambda s, kw=kw: fused_pcn_dense._launch(g2, pos, zeros, eye, 0.5, 88, s, D2_BLOCK,
                                                     **kw),
            lambda s, kw=kw: fused_pcn_dense._run_plain(g2._forward_plain, pos, zeros, eye, 0.5,
                                                        88, s, D2_BLOCK, **kw),
            steps=20, kernel_long=2020, plain_long=40,
            variant=f"gauss2d target, L = I, d = 2 (no shipped path), block {D2_BLOCK}",
            paths=[], source="fused_pcn_dense.cu", pots=(g2,),
            per_step_ops=linear_ops(g2) + Ops((RNG_OPS_PER_DRAW + 4) * 2 + 2 * 2),
            replaces=JAX_OPS + "653")
        results[-1]["name"] = f"{PCN_DENSE_GROUP}<{'true' if recorded else 'false'}, 2, 2>"

    name = f"{ADAPT_GROUP}<2, 2>"
    args = lambda s: (pos, zeros, ones, 0.4, 89, s, 0.234, 0.5, D2_BLOCK)  # noqa: E731
    assert fused_pcn_adapt.stem(g2, 2, D2_BLOCK, D2_CHAINS) == ADAPT_GROUP
    got = fused_pcn_adapt._launch_group(g2, *args(20))
    ref = fused_pcn_adapt._run_plain(g2._forward_plain, *args(20))
    torch.cuda.synchronize()
    dev = (got[0] - ref[0]).abs().max(dim=1).values
    frac = float((dev <= CHAIN_ATOL).double().mean())
    beta_rel = float(((got[2] - ref[2]).abs() / ref[2]).max())
    print(f"{name} ({D2_CHAINS} chains, 20 steps, block {D2_BLOCK}): {frac:.4f} of chains "
          f"within {CHAIN_ATOL} of the plain loop, beta max rel {beta_rel:.3e}, acceptance "
          f"kernel {float(got[1].mean()):.4f} plain {float(ref[1].mean()):.4f}", flush=True)
    if (frac < MIN_CHAIN_FRAC or beta_rel > BETA_RTOL
            or abs(float(got[1].mean()) - float(ref[1].mean())) > RATE_ATOL):
        raise AssertionError(f"{name} disagrees with its plain version")
    plain_ms = slope_ms(lambda s: fused_pcn_adapt._run_plain(g2._forward_plain, *args(s)),
                        20, 40, 1)
    ms = slope_ms(lambda s: fused_pcn_adapt._launch_group(g2, *args(s)), 20, 2020, 3)
    row = {
        "name": name, "variant": (f"gauss2d target, unit prior scale, d = 2 (no shipped "
                                  f"path), block {D2_BLOCK}"),
        "route": "cuda", "source": SRC + "fused_pcn_adapt.cu", "replaces": JAX_OPS + "520",
        "paths": [], "max_abs_err": float(dev.max()), "frac_chains_within_atol": frac,
        "beta_max_rel_err": beta_rel, "ms": ms, "plain_ms": plain_ms,
        "ms_unit": ("one step: the slope between one-launch burn-ins of 20 and 2020 steps "
                    "(plain: 20 and 40)"),
        **chain_bound((g2,), D2_CHAINS, 2, linear_ops(g2) + Ops((RNG_OPS_PER_DRAW + 4) * 2 + 8),
                      False), "library_ms": None,
    }
    print(f"  one step at full width: {ms:.5f} ms, plain {plain_ms:.3f} ms, bound "
          f"{row['bound_ms']:.6f} ms ({row['bound_by']})", flush=True)
    results.append(row)


def check_linear_group():
    """What the linear-Gaussian group kernels add beside their twins: the
    Python mirror of the launch geometry against the C function (the three
    shipped widths, ragged 13, 1 and 0 chains); the specs the takes-rule
    leaves to the one-chain-a-CTA kernels (C: cudaErrorNotSupported, the
    mirror: not taken); and a ragged width, 13 chains in blocks of 8 (d = 2:
    three spare groups in the one live warp; d = 32: one CTA of 8 warps,
    three spare), equal bit for bit to the first 13 of the kernel's own
    16-chain run and within CHAIN_ATOL of the plain twin's, plain and
    recorded, for RWM with the prior and for dense pCN at d = 2 (no shipped
    path) and d = 32."""
    import ctypes

    from ip_mcmc_tpu_torch import configs
    from ip_mcmc_tpu_torch.convert import linear_gaussian_from_arrays
    from ip_mcmc_tpu_torch.ops import _build, _gaussian_group, _scaffold
    from ip_mcmc_tpu_torch.ops import fused_pcn_dense, fused_rwm

    geometry = _build.library().ipx_gaussian_group_geometry

    def c_geometry(pot, n, block):
        pos = torch.zeros(n, pot.K, device="cuda")
        args, _ = _scaffold.chain_args(pos, torch.zeros(pot.K), torch.ones(pot.K), 0, 1, block)
        out, spec = (ctypes.c_int * 3)(), pot.spec()
        return geometry(ctypes.byref(spec), ctypes.byref(args), out), tuple(out)

    cp, g2 = compare_paths_potential(), configs.gauss2d_batched_potential().cuda()
    lg, scale, chol = lingauss_potential()
    for pot, n, block in ((cp, CP_CHAINS, CP_BLOCK), (g2, 1024, 512), (lg, 2048, LINGAUSS_BLOCK),
                          (cp, 13, 8), (lg, 13, 8), (g2, 1, 1), (lg, 0, LINGAUSS_BLOCK)):
        status, out = c_geometry(pot, n, block)
        mirror = _gaussian_group.geometry(n, block, d=pot.K, m=pot.m)
        if status != 0 or out != mirror:
            raise AssertionError(
                f"group geometry at d = {pot.K}, m = {pot.m}, {n} chains, block {block}: "
                f"C {out} (status {status}), Python {mirror}")
    print("linear-Gaussian group geometry: Python mirror equals the C function (shipped: "
          f"{_gaussian_group.geometry(CP_CHAINS, CP_BLOCK, d=2, m=2)}, "
          f"{_gaussian_group.geometry(2048, LINGAUSS_BLOCK, d=32, m=16)})", flush=True)
    others = (linear_gaussian_from_arrays(np.eye(3), np.zeros(3), 1.0).cuda(),
              linear_misfit(40, 32, seed=67), linear_misfit(16, 64, seed=68),
              linear_misfit(8, 16, seed=69), linear_misfit(5, 2, seed=70))
    for pot in others:
        status = c_geometry(pot, 64, 64)[0]
        takes = _gaussian_group.takes(pot.K, pot.m, pot.K)
        stems = (fused_rwm.stem(pot, pot.K), fused_pcn_dense.stem(pot, pot.K))
        if status != 801 or takes or stems != ("fused_rwm_kernel", "fused_pcn_dense_kernel"):
            raise AssertionError(f"group rule on d = {pot.K}, m = {pot.m}: C status {status}, "
                                 f"Python takes {takes}, kernels {stems}")
    print(f"linear-Gaussian group rule: C and Python leave the same {len(others)} other specs "
          "(d = 3; m = 40; d = 64; d = 16; d = 2, m = 5) to the one-chain-a-CTA kernels",
          flush=True)

    gen = torch.Generator().manual_seed(82)
    pos2 = (3.0 * torch.randn(16, 2, generator=gen)).cuda()
    pos32 = (torch.randn(16, 32, generator=gen).cuda() * scale).contiguous()
    prior = dict(prior_mean=torch.zeros(2), prior_scale=torch.full((2,), 10.0))
    zeros = torch.zeros(32, device="cuda")
    eye2 = torch.eye(2, device="cuda")
    for recorded in (False, True):
        kw = {"thin": 1} if recorded else {}
        tag = "true" if recorded else "false"
        got, full = (fused_rwm._launch(g2, pos2[:n], 1.0, 83, 5, 8, **prior, **kw)
                     for n in (13, 16))
        ref = fused_rwm._run_plain(g2._forward_plain, pos2, 1.0, 83, 5, 8, **prior, **kw)
        check_ragged(f"{RWM_GROUP}<{tag}>", "gauss2d + prior, 13 chains, 16 a warp, 5 steps",
                     got, full, ref, recorded)
        got, full = (fused_pcn_dense._launch(g2, pos2[:n], zeros[:2], eye2, 0.5, 85, 5, 8, **kw)
                     for n in (13, 16))
        ref = fused_pcn_dense._run_plain(g2._forward_plain, pos2, zeros[:2], eye2, 0.5, 85, 5,
                                         8, **kw)
        check_ragged(f"{PCN_DENSE_GROUP}<{tag}>",
                     "gauss2d target, L = I, d = 2 (no shipped path), 13 chains, 16 a warp, "
                     "5 steps", got, full, ref, recorded)
        got, full = (fused_pcn_dense._launch(lg, pos32[:n], zeros, chol, 0.2, 84, 5, 8, **kw)
                     for n in (13, 16))
        ref = fused_pcn_dense._run_plain(lg._forward_plain, pos32, zeros, chol, 0.2, 84, 5, 8,
                                         **kw)
        check_ragged(f"{PCN_DENSE_GROUP}<{tag}>",
                     "lingauss, 13 chains, a chain a warp, 8 a CTA, 5 steps", got, full, ref,
                     recorded)


def check_pcn_adapt_group():
    """What K16's group kernel adds beside its twins: the Python mirror of
    its launch geometry against the C function (the shipped spec, ragged
    blocks, d = 2, one chain and none); the specs the takes-rule leaves to
    the host loop (C: cudaErrorNotSupported, the mirror: not taken); and,
    bit for bit against the host loop's two launches a step, a ragged
    block (300 chains in blocks of 100: spare chains on the last CTA of
    each cluster) and d = 2 (gauss2d, 1024 in blocks of 256, a CTA a
    block), 30 steps each."""
    import ctypes

    from ip_mcmc_tpu_torch import configs
    from ip_mcmc_tpu_torch.ops import _build, _scaffold, fused_pcn_adapt

    geometry = _build.library().ipx_pcn_adapt_group_geometry

    def c_geometry(pot, n, block):
        pos = torch.zeros(n, pot.K, device="cuda")
        args, _ = _scaffold.chain_args(pos, torch.zeros(pot.K), torch.ones(pot.K), 0, 1, block)
        out, spec = (ctypes.c_int * 5)(), pot.spec()
        status = geometry(ctypes.byref(spec), ctypes.byref(args), out)
        if status == 0 and out[4] < 1:
            raise AssertionError(f"no cluster of {out[2]} CTAs fits the card")
        return status, tuple(out)[:4], out[4]

    lg, scale, _ = lingauss_potential()
    g2 = configs.gauss2d_batched_potential().cuda()
    for pot, n, block in ((lg, 2048, LINGAUSS_BLOCK), (lg, 300, 100), (lg, 14, 7),
                          (g2, 1024, 256), (g2, 1, 1), (lg, 0, LINGAUSS_BLOCK)):
        status, out, _ = c_geometry(pot, n, block)
        mirror = fused_pcn_adapt.group_geometry(n, block, d=pot.K, m=pot.m)
        if status != 0 or out != mirror:
            raise AssertionError(
                f"adaptive group geometry at d = {pot.K}, m = {pot.m}, {n} chains, block "
                f"{block}: C {out} (status {status}), Python {mirror}")
    print("adaptive pCN group geometry: Python mirror equals the C function (shipped: "
          f"{fused_pcn_adapt.group_geometry(2048, LINGAUSS_BLOCK, d=32, m=16)}; such clusters "
          f"the card holds at once: {c_geometry(lg, 2048, LINGAUSS_BLOCK)[2]})", flush=True)
    left = ((linear_misfit(40, 32, seed=67), 256, 256), (linear_misfit(3, 3, seed=71), 64, 64),
            (lg, 1024, 512), (g2, 1024, 512), (lg, 2000, LINGAUSS_BLOCK))
    for pot, n, block in left:
        status = c_geometry(pot, n, block)[0]
        takes = fused_pcn_adapt.group_takes(pot.K, pot.m, pot.K, block, n)
        if status != 801 or takes:
            raise AssertionError(f"adaptive group rule on d = {pot.K}, m = {pot.m}, {n} chains, "
                                 f"block {block}: C status {status}, Python takes {takes}")
    print(f"adaptive pCN group rule: C and Python leave the same {len(left)} burn-ins (m = 40; "
          "d = 3; blocks of 512 at d = 32 and d = 2; a ragged last block) to the host loop",
          flush=True)

    gen = torch.Generator().manual_seed(86)
    for what, pot, pos, sc, block in (
            ("lingauss, 300 chains in blocks of 100", lg,
             (torch.randn(300, 32, generator=gen).cuda() * scale).contiguous(), scale, 100),
            ("gauss2d target, d = 2 (no shipped path), 1024 chains in blocks of 256", g2,
             (3.0 * torch.randn(1024, 2, generator=gen)).cuda(), torch.ones(2, device="cuda"),
             256)):
        d = pos.shape[1]
        args = (pos, torch.zeros(d, device="cuda"), sc, 0.4, 87, 30, 0.234, 0.5, block)
        got = fused_pcn_adapt._launch_group(pot, *args)
        two = fused_pcn_adapt._launch_steps(pot, *args)
        same = [bool(torch.equal(a, b)) for a, b in zip(got, two)]
        print(f"{ADAPT_GROUP} ({what}, 30 steps) against the two launches a step: chains, "
              f"acceptance, beta bit for bit {same}", flush=True)
        if not all(same):
            raise AssertionError(f"{ADAPT_GROUP} ({what}) differs from the two-launch burn-in")


def ran_on_host(label):
    """A count of work that did not run on the card: a plain version, or a
    scan step on the CPU."""
    return "plain" in label or label.endswith("[cpu]")


def drive_phase(name, kernels, fn):
    """Counts to 0, ``fn()``, counts read: every kernel of ``kernels``
    launched, nothing run on the host. Returns (counts, what ``fn``
    returns)."""
    from ip_mcmc_tpu_torch.ops import _build

    _build.launch_counts.clear()
    out = fn()
    torch.cuda.synchronize()
    counts = dict(_build.launch_counts)
    print(f"{name} launch counts: " + json.dumps(counts), flush=True)
    for k in kernels:
        if counts.get(k, 0) < 1:
            raise AssertionError(f"{k} was not launched by {name}")
    plain = {k: v for k, v in counts.items() if ran_on_host(k) and v}
    if plain:
        raise AssertionError(f"plain versions ran on {name}: {plain}")
    return counts, out


def run_compare_paths():
    """benchmarks/compare_paths.py on the port: the fused RWM kernel, then
    the scan path, each at 8192 chains x 2000 steps (seed 0 first, then the
    timed seed-1 launch, as that script does); the chains' moments against
    the target's."""
    from ip_mcmc_tpu_torch import driver
    from ip_mcmc_tpu_torch.kernels import rwm
    from ip_mcmc_tpu_torch.ops import fused_rwm

    pot = compare_paths_potential()
    zeros = torch.zeros(CP_CHAINS, 2, device="cuda")
    fused = lambda seed: fused_rwm.fused_rwm_chain(  # noqa: E731
        pot, zeros, 0.9, seed, n_steps=CP_STEPS, block_chains=CP_BLOCK)
    fused(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, acc = fused(1)
    acc.cpu()
    fused_s = time.perf_counter() - t0

    mean = torch.tensor(CP_MEAN, device="cuda")
    var = torch.tensor(CP_VAR, device="cuda")
    logpi = lambda x: -0.5 * torch.sum((x - mean) ** 2 / var, dim=-1)  # noqa: E731
    kernel = rwm.build_kernel(logpi, step_size=0.9)

    def scan():
        state = driver.init_chains(rwm.init, zeros, logpi)
        g = torch.Generator("cuda").manual_seed(0)
        state, _, _ = driver.sample_chains(kernel, state, g, n_samples=1,
                                           burn_in=CP_STEPS - 1)
        return state.position

    scan()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scan_pos = scan().cpu()
    scan_s = time.perf_counter() - t0
    fused_rate, scan_rate = CP_CHAINS * CP_STEPS / fused_s, CP_CHAINS * CP_STEPS / scan_s
    print(f"compare_paths ({CP_CHAINS} chains x {CP_STEPS} steps): scan {scan_rate:,.0f} "
          f"steps/s ({scan_s:.3f} s), fused {fused_rate:,.0f} steps/s ({fused_s:.4f} s), "
          f"speedup {fused_rate / scan_rate:.2f}x (fused accept {float(acc.mean()):.3f})",
          flush=True)
    for x in (out.cpu(), scan_pos):
        m, v = x.mean(0), x.var(0)
        if (not bool(torch.isfinite(x).all())
                or float((m - mean.cpu()).abs().max()) > 0.1
                or float(((v - var.cpu()) / var.cpu()).abs().max()) > 0.1):
            raise AssertionError(f"compare_paths chains off the target: mean {m}, var {v}")
    return {"fused_steps_per_s": fused_rate, "scan_steps_per_s": scan_rate,
            "fused_s": fused_s, "scan_s": scan_s, "accept_rate": float(acc.mean())}


def run_gauss2d_fused(problem):
    """gauss2d_rwm with the JAX config's phi_batched set by the caller, run
    through the runner's fused RWM branch at the config's size."""
    import dataclasses

    from ip_mcmc_tpu_torch import configs, runner

    p = dataclasses.replace(
        problem, batched_potential_fn=configs.gauss2d_batched_potential().cuda(),
        kernel_params={**problem.kernel_params, "fused": True})
    m = runner.run_problem(p, "cuda")
    print("gauss2d_rwm --fused metrics: " + json.dumps(m), flush=True)
    assert m["kernel"] == "rwm(fused)" and m["n_chains"] == p.n_chains
    assert 0.0 < m["accept_rate"] < 1.0 and math.isfinite(m["max_rhat"])
    # the target is N(m, Σ) times the N(0, 10^2) prior: the mean moves ~1 %
    err = max(abs(a - b) for a, b in zip(m["posterior_mean"], p.truth))
    assert err < 0.1, f"gauss2d_rwm --fused posterior mean off by {err}"
    return m


def run_lingauss_fused(problem):
    """lingauss_pcn fused: K16 adapts β over the config's burn-in, then K15
    with the prior as a dense Cholesky and β frozen at the chains' mean:
    500 steps more, then 1000 recorded; the posterior mean against the
    conjugate one within Monte Carlo error."""
    from ip_mcmc_tpu_torch import configs, diagnostics, ops
    from ip_mcmc_tpu_torch.models import linear

    pot, scale, chol = lingauss_potential()
    n, d = problem.n_chains, problem.dim
    zeros = torch.zeros(d, device="cuda")
    pos = problem.init_positions(torch.Generator().manual_seed(61), n).cuda()
    t0 = time.perf_counter()
    pos, acc, beta = ops.fused_pcn_chain_adapt(
        pot, pos, zeros, scale, problem.kernel_params["beta"], 61,
        n_steps=problem.burn_in, target_accept=0.234, block_chains=LINGAUSS_BLOCK)
    b = float(beta.mean())
    burn_s = time.perf_counter() - t0
    pos, _ = ops.fused_pcn_chain_dense(pot, pos, zeros, chol, b, 62,
                                       n_steps=LINGAUSS_BURN, block_chains=LINGAUSS_BLOCK)
    t0 = time.perf_counter()
    _, acc_s, samples = ops.fused_pcn_chain_dense_recorded(
        pot, pos, zeros, chol, b, 63, n_steps=LINGAUSS_SAMPLES, thin=1,
        block_chains=LINGAUSS_BLOCK)
    acc_s.cpu()
    run_s = time.perf_counter() - t0
    summ = diagnostics.summarize(samples)
    A, lam, y, sigma = configs.lingauss_arrays()
    exact, cov = linear.conjugate_posterior(A, np.zeros(d), lam, sigma**2 * np.ones(len(y)), y)
    got = summ["mean"].cpu().numpy()
    se = np.sqrt(np.diag(cov) / summ["ess"].cpu().numpy())
    z = float(np.max(np.abs(got - exact) / se))
    out = {"beta": b, "burn_accept_rate": float(acc.mean()), "burn_s": burn_s,
           "accept_rate": float(acc_s.mean()), "run_s": run_s,
           "steps_per_s": n * LINGAUSS_SAMPLES / run_s,
           "min_ess": float(summ["min_ess"]), "max_rhat": float(summ["max_rhat"]),
           "mean_error_vs_exact": float(np.max(np.abs(got - exact))),
           "max_z_vs_exact": z}
    print("lingauss_pcn fused (K16 burn-in, K15 sampling): " + json.dumps(out), flush=True)
    if not (0.0 < b < 1.0 and 0.1 < out["accept_rate"] < 0.5 and z < 6.0):
        raise AssertionError(f"lingauss_pcn fused is off the conjugate posterior: {out}")
    return out


# --- the six fused samplers on the linear-Gaussian potential ------------------

# The fused samplers that take a LinearGaussianPotential one chain a CTA
# (csrc/gaussian_potential.cuh linear_cta_takes), and the kernels of their
# start positions: Phi (pCN, ESS, FES, DA, DA3) and Phi with its gradient
# (MALA), one draw a CTA
LIN_PCN, LIN_ESS, LIN_FES = ("fused_pcn_kernel[linear]", "fused_ess_kernel[linear]",
                             "fused_fes_kernel[linear]")
LIN_MALA, LIN_DA, LIN_DA3 = ("fused_mala_kernel[linear]", "fused_da_pcn_kernel[linear]",
                             "fused_da3_pcn_kernel[linear]")
LINEAR_MISFIT, LINEAR_GRAD = "linear_gaussian_misfit_kernel", "linear_gaussian_misfit_grad_kernel"
# MALA's step on lingauss_pcn's posterior (the prior's KL scale sqrt(lambda)
# folded in), chosen for an acceptance in 0.5-0.8: 0.73 at 2048 chains on
# the CPU's plain loop, the config's burn-in and samples
MALA_LINEAR_STEP = 0.02
# the delayed-acceptance levels: the same A with sigma scaled (surrogate,
# middle)
SURR_SIGMA, MID_SIGMA = 1.25, 1.1
# lingauss_pcn's problem (d = 32, m = 16, sigma 0.05, lingauss32.npz, 2048
# chains, the config's burn-in 500 and 1000 samples) through the runner's
# fused branch on each sampler: path -> (config, configs.build overrides
# besides the potentials, sigma factors of the other levels, kernel stem)
LINEAR_FUSED = {
    "lingauss_elliptical fused": (
        "lingauss_elliptical", {"kernel_params": {"fused": True, "max_shrink": 30}}, {},
        LIN_ESS),
    "lingauss_fes fused": (
        "lingauss_fes", {"kernel_params": {"fused": True, "n_low_modes": 6, "pcn_beta": 0.25,
                                           "stretch_a": 2.0}}, {}, LIN_FES),
    # the fused branch ignores kernel_params["adapt"], as JAX's: beta 0.2
    "lingauss_pcn fused pcn": (
        "lingauss_pcn", {"kernel_params": {"fused": True, "beta": 0.2, "adapt": True}}, {},
        LIN_PCN),
    "lingauss_pcn fused mala": (
        "lingauss_pcn", {"kernel": "mala",
                         "kernel_params": {"fused": True, "step_size": MALA_LINEAR_STEP}}, {},
        LIN_MALA),
    "lingauss_pcn fused da_pcn": (
        "lingauss_pcn", {"kernel": "da_pcn",
                         "kernel_params": {"fused": True, "beta": 0.2, "subchain_len": 4}},
        {"batched_surrogate_fn": SURR_SIGMA}, LIN_DA),
    "lingauss_pcn fused da3_pcn": (
        "lingauss_pcn", {"kernel": "da_pcn",
                         "kernel_params": {"fused": True, "beta": 0.2, "k_inner": 4,
                                           "k_mid": 2}},
        {"batched_mid_fn": MID_SIGMA, "batched_surrogate_fn": SURR_SIGMA}, LIN_DA3),
}
# the JAX step builder each kernel replaces (ip_mcmc_tpu/ops/fused_mcmc.py)
LINEAR_FUSED_REPLACES = {LIN_PCN: "303", LIN_ESS: "680", LIN_FES: "571", LIN_MALA: "784",
                         LIN_DA: "325", LIN_DA3: "391"}
# a path's posterior mean within this many Monte Carlo standard errors of
# the conjugate one in every coordinate (each coordinate's error from the
# run's ESS)
LINEAR_Z = 4.0
# The six kernels' instantiations as ptxas names them, mangled and demangled
_LIN = "NS_23LinearGaussianPotentialE"
LINEAR_FUSED_PTXAS = {
    **{f"{stem}<{r}>": (f"{len(k)}{k}I{_LIN}Lb{b}E", f"ipx::{k}<ipx::LinearGaussianPotential, {r}")
       for stem, k in ((LIN_PCN, "fused_pcn_kernel"), (LIN_ESS, "fused_ess_kernel"),
                       (LIN_FES, "fused_fes_kernel"), (LIN_MALA, "fused_mala_kernel"),
                       (LIN_DA, "fused_da_pcn_kernel"), (LIN_DA3, "fused_da3_pcn_kernel"))
       for b, r in ((0, "false"), (1, "true"))},
    LINEAR_GRAD: ("34linear_gaussian_misfit_grad_kernel", "linear_gaussian_misfit_grad_kernel("),
}


def linear_fused_kernels(path):
    """The kernels a path must launch: its start positions' and its
    sampler's, plain and recorded."""
    stem = LINEAR_FUSED[path][3]
    return (LINEAR_GRAD if stem == LIN_MALA else LINEAR_MISFIT, f"{stem}<false>",
            f"{stem}<true>")


def linear_fused_problem(path, device="cuda"):
    """The path's problem: ``configs.build`` with lingauss_pcn's misfit as a
    LinearGaussianPotential (``convert.linear_gaussian_from_arrays`` on
    ``configs.lingauss_arrays()``) and the path's overrides."""
    from ip_mcmc_tpu_torch import configs
    from ip_mcmc_tpu_torch.convert import linear_gaussian_from_arrays

    config, over, levels, _ = LINEAR_FUSED[path]
    A, _, y, sigma = configs.lingauss_arrays()
    level = lambda f: linear_gaussian_from_arrays(A, y, sigma * f).to(device)  # noqa: E731
    return configs.build(config, device, batched_potential_fn=level(1.0), **over,
                         **{k: level(f) for k, f in levels.items()})


def compare_linear_grad(results, pot, U, *, variant, paths):
    """``linear_gaussian_misfit_grad_kernel`` (Phi and its gradient, one
    draw a CTA) against the plain version on the same draws: Phi to
    LINEAR_TOL, each gradient coordinate within 1e-5 of sum_i |A_ik w_i|
    (its terms' magnitudes, w the weights r / sigma); timed as
    compare_small_misfit times a misfit; appends the result row."""
    from ip_mcmc_tpu_torch.ops import _build

    name = pot.grad_kernel_label
    kern, plain = (lambda: pot.value_and_grad(U)), (lambda: pot._value_and_grad_plain(U))
    before = _build.launch_counts[name]
    (phi, g), (phi_ref, g_ref) = kern(), plain()
    torch.cuda.synchronize()
    assert _build.launch_counts[name] == before + 1, f"{name} did not launch"
    B = U.shape[1]
    assert phi.shape == (B,) and g.shape == U.shape
    assert bool(torch.isfinite(phi).all() and torch.isfinite(g).all()), f"{name}: non-finite"
    rel = ((phi - phi_ref).abs() / phi_ref.abs()).cpu()
    line, bad, frac = within(rel, LINEAR_TOL, "Phi")
    w = (pot.data[:, None] - pot.A @ (U - pot.center[:, None])) / pot.noise[:, None] ** 2
    scale = pot.A.abs().T @ w.abs()
    g_err = float(((g - g_ref).abs() / scale.clamp_min(1e-30)).max())
    print(f"{name} ({variant}, {B} draws): {line}; gradient error relative to its terms "
          f"{g_err:.2e}", flush=True)
    if bad or g_err > 1e-5:
        raise AssertionError(f"{name} ({variant}) disagrees with its plain version")
    wide = U.repeat(1, 8)
    ms = cuda_time_ms(lambda: pot.value_and_grad(wide), 50) / 8
    call_ms, plain_ms = cuda_time_ms(kern, 200), cuda_time_ms(plain, 3)
    dev_ms = device_ms(kern, 50, name)
    d, m = pot.K, pot.m
    row = {
        "name": name, "variant": variant, "route": "cuda", "source": SRC + "fused_rwm.cu",
        "replaces": "none: the value and gradient that the step builder of "
                    + JAX_OPS + "784 takes at the start positions (jax.vjp, "
                    + JAX_OPS + "99)",
        "paths": paths, "max_abs_err": float((g - g_ref).abs().max()),
        "max_rel_err": float(rel.max()), "frac_within_rtol": frac,
        "ms": ms, "call_ms": call_ms, "device_ms": dev_ms, "plain_ms": plain_ms,
        "ms_unit": (f"{B} draws: ms per {B} of one call of {8 * B}, call_ms and plain_ms "
                    f"one call of {B}, device_ms the profiler's kernel time of one call "
                    f"of {B}"),
        **bound(B * (linear_ops(pot) + Ops(2 * d * m + m)),
                4 * B * (2 * d + 1) + constant_bytes(pot)),
        "library_ms": None,
    }
    dev = "not recorded" if dev_ms is None else f"{dev_ms:.5f}"
    print(f"  time per {B} draws: kernel {ms:.5f} ms (one call of {B} through the "
          f"wrapper {call_ms:.4f}, on the device {dev}), plain {plain_ms:.3f} ms, bound "
          f"{row['bound_ms']:.6f} ms ({row['bound_by']})", flush=True)
    results.append(row)


def check_linear_family_fused(problems, gen, results):
    """The six fused samplers on lingauss_pcn's misfit at its 2048 chains,
    each kernel (plain and recorded) against its plain loop from the same
    start and seed: at least 99 % of the chains within CHAIN_ATOL and every
    mean rate within 1e-4; a step timed as the slope between two launch
    lengths. The path's own settings (LINEAR_FUSED), blocks of 512 as the
    runner's fused branch; the start-position gradient kernel. (The C
    routes against their mirrors: the card tests, test_routes_agree_in_c_and_python.)"""
    from ip_mcmc_tpu_torch.ops import fused_da3_pcn as da3
    from ip_mcmc_tpu_torch.ops import fused_da_pcn as da
    from ip_mcmc_tpu_torch.ops import fused_ess, fused_fes, fused_mala, fused_pcn

    t0 = time.perf_counter()
    probs = {path: problems[path] for path in LINEAR_FUSED}
    pot = probs["lingauss_pcn fused pcn"].batched_potential_fn
    p0 = probs["lingauss_pcn fused pcn"]
    n, d = p0.n_chains, pot.K
    pm, ps = p0.prior.mean, p0.prior.scale
    pos = p0.init_positions(gen, n).cuda()
    block = min(512, n)
    draws = Ops((RNG_OPS_PER_DRAW + 4) * d)
    lin = linear_ops(pot)

    def compare(stem, recorded, kern, plain, *, steps, long, plain_long, variant, path, levels,
                ops, source):
        compare_chain(results, stem, recorded, kern, plain, steps=steps, kernel_long=long,
                      plain_long=plain_long, variant=f"{variant}, block {block}", paths=[path],
                      source=source, pots=levels, per_step_ops=ops,
                      replaces=JAX_OPS + LINEAR_FUSED_REPLACES[stem], rate_atol=1e-4)

    for recorded in (False, True):
        kw = {"thin": 1} if recorded else {}
        # cold pCN
        beta = probs["lingauss_pcn fused pcn"].kernel_params["beta"]
        compare(LIN_PCN, recorded,
                launched(f"{LIN_PCN}<{str(recorded).lower()}>", lambda s, kw=kw: fused_pcn._launch(
                    pot, pos, pm, ps, beta, 73, s, block, **kw)),
                lambda s, kw=kw: fused_pcn._run_plain(pot._forward_plain, pos, pm, ps, beta, 73,
                                                      s, block, **kw),
                steps=20, long=1020, plain_long=60, variant=f"beta {beta}",
                path="lingauss_pcn fused pcn", levels=(pot,), ops=lin + draws,
                source="fused_pcn.cu")
        # MALA: its step size, the prior folded in
        eps = probs["lingauss_pcn fused mala"].kernel_params["step_size"]
        compare(LIN_MALA, recorded,
                launched(f"{LIN_MALA}<{str(recorded).lower()}>", lambda s, kw=kw: fused_mala._launch(
                    pot, pos, pm, ps, eps, 79, s, block, **kw)),
                lambda s, kw=kw: fused_mala._run_plain(pot._forward_plain, pos, pm, ps, eps, 79,
                                                       s, block, **kw),
                steps=20, long=1020, plain_long=60, variant=f"step size {eps}, prior folded in",
                path="lingauss_pcn fused mala", levels=(pot,),
                ops=lin + Ops(2 * d * pot.m + pot.m + 12 * d) + draws, source="fused_mala.cu")

    # ESS: what this run's data needs, the evaluations of the timed steps
    shrink = probs["lingauss_elliptical fused"].kernel_params["max_shrink"]
    steps, long = 20, 320
    counting = CountingPotential(pot, shrink)
    fused_ess._run_plain(counting, pos, pm, ps, 83, long, shrink, block)
    evals = sum(counting.per_step[steps:]) / (long - steps)
    print(f"{LIN_ESS}: {evals:.3f} evaluations per step of a budget of {shrink} in steps "
          f"{steps + 1}-{long}", flush=True)
    for recorded in (False, True):
        kw = {"thin": 1} if recorded else {}
        compare(LIN_ESS, recorded,
                launched(f"{LIN_ESS}<{str(recorded).lower()}>", lambda s, kw=kw: fused_ess._launch(
                    pot, pos, pm, ps, 83, s, shrink, block, **kw)),
                lambda s, kw=kw: fused_ess._run_plain(pot._forward_plain, pos, pm, ps, 83, s,
                                                      shrink, block, **kw),
                steps=steps, long=long, plain_long=40, variant=f"max_shrink {shrink}",
                path="lingauss_elliptical fused", levels=(pot,),
                ops=evals * (lin + Ops(2 * d)) + draws, source="fused_ess.cu")
        results[-1]["evals_per_step"] = evals

    # FES: two launches a step (one a lane parity), two evaluations a chain
    kp = probs["lingauss_fes fused"].kernel_params
    fes_args = (pos, pm, ps, kp["n_low_modes"], 89, kp["pcn_beta"], kp["stretch_a"])
    for recorded in (False, True):
        kw = {"thin": 1} if recorded else {}
        compare(LIN_FES, recorded,
                launched(f"{LIN_FES}<{str(recorded).lower()}>",
                         lambda s, kw=kw: fused_fes._launch(pot, *fes_args, s, block, **kw),
                         per_step=2),
                lambda s, kw=kw: fused_fes._run_plain(pot._forward_plain, *fes_args, s, block,
                                                      **kw),
                steps=8, long=208, plain_long=24,
                variant=f"M = {kp['n_low_modes']}, a {kp['stretch_a']}, pCN beta "
                        f"{kp['pcn_beta']}; two launches a step",
                path="lingauss_fes fused", levels=(pot,), ops=2 * lin + draws,
                source="fused_fes.cu")

    # DA and three-level DA on the same A with sigma scaled
    pda, pda3 = probs["lingauss_pcn fused da_pcn"], probs["lingauss_pcn fused da3_pcn"]
    surr, mid = pda.batched_surrogate_fn, pda3.batched_mid_fn
    k = pda.kernel_params["subchain_len"]
    k1, k2 = pda3.kernel_params["k_inner"], pda3.kernel_params["k_mid"]
    beta_da, beta_da3 = pda.kernel_params["beta"], pda3.kernel_params["beta"]
    for recorded in (False, True):
        kw = {"thin": 1} if recorded else {}
        plain_da = da._run_plain_recorded if recorded else da._run_plain
        compare(LIN_DA, recorded,
                launched(f"{LIN_DA}<{str(recorded).lower()}>", lambda s, kw=kw: da._launch(
                    pot, surr, pos, pm, ps, beta_da, 97, s, k, block, **kw)),
                (lambda s: plain_da(pot._forward_plain, surr._forward_plain, pos, pm, ps,
                                    beta_da, 97, s, 1, k, block)) if recorded else
                (lambda s: plain_da(pot._forward_plain, surr._forward_plain, pos, pm, ps,
                                    beta_da, 97, s, k, block)),
                steps=10, long=410, plain_long=30,
                variant=f"k = {k}, surrogate sigma x {SURR_SIGMA}",
                path="lingauss_pcn fused da_pcn", levels=(pot, surr),
                ops=k * (lin + draws) + lin, source="fused_da_pcn.cu")
        compare(LIN_DA3, recorded,
                launched(f"{LIN_DA3}<{str(recorded).lower()}>", lambda s, kw=kw: da3._launch(
                    pot, mid, surr, pos, pm, ps, beta_da3, 101, s, k1, k2, block, **kw)),
                lambda s, kw=kw: da3._run_plain(pot._forward_plain, mid._forward_plain,
                                                surr._forward_plain, pos, pm, ps, beta_da3, 101,
                                                s, k1, k2, block, **kw),
                steps=10, long=410, plain_long=30,
                variant=f"k_inner {k1}, k_mid {k2}, middle sigma x {MID_SIGMA}, surrogate "
                        f"sigma x {SURR_SIGMA}",
                path="lingauss_pcn fused da3_pcn", levels=(pot, mid, surr),
                ops=k1 * k2 * (lin + draws) + k2 * lin + lin, source="fused_da3_pcn.cu")

    U = pos.T.contiguous()
    compare_linear_grad(results, pot, U, variant="lingauss_pcn misfit, m = 16, d = 32 (cold "
                        "MALA's start positions)", paths=["lingauss_pcn fused mala"])
    print(f"check_linear_family_fused: {time.perf_counter() - t0:.1f} s", flush=True)


def run_linear_fused(path, problem, n_samples):
    """One run of the path through ``runner.run_problem`` (the runner's
    fused branch: a launch for the burn-in, a recorded launch for the
    samples, twice); its posterior mean against the conjugate one, each
    coordinate within LINEAR_Z Monte Carlo standard errors (the closed-form
    posterior variance over the run's ESS of that coordinate, which the
    runner's summary computes and this keeps). Returns the metrics, with
    ``mean_error_vs_exact`` and ``max_z_vs_exact``."""
    from ip_mcmc_tpu_torch import configs, runner
    from ip_mcmc_tpu_torch.models import linear

    kept = {}
    summarize = runner._summarize_timed

    def keep(samples):
        summ, s = summarize(samples)
        kept.update(summ)
        return summ, s

    runner._summarize_timed = keep
    try:
        m = runner.run_problem(problem, problem.batched_potential_fn.A.device,
                               n_samples=n_samples)
    finally:
        runner._summarize_timed = summarize
    A, lam, y, sigma = configs.lingauss_arrays()
    exact, cov = linear.conjugate_posterior(A, np.zeros(problem.dim), lam,
                                            sigma**2 * np.ones(len(y)), y)
    got = np.asarray(m["posterior_mean"])
    z = np.abs(got - exact) / np.sqrt(np.diag(cov) / kept["ess"].cpu().numpy())
    m["mean_error_vs_exact"] = float(np.abs(got - exact).max())
    m["max_z_vs_exact"] = float(z.max())
    if not float(z.max()) <= LINEAR_Z:
        raise AssertionError(f"{path}: posterior mean {float(z.max()):.2f} Monte Carlo "
                             f"standard errors from the conjugate one (coordinate "
                             f"{int(z.argmax())}; limit {LINEAR_Z})")
    return m


def report_linear_fused(path_metrics):
    """The six linear-Gaussian fused paths beside the scan path of their
    config: run_s, the rates, min_ess, the error of the posterior mean
    against the conjugate one (and in Monte Carlo standard errors)."""
    keys = ("run_s", "warmup_s", "accept_rate", "inner_accept_rate", "mid_accept_rate",
            "stretch_accept_rate", "min_ess", "max_rhat", "mean_error_vs_exact",
            "max_z_vs_exact")
    out = {}
    for path, (config, *_rest) in LINEAR_FUSED.items():
        m, scan = path_metrics[path], path_metrics.get(config, {})
        out[path] = {**{k: m[k] for k in keys if k in m},
                     "scan_run_s": scan.get("run_s"),
                     "scan_mean_error_vs_exact": scan.get("mean_error_vs_exact")}
        print(f"{path}: " + json.dumps(out[path]), flush=True)
    return out

# --- the single-particle Darcy forward (the scan path, plain PyTorch) ---------

# Φ on the card against the same plain code on the CPU: f32 in other
# summation orders (cuBLAS and the CUDA reductions against the CPU's), which
# the CPU tests bound at 1e-5 relative against the JAX package
# (tests/test_torch_darcy_forward.py)
DARCY_FORWARD_RTOL = 1e-5


def check_darcy_forward(problems):
    """The scan path's potential of darcy_pcn_4096 (16x16, Jacobi / 48
    CG) and darcy64_pcn (64x64, dst / 24 CG) on 16 prior draws, half of
    them tripled (rougher fields), on the card against the same config's on
    the CPU: finite, of shape (16,), within DARCY_FORWARD_RTOL."""
    from ip_mcmc_tpu_torch import configs

    for path in ("darcy_pcn_4096 scan", "darcy64_pcn"):
        p, ref = problems[path], configs.build(config_of(path), "cpu")
        u = p.prior.sample(torch.Generator().manual_seed(71), 16).cpu()
        u[8:] *= 3.0
        got = p.potential_fn(u.cuda()).cpu()
        want = ref.potential_fn(u)
        rel = ((got - want).abs() / want.abs()).max()
        print(f"{path} potential (16 draws): card against CPU max rel {float(rel):.3e}",
              flush=True)
        if got.shape != (16,) or not bool(torch.isfinite(got).all()) or rel > DARCY_FORWARD_RTOL:
            raise AssertionError(f"{path}: the potential on the card disagrees with the CPU's")


# the Burgers and ODE forwards of the scan path on the card against the CPU.
# Burgers: the same f32 Godunov arithmetic, the KL sum in another order
# (tests/test_torch_burgers_forward.py: within 5e-7 of JAX's forward). The
# ODE: on the card Phi and its gradient come from lv_misfit_grad_kernel (the
# RK4 multiply-adds contracted into one rounding, the adjoint's own
# roundings: tests/test_torch_lv_kernel.py holds its algorithm within 1.2e-6
# of autograd's gradient on the CPU); over 200 steps the CPU tests see
# 1.4e-5 between two f32 orders on a forward value (tests/test_torch_ode.py),
# so Phi and the gradient (of each draw's largest entry) within 1e-4.
BURGERS_FORWARD_RTOL = 1e-5
ODE_RTOL = 1e-4
ODE_GRAD_REPS = 5
# lv_misfit_grad_kernel against its plain version on the card (autograd
# through the RK4 loop; and that loop in f64): Phi within LV_PHI_RTOL
# relative, the gradient within LV_GRAD_TOL of each chain's largest entry
LV_PHI_RTOL, LV_GRAD_TOL = 1e-4, 1e-3
LV = "lv_misfit_grad_kernel"
# the ODE paths by width: the kernel's rows of the kernels line
LV_WIDTHS = {256: ["ode_nuts"], 512: ["ode_hmc", "ode_chees"], 1024: ["ode_mala"]}
LV_STATES = "lv_misfit_grad_states_kernel"
# a spec the stages kernel leaves (its e^Y exceed a CTA's shared memory): the
# configs' span in LV_LEFT_STEPS steps, on the states kernel
LV_LEFT_STEPS = 4000
# f32 operations of one RK4 step for one chain that the value and gradient
# need, an exp counted as one and a multiply-add as two: the forward (4 stages
# of 2 exp and 2 multiply-adds, 3 stage inputs of 2 multiply-adds, the
# increment and the update) 50; its adjoint (per stage 10, the stage inputs'
# and the state's cotangents 24) 64. lv_misfit_grad_kernel computes just
# these, reading the stages' e^Y back from shared memory; the states kernel
# of the specs it leaves recomputes each step's forward in its backward: not
# counted
LV_STEP_OPS = 50 + 64
# per observed value: e^z, the whitened residual (a subtract and a divide),
# its square added (a multiply-add), and its derivative -w e^z / sigma added
# to the cotangent (a multiply, a divide, an add)
LV_OBS_OPS = 8


def lv_bound(spec, n):
    """The least time of one launch on n chains: its operations (the steps,
    the misfit and its injections, the rates and the gradient's chain rule)
    or its bytes (theta in, Phi and the gradient out, the spec once)."""
    obs = spec.obs_step.numel() * spec.species.numel()
    ops = n * (LV_STEP_OPS * spec.n_steps + LV_OBS_OPS * obs + 8)
    spec_bytes = sum(t.numel() * t.element_size()
                     for t in (spec.obs_step, spec.species, spec.data, spec.noise))
    return bound(Ops(f32=ops), n * 4 * (4 + 1 + 4) + spec_bytes)


def lv_launch_ms(theta, spec, states_kernel=False, launches=200):
    """A launch's time with the wrapper's host path left out: CUDA events
    around ``launches`` back-to-back launches through the C entry on
    buffers allocated once (a launch's host cost, a few µs, is below its
    device time, so the events time the card); lv_misfit_grad_kernel, or
    with ``states_kernel`` lv_misfit_grad_states_kernel and its scratch."""
    import ctypes

    from ip_mcmc_tpu_torch.ops import _build

    lib, n = _build.library(), theta.shape[0]
    entry = lib.ipx_lv_misfit_grad_states if states_kernel else lib.ipx_lv_misfit_grad
    states = torch.empty((spec.n_steps + 1) * 2 * n, device="cuda") if states_kernel else None
    phi, grad = torch.empty(n, device="cuda"), torch.empty(n, 4, device="cuda")
    args = (ctypes.byref(spec.c_struct), theta.data_ptr(), n,
            None if states is None else states.data_ptr(), phi.data_ptr(), grad.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _build.check(entry(*args), LV)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(launches):
        entry(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / launches


def lv_errors(phi, grad, refs):
    """Phi's largest relative error, the gradient's largest of each chain's
    largest entry and Phi's largest absolute error against each reference
    (name -> (Phi, gradient))."""
    return {k: (float(((phi.double() - v[0]).abs() / v[0].abs()).max()),
                float(((grad.double() - v[1]).abs().amax(1) / v[1].abs().amax(1)).max()),
                float((phi.double() - v[0]).abs().max())) for k, v in refs.items()}


def lv_within(phi, grad, errs):
    return (bool(torch.isfinite(phi).all()) and bool(torch.isfinite(grad).all())
            and all(v[0] <= LV_PHI_RTOL and v[1] <= LV_GRAD_TOL for v in errs.values()))


LV_REPLACES = ("none: ip_mcmc_tpu/models/ode.py:56 under jax.value_and_grad "
               "(lax.scan, no Pallas kernel)")


def check_lv_kernel(problems, results):
    """lv_misfit_grad_kernel (the stage exponentials in shared memory) at
    each ODE path's width (256, 512, 1024 prior draws, half doubled) against
    its plain version on the same inputs (autograd through the RK4 loop on
    the card) and against that loop in f64: Phi within LV_PHI_RTOL, the
    gradient within LV_GRAD_TOL of each chain's largest entry, the measured
    maxima printed; and against lv_misfit_grad_states_kernel, the kernel it
    replaced, bit for bit (the count of chains that differ printed; 0 is
    required). Its time (CUDA events through the wrapper; over back-to-back
    launches through its C entry; the profiler's device time) beside the
    states kernel's, the plain version's, its bound and the latency floor
    (lv_forward_floor_kernel: one thread, the forward's stage chain alone).
    Then the states kernel on a spec the stages kernel leaves
    (LV_LEFT_STEPS steps of the configs' span) through misfit_and_grad,
    against its plain version. Appends a kernels-line row a width, and one
    for the states kernel."""
    from ip_mcmc_tpu_torch import distributions as dist
    from ip_mcmc_tpu_torch import configs
    from ip_mcmc_tpu_torch.models import ode
    from ip_mcmc_tpu_torch.ops import _build, lv_rk4

    p = problems["ode_mala"]
    pot = p.potential_fn
    floor_theta = p.prior.sample(torch.Generator().manual_seed(74), 1)[0]
    floor_ms = device_ms(lambda: lv_rk4.forward_floor(floor_theta, pot.spec), 50,
                         lv_rk4.FLOOR_KERNEL)
    print(f"{LV} latency floor (one thread, {pot.spec.n_steps} steps x 4 stages forward, "
          f"nothing kept): {ms_text(floor_ms)} ms of device time", flush=True)
    for n, paths in LV_WIDTHS.items():
        th = p.prior.sample(torch.Generator().manual_seed(75 + n), n)
        th[n // 2:] *= 2.0
        before = dict(_build.launch_counts)
        phi, grad = lv_rk4.misfit_and_grad(th, pot.spec)
        torch.cuda.synchronize()
        assert _build.launch_counts[LV] == before.get(LV, 0) + 1, f"{LV} did not launch"
        assert _build.launch_counts[LV_STATES] == before.get(LV_STATES, 0), f"{LV_STATES} ran"
        errs = lv_errors(phi, grad, {"plain": pot.plain_value_and_grad(th),
                                     "plain f64": pot.plain_value_and_grad(th.double())})
        parent = lv_rk4.misfit_and_grad_states(th, pot.spec)
        differ = int(((phi != parent[0]) | (grad != parent[1]).any(dim=1)).sum())
        line = "; ".join(f"against the {k}: Phi max rel {v[0]:.3e}, gradient max {v[1]:.3e} of "
                         f"each chain's largest entry" for k, v in errs.items())
        print(f"{LV} ({n} chains): {line}; {differ} of {n} chains differ from {LV_STATES}",
              flush=True)
        if not lv_within(phi, grad, errs) or differ:
            raise AssertionError(f"{LV} ({n} chains) disagrees with its plain version or "
                                 f"with {LV_STATES}")
        kern = lambda th=th: lv_rk4.misfit_and_grad(th, pot.spec)  # noqa: E731
        states = lambda th=th: lv_rk4.misfit_and_grad_states(th, pot.spec)  # noqa: E731
        ms, plain_ms = cuda_time_ms(kern, 20), cuda_time_ms(lambda: pot.plain_value_and_grad(th), 3)
        row = {"name": LV, "variant": f"{n} chains, 200 RK4 steps, 40 observations",
               "route": "cuda", "source": SRC + "lv_rk4.cu", "replaces": LV_REPLACES,
               "paths": paths, "max_abs_err": errs["plain"][2],
               "reference": "plain version (autograd through the RK4 loop)",
               "max_rel_err": errs["plain"][0], "grad_max_err": errs["plain"][1],
               "f64_phi_max_rel": errs["plain f64"][0], "f64_grad_max": errs["plain f64"][1],
               "chains_differing_from_states_kernel": differ,
               "ms": ms, "back_to_back_ms": lv_launch_ms(th, pot.spec),
               "device_ms": device_ms(kern, 50, LV),
               "states_kernel_ms": cuda_time_ms(states, 20),
               "states_kernel_back_to_back_ms": lv_launch_ms(th, pot.spec, states_kernel=True),
               "states_kernel_device_ms": device_ms(states, 50, LV_STATES),
               "floor_device_ms": floor_ms, "plain_ms": plain_ms,
               "ms_unit": f"one call, {n} chains", **lv_bound(pot.spec, n), "library_ms": None}
        print(f"  time per call: kernel {ms:.4f} ms (back to back "
              f"{row['back_to_back_ms']:.4f}, device {ms_text(row['device_ms'])}), {LV_STATES} "
              f"{row['states_kernel_ms']:.4f} (back to back "
              f"{row['states_kernel_back_to_back_ms']:.4f}, device "
              f"{ms_text(row['states_kernel_device_ms'])}), plain {plain_ms:.2f} ms, bound "
              f"{row['bound_ms']:.6f} ms ({row['bound_by']}), latency floor "
              f"{ms_text(floor_ms)} ms", flush=True)
        results.append(row)

    # a spec the rule leaves: the configs' span in LV_LEFT_STEPS steps
    n = 1024
    data = torch.tensor(np.load(configs.LV_FIXTURE)["y"], device="cuda")
    left = ode.LotkaVolterraMisfit(
        configs.LV_Y0, configs.LV_DT * configs.LV_STEPS / LV_LEFT_STEPS, LV_LEFT_STEPS,
        [i * LV_LEFT_STEPS // configs.LV_STEPS for i in configs.LV_OBS], data,
        dist.DiagGaussian(mean=0 * data, scale=0.1 + 0 * data))
    if lv_rk4.stages_takes(left.spec):
        raise AssertionError(f"{LV_LEFT_STEPS} steps fit {LV}'s shared memory")
    th = p.prior.sample(torch.Generator().manual_seed(76), n)
    before = dict(_build.launch_counts)
    phi, grad = lv_rk4.misfit_and_grad(th, left.spec)
    torch.cuda.synchronize()
    if (_build.launch_counts[LV_STATES] != before.get(LV_STATES, 0) + 1
            or _build.launch_counts[LV] != before.get(LV, 0)):
        raise AssertionError(f"a spec of {LV_LEFT_STEPS} steps did not run on {LV_STATES}")
    t0 = time.perf_counter()
    ref = left.plain_value_and_grad(th)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3  # one call: ~4 s of launches
    errs = lv_errors(phi, grad, {"plain": ref})
    print(f"{LV_STATES} ({n} chains, {LV_LEFT_STEPS} steps, the rule leaves it): Phi max rel "
          f"{errs['plain'][0]:.3e}, gradient max {errs['plain'][1]:.3e}", flush=True)
    if not lv_within(phi, grad, errs):
        raise AssertionError(f"{LV_STATES} disagrees with its plain version")
    kern = lambda: lv_rk4.misfit_and_grad(th, left.spec)  # noqa: E731
    row = {"name": LV_STATES, "variant": f"{n} chains, {LV_LEFT_STEPS} RK4 steps, 40 "
                                         "observations (a spec the stages kernel leaves)",
           "route": "cuda", "source": SRC + "lv_rk4.cu", "replaces": LV_REPLACES, "paths": [],
           "max_abs_err": errs["plain"][2], "reference": "plain version",
           "max_rel_err": errs["plain"][0], "grad_max_err": errs["plain"][1],
           "ms": cuda_time_ms(kern, 5), "device_ms": device_ms(kern, 5, LV_STATES),
           "plain_ms": plain_ms,
           "ms_unit": f"one call, {n} chains", **lv_bound(left.spec, n), "library_ms": None}
    print(f"  time per call: {row['ms']:.4f} ms (device {ms_text(row['device_ms'])}), plain "
          f"{row['plain_ms']:.1f} ms, bound {row['bound_ms']:.6f} ms", flush=True)
    results.append(row)


def gradient_launches(vg, x):
    """Host ms (a synchronised loop after a warm-up), launches and device ms
    of one call of ``vg(x)``: the profiler's over ODE_GRAD_REPS calls, a
    call's share (a profile can lose its last few device records: over
    several calls they weigh less)."""
    from torch.profiler import ProfilerActivity, profile

    vg(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ODE_GRAD_REPS):
        vg(x)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / ODE_GRAD_REPS * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(ODE_GRAD_REPS):
            vg(x)
        torch.cuda.synchronize()
    launches, device_us = 0, 0.0
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            launches += ev.count
            device_us += (getattr(ev, "self_device_time_total", 0)
                          or getattr(ev, "self_cuda_time_total", 0))
    return {"ms": ms, "launches": launches / ODE_GRAD_REPS,
            "device_ms": device_us / 1e3 / ODE_GRAD_REPS}


def check_scan_forwards(problems, results):
    """The scan potentials of the Burgers paths (16 prior draws, half
    tripled) and of ode_mala (Phi and the gradient of log pi on 16 draws,
    half doubled; on the card through lv_misfit_grad_kernel) on the card
    against the same config's on the CPU; then lv_misfit_grad_kernel against
    its plain version at each ODE width (check_lv_kernel); then one gradient
    of log pi of ode_mala at 1024 chains through the kernel and through the
    plain version, each timed (host clock around synchronised calls, after
    a warm-up) and its device launches counted (profiler). Returns the
    timings."""
    from ip_mcmc_tpu_torch import configs
    from ip_mcmc_tpu_torch.kernels import base

    for path in ("burgers_pcn scan", "burgers_multitime_pcn scan"):
        p, ref = problems[path], configs.build(config_of(path), "cpu")
        u = p.prior.sample(torch.Generator().manual_seed(72), 16).cpu()
        u[8:] *= 3.0
        got = p.potential_fn(u.cuda()).cpu()
        want = ref.potential_fn(u)
        rel = float(((got - want).abs() / want.abs()).max())
        print(f"{path} potential (16 draws): card against CPU max rel {rel:.3e}", flush=True)
        if got.shape != (16,) or not bool(torch.isfinite(got).all()) or rel > BURGERS_FORWARD_RTOL:
            raise AssertionError(f"{path}: the potential on the card disagrees with the CPU's")

    p, ref = problems["ode_mala"], configs.build("ode_mala", "cpu")
    u = p.prior.sample(torch.Generator().manual_seed(73), 16).cpu()
    u[8:] *= 2.0
    got_v, got_g = base.value_and_grad(p.log_density_fn)(u.cuda())
    want_v, want_g = base.value_and_grad(ref.log_density_fn)(u)
    rel_v = float(((got_v.cpu() - want_v).abs() / want_v.abs()).max())
    rel_g = float(((got_g.cpu() - want_g).abs().amax(1) / want_g.abs().amax(1)).max())
    print(f"ode_mala log pi and its gradient (16 draws): card (the kernel) against CPU max rel "
          f"{rel_v:.3e}, {rel_g:.3e} of each draw's largest entry", flush=True)
    if not (bool(torch.isfinite(got_g).all()) and rel_v <= ODE_RTOL and rel_g <= ODE_RTOL):
        raise AssertionError("ode_mala: log pi or its gradient on the card disagrees "
                             "with the CPU's")

    check_lv_kernel(problems, results)
    x = p.init_positions(torch.Generator().manual_seed(74), p.n_chains).cuda()
    pot = p.potential_fn
    out = {"chains": p.n_chains, "rk4_steps": 200,
           "kernel": gradient_launches(base.value_and_grad(p.log_density_fn), x),
           "plain": gradient_launches(base.value_and_grad(
               lambda t: -pot.plain(t) - p.prior.potential(t)), x)}
    print("ode_mala gradient of log pi: " + json.dumps(out), flush=True)
    return out


# --- the CLI runs ---------------------------------------------------------------

# the multi-device paths (a world of one NCCL rank), each through the CLI
# with --devices 1: darcy_da_fused on the chain mesh, the composed configs
PARALLEL_DA = "darcy_da_fused --devices 1"
COMPOSED = ("darcy_composed_pcn", "darcy_composed_mala", "darcy_composed_ess")
# the composed configs' depth in this script: a step runs one (pCN), two
# (MALA) or one a shrink trip (ESS, ~14 trips at 512 chains) 150-iteration
# CG solves of ~14,000 small operations each, host-bound (~0.3 s a pCN step
# on an H100, PERF.md); the runner samples twice; the width, 512 chains,
# as shipped
COMPOSED_CUT = {"darcy_composed_pcn": {"burn_in": 10, "n_samples": 10},
                "darcy_composed_mala": {"burn_in": 5, "n_samples": 5},
                "darcy_composed_ess": {"burn_in": 0, "n_samples": 4}}
# the example script's run on the card
EXAMPLE_ARGS = ["--n-chains", "256", "--n-samples", "50", "--burn-in", "50"]

# config -> (CLI flags, kernels the run must launch)
PATHS = {
    "darcy_da_fused": ([], (MISFIT16, MISFIT8, f"{DA16}<false>", f"{DA16}<true>")),
    "darcy_pcn_warm": ([], (MISFIT_WARM16, f"{PCN_WARM}<false>", f"{PCN_WARM}<true>")),
    "darcy32_pcn_warm": ([], (MISFIT32_WARM, f"{PCN32}<false>", f"{PCN32}<true>")),
    "darcy64_pcn_warm": ([], (MISFIT64_WARM, f"{PCN64}<false>", f"{PCN64}<true>")),
    "darcy64_da_fused": ([], (MISFIT64, MISFIT_SURR, f"{DA64}<false>", f"{DA64}<true>")),
    "darcy_ess_fused": ([], (MISFIT_SLICE, f"{ESS}<false>", f"{ESS}<true>")),
    "darcy_pcn_4096": (["--fused"], (MISFIT_SLICE, f"{PCN_COLD}<false>", f"{PCN_COLD}<true>")),
    "darcy_mala_fused": ([], (GRAD_WARP, f"{MALA_COLD}<false>", f"{MALA_COLD}<true>")),
    "darcy_mala_warm": ([], (GRAD_WARM_WARP, f"{MALA_WARM}<false>", f"{MALA_WARM}<true>")),
    "darcy_fes_fused": ([], (MISFIT_SLICE, f"{FES}<false>", f"{FES}<true>")),
    "burgers_da3_pcn": ([], (*(BURGERS_MISFIT + tag for tag in (FINE, MID, COARSE)),
                             f"{DA3}<false>", f"{DA3}<true>")),
    "burgers_da_pcn": ([], (BURGERS_MISFIT + FINE, BURGERS_MISFIT + COARSE,
                            f"{DA_BURGERS}<false>", f"{DA_BURGERS}<true>")),
    "burgers_pcn": (["--fused"], (BURGERS_MISFIT + FINE, f"{PCN_BURGERS}<false>",
                                  f"{PCN_BURGERS}<true>")),
    "burgers_multitime_pcn": (["--fused"], (BURGERS_MISFIT + MULTI, f"{PCN_BURGERS}<false>",
                                            f"{PCN_BURGERS}<true>")),
    # the scan path: plain PyTorch on the card, no kernel of the port; the
    # scan steps count themselves by the device they ran on
    "gauss2d_rwm": ([], ("scan_rwm_step[cuda]",)),
    "lingauss_pcn": ([], ("scan_pcn_step[cuda]",)),
    # ... on the single-particle Darcy forward (the name "darcy_pcn_4096" is
    # its --fused run's)
    "darcy_pcn_4096 scan": ([], ("scan_pcn_step[cuda]",)),
    "darcy64_pcn": ([], ("scan_pcn_step[cuda]",)),
    # ... on the single-particle Burgers forward, and the other scan kernels
    "burgers_pcn scan": ([], ("scan_pcn_step[cuda]",)),
    "burgers_multitime_pcn scan": ([], ("scan_pcn_step[cuda]",)),
    "darcy_da_pcn": ([], ("scan_da_pcn_step[cuda]",)),
    "lingauss_elliptical": ([], ("scan_ess_step[cuda]",)),
    "lingauss_fes": ([], ("scan_fes_step[cuda]",)),
    # the six fused samplers on lingauss_pcn's misfit as a
    # LinearGaussianPotential, one chain a CTA, through runner.run_problem
    # (run_linear_fused); each against the conjugate posterior
    **{path: ([], linear_fused_kernels(path)) for path in LINEAR_FUSED},
    # the ODE gradient samplers: each gradient one launch of the
    # Lotka-Volterra kernel
    "ode_mala": ([], ("scan_mala_step[cuda]", LV)),
    "ode_hmc": ([], ("scan_hmc_step[cuda]", LV)),
    "ode_nuts": ([], ("scan_nuts_step[cuda]", LV)),
    "ode_chees": ([], ("scan_chees_step[cuda]", LV)),
    "multimodal_pt": ([], ("scan_pt_step[cuda]",)),
    "multimodal_pt_mala": ([], ("scan_pt_mala_step[cuda]",)),
    # tempered SMC (a count a stage), the warm one's mutation on the warm
    # misfit's kernel; ADVI (a count a step); the POD surrogates on scan DA
    "darcy_smc": ([], ("scan_smc_stage[cuda]",)),
    "darcy_smc_warm": ([], (MISFIT_WARM_DST, "scan_smc_stage[cuda]")),
    "lingauss_advi": ([], ("vi_step[cuda]",)),
    "darcy_advi": ([], ("vi_step[cuda]",)),
    "darcy_advi_warmstart": ([], ("vi_step[cuda]", "scan_pcn_step[cuda]")),
    "darcy_da_pod": ([], ("scan_da_pcn_step[cuda]",)),
    "darcy_da_pod_online": ([], ("scan_da_pcn_step[cuda]",)),
    # the multi-device layer: the DA kernels launched on the chain mesh's
    # shard; the composed samplers' steps (plain PyTorch and NCCL on the card)
    PARALLEL_DA: (["--devices", "1"], (MISFIT16, MISFIT8, f"{DA16}<false>", f"{DA16}<true>")),
    "darcy_composed_pcn": (["--devices", "1"], ("scan_composed_pcn_step[cuda]",)),
    "darcy_composed_mala": (["--devices", "1"], ("scan_composed_mala_step[cuda]",)),
    "darcy_composed_ess": (["--devices", "1"], ("scan_composed_ess_step[cuda]",)),
}
# the paths of run_parallel_phase, driven after the others
PARALLEL_PATHS = (PARALLEL_DA, *COMPOSED)
# a path's config where the two differ
PATH_CONFIG = {PARALLEL_DA: "darcy_da_fused",
               "darcy_pcn_4096 scan": "darcy_pcn_4096",
               "burgers_pcn scan": "burgers_pcn",
               "burgers_multitime_pcn scan": "burgers_multitime_pcn",
               **{path: cfg[0] for path, cfg in LINEAR_FUSED.items()}}
SCAN_PATHS = ("gauss2d_rwm", "lingauss_pcn", "darcy_pcn_4096 scan", "darcy64_pcn",
              "burgers_pcn scan", "burgers_multitime_pcn scan", "darcy_da_pcn",
              "lingauss_elliptical", "lingauss_fes", "ode_mala", "ode_hmc", "ode_nuts",
              "ode_chees", "multimodal_pt", "multimodal_pt_mala", "darcy_advi_warmstart",
              "darcy_da_pod", "darcy_da_pod_online")
# the SMC and VI paths: their own keys (no chains, samples or R-hat)
SMC_PATHS = ("darcy_smc", "darcy_smc_warm")
VI_PATHS = ("lingauss_advi", "darcy_advi")
# the scan paths of their own runner functions (the others: one dispatch)
OWN_RUNNER_PATHS = ("lingauss_fes", "multimodal_pt", "multimodal_pt_mala", "ode_chees")
ODE_PATHS = ("ode_mala", "ode_hmc", "ode_nuts", "ode_chees")
# the scan paths whose posterior mean has a closed form (the config's truth)
CLOSED_FORM = ("gauss2d_rwm", "lingauss_pcn")
CONJUGATE = ("lingauss_elliptical", "lingauss_fes")  # lingauss_pcn's posterior
# The samples of the scan paths whose steps take milliseconds (plain
# PyTorch, a thousand small launches a solve; a NUTS transition tens of
# leaves of ~1 ms of host time each): the warm-up or burn-in runs in full,
# twice, as the runner's protocol has it, unless SCAN_SHORT cuts it too;
# ode_hmc and ode_nuts cut their warm-up, darcy_pcn_4096's scan path its
# warm-up and darcy_da_pod its burn-in, through runner.run_problem; ode_mala,
# each gradient one kernel launch, runs as shipped. Every cut is printed.
SCAN_SAMPLES = {"darcy_pcn_4096 scan": 50, "darcy64_pcn": 100, "burgers_pcn scan": 100,
                "burgers_multitime_pcn scan": 100, "darcy_da_pcn": 25,
                "lingauss_elliptical": 200, "ode_hmc": 200, "ode_nuts": 30, "ode_chees": 100,
                "darcy_advi_warmstart": 50, "darcy_da_pod": 20,
                "darcy_da_pod_online": 20}
SCAN_SHORT = {"ode_hmc": {"burn_in": 100},
              "ode_nuts": {"burn_in": 30},
              "darcy_pcn_4096 scan": {"burn_in": 200},
              "darcy_da_pod": {"burn_in": 50}}
# ADVI steps of the Darcy VI paths (each a forward and an adjoint of the
# 48-CG solve at 32 samples, thousands of small launches), through
# runner.run_problem; lingauss_advi runs its 3000 as shipped
VI_STEPS = {"darcy_advi": 50, "darcy_advi_warmstart": 100}
# darcy_smc_warm's log evidence within this of darcy_smc's (the same
# posterior; ten seeds of each on the TPU: standard deviations 0.20 and
# 0.13, BASELINE.md)
SMC_EVIDENCE_ATOL = 1.0
SMC_WARM_SWEEPS = 8  # smc.run_batched's init_sweeps
# one-draw-a-CTA kernels that a path launched before its spec went to a
# kernel a draw a warp or a cluster level: the path must not launch them
RETIRED = {"darcy_ess_fused": ("darcy_misfit_kernel[n=16]",),
           "darcy_pcn_4096": ("darcy_misfit_kernel[n=16]",),
           "darcy_fes_fused": ("darcy_misfit_kernel[n=16]",),
           "darcy_mala_fused": ("darcy_misfit_grad_kernel[n=16]",),
           "darcy_mala_warm": ("darcy_misfit_grad_warm_kernel",),
           "darcy64_da_fused": ("darcy_misfit_kernel[n=32]",),
           "darcy_pcn_warm": (MISFIT_WARM_CTA,),
           "darcy_smc_warm": (MISFIT_WARM_CTA,),
           "darcy_da_fused": ("darcy_misfit_kernel[n=8]",),
           PARALLEL_DA: ("darcy_misfit_kernel[n=8]",),
           "burgers_da3_pcn": tuple(BURGERS_MISFIT_CTA + tag for tag in (FINE, MID, COARSE)),
           "burgers_da_pcn": (BURGERS_MISFIT_CTA + FINE, BURGERS_MISFIT_CTA + COARSE),
           "burgers_pcn": (BURGERS_MISFIT_CTA + FINE,),
           "burgers_multitime_pcn": (BURGERS_MISFIT_CTA + MULTI,)}
# ... and the one-chain-a-CTA kernels of the specs the Hopper designs leave
RETIRED = {path: RETIRED.get(path, ()) + tuple(f"{stem}<{r}>" for stem in RESTORED
                                               for r in ("false", "true"))
           for path in PATHS}


def config_of(path):
    return PATH_CONFIG.get(path, path)


def run_cli(config, flags, n_samples):
    """The port's CLI in-process; returns its metrics dict."""
    from ip_mcmc_tpu_torch import run

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = run.main(["--config", config, "--device", "cuda",
                       "--n-samples", str(n_samples), *flags])
    assert rc == 0, f"run.main returned {rc}"
    lines = [ln for ln in buf.getvalue().splitlines() if ln.strip()]
    assert len(lines) == 1, f"expected one JSON line, got {len(lines)}"
    return json.loads(lines[0])


def drive_path(config, problem, n_samples):
    """One CLI run (or, for the paths of SCAN_SHORT, one run of
    ``runner.run_problem`` on the config with those fields cut) as a
    ``drive_phase``; checks its metrics. Returns (the counts, the
    metrics)."""
    import dataclasses

    from ip_mcmc_tpu_torch import runner

    flags, kernels = PATHS[config]
    short = SCAN_SHORT.get(config)
    if short:
        kp = {**problem.kernel_params, **{k: v for k, v in short.items() if k != "burn_in"}}
        cut = dataclasses.replace(problem, burn_in=short["burn_in"], kernel_params=kp)
        run = lambda: runner.run_problem(cut, "cuda", seed=0, n_samples=n_samples)  # noqa: E731
    elif config in LINEAR_FUSED:
        run = lambda: run_linear_fused(config, problem, n_samples)  # noqa: E731
    elif config in VI_STEPS:
        kp = dict(problem.kernel_params)
        if "vi_init" in kp:
            kp["vi_init"] = {**kp["vi_init"], "num_steps": VI_STEPS[config]}
        else:
            kp["num_steps"] = VI_STEPS[config]
        cut = dataclasses.replace(problem, kernel_params=kp)
        run = lambda: runner.run_problem(cut, "cuda", seed=0, n_samples=n_samples)  # noqa: E731
    else:
        run = lambda: run_cli(config_of(config), flags, n_samples)  # noqa: E731
    counts, metrics = drive_phase(config, kernels, run)
    print(f"{config} metrics: " + json.dumps(metrics), flush=True)
    check_metrics(config, problem, n_samples, counts, metrics)
    return counts, metrics


def check_smc_vi_metrics(config, problem, metrics):
    """The checks of an SMC or VI run: the JAX runner's keys of that path;
    SMC reaches beta = 1 with a mutation acceptance in (0, 1] and a finite
    evidence; lingauss_advi's moments within 0.02 of the closed form."""
    assert all(math.isfinite(v) for v in metrics["posterior_mean"])
    assert len(metrics["posterior_mean"]) == problem.dim
    if config in SMC_PATHS:
        warm = config == "darcy_smc_warm"
        assert metrics["kernel"] == ("smc(batched+warm)" if warm else "smc")
        assert metrics["n_particles"] == problem.n_chains
        assert metrics["final_beta"] == 1.0, metrics["final_beta"]
        assert 0.0 < metrics["mean_mutation_accept"] <= 1.0
        assert 1 <= metrics["n_stages"] <= problem.kernel_params["max_stages"]
        assert math.isfinite(metrics["log_evidence"]) and math.isfinite(
            metrics["log_evidence_ti"])
        assert metrics["particles_per_s"] > 0.0
        return
    full_rank = problem.kernel_params["full_rank"]
    assert metrics["kernel"] == ("vi(full_rank)" if full_rank else "vi(mean_field)")
    assert metrics["num_steps"] == VI_STEPS.get(config, problem.kernel_params["num_steps"])
    assert math.isfinite(metrics["final_elbo"]) and metrics["elbo_steps_per_s"] > 0.0
    assert ("cov_error_vs_exact" in metrics) == full_rank
    if config == "lingauss_advi":
        assert metrics["mean_error_vs_exact"] < 0.02, metrics["mean_error_vs_exact"]
        assert metrics["cov_error_vs_exact"] < 0.02, metrics["cov_error_vs_exact"]


def check_metrics(config, problem, n_samples, counts, metrics):
    """The checks of a path's run: no retired kernel launched, the JAX
    runner's keys of that path, rates in (0, 1], finite statistics."""
    if config in SMC_PATHS + VI_PATHS:
        check_smc_vi_metrics(config, problem, metrics)
        return
    flags = PATHS[config][0]
    short = SCAN_SHORT.get(config)
    for k in RETIRED.get(config, ()):
        if counts.get(k, 0):
            raise AssertionError(f"{config} launched {k} {counts[k]} times")
    assert metrics["n_chains"] == problem.n_chains
    assert metrics["n_samples"] == n_samples
    assert math.isfinite(metrics["max_rhat"]), "max_rhat is not finite"
    kp = problem.kernel_params
    fused = bool(kp.get("fused")) or "--fused" in flags
    # elliptical slice sampling on the scan path accepts every step and
    # reports no rate (the fused kernel reports its shrink loop's)
    rates = [] if problem.kernel == "elliptical" and not fused else ["accept_rate"]
    assert ("accept_rate" in metrics) == bool(rates)
    if problem.kernel == "da_pcn":
        # three levels report the middle correction's rate, two the inner;
        # the scan path reports neither (as JAX's one-dispatch path)
        three = bool(kp.get("k_mid"))
        if fused:
            rates.append("mid_accept_rate" if three else "inner_accept_rate")
        assert ("mid_accept_rate" in metrics) == (fused and three)
        assert ("inner_accept_rate" in metrics) == (fused and not three)
        assert metrics["outer_steps_per_s"] > 0.0 and "steps_per_s" not in metrics
        inner = kp["k_inner"] * kp["k_mid"] if three else kp["subchain_len"]
        assert math.isclose(metrics["inner_steps_per_s"],
                            metrics["outer_steps_per_s"] * inner, rel_tol=1e-9)
    else:
        assert "inner_accept_rate" not in metrics and "mid_accept_rate" not in metrics
        assert metrics["steps_per_s"] > 0.0
    fes = problem.kernel == "fes"
    assert ("stretch_accept_rate" in metrics) == (fes and fused)
    assert ("pcn_accept_rate" in metrics) == (fes and not fused)
    if fes:
        rates.append("stretch_accept_rate" if fused else "pcn_accept_rate")
    if problem.kernel == "pt":
        rates.append("swap_rate_per_attempt")
        n_temps = kp["n_temps"]
        assert metrics["n_temps"] == n_temps == len(metrics["betas"])
        assert math.isclose(metrics["replica_steps_per_s"],
                            metrics["steps_per_s"] * n_temps, rel_tol=1e-9)
        assert len(metrics["swap_rate_per_pair"]) == n_temps - 1
        assert 0.3 <= metrics["mode_balance"] <= 0.7, (
            f"{config}: mode balance {metrics['mode_balance']}")
    for key in rates:
        assert 0.0 < metrics[key] <= 1.0, f"{key} = {metrics[key]}"
    assert all(math.isfinite(v) for v in metrics["posterior_mean"])
    assert len(metrics["posterior_mean"]) == problem.dim
    if config in SCAN_PATHS and config not in OWN_RUNNER_PATHS:  # the JAX one-dispatch keys
        assert metrics["program_count"] == 1 and metrics["sampling_steps_per_s"] > 0.0
        assert ("mean_error_vs_exact" in metrics) == (problem.exact_mean is not None)
    if short and problem.kernel != "chees":
        assert metrics.get("map_init_iters") == short.get("map_init", kp.get("map_init"))
        adapt = problem.kernel_params.get("adapt")
        assert metrics["warm_steps" if adapt else "burn_steps"] == short["burn_in"]
    if problem.kernel == "nuts":
        assert 1.0 <= metrics["mean_tree_depth"] <= kp["max_depth"], metrics["mean_tree_depth"]
    if problem.kernel == "chees":
        assert 0.0 < metrics["step_size"] <= metrics["trajectory_length"], metrics
    if config in ODE_PATHS:
        check_ode_launches(config, problem, counts, short)
    if config in CLOSED_FORM + CONJUGATE:
        err = max(abs(a - b) for a, b in zip(metrics["posterior_mean"], problem.truth))
        assert err < 0.1, f"{config}: posterior mean off the closed form by {err}"
    if config == "darcy_advi_warmstart":
        assert metrics["init_potential_vi"] < 0.2 * metrics["init_potential_prior"], (
            metrics["init_potential_vi"], metrics["init_potential_prior"])
        assert metrics["vi_fit_s"] > 0.0
    if config == "darcy_da_pod_online":
        spec = problem.kernel_params["pod_enrich"]
        assert len(metrics["pod_enrich_indicator_max"]) == spec["epochs"]
        assert all(math.isfinite(v) for v in metrics["pod_enrich_indicator_mean"])
        assert metrics["burn_steps"] == max(
            problem.burn_in - spec["epochs"] * spec["segment_steps"], 0)


def check_ode_launches(config, problem, counts, short):
    """Every gradient of an ODE path is one launch of the Lotka-Volterra
    kernel (drive_phase has seen no plain launch, so no RK4 ran by
    autograd): per pass of the runner, map_init Adam iterations and the
    start's gradient, then per MALA step one, per HMC step its leapfrog
    count, per NUTS transition at least one (a leaf), per ChEES step at
    least one (a leapfrog step; ChEES runs map_init and its warm-up once
    and its sampling twice)."""
    kp = problem.kernel_params
    map_init = (short or {}).get("map_init", kp.get("map_init", 0))
    steps = counts.get(f"scan_{problem.kernel}_step[cuda]", 0)
    got = counts.get(LV, 0)
    per_step = {"mala": 1, "hmc": kp.get("num_integration_steps", 8)}.get(problem.kernel)
    starts = map_init + 1 if problem.kernel == "chees" else 2 * (map_init + 1)
    want = starts + (per_step or 1) * steps
    ok = got == want if per_step else got >= want
    print(f"{config}: {got} launches of {LV} for {steps} steps "
          f"({'exactly' if per_step else 'at least'} {want})", flush=True)
    if not ok or steps < 1:
        raise AssertionError(f"{config}: {got} launches of {LV} for {steps} steps, "
                             f"{'not' if per_step else 'below'} {want}")


def check_smc_evidence(runs, counts, problem):
    """darcy_smc_warm against darcy_smc: log evidence within
    SMC_EVIDENCE_ATOL, and the warm misfit's kernel (a draw a warp)
    launched 8 + 5 a stage in each of the runner's two runs."""
    cold, warm = runs["darcy_smc"], runs["darcy_smc_warm"]
    gap = abs(warm["log_evidence"] - cold["log_evidence"])
    out = {"log_evidence": cold["log_evidence"], "log_evidence_warm": warm["log_evidence"],
           "gap": gap, "n_stages": cold["n_stages"], "n_stages_warm": warm["n_stages"]}
    print("darcy_smc against darcy_smc_warm: " + json.dumps(out), flush=True)
    if gap >= SMC_EVIDENCE_ATOL:
        raise AssertionError(f"darcy_smc_warm's log evidence is {gap} from darcy_smc's")
    steps = problem.kernel_params["mutation_steps"]
    want = 2 * (SMC_WARM_SWEEPS + steps * warm["n_stages"])
    got = counts["darcy_smc_warm"].get(MISFIT_WARM_DST, 0)
    if got != want:
        raise AssertionError(f"darcy_smc_warm launched {MISFIT_WARM_DST} {got} "
                             f"times, not 2 x ({SMC_WARM_SWEEPS} + {steps} x "
                             f"{warm['n_stages']})")
    return out


# the checkpoint phase: ode_mala's MALA kernel at its width, the config's
# step size, no adaptation; CKPT_CHUNKS chunks of CKPT_CHUNK samples
CKPT_CHUNK, CKPT_CHUNKS = 20, 3
# the CLI phase: ode_mala through the CLI with the three observability flags
CLI_FLAGS_SAMPLES = 50


def run_checkpoint_phase(problem):
    """checkpoint.CheckpointingDriver over ode_mala's MALA kernel (every
    gradient one launch of lv_misfit_grad_kernel) at 1024 chains, started
    near the config's truth (some moves accepted, required): the run
    of CKPT_CHUNKS chunks, then the same interrupted after chunk 1 and
    resumed from disk, which must give the uninterrupted run's samples bit
    for bit; then sample_chains_inscan with a checkpoint every CKPT_CHUNK
    samples, stopped after two of them and resumed from latest_inscan, the
    same. Files in a temporary directory, removed after."""
    import tempfile

    from ip_mcmc_tpu_torch import checkpoint, driver
    from ip_mcmc_tpu_torch.kernels import mala

    kp = problem.kernel_params
    kernel = mala.build_kernel(problem.log_density_fn, kp["step_size"])
    # near the truth, where some proposals of that unpreconditioned step are
    # accepted, so that the samples depend on every draw
    noise = torch.randn(problem.n_chains, 4, generator=torch.Generator().manual_seed(80))
    x0 = (torch.as_tensor(problem.truth, dtype=torch.float32) + 0.02 * noise).cuda()
    state = driver.init_chains(mala.init, x0, problem.log_density_fn)
    n = CKPT_CHUNK * CKPT_CHUNKS
    out = {"chains": problem.n_chains, "step_size": kp["step_size"], "samples": n}
    with tempfile.TemporaryDirectory() as tmp:
        ck = lambda d: checkpoint.CheckpointingDriver(  # noqa: E731
            f"{tmp}/{d}", kernel, 26, chunk_size=CKPT_CHUNK)
        _, full = ck("full").run(state, n)
        _, part = ck("int").run(state, 2 * CKPT_CHUNK)
        _, rest = ck("int").resume(state, n)
        _, s_full, info = checkpoint.sample_chains_inscan(
            kernel, state, 26, n_samples=n, every=CKPT_CHUNK, directory=f"{tmp}/inscan_full")
        _, s_a, _ = checkpoint.sample_chains_inscan(
            kernel, state, 26, n_samples=2 * CKPT_CHUNK, every=CKPT_CHUNK,
            directory=f"{tmp}/inscan")
        start, st = checkpoint.latest_inscan(f"{tmp}/inscan", state)
        _, s_b, _ = checkpoint.sample_chains_inscan(
            kernel, st, 26, n_samples=n - start, every=CKPT_CHUNK, directory=f"{tmp}/inscan",
            start_sample=start)
    out["chunked_resume_bit_for_bit"] = bool(torch.equal(full, torch.cat([part, rest])))
    out["inscan_resume_bit_for_bit"] = bool(torch.equal(s_full, torch.cat([s_a, s_b])))
    out["inscan_resumed_at"] = start
    out["accept_rate"] = float(info.accepted.mean())
    out["finite"] = bool(torch.isfinite(full).all()) and full.shape == (n, problem.n_chains, 4)
    print("checkpoint phase: " + json.dumps(out), flush=True)
    if not (out["chunked_resume_bit_for_bit"] and out["inscan_resume_bit_for_bit"]
            and start == 2 * CKPT_CHUNK and out["finite"] and out["accept_rate"] > 0):
        raise AssertionError(f"the resumed runs differ from the uninterrupted ones: {out}")
    return out


def run_cli_flags_phase():
    """python -m ip_mcmc_tpu_torch.run --config ode_mala --n-samples 50
    --metrics-log --tensorboard --profile-dir (in-process, into a temporary
    directory): the log's run_complete record holds every metric key the
    CLI printed, read_events reads its scalars back, and the Chrome trace of
    the timed run holds device events of lv_misfit_grad_kernel (fails, and
    says so, if torch.profiler records no device event here)."""
    import glob
    import os
    import tempfile

    from ip_mcmc_tpu_torch.utils import tensorboard as tb

    with tempfile.TemporaryDirectory() as tmp:
        log, logdir, prof = f"{tmp}/metrics.jsonl", f"{tmp}/tb", f"{tmp}/prof"
        metrics = run_cli("ode_mala", ["--metrics-log", log, "--tensorboard", logdir,
                                       "--profile-dir", prof], CLI_FLAGS_SAMPLES)
        records = [json.loads(ln) for ln in open(log)]
        done = [r for r in records if r["event"] == "run_complete"]
        missing = (set(metrics) - {"setup_s", "cli_total_s", "tensorboard_events"}
                   - set(done[0] if done else {}))
        events = tb.read_events(metrics["tensorboard_events"])
        scalars = [e for e in events if e[2]]
        traces = glob.glob(os.path.join(prof, "*.json"))
        trace_bytes = sum(os.path.getsize(t) for t in traces)
        kernel_events = [e for t in traces for e in json.load(open(t))["traceEvents"]
                         if e.get("cat") == "kernel"]
        lv = [e for e in kernel_events if LV in e.get("name", "")]
    out = {"records": len(records), "run_complete": len(done),
           "accept_trace_records": sum(r["event"] == "accept_trace" for r in records),
           "missing_keys": sorted(missing), "events": len(events),
           "scalar_events": len(scalars), "trace_files": len(traces),
           "trace_mb": trace_bytes / 2**20, "device_kernel_events": len(kernel_events),
           f"{LV}_events": len(lv),
           f"{LV}_device_ms": sum(e.get("dur", 0.0) for e in lv) / 1e3,
           "run_s": metrics["run_s"], "min_ess": metrics["min_ess"]}
    print("CLI flags phase (ode_mala): " + json.dumps(out), flush=True)
    if len(done) != 1 or missing or not scalars or not out["accept_trace_records"]:
        raise AssertionError(f"the metrics log or the TensorBoard events are wrong: {out}")
    if abs(scalars[0][2]["min_ess"] - metrics["min_ess"]) > 1e-6 * abs(metrics["min_ess"]):
        raise AssertionError("the TensorBoard events do not read back the run's min_ess")
    if not lv:
        raise AssertionError(f"the --profile-dir trace holds no device event of {LV} "
                             f"({len(kernel_events)} kernel events): torch.profiler "
                             "recorded no card activity here")
    return out


def check_composed_metrics(config, problem, cut, metrics):
    """A composed run's checks: the JAX runner's _run_composed keys, a
    (1, 1) mesh at the config's width, finite statistics; pCN and MALA
    accept something, ESS evaluates at least once a step."""
    kind = problem.kernel.split("_")[0]
    assert metrics["kernel"] == f"{kind}(composed chains x model)", metrics["kernel"]
    assert metrics["mesh_shape"] == [1, 1], metrics["mesh_shape"]
    assert metrics["n_chains"] == problem.n_chains and metrics["n_samples"] == cut["n_samples"]
    assert math.isfinite(metrics["max_rhat"]) and math.isfinite(metrics["min_ess"])
    assert all(math.isfinite(v) for v in metrics["posterior_mean"])
    assert len(metrics["posterior_mean"]) == problem.dim
    steps = cut["burn_in"] + cut["n_samples"] * problem.thin
    assert math.isclose(metrics["steps_per_s"], problem.n_chains * steps / metrics["run_s"],
                        rel_tol=1e-9)
    if kind == "ess":
        assert "accept_rate" not in metrics
        assert metrics["mean_evals_per_step"] >= 1.0, metrics["mean_evals_per_step"]
    else:
        assert "mean_evals_per_step" not in metrics
        assert 0.0 < metrics["accept_rate"] <= 1.0, metrics["accept_rate"]


def run_parallel_phase(problems, counts, n_samples):
    """The multi-device layer in a world of one NCCL rank (never gloo):
    darcy_da_fused at full width through the CLI with --devices 1 (the
    runner on the chain mesh), its recorded launch through
    sharded_fused_chain bit for bit the unsharded launch's and its
    statistics those of the unsharded run (rank 0's seed offset is 0);
    then the three composed configs through the CLI with --devices 1,
    their burn-in and samples cut (COMPOSED_CUT). Each CLI run is a
    drive_phase; the unsharded reference runs outside the counted windows.
    Returns the phase's record."""
    import dataclasses

    import torch.distributed as dist

    from ip_mcmc_tpu_torch import configs, ops, parallel, runner

    parallel.distributed_init(device="cuda")
    if dist.get_backend() != "nccl":
        raise AssertionError(f"the world's backend is {dist.get_backend()}, not nccl")
    mesh = parallel.make_chain_mesh(n_devices=1)
    out = {"backend": dist.get_backend(), "world": dist.get_world_size()}
    p = problems[PARALLEL_DA]
    kp = p.kernel_params
    pos = p.init_positions(torch.Generator().manual_seed(21), p.n_chains).cuda()
    kw = dict(prior_mean=p.prior.mean, prior_scale=p.prior.scale, beta=kp["beta"],
              subchain_len=kp["subchain_len"], block_chains=kp.get("block_chains", 512),
              n_steps=8, thin=2)
    direct = ops.fused_da_pcn_chain_recorded(p.batched_potential_fn, p.batched_surrogate_fn,
                                              pos, seed=5, **kw)
    sharded = parallel.sharded_fused_chain(
        lambda phi, x, **k: ops.fused_da_pcn_chain_recorded(phi, p.batched_surrogate_fn, x, **k),
        mesh, p.batched_potential_fn, pos, seed=5, **kw)
    if not all(torch.equal(a, b) for a, b in zip(direct, sharded)):
        raise AssertionError("the sharded recorded DA launch differs from the unsharded one")
    t0 = time.perf_counter()
    ref = runner.run_problem(p, "cuda", seed=0, n_samples=n_samples)
    ref_wall = time.perf_counter() - t0
    counts[PARALLEL_DA], metrics = drive_phase(
        PARALLEL_DA, PATHS[PARALLEL_DA][1],
        lambda: run_cli(config_of(PARALLEL_DA), PATHS[PARALLEL_DA][0], n_samples))
    print(f"{PARALLEL_DA} metrics: " + json.dumps(metrics), flush=True)
    check_metrics(PARALLEL_DA, p, n_samples, counts[PARALLEL_DA], metrics)
    if dist.get_world_size() != 1 or dist.get_backend() != "nccl":
        raise AssertionError(f"{PARALLEL_DA} left a world of {dist.get_world_size()} on "
                             f"{dist.get_backend()}")
    # the CLI's line went through JSON: the reference's values too
    ref = json.loads(json.dumps(ref))
    stats = ("min_ess", "max_rhat", "accept_rate", "inner_accept_rate", "posterior_mean")
    differ = [k for k in stats if metrics[k] != ref[k]]
    if differ:
        raise AssertionError(f"{PARALLEL_DA}: {differ} differ from the unsharded run's")
    out[PARALLEL_DA] = {"recorded_launch_bitwise": True, "statistics_equal": True,
                        "n_samples": n_samples, "run_s": metrics["run_s"],
                        "unsharded_run_s": ref["run_s"], "unsharded_wall_s": ref_wall,
                        "outer_steps_per_s": metrics["outer_steps_per_s"]}
    for name in COMPOSED:
        cut = COMPOSED_CUT[name]
        problem = problems[name]
        print(f"{name}: burn_in cut from {problem.burn_in} to {cut['burn_in']} and n_samples "
              f"from {problem.n_samples} to {cut['n_samples']} to fit the time limit (width "
              f"unchanged: {problem.n_chains} chains)", flush=True)
        shipped = configs.REGISTRY[name]
        configs.REGISTRY[name] = lambda device, f=shipped, b=cut["burn_in"]: (
            dataclasses.replace(f(device), burn_in=b))
        try:
            counts[name], m = drive_phase(
                name, PATHS[name][1], lambda: run_cli(name, PATHS[name][0], cut["n_samples"]))
        finally:
            configs.REGISTRY[name] = shipped
        if dist.get_backend() != "nccl":
            raise AssertionError(f"{name} ran on {dist.get_backend()}")
        print(f"{name} metrics: " + json.dumps(m), flush=True)
        check_composed_metrics(name, problem, cut, m)
        out[name] = {**cut, **{k: v for k, v in m.items() if k != "posterior_mean"}}
    parallel.shutdown()
    return out


def run_examples_phase():
    """The port's darcy_inversion example on the card, cut (EXAMPLE_ARGS):
    its scan pCN's steps on the card, a finite field error."""
    from ip_mcmc_tpu_torch.examples import darcy_inversion

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = darcy_inversion.main(EXAMPLE_ARGS)
    print("examples/darcy_inversion " + " ".join(EXAMPLE_ARGS) + ":\n" + buf.getvalue().strip(),
          flush=True)
    assert 0.0 < out["accept_rate"] <= 1.0 and math.isfinite(out["field_error"]), out
    return {"args": EXAMPLE_ARGS, **out}


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
          f"(nvcc {_build.build_seconds if _build.build_seconds is not None else 0.0:.1f} s, "
          f"{len(_build.sources()[1])} sources in parallel)", flush=True)
    ptxas = sampler_ptxas_report()

    problems = {name: (linear_fused_problem(name) if name in LINEAR_FUSED
                       else configs.build(config_of(name), "cuda")) for name in PATHS}
    gen = torch.Generator().manual_seed(1234)
    results = []
    check_da(problems["darcy_da_fused"], gen, results)
    richardson = {v: configs.darcy_da_richardson(v, "cuda")
                  for v in configs.RICHARDSON_VARIANTS}
    check_richardson(richardson, gen, results)
    check_warm_misfit(problems["darcy_pcn_warm"], gen, results)
    smc_warm_misfit = check_smc_warm_misfit(problems["darcy_smc_warm"], gen, results)
    check_single_level(problems, gen, results)
    check_large_grids(problems, gen, results)
    check_da64(problems["darcy64_da_fused"], gen, results)
    check_cluster(problems)
    check_misfit_levels(problems, richardson)
    check_ess_warp(problems["darcy_ess_fused"])
    check_da3_warp(problems["burgers_da3_pcn"])
    check_fes_warp(problems["darcy_fes_fused"])
    check_mala_warp(problems["darcy_mala_warm"])
    check_pcn_warp(problems)
    check_gradient_and_ensemble(problems, gen, results)
    check_restored(problems, gen, results)
    check_burgers(problems, gen, results)
    check_burgers_warp(problems, gen, results)
    check_burgers_misfit_warp(problems, gen, results)
    attach_ptxas(results, ptxas, {**MALA_PTXAS, **PCN_PTXAS, **BURGERS_PTXAS, **MISFIT_PTXAS,
                                  **RESTORED_PTXAS})
    check_linear_family(problems, gen, results)
    check_linear_family_fused(problems, gen, results)
    attach_ptxas(results, ptxas, LINEAR_FUSED_PTXAS)
    check_linear_d2(gen, results)
    check_linear_group()
    check_pcn_adapt_group()
    attach_ptxas(results, ptxas, group_ptxas())
    check_darcy_forward(problems)
    ode_gradient = check_scan_forwards(problems, results)
    attach_ptxas(results, ptxas, {LV: ("lv_misfit_grad_kernel",),
                                  LV_STATES: ("lv_misfit_grad_states_kernel",)})

    # the fused linear-Gaussian paths, each with the counts set to 0 before it
    counts = {}
    counts["compare_paths"], compare_paths = drive_phase(
        "compare_paths", (f"{RWM_GROUP}<false>", "scan_rwm_step[cuda]"), run_compare_paths)
    counts["gauss2d_rwm --fused"], _ = drive_phase(
        "gauss2d_rwm --fused", (f"{RWM_GROUP}<false>", f"{RWM_GROUP}<true>"),
        lambda: run_gauss2d_fused(problems["gauss2d_rwm"]))
    counts["lingauss_pcn fused"], _ = drive_phase(
        "lingauss_pcn fused",
        (ADAPT_GROUP, f"{PCN_DENSE_GROUP}<false>", f"{PCN_DENSE_GROUP}<true>"),
        lambda: run_lingauss_fused(problems["lingauss_pcn"]))
    richardson_counts, richardson_da = run_richardson_da(richardson)
    counts.update(richardson_counts)

    new_paths = {}  # the SMC, VI and POD paths' metrics, for the result line
    path_metrics = {}
    # the fourteen fused CLI paths, as shipped unless their predicted time
    # exceeds the budget: then every path's n_samples is cut by the same
    # factor; the scan paths as shipped but for SCAN_SAMPLES and SCAN_SHORT
    step_ms = {
        "darcy_da_fused": f"{DA16}<true>",
        "darcy_pcn_warm": f"{PCN_WARM}<true>",
        "darcy32_pcn_warm": f"{PCN32}<true>",
        "darcy64_pcn_warm": f"{PCN64}<true>",
        "darcy64_da_fused": f"{DA64}<true>",
        "darcy_ess_fused": f"{ESS}<true>",
        "darcy_pcn_4096": f"{PCN_COLD}<true>",
        "darcy_mala_fused": f"{MALA_COLD}<true>",
        "darcy_mala_warm": f"{MALA_WARM}<true>",
        "darcy_fes_fused": f"{FES}<true>",
        "burgers_da3_pcn": f"{DA3}<true>",
        "burgers_da_pcn": f"{DA_BURGERS}<true>",
        "burgers_pcn": f"{PCN_BURGERS}<true>",
        "burgers_multitime_pcn": f"{PCN_BURGERS}<true>",
    }
    step_ms = {cfg: next(r["ms"] for r in results
                         if r["name"] == k and cfg in r["paths"])
               for cfg, k in step_ms.items()}
    steps = lambda p, ns: p.burn_in + 2 * ns * p.thin
    predicted = sum(steps(p, p.n_samples) * step_ms[c] / 1e3
                    for c, p in problems.items() if c in step_ms)
    cut = min(1.0, RUN_BUDGET_S / predicted)
    print(f"predicted device time of the fourteen fused runs as shipped: {predicted:.1f} s",
          flush=True)
    for config, problem in problems.items():
        if config in PARALLEL_PATHS:
            continue  # run_parallel_phase's, below
        n_samples = problem.n_samples
        if config in SMC_PATHS + VI_PATHS + tuple(LINEAR_FUSED):
            pass  # no samples (particles or ADVI steps), or the config's own
        elif config not in SCAN_PATHS:
            n_samples = max(8, int(problem.n_samples * cut))
        else:
            n_samples = SCAN_SAMPLES.get(config, n_samples)
        if n_samples != problem.n_samples:
            print(f"{config}: n_samples cut from {problem.n_samples} to "
                  f"{n_samples} to fit the time limit (width unchanged: "
                  f"{problem.n_chains} chains)", flush=True)
        for field, value in SCAN_SHORT.get(config, {}).items():
            shipped = (problem.burn_in if field == "burn_in"
                       else problem.kernel_params[field])
            print(f"{config}: {field} cut from {shipped} to {value} to fit the time "
                  "limit (width unchanged)", flush=True)
        if config in VI_STEPS:
            kp = problem.kernel_params
            shipped = kp["vi_init"]["num_steps"] if "vi_init" in kp else kp["num_steps"]
            print(f"{config}: ADVI num_steps cut from {shipped} to {VI_STEPS[config]} to "
                  "fit the time limit (Monte Carlo batch unchanged)", flush=True)
        counts[config], metrics = drive_path(config, problem, n_samples)
        path_metrics[config] = metrics
        if config == "darcy64_da_fused":
            darcy64_da = report_da64(problem, metrics)
        if config in SMC_PATHS + VI_PATHS + ("darcy_advi_warmstart", "darcy_da_pod",
                                             "darcy_da_pod_online"):
            new_paths[config] = {k: v for k, v in metrics.items() if k != "posterior_mean"}
    smc = check_smc_evidence(new_paths, counts, problems["darcy_smc_warm"])
    linear_oracle = report_linear_fused(path_metrics)
    # the multi-device layer, darcy_da_fused at the samples its CLI run took
    parallel_phase = run_parallel_phase(problems, counts, max(8, int(
        problems[PARALLEL_DA].n_samples * cut)))
    counts["examples darcy_inversion"], examples_phase = drive_phase(
        "examples darcy_inversion", ("scan_pcn_step[cuda]",), run_examples_phase)
    # checkpoint / resume and the CLI's observability flags on the ODE path
    counts["checkpoint ode_mala"], checkpoint_phase = drive_phase(
        "checkpoint ode_mala", (LV, "scan_mala_step[cuda]"),
        lambda: run_checkpoint_phase(problems["ode_mala"]))
    counts["ode_mala --metrics-log --tensorboard --profile-dir"], cli_flags = drive_phase(
        "ode_mala --metrics-log --tensorboard --profile-dir", (LV, "scan_mala_step[cuda]"),
        run_cli_flags_phase)

    # no path launched a kernel of the specs the Hopper designs leave
    for path, c in counts.items():
        hit = {k: v for k, v in c.items() if k.split("<")[0] in RESTORED and v}
        if hit:
            raise AssertionError(f"{path} launched {hit}")

    # launches of each variant: those of the runs that use it (0 for an
    # option that no shipped config uses)
    for r in results:
        r["launches"] = sum(counts[p].get(r["name"], 0) for p in r["paths"])
        if r["paths"] and r["launches"] < 1:
            raise AssertionError(f"{r['name']} was launched by none of {r['paths']}")

    print(json.dumps({"kernels": results, "card": card, "compare_paths": compare_paths,
                      "richardson_da": richardson_da, "darcy64_da": darcy64_da,
                      "ode_gradient": ode_gradient, "smc_evidence": smc,
                      "smc_warm_misfit": smc_warm_misfit,
                      "smc_vi_pod_runs": new_paths, "checkpoint": checkpoint_phase,
                      "cli_flags": cli_flags, "parallel": parallel_phase,
                      "examples": examples_phase, "linear_oracle": linear_oracle,
                      "ptxas": ptxas}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
