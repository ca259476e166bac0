"""Burn-in pCN with Robbins–Monro adaptation of β on the block-pooled
acceptance probability, fused (K16; mirrors ``ip_mcmc_tpu/ops/fused_mcmc.py``
``fused_pcn_chain_adapt`` l.992 with ``_make_pcn_adapt_step_builder``
l.520).

Each block of ``block_chains`` chains shares one log β. One step:
β = exp(log β), prop = m + √(1 − β²)(pos − m) + β·s·ξ, p = min(1, e^{Φ−Φ'}),
accepted when log u < log p; then

    log β ← clip(log β + γ_i·(mean over the block of p − target),
                 log 1e-4, log 0.999),   γ_i = gain·(1 + i)^−0.6,

with i counting this launch's steps from 0. Burn-in only: freeze the
returned β (per chain, constant within a block) for sampling. There is no
recorded variant.

γ_i, the clip bounds and the initial log β are formed on the host in
float64 and rounded once to f32, identical for the kernel and the plain
version (the JAX kernel forms (1 + i)^−0.6 through exp and log in f32, a
Mosaic workaround: against it β agrees to a stated tolerance, not to the
bit). The block mean is summed in a fixed pairwise order (``_fold_sum``:
fold the upper half onto the lower until one element is left) by both.

For CUDA tensors the entry point runs the step loop on the host, two
launches per step (``csrc/fused_pcn_adapt.cu``: ``fused_pcn_adapt_kernel``
moves every chain and writes its p; ``pcn_adapt_update_kernel`` pools each
block and updates its log β), on a ``LinearGaussianPotential``; Φ at the
start comes from the potential's own kernel. For CPU tensors it runs the
step builder below on ``_scaffold.run_plain``, with any features-first
callable. Tags: normals 0 (keys 0, 1), MH uniform 2.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from ip_mcmc_tpu_torch.ops import _build, _scaffold

# log β stays in [log 1e-4, log 0.999]: β below 1, so √(1 − β²) is real
LOG_BETA_MIN = float(np.float32(math.log(np.float32(1e-4))))
LOG_BETA_MAX = float(np.float32(math.log(np.float32(0.999))))
MAX_BLOCK = 12288  # the update kernel pools a block in 48 KB of shared memory


def gain_at(gain, i) -> float:
    """γ_i = gain·(1 + i)^−0.6, formed in float64 and rounded to f32."""
    return float(np.float32(float(np.float32(gain)) * (1.0 + i) ** -0.6))


def initial_log_beta(beta0) -> float:
    return float(np.float32(math.log(float(np.float32(beta0)))))


def _fold_sum(x):
    """Sum of each row of ``x`` (rows, B) in the order of
    ``pcn_adapt_update_kernel``: element e < n − h takes element e + h,
    h = ⌈n/2⌉, until one is left."""
    n = x.shape[1]
    while n > 1:
        h = (n + 1) // 2
        x = torch.cat([x[:, : n - h] + x[:, h:n], x[:, n - h : h]], dim=1)
        n = h
    return x[:, 0]


def _update_plain(accept_prob, log_beta, block_chains, gamma, target):
    """Plain twin of ``pcn_adapt_update_kernel``: the blocks' new log β
    from this step's acceptance probabilities (n,), and β per chain."""
    pooled = _fold_sum(accept_prob.reshape(-1, block_chains)) / block_chains
    log_beta = torch.clamp(log_beta + gamma * (pooled - target),
                           LOG_BETA_MIN, LOG_BETA_MAX)
    return log_beta, torch.exp(log_beta).repeat_interleave(block_chains)


def _update_kernel(accept_prob, log_beta, beta, block_chains, gamma, target):
    """``pcn_adapt_update_kernel``: ``log_beta`` (blocks,) and ``beta`` (n,)
    updated in place from ``accept_prob`` (n,); all contiguous f32 on one
    card."""
    status = _build.library().ipx_pcn_adapt_update(
        accept_prob.data_ptr(), log_beta.data_ptr(), beta.data_ptr(),
        accept_prob.numel(), int(block_chains), float(gamma), float(target),
        LOG_BETA_MIN, LOG_BETA_MAX,
        torch.cuda.current_stream(accept_prob.device).cuda_stream)
    _build.check(status, "pcn_adapt_update_kernel")
    _build.launch_counts["pcn_adapt_update_kernel"] += 1


# --- the plain version ------------------------------------------------------


def _make_pcn_adapt_step_builder(target_accept, gain, block_chains):
    target = float(np.float32(target_accept))
    bc = int(block_chains)

    def builder(pot, beta0, mean, scale):
        m, s = mean[:, None], scale[:, None]

        def init(pos):
            log_beta = torch.full((pos.shape[1] // bc,),
                                  initial_log_beta(float(beta0)),
                                  dtype=torch.float32, device=pos.device)
            return (pos, pot(pos), log_beta, 0)

        def step(carry, rand_n, rand_u):
            pos, phi, log_beta, i = carry
            beta = torch.exp(log_beta).repeat_interleave(bc)[None, :]
            contraction = torch.sqrt(1.0 - beta * beta)
            xi = s * rand_n(pos.shape, 0)
            prop = m + contraction * (pos - m) + beta * xi
            phi_prop = pot(prop)
            log_ratio = torch.minimum(phi - phi_prop, torch.zeros_like(phi))
            accept_prob = torch.exp(log_ratio)
            log_u = torch.log(rand_u((1, pos.shape[1]), 2))[0]
            accept = log_u < log_ratio
            log_beta, _ = _update_plain(accept_prob, log_beta, bc,
                                        gain_at(gain, i), target)
            return (
                torch.where(accept[None, :], prop, pos),
                torch.where(accept, phi_prop, phi),
                log_beta,
                i + 1,
            ), accept[None, :]

        return init, step

    # the adapted β per chain (constant within a block)
    builder.extra_out = lambda carry: torch.exp(carry[2]).repeat_interleave(bc)
    return builder


def _run_plain(potential_fn, positions, prior_mean, prior_scale, beta0, seed,
               n_steps, target_accept, gain, block_chains):
    """Plain twin of the two kernels: (final (n, d), acceptance (n,), β
    (n,))."""
    _build.launch_counts["fused_pcn_adapt_plain"] += 1
    return _scaffold.run_plain(
        _make_pcn_adapt_step_builder(target_accept, gain, block_chains),
        potential_fn, positions, [beta0, prior_mean, prior_scale], seed,
        n_steps, block_chains,
    )[:3]


# --- the kernels ------------------------------------------------------------


def _launch(potential_fn, positions, prior_mean, prior_scale, beta0, seed,
            n_steps, target_accept, gain, block_chains):
    _scaffold.require_family({"potential_fn": potential_fn},
                             families=("linear",))
    # the chain's state: updated in place by every launch
    state = positions.clone(memory_format=torch.contiguous_format)
    args, _ = _scaffold.chain_args(state, prior_mean, prior_scale, seed,
                                   n_steps, block_chains, in_place=True)
    n, dev = state.shape[0], state.device
    U = state.T.contiguous()
    potential_fn.check_input(U, "positions.T")
    phi = potential_fn(U)  # the step builder's init, by the potential's kernel
    acc = torch.zeros(n, dtype=torch.float32, device=dev)
    accept_prob = torch.empty_like(acc)
    log_beta0 = initial_log_beta(beta0)
    log_beta = torch.full((n // block_chains,), log_beta0, dtype=torch.float32,
                          device=dev)
    beta = torch.full((n,), float(np.float32(math.exp(log_beta0))),
                      dtype=torch.float32, device=dev)
    target = float(np.float32(target_accept))
    spec = potential_fn.spec()
    lib = _build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    for i in range(n_steps):  # stream order is the barrier between launches
        status = lib.ipx_fused_pcn_adapt(
            ctypes.byref(spec), ctypes.byref(args), phi.data_ptr(),
            acc.data_ptr(), accept_prob.data_ptr(), log_beta.data_ptr(), i,
            stream)
        _build.check(status, "fused_pcn_adapt_kernel")
        _build.launch_counts["fused_pcn_adapt_kernel"] += 1
        _update_kernel(accept_prob, log_beta, beta, block_chains,
                       gain_at(gain, i), target)
    return state, acc / n_steps, beta


# --- entry point ------------------------------------------------------------


def fused_pcn_chain_adapt(potential_fn, positions, prior_mean, prior_scale,
                          beta0, seed, n_steps=300, target_accept=0.3,
                          gain=0.5, block_chains=256):
    """Burn-in pCN with β adapted per block of ``block_chains`` chains.
    ``potential_fn``: (d, B) → (B,). Returns (final positions (n, d),
    acceptance rate per chain (n,), β per chain (n,)); freeze e.g.
    ``float(beta.mean())`` for the sampling launch."""
    _scaffold.validate(positions, n_steps, block_chains)
    if block_chains > MAX_BLOCK:
        raise ValueError(f"block_chains {block_chains} > {MAX_BLOCK}")
    return _scaffold.on_device(positions, _launch, _run_plain)(
        potential_fn, positions, prior_mean, prior_scale, beta0, seed, n_steps,
        target_accept, gain, block_chains)
