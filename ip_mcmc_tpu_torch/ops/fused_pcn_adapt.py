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

For CUDA tensors the entry point runs on a ``LinearGaussianPotential``
(``csrc/fused_pcn_adapt.cu``). What ``group_takes`` (d = 2 or 32, K = d,
m ≤ d; a block of at most 256 chains that fits one thread-block cluster;
whole blocks: the lingauss_pcn burn-in) runs the whole burn-in in one
launch of ``fused_pcn_adapt_group_kernel``: each block on one cluster, a
chain on each group of d lanes, the block's p pooled once a step through
distributed shared memory behind one cluster barrier, Φ at the start in
the kernel. Every other spec keeps the host loop, two launches a step
(``fused_pcn_adapt_kernel`` moves every chain and writes its p;
``pcn_adapt_update_kernel`` pools each block and updates its log β), Φ at
the start from the potential's own kernel. Both give the same chains,
acceptance rates and β bit for bit. For CPU tensors the entry point runs
the step builder below on ``_scaffold.run_plain``, with any
features-first callable. Tags: normals 0 (keys 0, 1), MH uniform 2.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from ip_mcmc_tpu_torch.ops import _build, _gaussian_group, _scaffold

# log β stays in [log 1e-4, log 0.999]: β below 1, so √(1 − β²) is real
LOG_BETA_MIN = float(np.float32(math.log(np.float32(1e-4))))
LOG_BETA_MAX = float(np.float32(math.log(np.float32(0.999))))
MAX_BLOCK = 12288  # the update kernel pools a block in 48 KB of shared memory

# ``PcnAdaptGroupDesign`` in ``csrc/fused_pcn_adapt.cu``: warps a CTA, chains
# a group runs in turn, CTAs a cluster at most; and the p values a lane of
# the folding warp holds (``kFoldSlots``)
WARPS, TURNS, MAX_CLUSTER, FOLD_SLOTS = 16, 2, 8, 8
GROUP_KERNEL = "fused_pcn_adapt_group_kernel"


def gain_at(gain, i) -> float:
    """γ_i = gain·(1 + i)^−0.6, formed in float64 and rounded to f32."""
    return float(np.float32(float(np.float32(gain)) * (1.0 + i) ** -0.6))


def gains(gain, n_steps) -> np.ndarray:
    """γ_i for i < n_steps, f32: ``gain_at``'s values, formed at once."""
    pows = np.array([(1.0 + i) ** -0.6 for i in range(n_steps)], dtype=np.float64)
    return (float(np.float32(gain)) * pows).astype(np.float32)


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


# --- which route a burn-in takes -------------------------------------------


def group_chains(d) -> int:
    """Chains a CTA of the group kernel (``pcn_adapt_group_chains``)."""
    return WARPS * TURNS * (32 // _gaussian_group.width(d))


def group_max_block(d) -> int:
    """The largest block the group kernel takes: one cluster's chains, and
    what the folding warp holds (``pcn_adapt_group_max_block``)."""
    return min(MAX_CLUSTER * group_chains(d), 32 * FOLD_SLOTS)


def group_takes(d, m, K, block_chains, n) -> bool:
    """Whether ``fused_pcn_adapt_group_kernel`` runs a burn-in of n chains
    of d coordinates in blocks of ``block_chains`` on a potential of m rows
    and K columns, as ``pcn_adapt_group_takes`` decides."""
    return (_gaussian_group.takes(d, m, K) and 1 <= block_chains <= group_max_block(d)
            and n % block_chains == 0)


def group_geometry(n_chains, block_chains, *, d, m, K=None):
    """The group kernel's launch: (lanes a chain G, warps a CTA, CTAs a
    cluster, CTAs), as ``pcn_adapt_group_geometry`` computes it. Block b
    runs on cluster b, chain e of the block on its CTA e // chains-a-CTA.
    Raises ``ValueError`` for what the kernel does not take (the card runs
    it two launches a step)."""
    K = d if K is None else K
    if n_chains < 0 or not group_takes(d, m, K, block_chains, n_chains):
        raise ValueError(
            f"the adaptive group kernel takes d = K in {_gaussian_group.DIMS}, m <= d, "
            f"blocks of 1 to {group_max_block(d) if d in _gaussian_group.DIMS else 0} chains "
            f"and whole blocks; got d = {d}, K = {K}, m = {m}, {n_chains} chains in blocks "
            f"of {block_chains}")
    cluster = -(-block_chains // group_chains(d))
    return _gaussian_group.width(d), WARPS, cluster, n_chains // block_chains * cluster


def stem(potential_fn, d, block_chains, n) -> str:
    """The launch count's name of the kernel that runs this burn-in's
    steps on the card: the group kernel for what ``group_takes``, else
    ``fused_pcn_adapt_kernel`` (beside ``pcn_adapt_update_kernel``)."""
    return (GROUP_KERNEL if group_takes(d, potential_fn.m, potential_fn.K, block_chains, n)
            else "fused_pcn_adapt_kernel")


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
    """The burn-in on the card, by the route ``stem`` names."""
    _scaffold.require_family({"potential_fn": potential_fn},
                             families=("linear",))
    n, d = positions.shape
    run = (_launch_group if stem(potential_fn, d, block_chains, n) == GROUP_KERNEL
           else _launch_steps)
    return run(potential_fn, positions, prior_mean, prior_scale, beta0, seed,
               n_steps, target_accept, gain, block_chains)


def _launch_group(potential_fn, positions, prior_mean, prior_scale, beta0, seed,
                  n_steps, target_accept, gain, block_chains):
    """``fused_pcn_adapt_group_kernel``: the whole burn-in in one launch."""
    args, keep = _scaffold.chain_args(positions, prior_mean, prior_scale, seed,
                                      n_steps, block_chains)
    potential_fn.check_input(keep[0].T, "positions.T")
    dev = keep[0].device
    gamma = torch.from_numpy(gains(gain, n_steps)).to(dev)
    beta = torch.empty(keep[0].shape[0], dtype=torch.float32, device=dev)
    log_beta0 = initial_log_beta(beta0)
    with np.errstate(divide="ignore"):  # 0 steps: a NaN rate, as count / 0
        inv_steps = float(np.float32(1.0) / np.float32(n_steps))
    spec = potential_fn.spec()
    status = _build.library().ipx_fused_pcn_adapt_chain(
        ctypes.byref(spec), ctypes.byref(args), beta.data_ptr(), gamma.data_ptr(),
        float(np.float32(target_accept)), LOG_BETA_MIN, LOG_BETA_MAX, log_beta0,
        float(np.float32(math.exp(log_beta0))), inv_steps,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(status, GROUP_KERNEL)
    _build.launch_counts[GROUP_KERNEL] += 1
    _, _, _, out, acc, _ = keep
    return out, acc, beta


def _launch_steps(potential_fn, positions, prior_mean, prior_scale, beta0, seed,
                  n_steps, target_accept, gain, block_chains):
    """The host loop, two launches a step, on any linear-Gaussian spec up
    to MAX_BLOCK."""
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
