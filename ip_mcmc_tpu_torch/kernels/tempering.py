"""Parallel tempering (replica exchange), scan path (mirrors
``ip_mcmc_tpu/kernels/tempering.py``).

T replicas of each chain target exp(−β_t Φ) dμ₀ along a ladder
β_1 = 1 > … > β_T; each step mutates every replica (tempered pCN, or MALA
with ∇log π_t = −β_t ∇Φ + ∇log μ₀) and then tries one round of adjacent
swaps, pairs of alternating parity, replica i and i + 1 exchanged with
probability min(1, exp((β_i − β_{i+1})(Φ_i − Φ_{i+1}))).

A state is (n, T, d) positions and (n, T) untempered Φ, with a parity per
chain: the JAX kernel's single-chain state with the chain axis written
out. ``adapt_ladder`` equalises the per-attempt swap rates with both ends
of the ladder pinned; ``cold_chain`` takes the β = 1 replica."""

from __future__ import annotations

import dataclasses

import torch

from ip_mcmc_tpu_torch.kernels.base import (
    contraction,
    count_step,
    nan_to_neg_inf,
    normals,
    uniforms,
    value_and_grad,
)


@dataclasses.dataclass
class PTState:
    positions: torch.Tensor  # (n, T, d)
    potentials: torch.Tensor  # (n, T) untempered Φ
    parity: torch.Tensor  # (n,) int32, alternates the swap pairing


@dataclasses.dataclass
class PTMalaState:
    positions: torch.Tensor  # (n, T, d)
    potentials: torch.Tensor  # (n, T)
    phi_grads: torch.Tensor  # (n, T, d) cached untempered ∇Φ
    parity: torch.Tensor  # (n,)


@dataclasses.dataclass
class PTInfo:
    accept_rate: torch.Tensor  # (n,) mean mutation acceptance over the ladder
    swap_rate: torch.Tensor  # (n,) share of the attempted swaps accepted
    cold_accepted: torch.Tensor  # (n,) the cold replica's mutation accepted
    pair_swap_prob: torch.Tensor  # (n, T) min(1, e^{log swap}) at lead i, 0 if inactive
    pair_active: torch.Tensor  # (n, T) 1.0 where pair (i, i + 1) was attempted


def geometric_ladder(n_temps, beta_min=0.05):
    """β_t = beta_min^(t / (T − 1)), from 1 down to beta_min (f32)."""
    t = torch.arange(n_temps, dtype=torch.float32) / max(n_temps - 1, 1)
    return torch.pow(torch.tensor(beta_min, dtype=torch.float32), t)


def _batched_phi(potential_fn, x):
    """Φ of (n, T, d) replicas as one (n·T, d) batch."""
    n, T, d = x.shape
    return potential_fn(x.reshape(n * T, d)).reshape(n, T)


def init(position, potential_fn, n_temps):
    """Replicate each chain's position (n, d) across the ladder."""
    n = position.shape[0]
    phi = potential_fn(position)
    return PTState(
        positions=position[:, None, :].expand(n, n_temps, position.shape[1]).clone(),
        potentials=phi[:, None].expand(n, n_temps).clone(),
        parity=torch.zeros(n, dtype=torch.int32, device=position.device))


def init_mala(position, potential_fn, n_temps):
    n, d = position.shape
    phi, g = value_and_grad(potential_fn)(position)
    return PTMalaState(
        positions=position[:, None, :].expand(n, n_temps, d).clone(),
        potentials=phi[:, None].expand(n, n_temps).clone(),
        phi_grads=g[:, None, :].expand(n, n_temps, d).clone(),
        parity=torch.zeros(n, dtype=torch.int32, device=position.device))


def _swap_round(betas, potentials, parity, u_swap):
    """The adjacent-swap decisions of one step: (lead (n, T): i takes from
    i + 1, follow: i + 1 takes from i, info fields)."""
    n_temps = betas.shape[0]
    idx = torch.arange(n_temps, device=potentials.device)
    active = ((idx % 2)[None, :] == (parity % 2)[:, None]) & (idx < n_temps - 1)
    beta_next = torch.roll(betas, -1)
    log_swap = (betas - beta_next) * (potentials - torch.roll(potentials, -1, dims=1))
    lead = active & (torch.log(u_swap) < log_swap)
    follow = torch.roll(lead, 1, dims=1)
    active_f = active.to(torch.float32)
    n_active = torch.clamp(torch.sum(active_f, dim=1), min=1.0)
    info = dict(swap_rate=torch.sum(lead.to(torch.float32), dim=1) / n_active,
                pair_swap_prob=torch.exp(torch.clamp(log_swap, max=0.0)) * active_f,
                pair_active=active_f)
    return lead, follow, info


def _shuffle(x, lead, follow):
    """Apply the swaps to a per-replica field x (n, T, ...)."""
    shape = lead.shape + (1,) * (x.dim() - 2)
    return torch.where(lead.reshape(shape), torch.roll(x, -1, dims=1),
                       torch.where(follow.reshape(shape), torch.roll(x, 1, dims=1), x))


def build_kernel(potential_fn, prior, betas, pcn_step=0.25):
    """One PT step: a tempered pCN update of every replica and one round of
    parity-alternating adjacent swaps. ``betas``: (T,), betas[0] = 1."""
    betas = torch.as_tensor(betas, dtype=torch.float32, device=prior.mean.device)
    n_temps = betas.shape[0]
    shrink = contraction(pcn_step)

    def transition(state, xi, u_acc, u_swap):
        """From the centred prior draws ``xi`` (n, T, d) and the mutation's
        and the swaps' uniforms (n, T) each."""
        m = prior.mean
        proposals = m + shrink * (state.positions - m) + pcn_step * xi
        phi_prop = _batched_phi(potential_fn, proposals)
        log_ratio = nan_to_neg_inf(betas * (state.potentials - phi_prop))
        accepted = torch.log(u_acc) < log_ratio
        positions = torch.where(accepted[..., None], proposals, state.positions)
        potentials = torch.where(accepted, phi_prop, state.potentials)
        lead, follow, swap_info = _swap_round(betas, potentials, state.parity, u_swap)
        new = PTState(positions=_shuffle(positions, lead, follow),
                      potentials=_shuffle(potentials, lead, follow),
                      parity=1 - state.parity)
        acc_f = accepted.to(torch.float32)
        return new, PTInfo(accept_rate=torch.mean(acc_f, dim=1),
                           cold_accepted=accepted[:, 0], **swap_info)

    def kernel(generator, state):
        n, _, d = state.positions.shape
        dev = state.positions.device
        count_step("scan_pt_step", dev)
        xi = prior.scale_apply(normals(generator, (n, n_temps, d), dev))
        return transition(state, xi, uniforms(generator, (n, n_temps), dev),
                          uniforms(generator, (n, n_temps), dev))

    kernel.transition = transition
    return kernel


def build_mala_kernel(potential_fn, prior, betas, step_size=0.05):
    """PT with MALA mutations: replica t targets exp(−β_t Φ) μ₀, its drift
    −β_t ∇Φ + ∇log μ₀ from the cached untempered ∇Φ (one forward and
    gradient a replica a step); swaps move ∇Φ with the position."""
    betas = torch.as_tensor(betas, dtype=torch.float32, device=prior.mean.device)
    n_temps = betas.shape[0]
    eps = step_size
    prior_vg = value_and_grad(prior.log_prob)
    phi_vg = value_and_grad(potential_fn)

    def flat_vg(vg, x):
        n, T, d = x.shape
        val, g = vg(x.reshape(n * T, d))
        return val.reshape(n, T), g.reshape(n, T, d)

    def transition(state, xi, u_acc, u_swap):
        """From the standard normals ``xi`` (n, T, d) and the mutation's and
        the swaps' uniforms (n, T) each."""
        u = state.positions
        b = betas[:, None]
        lp0, lp0_grad = flat_vg(prior_vg, u)
        drift0 = -b * state.phi_grads + lp0_grad
        mean_fwd = u + 0.5 * eps * eps * drift0
        v = mean_fwd + eps * xi
        phi_v, phi_v_grad = flat_vg(phi_vg, v)
        lp1, lp1_grad = flat_vg(prior_vg, v)
        drift1 = -b * phi_v_grad + lp1_grad
        mean_rev = v + 0.5 * eps * eps * drift1
        inv2e2 = 1.0 / (2.0 * eps * eps)
        log_q_rev = -torch.sum(torch.square(u - mean_rev), dim=-1) * inv2e2
        log_q_fwd = -0.5 * torch.sum(xi * xi, dim=-1)
        log_ratio = nan_to_neg_inf(
            (-betas * phi_v + lp1) - (-betas * state.potentials + lp0)
            + log_q_rev - log_q_fwd)
        accepted = torch.log(u_acc) < log_ratio
        positions = torch.where(accepted[..., None], v, u)
        potentials = torch.where(accepted, phi_v, state.potentials)
        grads = torch.where(accepted[..., None], phi_v_grad, state.phi_grads)
        lead, follow, swap_info = _swap_round(betas, potentials, state.parity, u_swap)
        new = PTMalaState(positions=_shuffle(positions, lead, follow),
                          potentials=_shuffle(potentials, lead, follow),
                          phi_grads=_shuffle(grads, lead, follow),
                          parity=1 - state.parity)
        acc_f = accepted.to(torch.float32)
        return new, PTInfo(accept_rate=torch.mean(acc_f, dim=1),
                           cold_accepted=accepted[:, 0], **swap_info)

    def kernel(generator, state):
        n, _, d = state.positions.shape
        dev = state.positions.device
        count_step("scan_pt_mala_step", dev)
        return transition(state, normals(generator, (n, n_temps, d), dev),
                          uniforms(generator, (n, n_temps), dev),
                          uniforms(generator, (n, n_temps), dev))

    kernel.transition = transition
    return kernel


def betas_from_gaps(rho):
    """Free-bottom ladder: β_1 = 1, β_{t+1} = β_t·e^{−e^{ρ_t}} (any real gap
    vector gives a decreasing ladder; not what ``adapt_ladder`` uses)."""
    return torch.cat([torch.ones(1, dtype=rho.dtype, device=rho.device),
                      torch.exp(-torch.cumsum(torch.exp(rho), dim=0))])


def betas_from_shares(rho, beta_min):
    """Fixed-endpoint ladder: β_1 = 1 and β_T = beta_min pinned, the T − 1
    log-β gaps splitting log(beta_min) in softmax(ρ) proportions."""
    w = torch.softmax(rho, dim=0)
    log_min = torch.log(torch.tensor(beta_min, dtype=rho.dtype, device=rho.device))
    log_beta = torch.cat([torch.zeros(1, dtype=rho.dtype, device=rho.device),
                          torch.cumsum(w, dim=0) * log_min])
    return torch.exp(log_beta)


def adapt_ladder(potential_fn, prior, positions, generator, n_temps=8,
                 num_steps=300, swap_center=0.4, pcn_step=0.25, beta_min=0.05,
                 gain=0.6, mutation="pcn", step_size=0.05):
    """Equi-acceptance ladder adaptation with both ends pinned: stochastic
    approximation on the gap shares ρ (``betas_from_shares``),
    ρ_t += γ_k (p_t − swap_center) on the steps where pair t was attempted,
    p_t the chain-mean swap probability per attempt, γ_k = gain/(1 + k)^0.6.
    The common part of (p − center) cancels in the softmax, so the rates
    converge to equal values, not to ``swap_center``. The adaptation runs
    the production ``mutation`` ("pcn" or "mala"; ``step_size`` is MALA's).
    ``positions`` (n, d): the chains' cold starts, replicated over the
    ladder. Returns (states, betas (T,), pair_rates (T − 1,): the
    per-attempt rate of each adjacent pair over the last third)."""
    if mutation not in ("pcn", "mala"):
        raise ValueError(f"mutation must be 'pcn' or 'mala', got {mutation!r}")
    dev = positions.device
    rho = torch.zeros(n_temps - 1, dtype=torch.float32, device=dev)
    if mutation == "mala":
        states = init_mala(positions, potential_fn, n_temps)

        def make_kernel(betas):
            return build_mala_kernel(potential_fn, prior, betas, step_size=step_size)
    else:
        states = init(positions, potential_fn, n_temps)

        def make_kernel(betas):
            return build_kernel(potential_fn, prior, betas, pcn_step=pcn_step)

    rates, actives = [], []
    for step in range(num_steps):
        states, infos = make_kernel(betas_from_shares(rho, beta_min))(generator, states)
        act_mean = torch.mean(infos.pair_active, dim=0)
        prob = torch.mean(infos.pair_swap_prob, dim=0)
        pair_rate = (prob / torch.clamp(act_mean, min=1e-6))[: n_temps - 1]
        act_mask = (act_mean > 0.5)[: n_temps - 1].to(rho.dtype)
        gamma = gain / (1.0 + torch.tensor(float(step), dtype=rho.dtype)) ** 0.6
        rho = rho + gamma.to(dev) * act_mask * (pair_rate - swap_center)
        rates.append(pair_rate)
        actives.append(act_mask)
    tail = max(num_steps - num_steps // 3, 0)
    rates, act_f = torch.stack(rates[tail:]), torch.stack(actives[tail:])
    pair_rates = torch.sum(rates * act_f, dim=0) / torch.clamp(
        torch.sum(act_f, dim=0), min=1.0)
    return states, betas_from_shares(rho, beta_min), pair_rates


def cold_chain(state_or_samples):
    """The β = 1 replica of a PT state or of recorded (…, T, d) positions."""
    if hasattr(state_or_samples, "positions"):
        return state_or_samples.positions[..., 0, :]
    return state_or_samples[..., 0, :]
