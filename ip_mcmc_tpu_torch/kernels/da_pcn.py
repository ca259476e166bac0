"""Delayed-acceptance pCN, scan path (mirrors ``ip_mcmc_tpu/kernels/da_pcn.py``;
Christen–Fox 2005 in the k-step surrogate-transition form, Liu 2001
§9.4.3):

    v = endpoint of k pCN steps from u, each accepted against Φ*,
    accepted with probability min(1, exp[(Φ(u) − Φ(v)) − (Φ*(u) − Φ*(v))]).

The subchain is reversible with respect to π* ∝ e^{−Φ*} μ₀, so the
correction leaves π ∝ e^{−Φ} μ₀ invariant whatever the surrogate. Each outer
step costs k surrogate evaluations and one exact one for every chain; the
state caches Φ and Φ* at the current position."""

from __future__ import annotations

import dataclasses

import torch

from ip_mcmc_tpu_torch.kernels.base import (
    count_step,
    mh_select,
    nan_to_neg_inf,
    normals,
    uniforms,
)


@dataclasses.dataclass
class DAPCNState:
    position: torch.Tensor  # (n, d)
    potential: torch.Tensor  # (n,) cached exact Φ(position)
    surrogate: torch.Tensor  # (n,) cached surrogate Φ*(position)


@dataclasses.dataclass
class DAPCNInfo:
    accepted: torch.Tensor  # (n,) outer (exact-correction) accept
    accept_prob: torch.Tensor  # (n,) outer accept probability
    inner_accept_rate: torch.Tensor  # (n,) mean surrogate-stage acceptance
    moved: torch.Tensor  # (n,) the subchain's endpoint differs from its start


def init(position, potential_fn, surrogate_fn):
    return DAPCNState(position=position, potential=potential_fn(position),
                      surrogate=surrogate_fn(position))


def build_kernel(potential_fn, surrogate_fn, prior, beta, subchain_len=4):
    """One DA-pCN transition: ``subchain_len`` surrogate pCN steps and one
    exact correction. ``prior`` has ``mean`` and ``scale_apply``."""
    if isinstance(beta, (int, float)) and not 0.0 < float(beta) <= 1.0:
        raise ValueError(f"pCN beta must be in (0, 1], got {beta}")
    if subchain_len < 1:
        raise ValueError(f"subchain_len must be >= 1, got {subchain_len}")
    beta = torch.as_tensor(beta, dtype=torch.float32, device=prior.mean.device)

    def transition(state, xi, u_inner, u_outer):
        """From the centred prior draws ``xi`` (k, n, d) and the uniforms
        ``u_inner`` (k, n) of the subchain, and the correction's uniforms
        ``u_outer`` (n,)."""
        contraction = torch.sqrt(1.0 - beta * beta)
        m = prior.mean
        pos, phi_s = state.position, state.surrogate
        n_acc = torch.zeros_like(phi_s)
        for j in range(subchain_len):
            prop = m + contraction * (pos - m) + beta * xi[j]
            phi_prop = surrogate_fn(prop)
            take = torch.log(u_inner[j]) < nan_to_neg_inf(phi_s - phi_prop)
            pos = torch.where(take[:, None], prop, pos)
            phi_s = torch.where(take, phi_prop, phi_s)
            n_acc = n_acc + take.to(torch.float32)

        phi_end = potential_fn(pos)
        # π*-to-π correction: (Φ(u) − Φ(v)) − (Φ*(u) − Φ*(v))
        log_ratio = (state.potential - phi_end) - (state.surrogate - phi_s)
        new, accepted, accept_prob = mh_select(
            u_outer, log_ratio, state,
            DAPCNState(position=pos, potential=phi_end, surrogate=phi_s))
        return new, DAPCNInfo(
            accepted=accepted, accept_prob=accept_prob,
            inner_accept_rate=n_acc / subchain_len,
            moved=torch.any(pos != state.position, dim=1))

    def kernel(generator, state):
        n, d = state.position.shape
        dev = state.position.device
        count_step("scan_da_pcn_step", dev)
        xi = prior.scale_apply(normals(generator, (subchain_len, n, d), dev, chain_axis=1))
        u_inner = uniforms(generator, (subchain_len, n), dev, chain_axis=1)
        return transition(state, xi, u_inner, uniforms(generator, (n,), dev))

    kernel.transition = transition
    return kernel
