"""Preconditioned Crank–Nicolson, scan path (mirrors
``ip_mcmc_tpu/kernels/pcn.py``):

    v = m + √(1 − β²)(u − m) + β ξ,   ξ ~ N(0, C₀),
    accepted with probability min(1, exp(Φ(u) − Φ(v))).

pCN is prior-reversible: only the data misfit Φ enters the ratio."""

from __future__ import annotations

import dataclasses

import torch

from ip_mcmc_tpu_torch.kernels.base import MHInfo, draws, mh_select


@dataclasses.dataclass
class PCNState:
    position: torch.Tensor  # (n, d)
    potential: torch.Tensor  # (n,) cached Φ(position)


def init(position, potential_fn):
    return PCNState(position=position, potential=potential_fn(position))


def build_kernel(potential_fn, prior, beta):
    """pCN step with contraction √(1 − β²) toward the prior mean. ``prior``
    has ``mean`` and ``scale_apply`` (ξ = C₀^{1/2} z)."""
    if isinstance(beta, (int, float)) and not 0.0 < float(beta) <= 1.0:
        raise ValueError(
            f"pCN beta must be in (0, 1], got {beta}: sqrt(1-beta^2) would be NaN"
        )
    beta = torch.as_tensor(beta, dtype=torch.float32, device=prior.mean.device)

    def transition(state, xi, u):
        """One step from the centred prior draw ``xi`` (n, d) and the
        uniforms ``u`` (n,)."""
        contraction = torch.sqrt(1.0 - beta * beta)
        proposal = prior.mean + contraction * (state.position - prior.mean) + beta * xi
        proposal_phi = potential_fn(proposal)
        new, accepted, accept_prob = mh_select(
            u, state.potential - proposal_phi, state,
            PCNState(position=proposal, potential=proposal_phi))
        return new, MHInfo(accepted=accepted, accept_prob=accept_prob,
                           proposal=proposal)

    def kernel(generator, state):
        z, u = draws(generator, state, "scan_pcn_step")
        return transition(state, prior.scale_apply(z), u)

    kernel.transition = transition
    return kernel
