"""Metropolis-adjusted Langevin algorithm, scan path (mirrors
``ip_mcmc_tpu/kernels/mala.py``):

    v = u + (ε²/2) Σ ∇log π(u) + ε Σ^{1/2} ξ,   ξ ~ N(0, I),
    accepted with probability min(1, π(v) q(u|v) / (π(u) q(v|u))).

The gradient comes from autograd through the forward model, each chain's
from its own row (``base.value_and_grad``)."""

from __future__ import annotations

import dataclasses

import torch

from ip_mcmc_tpu_torch.kernels.base import MHInfo, draws, mh_select, value_and_grad


@dataclasses.dataclass
class MALAState:
    position: torch.Tensor  # (n, d)
    log_density: torch.Tensor  # (n,)
    grad: torch.Tensor  # (n, d) cached ∇log π(position)


def init(position, log_density_fn):
    ld, g = value_and_grad(log_density_fn)(position)
    return MALAState(position=position, log_density=ld, grad=g)


def build_kernel(log_density_fn, step_size, precond=None):
    """``precond``: None, (d,) variances (diagonal Σ), or a (d, d)
    lower-triangular Cholesky factor L with Σ = L Lᵀ (the cross-chain
    adapted one)."""
    vg = value_and_grad(log_density_fn)
    eps = step_size
    dense = precond is not None and precond.dim() == 2

    def apply_sigma(g):  # Σ g for every chain
        if precond is None:
            return g
        if dense:
            return (g @ precond) @ precond.T
        return precond * g

    def sqrt_sigma_noise(xi):  # Σ^{1/2} ξ for every chain
        if precond is None:
            return xi
        if dense:
            return xi @ precond.T
        return torch.sqrt(precond) * xi

    def mahalanobis(d):
        """‖Σ^{-1/2} d‖² per chain (the q-density exponent)."""
        if precond is None:
            return torch.sum(torch.square(d), dim=-1)
        if dense:
            w = torch.linalg.solve_triangular(precond, d.T, upper=False).T
            return torch.sum(torch.square(w), dim=-1)
        return torch.sum(torch.square(d) / precond, dim=-1)

    def transition(state, xi, u):
        """From the standard normals ``xi`` (n, d) and uniforms ``u`` (n,)."""
        mean_fwd = state.position + 0.5 * eps * eps * apply_sigma(state.grad)
        proposal = mean_fwd + eps * sqrt_sigma_noise(xi)
        proposal_ld, proposal_grad = vg(proposal)
        mean_rev = proposal + 0.5 * eps * eps * apply_sigma(proposal_grad)
        log_q_rev = -0.5 * mahalanobis(state.position - mean_rev) / (eps * eps)
        log_q_fwd = -0.5 * mahalanobis(proposal - mean_fwd) / (eps * eps)
        log_ratio = proposal_ld - state.log_density + log_q_rev - log_q_fwd
        new, accepted, accept_prob = mh_select(
            u, log_ratio, state,
            MALAState(position=proposal, log_density=proposal_ld, grad=proposal_grad))
        return new, MHInfo(accepted=accepted, accept_prob=accept_prob,
                           proposal=proposal)

    def kernel(generator, state):
        return transition(state, *draws(generator, state, "scan_mala_step"))

    kernel.transition = transition
    return kernel
