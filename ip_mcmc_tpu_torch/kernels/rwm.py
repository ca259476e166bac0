"""Random-walk Metropolis, scan path (mirrors ``ip_mcmc_tpu/kernels/rwm.py``):
v = u + δ·ξ, with an isotropic, diagonal or dense-Cholesky proposal scale
(the dense one is what cross-chain covariance adaptation feeds)."""

from __future__ import annotations

import dataclasses

import torch

from ip_mcmc_tpu_torch.kernels.base import MHInfo, draws, mh_select


@dataclasses.dataclass
class RWMState:
    position: torch.Tensor  # (n, d)
    log_density: torch.Tensor  # (n,) cached log π(position)


def init(position, log_density_fn):
    return RWMState(position=position, log_density=log_density_fn(position))


def build_kernel(log_density_fn, step_size, scale=None):
    """RWM step. ``scale``: None (isotropic), (d,) diagonal standard
    deviations, or a (d, d) lower-triangular proposal Cholesky factor."""

    def transition(state, xi, u):
        if scale is None:
            delta = step_size * xi
        elif scale.dim() == 1:
            delta = step_size * scale * xi
        else:
            delta = step_size * (xi @ scale.T)  # scale @ ξ for every chain
        proposal = state.position + delta
        proposal_ld = log_density_fn(proposal)
        new, accepted, accept_prob = mh_select(
            u, proposal_ld - state.log_density, state,
            RWMState(position=proposal, log_density=proposal_ld))
        return new, MHInfo(accepted=accepted, accept_prob=accept_prob,
                           proposal=proposal)

    def kernel(generator, state):
        return transition(state, *draws(generator, state, "scan_rwm_step"))

    kernel.transition = transition
    return kernel
