"""Hamiltonian Monte Carlo with a fixed number of leapfrog steps, scan path
(mirrors ``ip_mcmc_tpu/kernels/hmc.py``). Diagonal mass matrix M: momenta
p ~ N(0, M), kinetic energy ½ pᵀM⁻¹p; one gradient per leapfrog step,
through autograd (``base.value_and_grad``)."""

from __future__ import annotations

import dataclasses

import torch

from ip_mcmc_tpu_torch.kernels.base import MHInfo, draws, mh_select, value_and_grad


@dataclasses.dataclass
class HMCState:
    position: torch.Tensor  # (n, d)
    log_density: torch.Tensor  # (n,)
    grad: torch.Tensor  # (n, d)


def init(position, log_density_fn):
    ld, g = value_and_grad(log_density_fn)(position)
    return HMCState(position=position, log_density=ld, grad=g)


def leapfrog(value_and_grad, position, momentum, grad, step_size, num_steps,
             inv_mass):
    """``num_steps`` leapfrog steps; returns the final (q, p, log π(q),
    ∇log π(q))."""
    q, p, g = position, momentum, grad
    ld = None
    for _ in range(num_steps):
        p_half = p + 0.5 * step_size * g
        q = q + step_size * inv_mass * p_half
        ld, g = value_and_grad(q)
        p = p_half + 0.5 * step_size * g
    return q, p, ld, g


def build_kernel(log_density_fn, step_size, num_integration_steps, inv_mass=None):
    """``inv_mass``: None (unit mass) or (d,) diagonal M⁻¹."""
    vg = value_and_grad(log_density_fn)

    def transition(state, z, u):
        """From the standard normals ``z`` (n, d) of the momenta and
        uniforms ``u`` (n,)."""
        im = torch.ones_like(state.position) if inv_mass is None else inv_mass
        momentum = z / torch.sqrt(im)  # p ~ N(0, M) as M^{1/2} z

        def kinetic(p):
            return 0.5 * torch.sum(im * p * p, dim=-1)

        q, p, ld_new, g_new = leapfrog(vg, state.position, momentum, state.grad,
                                       step_size, num_integration_steps, im)
        h_init = -state.log_density + kinetic(momentum)
        h_final = -ld_new + kinetic(p)
        new, accepted, accept_prob = mh_select(
            u, h_init - h_final, state,
            HMCState(position=q, log_density=ld_new, grad=g_new))
        return new, MHInfo(accepted=accepted, accept_prob=accept_prob, proposal=q)

    def kernel(generator, state):
        return transition(state, *draws(generator, state, "scan_hmc_step"))

    kernel.transition = transition
    return kernel
