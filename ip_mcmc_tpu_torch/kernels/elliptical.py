"""Elliptical slice sampling, scan path (mirrors
``ip_mcmc_tpu/kernels/elliptical.py``; Murray, Adams & MacKay 2010).

Targets exp(−Φ(u)) dμ₀ under a Gaussian prior μ₀ with no step size and no
rejection: each transition draws ν ~ N(0, C₀), a slice level
log y = −Φ(u) + log U and an angle θ ∈ [0, 2π), and shrinks the bracket
[θ − 2π, θ] towards 0 until u' = (u − m) cos θ + ν sin θ + m beats the
level, or ``max_shrink`` evaluations have run (then the chain stays put).

JAX ``vmap``s a ``while_loop`` over the chains; here the loop runs over the
batch with a mask, each chain's carry frozen once it has accepted, and the
host reads after every evaluation whether any chain is still shrinking and
stops when none is. All ``max_shrink`` bracket uniforms are drawn up
front."""

from __future__ import annotations

import dataclasses
import math

import torch

from ip_mcmc_tpu_torch.kernels.base import count_step, normals, uniforms

# 2π as the f32 that JAX's uniform(maxval=2.0 * jnp.pi) scales by
TWO_PI = float(torch.tensor(2.0 * math.pi, dtype=torch.float32))


@dataclasses.dataclass
class EllipticalState:
    position: torch.Tensor  # (n, d)
    potential: torch.Tensor  # (n,) cached Φ(position)


@dataclasses.dataclass
class EllipticalInfo:
    n_evals: torch.Tensor  # (n,) int32 forward evaluations this step
    theta: torch.Tensor  # (n,) the accepted angle (0 where none was)


def init(position, potential_fn):
    return EllipticalState(position=position, potential=potential_fn(position))


def _between(u, lo, hi):
    """JAX's ``uniform(minval=lo, maxval=hi)`` from its [0, 1) float u."""
    return torch.maximum(lo, u * (hi - lo) + lo)


def build_kernel(potential_fn, prior, max_shrink=30):
    """One ESS transition targeting exp(−Φ) dμ₀ (μ₀ = ``prior``)."""

    def transition(state, nu, u_level, u_theta, u_shrink):
        """From the centred prior draw ``nu`` (n, d), the level's and the
        first angle's uniforms (n,) each, and ``max_shrink`` rows of
        bracket uniforms (max_shrink, n)."""
        m = prior.mean
        centred = state.position - m
        log_y = -state.potential + torch.log(u_level)
        theta = u_theta * TWO_PI
        lo, hi = theta - TWO_PI, theta
        phi = torch.zeros_like(state.potential)
        accepted = torch.zeros_like(state.potential, dtype=torch.bool)
        n_evals = torch.zeros_like(state.potential, dtype=torch.int32)
        for it in range(max_shrink):
            active = ~accepted
            phi_new = potential_fn(centred * torch.cos(theta)[:, None]
                                   + nu * torch.sin(theta)[:, None] + m)
            acc_new = -phi_new > log_y
            # a chain that accepted keeps its carry, as under JAX's vmap
            phi = torch.where(active, phi_new, phi)
            lo_new = torch.where(acc_new | (theta >= 0.0), lo, theta)
            hi_new = torch.where(acc_new | (theta < 0.0), hi, theta)
            theta_new = torch.where(acc_new, theta,
                                    _between(u_shrink[it], lo_new, hi_new))
            lo = torch.where(active, lo_new, lo)
            hi = torch.where(active, hi_new, hi)
            theta = torch.where(active, theta_new, theta)
            n_evals = n_evals + active.to(torch.int32)
            accepted = accepted | acc_new
            if bool(torch.all(accepted)):
                break
        # no acceptance within max_shrink: stay put (θ → 0 is the current point)
        new_position = torch.where(
            accepted[:, None],
            centred * torch.cos(theta)[:, None] + nu * torch.sin(theta)[:, None] + m,
            state.position)
        new = EllipticalState(position=new_position,
                              potential=torch.where(accepted, phi, state.potential))
        return new, EllipticalInfo(
            n_evals=n_evals, theta=torch.where(accepted, theta, torch.zeros_like(theta)))

    def kernel(generator, state):
        n = state.position.shape[0]
        dev = state.position.device
        count_step("scan_ess_step", dev)
        nu = prior.scale_apply(normals(generator, state.position.shape, dev))
        u_level = uniforms(generator, (n,), dev)
        u_theta = uniforms(generator, (n,), dev)
        return transition(state, nu, u_level, u_theta,
                          uniforms(generator, (max_shrink, n), dev, chain_axis=1))

    kernel.transition = transition
    return kernel
