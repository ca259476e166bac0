"""ODE forward models: fixed-step RK4 (mirrors ``ip_mcmc_tpu/models/ode.py``).

The chains are a leading dimension: a state is (..., state_dim) and the
parameters (..., p). The time loop is Python over batched PyTorch
operations, differentiable by autograd through every step: this is the
gradient of the MALA and HMC configs. ``remat`` recomputes each step in
the backward pass (``torch.utils.checkpoint``) instead of keeping its
stages.

``make_lotka_volterra_forward`` integrates the log-population field with
its rates formed once a solve, so a stage is one ``exp``, a swap of the two
species and one fused multiply-add; the stage inputs and the update are
fused adds. The arithmetic is JAX's up to the contraction of a multiply and
an add into one rounding. ``LotkaVolterraMisfit`` is the configs' misfit of
that forward: on the card one kernel gives its value and gradient
(``ops/lv_rk4.py``), on the CPU this module's loop under autograd."""

from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ip_mcmc_tpu_torch import potentials
from ip_mcmc_tpu_torch.ops import _build, lv_rk4


def _rk4_step(field, y, dt, params):
    k1 = field(y, params)
    k2 = field(torch.add(y, k1, alpha=0.5 * dt), params)
    k3 = field(torch.add(y, k2, alpha=0.5 * dt), params)
    k4 = field(torch.add(y, k3, alpha=dt), params)
    incr = torch.add(k1, k2, alpha=2.0).add_(k3, alpha=2.0).add_(k4)
    return torch.add(y, incr, alpha=dt / 6.0)


def _rk4_states(field, y0, dt, n_steps, params, keep, remat):
    """The states after the steps in ``keep`` (a set of step indices, 0 =
    y0), in increasing order."""
    states = [y0] if 0 in keep else []
    y = y0
    for i in range(1, n_steps + 1):
        if remat:
            y = checkpoint(_rk4_step, field, y, dt, params, use_reentrant=False)
        else:
            y = _rk4_step(field, y, dt, params)
        if i in keep:
            states.append(y)
    return states


def rk4_integrate(vector_field, y0, dt, n_steps, params=None, remat=False):
    """Integrate dy/dt = f(y, params) for ``n_steps`` steps of ``dt``.
    Returns the trajectory (n_steps + 1, ..., state_dim), y0 first."""
    return torch.stack(_rk4_states(vector_field, y0, dt, n_steps, params,
                                   set(range(n_steps + 1)), remat))


def lotka_volterra_field(y, theta):
    """Predator–prey: dx = αx − βxy, dy = δxy − γy; θ = log(α, β, γ, δ)."""
    alpha, beta, gamma, delta = torch.exp(theta).unbind(-1)
    x, z = y[..., 0], y[..., 1]
    return torch.stack([alpha * x - beta * x * z, delta * x * z - gamma * z], dim=-1)


def lotka_volterra_log_field(z, theta):
    """LV in log-population coordinates z = log(x, y):
    dz₁ = α − β e^{z₂}, dz₂ = δ e^{z₁} − γ (positive and bounded for every
    prior draw)."""
    alpha, beta, gamma, delta = torch.exp(theta).unbind(-1)
    return torch.stack([alpha - beta * torch.exp(z[..., 1]),
                        delta * torch.exp(z[..., 0]) - gamma], dim=-1)


def _lv_log_stage(z, coeffs):
    """``lotka_volterra_log_field`` from the rates as (c, s) = ((α, −γ),
    (−β, δ)): dz = c + s · swap(e^z), one multiply-add."""
    c, s = coeffs
    return torch.addcmul(c, s, torch.exp(z).flip(-1))


def make_lotka_volterra_forward(y0, dt, n_steps, obs_indices, obs_species=(0, 1),
                                remat=False):
    """Forward map θ (..., 4) log-rates → the populations at the time
    indices ``obs_indices`` (into the n_steps + 1 states) and ``obs_species``,
    flattened time-major: (..., len(obs_indices) · len(obs_species))."""
    z0 = torch.log(torch.as_tensor(np.asarray(y0, np.float32)))
    obs = [int(i) for i in np.asarray(obs_indices)]
    if min(obs) < 0 or max(obs) > n_steps:
        raise ValueError(f"obs_indices must lie in [0, {n_steps}], got {obs}")
    order = sorted(set(obs))
    pick = [order.index(i) for i in obs]
    species = list(obs_species)

    def forward(theta):
        rates = torch.exp(theta)
        alpha, beta, gamma, delta = rates.unbind(-1)
        coeffs = (torch.stack([alpha, -gamma], dim=-1),
                  torch.stack([-beta, delta], dim=-1))
        z = z0.to(theta).expand(rates.shape[:-1] + (2,))
        states = torch.stack(_rk4_states(_lv_log_stage, z, dt, n_steps, coeffs,
                                         set(order), remat), dim=-2)
        pred = torch.exp(states[..., pick, :][..., species])
        return pred.reshape(rates.shape[:-1] + (-1,))

    return forward


PLAIN = "lv_misfit_plain"  # the plain version's launch count


class LotkaVolterraMisfit:
    """Φ(θ) = ½‖(y − G(θ)) / σ‖² of the Lotka–Volterra forward
    (``make_lotka_volterra_forward``) for (..., 4) log-rates. On a CUDA
    tensor it runs ``ops/lv_rk4.py``'s kernel, which gives Φ and ∇Φ of every
    chain in one launch (autograd reaches ∇Φ through
    ``LvMisfitFunction``); on a CPU tensor the plain version,
    ``potentials.misfit_potential`` of the forward, differentiated by
    autograd through the RK4 loop. ``noise`` is a ``DiagGaussian`` of zero
    mean."""

    def __init__(self, y0, dt, n_steps, obs_indices, data, noise, obs_species=(0, 1)):
        self.plain = potentials.misfit_potential(
            make_lotka_volterra_forward(y0, dt, n_steps, obs_indices, obs_species), data, noise)
        self.spec = lv_rk4.LvSpec.build(y0, dt, n_steps, obs_indices, obs_species,
                                        torch.as_tensor(data).cpu().numpy(),
                                        noise.scale.cpu().numpy(), noise.scale.device)

    def __call__(self, theta):
        if theta.device.type == "cuda":
            lead = theta.shape[:-1]
            phi = lv_rk4.LvMisfitFunction.apply(theta.reshape(-1, 4), self.spec)
            return phi.reshape(lead)
        if theta.device.type != "cpu":
            raise ValueError(f"LotkaVolterraMisfit: unsupported device {theta.device}")
        _build.launch_counts[PLAIN] += 1
        return self.plain(theta)

    def plain_value_and_grad(self, theta):
        """Φ and ∇Φ of the plain version on ``theta``'s device, by autograd
        through the RK4 loop: the kernel's reference on the card."""
        _build.launch_counts[PLAIN] += 1
        with torch.enable_grad():
            x = theta.detach().requires_grad_(True)
            phi = self.plain(x)
            (grad,) = torch.autograd.grad(phi.sum(), x)
        return phi.detach(), grad


def logistic_field(y, theta):
    """Logistic growth dy = r y (1 − y/K); θ = log(r, K)."""
    r, K = torch.exp(theta).unbind(-1)
    return (r * y[..., 0] * (1.0 - y[..., 0] / K))[..., None]


def make_logistic_forward(y0, dt, n_steps, obs_indices, remat=False):
    """Forward map θ (..., 2) → the states at ``obs_indices``: (..., m)."""
    y0 = torch.as_tensor(np.asarray(y0, np.float32)).reshape(-1)
    obs = [int(i) for i in np.asarray(obs_indices)]

    def forward(theta):
        y = y0.to(theta).expand(theta.shape[:-1] + y0.shape)
        traj = rk4_integrate(logistic_field, y, dt, n_steps, params=theta, remat=remat)
        return traj[obs].movedim(0, -2).reshape(theta.shape[:-1] + (-1,))

    return forward
