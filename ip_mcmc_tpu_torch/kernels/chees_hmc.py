"""ChEES-HMC, scan path (mirrors ``ip_mcmc_tpu/kernels/chees_hmc.py``;
Hoffman, Radul & Sountsov, AISTATS 2021): jittered HMC on the whole (n, d)
batch of chains with one trajectory length τ shared by every chain, adapted
by Adam on the cross-chain ChEES criterion's gradient, the step size by dual
averaging on the pooled acceptance, both frozen after the warm-up.

A step integrates ⌈u·τ/ε⌉ leapfrog steps of the equal size u·τ/n_leap
(u: the step's Halton jitter, shared by the chains), so the count is one
host integer a step, read once; ε and τ stay f32 tensors on the chains'
device, so the ceiling falls as in JAX. Every gradient comes from autograd
through ``log_density_fn`` (on the ODE configs one launch of the
Lotka–Volterra kernel a leapfrog step); the final log density is the last
leapfrog's evaluation, where JAX evaluates the same point again."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ip_mcmc_tpu_torch.adapt import dual_averaging as da
from ip_mcmc_tpu_torch.kernels.base import count_step, normals, uniforms, value_and_grad


@dataclasses.dataclass
class CheesState:
    """Batch state: the chain is the leading axis."""

    positions: torch.Tensor  # (n, d)
    log_densities: torch.Tensor  # (n,)
    grads: torch.Tensor  # (n, d)


@dataclasses.dataclass
class CheesInfo:
    accept_prob: torch.Tensor  # (n,)
    accepted: torch.Tensor  # (n,) bool
    final_velocity: torch.Tensor  # (n, d): feeds the ChEES gradient
    proposal: torch.Tensor  # (n, d)


def init(positions, log_density_fn):
    ld, g = value_and_grad(log_density_fn)(positions)
    return CheesState(positions=positions, log_densities=ld, grads=g)


def halton(i: int) -> float:
    """The base-2 radical inverse (van der Corput) of i + 1, added in f32
    over 32 digits as JAX's ``halton`` adds it: the step's trajectory
    jitter (an f32 value, as a Python float)."""
    acc, denom, m = np.float32(0.0), np.float32(0.5), (int(i) + 1) & 0xFFFFFFFF
    for _ in range(32):
        acc = np.float32(acc + np.float32(m % 2) * denom)
        denom = np.float32(denom * np.float32(0.5))
        m //= 2
    return float(acc)


def batch_step(log_density_fn, state, step_size, trajectory_length, jitter_u, inv_mass,
               z, u):
    """One jittered-HMC transition of the whole batch from the standard
    normals ``z`` (n, d) of the momenta and the MH uniforms ``u`` (n,):
    n_leap = max(⌈u·τ/ε⌉, 1) leapfrog steps of u·τ / n_leap, each chain
    Metropolis-corrected. ``step_size`` and ``trajectory_length`` are f32
    tensors (or floats), ``inv_mass`` (d,) or None. Returns (CheesState,
    CheesInfo)."""
    x0 = state.positions
    vg = value_and_grad(log_density_fn)
    if inv_mass is None:
        inv_mass = torch.ones(x0.shape[1], dtype=x0.dtype, device=x0.device)
    sqrt_mass = 1.0 / torch.sqrt(inv_mass)
    traj = jitter_u * torch.as_tensor(trajectory_length, dtype=x0.dtype, device=x0.device)
    n_leap_t = torch.clamp(torch.ceil(traj / step_size).to(torch.int32), min=1)
    n_leap = int(n_leap_t)  # the step's one host read
    # exactly time u·τ in n_leap equal steps of at most ε: the dynamics is
    # continuous in τ, which makes the ChEES gradient meaningful
    eps = traj / n_leap_t.to(traj.dtype)
    p0 = sqrt_mass[None, :] * z
    x, p, g = x0, p0, state.grads
    for _ in range(n_leap):
        p_half = p + 0.5 * eps * g
        x = x + eps * inv_mass[None, :] * p_half
        ld1, g = vg(x)
        p = p_half + 0.5 * eps * g

    kin0 = 0.5 * torch.sum(inv_mass[None, :] * p0 * p0, dim=1)
    kin1 = 0.5 * torch.sum(inv_mass[None, :] * p * p, dim=1)
    log_ratio = (ld1 - kin1) - (state.log_densities - kin0)
    log_ratio = torch.where(torch.isnan(log_ratio), -torch.inf, log_ratio)
    accept_prob = torch.exp(torch.clamp(log_ratio, max=0.0))
    accepted = torch.log(u) < log_ratio
    sel = accepted[:, None]
    new_state = CheesState(positions=torch.where(sel, x, x0),
                           log_densities=torch.where(accepted, ld1, state.log_densities),
                           grads=torch.where(sel, g, state.grads))
    info = CheesInfo(accept_prob=accept_prob, accepted=accepted,
                     final_velocity=inv_mass[None, :] * p, proposal=x)
    return new_state, info


def chees_gradient(state, info, jitter_u):
    """Monte-Carlo ∂ChEES/∂τ over the chain axis from the PRE-step state
    (the estimator contrasts the proposals with the positions the
    trajectories started from). A diverged trajectory (a non-finite
    proposal or velocity) is left out: its weight is 0 and its terms the
    start's."""
    x, xp, v = state.positions, info.proposal, info.final_velocity
    ok = torch.all(torch.isfinite(xp) & torch.isfinite(v), dim=1)
    xp = torch.where(ok[:, None], xp, x)
    v = torch.where(ok[:, None], v, 0.0)
    w = torch.where(ok, info.accept_prob, 0.0)
    xbar = torch.mean(x, dim=0)
    xpbar = torch.mean(xp, dim=0)
    dsq = torch.sum((xp - xpbar) ** 2, dim=1) - torch.sum((x - xbar) ** 2, dim=1)
    proj = torch.sum((xp - xpbar) * v, dim=1)
    num = torch.mean(w * dsq * proj) * jitter_u
    return num / torch.clamp(torch.mean(w), min=1e-6)


@dataclasses.dataclass
class AdamState:
    log_value: torch.Tensor
    m: torch.Tensor
    v: torch.Tensor
    t: torch.Tensor


def adam_init(value, device="cpu"):
    z = torch.zeros((), dtype=torch.float32, device=device)
    return AdamState(log_value=torch.log(torch.tensor(value, dtype=torch.float32,
                                                      device=device)),
                     m=z, v=z, t=z)


def adam_ascend(s, grad, lr=0.025, b1=0.9, b2=0.999, eps=1e-8):
    """One Adam ascent step on log τ (JAX's own Adam, not ``torch.optim``)."""
    t = s.t + 1.0
    m = b1 * s.m + (1.0 - b1) * grad
    v = b2 * s.v + (1.0 - b2) * grad * grad
    mhat = m / (1.0 - b1 ** t)
    vhat = v / (1.0 - b2 ** t)
    return AdamState(log_value=s.log_value + lr * mhat / (torch.sqrt(vhat) + eps),
                     m=m, v=v, t=t)


def step(log_density_fn, state, generator, step_idx, step_size, trajectory_length,
         inv_mass):
    """``batch_step`` at global step ``step_idx`` (its Halton jitter), the
    draws from ``generator``; counts one ``scan_chees_step``."""
    pos = state.positions
    count_step("scan_chees_step", pos.device)
    z = normals(generator, pos.shape, pos.device)
    u = uniforms(generator, pos.shape[:1], pos.device)
    return batch_step(log_density_fn, state, step_size, trajectory_length, halton(step_idx),
                      inv_mass, z, u)


def warmup_chees(log_density_fn, positions, generator, num_steps=400, initial_step_size=0.1,
                 initial_trajectory=1.0, target_accept=0.651, adapt_mass=True):
    """Joint warm-up: ε by dual averaging on the pooled acceptance (capped
    at τ), τ by Adam on the ChEES gradient, the diagonal M⁻¹ from the
    cross-chain variances. Returns (state, step_size, trajectory_length,
    inv_mass), all frozen."""
    state = init(positions, log_density_fn)
    dev = positions.device
    das = da.init(initial_step_size, dev)
    adam = adam_init(initial_trajectory, dev)
    inv_mass = torch.ones(positions.shape[1], dtype=positions.dtype, device=dev)
    for i in range(num_steps):
        u = halton(i)
        tau = torch.exp(adam.log_value)
        pre = state  # the gradient contrasts the proposals with the pre-step positions
        state, info = step(log_density_fn, state, generator, i,
                           torch.minimum(da.current(das), tau), tau, inv_mass)
        das = da.update(das, torch.mean(info.accept_prob), target=target_accept)
        adam = adam_ascend(adam, chees_gradient(pre, info, u))
        if adapt_mass:
            inv_mass = torch.var(state.positions, dim=0, unbiased=False) + 1e-6
    tau = torch.exp(adam.log_value)
    return state, torch.minimum(da.final(das), tau), tau, inv_mass


def sample_chees(log_density_fn, state, generator, step_size, trajectory_length,
                 inv_mass=None, *, n_samples, burn_in=0, thin=1):
    """Sampling with (ε, τ) frozen. Returns (state, samples (n_samples, n,
    d), info means): each info field's chain mean (f32) of every thin
    group's last step, stacked."""
    for i in range(burn_in):
        state, _ = step(log_density_fn, state, generator, i, step_size, trajectory_length,
                        inv_mass)
    samples, means = [], []
    for s in range(n_samples):
        for k in range(thin):
            state, info = step(log_density_fn, state, generator, burn_in + s * thin + k,
                               step_size, trajectory_length, inv_mass)
        samples.append(state.positions)
        means.append({f.name: torch.mean(getattr(info, f.name).to(torch.float32), dim=0)
                      for f in dataclasses.fields(info)})
    info_means = CheesInfo(**{k: torch.stack([m[k] for m in means]) for k in means[0]})
    return state, torch.stack(samples), info_means
