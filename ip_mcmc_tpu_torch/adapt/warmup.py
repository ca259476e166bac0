"""Warm-up drivers of the scan path (mirrors ``ip_mcmc_tpu/adapt/warmup.py``
``warmup_rwm``, ``warmup_pcn``, ``warmup_mala``, ``warmup_hmc``,
``warmup_nuts`` and ``map_localize``): the acceptance signal and the proposal covariance or
mass matrix are pooled across chains every step; the kernel is rebuilt
each step around the current hyper-parameters (tensors on the device, so
no step waits for the host); adaptation is frozen afterwards."""

from __future__ import annotations

import torch

from ip_mcmc_tpu_torch.adapt import dual_averaging as da
from ip_mcmc_tpu_torch.kernels import hmc, mala, nuts, pcn, rwm


def _pooled_cov(positions, jitter=1e-6):
    """Cross-chain empirical covariance, plus ``jitter`` on the diagonal."""
    centered = positions - torch.mean(positions, dim=0)
    cov = centered.T @ centered / (positions.shape[0] - 1)
    return cov + jitter * torch.eye(cov.shape[0], dtype=cov.dtype,
                                    device=cov.device)


def _cholesky(cov):
    """Lower Cholesky factor, NaN where the factorisation fails (as JAX's
    ``cholesky``); ``cholesky_ex`` reports failure in a tensor instead of
    raising, so the step does not synchronise with the host."""
    chol, info = torch.linalg.cholesky_ex(cov)
    return torch.where(info == 0, chol, torch.full_like(chol, torch.nan))


def warmup_rwm(log_density_fn, state, generator, num_steps=500,
               initial_step_size=0.5, target_accept=0.234, adapt_cov=True):
    """Adapt the RWM step size (dual averaging on the pooled acceptance) and
    a dense proposal covariance (cross-chain). Returns (state, step_size,
    chol)."""
    dev = state.position.device
    das = da.init(initial_step_size, dev)
    chol = torch.eye(state.position.shape[1], dtype=state.position.dtype,
                     device=dev)
    for _ in range(num_steps):
        kernel = rwm.build_kernel(log_density_fn, step_size=da.current(das),
                                  scale=chol)
        state, info = kernel(generator, state)
        das = da.update(das, torch.mean(info.accept_prob), target=target_accept)
        if adapt_cov:
            chol = _cholesky(_pooled_cov(state.position))
    return state, da.final(das), chol


def warmup_pcn(potential_fn, prior, state, generator, num_steps=500,
               initial_beta=0.2, target_accept=0.234):
    """Adapt pCN β on the pooled acceptance; β = sigmoid(z) stays in
    (0, 1). Returns (state, beta)."""
    dev = state.position.device
    z0 = torch.log(torch.tensor(initial_beta / (1.0 - initial_beta),
                                dtype=torch.float32, device=dev))
    das = da.init(1.0, dev)
    das = da.DAState(log_x=z0, log_x_avg=z0, h_avg=das.h_avg, t=das.t, mu=z0)
    for _ in range(num_steps):
        kernel = pcn.build_kernel(potential_fn, prior,
                                  beta=torch.sigmoid(das.log_x))
        state, info = kernel(generator, state)
        das = da.update(das, torch.mean(info.accept_prob), target=target_accept)
    return state, torch.sigmoid(das.log_x_avg)


def _variance_inv_mass(positions, jitter=1e-6):
    """Diagonal M⁻¹ from the cross-chain variances (population variance,
    as ``jnp.var``)."""
    return 1.0 / (torch.var(positions, dim=0, unbiased=False) + jitter)


def map_localize(log_density_fn, positions, num_steps=200, learning_rate=0.05):
    """Move each chain towards a posterior mode by Adam ascent on log π
    before the warm-up (optax's ``adam`` defaults: β 0.9 / 0.999, ε 1e-8).
    Adam is elementwise, so one optimiser over the (n, d) leaf is JAX's
    ``vmap`` of one optimiser a chain. Returns the moved positions."""
    p = positions.detach().clone().requires_grad_(True)
    opt = torch.optim.Adam([p], lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)
    with torch.enable_grad():
        for _ in range(num_steps):
            opt.zero_grad(set_to_none=True)
            (-log_density_fn(p)).sum().backward()
            opt.step()
    return p.detach()


def warmup_mala(log_density_fn, state, generator, num_steps=500,
                initial_step_size=0.05, target_accept=0.574):
    """Adapt the MALA step size (dual averaging) and a dense preconditioner
    Σ = L Lᵀ from the cross-chain covariance. Returns (state, step_size,
    chol)."""
    dev = state.position.device
    das = da.init(initial_step_size, dev)
    chol = torch.eye(state.position.shape[1], dtype=state.position.dtype,
                     device=dev)
    for _ in range(num_steps):
        kernel = mala.build_kernel(log_density_fn, step_size=da.current(das),
                                   precond=chol)
        state, info = kernel(generator, state)
        das = da.update(das, torch.mean(info.accept_prob), target=target_accept)
        chol = _cholesky(_pooled_cov(state.position))
    return state, da.final(das), chol


def warmup_hmc(log_density_fn, state, generator, num_steps=300,
               num_integration_steps=8, initial_step_size=0.1, target_accept=0.8):
    """Adapt the HMC step size (dual averaging) and a diagonal mass from the
    cross-chain variances. Returns (state, step_size, inv_mass)."""
    dev = state.position.device
    das = da.init(initial_step_size, dev)
    inv_mass = torch.ones(state.position.shape[1], dtype=state.position.dtype,
                          device=dev)
    for _ in range(num_steps):
        kernel = hmc.build_kernel(log_density_fn, step_size=da.current(das),
                                  num_integration_steps=num_integration_steps,
                                  inv_mass=inv_mass)
        state, info = kernel(generator, state)
        das = da.update(das, torch.mean(info.accept_prob), target=target_accept)
        inv_mass = _variance_inv_mass(state.position)
    return state, da.final(das), inv_mass


def warmup_nuts(log_density_fn, state, generator, num_steps=300, max_depth=8,
                initial_step_size=0.1, target_accept=0.8):
    """Adapt the NUTS step size (dual averaging on the chains' mean leaf
    acceptance) and a diagonal mass from the cross-chain variances. Returns
    (state, step_size, inv_mass)."""
    dev = state.position.device
    das = da.init(initial_step_size, dev)
    inv_mass = torch.ones(state.position.shape[1], dtype=state.position.dtype,
                          device=dev)
    for _ in range(num_steps):
        kernel = nuts.build_kernel(log_density_fn, step_size=da.current(das),
                                   max_depth=max_depth, inv_mass=inv_mass)
        state, info = kernel(generator, state)
        das = da.update(das, torch.mean(info.accept_prob), target=target_accept)
        inv_mass = _variance_inv_mass(state.position)
    return state, da.final(das), inv_mass
