"""Warm-up drivers of the scan path (mirrors ``ip_mcmc_tpu/adapt/warmup.py``
``warmup_rwm`` and ``warmup_pcn``): the acceptance signal and, for RWM, the
proposal covariance are pooled across chains every step; the kernel is
rebuilt each step around the current hyper-parameters (tensors on the
device, so no step waits for the host); adaptation is frozen afterwards."""

from __future__ import annotations

import torch

from ip_mcmc_tpu_torch.adapt import dual_averaging as da
from ip_mcmc_tpu_torch.kernels import pcn, rwm


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
