"""Variational inference: ADVI, mean-field and full-rank (mirrors
``ip_mcmc_tpu/vi.py``).

Maximises the ELBO L(λ) = E_q[log π(u) − log q_λ(u)] by the
reparameterisation u = μ + L z, z ~ N(0, I), the Monte Carlo gradient by
autograd through ``log_density_fn`` (a batch of samples at once) and Adam
under a cosine-decayed learning rate. The fitted family warm-starts MCMC
chains (``warm_start``). Each optimisation step counts one
``vi_step[device]`` step.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ip_mcmc_tpu_torch.kernels.base import count_step, normals

_LOG_2PI = math.log(2.0 * math.pi)


@dataclasses.dataclass
class MeanFieldParams:
    mu: torch.Tensor  # (d,)
    log_sigma: torch.Tensor  # (d,)


@dataclasses.dataclass
class FullRankParams:
    mu: torch.Tensor  # (d,)
    chol_flat: torch.Tensor  # (d(d+1)/2,) packed lower triangle, diagonal in log


def _unpack_chol(chol_flat, d):
    """L (d, d) from the packed lower triangle (row-major, as
    ``jnp.tril_indices``), its diagonal exponentiated."""
    rows, cols = torch.tril_indices(d, d, device=chol_flat.device)
    L = torch.zeros((d, d), dtype=chol_flat.dtype, device=chol_flat.device)
    L = L.index_put((rows, cols), chol_flat)
    diag = torch.diagonal(L)
    return L - torch.diag(diag) + torch.diag(torch.exp(diag))


def _sample_and_logq_meanfield(params, z):
    """u = μ + σ z and log q(u) for standard normals ``z`` (n, d)."""
    u = params.mu + torch.exp(params.log_sigma) * z
    log_q = torch.sum(-0.5 * z * z - params.log_sigma - 0.5 * _LOG_2PI, dim=-1)
    return u, log_q


def _sample_and_logq_fullrank(params, z):
    """u = μ + L z and log q(u) for standard normals ``z`` (n, d)."""
    d = params.mu.shape[0]
    L = _unpack_chol(params.chol_flat, d)
    u = params.mu + z @ L.T
    log_det = torch.sum(torch.log(torch.diagonal(L)))
    log_q = torch.sum(-0.5 * z * z, dim=-1) - log_det - 0.5 * d * _LOG_2PI
    return u, log_q


def _sampler(params):
    return (_sample_and_logq_meanfield if isinstance(params, MeanFieldParams)
            else _sample_and_logq_fullrank)


def cosine_decay(learning_rate, step, num_steps):
    """optax's ``cosine_decay_schedule(learning_rate, num_steps)`` at
    ``step`` (0 at the first update), in f32."""
    arg = np.float32(np.pi) * np.float32(min(step, num_steps)) / np.float32(num_steps)
    decay = np.float32(0.5) * (np.float32(1.0) + np.cos(arg))
    return float(np.float32(learning_rate) * decay)


def fit(log_density_fn, dim, generator, *, num_steps=2000, n_samples=64,
        learning_rate=5e-2, full_rank=False, init_mu=None, z=None):
    """Run ADVI. Returns (params, elbo_trace (num_steps,)).

    ``log_density_fn``: the unnormalised log posterior of an (n, d) batch.
    Step t draws its z (n_samples, d) from ``generator``, or takes ``z[t]``
    of a given ``z`` (num_steps, n_samples, d). Adam (β 0.9 / 0.999, ε 1e-8,
    as optax's) at the cosine-decayed rate of step t; the trace holds each
    step's ELBO estimate before its update. The parameters live on the
    generator's device."""
    dev = generator.device
    mu0 = (torch.zeros(dim, dtype=torch.float32, device=dev) if init_mu is None
           else torch.as_tensor(init_mu, dtype=torch.float32).to(dev))
    if full_rank:
        params = FullRankParams(mu=mu0.clone(),
                                chol_flat=torch.zeros(dim * (dim + 1) // 2, device=dev))
    else:
        params = MeanFieldParams(mu=mu0.clone(), log_sigma=torch.zeros(dim, device=dev))
    leaves = [getattr(params, f.name).requires_grad_(True)
              for f in dataclasses.fields(params)]
    sampler = _sampler(params)
    opt = torch.optim.Adam(leaves, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)
    trace = []
    with torch.enable_grad():
        for t in range(num_steps):
            count_step("vi_step", dev)
            zt = normals(generator, (n_samples, dim), dev) if z is None else z[t].to(dev)
            opt.param_groups[0]["lr"] = cosine_decay(learning_rate, t, num_steps)
            opt.zero_grad(set_to_none=True)
            u, log_q = sampler(params, zt)
            loss = -torch.mean(log_density_fn(u) - log_q)
            loss.backward()
            opt.step()
            trace.append(-loss.detach())
    params = type(params)(**{f.name: getattr(params, f.name).detach()
                             for f in dataclasses.fields(params)})
    return params, torch.stack(trace) if trace else torch.zeros(0, device=dev)


def posterior_moments(params):
    """(mean, covariance) of the fitted variational family."""
    if isinstance(params, MeanFieldParams):
        sigma = torch.exp(params.log_sigma)
        return params.mu, torch.diag(sigma * sigma)
    L = _unpack_chol(params.chol_flat, params.mu.shape[0])
    return params.mu, L @ L.T


def sample(params, generator, n_samples):
    """(n_samples, d) draws of the fitted family; z from ``generator`` on its
    own device, moved to the parameters'."""
    z = normals(generator, (n_samples, params.mu.shape[0]), params.mu.device)
    return _sampler(params)(params, z)[0]


def warm_start(params, generator, n_chains):
    """Chain initial positions from the fitted variational posterior: the
    VI → MCMC warm start."""
    return sample(params, generator, n_chains)
