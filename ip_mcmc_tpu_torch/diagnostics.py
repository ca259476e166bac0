"""Convergence diagnostics: multi-chain ESS and split-R̂ (mirrors
``ip_mcmc_tpu/diagnostics.py``; the same estimators as the NumPy oracle in
``tests/oracle``). Plain PyTorch on the samples' own device: FFT
autocovariance, Geyer initial monotone positive sequence, rank
normalization through ``torch.special.ndtri``."""

from __future__ import annotations

import torch


def _next_pow2(n: int) -> int:
    m = 1
    while m < n:
        m <<= 1
    return m


def autocovariance(x):
    """Biased autocovariance per chain via FFT. x: (n_steps, n_chains)."""
    n = x.shape[0]
    x = x - torch.mean(x, dim=0, keepdim=True)
    m = _next_pow2(2 * n)
    f = torch.fft.rfft(x, n=m, dim=0)
    acov = torch.fft.irfft(f * torch.conj(f), n=m, dim=0)[:n]
    return acov / n


def split_chains(x):
    """(n, c) -> (n//2, 2c): split each chain in half (Stan split-R̂)."""
    n = x.shape[0] - (x.shape[0] % 2)
    half = n // 2
    return torch.cat([x[:half], x[half:n]], dim=1)


def split_rhat(x):
    """Split-R̂ for one scalar parameter. x: (n_steps, n_chains)."""
    x = split_chains(x)
    n = x.shape[0]
    chain_means = torch.mean(x, dim=0)
    chain_vars = torch.var(x, dim=0, correction=1)
    between = n * torch.var(chain_means, correction=1)
    within = torch.mean(chain_vars)
    var_plus = (n - 1) / n * within + between / n
    return torch.sqrt(var_plus / within)


def _median(x):
    """Median of all elements, averaging the two middle values for an even
    count (``jnp.median``; ``torch.median`` returns the lower one)."""
    s = torch.sort(x.reshape(-1)).values
    k = s.numel()
    return s[k // 2] if k % 2 else 0.5 * (s[k // 2 - 1] + s[k // 2])


def _rank_normalize(x):
    """Fractional-rank inverse-normal transform (Blom offsets): pooled
    ranks over all draws → z-scores; ties get distinct ranks."""
    flat = x.reshape(-1)
    ranks = torch.argsort(torch.argsort(flat)) + 1
    z = torch.special.ndtri(
        (ranks.to(x.dtype) - 0.375) / (flat.numel() + 0.25)
    )
    return z.reshape(x.shape)


def rank_normalized_rhat(x):
    """Rank-normalized split-R̂, max of bulk and folded (tail) versions.
    x: (n_steps, n_chains)."""
    bulk = split_rhat(_rank_normalize(x))
    folded = split_rhat(_rank_normalize(torch.abs(x - _median(x))))
    return torch.maximum(bulk, folded)


def _per_param(fn, samples):
    """Apply a (n_steps, n_chains) -> scalar estimator per parameter, one
    parameter at a time (bounded peak memory)."""
    return torch.stack([fn(samples[:, :, i]) for i in range(samples.shape[2])])


def rank_rhat_per_param(samples):
    return _per_param(rank_normalized_rhat, samples)


def ess(x):
    """Multi-chain effective sample size for one scalar parameter.
    x: (n_steps, n_chains)."""
    x = split_chains(x)
    n, m = x.shape
    acov = autocovariance(x)
    chain_vars = acov[0] * n / (n - 1)
    mean_acov = torch.mean(acov, dim=1)
    within = torch.mean(chain_vars)
    chain_means = torch.mean(x, dim=0)
    between_over_n = torch.var(chain_means, correction=1)
    var_plus = (n - 1) / n * within + between_over_n
    rho = 1.0 - (within - mean_acov) / var_plus

    # Geyer paired sums P_k = rho_{2k} + rho_{2k+1}
    n_pairs = n // 2
    pairs = rho[: 2 * n_pairs].reshape(n_pairs, 2).sum(dim=1)
    # initial positive sequence: stop at the first non-positive pair (k >= 1)
    positive = pairs > 0.0
    positive[0] = True
    keep_pos = torch.cumprod(positive.to(torch.int32), dim=0) > 0
    # initial monotone sequence: running minimum
    pairs_mono = torch.cummin(pairs, dim=0).values
    pairs_used = torch.where(keep_pos, torch.minimum(pairs, pairs_mono), 0.0)
    pairs_used = torch.clamp(pairs_used, min=0.0)
    tau = -1.0 + 2.0 * torch.sum(pairs_used)
    floor = 1.0 / torch.log10(torch.tensor(n * m + 10.0, dtype=x.dtype,
                                           device=x.device))
    return n * m / torch.maximum(tau, floor)


def ess_per_param(samples):
    """ESS for each parameter. samples: (n_steps, n_chains, dim) -> (dim,)."""
    return _per_param(ess, samples)


def rhat_per_param(samples):
    return _per_param(split_rhat, samples)


def summarize(samples):
    """Posterior summary: mean/std per dim, ESS and R̂ per dim, min ESS,
    max R̂, max rank-normalized R̂. samples: (n_steps, n_chains, dim)."""
    flat = samples.reshape(-1, samples.shape[-1])
    e = ess_per_param(samples)
    r = rhat_per_param(samples)
    return {
        "mean": torch.mean(flat, dim=0),
        "std": torch.std(flat, dim=0, correction=0),
        "ess": e,
        "min_ess": torch.min(e),
        "rhat": r,
        "max_rhat": torch.max(r),
        "max_rank_rhat": torch.max(rank_rhat_per_param(samples)),
    }
