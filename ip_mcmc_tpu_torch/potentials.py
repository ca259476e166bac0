"""Potentials of the scan path (mirrors ``ip_mcmc_tpu/potentials.py``:
``analytic_potential``, ``misfit_potential``, ``posterior_log_density``).

A potential here is a plain function of a position (d,) or of an (n, d)
batch of chains, returning a scalar or (n,): the JAX package's single-
particle functions with the chain axis written out instead of ``vmap``-ed.
Φ(u) = ½‖Γ^{-1/2}(y − O(G(u)))‖².
"""

from __future__ import annotations

import torch


def analytic_potential(log_density_fn):
    """Φ = −log π for a closed-form unnormalised log-density."""

    def phi(u):
        return -log_density_fn(u)

    return phi


def misfit_potential(forward_fn, data, noise, observation_fn=None):
    """Φ(u) = ½‖Γ^{-1/2}(y − O(G(u)))‖². ``noise``: a distribution with
    ``whiten`` (typically ``DiagGaussian(0, σ)``), or None for identity
    weighting; ``observation_fn``: an optional restriction O of the forward
    output."""
    data = torch.as_tensor(data)

    def phi(u):
        pred = forward_fn(u)
        if observation_fn is not None:
            pred = observation_fn(pred)
        if pred.shape[pred.dim() - data.dim():] != data.shape:
            raise ValueError(
                f"forward-model prediction shape {tuple(pred.shape)} does not "
                f"end in the data shape {tuple(data.shape)}; refusing to "
                "broadcast a misfit silently"
            )
        r = data - pred
        if noise is not None:
            r = noise.whiten(r + noise.mean)  # centre on the noise mean
        return 0.5 * torch.sum(torch.square(r), dim=tuple(range(-data.dim(), 0)))

    return phi


def posterior_log_density(potential_fn, prior):
    """log π(u) = −Φ(u) − Φ_prior(u), for the whole-space kernels (RWM);
    pCN keeps Φ and the prior apart."""

    def logpi(u):
        return -potential_fn(u) - prior.potential(u)

    return logpi
