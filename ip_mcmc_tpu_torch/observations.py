"""Observation operators O: the forward solve's output restricted to the
observed points and times (mirrors ``ip_mcmc_tpu/observations.py``).
Static index gathers and one matrix product, on the device of the tensor
they are given; chains lead, as everywhere in the port."""

from __future__ import annotations

import numpy as np
import torch


def _index(indices):
    return torch.as_tensor(np.asarray(indices), dtype=torch.long)


def point_observation(indices):
    """O(x) = x[..., indices]: point values at fixed locations."""
    idx = _index(indices)

    def observe(x):
        return x[..., idx.to(x.device)]

    return observe


def time_point_observation(time_indices, space_indices=None):
    """For a trajectory (..., T, n): the chosen times (and, optionally,
    locations), flattened."""
    t_idx = _index(time_indices)
    s_idx = None if space_indices is None else _index(space_indices)

    def observe(traj):
        out = traj[..., t_idx.to(traj.device), :]
        if s_idx is not None:
            out = out[..., s_idx.to(traj.device)]
        return out.reshape(*out.shape[:-2], -1)

    return observe


def linear_observation(weights):
    """O(x) = W x: a bounded linear functional a row of ``weights`` (local
    averages, sensors with a footprint)."""
    w = torch.as_tensor(np.asarray(weights.cpu() if torch.is_tensor(weights) else weights),
                        dtype=torch.float32)

    def observe(x):
        return x @ w.to(x.device).T

    return observe


def subsample_grid_2d(n_grid, n_obs_per_dim):
    """Flattened indices of an evenly spaced interior grid of observation
    points on an n × n field (``models.darcy.default_observation_indices``)."""
    pos = np.linspace(0, n_grid - 1, n_obs_per_dim + 2)[1:-1].round().astype(int)
    ii, jj = np.meshgrid(pos, pos, indexing="ij")
    return (ii * n_grid + jj).ravel()
