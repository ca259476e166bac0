"""Distributed systematic resampling (mirrors
``ip_mcmc_tpu/parallel/resample.py``).

Each rank holds its shard of the particles and their log-weights. The
weights are ``all_gather``-ed over 'chains' (n floats), every rank computes
the same global ancestry with ``smc.systematic_resample`` (a pure function
of the uniform and the weights), the particles are ``all_gather``-ed, and
each rank keeps the rows of its own shard of the new generation. The result
is the serial resampling's, bit for bit, on any mesh.
"""

from __future__ import annotations

import torch

from ip_mcmc_tpu_torch.parallel.mesh import Mesh, gather_chains
from ip_mcmc_tpu_torch.smc import systematic_resample


def distributed_systematic_resample(u0, log_weights, particles, mesh: Mesh):
    """Resample this rank's ``particles`` (n_local, d) with its
    ``log_weights`` (n_local,) from the uniform ``u0`` in [0, 1/n) (the
    same on every rank, as ``smc.draw_u0`` gives it); returns this rank's
    (n_local, d) rows of the new generation. Shards of unequal size (an n
    that does not divide over the ranks) raise ``ValueError`` on every
    rank."""
    n_local = log_weights.shape[0]
    sizes = torch.tensor([n_local], dtype=torch.int64, device=log_weights.device)
    sizes = gather_chains(sizes, mesh)
    if bool(torch.any(sizes != n_local)):
        raise ValueError(
            f"n particles {int(sizes.sum())} not divisible by {mesh.shape[0]} ranks "
            f"(shards of {sizes.tolist()})")
    lw = gather_chains(log_weights, mesh)
    ancestors = systematic_resample(lw, u0)
    table = gather_chains(particles, mesh)
    lo = mesh.chains_index * n_local
    return table[ancestors[lo:lo + n_local]]


__all__ = ["distributed_systematic_resample"]
