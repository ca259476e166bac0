"""Fused samplers on a chain shard of each rank (mirrors
``ip_mcmc_tpu/parallel/fused_shard.py``).

A fused sampler (an ``ops.fused_*`` entry point) runs all its chains on one
device. Here each rank launches it on its rows of the (n, d) positions
with its own seed, ``seed + flat_rank · SEED_STRIDE`` (rank 0's is
``seed``), so rank r's shard is, bit for bit, a single-process run of
those chains with that seed: on the card the CUDA kernels, on the CPU
their plain versions. The chains do not talk while they run; the outputs
are ``all_gather``-ed along their chain axis afterwards (axis 1 of the
recorded samples (n_rec, n, d), axis 0 of everything else), so every rank
holds the whole run, as JAX's global view does.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ip_mcmc_tpu_torch.parallel.mesh import Mesh

SEED_STRIDE = 1_000_003  # decorrelates the ranks' counter-hash streams


def _gather(x, group, n_parts):
    x = x.contiguous()
    axis = 1 if x.dim() == 3 else 0
    parts = [torch.empty_like(x) for _ in range(n_parts)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=axis)


def _run(fused_fn, potential_fn, positions, seed, flat, n_parts, group, kwargs):
    n = positions.shape[0]
    if n % n_parts:
        raise ValueError(f"n_chains {n} must divide over {n_parts} devices")
    per = n // n_parts
    block = kwargs.get("block_chains", 256)
    if per % block:
        raise ValueError(
            f"per-device chains {per} must be a multiple of block_chains {block}")
    local = positions[flat * per:(flat + 1) * per].contiguous()
    out = fused_fn(potential_fn, local, seed=int(seed) + flat * SEED_STRIDE, **kwargs)
    return tuple(_gather(o, group, n_parts) for o in out)


def sharded_fused_chain(fused_fn, mesh: Mesh, potential_fn, positions, *, seed, **kwargs):
    """Run ``fused_fn(potential_fn, rows, seed=..., **kwargs)`` on this
    rank's rows of ``positions`` (n, d) over a chain mesh; returns the
    (final positions, acceptance[, extra][, samples]) of all n chains."""
    if mesh.shape[1] != 1:
        raise ValueError(f"a chain mesh has shape (n, 1), got {mesh.shape}: use "
                         "sharded_fused_chain_composed on a composed mesh")
    return _run(fused_fn, potential_fn, positions, seed, mesh.chains_index,
                mesh.shape[0], mesh.chains_group, kwargs)


def sharded_fused_chain_composed(fused_fn, mesh: Mesh, potential_fn, positions, *, seed,
                                 **kwargs):
    """The same on a ('chains', 'model') mesh used as one flat pool of
    chains: the chains shard over both axes, rank (i, j) runs its rows with
    ``seed + (i·n_model + j)·SEED_STRIDE`` (its world rank), and the
    outputs gather over the whole world."""
    return _run(fused_fn, potential_fn, positions, seed, mesh.rank, mesh.size, None, kwargs)
