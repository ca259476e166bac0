"""One sharded step on an n-rank chain mesh (the port's twin of the JAX
package's ``__graft_entry__.dryrun_multichip``): a pCN transition of a
chain batch sharded over the world on a small Darcy problem (8×8 grid, 16
KL modes), the pooled cross-chain statistics by ``all_reduce`` (the
adaptation signal), and a fused sampler launched on each rank's shard (on
the card its kernel, on the CPU the plain version). Every rank of the
world calls it; the port spawns no processes, so a world of n ranks must
be running (``mesh.distributed_init``), or, for n = 1, is started here.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ip_mcmc_tpu_torch import distributions, driver, potentials
from ip_mcmc_tpu_torch.configs import gauss2d_batched_potential
from ip_mcmc_tpu_torch.kernels import pcn
from ip_mcmc_tpu_torch.models import darcy
from ip_mcmc_tpu_torch.ops import fused_rwm_chain
from ip_mcmc_tpu_torch.parallel.fused_shard import sharded_fused_chain
from ip_mcmc_tpu_torch.parallel.mesh import (gather_chains, make_chain_mesh,
                                             sample_chains_sharded, shard_chains)


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """Run the step on the chain mesh of ``n_devices`` ranks; returns the
    pooled statistics (the same on every rank) and raises if anything is
    not finite or not of its shape."""
    mesh = make_chain_mesh(n_devices=n_devices, device=device)
    dev = mesh.device
    n_chains = max(4 * n_devices, 8)
    fwd, aux = darcy.make_darcy_forward(n_grid=8, n_modes_per_dim=4, device=dev)
    K = 16
    prior = distributions.DiagGaussian(mean=torch.zeros(K, device=dev),
                                       scale=torch.ones(K, device=dev))
    host = torch.Generator().manual_seed(1)
    u_true = prior.sample(host, 1)[0]
    y = fwd(u_true)
    noise = distributions.DiagGaussian(mean=torch.zeros_like(y),
                                       scale=0.01 * torch.ones_like(y))
    y = y + noise.sample(host, 1)[0]
    phi = potentials.misfit_potential(fwd, y, noise)
    kernel = pcn.build_kernel(phi, prior, beta=0.2)
    state = driver.init_chains(pcn.init, prior.sample(host, n_chains), phi)

    gen = torch.Generator(dev).manual_seed(0)
    new_state, _, info = sample_chains_sharded(kernel, state, gen, mesh, n_samples=1)
    # the pooled statistics of the local rows, summed over 'chains'
    rows = shard_chains(new_state, mesh)
    sums = torch.cat([torch.sum(rows.position, dim=0),
                      torch.sum(rows.position * rows.position, dim=0)])
    dist.all_reduce(sums, group=mesh.chains_group)
    mean = sums[:K] / n_chains
    stats = {"pooled_accept": float(info.accept_prob[0]),
             "pooled_mean": mean.cpu().tolist(),
             "pooled_var": (sums[K:] / n_chains - mean * mean).cpu().tolist()}
    if new_state.position.shape != state.position.shape:
        raise RuntimeError("the sharded step changed the batch's shape")

    # a fused launch on each rank's shard (the linear-Gaussian RWM)
    block = 8
    positions = torch.zeros((n_devices * block, 2), dtype=torch.float32, device=dev)
    final, acc = sharded_fused_chain(fused_rwm_chain, mesh, gauss2d_batched_potential().to(dev),
                                     positions, seed=0, step_size=0.9, n_steps=5,
                                     block_chains=block)
    stats["fused_accept"] = float(acc.mean())
    check = torch.cat([final.reshape(-1), gather_chains(rows.position, mesh).reshape(-1)])
    if final.shape != positions.shape or not bool(torch.isfinite(check).all()) or not all(
            np.isfinite(v).all() for v in (stats["pooled_mean"], stats["pooled_var"])):
        raise RuntimeError(f"non-finite or misshapen output: {stats}")
    return stats
