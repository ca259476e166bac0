"""The functional ensemble sampler with its walkers sharded over 'chains'
(mirrors ``ip_mcmc_tpu/parallel/fes_shard.py``).

The stretch move is FES's only coupling between walkers, and it reads a
partner only through its first M whitened coordinates. So each step
``all_gather``-s just the (H, M) low-mode block of the opposite half (two
gathers a step, 2·H·M floats), and everything else (the potentials, the
pCN move on the complement, the accept tests) stays on the walker's rank.
The order is the unsharded kernel's (``kernels/ensemble.py``): half A
stretches against B before the step, half B against the new A, then pCN
moves the complement of both halves.

Every draw is a function of (seed, step, global walker id) only (the
counter-hash stream of ``ops/rng.py``; half A's walkers are 0..H−1, half
B's H..2H−1), so the walkers' paths do not depend on the number of ranks.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ip_mcmc_tpu_torch.kernels.base import count_step
from ip_mcmc_tpu_torch.ops import rng
from ip_mcmc_tpu_torch.parallel.mesh import Mesh, gather_chains

# counter-hash tags: the partner, the stretch factor, the stretch MH
# uniform; the pCN normals (two, Box–Muller) and its MH uniform
_TAG_PICK, _TAG_Z, _TAG_U, _TAG_XI, _TAG_UPCN = 0, 1, 2, 3, 5


_uniform = rng.chain_uniforms


def sample_fes_sharded(potential_fn, prior, *, mesh: Mesh, u0, seed, n_low_modes, n_samples,
                       burn_in=0, thin=1, stretch_a=2.0, pcn_beta=0.2):
    """FES over the mesh's 'chains' axis. ``u0`` (L, d) walkers, the same
    on every rank, L even and L/2 divisible by the chain groups (each rank
    holds equal blocks of both halves); ``potential_fn`` (n, d) → (n,);
    ``prior`` the diagonal whitening prior (``mean``, ``scale``). Returns
    (samples (n_samples, L, d), {"stretch_accept", "pcn_accept"}: the
    acceptance means over every step and walker)."""
    L, d = u0.shape
    if L % 2:
        raise ValueError(f"need an even walker count, got {L}")
    H = L // 2
    n_dev = mesh.shape[0]
    if H % n_dev:
        raise ValueError(f"half-ensemble size {H} must be divisible by the mesh size {n_dev}")
    M = int(n_low_modes)
    if not 0 < M <= d:
        raise ValueError(f"n_low_modes must be in (0, {d}], got {M}")
    a = float(stretch_a)
    dev = mesh.device
    beta = torch.tensor(pcn_beta, dtype=torch.float32, device=dev)
    shrink = torch.sqrt(1.0 - beta * beta)
    mean = torch.as_tensor(prior.mean, dtype=torch.float32).to(dev)
    scale = torch.as_tensor(prior.scale, dtype=torch.float32).to(dev)
    h = H // n_dev
    lo = mesh.chains_index * h
    u0 = torch.as_tensor(u0, dtype=torch.float32).to(dev)
    pa, pb = u0[lo:lo + h], u0[H + lo:H + lo + h]
    gid_a = torch.arange(lo, lo + h, dtype=torch.int64, device=dev)
    gid_b = H + gid_a

    def whiten(u):
        return (u - mean) / scale

    def half_stretch(t, movers, movers_phi, anchors_low_loc, gids):
        anchors_low = gather_chains(anchors_low_loc, mesh)  # the step's collective: (H, M)
        pick = torch.clamp((_uniform(seed, t, _TAG_PICK, gids) * H).to(torch.int64), max=H - 1)
        z = torch.square((a - 1.0) * _uniform(seed, t, _TAG_Z, gids) + 1.0) / a
        log_u = torch.log(_uniform(seed, t, _TAG_U, gids))
        w_m = whiten(movers)
        w_p_low = anchors_low[pick]
        v_low = w_p_low + z[:, None] * (w_m[:, :M] - w_p_low)
        v = mean + scale * torch.cat([v_low, w_m[:, M:]], dim=1)
        phi_v = potential_fn(v)
        d_prior = 0.5 * (torch.sum(torch.square(v_low), dim=1)
                         - torch.sum(torch.square(w_m[:, :M]), dim=1))
        log_ratio = (M - 1) * torch.log(z) - (phi_v - movers_phi) - d_prior
        log_ratio = torch.where(torch.isnan(log_ratio), torch.full_like(log_ratio, -torch.inf),
                                log_ratio)
        acc = log_u < log_ratio
        return torch.where(acc[:, None], v, movers), torch.where(acc, phi_v, movers_phi), acc

    def pcn_complement(t, pos, phi, gids):
        xi = rng.chain_normals(seed, t, _TAG_XI, gids, d)
        log_u = torch.log(_uniform(seed, t, _TAG_UPCN, gids))
        w = whiten(pos)
        v = mean + scale * torch.cat([w[:, :M], shrink * w[:, M:] + beta * xi[:, M:]], dim=1)
        phi_v = potential_fn(v)
        log_ratio = phi - phi_v  # prior-reversible: only Φ in the ratio
        log_ratio = torch.where(torch.isnan(log_ratio), torch.full_like(log_ratio, -torch.inf),
                                log_ratio)
        acc = log_u < log_ratio
        return torch.where(acc[:, None], v, pos), torch.where(acc, phi_v, phi), acc

    phia, phib = potential_fn(pa), potential_fn(pb)
    counts = torch.zeros(2, dtype=torch.float64, device=dev)
    kept_a, kept_b = [], []
    total = burn_in + n_samples * thin
    for t in range(total):
        count_step("scan_fes_sharded_step", dev)
        pa, phia, sa = half_stretch(t, pa, phia, whiten(pb)[:, :M], gid_a)
        pb, phib, sb = half_stretch(t, pb, phib, whiten(pa)[:, :M], gid_b)
        pa, phia, ca = pcn_complement(t, pa, phia, gid_a)
        pb, phib, cb = pcn_complement(t, pb, phib, gid_b)
        counts += torch.stack([torch.sum(sa) + torch.sum(sb),
                               torch.sum(ca) + torch.sum(cb)]).to(torch.float64)
        if t >= burn_in and (t - burn_in + 1) % thin == 0:
            kept_a.append(pa)
            kept_b.append(pb)
    samples = torch.cat([gather_chains(torch.stack(kept_a[:n_samples]), mesh, axis=1),
                         gather_chains(torch.stack(kept_b[:n_samples]), mesh, axis=1)], dim=1)
    dist.all_reduce(counts, group=mesh.chains_group)
    rates = (counts / (total * L)).to(torch.float32)
    return samples, {"stretch_accept": rates[0], "pcn_accept": rates[1]}


__all__ = ["sample_fes_sharded"]
