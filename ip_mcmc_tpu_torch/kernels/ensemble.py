"""Functional ensemble sampler, scan path (mirrors
``ip_mcmc_tpu/kernels/ensemble.py``: ``choose_n_low_modes``,
``build_kernel``, ``sample_fes``; Coullon & Webber 2020).

The walker ensemble is the chain axis. One transition: a red-black affine
stretch move (Goodman & Weare) on the first ``n_low_modes`` whitened KL
coordinates, the first half of the walkers against partners drawn from the
second half and then the second half against the moved first, each walker
accepted with log ratio (M − 1)·log z − (Φ(v) − Φ(u)) − ½Σ_{<M}(v² − w²);
then pCN on the remaining coordinates (only Φ in the ratio). The prior is a
diagonal Gaussian (the KL parameterisation of every config)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ip_mcmc_tpu_torch import driver
from ip_mcmc_tpu_torch.kernels.base import (
    contraction,
    count_step,
    nan_to_neg_inf,
    normals,
    uniforms,
)


def choose_n_low_modes(eigenvalues, energy_frac=0.9, min_modes=2,
                       max_modes=None):
    """Spectral-energy criterion for the stretch-move dimension: the
    smallest M whose leading-M KL eigenvalue mass reaches ``energy_frac``
    of the total spectrum. ``eigenvalues``: the KL spectrum of the
    underlying field, not the whitened prior scale (isotropic by
    construction). Returns a Python int."""
    lam = np.sort(np.asarray(eigenvalues, dtype=np.float64))[::-1]
    if lam.size == 0 or not np.all(np.isfinite(lam)) or np.any(lam < 0):
        raise ValueError("eigenvalues must be a finite nonnegative spectrum")
    total = lam.sum()
    if total <= 0:
        raise ValueError("eigenvalue spectrum sums to zero")
    frac = np.cumsum(lam) / total
    m = int(np.searchsorted(frac, energy_frac) + 1)
    m = max(m, int(min_modes))
    if max_modes is not None:
        m = min(m, int(max_modes))
    return min(m, int(lam.size))


@dataclasses.dataclass
class FESState:
    positions: torch.Tensor  # (L, d) walkers
    potentials: torch.Tensor  # (L,) cached Φ


@dataclasses.dataclass
class FESInfo:
    """Per walker: whether its stretch move and its pCN move were accepted
    (the JAX kernel reports their means; the driver takes them)."""

    stretch_accept: torch.Tensor  # (L,) f32
    pcn_accept: torch.Tensor  # (L,) f32


@dataclasses.dataclass
class FESDraws:
    """One transition's draws. Per half (a: the first L // 2 walkers, b:
    the rest): partner indices into the other half, the uniforms of the
    stretch factor z, and the MH uniforms; then the pCN normals (L, d) and
    MH uniforms (L,)."""

    pick_a: torch.Tensor
    z_a: torch.Tensor
    u_a: torch.Tensor
    pick_b: torch.Tensor
    z_b: torch.Tensor
    u_b: torch.Tensor
    xi: torch.Tensor
    u_pcn: torch.Tensor


def init(positions, potential_fn):
    return FESState(positions=positions, potentials=potential_fn(positions))


def build_kernel(potential_fn, prior, n_low_modes, stretch_a=2.0,
                 pcn_beta=0.2):
    """One FES transition of the whole ensemble (an even number of
    walkers; at least 2·``n_low_modes`` recommended)."""
    if not 0 < n_low_modes:
        raise ValueError(f"n_low_modes must be positive, got {n_low_modes}")
    M = int(n_low_modes)
    a = float(stretch_a)
    shrink = contraction(pcn_beta)

    def half_stretch(movers, movers_phi, anchors, pick, z_u, u):
        z = torch.square((a - 1.0) * z_u + 1.0) / a
        w_m = prior.whiten(movers)
        w_p = prior.whiten(anchors[pick])
        v_low = w_p[:, :M] + z[:, None] * (w_m[:, :M] - w_p[:, :M])
        v = prior.mean + prior.scale * torch.cat([v_low, w_m[:, M:]], dim=1)
        phi_v = potential_fn(v)
        # prior terms on the unchanged complement cancel; on the low block:
        d_prior = 0.5 * (torch.sum(torch.square(v_low), dim=1)
                         - torch.sum(torch.square(w_m[:, :M]), dim=1))
        log_ratio = (M - 1) * torch.log(z) - (phi_v - movers_phi) - d_prior
        acc = torch.log(u) < nan_to_neg_inf(log_ratio)
        return (torch.where(acc[:, None], v, movers),
                torch.where(acc, phi_v, movers_phi), acc)

    def transition(state, draws):
        h = state.positions.shape[0] // 2
        pos_a, phi_a = state.positions[:h], state.potentials[:h]
        pos_b, phi_b = state.positions[h:], state.potentials[h:]
        pos_a, phi_a, acc_a = half_stretch(pos_a, phi_a, pos_b, draws.pick_a,
                                           draws.z_a, draws.u_a)
        pos_b, phi_b, acc_b = half_stretch(pos_b, phi_b, pos_a, draws.pick_b,
                                           draws.z_b, draws.u_b)
        positions = torch.cat([pos_a, pos_b], dim=0)
        potentials = torch.cat([phi_a, phi_b], dim=0)
        stretch_acc = torch.cat([acc_a, acc_b]).to(torch.float32)

        w = prior.whiten(positions)
        w_prop = torch.cat(
            [w[:, :M], shrink * w[:, M:] + pcn_beta * draws.xi[:, M:]],
            dim=1)
        v = prior.mean + prior.scale * w_prop
        phi_v = potential_fn(v)
        acc = torch.log(draws.u_pcn) < nan_to_neg_inf(potentials - phi_v)
        new = FESState(positions=torch.where(acc[:, None], v, positions),
                       potentials=torch.where(acc, phi_v, potentials))
        return new, FESInfo(stretch_accept=stretch_acc,
                            pcn_accept=acc.to(torch.float32))

    def kernel(generator, state):
        L, d = state.positions.shape
        h = L // 2
        dev = state.positions.device
        count_step("scan_fes_step", dev)

        def half(n_movers, n_anchors):
            pick = torch.randint(0, n_anchors, (n_movers,), generator=generator,
                                 device=generator.device).to(dev)
            return (pick, uniforms(generator, (n_movers,), dev),
                    uniforms(generator, (n_movers,), dev))

        pick_a, z_a, u_a = half(h, L - h)
        pick_b, z_b, u_b = half(L - h, h)
        return transition(state, FESDraws(
            pick_a=pick_a, z_a=z_a, u_a=u_a, pick_b=pick_b, z_b=z_b, u_b=u_b,
            xi=normals(generator, (L, d), dev), u_pcn=uniforms(generator, (L,), dev)))

    kernel.transition = transition
    return kernel


def sample_fes(potential_fn, prior, positions, generator, n_low_modes, *,
               stretch_a=2.0, pcn_beta=0.2, n_samples, burn_in=0, thin=1):
    """The scan driver over the ensemble: returns (state, samples
    (n_samples, L, d), info means (n_samples,) per field)."""
    kernel = build_kernel(potential_fn, prior, n_low_modes,
                          stretch_a=stretch_a, pcn_beta=pcn_beta)
    state = init(positions, potential_fn)
    return driver.sample_chains(kernel, state, generator, n_samples=n_samples,
                                burn_in=burn_in, thin=thin,
                                record_fn=lambda s: s.positions)
