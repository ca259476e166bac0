"""Shared kernel machinery (mirrors ``ip_mcmc_tpu/kernels/base.py``): the
per-step Metropolis–Hastings record and the accept/reject select, over an
(n, ...) batch of chains. A state is a dataclass of tensors whose first
dimension is the chain."""

from __future__ import annotations

import dataclasses

import torch

from ip_mcmc_tpu_torch.ops import _build


@dataclasses.dataclass
class MHInfo:
    """Per-step Metropolis–Hastings record (the ``CountedAccepter``
    equivalent), one entry per chain."""

    accepted: torch.Tensor  # (n,) bool
    accept_prob: torch.Tensor  # (n,) in [0, 1]
    proposal: torch.Tensor  # (n, d) the proposed position


def select(mask, proposal, current):
    """Field by field, ``proposal`` where ``mask`` (n,) holds, else
    ``current``: two states of one dataclass type."""
    def pick(p, c):
        return torch.where(mask.reshape(mask.shape + (1,) * (p.dim() - 1)), p, c)

    return dataclasses.replace(current, **{
        f.name: pick(getattr(proposal, f.name), getattr(current, f.name))
        for f in dataclasses.fields(current)
    })


def mh_select(u, log_accept_ratio, current, proposal):
    """Metropolis accept/reject from uniforms ``u`` (n,): returns (new
    state, accepted (n,), accept_prob (n,)). A NaN ratio (a diverged
    proposal) maps to −∞ and rejects; accepted where log u < min(ratio, 0)."""
    log_accept_ratio = torch.where(
        torch.isnan(log_accept_ratio),
        torch.full_like(log_accept_ratio, -torch.inf), log_accept_ratio)
    log_ratio = torch.clamp(log_accept_ratio, max=0.0)
    accepted = torch.log(u) < log_ratio
    return select(accepted, proposal, current), accepted, torch.exp(log_ratio)


def draws(generator, state, count_as):
    """This step's standard normals (n, d) and uniforms (n,) from
    ``generator`` (on its own device), moved to the chains' device. Counts
    one ``count_as[device]`` step, so a run can show where it ran."""
    pos = state.position
    n, d = pos.shape
    _build.launch_counts[f"{count_as}[{pos.device.type}]"] += 1
    kw = dict(generator=generator, dtype=torch.float32, device=generator.device)
    xi = torch.randn((n, d), **kw).to(pos.device)
    u = torch.rand((n,), **kw).to(pos.device)
    return xi, u
