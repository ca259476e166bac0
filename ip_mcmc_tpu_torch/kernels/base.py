"""Shared kernel machinery (mirrors ``ip_mcmc_tpu/kernels/base.py``): the
per-step Metropolis–Hastings record and the accept/reject select, over an
(n, ...) batch of chains. A state is a dataclass of tensors whose first
dimension is the chain."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


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


def nan_to_neg_inf(log_ratio):
    """A NaN log acceptance ratio (a diverged proposal) as −∞: it rejects."""
    return torch.where(torch.isnan(log_ratio), torch.full_like(log_ratio, -torch.inf),
                       log_ratio)


def contraction(beta):
    """√(1 − β²) of a Python float β as JAX rounds it: 1 − β² formed in
    float64, rounded to f32, the root in f32."""
    return float(np.sqrt(np.float32(1.0 - beta * beta)))


def mh_select(u, log_accept_ratio, current, proposal):
    """Metropolis accept/reject from uniforms ``u`` (n,): returns (new
    state, accepted (n,), accept_prob (n,)). A NaN ratio maps to −∞ and
    rejects; accepted where log u < min(ratio, 0)."""
    log_ratio = torch.clamp(nan_to_neg_inf(log_accept_ratio), max=0.0)
    accepted = torch.log(u) < log_ratio
    return select(accepted, proposal, current), accepted, torch.exp(log_ratio)


def count_step(count_as, device):
    """Counts one ``count_as[device type]`` step, so a run can show where
    it ran."""
    # imported here: the ops package imports kernels.ensemble, which
    # imports this module
    from ip_mcmc_tpu_torch.ops import _build

    _build.launch_counts[f"{count_as}[{torch.device(device).type}]"] += 1


@dataclasses.dataclass
class RowShard:
    """The generator of one rank's rows ``start:stop`` of an ``n_total``
    chain batch sharded over ranks (``parallel.sample_chains_sharded``).
    ``normals`` and ``uniforms`` draw the whole batch from ``generator``
    and keep the rank's rows, so every chain draws what it draws in one
    process, whatever the number of ranks."""

    generator: torch.Generator
    n_total: int
    start: int
    stop: int

    @property
    def device(self):
        return self.generator.device


def _draw(fn, generator, shape, device, chain_axis):
    if isinstance(generator, RowShard):
        shape = list(shape)
        if shape[chain_axis] != generator.stop - generator.start:
            raise ValueError(
                f"draw of shape {tuple(shape)}: axis {chain_axis} is not the "
                f"{generator.stop - generator.start} chains of this rank")
        shape[chain_axis] = generator.n_total
        x = fn(shape, generator=generator.generator, dtype=torch.float32,
               device=generator.device)
        x = x.narrow(chain_axis, generator.start, generator.stop - generator.start)
    else:
        x = fn(shape, generator=generator, dtype=torch.float32,
               device=generator.device)
    return x.to(device)


def normals(generator, shape, device, chain_axis=0):
    """Standard normals of ``shape`` from ``generator`` (on its own device),
    moved to ``device``: a seed gives the same draws wherever the chains
    live. ``chain_axis``: the axis of ``shape`` that counts the chains (a
    ``RowShard`` draws it whole)."""
    return _draw(torch.randn, generator, shape, device, chain_axis)


def uniforms(generator, shape, device, chain_axis=0):
    """Uniforms on [0, 1) of ``shape``, drawn as ``normals`` draws."""
    return _draw(torch.rand, generator, shape, device, chain_axis)


def draws(generator, state, count_as):
    """This step's standard normals (n, d) and uniforms (n,) from
    ``generator``, on the chains' device; counts one ``count_as`` step."""
    pos = state.position
    count_step(count_as, pos.device)
    return normals(generator, pos.shape, pos.device), uniforms(
        generator, pos.shape[:1], pos.device)


def value_and_grad(fn):
    """``x (n, d) -> (fn(x) (n,), ∇fn(x) (n, d))`` for a function whose
    output for one chain depends only on that chain's row (so the gradient
    of the sum is every chain's own gradient; ``jax.value_and_grad`` under
    ``vmap``). Autograd records through ``fn`` even where the caller runs
    without gradients; both results are detached."""

    def vg(x):
        with torch.enable_grad():
            x = x.detach().requires_grad_(True)
            val = fn(x)
            (grad,) = torch.autograd.grad(val.sum(), x)
        return val.detach(), grad

    return vg
