"""Chain driver of the scan path (mirrors ``ip_mcmc_tpu/driver.py``): burn-in,
then ``n_samples`` retained states every ``thin`` steps, over an (n, d)
batch of chains. The JAX package compiles the loop into one ``lax.scan``
program and ``vmap``s the chains; here the loop is Python and each step is
a few batched PyTorch operations on the chains' device. The per-step info
is reduced over the chains on the device (the ``CountedAccepter``
equivalent), one record per retained step."""

from __future__ import annotations

import dataclasses

import torch


def init_chains(init_fn, positions, *args):
    """A kernel's ``init`` on an (n, d) position batch."""
    return init_fn(positions, *args)


def _chain_mean(info):
    return {f.name: torch.mean(getattr(info, f.name).to(torch.float32), dim=0)
            for f in dataclasses.fields(info)}


def sample_chains(kernel, state, generator, *, n_samples, burn_in=0, thin=1,
                  record_fn=None, info_fn=_chain_mean):
    """Run the chains; return (final state, samples (n_samples, n, ...),
    info means). ``kernel(generator, state) -> (state, info)``;
    ``record_fn``: state → what is recorded (default ``state.position``).
    The info means are the info's dataclass with each field the chain mean
    of the last step of every retained sample, stacked: (n_samples, ...);
    ``info_fn``: a retained step's info → the dict of what is stacked (by
    default the chain means)."""
    if record_fn is None:
        record_fn = lambda s: s.position  # noqa: E731
    for _ in range(burn_in):
        state, _ = kernel(generator, state)
    samples, means = [], []
    for _ in range(n_samples):
        for _ in range(thin):
            state, info = kernel(generator, state)
        samples.append(record_fn(state))
        means.append(info_fn(info))
    info_means = type(info)(**{k: torch.stack([m[k] for m in means])
                               for k in means[0]})
    return state, torch.stack(samples), info_means
