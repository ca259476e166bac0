"""Checkpoint / resume of the chains (mirrors ``ip_mcmc_tpu/checkpoint.py``).

The chain state is small (positions, cached potentials and gradients: a
dataclass, dict, list or tuple of tensors), so a checkpoint is the state's
tensors, written with ``torch.save`` into a directory of its own for each
step; the newest ``MAX_TO_KEEP`` steps are kept, as the JAX package's Orbax
manager keeps them. ``restore`` fills a template state of the same
structure, each tensor moved to its template's device and dtype.

Resume is exact. The JAX package keys each chunk by ``fold_in(base_key,
global offset)`` and each in-scan step by its global index, so a restored
state alone resumes the run. The port's kernels draw from a
``torch.Generator``; here each chunk's (and each in-scan step's) generator
is seeded from (seed, global offset) by ``step_generator``, a splitmix64 of
the pair, so an interrupted and resumed run gives the uninterrupted run's
samples bit for bit, on the CPU and on the card.
"""

from __future__ import annotations

import dataclasses
import glob
import os
import shutil

import numpy as np
import torch

from ip_mcmc_tpu_torch import driver

MAX_TO_KEEP = 3
_FILE = "checkpoint.pt"
_MASK = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK
    return x ^ (x >> 31)


def step_seed(seed: int, offset: int) -> int:
    """A 63-bit seed from (seed, global offset): splitmix64 of the pair."""
    return _splitmix64(_splitmix64(int(seed) & _MASK) ^ (int(offset) & _MASK)) >> 1


def step_generator(seed: int, offset: int, device) -> torch.Generator:
    """A generator on ``device`` seeded from (seed, global offset): the
    port's ``fold_in(base_key, offset)``."""
    return torch.Generator(device=torch.device(device)).manual_seed(step_seed(seed, offset))


def _leaves(tree) -> list:
    """The tensors of a state in order: a dataclass's fields in their
    order, a dict's values by sorted key, a list's or tuple's items; a
    number is a leaf; None has none."""
    if tree is None:
        return []
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [x for f in dataclasses.fields(tree) for x in _leaves(getattr(tree, f.name))]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for item in tree for x in _leaves(item)]
    return [tree]


def _fill(template, leaves):
    """``template`` with its leaves replaced in order from the iterator
    ``leaves``: a tensor leaf on the template's device and in its dtype, a
    number as the template's type."""
    if template is None:
        return None
    if dataclasses.is_dataclass(template) and not isinstance(template, type):
        return dataclasses.replace(template, **{
            f.name: _fill(getattr(template, f.name), leaves)
            for f in dataclasses.fields(template)})
    if isinstance(template, dict):
        filled = {k: _fill(template[k], leaves) for k in sorted(template)}
        return {k: filled[k] for k in template}
    if isinstance(template, (list, tuple)):
        return type(template)(_fill(item, leaves) for item in template)
    value = next(leaves)
    if isinstance(template, torch.Tensor):
        value = torch.as_tensor(value)
        if value.shape != template.shape:
            raise ValueError(f"checkpoint leaf of shape {tuple(value.shape)} for a template "
                             f"of shape {tuple(template.shape)}")
        return value.to(device=template.device, dtype=template.dtype)
    return type(template)(value.item() if isinstance(value, torch.Tensor) else value)


def _host(leaf):
    return leaf.detach().cpu() if isinstance(leaf, torch.Tensor) else leaf


def _steps(directory) -> list:
    if not os.path.isdir(directory):
        return []
    return sorted(int(d) for d in os.listdir(directory)
                  if d.isdigit() and os.path.exists(os.path.join(directory, d, _FILE)))


def save(directory, step, state, extra=None):
    """Save a chain state (and an optional dict ``extra``) at ``step`` in
    ``{directory}/{step}/``, written to a temporary directory and renamed;
    only the newest ``MAX_TO_KEEP`` steps stay."""
    os.makedirs(directory, exist_ok=True)
    payload = {"state": [_host(x) for x in _leaves(state)]}
    if extra is not None:
        payload["extra"] = [_host(x) for x in _leaves(extra)]
    final = os.path.join(directory, str(int(step)))
    tmp = f"{final}.tmp{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(payload, os.path.join(tmp, _FILE))
    shutil.rmtree(final, ignore_errors=True)
    os.replace(tmp, final)
    for old in _steps(directory)[:-MAX_TO_KEEP]:
        shutil.rmtree(os.path.join(directory, str(old)), ignore_errors=True)


def restore(directory, template_state, step=None, extra_template=None):
    """Restore (step, state[, extra]) into the templates' structure: the
    newest step unless ``step`` is given; each tensor on its template's
    device and in its dtype."""
    step = latest_step(directory) if step is None else int(step)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {directory}")
    payload = torch.load(os.path.join(directory, str(step), _FILE), weights_only=True)
    state = _fill(template_state, iter(payload["state"]))
    if extra_template is not None:
        return step, state, _fill(extra_template, iter(payload["extra"]))
    return step, state


def latest_step(directory):
    """The newest saved step, or None."""
    steps = _steps(directory)
    return steps[-1] if steps else None


def _device_of(state):
    return next(x.device for x in _leaves(state) if isinstance(x, torch.Tensor))


def sample_chains_inscan(kernel, state, seed, *, n_samples, thin=1, every=50, directory,
                         start_sample=0):
    """Chain sampling with a checkpoint every ``every`` retained samples,
    written from the sampling loop: ``{directory}/inscan_{step:08d}.npz``
    with ``step`` (the retained sample's global index) and ``leaf{i}`` (the
    state's tensors, as the JAX package names them). Each step's generator
    is seeded from (``seed``, the step's global index; ``start_sample``
    offsets it), so ``latest_inscan`` and this function reproduce the
    uninterrupted run exactly. Returns (state, positions (n_samples, n, ...),
    info means), as ``driver.sample_chains`` does."""
    os.makedirs(directory, exist_ok=True)
    device = _device_of(state)
    samples, means = [], []
    for sample_idx in range(start_sample, start_sample + n_samples):
        for j in range(thin):
            state, info = kernel(step_generator(seed, sample_idx * thin + j, device), state)
        samples.append(state.position)
        means.append(driver._chain_mean(info))
        if (sample_idx + 1) % every == 0:
            np.savez(os.path.join(directory, f"inscan_{sample_idx:08d}.npz"),
                     step=np.asarray(sample_idx),
                     **{f"leaf{i}": _host(x).numpy() if isinstance(x, torch.Tensor)
                        else np.asarray(x) for i, x in enumerate(_leaves(state))})
    info_means = type(info)(**{k: torch.stack([m[k] for m in means]) for k in means[0]})
    return state, torch.stack(samples), info_means


def latest_inscan(directory, template_state):
    """The newest in-scan checkpoint: (next sample index, state), or (0,
    ``template_state``) if there is none."""
    files = sorted(glob.glob(os.path.join(directory, "inscan_*.npz")))
    if not files:
        return 0, template_state
    with np.load(files[-1]) as z:
        step = int(z["step"])
        leaves = [torch.from_numpy(z[f"leaf{i}"]) for i in range(len(z.files) - 1)]
    return step + 1, _fill(template_state, iter(leaves))


class CheckpointingDriver:
    """Chunked sampling with a checkpoint after every chunk.

    Runs ``driver.sample_chains`` in chunks of ``chunk_size`` retained
    samples, saving the state after each chunk (step = the chunk's index).
    Each chunk draws from ``step_generator(seed, its first step's global
    index)``, so ``resume()`` picks up after the last saved chunk and gives
    exactly the samples the uninterrupted run would have."""

    def __init__(self, directory, kernel, seed, *, thin=1, chunk_size=100):
        self.directory = directory
        self.kernel = kernel
        self.seed = seed
        self.thin = thin
        self.chunk_size = chunk_size

    def run(self, state, n_samples, start_chunk=0):
        """Chunks ``start_chunk`` .. of ``n_samples`` retained samples:
        (state, samples (taken, n, ...) or None)."""
        device = _device_of(state)
        chunks = []
        for c in range(start_chunk, -(-n_samples // self.chunk_size)):
            take = min(self.chunk_size, n_samples - c * self.chunk_size)
            offset = c * self.chunk_size * self.thin
            state, samples, _ = driver.sample_chains(
                self.kernel, state, step_generator(self.seed, offset, device), n_samples=take,
                burn_in=0, thin=self.thin)
            chunks.append(samples)
            save(self.directory, c, state)
        return state, torch.cat(chunks) if chunks else None

    def resume(self, template_state, n_samples):
        """From the newest saved chunk on, or from ``template_state`` if
        none was saved."""
        last = latest_step(self.directory)
        if last is None:
            return self.run(template_state, n_samples)
        _, state = restore(self.directory, template_state, step=last)
        return self.run(state, n_samples, start_chunk=last + 1)
