"""Counter-hash RNG, plain PyTorch (K1; mirrors ``ip_mcmc_tpu/ops/fused_mcmc.py``
``_hash_bits``, ``_mix_key``, ``_uniform01``, ``_normal``).

The CUDA kernels reproduce the same stream in ``csrc/counter_rng.cuh``, so
port and JAX chains draw the same numbers and take the same decisions.
PyTorch has no general uint32 arithmetic, so the words live in int64
tensors holding values in [0, 2³²); every product is split into 16-bit
halves so that no intermediate leaves the int64 range.

Element indices are flat over a ``(rows, block_chains)`` tile: a chain's
bits depend on its block (through the per-block seed) and its lane.
"""

from __future__ import annotations

import math

import torch

_MASK = 0xFFFFFFFF
TWO_PI = 2.0 * math.pi


def _mul32(x, c: int):
    """(x · c) mod 2³² for ``x`` in [0, 2³²) (Python int or int64 tensor)
    and a 32-bit constant ``c``."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _MASK


def _u32(x):
    """An int64 tensor (or Python int) reduced to its low 32 bits."""
    return x & _MASK


def hash_bits(key, idx):
    """murmur3/splitmix finalizer over element index ``idx`` mixed with
    ``key``; both int64 tensors of 32-bit words (broadcast together)."""
    x = _u32(_mul32(idx, 0x9E3779B9) + key)
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def mix_key(seed, step, tag: int):
    """(seed, step, tag) → stream key. ``seed`` and ``step`` are Python ints
    or int64 tensors (reduced mod 2³²), ``tag`` a Python int."""
    k = _u32(seed) ^ _mul32(tag, 0x27D4EB2F)
    k = _mul32(k, 0x85EBCA6B)
    k = k ^ (k >> 13)
    k = _mul32(k, 0x165667B1)
    k = k ^ (k >> 16)
    k = _u32(k + _mul32(_u32(step), 0x9E3779B9))
    k = k ^ (k >> 13)
    k = _mul32(k, 0xC2B2AE35)
    return k ^ (k >> 16)


def uniform_from_bits(bits):
    """24-bit uniforms in (0, 1), never 0: (bits >> 8 + ½) · 2⁻²⁴ in f32."""
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24)) + (0.5 / (1 << 24))


def normal_from_uniforms(u1, u2):
    """Box–Muller on (half, ...) uniform rows: the cos rows, then the sin
    rows (concatenated along dim 0)."""
    r = torch.sqrt(-2.0 * torch.log(u1))
    theta = TWO_PI * u2
    return torch.cat([r * torch.cos(theta), r * torch.sin(theta)], dim=0)


def tile_index(rows: int, block: int, device):
    """Flat element index of a (rows, block) tile, as int64."""
    return torch.arange(rows * block, dtype=torch.int64, device=device).reshape(
        rows, block
    )


# --- scalar-key forms with the JAX signatures, on the CPU (for the tests) --


def _hash_bits(key, shape):
    rows, block = shape
    return hash_bits(torch.as_tensor(key, dtype=torch.int64),
                     tile_index(rows, block, "cpu"))


def _uniform01(key, shape):
    return uniform_from_bits(_hash_bits(key, shape))


def _normal(key1, key2, shape):
    d, b = shape
    half = (d + 1) // 2
    z = normal_from_uniforms(_uniform01(key1, (half, b)), _uniform01(key2, (half, b)))
    return z[:d]


def block_seeds(seed: int, n_chains: int, block_chains: int, device):
    """Per-chain copy of the per-block seed uint32(int32 seed + 7919·block)
    (``fused_mcmc.py`` l.207 / l.873), and each chain's lane in its block."""
    c = torch.arange(n_chains, dtype=torch.int64, device=device)
    blk = c // block_chains
    return _u32(int(seed) + 7919 * blk), c % block_chains
