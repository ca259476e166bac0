"""The port's counter-hash RNG (ip_mcmc_tpu_torch/ops/rng.py) against the
JAX kernel's (ip_mcmc_tpu/ops/fused_mcmc.py): keys, bits and uniforms bit
for bit, normals to f32 transcendental rounding."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ip_mcmc_tpu.ops import fused_mcmc as fm
from ip_mcmc_tpu_torch.ops import rng

torch.set_num_threads(1)

# (seed, step, tag): zero, a DA tag, a seed near 2**31 (int32 wrap), negative
TRIPLES = [(0, 0, 0), (12345, 7, 190), (2**31 - 3, 1000, 6), (-5, 3, 2)]
SHAPE = (32, 512)


def _jax_key(seed, step, tag):
    return fm._mix_key(jnp.int32(seed), jnp.int32(step), tag)


@pytest.mark.parametrize("seed,step,tag", TRIPLES)
def test_mix_key_bitwise(seed, step, tag):
    assert int(rng.mix_key(seed, step, tag)) == int(_jax_key(seed, step, tag))


@pytest.mark.parametrize("seed,step,tag", TRIPLES)
def test_hash_bits_and_uniform_bitwise(seed, step, tag):
    key = int(_jax_key(seed, step, tag))
    bits_j = np.asarray(fm._hash_bits(jnp.uint32(key), SHAPE)).astype(np.int64)
    np.testing.assert_array_equal(rng._hash_bits(key, SHAPE).numpy(), bits_j)
    u_j = np.asarray(fm._uniform01(jnp.uint32(key), SHAPE))
    u_t = rng._uniform01(key, SHAPE).numpy()
    assert u_t.dtype == np.float32
    np.testing.assert_array_equal(u_t, u_j)
    assert u_t.min() > 0.0 and u_t.max() < 1.0


@pytest.mark.parametrize("seed,step,tag", TRIPLES)
@pytest.mark.parametrize("d", [64, 5])
def test_normal_matches_jax(seed, step, tag, d):
    k1, k2 = int(_jax_key(seed, step, tag)), int(_jax_key(seed, step, tag + 1))
    z_j = np.asarray(fm._normal(jnp.uint32(k1), jnp.uint32(k2), (d, 512)))
    z_t = rng._normal(k1, k2, (d, 512)).numpy()
    assert z_t.shape == (d, 512)
    # log/cos/sin differ in the last bits between the two libraries
    np.testing.assert_allclose(z_t, z_j, rtol=0, atol=2e-6)


@pytest.mark.parametrize("seed", [0, 11, 2**31 - 7, -3])
def test_block_seed_derivation(seed):
    """uint32(int32 seed + 7919·block), with the JAX kernel's int32 wrap."""
    n, block = 8 * 32, 32
    seeds, lanes = rng.block_seeds(seed, n, block, "cpu")
    pid = jnp.arange(n // block, dtype=jnp.int32)
    expect = np.asarray((jnp.int32(seed) + pid * 7919).astype(jnp.uint32))
    np.testing.assert_array_equal(
        seeds.numpy(), np.repeat(expect.astype(np.int64), block)
    )
    np.testing.assert_array_equal(lanes.numpy(), np.tile(np.arange(block), n // block))
