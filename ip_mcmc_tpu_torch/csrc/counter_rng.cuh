// Counter-hash RNG (K1): the stream of ip_mcmc_tpu/ops/fused_mcmc.py
// (_hash_bits l.39, _mix_key l.53, _uniform01 l.77, _normal l.86),
// bit for bit in uint32 arithmetic. Philox would give other numbers; with
// the repo's hash, CUDA, plain PyTorch and JAX chains take the same
// decisions. The element index is flat over a (rows, block_chains) tile,
// so a chain's bits depend on its block (through the seed) and its lane.
#pragma once

#include <cstdint>

namespace ipx {

constexpr float kTwoPi = 6.283185307179586f;

__device__ __forceinline__ uint32_t hash_bits(uint32_t key, uint32_t idx) {
  uint32_t x = idx * 0x9E3779B9u + key;
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// (seed, step, tag) -> stream key: a nonlinear sponge (see _mix_key).
__device__ __forceinline__ uint32_t mix_key(uint32_t seed, uint32_t step,
                                            uint32_t tag) {
  uint32_t k = seed ^ (tag * 0x27D4EB2Fu);
  k *= 0x85EBCA6Bu;
  k ^= k >> 13;
  k *= 0x165667B1u;
  k ^= k >> 16;
  k += step * 0x9E3779B9u;
  k ^= k >> 13;
  k *= 0xC2B2AE35u;
  k ^= k >> 16;
  return k;
}

// U(0,1) with a 24-bit mantissa, never 0: ((bits >> 8) + 1/2) * 2^-24.
__device__ __forceinline__ float uniform01(uint32_t key, uint32_t idx) {
  const float top = static_cast<float>(static_cast<int>(hash_bits(key, idx) >> 8));
  return top * (1.0f / 16777216.0f) + (0.5f / 16777216.0f);
}

// Coordinate q of a (d, block) Box-Muller draw: rows q < half are the cos
// outputs of uniform row q, rows q >= half the sin outputs of row q - half.
__device__ __forceinline__ float normal_coord(uint32_t key1, uint32_t key2,
                                              int q, int half, uint32_t lane,
                                              uint32_t block_chains) {
  const uint32_t row = static_cast<uint32_t>(q < half ? q : q - half);
  const uint32_t idx = row * block_chains + lane;
  const float r = sqrtf(-2.0f * logf(uniform01(key1, idx)));
  const float theta = kTwoPi * uniform01(key2, idx);
  return q < half ? r * cosf(theta) : r * sinf(theta);
}

}  // namespace ipx
