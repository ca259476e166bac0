// Reductions over the warp and the block, shared by the misfits.
#pragma once

namespace ipx {

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum over the block, returned to every thread (same order everywhere).
// `red` holds 32 floats; every thread of the block calls.
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.0f;
  const int nw = blockDim.x >> 5;
  for (int w = 0; w < nw; ++w) s += red[w];
  __syncthreads();
  return s;
}

// Threads of a one-chain CTA over `cells` cells and d coordinates.
inline int round_up32(int v) { return (v + 31) / 32 * 32; }

}  // namespace ipx
