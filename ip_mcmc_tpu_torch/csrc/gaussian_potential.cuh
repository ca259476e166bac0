// The linear-Gaussian potential as a device function run by one CTA per
// chain: Phi(U) = 1/2 || (y - A (U - c)) / sigma ||^2 with A (m, d), c (d,),
// y and sigma (m,). One form covers every target that the JAX package feeds
// the RWM / dense-pCN / adaptive-pCN Pallas kernels (ip_mcmc_tpu/ops/
// fused_mcmc.py l.284, 653, 520), whose potentials are closures traced into
// the kernel body (_trace_potential l.99): the analytic Gaussian of
// benchmarks/compare_paths.py (A = I, c = mean, sigma = sqrt(var)), the
// gauss2d_rwm target 1/2 d^T P d (A = L^T with P = L L^T), the misfit of
// lingauss_pcn (A drawn, c = 0, sigma = 0.05) and the tests' potentials
// (m = 0 gives Phi = 0).
//
// Thread i < m forms row i of A (U - c) from the position in shared memory
// (rows i + blockDim.x, ... when m exceeds the CTA), squares its residual,
// and the CTA reduces. A is read from global memory, 4 m d bytes that stay
// in L1 across the steps of a launch, stored transposed (d, m): at each j
// the threads of a warp read neighbouring words, one transaction, where
// the rows of a row-major A would be 32 lines apart.
//
// What bounds it on the H100: 2 m d + 4 m operations per chain and one block
// reduction (two barriers); at the configs' sizes (m d <= 512) the barriers
// and the latency of the dependent row sum, not the f32 rate or memory, set
// its time, and many resident CTAs (one warp each at d <= 32) hide them.
#pragma once

#include <cstddef>

#include "block_reduce.cuh"

extern "C" {
// Mirrored by ip_mcmc_tpu_torch/ops/_build.py GaussianSpec.
typedef struct {
  const float* At;      // (d, m): A transposed, row-major
  const float* center;  // (d,) c
  const float* data;    // (m,) y
  const float* noise;   // (m,) sigma
  int m, K;             // rows, and the dimension d (K as in the other specs)
} IpxGaussianSpec;
}

namespace ipx {

struct GaussianSmem {
  float* red;  // [32] warp partials
};

// Phi for the chain whose position u[0..d) sits in shared memory; the same
// value in every thread. Every thread of the CTA calls; the caller has
// synchronised after writing u.
__device__ float gaussian_phi(const IpxGaussianSpec& s, const float* u, const GaussianSmem& ws) {
  float sq = 0.0f;
  for (int row = threadIdx.x; row < s.m; row += blockDim.x) {
    float acc = 0.0f;
    for (int j = 0; j < s.K; ++j)
      acc += s.At[static_cast<size_t>(j) * s.m + row] * (u[j] - s.center[j]);
    const float r = (s.data[row] - acc) / s.noise[row];
    sq += r * r;
  }
  return 0.5f * block_sum(sq, ws.red);
}

// The linear-Gaussian potential as the potential type of the samplers that
// take one (fused_rwm.cu, fused_pcn_dense.cu, fused_pcn_adapt.cu).
struct LinearGaussianPotential {
  using Spec = IpxGaussianSpec;
  using Workspace = GaussianSmem;
  // one thread per coordinate and per row up to 256; at d <= 32 a CTA is
  // one warp, and the SM's limit of 32 resident CTAs binds before the
  // 64 registers a thread that 4 CTAs of 256 threads allow
  static constexpr int kMaxThreads = 256;
  static constexpr int kMinCtasPerSm = 4;
  static constexpr int kCellsPerThread = 1;  // one thread per row

  struct Extent {
    int cells;  // rows that get a thread of their own
  };
  static __host__ __device__ __forceinline__ Extent extent(const Spec& s) {
    return {s.m < kMaxThreads ? s.m : kMaxThreads};
  }
  static __host__ __device__ __forceinline__ Extent join(Extent a, Extent b) {
    return {a.cells > b.cells ? a.cells : b.cells};
  }
  static __host__ __device__ __forceinline__ int workspace_floats(Extent) { return 32; }
  static __device__ __forceinline__ Workspace carve(float* base, Extent) {
    return GaussianSmem{base};
  }
  static bool valid(const Spec& s) { return s.m >= 0 && s.K > 0 && s.K <= kMaxThreads; }

  static __device__ __forceinline__ float phi(const Spec& s, const float* u,
                                              const Workspace& ws) {
    return gaussian_phi(s, u, ws);
  }
};

}  // namespace ipx
