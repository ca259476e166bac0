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
// reduction (two barriers). A one-chain-a-CTA sampler step on it (the
// specs that gaussian_group_takes leaves) waits on those barriers and on
// the latency of the dependent row sum, not on the f32 rate or memory. The
// shipped specs (d = 2, m = 2 and d = 32, m = 16) run on a group of d lanes
// a chain (GaussianGroupRow below): no barrier, A's row, c, y and sigma in
// registers, the state exchanged through the warp's shared memory, so a
// step waits on the latency of its dependent chain (the normal draw, the
// row sum, the butterfly, the MH uniform), hidden by the other groups of
// the SM.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>

#include "block_reduce.cuh"
#include "fused_scaffold.cuh"

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
  float* res;  // [m] (y - A (u - c)) / sigma^2: the gradient's weights (value_and_grad only)
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

// Phi and its gradient dPhi/du = -A^T ((y - A (u - c)) / sigma^2) for the
// chain whose position u[0..d) sits in shared memory: Phi (gaussian_phi's,
// bit for bit) in every thread, coordinate t of the gradient in g[t],
// written by thread t (t < d, and t + blockDim.x, ...). Thread i < m keeps
// its row's r_i / sigma_i in ws.res; after block_sum's barriers thread t
// adds row t of At (column t of A) against them, i ascending. Every thread
// of the CTA calls; the caller has synchronised after writing u, and makes
// a barrier before the next call writes ws.res.
__device__ float gaussian_value_and_grad(const IpxGaussianSpec& s, const float* u,
                                         const GaussianSmem& ws, float* g) {
  float sq = 0.0f;
  for (int row = threadIdx.x; row < s.m; row += blockDim.x) {
    float acc = 0.0f;
    for (int j = 0; j < s.K; ++j)
      acc += s.At[static_cast<size_t>(j) * s.m + row] * (u[j] - s.center[j]);
    const float r = (s.data[row] - acc) / s.noise[row];
    ws.res[row] = r / s.noise[row];
    sq += r * r;
  }
  const float phi = 0.5f * block_sum(sq, ws.red);
  for (int t = threadIdx.x; t < s.K; t += blockDim.x) {
    const float* col = s.At + static_cast<size_t>(t) * s.m;
    float acc = 0.0f;
    for (int i = 0; i < s.m; ++i) acc += col[i] * ws.res[i];
    g[t] = -acc;
  }
  return phi;
}

// The linear-Gaussian potential as the potential type of the samplers that
// take one (fused_rwm.cu, fused_pcn_dense.cu, fused_pcn_adapt.cu, and one
// chain a CTA: cold pCN, DA-pCN, three-level DA, ESS, FES, cold MALA).
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
  // what value_and_grad's workspace holds besides: the m weights of ws.res
  static __host__ __device__ __forceinline__ int grad_workspace_floats(const Spec& s) {
    return 32 + s.m;
  }
  static __device__ __forceinline__ Workspace carve(float* base, Extent) {
    return GaussianSmem{base, base + 32};
  }
  static bool valid(const Spec& s) { return s.m >= 0 && s.K > 0 && s.K <= kMaxThreads; }

  static __device__ __forceinline__ float phi(const Spec& s, const float* u,
                                              const Workspace& ws) {
    return gaussian_phi(s, u, ws);
  }
  // ws carved from grad_workspace_floats(s) floats
  static __device__ __forceinline__ float value_and_grad(const Spec& s, const float* u,
                                                         const Workspace& ws, float* g) {
    return gaussian_value_and_grad(s, u, ws, g);
  }
};

// Whether the one-chain-a-CTA samplers of cold pCN, DA-pCN, three-level DA,
// ESS, FES and cold MALA take a linear-Gaussian spec for chains of d
// coordinates (each sampler's *_route sends it to kRouteCta): K = d, a
// thread a coordinate up to kMaxThreads (the rows loop over the CTA), m >=
// 0. Mirrored by ip_mcmc_tpu_torch/ops/_scaffold.py linear_route.
inline bool linear_cta_takes(const IpxGaussianSpec& s, int d) {
  return s.K == d && d > 0 && d <= LinearGaussianPotential::kMaxThreads && s.m >= 0;
}
inline int linear_route(const IpxGaussianSpec& s, int d) {
  return linear_cta_takes(s, d) ? kRouteCta : kRouteRefused;
}


// --- several chains a warp: the group kernels of K14 and K15 ----------------
//
// One chain a CTA left 30 of the 32 lanes of a one-warp CTA idle at d = 2 and
// paid a block_sum (two barriers) and shared-memory round trips every step.
// So the specs that gaussian_group_takes (d = 2 or 32, m <= d: the shipped
// compare_paths, gauss2d_rwm and lingauss_pcn targets) run on G = d lanes a
// chain, 32 / G chains a warp, kWarps warps a CTA (fused_rwm_group_kernel,
// fused_pcn_dense_group_kernel), with no CTA barrier in the step. Lane t of
// a group holds coordinate t of the state (t < d) and row t of A, y_t and
// sigma_t (t < m) in registers for the whole launch; the coordinates reach
// the rows through the warp's shared memory (gather: a __syncwarp on either
// side of the write), and Phi's sum of squares adds by an xor butterfly
// over the group.
//
// The butterfly gives block_sum's value bit for bit. In the one-warp CTA of
// the one-chain-a-CTA kernel (d, m <= 32) block_sum returns 0 + lane 0's
// butterfly over offsets 16 ... 1, and every lane at or above m adds +0 (its
// sq is 0, and no sq is -0: sq = r r). The stages of offsets 16 ... G add to
// lane 0's partial sum only sums of such zeros, which leave it as it is
// (x + 0 = x for x >= +0 and for NaN), and leave lanes 1 ... G - 1 as they
// are too; what remains is the G-lane butterfly over offsets G/2 ... 1 (a
// NumPy mirror in tests/test_torch_linear_group.py). The prior's sum of
// squares (RWM) adds the same way over d <= G lanes. An xor butterfly ends
// with the same value in every lane of the group, since IEEE addition
// commutes, so no lane broadcasts it.

// The design: warps a CTA (the launch bound) of both group kernels, groups
// of at least kMinWidth lanes (scripts/measure_linear_group_design.py times
// the alternatives, PERF.md the numbers).
struct GaussianGroupDesign {
  static constexpr int kWarps = 8, kMinWidth = 2;
};

// G, the lanes of a chain of d coordinates: d, or kMinWidth if that is more.
__host__ __device__ constexpr int gaussian_group_width(int d) {
  return d > GaussianGroupDesign::kMinWidth ? d : GaussianGroupDesign::kMinWidth;
}

// Whether the group kernels take this spec for chains of d coordinates: d =
// 2 or 32 (the widths instantiated, which fix the normal draw's half (d + 1)
// / 2 at compile time), K = d, 0 <= m <= d. ipx_fused_rwm and
// ipx_fused_pcn_dense send every other spec to their one-chain-a-CTA
// kernels. Mirrored by ip_mcmc_tpu_torch/ops/_gaussian_group.py takes.
inline bool gaussian_group_takes(const IpxGaussianSpec& s, int d) {
  return (d == 2 || d == 32) && s.K == d && s.m >= 0 && s.m <= d;
}

struct GaussianGroupGeometry {
  int width;  // G: lanes a chain
  int warps;  // warps a CTA
  int ctas;
};

// Mirrored by ip_mcmc_tpu_torch/ops/_gaussian_group.py geometry: what
// gaussian_group_takes refuses, cudaErrorNotSupported (the entry points
// send it to the one-chain-a-CTA kernels). Chain c runs on group c % (32 /
// G) of warp c / (32 / G), kWarps warps a CTA; a ragged last warp or CTA
// runs spare groups on zeros.
inline int gaussian_group_geometry(const IpxGaussianSpec& s, const IpxChainArgs& chain,
                                   GaussianGroupGeometry* geo) {
  if (!gaussian_group_takes(s, chain.d)) return cudaErrorNotSupported;
  if (chain.block_chains <= 0 || chain.n < 0 || chain.n_steps < 0 ||
      (chain.samples != nullptr && chain.thin <= 0))
    return cudaErrorInvalidValue;
  geo->width = gaussian_group_width(chain.d);
  geo->warps = GaussianGroupDesign::kWarps;
  const int chains = geo->warps * (32 / geo->width);  // a CTA
  geo->ctas = (chain.n + chains - 1) / chains;
  return cudaSuccess;
}

// The sum over the G lanes of a group, in every lane of the group: the xor
// butterfly over offsets G/2 ... 1. Every lane of the warp calls.
template <int G>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The group's D values, lane j's v in x[j] (j < D), in every lane of the
// group, through the warp's 32 floats of shared memory (W warps a CTA): each
// lane writes its v, then reads the group's D (float4 reads where D % 4 ==
// 0), a __syncwarp before the write (every lane has read the last gather's)
// and after it. Every lane of the warp calls. At d = 32 this beat D shuffles
// by a few per cent, at d = 2 it ties (scripts/measure_linear_group_design.py,
// PERF.md).
template <int D, int G, int W = GaussianGroupDesign::kWarps>
__device__ __forceinline__ void gather(float v, float (&x)[D]) {
  const int base = (threadIdx.x & 31) & ~(G - 1);
  __shared__ __align__(16) float xch[32 * W];
  float* buf = xch + (threadIdx.x & ~31);
  __syncwarp();
  buf[threadIdx.x & 31] = v;
  __syncwarp();
  if constexpr (D % 4 == 0) {
#pragma unroll
    for (int q = 0; q < D / 4; ++q) {
      const float4 f = reinterpret_cast<const float4*>(buf + base)[q];
      x[4 * q] = f.x;
      x[4 * q + 1] = f.y;
      x[4 * q + 2] = f.z;
      x[4 * q + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < D; ++j) x[j] = buf[base + j];
  }
}

// Lane t of a group of G lanes: its row of the potential, in registers for
// the whole launch. Phi as gaussian_phi computes it, bit for bit, when d and
// m are at most G (see above). W: warps a CTA (the gather's buffer).
template <int D, int G, int W = GaussianGroupDesign::kWarps>
struct GaussianGroupRow {
  static_assert(D <= G && G <= 32 && (G & (G - 1)) == 0, "a group of G lanes holds d <= G");
  float a[D];      // row t of A (t < m), else zeros
  float y, sigma;  // y_t, sigma_t (t < m)
  float c;         // c_t (t < D)
  bool row;        // t < m

  __device__ __forceinline__ void load(const IpxGaussianSpec& s) {
    const int t = threadIdx.x & (G - 1);
    row = t < s.m;
#pragma unroll
    for (int j = 0; j < D; ++j) a[j] = row ? s.At[static_cast<size_t>(j) * s.m + t] : 0.0f;
    y = row ? s.data[t] : 0.0f;
    sigma = row ? s.noise[t] : 1.0f;
    c = t < D ? s.center[t] : 0.0f;
  }

  // Phi at the group's state, coordinate t in lane t's u (t < D), in every
  // lane of the group. Each row adds in gaussian_phi's order and form:
  // acc += A[t][j] (u_j - c_j), j ascending; then r = (y_t - acc) / sigma_t.
  // r r is rounded before the butterfly (__fmul_rn), as gaussian_phi's
  // loop-carried sq += r r is, so that no stage contracts it.
  __device__ __forceinline__ float phi(float u) const {
    float w[D];  // u_j - c_j, from lane j
    gather<D, G, W>(u - c, w);
    float acc = 0.0f;
#pragma unroll
    for (int j = 0; j < D; ++j) acc += a[j] * w[j];
    const float r = (y - acc) / sigma;
    return 0.5f * group_sum<G>(row ? __fmul_rn(r, r) : 0.0f);
  }
};

}  // namespace ipx
