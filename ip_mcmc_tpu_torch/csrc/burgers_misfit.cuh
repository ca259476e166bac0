// Batched Burgers misfit (K12) as a device function run by one CTA per
// chain: the arithmetic of ip_mcmc_tpu/models/burgers.py
// make_batched_misfit (l.153) with godunov_flux2 (l.25). On the TPU the
// whole finite-volume time loop is traced into the fused Pallas kernel
// with chains on the vector lanes; here thread t owns cell t of the
// periodic grid (t < n_cells).
//
//   state = mean + basis^T u                  16 multiply-adds per cell
//   per segment: seg_steps Godunov steps      u -= c (2F_{i+1/2} - 2F_{i-1/2}),
//                                             2F = max(max(u_l,0)^2, min(u_r,0)^2),
//                                             c = 1/2 dt/h
//                then the state at the m observed cells (a gather)
//   Phi = 1/2 sum ((y - pred) / sigma)^2
//
// The state is double-buffered in shared memory, so a time step costs one
// __syncthreads: every thread reads its two neighbours from the current
// buffer, writes its cell into the other, and the buffers swap. Each thread
// recomputes the flux through its left face from (u_{i-1}, u_i) instead of
// fetching its neighbour's right flux (the roll of burgers.py l.188): the
// same operands give the same bits, so the update stays conservative to the
// bit and one exchange per step suffices.
//
// What bounds it on the H100: a step is 13 f32 operations per cell (8 if
// each flux were computed once and exchanged) behind a block barrier, and the steps of a solve depend on one another (154 for
// the fine grid), so barrier latency sets the time, not the f32 rate and
// not memory (a solve reads 64 bytes of coefficients and writes 4). The
// design keeps everything on chip and leaves the latency to be hidden by
// many resident CTAs (128 threads each).
//
// Numerics follow the JAX kernel in f32: max and min propagate NaN (PTX
// max.NaN / min.NaN; fmaxf would drop it), so a NaN state reaches Phi as
// NaN and the MH test rejects. The update is written with __fmul_rn and
// __fsub_rn, so nvcc does not contract it into an FMA that the plain
// version does not have: from equal initial states the two give equal bits.
#pragma once

#include <cstddef>
#include <cstdint>

#include "block_reduce.cuh"

#define IPX_MAX_SEGMENTS 8

extern "C" {
// Mirrored by ip_mcmc_tpu_torch/ops/_build.py BurgersSpec.
typedef struct {
  const float* basis;  // (K, n_cells) scaled KL basis, f32
  const float* mean;   // (n_cells,) mean initial profile
  const int* obs;      // (m,) observed cells, the same after every segment
  const float* data;   // (n_segments * m,) segment-major
  const float* noise;  // (n_segments * m,) noise standard deviations
  int n_cells, K, m, n_segments;
  int seg_steps[IPX_MAX_SEGMENTS];  // Godunov steps of each segment
  float half_dt_over_h;             // 1/2 dt n_cells, rounded once to f32
} IpxBurgersSpec;
}

namespace ipx {

struct BurgersSmem {
  float* cur;  // [cells] the state that the next step reads
  float* nxt;  // [cells] the state that it writes
  float* red;  // [32] warp partials
};

__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// Twice the exact Godunov flux of f(u) = u^2 / 2 through the face between
// u_left and u_right.
__device__ __forceinline__ float godunov_flux2(float u_left, float u_right) {
  const float fl = max_nan(u_left, 0.0f);
  const float fr = min_nan(u_right, 0.0f);
  return max_nan(fl * fl, fr * fr);
}

// Phi(u) for the chain whose coefficients u[0..K) sit in shared memory; the
// same value in every thread. Every thread of the CTA calls (threads
// t >= n_cells contribute nothing), so every barrier is reached by the
// whole block; the caller has synchronised after writing u.
__device__ float burgers_phi(const IpxBurgersSpec& s, const float* u, const BurgersSmem& ws) {
  const int t = threadIdx.x, n = s.n_cells;
  const bool own = t < n;
  float* cur = ws.cur;
  float* nxt = ws.nxt;
  float v = 0.0f;
  if (own) {
    float acc = 0.0f;
    for (int k = 0; k < s.K; ++k) acc += s.basis[static_cast<size_t>(k) * n + t] * u[k];
    v = s.mean[t] + acc;
    cur[t] = v;
  }
  __syncthreads();
  const int left = t == 0 ? n - 1 : t - 1, right = t == n - 1 ? 0 : t + 1;  // periodic
  const float c = s.half_dt_over_h;
  float sq = 0.0f;
  for (int seg = 0; seg < s.n_segments; ++seg) {
    for (int it = 0; it < s.seg_steps[seg]; ++it) {
      if (own) {
        const float flux2_right = godunov_flux2(v, cur[right]);
        const float flux2_left = godunov_flux2(cur[left], v);
        v = __fsub_rn(v, __fmul_rn(c, __fsub_rn(flux2_right, flux2_left)));
        nxt[t] = v;
      }
      __syncthreads();
      float* swap = cur;
      cur = nxt;
      nxt = swap;
    }
    // The next step writes the other buffer, and the one after it comes
    // behind a barrier: these reads need none of their own.
    for (int o = t; o < s.m; o += blockDim.x) {
      const int e = seg * s.m + o;
      const float res = (s.data[e] - cur[s.obs[o]]) / s.noise[e];
      sq += res * res;
    }
  }
  return 0.5f * block_sum(sq, ws.red);
}

// The Burgers misfit as the potential type of the samplers that take one.
struct BurgersPotential {
  using Spec = IpxBurgersSpec;
  using Workspace = BurgersSmem;
  // the CTA of the samplers: one thread per cell of the 128-cell grid, and
  // 16 CTAs per SM (2048 threads) so that 2048 chains are resident at once
  // on the card's 132 SMs, which caps registers at 32 a thread
  static constexpr int kMaxThreads = 128;
  static constexpr int kMinCtasPerSm = 16;
  static constexpr int kCellsPerThread = 1;

  struct Extent {
    int cells;
  };
  static __host__ __device__ __forceinline__ Extent extent(const Spec& s) {
    return {s.n_cells};
  }
  static __host__ __device__ __forceinline__ Extent join(Extent a, Extent b) {
    return {a.cells > b.cells ? a.cells : b.cells};
  }
  static __host__ __device__ __forceinline__ int workspace_floats(Extent e) {
    return 2 * e.cells + 32;
  }
  static __device__ __forceinline__ Workspace carve(float* base, Extent e) {
    return BurgersSmem{base, base + e.cells, base + 2 * e.cells};
  }
  static bool valid(const Spec& s) {
    if (s.n_cells < 1 || s.K <= 0 || s.m < 0 || s.n_segments < 1 ||
        s.n_segments > IPX_MAX_SEGMENTS)
      return false;
    for (int i = 0; i < s.n_segments; ++i)
      if (s.seg_steps[i] < 0) return false;
    return true;
  }

  static __device__ __forceinline__ float phi(const Spec& s, const float* u,
                                              const Workspace& ws) {
    return burgers_phi(s, u, ws);
  }

};

}  // namespace ipx
