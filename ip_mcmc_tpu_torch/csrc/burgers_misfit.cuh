// Batched Burgers misfit (K12) as device functions: the arithmetic of
// ip_mcmc_tpu/models/burgers.py make_batched_misfit (l.153) with
// godunov_flux2 (l.25). On the TPU the whole finite-volume time loop is
// traced into the fused Pallas kernel with chains on the vector lanes.
// Here burgers_phi runs one chain on a CTA, thread t owning cell t of the
// periodic grid (t < n_cells): the misfit kernel and the Burgers DA and
// pCN samplers on a spec that the warp solve does not take (a level of
// other than 64 or 128 cells, or K != 16: burgers_warp_takes).
// burgers_phi_warp (below) runs one chain on a warp, with the same bits:
// the three-level DA kernel, and the standalone misfit and the Burgers DA
// and pCN samplers on every spec that it takes (the shipped configs').
//
//   state = mean + basis^T u                  16 multiply-adds per cell
//   per segment: seg_steps Godunov steps      u -= c (2F_{i+1/2} - 2F_{i-1/2}),
//                                             2F = max(max(u_l,0)^2, min(u_r,0)^2),
//                                             c = 1/2 dt/h
//                then the state at the m observed cells (a gather)
//   Phi = 1/2 sum ((y - pred) / sigma)^2
//
// In burgers_phi the state is double-buffered in shared memory, so a time
// step costs one __syncthreads: every thread reads its two neighbours from
// the current buffer, writes its cell into the other, and the buffers swap.
// Each thread recomputes the flux through its left face from (u_{i-1}, u_i)
// instead of fetching its neighbour's right flux (the roll of burgers.py
// l.188): the same operands give the same bits, so the update stays
// conservative to the bit and one exchange per step suffices.
//
// What bounds it on the H100: a step is 13 f32 operations per cell (8 if
// each flux were computed once and exchanged) behind a block barrier, and
// the steps of a solve depend on one another (154 for the fine grid), so
// barrier latency sets the time, not the f32 rate and not memory (a solve
// reads 64 bytes of coefficients and writes 4). burgers_phi_warp has no
// barrier and computes each flux once; what is left there is the Godunov
// arithmetic, with ~16 warps an SM to hide its latency.
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

// --- the Burgers solve on a warp: the warp kernels of the three samplers -----
//
// burgers_phi's arithmetic for one chain on one warp, with no CTA barrier:
// lane l owns the C = n_cells / 32 cells C l .. C l + C - 1 (4 of the
// 128-cell grid, 2 of the 64-cell one) in registers. A time step fetches
// the two edge cells of the neighbouring lanes, cell C l - 1 from lane
// l - 1 and cell C l + C from lane l + 1 (periodic: lane 0 and lane 31 are
// neighbours), by two independent shuffles (edge_cells), then computes the
// C + 1 fluxes through its cells' faces once each (burgers_phi computes
// both faces of every cell: 13 f32 operations a cell where this takes 8)
// and updates its cells. The same operands give the same bits, so every
// cell takes burgers_phi's values. The state goes through the warp's shared
// memory only at a segment's end, where the observed cells are gathered.
//
// Phi in burgers_phi's order. There block_sum adds over the samplers' CTA of
// T threads (round_up32 of the largest level's cells: 128, or 64 where
// every level of the sampler has 64 cells): thread t sums the squared
// residuals o = t, t + T, ... of every segment, then each warp's warp_sum,
// then 0 + warp 0 + warp 1 + ... Here lane l keeps one partial for each
// old warp w (residuals o = 32 w + l + T r, in the same order, across the
// segments), runs each through warp_sum's butterfly over the same lanes,
// and adds them 0 + w0 + w1 + ... A partial of an old warp that had no
// residual is +0, which adds nothing, so only the warps up to the last
// residual are summed. The KL sum runs over k in ascending order from the
// basis staged in shared memory, as burgers_phi sums it from global memory.

// The threads of the CTA that the one-chain-a-CTA samplers run a Burgers
// chain on, whose block_sum order Phi keeps: one a cell of the 128-cell grid.
constexpr int kBurgersOldThreads = 128;
constexpr int kBurgersWarpK = 16;  // the KL coefficients the warp solve takes
// the larger of the two cell counts it takes: a warp's gather buffer
constexpr int kBurgersWarpCells = 128;

// One level on a warp: its spec, its basis and mean staged in shared memory
// once a CTA, and the warp's gather buffer (n_cells floats, shared memory).
struct BurgersWarpLevel {
  const IpxBurgersSpec* s;
  const float* basis;  // (K, n_cells)
  const float* mean;   // (n_cells,)
  float* state;        // [n_cells] the warp's

  // Copies the level's basis and mean to `base` (every thread of the CTA
  // calls; a barrier must follow before they are read); returns the end.
  __device__ float* stage(float* base) {
    const int n = s->n_cells, kn = kBurgersWarpK * n;
    for (int e = threadIdx.x; e < kn + n; e += blockDim.x)
      base[e] = e < kn ? s->basis[e] : s->mean[e - kn];
    basis = base;
    mean = base + kn;
    return base + kn + n;
  }
  __host__ __device__ static int staged_floats(int n_cells) {
    return (kBurgersWarpK + 1) * n_cells;
  }
};

// C consecutive floats from 4 C-byte aligned shared memory.
template <int C>
__device__ __forceinline__ void load_cells(const float* p, float (&v)[C]) {
  static_assert(C == 2 || C == 4, "2 or 4 cells a lane");
  if constexpr (C == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x, v[1] = q.y;
  }
}

template <int C>
__device__ __forceinline__ void store_cells(float* p, const float (&v)[C]) {
  if constexpr (C == 4) *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
}

// The edge cells of the neighbouring lanes: left = cell C l - 1 (lane l - 1's
// last), right = cell C l + C (lane l + 1's first), periodic.
template <int C>
__device__ __forceinline__ void edge_cells(const float (&v)[C], float& left, float& right) {
  const int l = threadIdx.x & 31;
  left = __shfl_sync(0xffffffffu, v[C - 1], (l + 31) & 31);
  right = __shfl_sync(0xffffffffu, v[0], (l + 1) & 31);
}

// Phi(u) for the chain of this warp at a level of C x 32 cells, whose
// kBurgersWarpK coefficients sit in the warp's u[0..K) (shared memory,
// written before a __syncwarp), added in block_sum's order over a CTA of T
// threads; the same value in every lane.
template <int C, int T = kBurgersOldThreads>
__device__ float burgers_phi_warp(const BurgersWarpLevel& lv, const float* u) {
  static_assert(T % 32 == 0 && 32 * C <= T && T <= kBurgersOldThreads, "T: the old CTA's threads");
  constexpr int n = 32 * C;
  const IpxBurgersSpec& s = *lv.s;
  const int l = threadIdx.x & 31;
  float v[C], acc[C];
#pragma unroll
  for (int j = 0; j < C; ++j) acc[j] = 0.0f;
#pragma unroll
  for (int k = 0; k < kBurgersWarpK; ++k) {
    const float uk = u[k];
    float b[C];
    load_cells<C>(lv.basis + k * n + C * l, b);
#pragma unroll
    for (int j = 0; j < C; ++j) acc[j] += b[j] * uk;
  }
  float m[C];
  load_cells<C>(lv.mean + C * l, m);
#pragma unroll
  for (int j = 0; j < C; ++j) v[j] = m[j] + acc[j];
  const float c = s.half_dt_over_h;
  constexpr int kOldWarps = T / 32;
  float sq[kOldWarps];
#pragma unroll
  for (int w = 0; w < kOldWarps; ++w) sq[w] = 0.0f;
  for (int seg = 0; seg < s.n_segments; ++seg) {
#pragma unroll 2
    for (int it = 0; it < s.seg_steps[seg]; ++it) {
      float left, right;
      edge_cells<C>(v, left, right);
      float flux2[C + 1];  // flux2[j]: through the left face of cell C l + j
      flux2[0] = godunov_flux2(left, v[0]);
#pragma unroll
      for (int j = 1; j < C; ++j) flux2[j] = godunov_flux2(v[j - 1], v[j]);
      flux2[C] = godunov_flux2(v[C - 1], right);
#pragma unroll
      for (int j = 0; j < C; ++j)
        v[j] = __fsub_rn(v[j], __fmul_rn(c, __fsub_rn(flux2[j + 1], flux2[j])));
    }
    store_cells<C>(lv.state + C * l, v);
    __syncwarp();
#pragma unroll
    for (int w = 0; w < kOldWarps; ++w) {
      for (int o = 32 * w + l; o < s.m; o += T) {
        const int e = seg * s.m + o;
        const float res = (s.data[e] - lv.state[s.obs[o]]) / s.noise[e];
        sq[w] += res * res;
      }
    }
    __syncwarp();  // the reads end before the next write
  }
  const int old_warps = s.m < T ? (s.m + 31) / 32 : kOldWarps;
  float total = 0.0f;
#pragma unroll
  for (int w = 0; w < kOldWarps; ++w)
    if (w < old_warps) total += warp_sum(sq[w]);
  return 0.5f * total;
}

// Phi at a level of 64 or 128 cells (the warp kernels' geometry refuses
// others), in block_sum's order over 128 threads.
__device__ __forceinline__ float burgers_level_phi(const BurgersWarpLevel& lv, const float* u) {
  return lv.s->n_cells == 64 ? burgers_phi_warp<2>(lv, u) : burgers_phi_warp<4>(lv, u);
}

// The same over the `threads` threads of the one-chain-a-CTA sampler that
// the calling kernel replaces (the largest of its levels' cells: 64 or 128).
__device__ __forceinline__ float burgers_level_phi(const BurgersWarpLevel& lv, const float* u,
                                                   int threads) {
  return threads == 64 ? burgers_phi_warp<2, 64>(lv, u) : burgers_level_phi(lv, u);
}

// The Burgers misfit as the potential type of the samplers that take one.
struct BurgersPotential {
  using Spec = IpxBurgersSpec;
  using Workspace = BurgersSmem;
  // the CTA of the one-chain-a-CTA samplers (the specs that the warp solve
  // leaves): one thread per cell of a grid of up to 128 cells, and 16 CTAs
  // per SM (2048 threads) so that 2048 chains are resident at once on the
  // card's 132 SMs, which caps registers at 32 a thread
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

// Whether the warp solve takes this level for chains of d coordinates: a
// valid spec of 64 or 128 cells and K = d = kBurgersWarpK. The samplers'
// entry points send what it takes to their warp kernels and the rest to
// the one-chain-a-CTA kernels. Mirrored by
// ip_mcmc_tpu_torch/ops/_burgers_warp.py takes.
inline bool burgers_warp_takes(const IpxBurgersSpec& s, int d) {
  return BurgersPotential::valid(s) && (s.n_cells == 64 || s.n_cells == kBurgersWarpCells) &&
         s.K == kBurgersWarpK && d == kBurgersWarpK;
}

}  // namespace ipx
