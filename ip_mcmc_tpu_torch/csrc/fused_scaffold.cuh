// The launch scaffold of the fused samplers (K2, K3), written once for
// every step: replaces _run_fused (ip_mcmc_tpu/ops/fused_mcmc.py l.152,
// pallas_call l.260) and _run_fused_recorded (l.826, pallas_call l.950).
//
// run_chain runs one chain per CTA (run_cluster_chain: the same in a
// thread-block cluster; run_warp_chain below: one a warp; run_group_chain:
// one on each group of G lanes, the state in registers; run_group_pooled:
// the same with the chains of a block on one cluster, meeting once a
// step; launch_cluster launches a kernel in clusters). It
// loads the chain's position into shared memory, derives the per-block
// seed uint32(seed + 7919 * block) and the chain's lane, runs the
// n_steps loop around a Step, counts acceptances, stores every thin-th
// state into (n_rec, n, d) when RECORD, and writes the final position and
// the acceptance mean. A Step provides
//
//   void init(const ChainCtx&)            state beside the position
//   bool step(const ChainCtx&, uint32_t)  one transition on pos[0..d);
//                                         the same answer in every thread
//
// and keeps pos[t] written by thread t only. The step counter restarts at
// 0 in every launch, as in the JAX scaffold. A sampler whose chains read
// one another loops inside a launch where a block of chains fits one
// cluster (run_group_pooled); else (fused_fes.cu) it sets up a WarpChainCtx
// of its own and leaves the step loop to the host.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "counter_rng.cuh"

extern "C" {
// Mirrored by ip_mcmc_tpu_torch/ops/_build.py ChainArgs.
typedef struct {
  const float* pos_in;  // (n, d)
  const float* mean;    // (d,) prior mean
  const float* scale;   // (d,) prior scale
  float* out;           // (n, d)
  float* acc;           // (n,) acceptance rate
  float* samples;       // (n_steps / thin, n, d) when recording, else null
  int seed, n, d, n_steps, block_chains, thin;
} IpxChainArgs;
}

namespace ipx {

struct ChainCtx {
  int c, t, d, half;
  bool own;  // t < d: this thread holds coordinate t of the state
  uint32_t bseed, lane, bc;
  float mean_t, scale_t;

  // coordinate t of the (d, block) normal draw with tags tag, tag + 1
  __device__ __forceinline__ float normal(uint32_t step, uint32_t tag) const {
    return normal_coord(mix_key(bseed, step, tag), mix_key(bseed, step, tag + 1u), t, half,
                        lane, bc);
  }
  // this chain's element of the (1, block) uniform draw with tag `tag`
  __device__ __forceinline__ float uniform(uint32_t step, uint32_t tag) const {
    return uniform01(mix_key(bseed, step, tag), lane);
  }
};

// The context of chain c in the CTA that runs it.
__device__ __forceinline__ ChainCtx make_chain_ctx(const IpxChainArgs& a, int c) {
  ChainCtx x;
  x.c = c;
  x.t = threadIdx.x;
  x.d = a.d;
  x.half = (a.d + 1) / 2;
  x.own = x.t < a.d;
  x.bc = static_cast<uint32_t>(a.block_chains);
  x.lane = static_cast<uint32_t>(x.c) % x.bc;
  x.bseed = static_cast<uint32_t>(a.seed) + 7919u * (static_cast<uint32_t>(x.c) / x.bc);
  x.mean_t = x.own ? a.mean[x.t] : 0.0f;
  x.scale_t = x.own ? a.scale[x.t] : 0.0f;
  return x;
}

template <bool RECORD, class Step>
__device__ void run_chain(const IpxChainArgs& a, Step& step, float* pos) {
  const ChainCtx x = make_chain_ctx(a, blockIdx.x);
  if (x.own) pos[x.t] = a.pos_in[static_cast<size_t>(x.c) * x.d + x.t];
  __syncthreads();
  step.init(x);
  float acc = 0.0f;
  for (int i = 0; i < a.n_steps; ++i) {
    if (step.step(x, static_cast<uint32_t>(i))) acc += 1.0f;
    if (RECORD && (i + 1) % a.thin == 0 && x.own) {
      const size_t rec = static_cast<size_t>((i + 1) / a.thin - 1);
      a.samples[(rec * a.n + x.c) * x.d + x.t] = pos[x.t];
    }
  }
  if (x.own) a.out[static_cast<size_t>(x.c) * x.d + x.t] = pos[x.t];
  if (x.t == 0) a.acc[x.c] = acc / static_cast<float>(a.n_steps);
}

// run_chain for a CTA of a thread-block cluster (the 64 x 64 Darcy kernels):
// the same loop, but a CTA that is not `live` (a spare of a ragged last
// cluster, blockIdx.x >= n) runs a chain of zeros in lockstep with the
// others, so that its Step's cluster barriers line up, and stores nothing.
template <bool RECORD, class Step>
__device__ void run_cluster_chain(const IpxChainArgs& a, Step& step, float* pos, bool live) {
  const ChainCtx x = make_chain_ctx(a, blockIdx.x);
  if (x.own) pos[x.t] = live ? a.pos_in[static_cast<size_t>(x.c) * x.d + x.t] : 0.0f;
  __syncthreads();
  step.init(x);
  float acc = 0.0f;
  for (int i = 0; i < a.n_steps; ++i) {
    if (step.step(x, static_cast<uint32_t>(i))) acc += 1.0f;
    if (RECORD && live && (i + 1) % a.thin == 0 && x.own) {
      const size_t rec = static_cast<size_t>((i + 1) / a.thin - 1);
      a.samples[(rec * a.n + x.c) * x.d + x.t] = pos[x.t];
    }
  }
  if (!live) return;
  if (x.own) a.out[static_cast<size_t>(x.c) * x.d + x.t] = pos[x.t];
  if (x.t == 0) a.acc[x.c] = acc / static_cast<float>(a.n_steps);
}

// The context of one chain run by one warp (run_warp_chain<RECORD, D>):
// the chain c, whether it is one of the launch's (a spare warp of a ragged
// last CTA runs a chain of zeros in lockstep with the others and stores
// nothing), and the coordinates of the D-coordinate state that a lane
// holds. D = 64: two a lane, t = lane and t + 32; with half = 32 they are
// the cos and the sin of Box-Muller row `lane` (normal2). D <= 32: lane
// t < D holds coordinate t and the other lanes none (normal1).
template <int D>
struct WarpChainCtxT {
  static_assert(D == 64 || (D > 0 && D <= 32), "a warp holds d = 64 or d <= 32");
  static constexpr int kPer = D > 32 ? 2 : 1;  // coordinates a lane
  int c;
  bool live;
  uint32_t bseed, lane, bc;  // lane: the chain's column in its block's tile
  float mean[kPer], scale[kPer];

  // whether this lane holds coordinate lane + 32 h
  static __device__ __forceinline__ bool holds(int h) {
    return D % 32 == 0 || static_cast<int>(threadIdx.x & 31) + 32 * h < D;
  }
  // coordinates lane and lane + 32 of the (64, block) normal draw with
  // tags tag, tag + 1: one uniform pair serves both
  __device__ __forceinline__ void normal2(uint32_t step, uint32_t tag, float (&z)[2]) const {
    static_assert(D == 64, "two coordinates a lane");
    const uint32_t idx = static_cast<uint32_t>(threadIdx.x & 31) * bc + lane;
    const float r = sqrtf(-2.0f * logf(uniform01(mix_key(bseed, step, tag), idx)));
    const float theta = kTwoPi * uniform01(mix_key(bseed, step, tag + 1u), idx);
    z[0] = r * cosf(theta);
    z[1] = r * sinf(theta);
  }
  // coordinate lane (< D) of the (D, block) normal draw with tags tag,
  // tag + 1, as ChainCtx::normal draws it (rows t and t - half share a pair)
  __device__ __forceinline__ float normal1(uint32_t step, uint32_t tag) const {
    static_assert(D <= 32, "one coordinate a lane");
    return normal_coord(mix_key(bseed, step, tag), mix_key(bseed, step, tag + 1u),
                        static_cast<int>(threadIdx.x & 31), (D + 1) / 2, lane, bc);
  }
  // this chain's element of the (1, block) uniform draw with tag `tag`
  __device__ __forceinline__ float uniform(uint32_t step, uint32_t tag) const {
    return uniform01(mix_key(bseed, step, tag), lane);
  }
  // the (1, 1) uniform draw with tag `tag`: one number for the whole block
  __device__ __forceinline__ float block_uniform(uint32_t step, uint32_t tag) const {
    return uniform01(mix_key(bseed, step, tag), 0u);
  }
};
using WarpChainCtx = WarpChainCtxT<64>;

// Chain c of a launch on a warp, with make_chain_ctx's seed and lane (the
// coordinates' prior mean and scale are the caller's to load).
template <int D>
__device__ __forceinline__ WarpChainCtxT<D> warp_chain_ctx(const IpxChainArgs& a, int c) {
  WarpChainCtxT<D> x;
  x.c = c;
  x.live = c < a.n;
  x.bc = static_cast<uint32_t>(a.block_chains);
  x.lane = static_cast<uint32_t>(c) % x.bc;
  x.bseed = static_cast<uint32_t>(a.seed) + 7919u * (static_cast<uint32_t>(c) / x.bc);
  return x;
}

// The scaffold of the samplers that run a chain on each warp, W chains a
// CTA: warp w of CTA b runs chain c = b W + w, with the seed and lane of
// make_chain_ctx (bseed = seed + 7919 (c / block_chains), lane c %
// block_chains), so that its draws are those of run_chain's chain c. The
// state is D coordinates in the warp's pos[0..D), held as WarpChainCtxT<D>
// says; a Step provides
//
//   void init(const WarpChainCtxT<D>&)
//   bool step(const WarpChainCtxT<D>&, uint32_t)  the same answer in every lane
//
// and keeps pos[t] written by the lane that holds t. Every warp of the CTA,
// a spare one too, makes the same number of Step calls. A Step that holds
// barriers of the whole CTA (the DA kernel's preconditioner products) must
// make the same barriers in every warp, whatever its chain does; a Step
// with none (elliptical slice sampling's Jacobi solves, the Burgers solves
// of the three-level DA kernel) may take a different number of solves in
// each warp.
template <bool RECORD, int D = 64, class Step>
__device__ void run_warp_chain(const IpxChainArgs& a, Step& step, float* pos) {
  using Ctx = WarpChainCtxT<D>;
  const int l = threadIdx.x & 31;
  Ctx x = warp_chain_ctx<D>(a, blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5));
  const size_t row = static_cast<size_t>(x.c) * D;
#pragma unroll
  for (int h = 0; h < Ctx::kPer; ++h) {
    const int t = l + 32 * h;
    x.mean[h] = Ctx::holds(h) ? a.mean[t] : 0.0f;
    x.scale[h] = Ctx::holds(h) ? a.scale[t] : 0.0f;
    if (Ctx::holds(h)) pos[t] = x.live ? a.pos_in[row + t] : 0.0f;
  }
  __syncwarp();
  step.init(x);
  float acc = 0.0f;
  for (int i = 0; i < a.n_steps; ++i) {
    if (step.step(x, static_cast<uint32_t>(i))) acc += 1.0f;
    if (RECORD && (i + 1) % a.thin == 0 && x.live) {
      const size_t rec = static_cast<size_t>((i + 1) / a.thin - 1);
#pragma unroll
      for (int h = 0; h < Ctx::kPer; ++h)
        if (Ctx::holds(h)) a.samples[(rec * a.n + x.c) * D + l + 32 * h] = pos[l + 32 * h];
    }
  }
  if (x.live) {
#pragma unroll
    for (int h = 0; h < Ctx::kPer; ++h)
      if (Ctx::holds(h)) a.out[row + l + 32 * h] = pos[l + 32 * h];
    if (l == 0) a.acc[x.c] = acc / static_cast<float>(a.n_steps);
  }
}

// The context of one chain run by a group of G lanes of a warp
// (run_group_chain<RECORD, D, G>): lane t = lane % G of the group holds
// coordinate t < D of the state; lanes t >= D hold none. The chain, its
// seed and its lane in the RNG tile are make_chain_ctx's for chain c, so
// that lane t draws coordinate t of run_chain's chain c.
template <int D, int G>
struct GroupChainCtxT {
  static_assert(D > 0 && D <= G && G <= 32 && (G & (G - 1)) == 0,
                "a group of G lanes, a power of two up to a warp, holds d <= G");
  int c;
  bool live;
  uint32_t bseed, lane, bc;  // lane: the chain's column in its block's tile
  float mean, scale;         // coordinate t's prior mean and scale (t < D)

  static __device__ __forceinline__ int t() { return threadIdx.x & (G - 1); }
  static __device__ __forceinline__ bool holds() { return t() < D; }
  // coordinate t of the (D, block) normal draw with tags tag, tag + 1, as
  // ChainCtx::normal draws it (rows t and t - half share a pair)
  __device__ __forceinline__ float normal1(uint32_t step, uint32_t tag) const {
    return normal_coord(mix_key(bseed, step, tag), mix_key(bseed, step, tag + 1u), t(),
                        (D + 1) / 2, lane, bc);
  }
  // this chain's element of the (1, block) uniform draw with tag `tag`
  __device__ __forceinline__ float uniform(uint32_t step, uint32_t tag) const {
    return uniform01(mix_key(bseed, step, tag), lane);
  }
};

// The scaffold of the samplers that run a chain on each group of G lanes,
// 32 / G chains a warp (the linear-Gaussian group kernels): group g of warp
// w of CTA b runs chain c = (b W + w) 32 / G + g, with make_chain_ctx's seed
// and lane, so that its draws are those of run_chain's chain c. The state
// lives in registers: a Step holds `pos`, coordinate t of the state in lane
// t < D (run_warp_chain keeps it in the warp's shared memory), and provides
//
//   void init(const GroupChainCtxT<D, G>&)
//   bool step(const GroupChainCtxT<D, G>&, uint32_t)  the same answer in
//                                                    every lane of the group
//
// Every lane of the warp makes the same Step calls (the steps exchange
// through the warp's shared memory and by shuffles, each a warp-wide
// __syncwarp or shuffle); the groups of chains c >= n (a ragged last
// warp or CTA) run a chain of zeros and store nothing.
template <bool RECORD, int D, int G, class Step>
__device__ void run_group_chain(const IpxChainArgs& a, Step& step) {
  using Ctx = GroupChainCtxT<D, G>;
  const int t = Ctx::t();
  Ctx x;
  x.c = static_cast<int>((blockIdx.x * blockDim.x + threadIdx.x) / G);
  x.live = x.c < a.n;
  x.bc = static_cast<uint32_t>(a.block_chains);
  x.lane = static_cast<uint32_t>(x.c) % x.bc;
  x.bseed = static_cast<uint32_t>(a.seed) + 7919u * (static_cast<uint32_t>(x.c) / x.bc);
  const bool own = Ctx::holds();
  x.mean = own ? a.mean[t] : 0.0f;
  x.scale = own ? a.scale[t] : 0.0f;
  const size_t row = static_cast<size_t>(x.c) * D + t;
  step.pos = own && x.live ? a.pos_in[row] : 0.0f;
  step.init(x);
  float acc = 0.0f;
  for (int i = 0; i < a.n_steps; ++i) {
    if (step.step(x, static_cast<uint32_t>(i))) acc += 1.0f;
    if (RECORD && (i + 1) % a.thin == 0 && x.live && own) {
      const size_t rec = static_cast<size_t>((i + 1) / a.thin - 1);
      a.samples[rec * a.n * D + row] = step.pos;
    }
  }
  if (x.live) {
    if (own) a.out[row] = step.pos;
    if (t == 0) a.acc[x.c] = acc / static_cast<float>(a.n_steps);
  }
}

// The launch of a cluster kernel: chains (CTAs) a cluster, clusters, CTAs
// (a multiple of G: the spare CTAs of a ragged last cluster run on zeros),
// threads a CTA and dynamic shared memory.
struct ClusterGeometry {
  int g, clusters, ctas, threads;
  size_t smem;
};

// The launch of kernel<<<geo>>> in clusters of geo.g CTAs of geo.threads
// threads (attr: its one attribute, the cluster dimension), after setting
// the kernel's attributes; the status of that.
template <class... Args>
cudaError_t cluster_config(void (*kernel)(Args...), const ClusterGeometry& geo, void* stream,
                           cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  const int smem = static_cast<int>(geo.smem);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && geo.g > 8)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = geo.g;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *cfg = {};
  cfg->gridDim = dim3(geo.ctas);
  cfg->blockDim = dim3(geo.threads);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = static_cast<cudaStream_t>(stream);
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return err;
}

// How many such clusters the card holds at once
// (cudaOccupancyMaxActiveClusters), or the error.
template <class... Args>
cudaError_t max_active_clusters(void (*kernel)(Args...), const ClusterGeometry& geo, int* clusters) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  const cudaError_t err = cluster_config(kernel, geo, nullptr, &cfg, &attr);
  return err != cudaSuccess ? err : cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
}

// Launches kernel<<<geo>>> in clusters of geo.g CTAs of geo.threads
// threads (cudaLaunchKernelEx), after checking that such a cluster fits on
// the card; the status of the launch or of the check.
template <class... Args>
int launch_cluster(void (*kernel)(Args...), const ClusterGeometry& geo, void* stream,
                   Args... args) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = cluster_config(kernel, geo, stream, &cfg, &attr);
  if (err != cudaSuccess) return static_cast<int>(err);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (clusters < 1) return cudaErrorInvalidConfiguration;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, kernel, args...));
}

// The scaffold of the samplers whose chains read one another once a step
// (the adaptive pCN burn-in, fused_pcn_adapt.cu): a chain on each group of G
// lanes with its state in registers, as in run_group_chain, but the chains
// of one block of block_chains run together on one CTA or thread-block
// cluster and meet once a step. This CTA runs chains first + j of block
// `block` (with make_chain_ctx's seed and lane, so the draws of run_chain's
// chain block * block_chains + first + j), j = (turn W + warp) 32 / G +
// group: each group runs TURNS chains in turn. A chain past the block (a
// ragged last CTA) runs on zeros and stores nothing. A Step holds `pos`,
// coordinate t of each of its TURNS chains in lane t < D, and provides
//
//   void init(const Ctx (&)[TURNS])
//   void step(const Ctx (&)[TURNS], uint32_t i, bool (&accepted)[TURNS])
//                                                the TURNS chains'
//                                                transitions
//   void pool(const Ctx (&)[TURNS], uint32_t i)  once a step, after the
//                                                transitions, in every
//                                                thread of the CTA: what
//                                                the chains of the block
//                                                share
//   void finish(const Ctx&, float accepted)      a live chain's outputs
//                                                beside its position
template <int D, int G, int TURNS, class Step>
__device__ void run_group_pooled(const IpxChainArgs& a, Step& step, int block, int first) {
  using Ctx = GroupChainCtxT<D, G>;
  const int t = Ctx::t();
  const bool own = Ctx::holds();
  const int j0 = static_cast<int>(threadIdx.x >> 5) * (32 / G) + static_cast<int>(threadIdx.x & 31) / G;
  const int per_turn = static_cast<int>(blockDim.x) / G;  // chains a turn
  Ctx x[TURNS];
  float acc[TURNS];
#pragma unroll
  for (int turn = 0; turn < TURNS; ++turn) {
    const int e = first + turn * per_turn + j0;  // the chain in its block
    x[turn].c = block * a.block_chains + e;
    x[turn].live = e < a.block_chains;
    x[turn].bc = static_cast<uint32_t>(a.block_chains);
    x[turn].lane = static_cast<uint32_t>(e);
    x[turn].bseed = static_cast<uint32_t>(a.seed) + 7919u * static_cast<uint32_t>(block);
    x[turn].mean = own ? a.mean[t] : 0.0f;
    x[turn].scale = own ? a.scale[t] : 0.0f;
    step.pos[turn] = own && x[turn].live ? a.pos_in[static_cast<size_t>(x[turn].c) * D + t] : 0.0f;
    acc[turn] = 0.0f;
  }
  step.init(x);
  for (int i = 0; i < a.n_steps; ++i) {
    bool accepted[TURNS];
    step.step(x, static_cast<uint32_t>(i), accepted);
#pragma unroll
    for (int turn = 0; turn < TURNS; ++turn)
      if (accepted[turn]) acc[turn] += 1.0f;
    step.pool(x, static_cast<uint32_t>(i));
  }
#pragma unroll
  for (int turn = 0; turn < TURNS; ++turn) {
    if (!x[turn].live) continue;
    if (own) a.out[static_cast<size_t>(x[turn].c) * D + t] = step.pos[turn];
    step.finish(x[turn], acc[turn]);
  }
}

// The kernel that a sampler's dispatch sends a spec to, as its takes-rules
// decide (the ipx_*_route functions, each mirrored by its wrapper's
// `route`): the Hopper design a chain a warp or G chains a thread-block
// cluster for the specs it takes, one chain a CTA for the rest of the
// domain, and outside it none (cudaErrorNotSupported).
enum { kRouteRefused = 0, kRouteWarp = 1, kRouteCluster = 2, kRouteCta = 3 };

// What every launch of a sampler checks; threads for it (enough for the
// cells of the largest grid at cells_per_thread each, at least d, at most
// the kernel's launch bound) or 0.
inline int chain_threads(const IpxChainArgs& a, int cells, int K, int max_threads,
                         int cells_per_thread = 1) {
  const int owners = (cells + cells_per_thread - 1) / cells_per_thread;
  const int threads = ((owners > a.d ? owners : a.d) + 31) / 32 * 32;
  const bool record = a.samples != nullptr;
  if (threads > max_threads || K != a.d || a.block_chains <= 0 || a.n < 0 || a.n_steps < 0 ||
      (record && a.thin <= 0))
    return 0;
  return threads;
}

}  // namespace ipx
