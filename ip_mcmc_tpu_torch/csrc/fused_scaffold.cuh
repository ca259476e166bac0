// The launch scaffold of the fused samplers (K2, K3), written once for
// every step: replaces _run_fused (ip_mcmc_tpu/ops/fused_mcmc.py l.152,
// pallas_call l.260) and _run_fused_recorded (l.826, pallas_call l.950).
//
// One CTA per chain. run_chain loads the chain's position into shared
// memory, derives the per-block seed uint32(seed + 7919 * block) and the
// chain's lane, runs the n_steps loop around a Step, counts acceptances,
// stores every thin-th state into (n_rec, n, d) when RECORD, and writes
// the final position and the acceptance mean. A Step provides
//
//   void init(const ChainCtx&)            state beside the position
//   bool step(const ChainCtx&, uint32_t)  one transition on pos[0..d);
//                                         the same answer in every thread
//
// and keeps pos[t] written by thread t only. The step counter restarts at
// 0 in every launch, as in the JAX scaffold. A sampler whose chains read
// one another (fused_fes.cu) cannot loop inside a CTA: it takes ChainCtx
// alone and leaves the step loop to the host.
#pragma once

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

// The CTA of the 16x16 Darcy samplers that take no layout of their own
// (ESS, FES, MALA): 256 threads, one per cell, and at least 4 CTAs per SM,
// which caps registers at 64 a thread.
constexpr int kFusedThreads = 256;

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
  // the (1, 1) uniform draw with tag `tag`: one number for the whole block
  __device__ __forceinline__ float block_uniform(uint32_t step, uint32_t tag) const {
    return uniform01(mix_key(bseed, step, tag), 0u);
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

// What every launch of a sampler checks; threads for it (enough for the
// cells of the largest grid at cells_per_thread each, at least d, at most
// the kernel's launch bound) or 0.
inline int chain_threads(const IpxChainArgs& a, int cells, int K,
                         int max_threads = kFusedThreads, int cells_per_thread = 1) {
  const int owners = (cells + cells_per_thread - 1) / cells_per_thread;
  const int threads = ((owners > a.d ? owners : a.d) + 31) / 32 * 32;
  const bool record = a.samples != nullptr;
  if (threads > max_threads || K != a.d || a.block_chains <= 0 || a.n < 0 || a.n_steps < 0 ||
      (record && a.thin <= 0))
    return 0;
  return threads;
}

}  // namespace ipx
