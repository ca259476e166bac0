// Hand-written Hopper kernels of the three-level delayed-acceptance pCN
// path on the Burgers problem.
//
// Replaces the Pallas TPU kernel of ip_mcmc_tpu/ops/fused_mcmc.py as
// instantiated by fused_da3_pcn_chain (l.1574) and
// fused_da3_pcn_chain_recorded (l.1614): the step builder
// _make_da3_pcn_step_builder (K13, l.391) as a step on the scaffold of
// fused_scaffold.cuh (K2, K3), with the counter-hash RNG (K1) and the
// inlined Burgers misfits (K12, burgers_misfit.cuh; replaces
// ip_mcmc_tpu/models/burgers.py make_batched_misfit l.153).
//
//   burgers_misfit_warp_kernel<C, T>      Phi for a (K, B) batch at a level
//                                         of the samplers' warp solve, one
//                                         draw a warp.
//   burgers_misfit_kernel                 the same at any other Burgers
//                                         misfit spec, one draw a CTA.
//   fused_da3_pcn_warp_kernel<RECORD>     the whole n_steps loop in one
//                                         launch, one chain a warp.
//   fused_da3_pcn_kernel<Pot, RECORD>     the same one chain a CTA, on the
//                                         levels the warp kernel leaves:
//                                         any three Burgers levels of up to
//                                         128 cells, K = d up to 128.
//                                         da3_route sends each spec to one
//                                         of the two. Pot
//                                         LinearGaussianPotential: any three
//                                         linear-Gaussian levels that
//                                         linear_cta_takes
//                                         (ipx_fused_da3_pcn_linear).
//
// Per outer step: k_mid times (k_inner pCN steps against the coarse
// potential, then a middle correction), then one fine correction. Phi at
// the start positions comes in from three launches of the standalone
// misfit, a draw a warp on the same solve.
//
// What bounds it on the H100: at the shipped k_inner = 8, k_mid = 24 an
// outer step is 192 coarse solves of 26 Godunov steps, 24 middle solves of
// 52 and one fine solve of 154: 6394 dependent time steps; memory sees the
// positions in and out and the records only. One chain a CTA of 128
// threads, one thread a cell (the first design, 2.04 ms an outer step at
// 2048 chains), paid a block barrier a time step and left half its threads
// idle on the 64-cell coarse grid. So the kernel runs one chain a warp on
// run_warp_chain<RECORD, 16>: the Burgers solves of burgers_misfit.cuh's
// warp level (C cells a lane, the edge cells by shuffle, each face flux
// once, no barrier), lanes 0..15 holding the 16 coordinates of the chain's
// four positions (outer, middle, inner, proposal) in the warp's shared
// memory. The three levels' bases and means are staged once a CTA. What is
// left is the Godunov arithmetic, ~16 warps an SM (2048 chains on 132
// SMs) to hide its latency. Phi adds in burgers_phi's order, so the chains
// take the one-chain-a-CTA kernel's bits. The design is the line
// Da3WarpDesign (scripts/measure_da3_warp_design.py times the
// alternatives, PERF.md the numbers). fused_da3_pcn_kernel is that first
// design (BurgersPotential's CTA, a thread a cell, a barrier a time step),
// kept for the levels the warp solve does not take; no shipped config
// sends it one.
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "burgers_misfit.cuh"
#include "fused_scaffold.cuh"
#include "gaussian_potential.cuh"

namespace ipx {

__global__ void __launch_bounds__(1024)
    burgers_misfit_kernel(IpxBurgersSpec s, const float* __restrict__ U, int B,
                          float* __restrict__ phi) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  float* u = smem;
  const BurgersSmem ws = BurgersPotential::carve(smem + s.K, BurgersPotential::extent(s));
  for (int k = threadIdx.x; k < s.K; k += blockDim.x) u[k] = U[static_cast<size_t>(k) * B + b];
  __syncthreads();
  const float v = burgers_phi(s, u, ws);
  if (threadIdx.x == 0) phi[b] = v;
}

// --- the standalone misfit: one draw a warp --------------------------------
//
// Phi for a (K, B) batch at a level that the samplers' warp solve takes
// (burgers_warp_takes with d = K: 64 or 128 cells, K = 16; the Burgers
// configs' fine, middle, coarse and multi-time levels), on that solve:
// burgers_phi_warp<C, T>, one draw a warp, C cells a lane, the edge cells by
// shuffle, no CTA barrier after the staging. burgers_misfit_kernel above runs
// one draw a CTA, a thread a cell, and pays a barrier every Godunov step. T
// is that kernel's CTA, round_up32(n_cells) threads, so Phi adds in its
// block_sum order and keeps its bits: at 64 cells T = 64, where the samplers
// (burgers_level_phi) add over 128. The level's basis and mean are staged
// once a CTA ((K + 1) cells floats); a warp's slice holds its draw's K
// coefficients and the gather buffer of the level's cells. A spare warp of a
// ragged last CTA leaves after the staging barrier: no CTA barrier follows,
// and a warp's shuffles involve its own lanes only.

// The design (scripts/measure_burgers_misfit_warp_design.py times the
// alternatives): kWarps draws a CTA, one a warp; the launch bound's warps
// an SM (kSmWarps: 32 caps a thread at 64 registers, 16 at 128).
struct MisfitBurgersWarpDesign { static constexpr int kWarps = 16, kSmWarps = 32; };
constexpr int kMisfitBurgersWarpMinCtas =
    MisfitBurgersWarpDesign::kSmWarps >= 2 * MisfitBurgersWarpDesign::kWarps
        ? MisfitBurgersWarpDesign::kSmWarps / MisfitBurgersWarpDesign::kWarps
        : 1;

template <int C, int T>
__global__ void __launch_bounds__(32 * MisfitBurgersWarpDesign::kWarps, kMisfitBurgersWarpMinCtas)
    burgers_misfit_warp_kernel(const __grid_constant__ IpxBurgersSpec s,
                               const float* __restrict__ U, int B, float* __restrict__ phi) {
  constexpr int kSlice = kBurgersWarpK + 32 * C;  // a warp's u, then its gather buffer
  extern __shared__ float4 misfit_burgers_warp_smem[];
  BurgersWarpLevel lv{&s};
  float* slices = lv.stage(reinterpret_cast<float*>(misfit_burgers_warp_smem));
  // the CTA's draws' coefficients, W consecutive columns of U a row
  const int W = blockDim.x >> 5, warp = threadIdx.x >> 5, b0 = blockIdx.x * W;
  for (int e = threadIdx.x; e < kBurgersWarpK * W; e += blockDim.x) {
    const int k = e / W, j = e % W;
    if (b0 + j < B) slices[j * kSlice + k] = U[static_cast<size_t>(k) * B + b0 + j];
  }
  __syncthreads();  // the staged level and every warp's coefficients
  const int b = b0 + warp;
  if (b >= B) return;
  float* u = slices + warp * kSlice;
  lv.state = u + kBurgersWarpK;
  const float v = burgers_phi_warp<C, T>(lv, u);
  if ((threadIdx.x & 31) == 0) phi[b] = v;
}

// What a launch takes: draws (warps) a CTA, CTAs, dynamic shared memory.
struct MisfitBurgersWarpGeometry {
  int warps, ctas;
  size_t smem;
};

// Mirrored by ip_mcmc_tpu_torch/ops/_burgers_warp.py misfit_takes and
// misfit_geometry: a level that burgers_warp_takes for chains of K
// coordinates, else cudaErrorNotSupported (burgers_misfit_kernel takes
// it); kWarps draws a CTA, a ragged last CTA runs spare warps.
inline int misfit_burgers_warp_geometry(const IpxBurgersSpec& s, int B,
                                        MisfitBurgersWarpGeometry* geo) {
  if (!burgers_warp_takes(s, s.K)) return cudaErrorNotSupported;
  if (B < 0) return cudaErrorInvalidValue;
  geo->warps = MisfitBurgersWarpDesign::kWarps;
  geo->ctas = (B + geo->warps - 1) / geo->warps;
  geo->smem = sizeof(float) * (BurgersWarpLevel::staged_floats(s.n_cells) +
                               geo->warps * (kBurgersWarpK + s.n_cells));
  return geo->smem <= 232448 ? cudaSuccess : cudaErrorInvalidValue;
}

template <int C, int T>
inline int launch_misfit_burgers_warp(const IpxBurgersSpec& s, const float* U, int B,
                                      float* phi, const MisfitBurgersWarpGeometry& geo,
                                      void* stream) {
  const int smem = static_cast<int>(geo.smem);
  cudaFuncSetAttribute(burgers_misfit_warp_kernel<C, T>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  burgers_misfit_warp_kernel<C, T><<<geo.ctas, 32 * geo.warps, smem,
                                     static_cast<cudaStream_t>(stream)>>>(s, U, B, phi);
  return static_cast<int>(cudaGetLastError());
}

// The design: kWarps chains a CTA at most, one a warp; the launch bound's
// warps an SM (kSmWarps: 32 caps a thread at 64 registers, 16 at 128;
// 2048 chains on 132 SMs are 16 warps an SM at most).
struct Da3WarpDesign { static constexpr int kWarps = 16, kSmWarps = 16; };
constexpr int kDa3WarpMinCtas = Da3WarpDesign::kSmWarps >= 2 * Da3WarpDesign::kWarps
                                    ? Da3WarpDesign::kSmWarps / Da3WarpDesign::kWarps
                                    : 1;
constexpr int kDa3D = kBurgersWarpK;  // coordinates of a chain, one a lane of lanes 0..15
// a warp's slice: pos0, pos, p1, prop (kDa3D each), then the gather buffer
// of the largest level; before the slices, the three levels' staged
// bases and means
constexpr int kDa3WarpFloats = 4 * kDa3D + kBurgersWarpCells;

template <class Spec>
struct Da3ArgsT {
  Spec fine, mid, coarse;
  IpxChainArgs chain;
  const float* phi0;   // (n,) fine Phi at pos_in
  const float* mid0;   // (n,) middle Phi at pos_in
  const float* surr0;  // (n,) coarse Phi at pos_in
  float beta, contraction;
  int k_inner, k_mid;
  float* mid_rate;  // (n,) middle-correction acceptance rate
};
using Da3Args = Da3ArgsT<IpxBurgersSpec>;

// K13 on a warp. Tags as in the JAX step builder (l.442-466): inner step
// (j2, j1) draws its normals with t = 4 (j2 k_inner + j1) (keys t, t + 1)
// and its uniform with t + 2; middle correction j2 uses 4 k_inner k_mid +
// 4 j2 + 2, the fine correction 4 k_inner k_mid + 4 k_mid + 2. A NaN
// correction ratio maps to -inf; every inner MH test is log u < delta, so
// NaN rejects. Lane t < 16 holds coordinate t of the four positions.
struct Da3WarpStep {
  using Ctx = WarpChainCtxT<kDa3D>;
  const Da3Args& a;
  BurgersWarpLevel fine, mid, coarse;
  float* pos0;  // outer state
  float* pos;   // middle-level state
  float* p1;    // inner (coarse) state
  float* prop;  // proposal
  float phi0, mid0, surr0, mid_acc;

  __device__ void init(const Ctx& x) {
    const int t = threadIdx.x & 31;
    phi0 = x.live ? a.phi0[x.c] : 0.0f;
    mid0 = x.live ? a.mid0[x.c] : 0.0f;
    surr0 = x.live ? a.surr0[x.c] : 0.0f;
    if (Ctx::holds(0)) pos[t] = p1[t] = pos0[t];
    __syncwarp();
  }

  __device__ bool step(const Ctx& x, uint32_t i) {
    const int t = threadIdx.x & 31;
    const bool own = Ctx::holds(0);
    const uint32_t k1 = static_cast<uint32_t>(a.k_inner), k2 = static_cast<uint32_t>(a.k_mid);
    float mid_phi = mid0, surr = surr0;  // at pos, which equals pos0 here
    for (uint32_t j2 = 0; j2 < k2; ++j2) {
      float s1 = surr;  // at p1, which equals pos here
      for (uint32_t j1 = 0; j1 < k1; ++j1) {
        const uint32_t tag = 4u * (j2 * k1 + j1);
        if (own) {
          const float xi = x.scale[0] * x.normal1(i, tag);
          prop[t] = x.mean[0] + a.contraction * (p1[t] - x.mean[0]) + a.beta * xi;
        }
        __syncwarp();
        const float sp = burgers_level_phi(coarse, prop);
        if (logf(x.uniform(i, tag + 2u)) < s1 - sp) {  // the same in every lane
          s1 = sp;
          if (own) p1[t] = prop[t];
        }
      }
      __syncwarp();
      const float mid_end = burgers_level_phi(mid, p1);
      float lr = (mid_phi - mid_end) - (surr - s1);  // coarse -> middle correction
      if (isnan(lr)) lr = -INFINITY;
      if (logf(x.uniform(i, 4u * k1 * k2 + 4u * j2 + 2u)) < lr) {
        mid_acc += 1.0f;
        mid_phi = mid_end;
        surr = s1;
        if (own) pos[t] = p1[t];
      } else if (own) {
        p1[t] = pos[t];
      }
    }
    __syncwarp();
    const float pe = burgers_level_phi(fine, pos);
    float log_ratio = (phi0 - pe) - (mid0 - mid_phi);  // middle -> fine correction
    if (isnan(log_ratio)) log_ratio = -INFINITY;
    const bool accept = logf(x.uniform(i, 4u * k1 * k2 + 4u * k2 + 2u)) < log_ratio;
    if (accept) {
      phi0 = pe;
      mid0 = mid_phi;
      surr0 = surr;
      if (own) pos0[t] = pos[t];
    } else if (own) {
      pos[t] = p1[t] = pos0[t];
    }
    return accept;
  }
};

template <bool RECORD>
__global__ void __launch_bounds__(32 * Da3WarpDesign::kWarps, kDa3WarpMinCtas)
    fused_da3_pcn_warp_kernel(const __grid_constant__ Da3Args a) {
  extern __shared__ float4 da3_warp_smem[];
  float* staged = reinterpret_cast<float*>(da3_warp_smem);
  BurgersWarpLevel fine{&a.fine}, mid{&a.mid}, coarse{&a.coarse};
  float* w = coarse.stage(mid.stage(fine.stage(staged))) + (threadIdx.x >> 5) * kDa3WarpFloats;
  fine.state = mid.state = coarse.state = w + 4 * kDa3D;
  __syncthreads();  // the staged levels
  Da3WarpStep step{a,         fine,          mid,  coarse, w,    w + kDa3D,
                   w + 2 * kDa3D, w + 3 * kDa3D, 0.0f, 0.0f,   0.0f, 0.0f};
  run_warp_chain<RECORD, kDa3D>(a.chain, step, w);
  const int c = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (c < a.chain.n && (threadIdx.x & 31) == 0)
    a.mid_rate[c] =
        step.mid_acc /
        fmaxf(static_cast<float>(a.chain.n_steps) * static_cast<float>(a.k_mid), 1.0f);
}

// K13 one chain a CTA, with Da3WarpStep's tags: thread t < d holds
// coordinate t of the four positions; the levels are of the potential
// type Pot (BurgersPotential, LinearGaussianPotential).
template <class Pot>
struct Da3Step {
  const Da3ArgsT<typename Pot::Spec>& a;
  float* pos0;  // outer state
  float* pos;   // middle-level state
  float* p1;    // inner (coarse) state
  float* prop;  // proposal
  typename Pot::Workspace ws;
  float phi0, mid0, surr0, mid_acc;

  __device__ void init(const ChainCtx& c) {
    phi0 = a.phi0[c.c];
    mid0 = a.mid0[c.c];
    surr0 = a.surr0[c.c];
    if (c.own) pos[c.t] = p1[c.t] = pos0[c.t];
    __syncthreads();
  }

  __device__ bool step(const ChainCtx& c, uint32_t i) {
    const uint32_t k1 = static_cast<uint32_t>(a.k_inner), k2 = static_cast<uint32_t>(a.k_mid);
    float mid_phi = mid0, surr = surr0;  // at pos, which equals pos0 here
    for (uint32_t j2 = 0; j2 < k2; ++j2) {
      float s1 = surr;  // at p1, which equals pos here
      for (uint32_t j1 = 0; j1 < k1; ++j1) {
        const uint32_t tag = 4u * (j2 * k1 + j1);
        if (c.own) {
          const float xi = c.scale_t * c.normal(i, tag);
          prop[c.t] = c.mean_t + a.contraction * (p1[c.t] - c.mean_t) + a.beta * xi;
        }
        __syncthreads();
        const float sp = Pot::phi(a.coarse, prop, ws);
        if (logf(c.uniform(i, tag + 2u)) < s1 - sp) {  // the same in every thread
          s1 = sp;
          if (c.own) p1[c.t] = prop[c.t];
        }
      }
      __syncthreads();
      const float mid_end = Pot::phi(a.mid, p1, ws);
      float lr = (mid_phi - mid_end) - (surr - s1);  // coarse -> middle correction
      if (isnan(lr)) lr = -INFINITY;
      if (logf(c.uniform(i, 4u * k1 * k2 + 4u * j2 + 2u)) < lr) {
        mid_acc += 1.0f;
        mid_phi = mid_end;
        surr = s1;
        if (c.own) pos[c.t] = p1[c.t];
      } else if (c.own) {
        p1[c.t] = pos[c.t];
      }
    }
    __syncthreads();
    const float pe = Pot::phi(a.fine, pos, ws);
    float log_ratio = (phi0 - pe) - (mid0 - mid_phi);  // middle -> fine correction
    if (isnan(log_ratio)) log_ratio = -INFINITY;
    const bool accept = logf(c.uniform(i, 4u * k1 * k2 + 4u * k2 + 2u)) < log_ratio;
    if (accept) {
      phi0 = pe;
      mid0 = mid_phi;
      surr0 = surr;
      if (c.own) pos0[c.t] = pos[c.t];
    } else if (c.own) {
      pos[c.t] = p1[c.t] = pos0[c.t];
    }
    return accept;
  }
};

template <class Pot, bool RECORD>
__global__ void __launch_bounds__(Pot::kMaxThreads, Pot::kMinCtasPerSm)
    fused_da3_pcn_kernel(const __grid_constant__ Da3ArgsT<typename Pot::Spec> a) {
  extern __shared__ float da3_smem[];
  const int d = a.chain.d;
  const typename Pot::Extent extent =
      Pot::join(Pot::extent(a.fine), Pot::join(Pot::extent(a.mid), Pot::extent(a.coarse)));
  float* pos0 = da3_smem;
  float* pos = pos0 + d;
  float* p1 = pos + d;
  float* prop = p1 + d;
  Da3Step<Pot> step{a,   pos0, pos,  p1,   prop, Pot::carve(prop + d, extent),
                    0.0f, 0.0f, 0.0f, 0.0f};
  run_chain<RECORD>(a.chain, step, pos0);
  if (threadIdx.x == 0)
    a.mid_rate[blockIdx.x] =
        step.mid_acc /
        fmaxf(static_cast<float>(a.chain.n_steps) * static_cast<float>(a.k_mid), 1.0f);
}

// Whether the warp kernel takes the three levels for chains of d
// coordinates: every level one of the warp solve's (burgers_warp_takes: 64
// or 128 cells, K = d = 16). Mirrored by
// ip_mcmc_tpu_torch/ops/fused_da3_pcn.py warp_takes.
inline bool da3_warp_takes(const IpxBurgersSpec& fine, const IpxBurgersSpec& mid,
                           const IpxBurgersSpec& coarse, int d) {
  return burgers_warp_takes(fine, d) && burgers_warp_takes(mid, d) &&
         burgers_warp_takes(coarse, d);
}

// The kernel the levels go to: the warp kernel for what it takes, the
// one-chain-a-CTA kernel for any other three valid levels of up to 128
// cells (BurgersPotential's CTA, a thread a cell) with K = d up to 128,
// none else. Mirrored by ip_mcmc_tpu_torch/ops/fused_da3_pcn.py route.
inline int da3_route(const IpxBurgersSpec& fine, const IpxBurgersSpec& mid,
                     const IpxBurgersSpec& coarse, int d) {
  if (da3_warp_takes(fine, mid, coarse, d)) return kRouteWarp;
  const IpxBurgersSpec* levels[3] = {&fine, &mid, &coarse};
  for (const IpxBurgersSpec* s : levels)
    if (!BurgersPotential::valid(*s) || s->n_cells > BurgersPotential::kMaxThreads ||
        s->K != d || d > BurgersPotential::kMaxThreads)
      return kRouteRefused;
  return kRouteCta;
}

// Launches fused_da3_pcn_kernel<Pot, RECORD> (RECORD: chain.samples given)
// on levels of da3_route's (or, linear-Gaussian, da3_linear_route's)
// kRouteCta.
template <class Pot>
int launch_da3_cta(const Da3ArgsT<typename Pot::Spec>& a, void* stream) {
  const typename Pot::Extent extent =
      Pot::join(Pot::extent(a.fine), Pot::join(Pot::extent(a.mid), Pot::extent(a.coarse)));
  const int threads = chain_threads(a.chain, extent.cells, a.fine.K, Pot::kMaxThreads);
  if (threads == 0 || a.k_inner < 0 || a.k_mid < 0) return cudaErrorInvalidValue;
  if (a.chain.n == 0) return cudaSuccess;
  // state (4d) + misfit workspace
  const size_t smem = sizeof(float) * (4 * a.chain.d + Pot::workspace_floats(extent));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a.chain.samples != nullptr)
    fused_da3_pcn_kernel<Pot, true><<<a.chain.n, threads, smem, st>>>(a);
  else
    fused_da3_pcn_kernel<Pot, false><<<a.chain.n, threads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The kernel three linear-Gaussian levels go to: one chain a CTA when
// linear_cta_takes every level, else none. Mirrored by
// ip_mcmc_tpu_torch/ops/_scaffold.py linear_route.
inline int da3_linear_route(const IpxGaussianSpec& fine, const IpxGaussianSpec& mid,
                            const IpxGaussianSpec& coarse, int d) {
  return linear_cta_takes(fine, d) && linear_cta_takes(mid, d) && linear_cta_takes(coarse, d)
             ? kRouteCta
             : kRouteRefused;
}

// What a launch takes: warps (chains) a CTA, CTAs, dynamic shared memory.
struct Da3WarpGeometry {
  int warps, ctas;
  size_t smem;
};

// Mirrored by ip_mcmc_tpu_torch/ops/fused_da3_pcn.py warp_geometry: three
// Burgers levels that burgers_warp_takes (64 or 128 cells each, K = d =
// 16; else cudaErrorNotSupported, an invalid level cudaErrorInvalidValue). W: the largest power of two up to
// kWarps that divides block_chains; a ragged last CTA runs spare warps.
inline int da3_warp_geometry(const IpxBurgersSpec& fine, const IpxBurgersSpec& mid,
                             const IpxBurgersSpec& coarse, const IpxChainArgs& chain,
                             int k_inner, int k_mid, Da3WarpGeometry* geo) {
  const IpxBurgersSpec* levels[3] = {&fine, &mid, &coarse};
  int staged = 0;
  for (const IpxBurgersSpec* s : levels) {
    if (!BurgersPotential::valid(*s)) return cudaErrorInvalidValue;
    if (!burgers_warp_takes(*s, kDa3D)) return cudaErrorNotSupported;
    staged += BurgersWarpLevel::staged_floats(s->n_cells);
  }
  if (chain.d != kDa3D) return cudaErrorNotSupported;
  if (chain.block_chains <= 0 || chain.n < 0 || chain.n_steps < 0 || k_inner < 0 ||
      k_mid < 0 || (chain.samples != nullptr && chain.thin <= 0))
    return cudaErrorInvalidValue;
  int w = Da3WarpDesign::kWarps;
  while (chain.block_chains % w) w /= 2;
  geo->warps = w;
  geo->ctas = (chain.n + w - 1) / w;
  geo->smem = sizeof(float) * (staged + kDa3WarpFloats * w);
  return geo->smem <= 232448 ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace ipx

extern "C" {

// A level that the samplers' warp solve takes (burgers_warp_takes) goes to
// burgers_misfit_warp_kernel, a draw a warp, in the order of a CTA of
// round_up32(n_cells) threads; every other to burgers_misfit_kernel, a draw
// a CTA of that many threads.
int ipx_burgers_misfit(const IpxBurgersSpec* s, const float* U, int B, float* phi,
                       void* stream) {
  const int threads = ipx::round_up32(s->n_cells);
  if (!ipx::BurgersPotential::valid(*s) || threads > 1024 || B < 0) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  if (ipx::burgers_warp_takes(*s, s->K)) {
    ipx::MisfitBurgersWarpGeometry geo;
    const int status = ipx::misfit_burgers_warp_geometry(*s, B, &geo);
    if (status != cudaSuccess) return status;
    return threads == 64 ? ipx::launch_misfit_burgers_warp<2, 64>(*s, U, B, phi, geo, stream)
                         : ipx::launch_misfit_burgers_warp<4, 128>(*s, U, B, phi, geo, stream);
  }
  const size_t smem =
      sizeof(float) *
      (s->K + ipx::BurgersPotential::workspace_floats(ipx::BurgersPotential::extent(*s)));
  ipx::burgers_misfit_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(*s, U, B,
                                                                                      phi);
  return static_cast<int>(cudaGetLastError());
}

// da3_route picks the kernel: the warp kernel, the one-chain-a-CTA kernel,
// or none (cudaErrorNotSupported).
int ipx_fused_da3_pcn_burgers(const IpxBurgersSpec* fine, const IpxBurgersSpec* mid,
                              const IpxBurgersSpec* coarse, const IpxChainArgs* chain,
                              const float* phi0, const float* mid0, const float* surr0,
                              float beta, float contraction, int k_inner, int k_mid,
                              float* mid_rate, void* stream) {
  const int route = ipx::da3_route(*fine, *mid, *coarse, chain->d);
  if (route == ipx::kRouteCta)
    return ipx::launch_da3_cta<ipx::BurgersPotential>({*fine, *mid, *coarse, *chain, phi0, mid0,
                                                       surr0, beta, contraction, k_inner, k_mid,
                                                       mid_rate},
                                                      stream);
  if (route != ipx::kRouteWarp) return cudaErrorNotSupported;
  ipx::Da3WarpGeometry geo;
  const int status =
      ipx::da3_warp_geometry(*fine, *mid, *coarse, *chain, k_inner, k_mid, &geo);
  if (status != cudaSuccess) return status;
  if (chain->n == 0) return cudaSuccess;
  const ipx::Da3Args a{*fine, *mid, *coarse, *chain, phi0,    mid0, surr0,
                       beta,  contraction,   k_inner, k_mid, mid_rate};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = 32 * geo.warps, smem = static_cast<int>(geo.smem);
  if (chain->samples != nullptr) {
    cudaFuncSetAttribute(ipx::fused_da3_pcn_warp_kernel<true>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    ipx::fused_da3_pcn_warp_kernel<true><<<geo.ctas, threads, smem, st>>>(a);
  } else {
    cudaFuncSetAttribute(ipx::fused_da3_pcn_warp_kernel<false>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    ipx::fused_da3_pcn_warp_kernel<false><<<geo.ctas, threads, smem, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// The standalone misfit's launch geometry a draw a warp
// (burgers_misfit_warp_kernel) for this spec and B draws: out = {draws a
// CTA, CTAs, dynamic shared-memory bytes}; the status the launch would
// return for them, cudaErrorNotSupported for a spec that goes to
// burgers_misfit_kernel (the wrapper's mirror is checked against this on
// the card).
int ipx_burgers_misfit_warp_geometry(const IpxBurgersSpec* s, int B, int* out) {
  ipx::MisfitBurgersWarpGeometry geo{0, 0, 0};
  const int status = ipx::misfit_burgers_warp_geometry(*s, B, &geo);
  out[0] = geo.warps;
  out[1] = geo.ctas;
  out[2] = static_cast<int>(geo.smem);
  return status;
}

// Three linear-Gaussian levels that linear_cta_takes go to
// fused_da3_pcn_kernel<LinearGaussianPotential, ·>, one chain a CTA; any
// others are refused (cudaErrorNotSupported).
int ipx_fused_da3_pcn_linear(const IpxGaussianSpec* fine, const IpxGaussianSpec* mid,
                             const IpxGaussianSpec* coarse, const IpxChainArgs* chain,
                             const float* phi0, const float* mid0, const float* surr0,
                             float beta, float contraction, int k_inner, int k_mid,
                             float* mid_rate, void* stream) {
  if (ipx::da3_linear_route(*fine, *mid, *coarse, chain->d) != ipx::kRouteCta)
    return cudaErrorNotSupported;
  return ipx::launch_da3_cta<ipx::LinearGaussianPotential>(
      {*fine, *mid, *coarse, *chain, phi0, mid0, surr0, beta, contraction, k_inner, k_mid,
       mid_rate},
      stream);
}

// The kernel ipx_fused_da3_pcn_linear sends these levels to (ipx::kRoute*).
int ipx_da3_linear_route(const IpxGaussianSpec* fine, const IpxGaussianSpec* mid,
                         const IpxGaussianSpec* coarse, int d) {
  return ipx::da3_linear_route(*fine, *mid, *coarse, d);
}

// The kernel ipx_fused_da3_pcn_burgers sends these levels to, for chains of
// d coordinates (ipx::kRoute*; the wrapper's mirror is checked against this
// on the card).
int ipx_da3_route(const IpxBurgersSpec* fine, const IpxBurgersSpec* mid,
                  const IpxBurgersSpec* coarse, int d) {
  return ipx::da3_route(*fine, *mid, *coarse, d);
}

// The kernel's launch geometry for these specs and chain arguments: out =
// {chains a CTA, CTAs, dynamic shared-memory bytes}; the status the launch
// would return for them (the wrapper's mirror is checked against this on
// the card).
int ipx_da3_warp_geometry(const IpxBurgersSpec* fine, const IpxBurgersSpec* mid,
                          const IpxBurgersSpec* coarse, const IpxChainArgs* chain, int k_inner,
                          int k_mid, int* out) {
  ipx::Da3WarpGeometry geo{0, 0, 0};
  const int status =
      ipx::da3_warp_geometry(*fine, *mid, *coarse, *chain, k_inner, k_mid, &geo);
  out[0] = geo.warps;
  out[1] = geo.ctas;
  out[2] = static_cast<int>(geo.smem);
  return status;
}

}  // extern "C"
