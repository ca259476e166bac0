// Hand-written Hopper kernel of fused elliptical slice sampling on Darcy.
//
// Replaces the Pallas TPU kernel of ip_mcmc_tpu/ops/fused_mcmc.py as
// instantiated by fused_ess_chain (l.1250) / fused_ess_chain_recorded
// (l.1282) with _make_ess_step_builder (K8, l.680).
//
//   fused_ess_warp_kernel<RECORD>  per step: nu ~ N(0, scale^2), a slice
//                                  level log y = -Phi + log u, an angle
//                                  theta on a bracket that shrinks towards
//                                  0, at most max_shrink misfit evaluations.
//   fused_ess_kernel<Pot, RECORD>  the same step one chain a CTA, on the
//                                  specs the warp kernel leaves: any CG
//                                  Darcy misfit up to 16 x 16 (Jacobi,
//                                  dst_trunc, dst; K = d). ess_route sends
//                                  each spec to one of the two. Pot
//                                  LinearGaussianPotential: every
//                                  linear-Gaussian spec that
//                                  linear_cta_takes (ipx_fused_ess_linear).
//
// The Pallas kernel pays max_shrink batched evaluations per step behind
// per-chain done masks, because its chains share lanes. Here a chain is a
// warp, so a chain that is done leaves the shrink loop: the masked
// evaluations change nothing and the counter RNG needs no draws consumed.
// A chain that exhausts the budget stays put (not accepted).
//
// Tags: nu 0 (keys 0, 1), log_y uniform 2, theta uniform 4, shrink draw k
// 16 + k. Accept when -Phi' > log y, so a NaN Phi' never accepts.
//
// What bounds it on the H100: the cold Darcy solves (16 x 16, Jacobi, 48
// CG), 4.5 a step on average, each ~0.3 M multiply-adds but ~100 dependent
// dot products. One chain a CTA of 256 threads (the first design, 1.83 ms a
// step at 4096 chains) paid three CTA barriers a CG iteration, two of them
// block reductions, at 4 CTAs an SM. So the kernel runs one chain a warp
// on fused_scaffold.cuh's run_warp_chain: lane l owns eight cells of one
// 32-cell slice and coordinates l, l + 32 of d = 64; the dot products are
// shuffles, the stencil reads the warp's own shared memory after
// __syncwarp, and the Jacobi preconditioner needs no other chain
// (WarpSliceLevel in darcy_misfit.cuh), so each warp runs its own shrink
// loop and nothing makes the warps of a CTA step together. Its dot
// products add in block_sum's order (WarpSliceLevel::dot), so that the
// chains take the bits of the one-chain-a-CTA kernel; the KL basis is
// staged in shared memory once a CTA. The design is the line EssWarpDesign
// (scripts/measure_ess_warp_design.py times the alternatives, PERF.md the
// numbers).
//
// fused_ess_kernel is the first design, kept for the specs the warp
// kernel's one level does not hold (another grid, preconditioner or d):
// one chain a CTA of Layout16 (a thread a cell), the solve of
// darcy_misfit.cuh's darcy_phi with its CTA barriers, the factors read
// through L1 / L2. No shipped config sends it a spec. On a linear-Gaussian
// spec it runs the same step on gaussian_phi (a thread a row, one block
// reduction an evaluation): at lingauss_elliptical's d = 32, m = 16 a CTA is
// one warp, and the step waits on the shrink loop's dependent evaluations.
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "darcy_misfit.cuh"
#include "fused_scaffold.cuh"
#include "gaussian_potential.cuh"

namespace ipx {

// The design: kWarps chains a CTA at most, one a warp; the launch bound's
// warps an SM (kSmWarps: 32 caps a thread at 65536 / 1024 = 64 registers,
// 24 at 80, 16 at 128).
struct EssWarpDesign { static constexpr int kWarps = 16, kSmWarps = 16; };
constexpr int kEssWarpMinCtas = EssWarpDesign::kSmWarps >= 2 * EssWarpDesign::kWarps
                                    ? EssWarpDesign::kSmWarps / EssWarpDesign::kWarps
                                    : 1;
constexpr int kEssN = 16, kEssD = 64;
// a warp's slice: pos, prop (64 each), then p, th, tv (the level's padded
// cells); before the slices, the staged basis
constexpr int kEssWarpFloats = 2 * kEssD + 3 * WarpSliceLevel::kStride;

template <class Spec>
struct EssArgsT {
  Spec pot;
  IpxChainArgs chain;
  const float* phi0;  // (n,) Phi at pos_in
  int max_shrink;
};
using EssArgs = EssArgsT<IpxMisfitSpec>;

// K8 on a warp: the lane holds coordinates l and l + 32 of pos and prop.
struct EssWarpStep {
  const EssArgs& a;
  WarpSliceLevel lv;
  float* pos;
  float* prop;
  float phi;

  __device__ void init(const WarpChainCtx& x) { phi = x.live ? a.phi0[x.c] : 0.0f; }

  __device__ bool step(const WarpChainCtx& x, uint32_t i) {
    const int l = threadIdx.x & 31;
    float nu[2], centered[2];
    x.normal2(i, 0u, nu);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      nu[h] = x.scale[h] * nu[h];
      centered[h] = pos[l + 32 * h] - x.mean[h];
    }
    const float log_y = -phi + logf(x.uniform(i, 2u));
    float theta = kTwoPi * x.uniform(i, 4u);
    float lo = theta - kTwoPi, hi = theta;
    for (int k = 0; k < a.max_shrink; ++k) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
        prop[l + 32 * h] = centered[h] * cosf(theta) + nu[h] * sinf(theta) + x.mean[h];
      __syncwarp();
      const float phi_prop = lv.phi(prop);
      if (-phi_prop > log_y) {
        phi = phi_prop;
        pos[l] = prop[l];
        pos[l + 32] = prop[l + 32];
        return true;
      }
      // shrink the bracket towards 0
      if (theta >= 0.0f) hi = theta;
      else lo = theta;
      theta = lo + (hi - lo) * x.uniform(i, 16u + static_cast<uint32_t>(k));
    }
    return false;
  }
};

template <bool RECORD>
__global__ void __launch_bounds__(32 * EssWarpDesign::kWarps, kEssWarpMinCtas)
    fused_ess_warp_kernel(const __grid_constant__ EssArgs a) {
  extern __shared__ float4 ess_warp_smem[];
  constexpr int kStride = WarpSliceLevel::kStride;
  float* staged = reinterpret_cast<float*>(ess_warp_smem);
  float* w = staged + WarpSliceLevel::staged_bytes() / sizeof(float) +
             (threadIdx.x >> 5) * kEssWarpFloats;
  const WarpSmem ws{w + 2 * kEssD, w + 2 * kEssD + kStride, w + 2 * kEssD + 2 * kStride};
  const WarpSliceLevel lv{&a.pot, WarpSliceLevel::stage(a.pot, staged), ws};
  __syncthreads();  // the staged basis
  EssWarpStep step{a, lv, w, w + kEssD, 0.0f};
  run_warp_chain<RECORD>(a.chain, step, w);
}

// K8 one chain a CTA: thread t < d holds coordinate t of pos and prop.
template <class Pot>
struct EssStep {
  const EssArgsT<typename Pot::Spec>& a;
  float* pos;
  float* prop;
  typename Pot::Workspace ws;
  float phi;

  __device__ void init(const ChainCtx& c) { phi = a.phi0[c.c]; }

  __device__ bool step(const ChainCtx& c, uint32_t i) {
    float nu = 0.0f, centered = 0.0f;
    if (c.own) {
      nu = c.scale_t * c.normal(i, 0u);
      centered = pos[c.t] - c.mean_t;
    }
    const float log_y = -phi + logf(c.uniform(i, 2u));
    float theta = kTwoPi * c.uniform(i, 4u);
    float lo = theta - kTwoPi, hi = theta;
    for (int k = 0; k < a.max_shrink; ++k) {
      if (c.own) prop[c.t] = centered * cosf(theta) + nu * sinf(theta) + c.mean_t;
      __syncthreads();
      const float phi_prop = Pot::phi(a.pot, prop, ws);
      if (-phi_prop > log_y) {  // the same in every thread
        phi = phi_prop;
        if (c.own) pos[c.t] = prop[c.t];
        return true;
      }
      // shrink the bracket towards 0
      if (theta >= 0.0f) hi = theta;
      else lo = theta;
      theta = lo + (hi - lo) * c.uniform(i, 16u + static_cast<uint32_t>(k));
    }
    return false;
  }
};

template <class Pot, bool RECORD>
__global__ void __launch_bounds__(Pot::kMaxThreads, Pot::kMinCtasPerSm)
    fused_ess_kernel(const __grid_constant__ EssArgsT<typename Pot::Spec> a) {
  extern __shared__ float ess_smem[];
  float* pos = ess_smem;
  float* prop = pos + a.chain.d;
  EssStep<Pot> step{a, pos, prop, Pot::carve(prop + a.chain.d, Pot::extent(a.pot)), 0.0f};
  run_chain<RECORD>(a.chain, step, pos);
}

// Launches fused_ess_kernel<Pot, RECORD> (RECORD: chain.samples given) on
// a spec of ess_route's (or, linear-Gaussian, linear_route's) kRouteCta.
template <class Pot>
int launch_ess_cta(const EssArgsT<typename Pot::Spec>& a, void* stream) {
  const typename Pot::Extent extent = Pot::extent(a.pot);
  const int threads =
      chain_threads(a.chain, extent.cells, a.pot.K, Pot::kMaxThreads, Pot::kCellsPerThread);
  if (threads == 0 || a.max_shrink < 0 || !Pot::valid(a.pot)) return cudaErrorInvalidValue;
  if (a.chain.n == 0) return cudaSuccess;
  const size_t smem = sizeof(float) * (2 * a.chain.d + Pot::workspace_floats(extent));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a.chain.samples != nullptr)
    fused_ess_kernel<Pot, true><<<a.chain.n, threads, smem, st>>>(a);
  else
    fused_ess_kernel<Pot, false><<<a.chain.n, threads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// What a launch takes: warps (chains) a CTA, CTAs, dynamic shared memory.
struct EssWarpGeometry {
  int warps, ctas;
  size_t smem;
};

// Whether the warp kernel takes the spec for chains of d coordinates: a
// 16 x 16 Jacobi CG misfit with d = K = 64. Mirrored by
// ip_mcmc_tpu_torch/ops/fused_ess.py warp_takes.
inline bool ess_warp_takes(const IpxMisfitSpec& s, int d) {
  return s.n == kEssN && s.K == kEssD && d == kEssD && s.precond == kPrecondJacobi &&
         s.modes == 0 && s.solver == kSolverCg && s.m >= 0;
}

// The kernel a spec goes to: the warp kernel for what it takes, the
// one-chain-a-CTA kernel for any other CG misfit up to 16 x 16 with K = d,
// none above. Mirrored by ip_mcmc_tpu_torch/ops/fused_ess.py route.
inline int ess_route(const IpxMisfitSpec& s, int d) {
  if (ess_warp_takes(s, d)) return kRouteWarp;
  if (darcy_cta_spec(s, d, DarcyPotential::kMaxCells, DarcyPotential::kMaxThreads))
    return kRouteCta;
  return kRouteRefused;
}

// Mirrored by ip_mcmc_tpu_torch/ops/fused_ess.py warp_geometry: what
// ess_warp_takes (else cudaErrorNotSupported). W: the largest power of two
// up to kWarps that divides block_chains; a ragged last CTA runs spare
// warps.
inline int ess_warp_geometry(const IpxMisfitSpec& s, const IpxChainArgs& chain, int max_shrink,
                             EssWarpGeometry* geo) {
  if (!ess_warp_takes(s, chain.d)) return cudaErrorNotSupported;
  if (chain.block_chains <= 0 || chain.n < 0 || chain.n_steps < 0 || max_shrink < 0 ||
      (chain.samples != nullptr && chain.thin <= 0))
    return cudaErrorInvalidValue;
  int w = EssWarpDesign::kWarps;
  while (chain.block_chains % w) w /= 2;
  geo->warps = w;
  geo->ctas = (chain.n + w - 1) / w;
  geo->smem = WarpSliceLevel::staged_bytes() + sizeof(float) * kEssWarpFloats * w;
  return geo->smem <= 232448 ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace ipx

extern "C" {

// ess_route picks the kernel: the warp kernel, the one-chain-a-CTA kernel,
// or none (cudaErrorNotSupported).
int ipx_fused_ess(const IpxMisfitSpec* pot, const IpxChainArgs* chain, const float* phi0,
                  int max_shrink, void* stream) {
  const int route = ipx::ess_route(*pot, chain->d);
  if (route == ipx::kRouteCta)
    return ipx::launch_ess_cta<ipx::DarcyPotential>({*pot, *chain, phi0, max_shrink}, stream);
  if (route != ipx::kRouteWarp) return cudaErrorNotSupported;
  ipx::EssWarpGeometry geo;
  const int status = ipx::ess_warp_geometry(*pot, *chain, max_shrink, &geo);
  if (status != cudaSuccess) return status;
  if (chain->n == 0) return cudaSuccess;
  const ipx::EssArgs a{*pot, *chain, phi0, max_shrink};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = 32 * geo.warps, smem = static_cast<int>(geo.smem);
  if (chain->samples != nullptr) {
    cudaFuncSetAttribute(ipx::fused_ess_warp_kernel<true>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    ipx::fused_ess_warp_kernel<true><<<geo.ctas, threads, smem, st>>>(a);
  } else {
    cudaFuncSetAttribute(ipx::fused_ess_warp_kernel<false>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    ipx::fused_ess_warp_kernel<false><<<geo.ctas, threads, smem, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// The kernel's launch geometry for this spec and these chain arguments:
// out = {chains a CTA, CTAs, dynamic shared-memory bytes}; the status the
// launch would return for them (the wrapper's mirror is checked against
// this on the card).
int ipx_ess_warp_geometry(const IpxMisfitSpec* pot, const IpxChainArgs* chain, int max_shrink,
                          int* out) {
  ipx::EssWarpGeometry geo{0, 0, 0};
  const int status = ipx::ess_warp_geometry(*pot, *chain, max_shrink, &geo);
  out[0] = geo.warps;
  out[1] = geo.ctas;
  out[2] = static_cast<int>(geo.smem);
  return status;
}

// The kernel ipx_fused_ess sends this spec to, for chains of d coordinates
// (ipx::kRoute*; the wrapper's mirror is checked against this on the card).
int ipx_ess_route(const IpxMisfitSpec* pot, int d) { return ipx::ess_route(*pot, d); }

// A linear-Gaussian spec that linear_cta_takes goes to
// fused_ess_kernel<LinearGaussianPotential, ·>, one chain a CTA; any other
// is refused (cudaErrorNotSupported).
int ipx_fused_ess_linear(const IpxGaussianSpec* pot, const IpxChainArgs* chain,
                         const float* phi0, int max_shrink, void* stream) {
  if (ipx::linear_route(*pot, chain->d) != ipx::kRouteCta) return cudaErrorNotSupported;
  return ipx::launch_ess_cta<ipx::LinearGaussianPotential>({*pot, *chain, phi0, max_shrink},
                                                           stream);
}

// The kernel ipx_fused_ess_linear sends this spec to (ipx::kRoute*).
int ipx_ess_linear_route(const IpxGaussianSpec* pot, int d) { return ipx::linear_route(*pot, d); }

}  // extern "C"
