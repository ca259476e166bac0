// Hand-written Hopper kernel of fused elliptical slice sampling on Darcy.
//
// Replaces the Pallas TPU kernel of ip_mcmc_tpu/ops/fused_mcmc.py as
// instantiated by fused_ess_chain (l.1250) / fused_ess_chain_recorded
// (l.1282) with _make_ess_step_builder (K8, l.680).
//
//   fused_ess_kernel<RECORD>  per step: nu ~ N(0, scale^2), a slice level
//                             log y = -Phi + log u, an angle theta on a
//                             bracket that shrinks towards 0, at most
//                             max_shrink misfit evaluations.
//
// The Pallas kernel pays max_shrink batched evaluations per step behind
// per-chain done masks, because its chains share lanes. Here a chain is a
// CTA, so a chain that is done leaves the shrink loop: the masked
// evaluations change nothing and the counter RNG needs no draws consumed.
// A chain that exhausts the budget stays put (not accepted).
//
// Tags: nu 0 (keys 0, 1), log_y uniform 2, theta uniform 4, shrink draw k
// 16 + k. Accept when -Phi' > log y, so a NaN Phi' never accepts.
//
// Layout and scaffold: fused_scaffold.cuh. What bounds it on the H100: the
// cold Darcy solves (see fused_pcn.cu), as many per step as the slice
// needs.
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "darcy_misfit.cuh"
#include "fused_scaffold.cuh"

namespace ipx {

struct EssArgs {
  IpxMisfitSpec pot;
  IpxChainArgs chain;
  const float* phi0;  // (n,) Phi at pos_in
  int max_shrink;
};

struct EssStep {
  const EssArgs& a;
  float* pos;
  float* prop;
  MisfitSmem ws;
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
      const float phi_prop = darcy_phi(a.pot, prop, ws);
      if (-phi_prop > log_y) {
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

template <bool RECORD>
__global__ void __launch_bounds__(kFusedThreads, 4) fused_ess_kernel(EssArgs a) {
  extern __shared__ float smem[];
  float* pos = smem;
  float* prop = pos + a.chain.d;
  const int cells = a.pot.n * a.pot.n;
  EssStep step{a, pos, prop, carve_misfit_smem(prop + a.chain.d, cells, a.pot.modes), 0.0f};
  run_chain<RECORD>(a.chain, step, pos);
}

}  // namespace ipx

extern "C" {

int ipx_fused_ess(const IpxMisfitSpec* pot, const IpxChainArgs* chain, const float* phi0,
                  int max_shrink, void* stream) {
  const int cells = pot->n * pot->n;
  const int threads = ipx::chain_threads(*chain, cells, pot->K);
  if (threads == 0 || max_shrink < 0 || pot->solver != kSolverCg) return cudaErrorInvalidValue;
  if (chain->n == 0) return cudaSuccess;
  const ipx::EssArgs a{*pot, *chain, phi0, max_shrink};
  const size_t smem = sizeof(float) * (2 * chain->d + ipx::misfit_smem_floats(cells, pot->modes));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (chain->samples != nullptr) ipx::fused_ess_kernel<true><<<chain->n, threads, smem, st>>>(a);
  else ipx::fused_ess_kernel<false><<<chain->n, threads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
