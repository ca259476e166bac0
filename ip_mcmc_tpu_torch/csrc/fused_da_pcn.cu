// Hand-written Hopper kernels of the delayed-acceptance pCN Darcy path.
//
// Replaces the Pallas TPU kernel of ip_mcmc_tpu/ops/fused_mcmc.py as
// instantiated by fused_da_pcn_chain (l.1535) and
// fused_da_pcn_chain_recorded (l.1653): the step builder
// _make_da_pcn_step_builder (K4, l.325) as a step on the scaffold of
// fused_scaffold.cuh (K2, K3), with the counter-hash RNG (K1,
// counter_rng.cuh) and the inlined Darcy misfits (K5, darcy_misfit.cuh).
//
//   darcy_misfit_kernel          Phi for a (K, B) batch at one misfit spec.
//   fused_da_pcn_kernel<RECORD>  the whole n_steps loop in one launch;
//                                RECORD stores every thin-th state into
//                                (n_rec, n, d) with a plain store.
//
// Layout: one CTA per chain, one thread per cell of the largest grid
// (256 threads at 16x16; the 8x8 surrogate stage uses 64 of them). Chain
// state and CG vectors stay on chip; global memory is touched for the
// positions in and out, the constant factors and the records. Phi and
// Phi* at the start positions come in from darcy_misfit_kernel.
//
// What bounds it on the H100: per chain and outer step (k = 48) the misfits
// do ~2.9 M multiply-adds (4096 chains: ~24 GFLOP, ~20 of them the
// preconditioners' products of bf16 inputs: ~0.08 ms at the tensor cores'
// bf16 peak plus the f32 peak for the rest), but they run on the CUDA
// cores, and they also re-read their constant factors on every use: the
// surrogate's KL basis (16 KB) and modes (8 KB) 48 times and the exact
// misfit's modes (64 KB) twice per CG iteration, ~5.5 MB per chain-step
// from L2 before staging, and each CG iteration is a chain of dependent
// block reductions (about 30 barriers per surrogate solve). This first
// design stages the surrogate's factors in shared memory once per CTA
// (removing ~70% of the L2 traffic) and keeps the rest simple: no wgmma,
// no TMA, one chain per CTA.
//
// Numerics follow the JAX kernel: f32 everywhere except the
// preconditioner's bf16 inputs (f32 accumulation); no fast math (the
// transmissibility denominators add a subnormal 1e-38); every MH test is
// log u < delta, so NaN rejects; the outer log-ratio maps NaN to -inf.
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "darcy_misfit.cuh"
#include "fused_scaffold.cuh"

namespace ipx {

__global__ void darcy_misfit_kernel(IpxMisfitSpec s, const float* __restrict__ U,
                                    int B, float* __restrict__ phi) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, cells = s.n * s.n;
  float* u = smem;
  const MisfitSmem ws = carve_misfit_smem(smem + s.K, cells, s.modes);
  for (int k = threadIdx.x; k < s.K; k += blockDim.x) u[k] = U[static_cast<size_t>(k) * B + b];
  __syncthreads();
  const float v = darcy_phi(s, u, ws);
  if (threadIdx.x == 0) phi[b] = v;
}

struct DaArgs {
  IpxMisfitSpec exact, surr;
  IpxChainArgs chain;
  const float* phi0;   // (n,) Phi at pos_in
  const float* surr0;  // (n,) Phi* at pos_in
  float beta, contraction;
  int k;
  float* inner;  // (n,) inner (surrogate) acceptance rate
};

// K4: k pCN steps against the surrogate (tags 4j, 4j+1, 4j+2), then one
// exact correction (Phi(u) - Phi(v)) - (Phi*(u) - Phi*(v)) with tag 4k+2.
struct DaStep {
  const DaArgs& a;
  const IpxMisfitSpec& surr;  // a.surr with its factors staged on chip
  float* pos0;                // current state
  float* pos;                 // subchain state
  float* prop;                // proposal
  MisfitSmem ws;
  float phi0, surr0, in_acc;

  __device__ void init(const ChainCtx& c) {
    phi0 = a.phi0[c.c];
    surr0 = a.surr0[c.c];
    if (c.own) pos[c.t] = pos0[c.t];
    __syncthreads();
  }

  __device__ bool step(const ChainCtx& c, uint32_t i) {
    float surr_v = surr0;
    for (int j = 0; j < a.k; ++j) {
      if (c.own) {
        const float xi = c.scale_t * c.normal(i, 4u * j);
        prop[c.t] = c.mean_t + a.contraction * (pos[c.t] - c.mean_t) + a.beta * xi;
      }
      __syncthreads();
      const float sp = darcy_phi(surr, prop, ws);
      if (logf(c.uniform(i, 4u * j + 2u)) < surr_v - sp) {  // the same in every thread
        in_acc += 1.0f;
        surr_v = sp;
        if (c.own) pos[c.t] = prop[c.t];
      }
    }
    __syncthreads();
    const float pe = darcy_phi(a.exact, pos, ws);
    float log_ratio = (phi0 - pe) - (surr0 - surr_v);
    if (isnan(log_ratio)) log_ratio = -INFINITY;
    const bool accept = logf(c.uniform(i, 4u * a.k + 2u)) < log_ratio;
    if (accept) {
      phi0 = pe;
      surr0 = surr_v;
      if (c.own) pos0[c.t] = pos[c.t];
    } else if (c.own) {
      pos[c.t] = pos0[c.t];
    }
    return accept;
  }
};

// 256 threads and at least 4 CTAs per SM (fused_scaffold.cuh) cap registers
// at 64 a thread (96 without the bound; 2 CTAs per SM). Measured on the
// H100 at 4096 chains, k = 48: 11.07 ms per outer step against 16.25 ms
// without the bound (40-48 bytes of spills).
template <bool RECORD>
__global__ void __launch_bounds__(kFusedThreads, 4) fused_da_pcn_kernel(DaArgs a) {
  extern __shared__ float smem[];
  const int t = threadIdx.x, d = a.chain.d;
  const int cells_e = a.exact.n * a.exact.n, cells_s = a.surr.n * a.surr.n;
  const int cells = cells_e > cells_s ? cells_e : cells_s;
  const int modes = a.exact.modes > a.surr.modes ? a.exact.modes : a.surr.modes;
  float* pos0 = smem;
  float* pos = pos0 + d;
  float* prop = pos + d;
  // the surrogate's factors, read 48x per outer step, staged on chip
  float* surr_basis = prop + d + misfit_smem_floats(cells, modes);
  __nv_bfloat16* surr_V = reinterpret_cast<__nv_bfloat16*>(surr_basis + a.surr.K * cells_s);
  IpxMisfitSpec surr = a.surr;
  for (int e = t; e < a.surr.K * cells_s; e += blockDim.x) surr_basis[e] = a.surr.basis[e];
  const __nv_bfloat16* gV = static_cast<const __nv_bfloat16*>(a.surr.V);
  for (int e = t; e < a.surr.modes * cells_s; e += blockDim.x) surr_V[e] = gV[e];
  surr.basis = surr_basis;
  surr.V = surr_V;

  DaStep step{a, surr, pos0, pos, prop, carve_misfit_smem(prop + d, cells, modes),
              0.0f, 0.0f, 0.0f};
  run_chain<RECORD>(a.chain, step, pos0);
  if (t == 0)
    a.inner[blockIdx.x] = step.in_acc / fmaxf(static_cast<float>(a.chain.n_steps) *
                                                  static_cast<float>(a.k), 1.0f);
}

}  // namespace ipx

extern "C" {

const char* ipx_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int ipx_darcy_misfit(const IpxMisfitSpec* s, const float* U, int B, float* phi,
                     void* stream) {
  const int cells = s->n * s->n;
  const int threads = ipx::round_up32(cells);
  if (threads > 1024 || s->K <= 0 || s->modes < 0 || B < 0) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  const size_t smem = sizeof(float) * (s->K + ipx::misfit_smem_floats(cells, s->modes));
  ipx::darcy_misfit_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(*s, U, B, phi);
  return static_cast<int>(cudaGetLastError());
}

int ipx_fused_da_pcn(const IpxMisfitSpec* exact, const IpxMisfitSpec* surr,
                     const IpxChainArgs* chain, const float* phi0, const float* surr0,
                     float beta, float contraction, int k, float* inner, void* stream) {
  const int cells_e = exact->n * exact->n, cells_s = surr->n * surr->n;
  const int cells = cells_e > cells_s ? cells_e : cells_s;
  const int modes = exact->modes > surr->modes ? exact->modes : surr->modes;
  const int threads = ipx::chain_threads(*chain, cells, exact->K);
  const int d = chain->d, n = chain->n;
  if (threads == 0 || surr->K != d || k < 0) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const ipx::DaArgs a{*exact, *surr, *chain, phi0, surr0, beta, contraction, k, inner};
  // state (3d) + misfit workspace + staged surrogate basis (f32) and modes (bf16)
  const size_t smem = sizeof(float) * (3 * d + ipx::misfit_smem_floats(cells, modes) +
                                       surr->K * cells_s) +
                      sizeof(__nv_bfloat16) * surr->modes * cells_s;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (chain->samples != nullptr) {
    cudaFuncSetAttribute(ipx::fused_da_pcn_kernel<true>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    ipx::fused_da_pcn_kernel<true><<<n, threads, smem, st>>>(a);
  } else {
    cudaFuncSetAttribute(ipx::fused_da_pcn_kernel<false>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    ipx::fused_da_pcn_kernel<false><<<n, threads, smem, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
