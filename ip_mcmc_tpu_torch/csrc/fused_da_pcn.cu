// Hand-written Hopper kernels of the delayed-acceptance pCN Darcy path.
//
// Replaces the Pallas TPU kernel of ip_mcmc_tpu/ops/fused_mcmc.py as
// instantiated by fused_da_pcn_chain (l.1535) and
// fused_da_pcn_chain_recorded (l.1653): the scaffolds _run_fused (K2,
// pallas_call l.260) and _run_fused_recorded (K3, pallas_call l.950), the
// step builder _make_da_pcn_step_builder (K4, l.325), the counter-hash RNG
// (K1, counter_rng.cuh) and the inlined Darcy misfits (K5,
// darcy_misfit.cuh).
//
//   darcy_misfit_kernel          Phi for a (K, B) batch at one misfit spec.
//   fused_da_pcn_kernel<RECORD>  the whole n_steps loop in one launch;
//                                RECORD stores every thin-th state into
//                                (n_rec, n, d) with a plain store.
//
// Layout: one CTA per chain, one thread per cell of the largest grid
// (256 threads at 16x16; the 8x8 surrogate stage uses 64 of them). Chain
// state and CG vectors stay on chip; global memory is touched for the
// positions in and out, the constant factors and the records.
//
// What bounds it on the H100: per chain and outer step (k = 48) the misfits
// do ~2.7 M multiply-adds (4096 chains: ~22 GFLOP, ~0.3 ms at the f32
// peak), but they also re-read their constant factors on every use: the
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

#include "counter_rng.cuh"
#include "darcy_misfit.cuh"

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
  const float* pos_in;  // (n, d)
  const float* phi0;    // (n,) Phi at pos_in
  const float* surr0;   // (n,) Phi* at pos_in
  const float* mean;    // (d,)
  const float* scale;   // (d,)
  float beta, contraction;
  int seed, n, d, n_steps, k, block_chains, thin;
  float* out;      // (n, d)
  float* acc;      // (n,) exact acceptance rate
  float* inner;    // (n,) inner (surrogate) acceptance rate
  float* samples;  // (n_steps / thin, n, d) when recording
};

// 256 threads (one per cell of the 16x16 grid) and at least 4 CTAs per SM:
// caps registers at 64 a thread (96 without the bound; 2 CTAs per SM).
// Measured on the H100 at 4096 chains, k = 48: 11.07 ms per outer step
// against 16.25 ms without the bound (40-48 bytes of spills).
constexpr int kFusedThreads = 256;

template <bool RECORD>
__global__ void __launch_bounds__(kFusedThreads, 4) fused_da_pcn_kernel(DaArgs a) {
  extern __shared__ float smem[];
  const int c = blockIdx.x, t = threadIdx.x, d = a.d;
  const int cells_e = a.exact.n * a.exact.n, cells_s = a.surr.n * a.surr.n;
  const int cells = cells_e > cells_s ? cells_e : cells_s;
  const int modes = a.exact.modes > a.surr.modes ? a.exact.modes : a.surr.modes;
  float* pos0 = smem;      // current state
  float* pos = pos0 + d;   // subchain state
  float* prop = pos + d;   // proposal
  const MisfitSmem ws = carve_misfit_smem(prop + d, cells, modes);
  // the surrogate's factors, read 48x per outer step, staged on chip
  float* surr_basis = prop + d + misfit_smem_floats(cells, modes);
  __nv_bfloat16* surr_V = reinterpret_cast<__nv_bfloat16*>(surr_basis + a.surr.K * cells_s);
  IpxMisfitSpec surr = a.surr;
  for (int e = t; e < a.surr.K * cells_s; e += blockDim.x) surr_basis[e] = a.surr.basis[e];
  const __nv_bfloat16* gV = static_cast<const __nv_bfloat16*>(a.surr.V);
  for (int e = t; e < a.surr.modes * cells_s; e += blockDim.x) surr_V[e] = gV[e];
  surr.basis = surr_basis;
  surr.V = surr_V;

  const bool own = t < d;
  const float mean_t = own ? a.mean[t] : 0.0f, scale_t = own ? a.scale[t] : 0.0f;
  if (own) {
    pos0[t] = a.pos_in[static_cast<size_t>(c) * d + t];
    pos[t] = pos0[t];
  }
  float phi0 = a.phi0[c], surr0 = a.surr0[c];
  const uint32_t bc = static_cast<uint32_t>(a.block_chains);
  const uint32_t lane = static_cast<uint32_t>(c) % bc;
  // per-block seed uint32(int32 seed + 7919 * block), fused_mcmc.py l.207
  const uint32_t bseed = static_cast<uint32_t>(a.seed) + 7919u * (static_cast<uint32_t>(c) / bc);
  const int half = (d + 1) / 2;
  float acc = 0.0f, in_acc = 0.0f;
  __syncthreads();

  for (int i = 0; i < a.n_steps; ++i) {
    const uint32_t step = static_cast<uint32_t>(i);
    float surr_v = surr0;
    for (int j = 0; j < a.k; ++j) {  // surrogate subchain; tags 4j, 4j+1, 4j+2
      if (own) {
        const float z = normal_coord(mix_key(bseed, step, 4u * j), mix_key(bseed, step, 4u * j + 1u),
                                     t, half, lane, bc);
        const float xi = scale_t * z;
        prop[t] = mean_t + a.contraction * (pos[t] - mean_t) + a.beta * xi;
      }
      __syncthreads();
      const float sp = darcy_phi(surr, prop, ws);
      const float log_u = logf(uniform01(mix_key(bseed, step, 4u * j + 2u), lane));
      if (log_u < surr_v - sp) {  // the same in every thread of the CTA
        in_acc += 1.0f;
        surr_v = sp;
        if (own) pos[t] = prop[t];
      }
    }
    __syncthreads();
    // exact correction: (Phi(u) - Phi(v)) - (Phi*(u) - Phi*(v)); tag 4k+2
    const float pe = darcy_phi(a.exact, pos, ws);
    float log_ratio = (phi0 - pe) - (surr0 - surr_v);
    if (isnan(log_ratio)) log_ratio = -INFINITY;
    const float log_u = logf(uniform01(mix_key(bseed, step, 4u * a.k + 2u), lane));
    if (log_u < log_ratio) {
      acc += 1.0f;
      phi0 = pe;
      surr0 = surr_v;
      if (own) pos0[t] = pos[t];
    } else if (own) {
      pos[t] = pos0[t];
    }
    if (RECORD && (i + 1) % a.thin == 0 && own) {
      const size_t rec = static_cast<size_t>((i + 1) / a.thin - 1);
      a.samples[(rec * a.n + c) * d + t] = pos0[t];
    }
  }
  if (own) a.out[static_cast<size_t>(c) * d + t] = pos0[t];
  if (t == 0) {
    a.acc[c] = acc / static_cast<float>(a.n_steps);
    a.inner[c] = in_acc / fmaxf(static_cast<float>(a.n_steps) * static_cast<float>(a.k), 1.0f);
  }
}

inline int round_up32(int v) { return (v + 31) / 32 * 32; }

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
                     const float* pos_in, const float* phi0, const float* surr0,
                     const float* mean, const float* scale, float beta,
                     float contraction, int seed, int n, int d, int n_steps,
                     int k, int block_chains, int thin, float* out, float* acc,
                     float* inner, float* samples, void* stream) {
  const int cells_e = exact->n * exact->n, cells_s = surr->n * surr->n;
  const int cells = cells_e > cells_s ? cells_e : cells_s;
  const int modes = exact->modes > surr->modes ? exact->modes : surr->modes;
  const int threads = ipx::round_up32(cells > d ? cells : d);
  const bool record = samples != nullptr;
  if (threads > ipx::kFusedThreads || exact->K != d || surr->K != d || block_chains <= 0 || n < 0 ||
      n_steps < 0 || k < 0 || (record && thin <= 0))
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  ipx::DaArgs a{*exact, *surr, pos_in, phi0, surr0, mean, scale, beta, contraction,
                seed, n, d, n_steps, k, block_chains, thin, out, acc, inner, samples};
  // state (3d) + misfit workspace + staged surrogate basis (f32) and modes (bf16)
  const size_t smem = sizeof(float) * (3 * d + ipx::misfit_smem_floats(cells, modes) +
                                       surr->K * cells_s) +
                      sizeof(__nv_bfloat16) * surr->modes * cells_s;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (record) {
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
