// Hand-written Hopper kernels of burn-in pCN with Robbins-Monro adaptation
// of beta on the block-pooled acceptance probability (K16).
//
// Replaces the Pallas TPU kernel of ip_mcmc_tpu/ops/fused_mcmc.py as
// instantiated by fused_pcn_chain_adapt (l.992) with
// _make_pcn_adapt_step_builder (K16, l.520). Per step, with one log beta
// per block of block_chains chains:
//
//   beta = exp(log beta), prop = m + sqrt(1 - beta^2) (pos - m) + beta s xi,
//   p = min(1, exp(Phi - Phi')), accepted when log u < log p;
//   log beta <- clip(log beta + gamma_i (mean over the block of p - target),
//                    log 1e-4, log 0.999),  gamma_i = gain (1 + i)^-0.6.
//
// Every chain of a block reads the block's beta, so the chains of a block
// are coupled, and a block of 256 or more chains fits no CTA. As for the
// ensemble sampler (fused_fes.cu) the state lives in device memory and the
// host loops over the steps: per step one launch of
//
//   fused_pcn_adapt_kernel<Pot>  one CTA per chain: the pCN move in place,
//                                Phi in place, the acceptance count, and
//                                the chain's p;
//   pcn_adapt_update_kernel      one CTA per block: the sum of the block's p
//                                in a fixed pairwise order (fold the upper
//                                half onto the lower until one is left),
//                                the update of log beta, and beta for every
//                                chain of the block (the extra output).
//
// Stream order is the barrier between the two. The plain version sums in
// the same order and the update is written with __fmul_rn / __fadd_rn (no
// FMA contraction), so from the same p the two give the same beta to the
// bit; beta then differs only where Phi does. gamma_i and the clip bounds
// come from the host, identical for both. Tags: normals 0 (keys 0, 1), MH
// uniform 2.
//
// What bounds it on the H100: per chain and step one potential and d draws,
// plus two launches per step (a few microseconds each), which at the
// configs' sizes (2048 chains, d = 32) cost more than the step's work. A
// cooperative launch with a grid barrier would take them out (later work).
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "fused_scaffold.cuh"
#include "gaussian_potential.cuh"

namespace ipx {

template <class Pot>
struct PcnAdaptArgs {
  typename Pot::Spec pot;
  IpxChainArgs chain;      // pos_in: the state (n, d), updated in place; out, acc null
  float* phi;              // (n,) Phi of the state, updated in place
  float* acc;              // (n,) accepted moves so far
  float* accept_prob;      // (n,) this step's min(1, exp(Phi - Phi'))
  const float* log_beta;   // (n / block_chains,) each block's log beta
  int step;
};

template <class Pot>
__global__ void __launch_bounds__(Pot::kMaxThreads, Pot::kMinCtasPerSm)
    fused_pcn_adapt_kernel(PcnAdaptArgs<Pot> a) {
  extern __shared__ float smem[];
  const ChainCtx c = make_chain_ctx(a.chain, blockIdx.x);
  const int d = a.chain.d;
  float* pos = const_cast<float*>(a.chain.pos_in);
  float* prop = smem;
  const typename Pot::Workspace ws = Pot::carve(prop + d, Pot::extent(a.pot));
  const uint32_t i = static_cast<uint32_t>(a.step);
  const size_t row = static_cast<size_t>(c.c) * d;

  const float beta = expf(a.log_beta[c.c / a.chain.block_chains]);
  const float contraction = sqrtf(__fsub_rn(1.0f, __fmul_rn(beta, beta)));
  if (c.own) {
    const float xi = c.scale_t * c.normal(i, 0u);
    prop[c.t] = c.mean_t + contraction * (pos[row + c.t] - c.mean_t) + beta * xi;
  }
  __syncthreads();
  const float phi = a.phi[c.c];
  const float phi_prop = Pot::phi(a.pot, prop, ws);
  const float delta = phi - phi_prop;
  const float log_ratio = (delta < 0.0f || isnan(delta)) ? delta : 0.0f;  // NaN stays NaN
  const bool accept = logf(c.uniform(i, 2u)) < log_ratio;
  if (accept && c.own) pos[row + c.t] = prop[c.t];
  if (c.t == 0) {
    a.accept_prob[c.c] = expf(log_ratio);
    if (accept) {
      a.phi[c.c] = phi_prop;
      a.acc[c.c] += 1.0f;
    }
  }
}

// One CTA per block; `pooled` holds block_chains floats of shared memory.
__global__ void pcn_adapt_update_kernel(const float* __restrict__ accept_prob,
                                        float* __restrict__ log_beta,
                                        float* __restrict__ beta_out, int block_chains,
                                        float gamma, float target, float lo, float hi) {
  extern __shared__ float pooled[];
  __shared__ float new_log_beta;
  const int blk = blockIdx.x, t = threadIdx.x;
  const size_t first = static_cast<size_t>(blk) * block_chains;
  for (int e = t; e < block_chains; e += blockDim.x) pooled[e] = accept_prob[first + e];
  __syncthreads();
  // fold: element e < n - h takes e + h (>= h, which no thread writes in
  // this round)
  for (int n = block_chains; n > 1;) {
    const int h = (n + 1) / 2;
    for (int e = t; e < n - h; e += blockDim.x) pooled[e] = __fadd_rn(pooled[e], pooled[e + h]);
    __syncthreads();
    n = h;
  }
  if (t == 0) {
    const float mean = pooled[0] / static_cast<float>(block_chains);
    float lb = __fadd_rn(log_beta[blk], __fmul_rn(gamma, __fsub_rn(mean, target)));
    lb = lb < lo ? lo : (lb > hi ? hi : lb);  // a NaN stays NaN, as in the clip
    log_beta[blk] = lb;
    new_log_beta = lb;
  }
  __syncthreads();
  const float beta = expf(new_log_beta);
  for (int e = t; e < block_chains; e += blockDim.x) beta_out[first + e] = beta;
}

template <class Pot>
int launch_pcn_adapt(const typename Pot::Spec& pot, const IpxChainArgs& chain, float* phi,
                     float* acc, float* accept_prob, const float* log_beta, int step,
                     void* stream) {
  const typename Pot::Extent extent = Pot::extent(pot);
  const int threads = chain_threads(chain, extent.cells, pot.K, Pot::kMaxThreads);
  if (threads == 0 || !Pot::valid(pot) || chain.n % chain.block_chains || step < 0)
    return cudaErrorInvalidValue;
  if (chain.n == 0) return cudaSuccess;
  const PcnAdaptArgs<Pot> a{pot, chain, phi, acc, accept_prob, log_beta, step};
  const size_t smem = sizeof(float) * (chain.d + Pot::workspace_floats(extent));
  fused_pcn_adapt_kernel<Pot><<<chain.n, threads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ipx

extern "C" {

// One step of every chain: the move, Phi and the acceptance count in place,
// and each chain's acceptance probability.
int ipx_fused_pcn_adapt(const IpxGaussianSpec* pot, const IpxChainArgs* chain, float* phi,
                        float* acc, float* accept_prob, const float* log_beta, int step,
                        void* stream) {
  return ipx::launch_pcn_adapt<ipx::LinearGaussianPotential>(*pot, *chain, phi, acc,
                                                             accept_prob, log_beta, step,
                                                             stream);
}

// The blocks' pooled acceptance, log beta in place, beta per chain.
int ipx_pcn_adapt_update(const float* accept_prob, float* log_beta, float* beta_out, int n,
                         int block_chains, float gamma, float target, float lo, float hi,
                         void* stream) {
  if (block_chains <= 0 || n < 0 || n % block_chains) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const int threads = ipx::round_up32(block_chains < 1024 ? block_chains : 1024);
  ipx::pcn_adapt_update_kernel<<<n / block_chains, threads, sizeof(float) * block_chains,
                                 static_cast<cudaStream_t>(stream)>>>(
      accept_prob, log_beta, beta_out, block_chains, gamma, target, lo, hi);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
