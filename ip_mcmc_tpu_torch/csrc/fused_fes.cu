// Hand-written Hopper kernel of the fused functional ensemble sampler on
// Darcy.
//
// Replaces the Pallas TPU kernel of ip_mcmc_tpu/ops/fused_mcmc.py as
// instantiated by fused_fes_chain (l.1105) / fused_fes_chain_recorded
// (l.1148) with _make_fes_step_builder (K9, l.571).
//
//   fused_fes_kernel<RECORD>  one step of the chains of one lane parity:
//                             the affine stretch move on the first M
//                             whitened coordinates against a partner chain
//                             of the other parity, then pCN on the rest.
//
// Each block of block_chains chains is one walker ensemble. A step is two
// red-black sub-steps: in sub-step `sub` the chains whose lane has parity
// `sub` move, w' = partner + z (w - partner) on rows < M with
// z = ((a - 1) u + 1)^2 / a, partner = lane - shift (mod block_chains), the
// shift odd and drawn once for the block, so the partner has the other
// parity and stands still during the sub-step. The log ratio is
// (M - 1) log z - (Phi' - Phi) - 1/2 sum_{rows < M} (w'^2 - w^2), NaN mapped
// to -inf. The pCN move on rows >= M follows.
//
// Synchronisation. A chain reads another chain's state, and all chains of
// parity 0 must have finished sub-step 0 before a chain of parity 1 reads
// them in sub-step 1 (and sub-step 1 of step i before sub-step 0 of step
// i + 1). 256 chains of 256 threads fit no CTA and no cluster, so the state
// lives in global memory and the host launches this kernel twice per step,
// once per parity, on one stream: stream order is the barrier. The host
// loop takes the place of run_chain's step loop. Within a launch only
// chains of one parity write and only chains of the other are read, so the
// update is in place. A chain of the wrong parity can never accept in a
// sub-step, so it is not evaluated there (the TPU kernel evaluates every
// lane in both sub-steps behind the parity mask: 3 misfit calls per step;
// here 2 per chain and step). Its pCN move touches rows >= M only, which no
// partner reads, so a chain does its stretch and its pCN move in the same
// launch; the counter RNG makes the order of the draws irrelevant.
//
// Tags: sub-step 0 shift 32, z 34, MH 36; sub-step 1 40, 42, 44; pCN
// normals 48 (keys 48, 49), MH 52.
//
// What bounds it on the H100: two cold Darcy solves per chain and step (see
// fused_pcn.cu) and two launches per step, each with half the chains.
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "darcy_misfit.cuh"
#include "fused_scaffold.cuh"

namespace ipx {

struct FesArgs {
  IpxMisfitSpec pot;
  IpxChainArgs chain;  // pos_in: the state (n, d), updated in place; out and acc are null
  float* phi;          // (n,) Phi of the state, updated in place
  float* pcn_acc;      // (n,) accepted pCN moves so far
  float* st_acc;       // (n,) accepted stretch moves so far
  float* record;       // (n, d) where <true> stores the new state
  float beta, contraction, stretch_a;
  int n_low, step, sub;
};

template <bool RECORD>
__global__ void __launch_bounds__(kFusedThreads, 4) fused_fes_kernel(FesArgs a) {
  extern __shared__ float smem[];
  const int d = a.chain.d, cells = a.pot.n * a.pot.n, bc = a.chain.block_chains;
  // CTA b runs the chain of lane 2 (b mod bc/2) + sub in block b / (bc/2)
  const int half = bc / 2;
  const int blk = blockIdx.x / half, my_lane = 2 * (blockIdx.x % half) + a.sub;
  const ChainCtx c = make_chain_ctx(a.chain, blk * bc + my_lane);
  float* pos = const_cast<float*>(a.chain.pos_in);
  float* prop = smem;
  const MisfitSmem ws = carve_misfit_smem(prop + d, cells, a.pot.modes);
  const uint32_t i = static_cast<uint32_t>(a.step);
  const bool low = c.t < a.n_low;
  const size_t row = static_cast<size_t>(c.c) * d;

  float phi = a.phi[c.c];
  float w = c.own ? (pos[row + c.t] - c.mean_t) / c.scale_t : 0.0f;

  // the stretch move of sub-step a.sub
  const uint32_t tag0 = a.sub ? 40u : 32u;
  const int shift = static_cast<int>(floorf(c.block_uniform(i, tag0) * static_cast<float>(half))) * 2 + 1;
  const int partner = blk * bc + ((my_lane - shift) % bc + bc) % bc;
  const float uz = c.uniform(i, tag0 + 2u);
  const float zq = (a.stretch_a - 1.0f) * uz + 1.0f;
  const float z = zq * zq / a.stretch_a;
  float w_prop = w;
  if (c.own && low) {
    const float wp = (pos[static_cast<size_t>(partner) * d + c.t] - c.mean_t) / c.scale_t;
    w_prop = wp + z * (w - wp);
  }
  if (c.own) prop[c.t] = c.mean_t + c.scale_t * w_prop;
  __syncthreads();
  float phi_p = darcy_phi(a.pot, prop, ws);
  const float d_prior =
      0.5f * block_sum((c.own && low) ? w_prop * w_prop - w * w : 0.0f, ws.red);
  float log_ratio = static_cast<float>(a.n_low - 1) * logf(z) - (phi_p - phi) - d_prior;
  if (isnan(log_ratio)) log_ratio = -INFINITY;
  const bool st_ok = logf(c.uniform(i, tag0 + 4u)) < log_ratio;
  if (st_ok) {
    w = w_prop;
    phi = phi_p;
  }

  // pCN on the complement rows
  w_prop = w;
  if (c.own && !low) w_prop = a.contraction * w + a.beta * c.normal(i, 48u);
  if (c.own) prop[c.t] = c.mean_t + c.scale_t * w_prop;
  __syncthreads();
  phi_p = darcy_phi(a.pot, prop, ws);
  const bool ok = logf(c.uniform(i, 52u)) < phi - phi_p;
  if (ok) {
    w = w_prop;
    phi = phi_p;
  }

  if (c.own) {
    const float v = c.mean_t + c.scale_t * w;
    pos[row + c.t] = v;
    if (RECORD) a.record[row + c.t] = v;
  }
  if (c.t == 0) {
    a.phi[c.c] = phi;
    if (st_ok) a.st_acc[c.c] += 1.0f;
    if (ok) a.pcn_acc[c.c] += 1.0f;
  }
}

}  // namespace ipx

extern "C" {

// One launch: step `step`, the chains of parity `sub`. `record`: where this
// launch stores its chains' new state, or null.
int ipx_fused_fes(const IpxMisfitSpec* pot, const IpxChainArgs* chain, float* phi,
                  float* pcn_acc, float* st_acc, float* record, float beta, float contraction,
                  float stretch_a, int n_low, int step, int sub, void* stream) {
  const int cells = pot->n * pot->n;
  const int threads = ipx::chain_threads(*chain, cells, pot->K);
  if (threads == 0 || pot->solver != kSolverCg || chain->block_chains % 2 ||
      chain->n % chain->block_chains || n_low < 0 || n_low > chain->d || step < 0 ||
      (sub != 0 && sub != 1))
    return cudaErrorInvalidValue;
  if (chain->n == 0) return cudaSuccess;
  const ipx::FesArgs a{*pot, *chain, phi, pcn_acc, st_acc, record, beta, contraction,
                       stretch_a, n_low, step, sub};
  const size_t smem = sizeof(float) * (chain->d + ipx::misfit_smem_floats(cells, pot->modes));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (record != nullptr) ipx::fused_fes_kernel<true><<<chain->n / 2, threads, smem, st>>>(a);
  else ipx::fused_fes_kernel<false><<<chain->n / 2, threads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
