// Hand-written Hopper kernels of the single-level pCN paths.
//
// Replaces the Pallas TPU kernel of ip_mcmc_tpu/ops/fused_mcmc.py as
// instantiated by fused_pcn_chain (l.1502) / fused_pcn_chain_recorded
// (l.1387) with _pcn_step_builder (K6, l.303), and by fused_pcn_chain_warm
// (l.1313) / fused_pcn_chain_warm_recorded (l.1351) with
// _make_pcn_warm_step_builder (K7, l.486) around
// darcy.make_batched_misfit_warm (ip_mcmc_tpu/models/darcy.py l.669).
//
//   darcy_misfit_warm_kernel       (U (K, B), x0 (n*n, B)) -> (Phi (B,),
//                                  x (n*n, B)): the warm-started misfit.
//   fused_pcn_kernel<Pot, RECORD>  cold pCN: proposal, Phi, MH. The
//                                  potential is a type: DarcyPotential
//                                  (Phi from x = 0) or BurgersPotential
//                                  (K12, burgers_misfit.cuh).
//   fused_pcn_warm_kernel<RECORD>  pCN carrying each chain's CG solution:
//                                  thread t keeps its cell of the accepted
//                                  x in a register, the proposal's solve
//                                  starts from it, and x follows the MH
//                                  select.
//
// Layout and scaffold: fused_scaffold.cuh (one CTA per chain, one thread
// per cell). Phi (and x) at the start positions come in from the
// standalone misfit kernels. Tags: normals 0 (keys 0, 1), MH uniform 2.
//
// What bounds them on the H100: per chain and step one solve (Burgers: the
// barrier per Godunov step, see burgers_misfit.cuh). The Darcy
// cold Jacobi solve of 48 CG iterations is ~0.3 M multiply-adds but ~100
// dependent block reductions of 256 threads, so barrier latency, not the
// f32 rate or memory, sets its time; the warm dst_trunc solve (4
// iterations, 64 modes) re-reads the 32 KB of bf16 modes from L1/L2 ten
// times per step. This first design keeps the factors in global memory and
// one chain per CTA: no staging, no wgmma, no TMA.
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "burgers_misfit.cuh"
#include "darcy_misfit.cuh"
#include "fused_scaffold.cuh"

namespace ipx {

__global__ void darcy_misfit_warm_kernel(IpxMisfitSpec s, const float* __restrict__ U,
                                         const float* __restrict__ x0, int B,
                                         float* __restrict__ phi, float* __restrict__ x_out) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, t = threadIdx.x, cells = s.n * s.n;
  float* u = smem;
  const MisfitSmem ws = carve_misfit_smem(smem + s.K, cells, s.modes);
  for (int k = t; k < s.K; k += blockDim.x) u[k] = U[static_cast<size_t>(k) * B + b];
  float x = t < cells ? x0[static_cast<size_t>(t) * B + b] : 0.0f;
  __syncthreads();
  const float v = darcy_solve<true>(s, u, ws, x);
  if (t < cells) x_out[static_cast<size_t>(t) * B + b] = x;
  if (t == 0) phi[b] = v;
}

template <class Pot>
struct PcnArgs {
  typename Pot::Spec pot;
  IpxChainArgs chain;
  const float* phi0;  // (n,) Phi at pos_in
  const float* x0;    // (cells, n) solutions at pos_in (warm only)
  float beta, contraction;
};

// K6 / K7: prop = m + sqrt(1 - beta^2) (pos - m) + beta scale xi; accept
// when log u < Phi(pos) - Phi(prop), so a NaN Phi(prop) rejects.
// WARM (Darcy only): x is this thread's cell of the accepted CG solution.
template <class Pot, bool WARM>
struct PcnStep {
  const PcnArgs<Pot>& a;
  float* pos;
  float* prop;
  typename Pot::Workspace ws;
  float phi, x;

  __device__ void init(const ChainCtx& c) {
    phi = a.phi0[c.c];
    x = 0.0f;
    if constexpr (WARM) {
      const int cells = a.pot.n * a.pot.n;
      if (c.t < cells) x = a.x0[static_cast<size_t>(c.t) * a.chain.n + c.c];
    }
  }

  __device__ bool step(const ChainCtx& c, uint32_t i) {
    if (c.own) {
      const float xi = c.scale_t * c.normal(i, 0u);
      prop[c.t] = c.mean_t + a.contraction * (pos[c.t] - c.mean_t) + a.beta * xi;
    }
    __syncthreads();
    float x_prop = x;
    float phi_prop;
    if constexpr (WARM) phi_prop = darcy_solve<true>(a.pot, prop, ws, x_prop);
    else phi_prop = Pot::phi(a.pot, prop, ws);
    const bool accept = logf(c.uniform(i, 2u)) < phi - phi_prop;
    if (accept) {
      phi = phi_prop;
      if (WARM) x = x_prop;
      if (c.own) pos[c.t] = prop[c.t];
    }
    return accept;
  }
};

template <class Pot, bool RECORD, bool WARM>
__device__ void pcn_chain(const PcnArgs<Pot>& a) {
  extern __shared__ float smem[];
  float* pos = smem;
  float* prop = pos + a.chain.d;
  PcnStep<Pot, WARM> step{a, pos, prop, Pot::carve(prop + a.chain.d, Pot::extent(a.pot)),
                          0.0f, 0.0f};
  run_chain<RECORD>(a.chain, step, pos);
}

template <class Pot, bool RECORD>
__global__ void __launch_bounds__(Pot::kMaxThreads, Pot::kMinCtasPerSm)
    fused_pcn_kernel(PcnArgs<Pot> a) {
  pcn_chain<Pot, RECORD, false>(a);
}

template <bool RECORD>
__global__ void __launch_bounds__(kFusedThreads, 4)
    fused_pcn_warm_kernel(PcnArgs<DarcyPotential> a) {
  pcn_chain<DarcyPotential, RECORD, true>(a);
}

// Launches fused_pcn_kernel<Pot, RECORD> (RECORD: chain.samples given).
template <class Pot>
int launch_pcn(const typename Pot::Spec& pot, const IpxChainArgs& chain, const float* phi0,
               float beta, float contraction, void* stream) {
  const typename Pot::Extent extent = Pot::extent(pot);
  const int threads = chain_threads(chain, extent.cells, pot.K, Pot::kMaxThreads);
  if (threads == 0 || !Pot::valid(pot)) return cudaErrorInvalidValue;
  if (chain.n == 0) return cudaSuccess;
  const PcnArgs<Pot> a{pot, chain, phi0, nullptr, beta, contraction};
  const size_t smem = sizeof(float) * (2 * chain.d + Pot::workspace_floats(extent));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (chain.samples != nullptr) fused_pcn_kernel<Pot, true><<<chain.n, threads, smem, st>>>(a);
  else fused_pcn_kernel<Pot, false><<<chain.n, threads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ipx

extern "C" {

int ipx_darcy_misfit_warm(const IpxMisfitSpec* s, const float* U, const float* x0, int B,
                          float* phi, float* x, void* stream) {
  const int cells = s->n * s->n;
  const int threads = ipx::round_up32(cells);
  if (threads > 1024 || s->K <= 0 || s->modes < 0 || B < 0) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  const size_t smem = sizeof(float) * (s->K + ipx::misfit_smem_floats(cells, s->modes));
  ipx::darcy_misfit_warm_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      *s, U, x0, B, phi, x);
  return static_cast<int>(cudaGetLastError());
}

// x0 == null: cold pCN (fused_pcn_kernel); else warm (fused_pcn_warm_kernel).
int ipx_fused_pcn(const IpxMisfitSpec* pot, const IpxChainArgs* chain, const float* phi0,
                  const float* x0, float beta, float contraction, void* stream) {
  if (x0 == nullptr)
    return ipx::launch_pcn<ipx::DarcyPotential>(*pot, *chain, phi0, beta, contraction, stream);
  const int cells = pot->n * pot->n;
  const int threads = ipx::chain_threads(*chain, cells, pot->K);
  if (threads == 0) return cudaErrorInvalidValue;
  if (chain->n == 0) return cudaSuccess;
  const ipx::PcnArgs<ipx::DarcyPotential> a{*pot, *chain, phi0, x0, beta, contraction};
  const size_t smem = sizeof(float) * (2 * chain->d + ipx::misfit_smem_floats(cells, pot->modes));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (chain->samples != nullptr)
    ipx::fused_pcn_warm_kernel<true><<<chain->n, threads, smem, st>>>(a);
  else
    ipx::fused_pcn_warm_kernel<false><<<chain->n, threads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int ipx_fused_pcn_burgers(const IpxBurgersSpec* pot, const IpxChainArgs* chain,
                          const float* phi0, float beta, float contraction, void* stream) {
  return ipx::launch_pcn<ipx::BurgersPotential>(*pot, *chain, phi0, beta, contraction, stream);
}

}  // extern "C"
