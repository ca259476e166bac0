// Hand-written Hopper kernels of random-walk Metropolis (K14), and the
// standalone linear-Gaussian misfit.
//
// Replaces the Pallas TPU kernel of ip_mcmc_tpu/ops/fused_mcmc.py as
// instantiated by fused_rwm_chain (l.1419) / fused_rwm_chain_recorded
// (l.1483) with _rwm_step_builder (K14, l.284).
//
//   linear_gaussian_misfit_kernel  Phi for a (d, B) batch at one
//                                  linear-Gaussian spec
//                                  (gaussian_potential.cuh).
//   fused_rwm_kernel<Pot, RECORD>  the whole n_steps loop in one launch:
//                                  prop = pos + step_size xi, accepted when
//                                  log u < Phi(pos) - Phi(prop), so a NaN
//                                  Phi(prop) rejects. The potential is a
//                                  type: LinearGaussianPotential or
//                                  DarcyPotential (K5).
//
// With `prior` set the step adds 1/2 |(U - mean) / scale|^2 to the
// potential: the runner's fused RWM branch targets misfit + whitened prior,
// as the JAX runner's phi_full (runner.py l.637) does. Without it the
// potential is used as given (the JAX signature). Phi at the start position
// is evaluated in the kernel, as the JAX step builder's init does.
// Tags: normals 0 (keys 0, 1), MH uniform 2.
//
// What bounds it on the H100: per chain and step one potential, d normal
// draws and one or two block reductions. On the linear-Gaussian targets
// (d <= 32, one warp per chain) that is a few hundred dependent
// instructions and four barriers per step, so latency and the 32 resident
// CTAs per SM, not the f32 rate or memory, set the time; on Darcy one cold
// solve (see fused_pcn.cu). One chain per CTA, the position in shared
// memory, no staging.
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "darcy_misfit.cuh"
#include "fused_scaffold.cuh"
#include "gaussian_potential.cuh"

namespace ipx {

__global__ void __launch_bounds__(LinearGaussianPotential::kMaxThreads)
    linear_gaussian_misfit_kernel(IpxGaussianSpec s, const float* __restrict__ U, int B,
                                  float* __restrict__ phi) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  float* u = smem;
  const GaussianSmem ws =
      LinearGaussianPotential::carve(smem + s.K, LinearGaussianPotential::extent(s));
  for (int k = threadIdx.x; k < s.K; k += blockDim.x) u[k] = U[static_cast<size_t>(k) * B + b];
  __syncthreads();
  const float v = gaussian_phi(s, u, ws);
  if (threadIdx.x == 0) phi[b] = v;
}

template <class Pot>
struct RwmArgs {
  typename Pot::Spec pot;
  IpxChainArgs chain;  // mean / scale: the whitened prior when `prior` is set
  float step_size;
  int prior;
};

template <class Pot>
struct RwmStep {
  const RwmArgs<Pot>& a;
  float* pos;
  float* prop;
  typename Pot::Workspace ws;
  float phi;

  // the potential at u (in shared memory), the prior added when asked for
  __device__ float potential(const ChainCtx& c, const float* u) const {
    float v = Pot::phi(a.pot, u, ws);
    if (a.prior) {
      const float z = c.own ? (u[c.t] - c.mean_t) / c.scale_t : 0.0f;
      v = v + 0.5f * block_sum(z * z, ws.red);
    }
    return v;
  }

  __device__ void init(const ChainCtx& c) { phi = potential(c, pos); }

  __device__ bool step(const ChainCtx& c, uint32_t i) {
    if (c.own) prop[c.t] = pos[c.t] + a.step_size * c.normal(i, 0u);
    __syncthreads();
    const float phi_prop = potential(c, prop);
    const bool accept = logf(c.uniform(i, 2u)) < phi - phi_prop;
    if (accept) {
      phi = phi_prop;
      if (c.own) pos[c.t] = prop[c.t];
    }
    return accept;
  }
};

template <class Pot, bool RECORD>
__global__ void __launch_bounds__(Pot::kMaxThreads, Pot::kMinCtasPerSm)
    fused_rwm_kernel(RwmArgs<Pot> a) {
  extern __shared__ float smem[];
  float* pos = smem;
  float* prop = pos + a.chain.d;
  RwmStep<Pot> step{a, pos, prop, Pot::carve(prop + a.chain.d, Pot::extent(a.pot)), 0.0f};
  run_chain<RECORD>(a.chain, step, pos);
}

// Launches fused_rwm_kernel<Pot, RECORD> (RECORD: chain.samples given).
template <class Pot>
int launch_rwm(const typename Pot::Spec& pot, const IpxChainArgs& chain, float step_size,
               int prior, void* stream) {
  const typename Pot::Extent extent = Pot::extent(pot);
  const int threads = chain_threads(chain, extent.cells, pot.K, Pot::kMaxThreads);
  if (threads == 0 || !Pot::valid(pot)) return cudaErrorInvalidValue;
  if (chain.n == 0) return cudaSuccess;
  const RwmArgs<Pot> a{pot, chain, step_size, prior};
  const size_t smem = sizeof(float) * (2 * chain.d + Pot::workspace_floats(extent));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (chain.samples != nullptr) fused_rwm_kernel<Pot, true><<<chain.n, threads, smem, st>>>(a);
  else fused_rwm_kernel<Pot, false><<<chain.n, threads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ipx

extern "C" {

int ipx_linear_gaussian_misfit(const IpxGaussianSpec* s, const float* U, int B, float* phi,
                               void* stream) {
  using ipx::LinearGaussianPotential;
  const LinearGaussianPotential::Extent e = LinearGaussianPotential::extent(*s);
  const int threads = ipx::round_up32(e.cells > s->K ? e.cells : s->K);
  if (!LinearGaussianPotential::valid(*s) || B < 0) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  const size_t smem = sizeof(float) * (s->K + LinearGaussianPotential::workspace_floats(e));
  ipx::linear_gaussian_misfit_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      *s, U, B, phi);
  return static_cast<int>(cudaGetLastError());
}

// prior != 0: the step adds the whitened prior of chain->mean / chain->scale.
int ipx_fused_rwm(const IpxGaussianSpec* pot, const IpxChainArgs* chain, float step_size,
                  int prior, void* stream) {
  return ipx::launch_rwm<ipx::LinearGaussianPotential>(*pot, *chain, step_size, prior, stream);
}

int ipx_fused_rwm_darcy(const IpxMisfitSpec* pot, const IpxChainArgs* chain, float step_size,
                        int prior, void* stream) {
  return ipx::launch_rwm<ipx::DarcyPotential>(*pot, *chain, step_size, prior, stream);
}

}  // extern "C"
