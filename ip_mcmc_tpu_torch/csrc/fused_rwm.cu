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
//   linear_gaussian_misfit_grad_kernel
//                                  Phi and grad Phi (d, B) for such a
//                                  batch, one draw a CTA: the start
//                                  positions of the cold MALA kernel on a
//                                  linear-Gaussian spec (fused_mala.cu),
//                                  whose JAX step builder's init evaluates
//                                  the value and gradient.
//   fused_rwm_group_kernel<RECORD, D, G>
//                                  the whole n_steps loop in one launch:
//                                  prop = pos + step_size xi, accepted when
//                                  log u < Phi(pos) - Phi(prop), so a NaN
//                                  Phi(prop) rejects; a chain on each group
//                                  of G = d lanes, 32 / G a warp, no CTA
//                                  barrier (gaussian_potential.cuh), for
//                                  the linear-Gaussian specs that
//                                  gaussian_group_takes (d = 2 or 32, m <=
//                                  d: the shipped targets).
//   fused_rwm_kernel<Pot, RECORD>  the same step, one chain a CTA, on every
//                                  other LinearGaussianPotential spec and
//                                  on DarcyPotential (K5).
//
// With `prior` set the step adds 1/2 |(U - mean) / scale|^2 to the
// potential: the runner's fused RWM branch targets misfit + whitened prior,
// as the JAX runner's phi_full (runner.py l.637) does. Without it the
// potential is used as given (the JAX signature). Phi at the start position
// is evaluated in the kernel, as the JAX step builder's init does.
// Tags: normals 0 (keys 0, 1), MH uniform 2.
//
// What bounds it on the H100: per chain and step one potential, d normal
// draws and one or two sums. The group kernel keeps the state and the
// potential's rows in registers and pays no barrier, so the latency of a
// step's dependent chain (the normal draw, the row sum, one or two
// butterflies, the MH uniform) sets its time, hidden by the SM's other
// groups; 16 chains a warp at d = 2 fill the lanes that one chain a CTA left
// idle. The one-chain-a-CTA kernel keeps the position in shared memory and
// pays two barriers a block reduction (on Darcy: one cold solve, see
// fused_pcn.cu).
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

__global__ void __launch_bounds__(LinearGaussianPotential::kMaxThreads)
    linear_gaussian_misfit_grad_kernel(IpxGaussianSpec s, const float* __restrict__ U, int B,
                                       float* __restrict__ phi, float* __restrict__ grad) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  float* u = smem;
  float* g = u + s.K;
  const GaussianSmem ws =
      LinearGaussianPotential::carve(g + s.K, LinearGaussianPotential::extent(s));
  for (int k = threadIdx.x; k < s.K; k += blockDim.x) u[k] = U[static_cast<size_t>(k) * B + b];
  __syncthreads();
  const float v = gaussian_value_and_grad(s, u, ws, g);
  for (int k = threadIdx.x; k < s.K; k += blockDim.x) grad[static_cast<size_t>(k) * B + b] = g[k];
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

// --- a chain a group of lanes: K14 on the linear-Gaussian specs that
// gaussian_group_takes (see gaussian_potential.cuh) ------------------------

// K14 on G lanes: lane t holds coordinate t of pos (t < D) and row t of the
// potential. The proposal, Phi and the prior in the one-chain-a-CTA step's
// order and form (RwmStep), so the chains keep that kernel's bits.
template <int D, int G>
struct RwmGroupStep {
  using Ctx = GroupChainCtxT<D, G>;
  const RwmArgs<LinearGaussianPotential>& a;
  GaussianGroupRow<D, G> row;
  float pos, phi;

  // the potential at the group's state u, the prior added when asked for
  __device__ __forceinline__ float potential(const Ctx& x, float u) const {
    float v = row.phi(u);
    if (a.prior) {
      const float z = Ctx::holds() ? (u - x.mean) / x.scale : 0.0f;
      v = v + 0.5f * group_sum<G>(__fmul_rn(z, z));
    }
    return v;
  }

  __device__ void init(const Ctx& x) { phi = potential(x, pos); }

  __device__ bool step(const Ctx& x, uint32_t i) {
    const float prop = pos + a.step_size * x.normal1(i, 0u);
    const float phi_prop = potential(x, prop);
    const bool accept = logf(x.uniform(i, 2u)) < phi - phi_prop;  // the same in the group
    phi = accept ? phi_prop : phi;
    pos = accept ? prop : pos;
    return accept;
  }
};

template <bool RECORD, int D, int G>
__global__ void __launch_bounds__(32 * GaussianGroupDesign::kWarps)
    fused_rwm_group_kernel(const __grid_constant__ RwmArgs<LinearGaussianPotential> a) {
  RwmGroupStep<D, G> step{a};
  step.row.load(a.pot);
  run_group_chain<RECORD, D, G>(a.chain, step);
}

// Launches fused_rwm_group_kernel<RECORD, d, G> (RECORD: chain.samples
// given) for a spec that gaussian_group_takes.
inline int launch_rwm_group(const IpxGaussianSpec& pot, const IpxChainArgs& chain,
                            float step_size, int prior, void* stream) {
  GaussianGroupGeometry geo;
  const int status = gaussian_group_geometry(pot, chain, &geo);
  if (status != cudaSuccess) return status;
  if (chain.n == 0) return cudaSuccess;
  const RwmArgs<LinearGaussianPotential> a{pot, chain, step_size, prior};
  const dim3 grid(geo.ctas), block(32 * geo.warps);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  constexpr int G2 = gaussian_group_width(2), G32 = gaussian_group_width(32);
  if (chain.d == 2 && chain.samples != nullptr)
    fused_rwm_group_kernel<true, 2, G2><<<grid, block, 0, st>>>(a);
  else if (chain.d == 2)
    fused_rwm_group_kernel<false, 2, G2><<<grid, block, 0, st>>>(a);
  else if (chain.samples != nullptr)
    fused_rwm_group_kernel<true, 32, G32><<<grid, block, 0, st>>>(a);
  else
    fused_rwm_group_kernel<false, 32, G32><<<grid, block, 0, st>>>(a);
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

// Phi (B,) and grad Phi (d, B) for U (d, B), one draw a CTA.
int ipx_linear_gaussian_misfit_grad(const IpxGaussianSpec* s, const float* U, int B, float* phi,
                                    float* grad, void* stream) {
  using ipx::LinearGaussianPotential;
  const LinearGaussianPotential::Extent e = LinearGaussianPotential::extent(*s);
  const int threads = ipx::round_up32(e.cells > s->K ? e.cells : s->K);
  if (!LinearGaussianPotential::valid(*s) || B < 0) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  const size_t smem =
      sizeof(float) * (2 * s->K + LinearGaussianPotential::grad_workspace_floats(*s));
  ipx::linear_gaussian_misfit_grad_kernel<<<B, threads, smem,
                                            static_cast<cudaStream_t>(stream)>>>(*s, U, B, phi,
                                                                                 grad);
  return static_cast<int>(cudaGetLastError());
}

// prior != 0: the step adds the whitened prior of chain->mean / chain->scale.
// What gaussian_group_takes (d = 2 or 32, m <= d) goes to
// fused_rwm_group_kernel, every other spec to fused_rwm_kernel, one chain a
// CTA.
int ipx_fused_rwm(const IpxGaussianSpec* pot, const IpxChainArgs* chain, float step_size,
                  int prior, void* stream) {
  if (ipx::gaussian_group_takes(*pot, chain->d))
    return ipx::launch_rwm_group(*pot, *chain, step_size, prior, stream);
  return ipx::launch_rwm<ipx::LinearGaussianPotential>(*pot, *chain, step_size, prior, stream);
}

// The launch geometry of fused_rwm_group_kernel and of
// fused_pcn_dense_group_kernel for this spec and these chain arguments: out
// = {lanes a chain, warps a CTA, CTAs}; the status the launch would return
// for them, cudaErrorNotSupported for a spec that goes to the
// one-chain-a-CTA kernels (the wrappers' mirror is checked against this on
// the card).
int ipx_gaussian_group_geometry(const IpxGaussianSpec* pot, const IpxChainArgs* chain,
                                int* out) {
  ipx::GaussianGroupGeometry geo{0, 0, 0};
  const int status = ipx::gaussian_group_geometry(*pot, *chain, &geo);
  out[0] = geo.width;
  out[1] = geo.warps;
  out[2] = geo.ctas;
  return status;
}

int ipx_fused_rwm_darcy(const IpxMisfitSpec* pot, const IpxChainArgs* chain, float step_size,
                        int prior, void* stream) {
  return ipx::launch_rwm<ipx::DarcyPotential>(*pot, *chain, step_size, prior, stream);
}

}  // extern "C"
