// Hand-written Hopper kernel of pCN with a dense Gaussian prior (K15).
//
// Replaces the Pallas TPU kernel of ip_mcmc_tpu/ops/fused_mcmc.py as
// instantiated by fused_pcn_chain_dense (l.1186) /
// fused_pcn_chain_dense_recorded (l.1218) with _pcn_dense_step_builder
// (K15, l.653).
//
//   fused_pcn_dense_group_kernel<RECORD, D, G>
//                                        the whole n_steps loop in one
//                                        launch: xi = L z,
//                                        prop = m + sqrt(1 - beta^2)
//                                        (pos - m) + beta xi, accepted
//                                        when log u < Phi(pos) - Phi(prop);
//                                        a chain on each group of G = d
//                                        lanes (at d = 32 a warp), no
//                                        CTA barrier, for the specs that
//                                        gaussian_group_takes (the shipped
//                                        lingauss_pcn target).
//   fused_pcn_dense_kernel<Pot, RECORD>  the same step, one chain a CTA,
//                                        on every other spec.
//
// L is the (d, d) prior Cholesky factor, passed transposed (L^T row-major).
// Thread (lane) t < d draws coordinate t of z (tags 0, 1) and forms row t
// of L z, sum over k = 0..d-1 in order (the whole row, as the TPU kernel's
// matmul does: a lower-triangular L adds exact zeros). One chain a CTA: z
// through shared memory after a barrier, L read at each k by the threads
// of a warp from neighbouring words. The group kernel: z[k] from lane k
// through the warp's shared memory (gather), row t of L in lane t's
// registers for the whole launch, the sum in the same order and form, so
// the chains keep the one-chain-a-CTA kernel's bits. The scaffold's
// per-coordinate prior scale does not enter: the wrapper passes ones. Phi
// at the start position is evaluated in the kernel, as the JAX step
// builder's init does. MH uniform: tag 2.
//
// What bounds it on the H100: per chain and step d^2 multiply-adds for the
// draw (1024 at d = 32) and one potential, a few MFLOP a step at 2048
// chains, far below the f32 rate, and no memory traffic but the records.
// The group kernel's step waits on its dependent chain (the normal draw,
// the gather and 32 multiply-adds of xi, those of the row sum, the
// butterfly); the one-chain-a-CTA kernel's also on three barriers and L
// through L1. The product stays on the CUDA cores: a 32 x 32 by 32 x 1
// product a chain fills no tensor-core tile.
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "fused_scaffold.cuh"
#include "gaussian_potential.cuh"

namespace ipx {

template <class Pot>
struct PcnDenseArgs {
  typename Pot::Spec pot;
  IpxChainArgs chain;  // mean: the prior mean; scale: ones (unused)
  const float* chol_t;  // (d, d) the prior Cholesky factor L, transposed
  float beta, contraction;
};

template <class Pot>
struct PcnDenseStep {
  const PcnDenseArgs<Pot>& a;
  float* pos;
  float* prop;
  float* z;  // [d] this step's standard normals
  typename Pot::Workspace ws;
  float phi;

  __device__ void init(const ChainCtx&) { phi = Pot::phi(a.pot, pos, ws); }

  __device__ bool step(const ChainCtx& c, uint32_t i) {
    const int d = c.d;
    if (c.own) z[c.t] = c.normal(i, 0u);
    __syncthreads();
    if (c.own) {
      float xi = 0.0f;
      for (int k = 0; k < d; ++k) xi += a.chol_t[static_cast<size_t>(k) * d + c.t] * z[k];
      prop[c.t] = c.mean_t + a.contraction * (pos[c.t] - c.mean_t) + a.beta * xi;
    }
    __syncthreads();
    const float phi_prop = Pot::phi(a.pot, prop, ws);
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
    fused_pcn_dense_kernel(PcnDenseArgs<Pot> a) {
  extern __shared__ float smem[];
  const int d = a.chain.d;
  float* pos = smem;
  float* prop = pos + d;
  float* z = prop + d;
  PcnDenseStep<Pot> step{a, pos, prop, z, Pot::carve(z + d, Pot::extent(a.pot)), 0.0f};
  run_chain<RECORD>(a.chain, step, pos);
}

template <class Pot>
int launch_pcn_dense(const typename Pot::Spec& pot, const IpxChainArgs& chain,
                     const float* chol_t, float beta, float contraction, void* stream) {
  const typename Pot::Extent extent = Pot::extent(pot);
  const int threads = chain_threads(chain, extent.cells, pot.K, Pot::kMaxThreads);
  if (threads == 0 || !Pot::valid(pot) || chol_t == nullptr) return cudaErrorInvalidValue;
  if (chain.n == 0) return cudaSuccess;
  const PcnDenseArgs<Pot> a{pot, chain, chol_t, beta, contraction};
  const size_t smem = sizeof(float) * (3 * chain.d + Pot::workspace_floats(extent));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (chain.samples != nullptr)
    fused_pcn_dense_kernel<Pot, true><<<chain.n, threads, smem, st>>>(a);
  else
    fused_pcn_dense_kernel<Pot, false><<<chain.n, threads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// --- a chain a group of lanes: K15 on the specs that gaussian_group_takes

// K15 on G lanes: lane t holds coordinate t of pos and row t of L (t < D)
// and row t of the potential. The product and the proposal in
// PcnDenseStep's order and form.
template <int D, int G>
struct PcnDenseGroupStep {
  using Ctx = GroupChainCtxT<D, G>;
  const PcnDenseArgs<LinearGaussianPotential>& a;
  GaussianGroupRow<D, G> row;
  float l[D];  // row t of L (t < D), else zeros
  float pos, phi;

  __device__ __forceinline__ void load() {
    const int t = Ctx::t();
#pragma unroll
    for (int k = 0; k < D; ++k) l[k] = Ctx::holds() ? a.chol_t[k * D + t] : 0.0f;
  }

  __device__ void init(const Ctx&) { phi = row.phi(pos); }

  __device__ bool step(const Ctx& x, uint32_t i) {
    float z[D];  // z_k, from lane k
    gather<D, G>(x.normal1(i, 0u), z);
    float xi = 0.0f;
#pragma unroll
    for (int k = 0; k < D; ++k) xi += l[k] * z[k];
    const float prop = x.mean + a.contraction * (pos - x.mean) + a.beta * xi;
    const float phi_prop = row.phi(prop);
    const bool accept = logf(x.uniform(i, 2u)) < phi - phi_prop;  // the same in the group
    phi = accept ? phi_prop : phi;
    pos = accept ? prop : pos;
    return accept;
  }
};

template <bool RECORD, int D, int G>
__global__ void __launch_bounds__(32 * GaussianGroupDesign::kWarps)
    fused_pcn_dense_group_kernel(const __grid_constant__ PcnDenseArgs<LinearGaussianPotential> a) {
  PcnDenseGroupStep<D, G> step{a};
  step.row.load(a.pot);
  step.load();
  run_group_chain<RECORD, D, G>(a.chain, step);
}

// Launches fused_pcn_dense_group_kernel<RECORD, d, G> (RECORD: chain.samples
// given) for a spec that gaussian_group_takes.
inline int launch_pcn_dense_group(const IpxGaussianSpec& pot, const IpxChainArgs& chain,
                                  const float* chol_t, float beta, float contraction,
                                  void* stream) {
  GaussianGroupGeometry geo;
  const int status = gaussian_group_geometry(pot, chain, &geo);
  if (status != cudaSuccess) return status;
  if (chol_t == nullptr) return cudaErrorInvalidValue;
  if (chain.n == 0) return cudaSuccess;
  const PcnDenseArgs<LinearGaussianPotential> a{pot, chain, chol_t, beta, contraction};
  const dim3 grid(geo.ctas), block(32 * geo.warps);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  constexpr int G2 = gaussian_group_width(2), G32 = gaussian_group_width(32);
  if (chain.d == 2 && chain.samples != nullptr)
    fused_pcn_dense_group_kernel<true, 2, G2><<<grid, block, 0, st>>>(a);
  else if (chain.d == 2)
    fused_pcn_dense_group_kernel<false, 2, G2><<<grid, block, 0, st>>>(a);
  else if (chain.samples != nullptr)
    fused_pcn_dense_group_kernel<true, 32, G32><<<grid, block, 0, st>>>(a);
  else
    fused_pcn_dense_group_kernel<false, 32, G32><<<grid, block, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ipx

extern "C" {

// What gaussian_group_takes (d = 2 or 32, m <= d) goes to
// fused_pcn_dense_group_kernel, every other spec to fused_pcn_dense_kernel,
// one chain a CTA.
int ipx_fused_pcn_dense(const IpxGaussianSpec* pot, const IpxChainArgs* chain,
                        const float* chol_t, float beta, float contraction, void* stream) {
  if (ipx::gaussian_group_takes(*pot, chain->d))
    return ipx::launch_pcn_dense_group(*pot, *chain, chol_t, beta, contraction, stream);
  return ipx::launch_pcn_dense<ipx::LinearGaussianPotential>(*pot, *chain, chol_t, beta,
                                                             contraction, stream);
}

}  // extern "C"
