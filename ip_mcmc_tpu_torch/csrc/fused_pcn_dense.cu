// Hand-written Hopper kernel of pCN with a dense Gaussian prior (K15).
//
// Replaces the Pallas TPU kernel of ip_mcmc_tpu/ops/fused_mcmc.py as
// instantiated by fused_pcn_chain_dense (l.1186) /
// fused_pcn_chain_dense_recorded (l.1218) with _pcn_dense_step_builder
// (K15, l.653).
//
//   fused_pcn_dense_kernel<Pot, RECORD>  the whole n_steps loop in one
//                                        launch: xi = L z,
//                                        prop = m + sqrt(1 - beta^2)
//                                        (pos - m) + beta xi, accepted
//                                        when log u < Phi(pos) - Phi(prop).
//
// L is the (d, d) prior Cholesky factor, passed transposed (L^T row-major,
// so that at each k the threads of a warp read neighbouring words). Each
// thread t < d draws coordinate t of z (tags 0, 1) into shared memory;
// after a barrier thread t forms row t of L z, sum over k = 0..d-1 in
// order (the whole row, as the TPU kernel's matmul does: a
// lower-triangular L adds exact zeros).
// The scaffold's per-coordinate prior scale does not enter: the wrapper
// passes ones. Phi at the start position is evaluated in the kernel, as
// the JAX step builder's init does. MH uniform: tag 2.
//
// What bounds it on the H100: per chain and step d^2 multiply-adds for the
// draw (1024 at d = 32) and one potential; at the configs' sizes the
// dependent row sums and the three barriers of a step set the time, not
// the f32 rate (a step at 2048 chains is a few MFLOP) or memory (L stays in
// L1). One chain per CTA; the product is on the CUDA cores, since a 32 x 32
// by 32 x 1 product per chain fills no tensor-core tile.
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

}  // namespace ipx

extern "C" {

int ipx_fused_pcn_dense(const IpxGaussianSpec* pot, const IpxChainArgs* chain,
                        const float* chol_t, float beta, float contraction, void* stream) {
  return ipx::launch_pcn_dense<ipx::LinearGaussianPotential>(*pot, *chain, chol_t, beta,
                                                             contraction, stream);
}

}  // extern "C"
