// Hand-written Hopper kernels of the gradient-based Darcy paths.
//
// Replaces the Pallas TPU kernel of ip_mcmc_tpu/ops/fused_mcmc.py as
// instantiated by fused_mala_chain (l.1439) / fused_mala_chain_recorded
// (l.1462) with _mala_step_builder (K10, l.784) around the value-and-grad
// of darcy.make_batched_misfit(differentiable=True)
// (ip_mcmc_tpu/models/darcy.py l.629-666), and by fused_mala_chain_warm
// (l.1028) / fused_mala_chain_warm_recorded (l.1068) with
// _make_mala_warm_step_builder (K11, l.732) around
// darcy.make_batched_misfit_mala_warm (l.783).
//
//   darcy_misfit_grad_kernel       U (K, B) -> Phi (B,), grad (K, B): both
//                                  solves from zero.
//   darcy_misfit_grad_warm_kernel  (U, aux0 (2 n*n, B)) -> Phi, grad, aux:
//                                  rows [0, n*n) of aux carry the forward
//                                  solution, rows [n*n, 2 n*n) the adjoint
//                                  one; both solves start from aux0.
//   fused_mala_kernel<RECORD>      MALA on Phi + the whitened prior.
//   fused_mala_warm_kernel<RECORD> the same, each chain carrying the two
//                                  solutions of its current state.
//
// One step: prop = pos - eps^2/2 g + eps xi, value and gradient at prop,
// log ratio (phi - phi') + log q(pos | prop) - log q(prop | pos) with NaN
// mapped to -inf, accept when log u < log ratio. phi and g include the
// prior term 1/2 |z|^2, z = (u - mean) / scale (gradient z / scale): the
// TPU kernel inlines a closure that adds it (K10) or adds it in the step
// builder (K11); a CUDA kernel takes the prior as arguments.
// Tags: normals 0 (keys 0, 1), MH uniform 2.
//
// Layout and scaffold: fused_scaffold.cuh (one CTA per chain, one thread
// per cell). The sums over the d coordinates are block reductions, so every
// thread takes the same decision. Phi, the gradient (and the solutions) at
// the start positions come in from the standalone kernels. The carried
// solutions of the accepted state sit in shared memory, not in registers:
// only their owner thread reads them.
//
// What bounds them on the H100: per chain and step two Darcy solves on one
// operator (see fused_pcn.cu: dependent block reductions, not the f32
// rate), and two reductions of 64 modes x 256 cells for the KL products.
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "darcy_misfit.cuh"
#include "fused_scaffold.cuh"

namespace ipx {

template <bool WARM>
__global__ void darcy_misfit_grad_kernel(IpxMisfitSpec s, const float* __restrict__ U,
                                         const float* __restrict__ aux0, int B,
                                         float* __restrict__ phi, float* __restrict__ grad,
                                         float* __restrict__ aux) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, t = threadIdx.x, cells = s.n * s.n;
  float* u = smem;
  float* g = u + s.K;
  const MisfitSmem ws = carve_misfit_smem(g + s.K, cells, s.modes);
  const GradSmem gs = carve_grad_smem(g + s.K + misfit_smem_floats(cells, s.modes), cells);
  for (int k = t; k < s.K; k += blockDim.x) u[k] = U[static_cast<size_t>(k) * B + b];
  if (WARM && t < cells) {
    gs.x[t] = aux0[static_cast<size_t>(t) * B + b];
    gs.lam[t] = aux0[static_cast<size_t>(cells + t) * B + b];
  }
  __syncthreads();
  const float v = darcy_value_and_grad<WARM>(s, u, ws, gs, g);
  for (int k = t; k < s.K; k += blockDim.x) grad[static_cast<size_t>(k) * B + b] = g[k];
  if (WARM && t < cells) {
    aux[static_cast<size_t>(t) * B + b] = gs.x[t];
    aux[static_cast<size_t>(cells + t) * B + b] = gs.lam[t];
  }
  if (t == 0) phi[b] = v;
}

struct MalaArgs {
  IpxMisfitSpec pot;
  IpxChainArgs chain;
  const float* phi0;  // (n,) misfit at pos_in
  const float* g0;    // (d, n) its gradient
  const float* aux0;  // (2 cells, n) solutions at pos_in (warm only)
  float eps;
};

template <bool WARM>
struct MalaStep {
  const MalaArgs& a;
  float* pos;
  float* prop;
  float* gp;  // gradient of the misfit at the proposal
  MisfitSmem ws;
  GradSmem gs;
  float* xs;  // [cells] forward solution of the accepted state (warm)
  float* ls;  // [cells] adjoint solution of the accepted state (warm)
  float phi, g;

  // adds the prior's 1/2 |z|^2 to phi_v and z / scale to this thread's g_v
  __device__ void fold(const ChainCtx& c, const float* u, float& phi_v, float& g_v) const {
    const float z = c.own ? (u[c.t] - c.mean_t) / c.scale_t : 0.0f;
    phi_v = phi_v + 0.5f * block_sum(z * z, ws.red);
    if (c.own) g_v = g_v + z / c.scale_t;
  }

  __device__ void init(const ChainCtx& c) {
    const int n = a.chain.n, cells = a.pot.n * a.pot.n;
    phi = a.phi0[c.c];
    g = c.own ? a.g0[static_cast<size_t>(c.t) * n + c.c] : 0.0f;
    fold(c, pos, phi, g);
    if (WARM && c.t < cells) {
      xs[c.t] = a.aux0[static_cast<size_t>(c.t) * n + c.c];
      ls[c.t] = a.aux0[static_cast<size_t>(cells + c.t) * n + c.c];
    }
  }

  __device__ bool step(const ChainCtx& c, uint32_t i) {
    const int cells = a.pot.n * a.pot.n;
    const float eps = a.eps;
    const float half_eps2 = 0.5f * eps * eps;
    const float inv2e2 = 1.0f / (2.0f * eps * eps);
    float xi = 0.0f;
    if (c.own) {
      xi = c.normal(i, 0u);
      prop[c.t] = (pos[c.t] - half_eps2 * g) + eps * xi;
    }
    if (WARM && c.t < cells) {
      gs.x[c.t] = xs[c.t];
      gs.lam[c.t] = ls[c.t];
    }
    __syncthreads();
    float phi_p = darcy_value_and_grad<WARM>(a.pot, prop, ws, gs, gp);
    float g_p = c.own ? gp[c.t] : 0.0f;
    fold(c, prop, phi_p, g_p);
    const float d_rev = c.own ? pos[c.t] - (prop[c.t] - half_eps2 * g_p) : 0.0f;
    const float log_q_rev = -block_sum(d_rev * d_rev, ws.red) * inv2e2;
    const float log_q_fwd = -block_sum(xi * xi, ws.red) * 0.5f;
    float log_ratio = (phi - phi_p) + log_q_rev - log_q_fwd;
    if (isnan(log_ratio)) log_ratio = -INFINITY;
    const bool accept = logf(c.uniform(i, 2u)) < log_ratio;
    if (accept) {
      phi = phi_p;
      g = g_p;
      if (c.own) pos[c.t] = prop[c.t];
      if (WARM && c.t < cells) {
        xs[c.t] = gs.x[c.t];
        ls[c.t] = gs.lam[c.t];
      }
    }
    return accept;
  }
};

inline size_t mala_smem_floats(int d, int cells, int modes, int m, bool warm) {
  return 3 * d + misfit_smem_floats(cells, modes) + grad_smem_floats(cells, m) +
         (warm ? 2 * cells : 0);
}

template <bool RECORD, bool WARM>
__device__ void mala_chain(const MalaArgs& a) {
  extern __shared__ float smem[];
  const int d = a.chain.d, cells = a.pot.n * a.pot.n;
  float* pos = smem;
  float* prop = pos + d;
  float* gp = prop + d;
  float* work = gp + d;
  float* grad = work + misfit_smem_floats(cells, a.pot.modes);
  float* xs = grad + grad_smem_floats(cells, a.pot.m);
  MalaStep<WARM> step{a,  pos, prop, gp, carve_misfit_smem(work, cells, a.pot.modes),
                      carve_grad_smem(grad, cells), xs, xs + cells, 0.0f, 0.0f};
  run_chain<RECORD>(a.chain, step, pos);
}

template <bool RECORD>
__global__ void __launch_bounds__(kFusedThreads, 4) fused_mala_kernel(MalaArgs a) {
  mala_chain<RECORD, false>(a);
}

template <bool RECORD>
__global__ void __launch_bounds__(kFusedThreads, 4) fused_mala_warm_kernel(MalaArgs a) {
  mala_chain<RECORD, true>(a);
}

}  // namespace ipx

extern "C" {

// aux0 == null: both solves from zero (darcy_misfit_grad_kernel); else from
// aux0, and aux receives the solutions (darcy_misfit_grad_warm_kernel).
int ipx_darcy_misfit_grad(const IpxMisfitSpec* s, const float* U, const float* aux0, int B,
                          float* phi, float* grad, float* aux, void* stream) {
  const int cells = s->n * s->n;
  const int threads = ipx::round_up32(cells);
  if (threads > 1024 || s->K <= 0 || s->modes < 0 || B < 0 || s->solver != kSolverCg)
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  const size_t smem = sizeof(float) * (2 * s->K + ipx::misfit_smem_floats(cells, s->modes) +
                                       ipx::grad_smem_floats(cells, s->m));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (aux0 == nullptr)
    ipx::darcy_misfit_grad_kernel<false><<<B, threads, smem, st>>>(*s, U, nullptr, B, phi, grad,
                                                                  nullptr);
  else
    ipx::darcy_misfit_grad_kernel<true><<<B, threads, smem, st>>>(*s, U, aux0, B, phi, grad, aux);
  return static_cast<int>(cudaGetLastError());
}

// aux0 == null: cold MALA (fused_mala_kernel); else warm
// (fused_mala_warm_kernel).
int ipx_fused_mala(const IpxMisfitSpec* pot, const IpxChainArgs* chain, const float* phi0,
                   const float* g0, const float* aux0, float eps, void* stream) {
  const int cells = pot->n * pot->n;
  const int threads = ipx::chain_threads(*chain, cells, pot->K);
  if (threads == 0 || pot->solver != kSolverCg) return cudaErrorInvalidValue;
  if (chain->n == 0) return cudaSuccess;
  const ipx::MalaArgs a{*pot, *chain, phi0, g0, aux0, eps};
  const bool warm = aux0 != nullptr;
  const size_t smem =
      sizeof(float) * ipx::mala_smem_floats(chain->d, cells, pot->modes, pot->m, warm);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool record = chain->samples != nullptr;
  const int n = chain->n;
  if (!warm) {
    if (record) ipx::fused_mala_kernel<true><<<n, threads, smem, st>>>(a);
    else ipx::fused_mala_kernel<false><<<n, threads, smem, st>>>(a);
  } else {
    if (record) ipx::fused_mala_warm_kernel<true><<<n, threads, smem, st>>>(a);
    else ipx::fused_mala_warm_kernel<false><<<n, threads, smem, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
