// Hand-written Hopper kernels of the three-level delayed-acceptance pCN
// path on the Burgers problem.
//
// Replaces the Pallas TPU kernel of ip_mcmc_tpu/ops/fused_mcmc.py as
// instantiated by fused_da3_pcn_chain (l.1574) and
// fused_da3_pcn_chain_recorded (l.1614): the step builder
// _make_da3_pcn_step_builder (K13, l.391) as a step on the scaffold of
// fused_scaffold.cuh (K2, K3), with the counter-hash RNG (K1) and the
// inlined Burgers misfits (K12, burgers_misfit.cuh; replaces
// ip_mcmc_tpu/models/burgers.py make_batched_misfit l.153).
//
//   burgers_misfit_kernel              Phi for a (K, B) batch at one
//                                      Burgers misfit spec.
//   fused_da3_pcn_kernel<Pot, RECORD>  the whole n_steps loop in one
//                                      launch.
//
// Per outer step: k_mid times (k_inner pCN steps against the coarse
// potential, then a middle correction), then one fine correction. Layout:
// one CTA per chain, one thread per cell of the largest grid (128; the
// 64-cell coarse level uses half of them). The chain keeps four positions
// in shared memory (outer, middle-level, inner, proposal) and seven
// potential values in registers. Phi at the start positions comes in from
// three burgers_misfit_kernel launches.
//
// What bounds it on the H100: at the shipped k_inner = 8, k_mid = 24 an
// outer step is 192 coarse solves of 26 Godunov steps, 24 middle solves of
// 52 and one fine solve of 154: 6394 dependent time steps, each 13 f32
// operations per cell behind one block barrier, so barrier latency sets
// the time (see burgers_misfit.cuh); memory sees the positions in and out
// and the records only.
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "burgers_misfit.cuh"
#include "fused_scaffold.cuh"

namespace ipx {

__global__ void __launch_bounds__(1024)
    burgers_misfit_kernel(IpxBurgersSpec s, const float* __restrict__ U, int B,
                          float* __restrict__ phi) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  float* u = smem;
  const BurgersSmem ws = BurgersPotential::carve(smem + s.K, BurgersPotential::extent(s));
  for (int k = threadIdx.x; k < s.K; k += blockDim.x) u[k] = U[static_cast<size_t>(k) * B + b];
  __syncthreads();
  const float v = burgers_phi(s, u, ws);
  if (threadIdx.x == 0) phi[b] = v;
}

template <class Pot>
struct Da3Args {
  typename Pot::Spec fine, mid, coarse;
  IpxChainArgs chain;
  const float* phi0;   // (n,) fine Phi at pos_in
  const float* mid0;   // (n,) middle Phi at pos_in
  const float* surr0;  // (n,) coarse Phi at pos_in
  float beta, contraction;
  int k_inner, k_mid;
  float* mid_rate;  // (n,) middle-correction acceptance rate
};

// K13. Tags as in the JAX step builder (l.442-466): inner step (j2, j1)
// draws its normals with t = 4 (j2 k_inner + j1) (keys t, t + 1) and its
// uniform with t + 2; middle correction j2 uses 4 k_inner k_mid + 4 j2 + 2,
// the fine correction 4 k_inner k_mid + 4 k_mid + 2. A NaN correction
// ratio maps to -inf; every inner MH test is log u < delta, so NaN rejects.
template <class Pot>
struct Da3Step {
 const Da3Args<Pot>& a;
  float* pos0;                       // outer state
  float* pos;                        // middle-level state
  float* p1;                         // inner (coarse) state
  float* prop;                       // proposal
  typename Pot::Workspace ws;
  float phi0, mid0, surr0, mid_acc;

  __device__ void init(const ChainCtx& c) {
    phi0 = a.phi0[c.c];
    mid0 = a.mid0[c.c];
    surr0 = a.surr0[c.c];
    if (c.own) pos[c.t] = p1[c.t] = pos0[c.t];
    __syncthreads();
  }

  __device__ bool step(const ChainCtx& c, uint32_t i) {
    const uint32_t k1 = static_cast<uint32_t>(a.k_inner), k2 = static_cast<uint32_t>(a.k_mid);
    float mid = mid0, surr = surr0;  // at pos, which equals pos0 here
    for (uint32_t j2 = 0; j2 < k2; ++j2) {
      float s1 = surr;  // at p1, which equals pos here
      for (uint32_t j1 = 0; j1 < k1; ++j1) {
        const uint32_t tag = 4u * (j2 * k1 + j1);
        if (c.own) {
          const float xi = c.scale_t * c.normal(i, tag);
          prop[c.t] = c.mean_t + a.contraction * (p1[c.t] - c.mean_t) + a.beta * xi;
        }
        __syncthreads();
        const float sp = Pot::phi(a.coarse, prop, ws);
        if (logf(c.uniform(i, tag + 2u)) < s1 - sp) {  // the same in every thread
          s1 = sp;
          if (c.own) p1[c.t] = prop[c.t];
        }
      }
      __syncthreads();
      const float mid_end = Pot::phi(a.mid, p1, ws);
      float lr = (mid - mid_end) - (surr - s1);  // coarse -> middle correction
      if (isnan(lr)) lr = -INFINITY;
      if (logf(c.uniform(i, 4u * k1 * k2 + 4u * j2 + 2u)) < lr) {
        mid_acc += 1.0f;
        mid = mid_end;
        surr = s1;
        if (c.own) pos[c.t] = p1[c.t];
      } else if (c.own) {
        p1[c.t] = pos[c.t];
      }
    }
    __syncthreads();
    const float pe = Pot::phi(a.fine, pos, ws);
    float log_ratio = (phi0 - pe) - (mid0 - mid);  // middle -> fine correction
    if (isnan(log_ratio)) log_ratio = -INFINITY;
    const bool accept = logf(c.uniform(i, 4u * k1 * k2 + 4u * k2 + 2u)) < log_ratio;
    if (accept) {
      phi0 = pe;
      mid0 = mid;
      surr0 = surr;
      if (c.own) pos0[c.t] = pos[c.t];
    } else if (c.own) {
      pos[c.t] = p1[c.t] = pos0[c.t];
    }
    return accept;
  }
};

template <class Pot, bool RECORD>
__global__ void __launch_bounds__(Pot::kMaxThreads, Pot::kMinCtasPerSm)
    fused_da3_pcn_kernel(Da3Args<Pot> a) {
  extern __shared__ float smem[];
  const int d = a.chain.d;
  const typename Pot::Extent extent =
      Pot::join(Pot::extent(a.fine), Pot::join(Pot::extent(a.mid), Pot::extent(a.coarse)));
  float* pos0 = smem;
  float* pos = pos0 + d;
  float* p1 = pos + d;
  float* prop = p1 + d;
  // no level's constants are staged on chip: the only potential this
  // kernel is instantiated for keeps none there
  Da3Step<Pot> step{a,    pos0, pos,  p1,  prop, Pot::carve(prop + d, extent),
                    0.0f, 0.0f, 0.0f, 0.0f};
  run_chain<RECORD>(a.chain, step, pos0);
  if (threadIdx.x == 0)
    a.mid_rate[blockIdx.x] =
        step.mid_acc /
        fmaxf(static_cast<float>(a.chain.n_steps) * static_cast<float>(a.k_mid), 1.0f);
}

// Launches fused_da3_pcn_kernel<Pot, RECORD> (RECORD: chain.samples given).
template <class Pot>
int launch_da3_pcn(const typename Pot::Spec& fine, const typename Pot::Spec& mid,
                   const typename Pot::Spec& coarse, const IpxChainArgs& chain,
                   const float* phi0, const float* mid0, const float* surr0, float beta,
                   float contraction, int k_inner, int k_mid, float* mid_rate, void* stream) {
  const typename Pot::Extent extent =
      Pot::join(Pot::extent(fine), Pot::join(Pot::extent(mid), Pot::extent(coarse)));
  const int threads = chain_threads(chain, extent.cells, fine.K, Pot::kMaxThreads);
  const int d = chain.d, n = chain.n;
  if (threads == 0 || !Pot::valid(fine) || !Pot::valid(mid) || !Pot::valid(coarse) ||
      mid.K != d || coarse.K != d || k_inner < 0 || k_mid < 0)
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const Da3Args<Pot> a{fine, mid,  coarse,      chain,   phi0,  mid0,    surr0,
                       beta, contraction, k_inner, k_mid, mid_rate};
  // state (4d) + misfit workspace
  const size_t smem = sizeof(float) * (4 * d + Pot::workspace_floats(extent));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (chain.samples != nullptr) {
    cudaFuncSetAttribute(fused_da3_pcn_kernel<Pot, true>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    fused_da3_pcn_kernel<Pot, true><<<n, threads, smem, st>>>(a);
  } else {
    cudaFuncSetAttribute(fused_da3_pcn_kernel<Pot, false>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    fused_da3_pcn_kernel<Pot, false><<<n, threads, smem, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ipx

extern "C" {

int ipx_burgers_misfit(const IpxBurgersSpec* s, const float* U, int B, float* phi,
                       void* stream) {
  const int threads = ipx::round_up32(s->n_cells);
  if (!ipx::BurgersPotential::valid(*s) || threads > 1024 || B < 0) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  const size_t smem =
      sizeof(float) *
      (s->K + ipx::BurgersPotential::workspace_floats(ipx::BurgersPotential::extent(*s)));
  ipx::burgers_misfit_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(*s, U, B,
                                                                                      phi);
  return static_cast<int>(cudaGetLastError());
}

int ipx_fused_da3_pcn_burgers(const IpxBurgersSpec* fine, const IpxBurgersSpec* mid,
                              const IpxBurgersSpec* coarse, const IpxChainArgs* chain,
                              const float* phi0, const float* mid0, const float* surr0,
                              float beta, float contraction, int k_inner, int k_mid,
                              float* mid_rate, void* stream) {
  return ipx::launch_da3_pcn<ipx::BurgersPotential>(*fine, *mid, *coarse, *chain, phi0, mid0,
                                                    surr0, beta, contraction, k_inner, k_mid,
                                                    mid_rate, stream);
}

}  // extern "C"
