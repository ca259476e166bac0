// Hand-written Hopper kernels of the delayed-acceptance pCN paths.
//
// Replaces the Pallas TPU kernel of ip_mcmc_tpu/ops/fused_mcmc.py as
// instantiated by fused_da_pcn_chain (l.1535) and
// fused_da_pcn_chain_recorded (l.1653): the step builder
// _make_da_pcn_step_builder (K4, l.325) as a step on the scaffold of
// fused_scaffold.cuh (K2, K3), with the counter-hash RNG (K1,
// counter_rng.cuh) and the inlined misfits. The potential is a type (the
// Pallas kernel inlines any traced JAX function; a CUDA kernel is compiled
// per potential): DarcyPotential (K5, darcy_misfit.cuh) or
// BurgersPotential (K12, burgers_misfit.cuh); the surrogate's type may
// differ from the exact level's in its solve (K17) or in its layout (the
// 64 x 64 kernel below).
//
//   darcy_misfit_kernel               Phi for a (K, B) batch at one Darcy
//                                     misfit spec.
//   fused_da_pcn_kernel<Pot, RECORD>  the whole n_steps loop in one launch;
//                                     RECORD stores every thin-th state
//                                     into (n_rec, n, d) with a plain store.
//
// Layout: one CTA per chain, one thread per cell of the largest grid
// (Darcy: 256 threads at 16x16, the 8x8 surrogate stage uses 64 of them;
// Burgers: 128 threads, the 64-cell surrogate uses half). The 64x64 Darcy
// kernel of darcy64_da_fused takes the exact level's layout (DaLayout64:
// 4 cells a thread on 1024 threads) and solves its 32x32 surrogate on the
// same threads, one cell each (SurrogateLayout). Chain state and
// solver vectors stay on chip; global memory is touched for the positions
// in and out, the constant factors and the records. Phi and Phi* at the
// start positions come in from the standalone misfit kernels.
//
// What bounds the Darcy instantiation on the H100: per chain and outer
// step (k = 48) the misfits
// do ~2.9 M multiply-adds (4096 chains: ~24 GFLOP, ~20 of them the
// preconditioners' products of bf16 inputs: ~0.08 ms at the tensor cores'
// bf16 peak plus the f32 peak for the rest), but they run on the CUDA
// cores, and they also re-read their constant factors on every use: the
// surrogate's KL basis (16 KB) and modes (8 KB) 48 times and the exact
// misfit's modes (64 KB) twice per CG iteration, ~5.5 MB per chain-step
// from L2 before staging, and each CG iteration is a chain of dependent
// block reductions (about 30 barriers per surrogate solve). This first
// design stages the surrogate's factors in shared memory once per CTA
// (removing ~70% of the L2 traffic) and keeps the rest simple: no wgmma,
// no TMA, one chain per CTA. At 64x64 with the 32x32 surrogate (K = 144,
// k = 48) the factors do not fit on chip: per chain and outer step the
// surrogate re-reads its basis (0.59 MB) and modes (0.26 MB, twice per
// preconditioner apply) 48 times and the exact solve its basis (2.4 MB)
// and modes (2 MB) 34 times, ~200 MB from L2 (~200 GB an outer step at
// 1024 chains) for ~100 M multiply-adds, so L2 bandwidth bounds it; the
// design that reads them once for many chains is a later one. The Burgers
// instantiation (k = 16: 16
// surrogate solves of 26 Godunov steps and one exact solve of 154) is
// bound by the barrier per time step: see burgers_misfit.cuh.
//
// Numerics follow the JAX kernel: f32 everywhere except the
// preconditioner's bf16 inputs (f32 accumulation); no fast math (the
// transmissibility denominators add a subnormal 1e-38); every MH test is
// log u < delta, so NaN rejects; the outer log-ratio maps NaN to -inf.
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "burgers_misfit.cuh"
#include "darcy_misfit.cuh"
#include "fused_scaffold.cuh"

namespace ipx {

// Phi for a (K, B) batch at one spec, one CTA per draw.
template <class Pot>
__device__ __forceinline__ void misfit_batch(const IpxMisfitSpec& s, const float* __restrict__ U,
                                             int B, float* __restrict__ phi) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, cells = s.n * s.n;
  float* u = smem;
  const MisfitSmem ws = carve_misfit_smem(smem + s.K, cells, s.modes);
  for (int k = threadIdx.x; k < s.K; k += blockDim.x) u[k] = U[static_cast<size_t>(k) * B + b];
  __syncthreads();
  const float v = Pot::phi(s, u, ws);
  if (threadIdx.x == 0) phi[b] = v;
}

// Layouts of up to 256 threads need no launch bound (a thread may have all
// 255 registers) and get none, as the kernel always had: a bound changes
// ptxas' register allocation. The wider layouts carry the samplers' bound,
// which caps a thread's registers so that the CTA (or kMinCtas of them)
// fits on an SM.
template <class Pot>
__global__ void darcy_misfit_kernel(IpxMisfitSpec s, const float* __restrict__ U, int B,
                                    float* __restrict__ phi) {
  misfit_batch<Pot>(s, U, B, phi);
}

template <class Pot>
__global__ void __launch_bounds__(Pot::kMaxThreads, Pot::kMinCtasPerSm)
    darcy_misfit_wide_kernel(IpxMisfitSpec s, const float* __restrict__ U, int B,
                             float* __restrict__ phi) {
  misfit_batch<Pot>(s, U, B, phi);
}

template <class Pot>
struct DaArgs {
  typename Pot::Spec exact, surr;
  IpxChainArgs chain;
  const float* phi0;   // (n,) Phi at pos_in
  const float* surr0;  // (n,) Phi* at pos_in
  float beta, contraction;
  int k;
  float* inner;  // (n,) inner (surrogate) acceptance rate
};

// K4: k pCN steps against the surrogate (tags 4j, 4j+1, 4j+2), then one
// exact correction (Phi(u) - Phi(v)) - (Phi*(u) - Phi*(v)) with tag 4k+2.
// Surr: the surrogate's potential type (Pot's, or Pot's with another
// solve, or with a layout on Pot's threads).
template <class Pot, class Surr = Pot>
struct DaStep {
  static_assert(Surr::kMaxThreads == Pot::kMaxThreads,
                "both levels run on the threads of one CTA");
  const DaArgs<Pot>& a;
  const typename Pot::Spec& surr;  // a.surr, its factors staged on chip if Surr::kStaged
  float* pos0;                     // current state
  float* pos;                      // subchain state
  float* prop;                     // proposal
  typename Pot::Workspace ws;
  float phi0, surr0, in_acc;

  __device__ void init(const ChainCtx& c) {
    phi0 = a.phi0[c.c];
    surr0 = a.surr0[c.c];
    if (c.own) pos[c.t] = pos0[c.t];
    __syncthreads();
  }

  __device__ bool step(const ChainCtx& c, uint32_t i) {
    float surr_v = surr0;
    for (int j = 0; j < a.k; ++j) {
      if (c.own) {
        const float xi = c.scale_t * c.normal(i, 4u * j);
        prop[c.t] = c.mean_t + a.contraction * (pos[c.t] - c.mean_t) + a.beta * xi;
      }
      __syncthreads();
      const float sp = Surr::phi(surr, prop, ws);
      if (logf(c.uniform(i, 4u * j + 2u)) < surr_v - sp) {  // the same in every thread
        in_acc += 1.0f;
        surr_v = sp;
        if (c.own) pos[c.t] = prop[c.t];
      }
    }
    __syncthreads();
    const float pe = Pot::phi(a.exact, pos, ws);
    float log_ratio = (phi0 - pe) - (surr0 - surr_v);
    if (isnan(log_ratio)) log_ratio = -INFINITY;
    const bool accept = logf(c.uniform(i, 4u * a.k + 2u)) < log_ratio;
    if (accept) {
      phi0 = pe;
      surr0 = surr_v;
      if (c.own) pos0[c.t] = pos[c.t];
    } else if (c.own) {
      pos[c.t] = pos0[c.t];
    }
    return accept;
  }
};

// Darcy: 256 threads and at least 4 CTAs per SM cap registers at 64 a
// thread (96 without the bound; 2 CTAs per SM). Measured on the H100 at
// 4096 chains, k = 48: 11.07 ms per outer step against 16.25 ms without the
// bound (40-48 bytes of spills).
template <class Pot, bool RECORD, class Surr = Pot>
__global__ void __launch_bounds__(Pot::kMaxThreads, Pot::kMinCtasPerSm)
    fused_da_pcn_kernel(DaArgs<Pot> a) {
  extern __shared__ float smem[];
  const int t = threadIdx.x, d = a.chain.d;
  const typename Pot::Extent extent = Pot::join(Pot::extent(a.exact), Pot::extent(a.surr));
  float* pos0 = smem;
  float* pos = pos0 + d;
  float* prop = pos + d;
  // The surrogate's factors, read k times per outer step, staged on chip
  // where they fit (Surr::kStaged; else read through L2). The assumption
  // tells the compiler what it no longer infers once the copy sits in a
  // function of the potential: the staged factors lie in shared memory.
  // Without it the Darcy kernel addresses them generically and spills
  // (48-64 bytes of stores at 64 registers, 6 % slower per step). ptxas is
  // touchy here: naming the address in a variable first, or staging from
  // the local copy instead of the parameter, brings the spills back (nvcc
  // 12.8), so keep this form and read nvcc.log.
  typename Pot::Spec surr = a.surr;
  if constexpr (Surr::kStaged) {
    __builtin_assume(__isShared(prop + d + Pot::workspace_floats(extent)));
    Surr::stage(a.surr, surr, prop + d + Pot::workspace_floats(extent));
  }

  DaStep<Pot, Surr> step{a, surr, pos0, pos, prop, Pot::carve(prop + d, extent),
                         0.0f, 0.0f, 0.0f};
  run_chain<RECORD>(a.chain, step, pos0);
  if (t == 0)
    a.inner[blockIdx.x] = step.in_acc / fmaxf(static_cast<float>(a.chain.n_steps) *
                                                  static_cast<float>(a.k), 1.0f);
}

// Launches fused_da_pcn_kernel<Pot, RECORD, Surr> (RECORD: chain.samples
// given).
template <class Pot, class Surr = Pot>
int launch_da_pcn(const typename Pot::Spec& exact, const typename Pot::Spec& surr,
                  const IpxChainArgs& chain, const float* phi0, const float* surr0,
                  float beta, float contraction, int k, float* inner, void* stream) {
  const typename Pot::Extent extent = Pot::join(Pot::extent(exact), Pot::extent(surr));
  const int threads =
      chain_threads(chain, extent.cells, exact.K, Pot::kMaxThreads, Pot::kCellsPerThread);
  const int d = chain.d, n = chain.n;
  // the surrogate is solved on the exact level's threads, which must own
  // its every cell
  if (threads == 0 || !Pot::valid(exact) || !Surr::valid(surr) || surr.K != d || k < 0 ||
      threads * Surr::kCellsPerThread < Surr::extent(surr).cells)
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const DaArgs<Pot> a{exact, surr, chain, phi0, surr0, beta, contraction, k, inner};
  // state (3d) + misfit workspace (+ the staged factors of the surrogate)
  size_t smem = sizeof(float) * (3 * d + Pot::workspace_floats(extent));
  if constexpr (Surr::kStaged) smem += Surr::staged_bytes(surr);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (chain.samples != nullptr) {
    cudaFuncSetAttribute(fused_da_pcn_kernel<Pot, true, Surr>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    fused_da_pcn_kernel<Pot, true, Surr><<<n, threads, smem, st>>>(a);
  } else {
    cudaFuncSetAttribute(fused_da_pcn_kernel<Pot, false, Surr>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    fused_da_pcn_kernel<Pot, false, Surr><<<n, threads, smem, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launches darcy_misfit_kernel<Pot> (or its bounded form).
template <class Pot>
int launch_misfit(const IpxMisfitSpec& s, const float* U, int B, float* phi, void* stream) {
  const int cells = s.n * s.n;
  const int threads = round_up32((cells + Pot::kCellsPerThread - 1) / Pot::kCellsPerThread);
  if (threads > Pot::kMaxThreads || !Pot::valid(s) || B < 0) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  const size_t smem = sizeof(float) * (s.K + misfit_smem_floats(cells, s.modes));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if constexpr (Pot::kMaxThreads <= 256)
    darcy_misfit_kernel<Pot><<<B, threads, smem, st>>>(s, U, B, phi);
  else
    darcy_misfit_wide_kernel<Pot><<<B, threads, smem, st>>>(s, U, B, phi);
  return static_cast<int>(cudaGetLastError());
}

// The 64x64 DA kernel of darcy64_da_fused: the exact level on 4 cells a
// thread x 1024 threads, 1 CTA per SM, and the 32x32 surrogate, which
// carries most of the work, on the same threads at one cell each. On an
// H100 80GB HBM3 (700 W), 1024 chains, k = 48: 45.0 ms an outer step
// against 47.4 ms on the 64x64 warm pCN's CTA (8 x 512, 2 CTAs per SM;
// the surrogate then 2 cells a thread), which also spills 3.7 times the
// bytes (scripts/measure_darcy_layouts.py, PERF.md).
struct DaLayout64 { static constexpr int kCells = 4, kThreads = 1024, kMinCtas = 1; };
using DaExact64 = DarcyPot<DaLayout64>;
using DaSurrogate32 = DarcyPot<SurrogateLayout<DaLayout64, 32>>;

}  // namespace ipx

extern "C" {

const char* ipx_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// sizeof(IpxMisfitSpec), against which the ctypes mirror is checked.
int ipx_misfit_spec_size() { return static_cast<int>(sizeof(IpxMisfitSpec)); }

// The layout follows the spec's grid, the solve its solver.
int ipx_darcy_misfit(const IpxMisfitSpec* s, const float* U, int B, float* phi,
                     void* stream) {
  const auto launch = [&](auto pot) {
    return ipx::launch_misfit<decltype(pot)>(*s, U, B, phi, stream);
  };
  if (s->solver == kSolverRichardson)
    return ipx::with_darcy_layout<kSolverRichardson>(*s, launch);
  return ipx::with_darcy_layout<kSolverCg>(*s, launch);
}

// The instantiation follows the two grids: both up to 16x16 (the exact
// misfit solved by CG, the surrogate by CG or by Richardson), or an exact
// grid of the 64x64 class (above 32x32 cells) with a CG surrogate of the
// 32x32 class (above 16x16). Any other pair is refused with
// cudaErrorNotSupported, not run by another instantiation.
int ipx_fused_da_pcn(const IpxMisfitSpec* exact, const IpxMisfitSpec* surr,
                     const IpxChainArgs* chain, const float* phi0, const float* surr0,
                     float beta, float contraction, int k, float* inner, void* stream) {
  using ipx::DarcyPotential;
  const int exact_cells = exact->n * exact->n, surr_cells = surr->n * surr->n;
  if (exact_cells <= DarcyPotential::kMaxCells && surr_cells <= DarcyPotential::kMaxCells) {
    if (surr->solver == kSolverRichardson)
      return ipx::launch_da_pcn<DarcyPotential, ipx::DarcyPot<ipx::Layout16, kSolverRichardson>>(
          *exact, *surr, *chain, phi0, surr0, beta, contraction, k, inner, stream);
    return ipx::launch_da_pcn<DarcyPotential>(*exact, *surr, *chain, phi0, surr0, beta,
                                              contraction, k, inner, stream);
  }
  if (exact_cells > ipx::DarcyPot<ipx::Layout32>::kMaxCells &&
      exact_cells <= ipx::DaExact64::kMaxCells && surr_cells > DarcyPotential::kMaxCells &&
      surr_cells <= ipx::DaSurrogate32::kMaxCells && surr->solver == kSolverCg)
    return ipx::launch_da_pcn<ipx::DaExact64, ipx::DaSurrogate32>(
        *exact, *surr, *chain, phi0, surr0, beta, contraction, k, inner, stream);
  return cudaErrorNotSupported;
}

int ipx_fused_da_pcn_burgers(const IpxBurgersSpec* exact, const IpxBurgersSpec* surr,
                             const IpxChainArgs* chain, const float* phi0, const float* surr0,
                             float beta, float contraction, int k, float* inner,
                             void* stream) {
  return ipx::launch_da_pcn<ipx::BurgersPotential>(*exact, *surr, *chain, phi0, surr0, beta,
                                                   contraction, k, inner, stream);
}

}  // extern "C"
