// Hand-written Hopper kernels of the delayed-acceptance pCN paths.
//
// Replaces the Pallas TPU kernel of ip_mcmc_tpu/ops/fused_mcmc.py as
// instantiated by fused_da_pcn_chain (l.1535) and
// fused_da_pcn_chain_recorded (l.1653): the step builder
// _make_da_pcn_step_builder (K4, l.325) as a step on the scaffold of
// fused_scaffold.cuh (K2, K3), with the counter-hash RNG (K1,
// counter_rng.cuh) and the inlined misfits (K5, K17: darcy_misfit.cuh;
// K12: burgers_misfit.cuh). A CUDA kernel is compiled per potential (the
// Pallas kernel inlines any traced JAX function):
//
//   darcy_misfit_kernel                 Phi for a (K, B) batch at one
//                                       Darcy misfit spec, one draw a CTA
//                                       of the spec's layout.
//   darcy_misfit_cluster_kernel         the same on the specs of the 64x64
//                                       samplers' exact level, one draw a
//                                       CTA, G draws a thread-block
//                                       cluster (ClusterLevel).
//   darcy_misfit_cluster32_kernel       the same on the level of the 32x32
//                                       warm pCN (Cluster32Exact).
//   darcy_misfit_surr_cluster_kernel    the same on the 32x32 surrogate
//                                       level of the 64x64 DA kernel
//                                       (ClusterSurr).
//   darcy_misfit_warp_kernel<N, SOLVER> the same on a level of the 16x16 DA
//                                       kernel, one draw a warp (WarpLevel):
//                                       its exact level (N = 16, CG) and its
//                                       8x8 surrogate level (N = 8, CG or
//                                       K17's Richardson).
//   darcy_misfit_slice_kernel           the same on the 16x16 Jacobi spec of
//                                       the ESS, cold pCN and FES samplers'
//                                       solve, one draw a warp
//                                       (WarpSliceLevel).
//   fused_da_pcn_warp_kernel<SOLVER, RECORD>
//                                       the 16x16 Darcy DA loop (8x8
//                                       surrogate solved by CG or K17's
//                                       Richardson), one chain per warp.
//   fused_da_pcn_cluster_kernel<RECORD>
//                                       the 64x64 Darcy DA loop (32x32
//                                       surrogate), one chain per CTA, G
//                                       chains a thread-block cluster.
//   fused_da_pcn_burgers_warp_kernel<RECORD>
//                                       the Burgers DA loop on levels of 64
//                                       or 128 cells with d = K = 16 (the
//                                       shipped config's), one chain per
//                                       warp (burgers_misfit.cuh's warp
//                                       solve).
//   fused_da_pcn_kernel<Pot, RECORD, Surr>
//                                       one chain per CTA: the Burgers DA
//                                       loop on the other specs, and the
//                                       Darcy DA loop on the pairs that the
//                                       warp and cluster kernels leave
//                                       (da_route): both levels up to 16x16
//                                       (the surrogate no finer, solved by
//                                       CG or Richardson), or an exact grid
//                                       of 33x33 to 64x64 with a CG
//                                       surrogate of 17x17 to 32x32; and
//                                       the DA loop on two linear-Gaussian
//                                       levels (LinearGaussianPotential,
//                                       ipx_fused_da_pcn_linear: every pair
//                                       that linear_cta_takes).
//
// Each runs the whole n_steps loop in one launch; RECORD stores every
// thin-th state into (n_rec, n, d) with a plain store. Chain state and
// solver vectors stay on chip; global memory is touched for the positions
// in and out, the constant factors and the records. Phi and Phi* at the
// start positions come in from the standalone misfit kernels.
//
// The 16x16 kernel (main path, darcy_da_fused). Per chain and outer step
// (k = 48) the misfits do ~2.9 M multiply-adds, ~20 of 24 GFLOP at 4096
// chains being the dst_trunc preconditioner's products of bf16 inputs
// (0.077 ms at the card's peaks), but the work is a chain of small
// dependent steps: 48 surrogate solves of 3 CG iterations, each with two
// dot products and a preconditioner apply. So the kernel runs one chain
// per warp (lane l owns cells l, l + 32, ...: 2 of the 8x8 surrogate, 8 of
// the 16x16 exact level; coordinates l and l + 32 of d = 64): the dot
// products are warp sums and the stencil reads the warp's own shared
// memory, with no block barrier. DaWarpDesign::kWarps chains share a CTA,
// and their preconditioner products run together on the tensor cores: M =
// modes or cells, N = the CTA's chains, K = cells or modes, bf16
// mma.sync.m16n8k16 with f32 accumulation, three CTA barriers an apply.
// All chains of a CTA make the same solves at fixed iteration counts, so
// every warp reaches each barrier. The 8x8 surrogate's factors (25 KB) are
// staged once per CTA; the exact level's (130 KB) are read through L2 by
// fragments, once per apply for the CTA's 8 chains. Measured on an H100
// 80GB HBM3 (700 W), 4096 chains, k = 48 (scripts/measure_da_warp_design.py,
// PERF.md): 1.03-1.06 ms an outer step at 128 registers (80: 1.09, 268
// bytes spilled), against 10.2 ms for one chain per CTA; W = 4 1.77, W =
// 16 1.18; the exact factors staged 1.47; the products as CUDA-core loops
// 6.5-11.4. The exact correction takes 0.32 ms of it (k = 0).
//
// The 64x64 kernel of darcy64_da_fused (K = 144, k = 48). Its factors fit
// in no CTA (the 64x64 basis 2.4 MB and modes 2.1 MB, the 32x32 surrogate's
// 0.59 and 0.26 MB): per chain and outer step the exact solve reads the
// basis once and the modes 34 times, the 48 surrogate solves theirs 48 and
// 8 x 48 times, ~200 MB from L2, and ~90 % of its ~96 M multiply-adds are
// the preconditioner's products. So each CTA keeps one chain (8 cells a
// thread on 512 threads, two CTAs an SM), and the G CTAs of a thread-block
// cluster share each read of the factors: the KL reconstruction and both
// dst_trunc products run over the cluster's chains, the products as bf16
// mma.sync with the chains as N, each CTA on its slice of the outputs
// (ClusterLevel in darcy_misfit.cuh). That divides the L2 bytes by G; what
// is left is the latency chain of 48 surrogate solves, each with 4
// preconditioner applies of 3 cluster barriers. The design is the line
// ClusterDesign, shared with the 64x64 warm pCN kernel
// (scripts/measure_da64_cluster_design.py times the alternatives, PERF.md
// the numbers). The Burgers kernels: see the section of the warp kernel
// below (one chain a CTA is bound by the barrier per time step, see
// burgers_misfit.cuh).
//
// Numerics follow the JAX kernel: f32 everywhere except the
// preconditioner's bf16 inputs (f32 accumulation); no fast math (the
// transmissibility denominators add a subnormal 1e-38); every MH test is
// log u < delta, so NaN rejects; the outer log-ratio maps NaN to -inf.
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

#include "burgers_misfit.cuh"
#include "darcy_misfit.cuh"
#include "fused_scaffold.cuh"
#include "gaussian_potential.cuh"

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
  const typename Pot::Spec& surr;  // a.surr
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

// One chain per CTA, launch-bounded by the exact level's layout (Burgers:
// 128 threads, on the specs that the warp kernel below leaves).
template <class Pot, bool RECORD, class Surr = Pot>
__global__ void __launch_bounds__(Pot::kMaxThreads, Pot::kMinCtasPerSm)
    fused_da_pcn_kernel(DaArgs<Pot> a) {
  extern __shared__ float smem[];
  const int t = threadIdx.x, d = a.chain.d;
  const typename Pot::Extent extent = Pot::join(Pot::extent(a.exact), Pot::extent(a.surr));
  float* pos0 = smem;
  float* pos = pos0 + d;
  float* prop = pos + d;
  // the surrogate's factors are read through L2 (32 x 32: 0.85 MB fit no
  // CTA); the 16 x 16 kernel below stages its 8 x 8 surrogate's
  typename Pot::Spec surr = a.surr;

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
  // enough threads for the cells of both levels, each at its cells a thread
  const int t_exact =
      chain_threads(chain, extent.cells, exact.K, Pot::kMaxThreads, Pot::kCellsPerThread);
  const int t_surr = chain_threads(chain, Surr::extent(surr).cells, exact.K, Pot::kMaxThreads,
                                   Surr::kCellsPerThread);
  const int threads = t_exact == 0 || t_surr == 0 ? 0 : (t_exact > t_surr ? t_exact : t_surr);
  const int d = chain.d, n = chain.n;
  // the surrogate is solved on the exact level's threads, which must own
  // its every cell
  if (threads == 0 || !Pot::valid(exact) || !Surr::valid(surr) || surr.K != d || k < 0 ||
      threads * Surr::kCellsPerThread < Surr::extent(surr).cells)
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const DaArgs<Pot> a{exact, surr, chain, phi0, surr0, beta, contraction, k, inner};
  // state (3d) + misfit workspace
  const size_t smem = sizeof(float) * (3 * d + Pot::workspace_floats(extent));
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

// The one-chain-a-CTA Darcy DA kernel of the 64x64 class: the exact level
// on 4 cells a thread x 1024 threads, 1 CTA per SM, and the 32x32-class
// surrogate on the same threads at one cell each (the layout measured
// fastest for this kernel when it was the path of darcy64_da_fused: 45.0
// ms an outer step at 1024 chains against 47.4 on Layout64's CTA, which
// spilled 3.7 times the bytes; PERF.md).
struct DaLayout64 { static constexpr int kCells = 4, kThreads = 1024, kMinCtas = 1; };
using DaExact64 = DarcyPot<DaLayout64>;
using DaSurrogate32 = DarcyPot<SurrogateLayout<DaLayout64, 32>>;

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

// Phi for a (K, B) batch on the exact level of the 64 x 64 samplers, one
// draw a CTA, G draws a thread-block cluster (misfit_cluster_draw in
// darcy_misfit.cuh): darcy64_da_fused's exact misfit, 1024 draws of
// dst_trunc-256 / 16 CG. The design is the samplers' (ClusterDesign).
__global__ void __launch_bounds__(ClusterDesign::kThreads, ClusterDesign::kMinCtas)
    darcy_misfit_cluster_kernel(const __grid_constant__ MisfitBatch a) {
  misfit_cluster_draw<false, ClusterExact>(a);
}

// The same on the level of the 32 x 32 warm pCN (Cluster32Exact): a cold
// 32 x 32 dst_trunc CG misfit, the twin of darcy_misfit_warm_cluster32_kernel
// (fused_pcn.cu). No shipped path launches it (darcy32_pcn_warm's cold
// misfit is Jacobi). The design is Cluster32Design.
__global__ void __launch_bounds__(Cluster32Design::kThreads, Cluster32Design::kMinCtas)
    darcy_misfit_cluster32_kernel(const __grid_constant__ MisfitBatch a) {
  misfit_cluster_draw<false, Cluster32Exact>(a);
}

// Phi* for a (K, B) batch on the 32 x 32 surrogate level of the 64 x 64 DA
// kernel (ClusterSurr), one draw a CTA, G draws a thread-block cluster:
// darcy64_da_fused's surrogate at its start positions, 1024 draws of
// dst_trunc-128 / 3 CG with K = 144, so that Phi*0 and every proposal's
// Phi* come from one solve (the DA acceptance takes their difference). The
// design is the DA kernel's (ClusterDesign): 512 threads, 2 CTAs an SM, the
// ClusterSmem layout, whose free floats past the 32 x 32 cells hold this
// CTA's columns of V for the CUDA-core V^T coef (a layout sized for 32 x 32
// would not hold them). One draw a CTA of Layout32 read the f32 basis (590
// KB) once a draw and V (256 KB) twice an apply from L2.
__global__ void __launch_bounds__(ClusterDesign::kThreads, ClusterDesign::kMinCtas)
    darcy_misfit_surr_cluster_kernel(const __grid_constant__ MisfitBatch a) {
  misfit_cluster_draw<false, ClusterSurr>(a);
}

// --- the 64 x 64 kernel: one chain a CTA, G chains a thread-block cluster ------
//
// darcy64_da_fused: the exact level on 64 x 64 cells and its 32 x 32
// surrogate on the threads of one CTA (ClusterDesign in darcy_misfit.cuh),
// the cluster's chains sharing each read of the factors in the KL
// reconstruction and the preconditioner's products (ClusterLevel).

// K4 on a CTA of a cluster: k pCN steps against the surrogate (tags 4j,
// 4j+1, 4j+2), then one exact correction with tag 4k+2, as DaStep. Every
// CTA makes the same solves whatever it accepts, so the cluster's barriers
// inside them line up; a spare CTA (not live) runs on zeros.
struct DaClusterStep {
  const DaArgs<DarcyPotential>& a;
  ClusterSurr surr;
  ClusterExact exact;
  float* pos0;  // current state
  float* pos;   // subchain state
  float* prop;  // proposal
  bool live;
  float phi0, surr0, in_acc;

  __device__ void init(const ChainCtx& c) {
    phi0 = live ? a.phi0[c.c] : 0.0f;
    surr0 = live ? a.surr0[c.c] : 0.0f;
    if (c.own) pos[c.t] = pos0[c.t];
    __syncthreads();
  }

  __device__ bool step(const ChainCtx& c, uint32_t i) {
    float surr_v = surr0;
    surr.stage_columns();  // the exact solve of the last step covered them
    for (int j = 0; j < a.k; ++j) {
      if (c.own) {
        const float xi = c.scale_t * c.normal(i, 4u * j);
        prop[c.t] = c.mean_t + a.contraction * (pos[c.t] - c.mean_t) + a.beta * xi;
      }
      __syncthreads();
      float xs[ClusterSurr::kC];
      const float sp = darcy_solve_cluster<false>(surr, prop, xs);
      if (logf(c.uniform(i, 4u * j + 2u)) < surr_v - sp) {  // the same in every thread
        in_acc += 1.0f;
        surr_v = sp;
        if (c.own) pos[c.t] = prop[c.t];
      }
    }
    __syncthreads();
    float xe[ClusterExact::kC];
    const float pe = darcy_solve_cluster<false>(exact, pos, xe);
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

template <bool RECORD>
__global__ void __launch_bounds__(ClusterDesign::kThreads, ClusterDesign::kMinCtas)
    fused_da_pcn_cluster_kernel(const __grid_constant__ DaArgs<DarcyPotential> a) {
  const int d = a.chain.d;
  float* state = cluster_f32(ClusterSmem::kState);
  const bool live = static_cast<int>(blockIdx.x) < a.chain.n;
  DaClusterStep step{a,    {&a.surr}, {&a.exact}, state, state + d, state + 2 * d,
                     live, 0.0f,      0.0f,       0.0f};
  run_cluster_chain<RECORD>(a.chain, step, state, live);
  if (threadIdx.x == 0 && live)
    a.inner[blockIdx.x] = step.in_acc / fmaxf(static_cast<float>(a.chain.n_steps) *
                                                  static_cast<float>(a.k),
                                              1.0f);
  cg::this_cluster().sync();  // no peer reads this CTA's shared memory after it exits
}

// Launches fused_da_pcn_cluster_kernel<RECORD> (RECORD: chain.samples given).
inline int launch_da_pcn_cluster(const IpxMisfitSpec& exact, const IpxMisfitSpec& surr,
                                 const IpxChainArgs& chain, const float* phi0,
                                 const float* surr0, float beta, float contraction, int k,
                                 float* inner, void* stream) {
  ClusterGeometry geo;
  const int status = cluster_geometry(exact, &surr, chain, &geo);
  if (status != cudaSuccess) return status;
  if (k < 0) return cudaErrorInvalidValue;
  if (chain.n == 0) return cudaSuccess;
  const DaArgs<DarcyPotential> a{exact, surr, chain, phi0, surr0, beta, contraction, k, inner};
  if (chain.samples != nullptr) return launch_cluster(fused_da_pcn_cluster_kernel<true>, geo, stream, a);
  return launch_cluster(fused_da_pcn_cluster_kernel<false>, geo, stream, a);
}

// --- the 16 x 16 kernel: one warp per chain, W chains a CTA -------------------
//
// The design (scripts/measure_da_warp_design.py times the alternatives):
// kWarps chains a CTA, one a warp; the launch bound's warps an SM
// (kSmWarps: 16 caps a thread at 65536 / 512 = 128 registers, 24 at 80);
// the exact level's factors staged in shared memory or read through L2
// (kExactStaged); the preconditioner's products on the tensor cores or as
// loops on the CUDA cores (kMma).
struct DaWarpDesign { static constexpr int kWarps = 8, kSmWarps = 16; static constexpr bool kExactStaged = false, kMma = true; };
constexpr int kDaWarpTiles = (DaWarpDesign::kWarps + 7) / 8;  // mma tiles of 8 chains
constexpr int kDaWarpMinCtas =
    DaWarpDesign::kSmWarps >= 2 * DaWarpDesign::kWarps ? DaWarpDesign::kSmWarps / DaWarpDesign::kWarps : 1;
constexpr int kDaWarpExactN = 16, kDaWarpSurrN = 8, kDaWarpD = 64;
// a warp's slice: pos0, pos, prop (64 each), then p, th, tv of 256 cells
constexpr int kDaWarpFloats = 3 * kDaWarpD + 3 * kDaWarpExactN * kDaWarpExactN;

using DaWarpSurr = WarpLevel<kDaWarpSurrN, kDaWarpTiles, true, DaWarpDesign::kMma>;
using DaWarpExact =
    WarpLevel<kDaWarpExactN, kDaWarpTiles, DaWarpDesign::kExactStaged, DaWarpDesign::kMma>;

// K4 on a warp: k pCN steps against the surrogate (tags 4j, 4j+1, 4j+2),
// then one exact correction with tag 4k+2, as DaStep. Every warp makes the
// same solves whatever it accepts, so the CTA's barriers inside them line
// up.
template <int SURR_SOLVER>
struct DaWarpStep {
  const DaArgs<DarcyPotential>& a;
  DaWarpSurr surr;
  DaWarpExact exact;
  float* pos0;  // current state
  float* pos;   // subchain state
  float* prop;  // proposal
  float phi0, surr0, in_acc;

  __device__ void init(const WarpChainCtx& x) {
    const int l = threadIdx.x & 31;
    phi0 = x.live ? a.phi0[x.c] : 0.0f;
    surr0 = x.live ? a.surr0[x.c] : 0.0f;
    pos[l] = pos0[l];
    pos[l + 32] = pos0[l + 32];
    __syncwarp();
  }

  __device__ bool step(const WarpChainCtx& x, uint32_t i) {
    const int l = threadIdx.x & 31;
    float surr_v = surr0;
    for (int j = 0; j < a.k; ++j) {
      float z[2];
      x.normal2(i, 4u * j, z);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float xi = x.scale[h] * z[h];
        prop[l + 32 * h] = x.mean[h] + a.contraction * (pos[l + 32 * h] - x.mean[h]) + a.beta * xi;
      }
      __syncwarp();
      const float sp = darcy_phi_warp<SURR_SOLVER>(surr, prop);
      if (logf(x.uniform(i, 4u * j + 2u)) < surr_v - sp) {  // the same in every lane
        in_acc += 1.0f;
        surr_v = sp;
        pos[l] = prop[l];
        pos[l + 32] = prop[l + 32];
      }
    }
    __syncwarp();
    const float pe = darcy_phi_warp<kSolverCg>(exact, pos);
    float log_ratio = (phi0 - pe) - (surr0 - surr_v);
    if (isnan(log_ratio)) log_ratio = -INFINITY;
    const bool accept = logf(x.uniform(i, 4u * a.k + 2u)) < log_ratio;
    if (accept) {
      phi0 = pe;
      surr0 = surr_v;
      pos0[l] = pos[l];
      pos0[l + 32] = pos[l + 32];
    } else {
      pos[l] = pos0[l];
      pos[l + 32] = pos0[l + 32];
    }
    __syncwarp();
    return accept;
  }
};

// What a launch of the 16 x 16 kernel takes: warps (chains) a CTA, CTAs,
// dynamic shared memory.
struct DaWarpGeometry {
  int warps, ctas;
  size_t smem;
};

// A grid side, d = K = 64 and a preconditioner this kernel takes: dst_trunc
// with a multiple of 16 modes up to the cells, or Jacobi (no modes).
inline bool da_warp_level_ok(const IpxMisfitSpec& s, int n, int solver) {
  const bool precond = (s.precond == kPrecondDstTrunc && s.modes > 0 && s.modes % 16 == 0 &&
                        s.modes <= n * n) ||
                       (s.precond == kPrecondJacobi && s.modes == 0);
  return s.n == n && s.K == kDaWarpD && precond && s.solver == solver && s.m >= 0;
}

// Whether the 16 x 16 warp kernel takes the pair for chains of d
// coordinates, its surrogate solved by surr_solver: a 16 x 16 exact level by
// CG and an 8 x 8 surrogate, d = K = 64 (da_warp_level_ok). Mirrored by
// ip_mcmc_tpu_torch/ops/fused_da_pcn.py warp_takes.
inline bool da_warp_takes(const IpxMisfitSpec& exact, const IpxMisfitSpec& surr, int d,
                          int surr_solver) {
  return da_warp_level_ok(exact, kDaWarpExactN, kSolverCg) &&
         da_warp_level_ok(surr, kDaWarpSurrN, surr_solver) && d == kDaWarpD;
}

// The kernel a Darcy pair goes to: the 16 x 16 warp kernel or the 64 x 64
// cluster kernel (cluster_geometry: dst_trunc CG at both levels) for what
// they take; one chain a CTA for the rest of two domains: both levels up
// to 16 x 16 with the surrogate no finer than the exact grid, solved by CG
// or Richardson (Layout16), and an exact grid of 33 x 33 to 64 x 64 with a
// CG surrogate of 17 x 17 to 32 x 32 (DaLayout64); K = d at both levels.
// Every other pair: none. Mirrored by ip_mcmc_tpu_torch/ops/fused_da_pcn.py
// route.
inline int da_route(const IpxMisfitSpec& exact, const IpxMisfitSpec& surr, int d) {
  const int surr_solver = surr.solver == kSolverRichardson ? kSolverRichardson : kSolverCg;
  if (da_warp_takes(exact, surr, d, surr_solver)) return kRouteWarp;
  if (cluster_level_ok(exact, kClusterExactN, d, kClusterMaxModes) &&
      cluster_level_ok(surr, kClusterSurrN, d, kClusterSurrMaxModes))
    return kRouteCluster;
  constexpr int k16 = DarcyPotential::kMaxCells, k32 = DarcyPot<Layout32>::kMaxCells;
  const int exact_cells = exact.n * exact.n, surr_cells = surr.n * surr.n;
  if (surr.n <= exact.n && exact_cells <= k16 &&
      darcy_cta_spec(exact, d, k16, DarcyPotential::kMaxThreads) &&
      darcy_cta_spec(surr, d, k16, DarcyPotential::kMaxThreads, surr.solver))
    return kRouteCta;
  if (exact_cells > k32 && surr_cells > k16 &&
      darcy_cta_spec(exact, d, DaExact64::kMaxCells, DaExact64::kMaxThreads) &&
      darcy_cta_spec(surr, d, k32, DaExact64::kMaxThreads))
    return kRouteCta;
  return kRouteRefused;
}

// The kernel a linear-Gaussian pair goes to: one chain a CTA when
// linear_cta_takes both levels, else none. Mirrored by
// ip_mcmc_tpu_torch/ops/_scaffold.py linear_route.
inline int da_linear_route(const IpxGaussianSpec& exact, const IpxGaussianSpec& surr, int d) {
  return linear_cta_takes(exact, d) && linear_cta_takes(surr, d) ? kRouteCta : kRouteRefused;
}

// Mirrored by ip_mcmc_tpu_torch/ops/fused_da_pcn.py warp_geometry: what
// da_warp_takes (else cudaErrorNotSupported). W: the largest power of two up
// to kWarps that divides block_chains (so that a CTA's chains share their
// RNG block); a ragged last CTA runs spare warps.
inline int da_warp_geometry(const IpxMisfitSpec& exact, const IpxMisfitSpec& surr,
                            const IpxChainArgs& chain, int surr_solver, DaWarpGeometry* geo) {
  if (!da_warp_takes(exact, surr, chain.d, surr_solver)) return cudaErrorNotSupported;
  if (chain.block_chains <= 0 || chain.n < 0 || chain.n_steps < 0 ||
      (chain.samples != nullptr && chain.thin <= 0))
    return cudaErrorInvalidValue;
  int w = DaWarpDesign::kWarps;
  while (chain.block_chains % w) w /= 2;
  geo->warps = w;
  geo->ctas = (chain.n + w - 1) / w;
  geo->smem = xchg_bytes(8 * kDaWarpTiles) + warp_staged_bytes(surr) +
              (DaWarpDesign::kExactStaged ? warp_staged_bytes(exact) : 0) +
              sizeof(float) * kDaWarpFloats * w;
  return geo->smem <= 232448 ? cudaSuccess : cudaErrorInvalidValue;
}

template <int SURR_SOLVER, bool RECORD>
__global__ void __launch_bounds__(32 * DaWarpDesign::kWarps, kDaWarpMinCtas)
    fused_da_pcn_warp_kernel(const __grid_constant__ DaArgs<DarcyPotential> a) {
  extern __shared__ float4 da_warp_smem[];
  unsigned char* base = reinterpret_cast<unsigned char*>(da_warp_smem);
  const PrecondXchg xg = carve_xchg(base, 8 * kDaWarpTiles);
  base += xchg_bytes(8 * kDaWarpTiles);
  const WarpFactors<true> sf = stage_factors(a.surr, base);
  base += warp_staged_bytes(a.surr);
  const auto ef = level_factors<DaWarpDesign::kExactStaged>(a.exact, base);
  if (DaWarpDesign::kExactStaged) base += warp_staged_bytes(a.exact);
  float* w = reinterpret_cast<float*>(base) + (threadIdx.x >> 5) * kDaWarpFloats;
  const WarpSmem ws{w + 3 * kDaWarpD, w + 3 * kDaWarpD + 256, w + 3 * kDaWarpD + 512};
  __syncthreads();  // the staged factors

  const DaWarpSurr surr{&a.surr, sf, xg, ws};
  const DaWarpExact exact{&a.exact, ef, xg, ws};
  DaWarpStep<SURR_SOLVER> step{a,    surr, exact, w, w + kDaWarpD, w + 2 * kDaWarpD,
                               0.0f, 0.0f, 0.0f};
  run_warp_chain<RECORD>(a.chain, step, w);
  const int c = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if ((threadIdx.x & 31) == 0 && c < a.chain.n)
    a.inner[c] = step.in_acc / fmaxf(static_cast<float>(a.chain.n_steps) *
                                         static_cast<float>(a.k),
                                     1.0f);
}

// Launches fused_da_pcn_warp_kernel<SURR_SOLVER, RECORD> (RECORD:
// chain.samples given).
template <int SURR_SOLVER>
int launch_da_pcn_warp(const IpxMisfitSpec& exact, const IpxMisfitSpec& surr,
                       const IpxChainArgs& chain, const float* phi0, const float* surr0,
                       float beta, float contraction, int k, float* inner, void* stream) {
  DaWarpGeometry geo;
  const int status = da_warp_geometry(exact, surr, chain, SURR_SOLVER, &geo);
  if (status != cudaSuccess) return status;
  if (k < 0) return cudaErrorInvalidValue;
  if (chain.n == 0) return cudaSuccess;
  const DaArgs<DarcyPotential> a{exact, surr, chain, phi0, surr0, beta, contraction, k, inner};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = 32 * geo.warps, smem = static_cast<int>(geo.smem);
  if (chain.samples != nullptr) {
    cudaFuncSetAttribute(fused_da_pcn_warp_kernel<SURR_SOLVER, true>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    fused_da_pcn_warp_kernel<SURR_SOLVER, true><<<geo.ctas, threads, smem, st>>>(a);
  } else {
    cudaFuncSetAttribute(fused_da_pcn_warp_kernel<SURR_SOLVER, false>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    fused_da_pcn_warp_kernel<SURR_SOLVER, false><<<geo.ctas, threads, smem, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// --- the standalone misfits on the 16 x 16 DA kernel's levels: one draw a warp --
//
// Phi for a (K, B) batch on a level of the 16 x 16 DA kernel, one draw a
// warp, darcy_phi_warp<SOLVER> on the level's WarpLevel arithmetic (lane l
// owns cells l, l + 32, ...; the dst_trunc products over the CTA's draws by
// mma.sync), so that Phi0 (Phi*0) and every correction's Phi (proposal's
// Phi*) come from one solve:
//
//   darcy_misfit_warp_kernel<16, kSolverCg>  the exact level: darcy_da_fused's
//       exact misfit, 4096 draws of dst_trunc-128 / 12 CG, and the exact
//       misfit of the four darcy_da_richardson runs. One draw a CTA of
//       Layout16 read V (bf16 128 x 256, 64 KB) twice in each of 13 applies
//       and the f32 basis (64 KB) once a draw, ~1.7 MB from L2 a draw, and
//       summed each dot product over the CTA's 256 threads.
//   darcy_misfit_warp_kernel<8, SOLVER>  the 8 x 8 surrogate level
//       (DaWarpSurr, solved by CG or by K17's Richardson): the surrogate of
//       darcy_da_fused and of darcy_da_richardson[cg3], 4096 draws of
//       dst_trunc-64 / 3 CG, and those of the three Richardson runs. One draw
//       a CTA of Layout16 ran 64 of its 256 threads on the 64 cells and paid a
//       CTA barrier for every stencil, dot product and preconditioner apply.
//
// Here the CTA's draws share each read of the factors, and the dot
// products are warp sums. The preconditioner has CTA barriers, so the spare
// warps of a ragged last CTA run the solve on zeros and write nothing.

// The designs (scripts/measure_misfit_warp_design.py and, at 8 x 8,
// scripts/measure_misfit_warm16_surr8_design.py time the alternatives):
// kWarps draws a CTA, one a warp; the launch bound's warps an SM
// (kSmWarps); the level's factors staged in shared memory once a CTA or read
// through L2 (kStaged). The DA kernel keeps the exact level's in L2 only
// because its surrogate takes the shared memory; this kernel has it free.
// Measured on the H100 at 4096 draws (PERF.md): 16 draws a CTA with the
// factors staged (~215 KB, one CTA an SM) 0.143 ms a call, against 0.231
// through L2 at W = 16 and 0.27 / 0.32 at the DA kernel's W = 8 staged /
// through L2; every design gives the same bits (a draw's column of the
// products depends on it alone). The products run as the DA kernel's
// (DaWarpDesign::kMma). Staged, a spec whose factors leave no room (above
// 144 modes) goes to the one-draw-a-CTA kernel (misfit_warp_takes). The 8 x 8
// level stages its factors (25 KB), as the DA kernel does.
struct MisfitWarpDesign { static constexpr int kWarps = 16, kSmWarps = 16; static constexpr bool kStaged = true; };
struct MisfitSurrWarpDesign { static constexpr int kWarps = 16, kSmWarps = 32; };

// A level of the kernel: the grid side N (kDaWarpExactN or kDaWarpSurrN),
// its design, mma tiles of 8 draws, the launch bound's CTAs an SM, a warp's
// slice (the draw's u, then p, th, tv of N^2 cells) and the level's
// arithmetic.
template <int N>
struct MisfitWarp {
  static_assert(N == kDaWarpExactN || N == kDaWarpSurrN, "a level of the 16 x 16 DA kernel");
  using Design = std::conditional_t<N == kDaWarpExactN, MisfitWarpDesign, MisfitSurrWarpDesign>;
  static constexpr bool kStaged = N == kDaWarpExactN ? MisfitWarpDesign::kStaged : true;
  static constexpr int kTiles = (Design::kWarps + 7) / 8;
  static constexpr int kMinCtas =
      Design::kSmWarps >= 2 * Design::kWarps ? Design::kSmWarps / Design::kWarps : 1;
  static constexpr int kFloats = kDaWarpD + 3 * N * N;
  using Level = WarpLevel<N, kTiles, kStaged, DaWarpDesign::kMma>;

  // Dynamic shared memory of a launch on this spec: the exchange, the
  // staged factors (if the design stages them), a slice a warp.
  static size_t smem(const IpxMisfitSpec& s) {
    return xchg_bytes(8 * kTiles) + (kStaged ? warp_staged_bytes(s) : 0) +
           sizeof(float) * kFloats * Design::kWarps;
  }
};

// Whether darcy_misfit_warp_kernel takes this spec (ipx_darcy_misfit sends
// it there, every other spec to the kernels of its layout or to the
// cluster level): a level of the 16 x 16 DA kernel in the shared memory of
// a CTA, i.e. K = 64 and either its exact level with dst_trunc (16 x 16, a
// positive multiple of 16 modes up to 256, CG; staged: up to 144 modes) or
// its surrogate level as da_warp_geometry takes it (8 x 8, dst_trunc with a
// multiple of 16 modes up to 64 or Jacobi, CG or Richardson). Mirrored by
// ip_mcmc_tpu_torch/ops/fused_da_pcn.py misfit_warp_takes.
inline bool misfit_warp_takes(const IpxMisfitSpec& s) {
  if (s.n == kDaWarpExactN)
    return da_warp_level_ok(s, kDaWarpExactN, kSolverCg) && s.precond == kPrecondDstTrunc &&
           MisfitWarp<kDaWarpExactN>::smem(s) <= 232448;
  if (s.n == kDaWarpSurrN)
    return (s.solver == kSolverCg || s.solver == kSolverRichardson) &&
           da_warp_level_ok(s, kDaWarpSurrN, s.solver) &&
           MisfitWarp<kDaWarpSurrN>::smem(s) <= 232448;
  return false;
}

// Mirrored by ip_mcmc_tpu_torch/ops/fused_da_pcn.py misfit_warp_geometry:
// the level's kWarps draws a CTA, a ragged last CTA runs spare warps; what
// misfit_warp_takes refuses, cudaErrorNotSupported.
inline int misfit_warp_geometry(const IpxMisfitSpec& s, int B, DaWarpGeometry* geo) {
  if (!misfit_warp_takes(s)) return cudaErrorNotSupported;
  if (B < 0) return cudaErrorInvalidValue;
  const bool exact = s.n == kDaWarpExactN;
  geo->warps = exact ? MisfitWarp<kDaWarpExactN>::Design::kWarps
                     : MisfitWarp<kDaWarpSurrN>::Design::kWarps;
  geo->ctas = (B + geo->warps - 1) / geo->warps;
  geo->smem = exact ? MisfitWarp<kDaWarpExactN>::smem(s) : MisfitWarp<kDaWarpSurrN>::smem(s);
  return cudaSuccess;
}

template <int N, int SOLVER>
__global__ void __launch_bounds__(32 * MisfitWarp<N>::Design::kWarps, MisfitWarp<N>::kMinCtas)
    darcy_misfit_warp_kernel(const __grid_constant__ MisfitBatch a) {
  using M = MisfitWarp<N>;
  extern __shared__ float4 misfit_warp_smem_buf[];
  unsigned char* base = reinterpret_cast<unsigned char*>(misfit_warp_smem_buf);
  const PrecondXchg xg = carve_xchg(base, 8 * M::kTiles);
  base += xchg_bytes(8 * M::kTiles);
  const auto f = level_factors<M::kStaged>(a.s, base);
  if (M::kStaged) base += warp_staged_bytes(a.s);
  float* slices = reinterpret_cast<float*>(base);
  // the CTA's draws' coefficients, W consecutive columns of U a row
  const int W = blockDim.x >> 5, b0 = blockIdx.x * W, B = a.B;
  for (int e = threadIdx.x; e < kDaWarpD * W; e += blockDim.x) {
    const int k = e / W, j = e % W;
    slices[j * M::kFloats + k] = b0 + j < B ? a.U[static_cast<size_t>(k) * B + b0 + j] : 0.0f;
  }
  float* u = slices + (threadIdx.x >> 5) * M::kFloats;
  const WarpSmem ws{u + kDaWarpD, u + kDaWarpD + N * N, u + kDaWarpD + 2 * N * N};
  __syncthreads();  // the staged factors and every warp's u
  const float v = darcy_phi_warp<SOLVER>(typename M::Level{&a.s, f, xg, ws}, u);
  const int b = b0 + (threadIdx.x >> 5);
  if ((threadIdx.x & 31) == 0 && b < B) a.phi[b] = v;
}

template <int N, int SOLVER>
inline int launch_misfit_warp_level(const MisfitBatch& a, const DaWarpGeometry& geo,
                                    void* stream) {
  const int smem = static_cast<int>(geo.smem);
  cudaFuncSetAttribute(darcy_misfit_warp_kernel<N, SOLVER>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  darcy_misfit_warp_kernel<N, SOLVER><<<geo.ctas, 32 * geo.warps, smem,
                                        static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Launches darcy_misfit_warp_kernel on the batch, at the spec's level and
// by its solver: the status of the geometry or of the launch.
inline int launch_misfit_warp(const MisfitBatch& a, void* stream) {
  DaWarpGeometry geo;
  const int status = misfit_warp_geometry(a.s, a.B, &geo);
  if (status != cudaSuccess) return status;
  if (a.B == 0) return cudaSuccess;
  if (a.s.n == kDaWarpExactN)
    return launch_misfit_warp_level<kDaWarpExactN, kSolverCg>(a, geo, stream);
  if (a.s.solver == kSolverRichardson)
    return launch_misfit_warp_level<kDaWarpSurrN, kSolverRichardson>(a, geo, stream);
  return launch_misfit_warp_level<kDaWarpSurrN, kSolverCg>(a, geo, stream);
}

// --- the standalone 16 x 16 Jacobi misfit: one draw a warp ---------------------
//
// Phi for a (K, B) batch of the cold 16 x 16 Jacobi CG misfit (Phi0 of
// darcy_ess_fused, darcy_pcn_4096 --fused and darcy_fes_fused: Jacobi / 48
// CG, 4096 draws) on the solve its samplers run, WarpSliceLevel: one draw a
// warp, lane l owning eight cells of one 32-cell slice, the dot products
// added in block_sum's order, so that Phi has the bits of the one-draw-a-CTA
// kernel (darcy_misfit_kernel on Layout16, 256 threads, a CTA barrier on
// every stencil and block_sum). The KL basis is staged once a CTA, padded as
// the level reads it; each warp's slice holds its draw's u and the solve's
// p, th, tv. A Jacobi solve needs no other draw, so after the staging
// barrier the spare warps of a ragged last CTA leave.

// The design (scripts/measure_misfit_slice_design.py times the
// alternatives): kWarps draws a CTA, one a warp; the launch bound's warps
// an SM (kSmWarps: 16 caps a thread at 128 registers, 32 at 64). Measured
// on the H100 at 4096 draws (PERF.md): 32 draws a CTA at 64 registers, no
// spill (one wave of 128 CTAs), 0.100 ms a call, against 0.110 at W = 16
// (107 registers) and 0.119 at W = 8; the basis read through L2 instead,
// 0.155-0.160; every design gives the same bits.
struct MisfitSliceDesign { static constexpr int kWarps = 32, kSmWarps = 32; };
constexpr int kMisfitSliceMinCtas = MisfitSliceDesign::kSmWarps >= 2 * MisfitSliceDesign::kWarps
                                        ? MisfitSliceDesign::kSmWarps / MisfitSliceDesign::kWarps
                                        : 1;
// a warp's slice: the draw's u (K), then p, th, tv (the level's padded cells)
constexpr int kMisfitSliceFloats = WarpSliceLevel::kK + 3 * WarpSliceLevel::kStride;

// Dynamic shared memory of a launch: the staged basis, a slice a warp.
constexpr size_t kMisfitSliceSmem =
    WarpSliceLevel::staged_bytes() + sizeof(float) * kMisfitSliceFloats * MisfitSliceDesign::kWarps;
static_assert(kMisfitSliceSmem <= 232448, "the design's CTA exceeds the card's shared memory");

// Whether darcy_misfit_slice_kernel takes this spec (ipx_darcy_misfit sends
// it there): WarpSliceLevel's, i.e. 16 x 16, K = 64, Jacobi, CG
// (warp_slice_spec). Mirrored by ip_mcmc_tpu_torch/ops/fused_da_pcn.py
// misfit_slice_takes.
inline bool misfit_slice_takes(const IpxMisfitSpec& s) { return warp_slice_spec(s); }

// Mirrored by ip_mcmc_tpu_torch/ops/fused_da_pcn.py misfit_slice_geometry:
// kWarps draws a CTA, the spare warps of a ragged last CTA leave; what
// misfit_slice_takes refuses, cudaErrorNotSupported.
inline int misfit_slice_geometry(const IpxMisfitSpec& s, int B, DaWarpGeometry* geo) {
  if (!misfit_slice_takes(s)) return cudaErrorNotSupported;
  if (B < 0) return cudaErrorInvalidValue;
  geo->warps = MisfitSliceDesign::kWarps;
  geo->ctas = (B + geo->warps - 1) / geo->warps;
  geo->smem = kMisfitSliceSmem;
  return cudaSuccess;
}

__global__ void __launch_bounds__(32 * MisfitSliceDesign::kWarps, kMisfitSliceMinCtas)
    darcy_misfit_slice_kernel(const __grid_constant__ MisfitBatch a) {
  constexpr int kStride = WarpSliceLevel::kStride, K = WarpSliceLevel::kK;
  extern __shared__ float4 misfit_slice_smem_buf[];
  float* staged = reinterpret_cast<float*>(misfit_slice_smem_buf);
  const float* basis = WarpSliceLevel::stage(a.s, staged);
  float* slices = staged + WarpSliceLevel::staged_bytes() / sizeof(float);
  // the CTA's draws' coefficients, W consecutive columns of U a row
  const int W = blockDim.x >> 5, b0 = blockIdx.x * W, B = a.B;
  for (int e = threadIdx.x; e < K * W; e += blockDim.x) {
    const int k = e / W, j = e % W;
    if (b0 + j < B) slices[j * kMisfitSliceFloats + k] = a.U[static_cast<size_t>(k) * B + b0 + j];
  }
  __syncthreads();  // the staged basis and every warp's u
  const int b = b0 + (threadIdx.x >> 5);
  if (b >= B) return;  // a spare warp: no CTA barrier follows
  float* u = slices + (threadIdx.x >> 5) * kMisfitSliceFloats;
  const WarpSmem ws{u + K, u + K + kStride, u + K + 2 * kStride};
  const float v = WarpSliceLevel{&a.s, basis, ws}.phi(u);
  if ((threadIdx.x & 31) == 0) a.phi[b] = v;
}

// Launches darcy_misfit_slice_kernel on the batch: the status of the
// geometry or of the launch.
inline int launch_misfit_slice(const MisfitBatch& a, void* stream) {
  DaWarpGeometry geo;
  const int status = misfit_slice_geometry(a.s, a.B, &geo);
  if (status != cudaSuccess) return status;
  if (a.B == 0) return cudaSuccess;
  const int smem = static_cast<int>(geo.smem);
  cudaFuncSetAttribute(darcy_misfit_slice_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  darcy_misfit_slice_kernel<<<geo.ctas, 32 * geo.warps, smem, static_cast<cudaStream_t>(stream)>>>(
      a);
  return static_cast<int>(cudaGetLastError());
}

// --- one chain a warp: K4 on Burgers -------------------------------------------
//
// burgers_da_pcn (k = 16: 16 surrogate solves of 64 cells / 26 Godunov steps and one exact solve of
// 128 / 154 an outer step, 570 dependent time steps). One chain a CTA of 128 threads, one thread a
// cell (0.191 ms an outer step at 2048 chains on an H100 80GB HBM3, PERF.md), paid a block barrier
// a time step and left half its threads idle on the 64-cell surrogate. So every pair of specs that
// burgers_warp_takes runs a chain a warp on run_warp_chain<RECORD, 16>, as the three-level DA
// kernel does: lanes 0..15 hold the coordinates of the chain's three positions (current, subchain,
// proposal) in the warp's shared memory, both levels' bases and means are staged once a CTA, and
// Phi comes from burgers_phi_warp in the one-chain-a-CTA kernel's block_sum order (its CTA had as
// many threads as the larger level has cells), so the chains keep that kernel's bits. The design is
// the line DaBurgersWarpDesign (scripts/measure_burgers_warp_design.py times the alternatives,
// PERF.md the numbers).

// The design: kWarps chains a CTA at most, one a warp; the launch bound's
// warps an SM (kSmWarps: 32 caps a thread at 64 registers, 16 at 128;
// 2048 chains on 132 SMs are 16 warps an SM at most).
struct DaBurgersWarpDesign { static constexpr int kWarps = 16, kSmWarps = 16; };
constexpr int kDaBurgersWarpMinCtas =
    DaBurgersWarpDesign::kSmWarps >= 2 * DaBurgersWarpDesign::kWarps
        ? DaBurgersWarpDesign::kSmWarps / DaBurgersWarpDesign::kWarps
        : 1;
constexpr int kDaBurgersD = kBurgersWarpK;  // coordinates, one a lane of lanes 0..15
// a warp's slice: pos0, pos, prop (kDaBurgersD each), then the gather
// buffer of the larger level; before the slices, both levels' staged bases
// and means
constexpr int kDaBurgersWarpFloats = 3 * kDaBurgersD + kBurgersWarpCells;

// K4 on a warp, DaStep's tags: k pCN steps against the surrogate (tags 4j,
// 4j+1, 4j+2), then one exact correction with tag 4k+2 whose NaN log-ratio
// maps to -inf; every inner MH test is log u < delta, so NaN rejects.
// Lane t < 16 holds coordinate t of the three positions.
struct DaBurgersWarpStep {
  using Ctx = WarpChainCtxT<kDaBurgersD>;
  const DaArgs<BurgersPotential>& a;
  BurgersWarpLevel exact, surr;
  int threads;  // the one-chain-a-CTA kernel's, whose block_sum order Phi keeps
  float* pos0;  // current state
  float* pos;   // subchain state
  float* prop;  // proposal
  float phi0, surr0, in_acc;

  __device__ void init(const Ctx& x) {
    const int t = threadIdx.x & 31;
    phi0 = x.live ? a.phi0[x.c] : 0.0f;
    surr0 = x.live ? a.surr0[x.c] : 0.0f;
    if (Ctx::holds(0)) pos[t] = pos0[t];
    __syncwarp();
  }

  __device__ bool step(const Ctx& x, uint32_t i) {
    const int t = threadIdx.x & 31;
    const bool own = Ctx::holds(0);
    float surr_v = surr0;
    for (int j = 0; j < a.k; ++j) {
      if (own) {
        const float xi = x.scale[0] * x.normal1(i, 4u * j);
        prop[t] = x.mean[0] + a.contraction * (pos[t] - x.mean[0]) + a.beta * xi;
      }
      __syncwarp();
      const float sp = burgers_level_phi(surr, prop, threads);
      if (logf(x.uniform(i, 4u * j + 2u)) < surr_v - sp) {  // the same in every lane
        in_acc += 1.0f;
        surr_v = sp;
        if (own) pos[t] = prop[t];
      }
    }
    __syncwarp();
    const float pe = burgers_level_phi(exact, pos, threads);
    float log_ratio = (phi0 - pe) - (surr0 - surr_v);
    if (isnan(log_ratio)) log_ratio = -INFINITY;
    const bool accept = logf(x.uniform(i, 4u * a.k + 2u)) < log_ratio;
    if (accept) {
      phi0 = pe;
      surr0 = surr_v;
      if (own) pos0[t] = pos[t];
    } else if (own) {
      pos[t] = pos0[t];
    }
    return accept;
  }
};

template <bool RECORD>
__global__ void __launch_bounds__(32 * DaBurgersWarpDesign::kWarps, kDaBurgersWarpMinCtas)
    fused_da_pcn_burgers_warp_kernel(const __grid_constant__ DaArgs<BurgersPotential> a) {
  extern __shared__ float4 da_burgers_warp_smem[];
  float* staged = reinterpret_cast<float*>(da_burgers_warp_smem);
  BurgersWarpLevel exact{&a.exact}, surr{&a.surr};
  float* w = surr.stage(exact.stage(staged)) + (threadIdx.x >> 5) * kDaBurgersWarpFloats;
  exact.state = surr.state = w + 3 * kDaBurgersD;
  __syncthreads();  // the staged levels
  // the one-chain-a-CTA kernel's threads: a thread a cell of the larger level
  const int threads = max(a.exact.n_cells, a.surr.n_cells);
  DaBurgersWarpStep step{a,    exact,         surr,          threads, w,
                         w + kDaBurgersD, w + 2 * kDaBurgersD, 0.0f, 0.0f, 0.0f};
  run_warp_chain<RECORD, kDaBurgersD>(a.chain, step, w);
  const int c = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (c < a.chain.n && (threadIdx.x & 31) == 0)
    a.inner[c] = step.in_acc / fmaxf(static_cast<float>(a.chain.n_steps) *
                                         static_cast<float>(a.k),
                                     1.0f);
}

// Mirrored by ip_mcmc_tpu_torch/ops/fused_da_pcn.py burgers_warp_geometry:
// a pair that burgers_warp_takes refuses, cudaErrorNotSupported (the entry
// point sends it to fused_da_pcn_kernel<BurgersPotential, ·>). W: the
// largest power of two up to kWarps that divides block_chains; a ragged
// last CTA runs spare warps.
inline int da_burgers_warp_geometry(const IpxBurgersSpec& exact, const IpxBurgersSpec& surr,
                                    const IpxChainArgs& chain, int k, DaWarpGeometry* geo) {
  if (!burgers_warp_takes(exact, chain.d) || !burgers_warp_takes(surr, chain.d))
    return cudaErrorNotSupported;
  if (chain.block_chains <= 0 || chain.n < 0 || chain.n_steps < 0 || k < 0 ||
      (chain.samples != nullptr && chain.thin <= 0))
    return cudaErrorInvalidValue;
  int w = DaBurgersWarpDesign::kWarps;
  while (chain.block_chains % w) w /= 2;
  geo->warps = w;
  geo->ctas = (chain.n + w - 1) / w;
  geo->smem = sizeof(float) * (BurgersWarpLevel::staged_floats(exact.n_cells) +
                               BurgersWarpLevel::staged_floats(surr.n_cells) +
                               kDaBurgersWarpFloats * w);
  return geo->smem <= 232448 ? cudaSuccess : cudaErrorInvalidValue;
}

// Launches fused_da_pcn_burgers_warp_kernel<RECORD> (RECORD: chain.samples
// given).
inline int launch_da_pcn_burgers_warp(const IpxBurgersSpec& exact, const IpxBurgersSpec& surr,
                                      const IpxChainArgs& chain, const float* phi0,
                                      const float* surr0, float beta, float contraction, int k,
                                      float* inner, void* stream) {
  DaWarpGeometry geo;
  const int status = da_burgers_warp_geometry(exact, surr, chain, k, &geo);
  if (status != cudaSuccess) return status;
  if (chain.n == 0) return cudaSuccess;
  const DaArgs<BurgersPotential> a{exact, surr, chain, phi0, surr0, beta, contraction, k, inner};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = 32 * geo.warps, smem = static_cast<int>(geo.smem);
  if (chain.samples != nullptr) {
    cudaFuncSetAttribute(fused_da_pcn_burgers_warp_kernel<true>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    fused_da_pcn_burgers_warp_kernel<true><<<geo.ctas, threads, smem, st>>>(a);
  } else {
    cudaFuncSetAttribute(fused_da_pcn_burgers_warp_kernel<false>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    fused_da_pcn_burgers_warp_kernel<false><<<geo.ctas, threads, smem, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ipx

extern "C" {

const char* ipx_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// sizeof(IpxMisfitSpec), against which the ctypes mirror is checked.
int ipx_misfit_spec_size() { return static_cast<int>(sizeof(IpxMisfitSpec)); }

// A spec of a level of the 16 x 16 DA kernel (misfit_warp_takes: its exact
// level, its 8 x 8 surrogate level by CG or Richardson) goes to
// darcy_misfit_warp_kernel<N, SOLVER>; the 16 x 16 Jacobi spec of the ESS, cold pCN
// and FES samplers' solve (misfit_slice_takes) to darcy_misfit_slice_kernel;
// one of a cluster sampler's level (misfit_cluster_takes) to
// darcy_misfit_cluster_kernel (64 x 64), darcy_misfit_cluster32_kernel (the
// 32 x 32 warm pCN's) or darcy_misfit_surr_cluster_kernel (the 64 x 64 DA
// kernel's 32 x 32 surrogate); for every other the layout follows the
// spec's grid, the solve its solver.
int ipx_darcy_misfit(const IpxMisfitSpec* s, const float* U, int B, float* phi,
                     void* stream) {
  if (ipx::misfit_warp_takes(*s))
    return ipx::launch_misfit_warp({*s, U, nullptr, B, phi, nullptr}, stream);
  if (ipx::misfit_slice_takes(*s))
    return ipx::launch_misfit_slice({*s, U, nullptr, B, phi, nullptr}, stream);
  if (ipx::misfit_cluster_takes(*s))
    return ipx::launch_misfit_cluster(ipx::darcy_misfit_cluster_kernel,
                                      ipx::darcy_misfit_cluster32_kernel,
                                      ipx::darcy_misfit_surr_cluster_kernel,
                                      {*s, U, nullptr, B, phi, nullptr}, stream);
  const auto launch = [&](auto pot) {
    return ipx::launch_misfit<decltype(pot)>(*s, U, B, phi, stream);
  };
  if (s->solver == kSolverRichardson)
    return ipx::with_darcy_layout<kSolverRichardson>(*s, launch);
  return ipx::with_darcy_layout<kSolverCg>(*s, launch);
}

// da_route picks the kernel: the 16x16 warp kernel (its surrogate solved by
// CG or Richardson), the 64x64 cluster kernel, the one-chain-a-CTA kernel
// of the pair's class (fused_da_pcn_kernel on Layout16, the surrogate's
// solve by its solver; on DaLayout64 with the surrogate on DaSurrogate32),
// or none: any other pair or solve is refused with cudaErrorNotSupported,
// not run by another kernel.
int ipx_fused_da_pcn(const IpxMisfitSpec* exact, const IpxMisfitSpec* surr,
                     const IpxChainArgs* chain, const float* phi0, const float* surr0,
                     float beta, float contraction, int k, float* inner, void* stream) {
  using ipx::DarcyPotential;
  const bool richardson = surr->solver == kSolverRichardson;
  switch (ipx::da_route(*exact, *surr, chain->d)) {
    case ipx::kRouteWarp:
      if (richardson)
        return ipx::launch_da_pcn_warp<kSolverRichardson>(*exact, *surr, *chain, phi0, surr0,
                                                          beta, contraction, k, inner, stream);
      return ipx::launch_da_pcn_warp<kSolverCg>(*exact, *surr, *chain, phi0, surr0, beta,
                                                contraction, k, inner, stream);
    case ipx::kRouteCluster:
      return ipx::launch_da_pcn_cluster(*exact, *surr, *chain, phi0, surr0, beta, contraction,
                                        k, inner, stream);
    case ipx::kRouteCta:
      if (exact->n * exact->n > DarcyPotential::kMaxCells)
        return ipx::launch_da_pcn<ipx::DaExact64, ipx::DaSurrogate32>(
            *exact, *surr, *chain, phi0, surr0, beta, contraction, k, inner, stream);
      if (richardson)
        return ipx::launch_da_pcn<DarcyPotential, ipx::DarcyPot<ipx::Layout16, kSolverRichardson>>(
            *exact, *surr, *chain, phi0, surr0, beta, contraction, k, inner, stream);
      return ipx::launch_da_pcn<DarcyPotential>(*exact, *surr, *chain, phi0, surr0, beta,
                                                contraction, k, inner, stream);
    default:
      return cudaErrorNotSupported;
  }
}

// The kernel ipx_fused_da_pcn sends this pair to, for chains of d
// coordinates (ipx::kRoute*; the wrapper's mirror is checked against this
// on the card).
int ipx_da_pcn_route(const IpxMisfitSpec* exact, const IpxMisfitSpec* surr, int d) {
  return ipx::da_route(*exact, *surr, d);
}

// The 16 x 16 kernel's launch geometry for these specs and chain
// arguments: out = {chains a CTA, CTAs, dynamic shared-memory bytes}; the
// status the launch would return for them (the wrapper's mirror of it is
// checked against this on the card).
int ipx_da_pcn_warp_geometry(const IpxMisfitSpec* exact, const IpxMisfitSpec* surr,
                             const IpxChainArgs* chain, int* out) {
  ipx::DaWarpGeometry geo{0, 0, 0};
  const int status = ipx::da_warp_geometry(*exact, *surr, *chain, surr->solver, &geo);
  out[0] = geo.warps;
  out[1] = geo.ctas;
  out[2] = static_cast<int>(geo.smem);
  return status;
}

// The cluster kernels' launch geometry (fused_da_pcn_cluster_kernel; with
// surr null, fused_pcn_warm_cluster_kernel of fused_pcn.cu): out = {chains
// a cluster, clusters, CTAs, dynamic shared-memory bytes}; the status the
// launch would return before its occupancy check (the wrapper's mirror is
// checked against this on the card).
int ipx_darcy_cluster_geometry(const IpxMisfitSpec* exact, const IpxMisfitSpec* surr,
                               const IpxChainArgs* chain, int* out) {
  ipx::ClusterGeometry geo{0, 0, 0, 0, 0};
  const int status = ipx::cluster_geometry(*exact, surr, *chain, &geo);
  out[0] = geo.g;
  out[1] = geo.clusters;
  out[2] = geo.ctas;
  out[3] = static_cast<int>(geo.smem);
  return status;
}

// The standalone cluster misfits' launch geometry
// (darcy_misfit_cluster_kernel, darcy_misfit_cluster32_kernel,
// darcy_misfit_surr_cluster_kernel;
// darcy_misfit_warm_cluster_kernel and darcy_misfit_warm_cluster32_kernel
// of fused_pcn.cu) for this spec and B
// draws: out = {draws a cluster, clusters, CTAs, dynamic shared-memory
// bytes}; the status the launch would return before its occupancy check,
// cudaErrorNotSupported for a spec that goes to the kernels of its layout
// (the wrapper's mirror is checked against this on the card).
int ipx_darcy_misfit_cluster_geometry(const IpxMisfitSpec* s, int B, int* out) {
  ipx::ClusterGeometry geo{0, 0, 0, 0, 0};
  const int status = ipx::misfit_cluster_geometry(*s, B, &geo);
  out[0] = geo.g;
  out[1] = geo.clusters;
  out[2] = geo.ctas;
  out[3] = static_cast<int>(geo.smem);
  return status;
}

// The launch geometry of the standalone misfits on the 16 x 16 DA kernel's
// levels (darcy_misfit_warp_kernel<N, SOLVER>) for this spec and B draws: out = {draws a
// CTA, CTAs, dynamic shared-memory bytes}; the status the launch would
// return for them, cudaErrorNotSupported for a spec that goes to another
// kernel (the wrapper's mirror is checked against this on the card).
int ipx_darcy_misfit_warp_geometry(const IpxMisfitSpec* s, int B, int* out) {
  ipx::DaWarpGeometry geo{0, 0, 0};
  const int status = ipx::misfit_warp_geometry(*s, B, &geo);
  out[0] = geo.warps;
  out[1] = geo.ctas;
  out[2] = static_cast<int>(geo.smem);
  return status;
}

// The standalone 16 x 16 Jacobi misfit's launch geometry
// (darcy_misfit_slice_kernel) for this spec and B draws: out = {draws a
// CTA, CTAs, dynamic shared-memory bytes}; the status the launch would
// return for them, cudaErrorNotSupported for a spec that goes to another
// kernel (the wrapper's mirror is checked against this on the card).
int ipx_darcy_misfit_slice_geometry(const IpxMisfitSpec* s, int B, int* out) {
  ipx::DaWarpGeometry geo{0, 0, 0};
  const int status = ipx::misfit_slice_geometry(*s, B, &geo);
  out[0] = geo.warps;
  out[1] = geo.ctas;
  out[2] = static_cast<int>(geo.smem);
  return status;
}

// A pair that burgers_warp_takes (64 or 128 cells each, d = K = 16) goes to
// fused_da_pcn_burgers_warp_kernel, any other to
// fused_da_pcn_kernel<BurgersPotential, ·>, one chain a CTA.
int ipx_fused_da_pcn_burgers(const IpxBurgersSpec* exact, const IpxBurgersSpec* surr,
                             const IpxChainArgs* chain, const float* phi0, const float* surr0,
                             float beta, float contraction, int k, float* inner,
                             void* stream) {
  if (ipx::burgers_warp_takes(*exact, chain->d) && ipx::burgers_warp_takes(*surr, chain->d))
    return ipx::launch_da_pcn_burgers_warp(*exact, *surr, *chain, phi0, surr0, beta,
                                           contraction, k, inner, stream);
  return ipx::launch_da_pcn<ipx::BurgersPotential>(*exact, *surr, *chain, phi0, surr0, beta,
                                                   contraction, k, inner, stream);
}

// A linear-Gaussian pair that linear_cta_takes at both levels goes to
// fused_da_pcn_kernel<LinearGaussianPotential, ·>, one chain a CTA; any
// other is refused (cudaErrorNotSupported).
int ipx_fused_da_pcn_linear(const IpxGaussianSpec* exact, const IpxGaussianSpec* surr,
                            const IpxChainArgs* chain, const float* phi0, const float* surr0,
                            float beta, float contraction, int k, float* inner, void* stream) {
  if (ipx::da_linear_route(*exact, *surr, chain->d) != ipx::kRouteCta)
    return cudaErrorNotSupported;
  return ipx::launch_da_pcn<ipx::LinearGaussianPotential>(*exact, *surr, *chain, phi0, surr0,
                                                          beta, contraction, k, inner, stream);
}

// The kernel ipx_fused_da_pcn_linear sends this pair to, for chains of d
// coordinates (ipx::kRoute*; the wrapper's mirror is checked against this
// on the card).
int ipx_da_pcn_linear_route(const IpxGaussianSpec* exact, const IpxGaussianSpec* surr, int d) {
  return ipx::da_linear_route(*exact, *surr, d);
}

// The Burgers warp kernel's launch geometry for these specs, chain
// arguments and k: out = {chains a CTA, CTAs, dynamic shared-memory bytes};
// the status the launch would return for them, cudaErrorNotSupported for a
// pair that goes to the one-chain-a-CTA kernel (the wrapper's mirror is
// checked against this on the card).
int ipx_da_pcn_burgers_warp_geometry(const IpxBurgersSpec* exact, const IpxBurgersSpec* surr,
                                     const IpxChainArgs* chain, int k, int* out) {
  ipx::DaWarpGeometry geo{0, 0, 0};
  const int status = ipx::da_burgers_warp_geometry(*exact, *surr, *chain, k, &geo);
  out[0] = geo.warps;
  out[1] = geo.ctas;
  out[2] = static_cast<int>(geo.smem);
  return status;
}

}  // extern "C"
