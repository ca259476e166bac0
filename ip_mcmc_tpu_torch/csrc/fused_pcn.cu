// Hand-written Hopper kernels of the single-level pCN paths.
//
// Replaces the Pallas TPU kernel of ip_mcmc_tpu/ops/fused_mcmc.py as
// instantiated by fused_pcn_chain (l.1502) / fused_pcn_chain_recorded
// (l.1387) with _pcn_step_builder (K6, l.303), and by fused_pcn_chain_warm
// (l.1313) / fused_pcn_chain_warm_recorded (l.1351) with
// _make_pcn_warm_step_builder (K7, l.486) around
// darcy.make_batched_misfit_warm (ip_mcmc_tpu/models/darcy.py l.669).
//
//   darcy_misfit_warm_kernel<Pot>  (U (K, B), x0 (n*n, B)) -> (Phi (B,),
//                                  x (n*n, B)): the warm-started misfit,
//                                  one draw a CTA of the spec's layout.
//   darcy_misfit_warm_warp_kernel  the same on a spec of the 16 x 16 warm
//                                  pCN below, one draw a warp on its
//                                  level (WarpTruncSliceLevel).
//   darcy_misfit_warm_dst_warp_kernel  the same on a 16 x 16 dense-dst CG
//                                  spec (darcy_smc_warm's mutation), one
//                                  draw a warp on warm MALA's level
//                                  (WarpDstSliceLevel).
//   darcy_misfit_warm_cluster_kernel  the same on the specs of the 64 x 64
//                                  samplers' exact level, one draw a CTA,
//                                  G draws a thread-block cluster.
//   darcy_misfit_warm_cluster32_kernel  the same on the level of the 32 x 32
//                                  warm pCN (Cluster32Exact).
//   fused_pcn_kernel<Pot, RECORD>  cold pCN: proposal, Phi, MH. The
//                                  potential is a type: DarcyPot (Phi from
//                                  x = 0), BurgersPotential (K12,
//                                  burgers_misfit.cuh) or
//                                  LinearGaussianPotential
//                                  (gaussian_potential.cuh: ipx_fused_pcn_linear,
//                                  every spec that linear_cta_takes).
//   fused_pcn_warm_kernel<Pot, RECORD>  pCN carrying each chain's CG
//                                  solution: each thread keeps its cells of
//                                  the accepted x in registers, the
//                                  proposal's solve starts from them, and x
//                                  follows the MH select (any grid up to
//                                  64 x 64 that the kernels below leave,
//                                  in the layout of its grid).
//   fused_pcn_warm_cluster_kernel<RECORD>  the same on 64 x 64, G chains
//                                  a thread-block cluster.
//   fused_pcn_warm_cluster32_kernel<RECORD>  the same on 32 x 32, in a
//                                  layout of its own at 7 CTAs an SM, the
//                                  factors read through L2.
//   fused_pcn_warp_kernel<RECORD, PRECOND>  the 16 x 16 grid with d = K =
//                                  64, one chain a warp: cold on a Jacobi
//                                  CG misfit (PRECOND kPrecondJacobi, K6),
//                                  warm on a dst_trunc CG one (a multiple
//                                  of 16 modes up to 112; kPrecondDstTrunc,
//                                  K7). ipx_fused_pcn sends it every spec
//                                  it takes, the kernels above the rest
//                                  (pcn_route).
//   fused_pcn_burgers_warp_kernel<RECORD>  K6 on a Burgers misfit of 64
//                                  or 128 cells with d = K = 16, one chain
//                                  a warp (burgers_misfit.cuh's warp
//                                  solve). ipx_fused_pcn_burgers sends it
//                                  every spec it takes (burgers_warp_takes:
//                                  the shipped configs'), the rest to
//                                  fused_pcn_kernel<BurgersPotential, ·>.
//
// Layout and scaffold: fused_scaffold.cuh (one CTA per chain) and the
// Darcy layouts of darcy_misfit.cuh: up to 16 x 16 one thread per cell; the
// 32 x 32 and 64 x 64 grids (the cold misfit and cold pCN; the warm ones,
// and the misfits of a dst_trunc CG spec, run in clusters)
// several cells per thread, picked from the spec's grid at launch. Phi
// (and x) at the start positions come in from the standalone misfit
// kernels: at 64 x 64, and at 32 x 32 for a dst_trunc CG spec, from the
// cluster level of the samplers' steps. Tags:
// normals 0 (keys 0, 1), MH uniform 2.
//
// What bounds them on the H100: per chain and step one solve (Burgers one
// chain a CTA: the barrier per Godunov step, see burgers_misfit.cuh; the
// Burgers warp kernel: the Godunov arithmetic, see below). The Darcy
// cold Jacobi solve of 48 CG iterations is ~0.3 M multiply-adds but ~100
// dependent block reductions of 256 threads, so barrier latency, not the
// f32 rate or memory, sets its time; the warm dst_trunc solve (4
// iterations, 64 modes) re-reads the 32 KB of bf16 modes from L1/L2 ten
// times per step. On the large grids the factors are megabytes (64 x 64:
// the f32 KL basis 2.4 MB, the 256 bf16 modes 2 MB), so each chain-step
// reads ~22 MB from L2 there (the basis once, V twice in each of five
// preconditioner applies) and L2 bandwidth bounds the step. This first
// design keeps the factors in global memory and one chain per CTA: no
// staging, no wgmma, no TMA. Above 16 x 16 the warm kernels run in
// thread-block clusters: the G chains of a cluster share each read of the
// factors and run the preconditioner's products on the tensor cores
// (ClusterLevel in darcy_misfit.cuh). At 64 x 64 (design ClusterDesign, as
// in fused_da_pcn.cu's 64 x 64 DA kernel) the factors stay in L2. At
// 32 x 32 (darcy32_pcn_warm, design Cluster32Design) one chain a CTA read
// ~2.8 MB of factors from L2 a step (the basis once, V twice in each of
// five applies), ~11.5 GB a step at 4096 chains, and took 2.32 ms. There a
// CTA's slices of the modes (two of 32 KB at G = 8) fit in its shared
// memory for the launch, but then only two CTAs fit an SM; measured on the
// H100 (scripts/measure_pcn32_cluster_design.py, PERF.md) the cluster's
// phases wait on latency more than on L2, and the smallest CTA wins: 8
// cells a thread on 128 threads, 7 CTAs an SM, the factors read through L2
// (0.56 ms; resident at 2 CTAs an SM 0.80-0.85).
//
// On the 16 x 16 grid one chain a CTA of 256 threads (the first design,
// 0.414 ms a cold and 0.337 ms a warm step at 4096 chains) paid a CTA
// barrier for every stencil and block reduction, and the warm solve two
// more and two reads of V from L1/L2 for every dst_trunc apply. So there
// the kernel runs one chain a warp on fused_scaffold.cuh's
// run_warp_chain, 16 chains a CTA, lane l holding coordinates l, l + 32 of
// d = 64 and eight cells of one 32-cell slice (darcy_misfit.cuh). The cold
// solve runs on WarpSliceLevel, as fused_ess.cu's: every sum in the
// one-chain-a-CTA kernel's order, so the chains keep its bits, and no CTA
// barrier after the staging of the basis. The warm one runs on
// WarpTruncSliceLevel, the carried solution in eight registers a lane:
// everything in the parent's order but the dst_trunc products, which run
// over the CTA's 16 chains on the tensor cores from the modes staged once
// a CTA (three CTA barriers an apply). Measured on the H100
// (scripts/measure_pcn_warp_design.py, PERF.md), a warm step takes 0.051
// ms so, 0.071 with the modes read through L2 and 0.093 with the products
// on the warp's CUDA cores in the parent's order. W and the launch bound
// are the line PcnWarpDesign.
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

#include "burgers_misfit.cuh"
#include "darcy_misfit.cuh"
#include "fused_scaffold.cuh"
#include "gaussian_potential.cuh"

namespace ipx {

// (Phi, x) for a (K, B) batch from the starts x0, one CTA per draw.
template <class Pot>
__device__ __forceinline__ void misfit_warm_batch(const IpxMisfitSpec& s,
                                                  const float* __restrict__ U,
                                                  const float* __restrict__ x0, int B,
                                                  float* __restrict__ phi,
                                                  float* __restrict__ x_out) {
  constexpr int C = Pot::kCellsPerThread;
  extern __shared__ float smem[];
  const int b = blockIdx.x, t = threadIdx.x, cells = s.n * s.n;
  float* u = smem;
  const MisfitSmem ws = carve_misfit_smem(smem + s.K, cells, s.modes);
  for (int k = t; k < s.K; k += blockDim.x) u[k] = U[static_cast<size_t>(k) * B + b];
  float x[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int cell = own_cell(c);
    x[c] = cell < cells ? x0[static_cast<size_t>(cell) * B + b] : 0.0f;
  }
  __syncthreads();
  const float v = darcy_solve<true, C>(s, u, ws, x);
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int cell = own_cell(c);
    if (cell < cells) x_out[static_cast<size_t>(cell) * B + b] = x[c];
  }
  if (t == 0) phi[b] = v;
}

// No launch bound up to 256 threads, the wider layouts' bound above (see
// darcy_misfit_kernel in fused_da_pcn.cu).
template <class Pot>
__global__ void darcy_misfit_warm_kernel(IpxMisfitSpec s, const float* __restrict__ U,
                                         const float* __restrict__ x0, int B,
                                         float* __restrict__ phi, float* __restrict__ x_out) {
  misfit_warm_batch<Pot>(s, U, x0, B, phi, x_out);
}

template <class Pot>
__global__ void __launch_bounds__(Pot::kMaxThreads, Pot::kMinCtasPerSm)
    darcy_misfit_warm_wide_kernel(IpxMisfitSpec s, const float* __restrict__ U,
                                  const float* __restrict__ x0, int B, float* __restrict__ phi,
                                  float* __restrict__ x_out) {
  misfit_warm_batch<Pot>(s, U, x0, B, phi, x_out);
}

// (Phi, x) for a (K, B) batch from the starts x0 on the exact level of the
// 64 x 64 samplers, one draw a CTA, G draws a thread-block cluster
// (misfit_cluster_draw in darcy_misfit.cuh): darcy64_pcn_warm's warm
// misfit, 2048 draws of dst_trunc-256 / 4 CG from x0 = 0, the solve of
// fused_pcn_warm_cluster_kernel's steps. The design is ClusterDesign.
__global__ void __launch_bounds__(ClusterDesign::kThreads, ClusterDesign::kMinCtas)
    darcy_misfit_warm_cluster_kernel(const __grid_constant__ MisfitBatch a) {
  misfit_cluster_draw<true, ClusterExact>(a);
}

// The same on the level of the 32 x 32 warm pCN (Cluster32Exact, in its own
// layout Cluster32Smem): darcy32_pcn_warm's warm misfit, 4096 draws of
// dst_trunc-128 / 4 CG from x0 = 0, the solve of
// fused_pcn_warm_cluster32_kernel's steps. The design is Cluster32Design.
__global__ void __launch_bounds__(Cluster32Design::kThreads, Cluster32Design::kMinCtas)
    darcy_misfit_warm_cluster32_kernel(const __grid_constant__ MisfitBatch a) {
  misfit_cluster_draw<true, Cluster32Exact>(a);
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
// WARM (Darcy only): x holds this thread's cells of the accepted CG
// solution.
template <class Pot, bool WARM>
struct PcnStep {
  static constexpr int C = Pot::kCellsPerThread;
  const PcnArgs<Pot>& a;
  float* pos;
  float* prop;
  typename Pot::Workspace ws;
  float phi;
  float x[C];

  __device__ void init(const ChainCtx& c) {
    phi = a.phi0[c.c];
#pragma unroll
    for (int k = 0; k < C; ++k) x[k] = 0.0f;
    if constexpr (WARM) {
      const int cells = a.pot.n * a.pot.n;
#pragma unroll
      for (int k = 0; k < C; ++k) {
        const int cell = own_cell(k);
        if (cell < cells) x[k] = a.x0[static_cast<size_t>(cell) * a.chain.n + c.c];
      }
    }
  }

  __device__ bool step(const ChainCtx& c, uint32_t i) {
    if (c.own) {
      const float xi = c.scale_t * c.normal(i, 0u);
      prop[c.t] = c.mean_t + a.contraction * (pos[c.t] - c.mean_t) + a.beta * xi;
    }
    __syncthreads();
    float x_prop[C];
#pragma unroll
    for (int k = 0; k < C; ++k) x_prop[k] = x[k];
    float phi_prop;
    if constexpr (WARM) phi_prop = darcy_solve<true, C>(a.pot, prop, ws, x_prop);
    else phi_prop = Pot::phi(a.pot, prop, ws);
    const bool accept = logf(c.uniform(i, 2u)) < phi - phi_prop;
    if (accept) {
      phi = phi_prop;
      if (WARM) {
#pragma unroll
        for (int k = 0; k < C; ++k) x[k] = x_prop[k];
      }
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
                          0.0f, {}};
  run_chain<RECORD>(a.chain, step, pos);
}

template <class Pot, bool RECORD>
__global__ void __launch_bounds__(Pot::kMaxThreads, Pot::kMinCtasPerSm)
    fused_pcn_kernel(PcnArgs<Pot> a) {
  pcn_chain<Pot, RECORD, false>(a);
}

template <class Pot, bool RECORD>
__global__ void __launch_bounds__(Pot::kMaxThreads, Pot::kMinCtasPerSm)
    fused_pcn_warm_kernel(PcnArgs<Pot> a) {
  pcn_chain<Pot, RECORD, true>(a);
}

// K7 on a CTA of a thread-block cluster (the 64 x 64 and 32 x 32 grids):
// PcnStep<Pot, true>'s step with the cluster-level solve on the level L
// (darcy_misfit.cuh ClusterLevel). Each thread keeps its cells of the
// accepted x in registers; every CTA makes one warm solve a step whatever
// it accepts, so the cluster's barriers line up; a spare CTA (not live)
// runs on zeros.
template <class L>
struct PcnClusterStep {
  static constexpr int C = L::kC;
  const PcnArgs<DarcyPotential>& a;
  L lv;
  float* pos;
  float* prop;
  bool live;
  float phi;
  float x[C];

  __device__ void init(const ChainCtx& c) {
    phi = live ? a.phi0[c.c] : 0.0f;
    const int cells = a.pot.n * a.pot.n;
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const int cell = own_cell(k);
      x[k] = live && cell < cells ? a.x0[static_cast<size_t>(cell) * a.chain.n + c.c] : 0.0f;
    }
  }

  __device__ bool step(const ChainCtx& c, uint32_t i) {
    if (c.own) {
      const float xi = c.scale_t * c.normal(i, 0u);
      prop[c.t] = c.mean_t + a.contraction * (pos[c.t] - c.mean_t) + a.beta * xi;
    }
    __syncthreads();
    float x_prop[C];
#pragma unroll
    for (int k = 0; k < C; ++k) x_prop[k] = x[k];
    const float phi_prop = darcy_solve_cluster<true>(lv, prop, x_prop);
    const bool accept = logf(c.uniform(i, 2u)) < phi - phi_prop;
    if (accept) {
      phi = phi_prop;
#pragma unroll
      for (int k = 0; k < C; ++k) x[k] = x_prop[k];
      if (c.own) pos[c.t] = prop[c.t];
    }
    return accept;
  }
};

template <bool RECORD>
__global__ void __launch_bounds__(ClusterDesign::kThreads, ClusterDesign::kMinCtas)
    fused_pcn_warm_cluster_kernel(const __grid_constant__ PcnArgs<DarcyPotential> a) {
  const int d = a.chain.d;
  float* state = cluster_f32(ClusterSmem::kState);
  const bool live = static_cast<int>(blockIdx.x) < a.chain.n;
  PcnClusterStep<ClusterExact> step{a, {&a.pot}, state, state + d, live, 0.0f, {}};
  run_cluster_chain<RECORD>(a.chain, step, state, live);
  cg::this_cluster().sync();  // no peer reads this CTA's shared memory after it exits
}

// The same on the 32 x 32 grid (darcy32_pcn_warm): its own layout and
// design (Cluster32Design), the factors read through L2.
template <bool RECORD>
__global__ void __launch_bounds__(Cluster32Design::kThreads, Cluster32Design::kMinCtas)
    fused_pcn_warm_cluster32_kernel(const __grid_constant__ PcnArgs<DarcyPotential> a) {
  const int d = a.chain.d;
  float* state = cluster_f32(Cluster32Smem::kState);
  const bool live = static_cast<int>(blockIdx.x) < a.chain.n;
  PcnClusterStep<Cluster32Exact> step{a, {&a.pot}, state, state + d, live, 0.0f, {}};
  run_cluster_chain<RECORD>(a.chain, step, state, live);
  cg::this_cluster().sync();  // no peer reads this CTA's shared memory after it exits
}

// Launches fused_pcn_warm_cluster_kernel<RECORD> (64 x 64) or
// fused_pcn_warm_cluster32_kernel<RECORD> (32 x 32), by the spec's grid
// (RECORD: chain.samples given).
inline int launch_pcn_warm_cluster(const IpxMisfitSpec& pot, const IpxChainArgs& chain,
                                   const float* phi0, const float* x0, float beta,
                                   float contraction, void* stream) {
  ClusterGeometry geo;
  const int status = cluster_geometry(pot, nullptr, chain, &geo);
  if (status != cudaSuccess) return status;
  if (chain.n == 0) return cudaSuccess;
  const PcnArgs<DarcyPotential> a{pot, chain, phi0, x0, beta, contraction};
  const bool record = chain.samples != nullptr;
  if (pot.n == kCluster32N) {
    if (record) return launch_cluster(fused_pcn_warm_cluster32_kernel<true>, geo, stream, a);
    return launch_cluster(fused_pcn_warm_cluster32_kernel<false>, geo, stream, a);
  }
  if (record) return launch_cluster(fused_pcn_warm_cluster_kernel<true>, geo, stream, a);
  return launch_cluster(fused_pcn_warm_cluster_kernel<false>, geo, stream, a);
}

// --- one chain a warp: K6 and K7 on the 16 x 16 grid -------------------------

// The design: kWarps chains a CTA at most, one a warp; the launch bound's
// warps an SM (kSmWarps: 32 caps a thread at 65536 / 1024 = 64 registers,
// 24 at 80, 16 at 128).
struct PcnWarpDesign { static constexpr int kWarps = 16, kSmWarps = 16; };
constexpr int kPcnWarpMinCtas = PcnWarpDesign::kSmWarps >= 2 * PcnWarpDesign::kWarps
                                    ? PcnWarpDesign::kSmWarps / PcnWarpDesign::kWarps
                                    : 1;
constexpr int kPcnD = WarpSliceLevel::kK;
// a warp's floats: pos, prop, then the slices p, th, tv
constexpr int kPcnWarpFloats = 2 * kPcnD + 3 * WarpSliceLevel::kStride;

// K6 / K7 on a warp: the lane holds coordinates l and l + 32 of pos and
// prop and (warm) its eight cells of the accepted CG solution in x.
template <int PRECOND>
struct PcnWarpStep {
  static constexpr bool kWarm = PRECOND == kPrecondDstTrunc;
  static constexpr int kC = WarpSliceLevel::kC;
  using Level = std::conditional_t<kWarm, WarpTruncSliceLevel, WarpSliceLevel>;
  // the CTA's staged bytes before the warps: the basis, (warm) what the
  // level stages (the products' exchange, V)
  __host__ __device__ static size_t staged_bytes(int modes) {
    return WarpSliceLevel::staged_bytes() + (kWarm ? WarpTruncSliceLevel::staged_bytes(modes) : 0);
  }

  const PcnArgs<DarcyPotential>& a;
  Level lv;
  float* pos;
  float* prop;
  float phi;
  float x[kC];

  __device__ void init(const WarpChainCtx& c) {
    phi = c.live ? a.phi0[c.c] : 0.0f;
    if constexpr (kWarm) {
#pragma unroll
      for (int k = 0; k < kC; ++k)
        x[k] = c.live ? a.x0[static_cast<size_t>(Level::cell(k)) * a.chain.n + c.c] : 0.0f;
    }
  }

  __device__ bool step(const WarpChainCtx& c, uint32_t i) {
    const int l = threadIdx.x & 31;
    float z[2];
    c.normal2(i, 0u, z);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float xi = c.scale[h] * z[h];
      prop[l + 32 * h] = c.mean[h] + a.contraction * (pos[l + 32 * h] - c.mean[h]) + a.beta * xi;
    }
    __syncwarp();
    float x_prop[kC];
    float phi_prop;
    if constexpr (kWarm) {
#pragma unroll
      for (int k = 0; k < kC; ++k) x_prop[k] = x[k];
      phi_prop = lv.phi_warm(prop, x_prop);
    } else {
      phi_prop = lv.phi(prop);
    }
    const bool accept = logf(c.uniform(i, 2u)) < phi - phi_prop;
    if (accept) {
      phi = phi_prop;
      if constexpr (kWarm) {
#pragma unroll
        for (int k = 0; k < kC; ++k) x[k] = x_prop[k];
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) pos[l + 32 * h] = prop[l + 32 * h];
    }
    return accept;
  }
};

template <bool RECORD, int PRECOND>
__global__ void __launch_bounds__(32 * PcnWarpDesign::kWarps, kPcnWarpMinCtas)
    fused_pcn_warp_kernel(const __grid_constant__ PcnArgs<DarcyPotential> a) {
  using Step = PcnWarpStep<PRECOND>;
  static_assert(PcnWarpDesign::kWarps <= WarpTruncSliceLevel::kRows, "the exchange's rows");
  constexpr int kStride = WarpSliceLevel::kStride;
  extern __shared__ float4 pcn_warp_smem[];
  unsigned char* const base = reinterpret_cast<unsigned char*>(pcn_warp_smem);
  const int modes = a.pot.modes;
  float* w = reinterpret_cast<float*>(base + Step::staged_bytes(modes)) +
             (threadIdx.x >> 5) * kPcnWarpFloats;
  float* slice = w + 2 * kPcnD;  // p, th, tv
  const WarpSmem ws{slice, slice + kStride, slice + 2 * kStride};
  const WarpSliceLevel lv0{&a.pot, WarpSliceLevel::stage(a.pot, reinterpret_cast<float*>(base)),
                           ws};
  typename Step::Level lv;
  if constexpr (Step::kWarm)
    lv = WarpTruncSliceLevel::make(lv0, base + WarpSliceLevel::staged_bytes());
  else
    lv = lv0;
  __syncthreads();  // the staged factors
  Step step{a, lv, w, w + kPcnD, 0.0f, {}};
  run_warp_chain<RECORD>(a.chain, step, w);
}

// What a launch takes: warps (chains) a CTA, CTAs, dynamic shared memory.
struct PcnWarpGeometry {
  int warps, ctas;
  size_t smem;
};

// Whether fused_pcn_warp_kernel takes this spec and d: a 16 x 16 CG misfit
// with d = K = 64, Jacobi (cold) or dst_trunc with a multiple of kModeTile
// modes up to kMaxModes (warm). Mirrored by ip_mcmc_tpu_torch/ops/fused_pcn.py
// warp_takes.
inline bool pcn_warp_takes(const IpxMisfitSpec& s, int d, bool warm) {
  if (s.n != WarpSliceLevel::kN || s.K != kPcnD || d != kPcnD || s.solver != kSolverCg ||
      s.m < 0)
    return false;
  if (warm)
    return s.precond == kPrecondDstTrunc && s.modes > 0 &&
           s.modes % WarpTruncSliceLevel::kModeTile == 0 &&
           s.modes <= WarpTruncSliceLevel::kMaxModes;
  return s.precond == kPrecondJacobi && s.modes == 0;
}

// Whether a cluster kernel takes a warm spec for chains of d coordinates
// (cluster_geometry with no surrogate): 64 x 64 or 32 x 32, dst_trunc CG.
inline bool pcn_cluster_takes(const IpxMisfitSpec& s, int d) {
  return s.n == kCluster32N
             ? cluster_level_ok(s, kCluster32N, d, kCluster32MaxModes, kCluster32MaxK)
             : cluster_level_ok(s, kClusterExactN, d, kClusterMaxModes);
}

// The kernel a spec goes to. Cold: the warp kernel for what it takes,
// fused_pcn_kernel in the layout of its grid for every other (which
// refuses a grid above 64 x 64). Warm: the warp kernel or a cluster kernel
// for what they take, fused_pcn_warm_kernel in the layout of its grid for
// any other CG spec up to 64 x 64 with K = d, none above. Mirrored by
// ip_mcmc_tpu_torch/ops/fused_pcn.py route.
inline int pcn_route(const IpxMisfitSpec& s, int d, bool warm) {
  if (pcn_warp_takes(s, d, warm)) return kRouteWarp;
  if (!warm) return kRouteCta;
  if (pcn_cluster_takes(s, d)) return kRouteCluster;
  const int cells = s.n * s.n;
  if (darcy_cta_spec(s, d, DarcyPot<Layout64>::kMaxCells, darcy_layout_threads(cells)))
    return kRouteCta;
  return kRouteRefused;
}

// Mirrored by ip_mcmc_tpu_torch/ops/fused_pcn.py warp_geometry: what
// pcn_warp_takes refuses, cudaErrorNotSupported. W: the largest power of
// two up to kWarps that divides block_chains; a ragged last CTA runs spare
// warps.
inline int pcn_warp_geometry(const IpxMisfitSpec& s, const IpxChainArgs& chain, bool warm,
                             PcnWarpGeometry* geo) {
  if (!pcn_warp_takes(s, chain.d, warm)) return cudaErrorNotSupported;
  if (chain.block_chains <= 0 || chain.n < 0 || chain.n_steps < 0 ||
      (chain.samples != nullptr && chain.thin <= 0))
    return cudaErrorInvalidValue;
  int w = PcnWarpDesign::kWarps;
  while (chain.block_chains % w) w /= 2;
  geo->warps = w;
  geo->ctas = (chain.n + w - 1) / w;
  geo->smem = (warm ? PcnWarpStep<kPrecondDstTrunc>::staged_bytes(s.modes)
                     : PcnWarpStep<kPrecondJacobi>::staged_bytes(0)) +
              sizeof(float) * kPcnWarpFloats * w;
  return geo->smem <= 232448 ? cudaSuccess : cudaErrorInvalidValue;
}

template <bool RECORD, int PRECOND>
int launch_pcn_warp(const PcnArgs<DarcyPotential>& a, const PcnWarpGeometry& geo,
                    cudaStream_t st) {
  const int smem = static_cast<int>(geo.smem);
  cudaFuncSetAttribute(fused_pcn_warp_kernel<RECORD, PRECOND>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  fused_pcn_warp_kernel<RECORD, PRECOND><<<geo.ctas, 32 * geo.warps, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Launches fused_pcn_warp_kernel<RECORD, kPrecondJacobi> (x0 null) or
// <RECORD, kPrecondDstTrunc> (RECORD: chain.samples given).
inline int launch_pcn_warps(const IpxMisfitSpec& pot, const IpxChainArgs& chain,
                            const float* phi0, const float* x0, float beta, float contraction,
                            void* stream) {
  const bool warm = x0 != nullptr;
  PcnWarpGeometry geo;
  const int status = pcn_warp_geometry(pot, chain, warm, &geo);
  if (status != cudaSuccess) return status;
  if (chain.n == 0) return cudaSuccess;
  const PcnArgs<DarcyPotential> a{pot, chain, phi0, x0, beta, contraction};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool record = chain.samples != nullptr;
  if (!warm)
    return record ? launch_pcn_warp<true, kPrecondJacobi>(a, geo, st)
                  : launch_pcn_warp<false, kPrecondJacobi>(a, geo, st);
  return record ? launch_pcn_warp<true, kPrecondDstTrunc>(a, geo, st)
                : launch_pcn_warp<false, kPrecondDstTrunc>(a, geo, st);
}

// --- the standalone 16 x 16 warm misfit: one draw a warp ----------------------
//
// (Phi, x) for a (K, B) batch of the warm 16 x 16 dst_trunc CG misfit from
// the starts x0 (darcy_pcn_warm's start positions: dst_trunc-64 / 4 CG from
// x0 = 0, 4096 draws): one draw a warp on K7's own warm level,
// WarpTruncSliceLevel::phi_warm (darcy_misfit.cuh: WarpSliceLevel's set-up,
// stencil and dot products in block_sum's order, the start in eight
// registers a lane, the dst_trunc products over the CTA's draws by
// mma.sync), so that (Phi, x) are, bit for bit, the warm solve that
// fused_pcn_warp_kernel<., kPrecondDstTrunc> makes of the same u from the
// same start. One draw a CTA of Layout16 (darcy_misfit_warm_kernel, 0.374
// ms of device time at 4096 draws on an H100 80GB HBM3, 700 W; PERF.md)
// summed every dot product over its 256 threads behind CTA barriers. The
// basis, the exchange and V are staged once a CTA; each warp's slice holds
// its draw's u and the solve's p, th, tv. x0 comes in and x goes out through
// the th slices, W consecutive columns of a row at a time, behind a CTA
// barrier at each end. The products meet behind three CTA barriers an
// apply, so every warp of a ragged last CTA runs the whole solve: a spare
// warp solves u = 0 from x = 0 and writes nothing. A draw's column of the
// products depends on that draw alone, so a ragged launch gives the draws'
// bits of a full one.

// The design (scripts/measure_misfit_warm16_surr8_design.py times the
// alternatives): kWarps draws a CTA, one a warp, at most the exchange's
// rows; the launch bound's warps an SM (kSmWarps).
struct MisfitWarmWarpDesign { static constexpr int kWarps = 16, kSmWarps = 16; };
static_assert(MisfitWarmWarpDesign::kWarps <= WarpTruncSliceLevel::kRows, "the exchange's rows");
constexpr int kMisfitWarmWarpMinCtas =
    MisfitWarmWarpDesign::kSmWarps >= 2 * MisfitWarmWarpDesign::kWarps
        ? MisfitWarmWarpDesign::kSmWarps / MisfitWarmWarpDesign::kWarps
        : 1;
// a warp's floats: the draw's u, the slices p, th, tv
constexpr int kMisfitWarmWarpFloats = kPcnD + 3 * WarpSliceLevel::kStride;

// Dynamic shared memory of a launch on a misfit of `modes` modes: the
// basis, the exchange and V staged, a slice a warp (225,856 bytes at
// kMaxModes: less than K7's CTA, whose slices hold two positions).
inline size_t misfit_warm_warp_smem(int modes) {
  return WarpSliceLevel::staged_bytes() + WarpTruncSliceLevel::staged_bytes(modes) +
         sizeof(float) * kMisfitWarmWarpFloats * MisfitWarmWarpDesign::kWarps;
}

// Whether darcy_misfit_warm_warp_kernel takes this spec
// (ipx_darcy_misfit_warm sends it there): the warm branch of pcn_warp_takes
// (16 x 16, K = 64, CG, dst_trunc with a multiple of kModeTile modes up to
// kMaxModes). Mirrored by ip_mcmc_tpu_torch/ops/fused_pcn.py
// misfit_warm_warp_takes.
inline bool misfit_warm_warp_takes(const IpxMisfitSpec& s) {
  return pcn_warp_takes(s, kPcnD, true);
}

// Mirrored by ip_mcmc_tpu_torch/ops/fused_pcn.py misfit_warm_warp_geometry:
// kWarps draws a CTA, the spare warps of a ragged last CTA solving on
// zeros; what misfit_warm_warp_takes refuses, cudaErrorNotSupported.
inline int misfit_warm_warp_geometry(const IpxMisfitSpec& s, int B, PcnWarpGeometry* geo) {
  if (!misfit_warm_warp_takes(s)) return cudaErrorNotSupported;
  if (B < 0) return cudaErrorInvalidValue;
  geo->warps = MisfitWarmWarpDesign::kWarps;
  geo->ctas = (B + geo->warps - 1) / geo->warps;
  geo->smem = misfit_warm_warp_smem(s.modes);
  return cudaSuccess;
}

__global__ void __launch_bounds__(32 * MisfitWarmWarpDesign::kWarps, kMisfitWarmWarpMinCtas)
    darcy_misfit_warm_warp_kernel(const __grid_constant__ MisfitBatch a) {
  constexpr int kStride = WarpSliceLevel::kStride, kCells = WarpSliceLevel::kCells;
  constexpr int kC = WarpSliceLevel::kC;
  extern __shared__ float4 misfit_warm_warp_smem_buf[];
  unsigned char* const base = reinterpret_cast<unsigned char*>(misfit_warm_warp_smem_buf);
  const float* basis = WarpSliceLevel::stage(a.s, reinterpret_cast<float*>(base));
  unsigned char* const staged = base + WarpSliceLevel::staged_bytes();
  float* slices =
      reinterpret_cast<float*>(staged + WarpTruncSliceLevel::staged_bytes(a.s.modes));
  // the CTA's draws' coefficients and starts, W consecutive columns of U and
  // x0 a row (x0 to the slice th, free before the solve); zeros for the
  // spare warps
  const int W = blockDim.x >> 5, b0 = blockIdx.x * W, B = a.B;
  for (int e = threadIdx.x; e < kPcnD * W; e += blockDim.x) {
    const int k = e / W, j = e % W;
    slices[j * kMisfitWarmWarpFloats + k] =
        b0 + j < B ? a.U[static_cast<size_t>(k) * B + b0 + j] : 0.0f;
  }
  for (int e = threadIdx.x; e < kCells * W; e += blockDim.x) {
    const int r = e / W, j = e % W;
    slices[j * kMisfitWarmWarpFloats + kPcnD + kStride + WarpSliceLevel::pad(r)] =
        b0 + j < B ? a.x0[static_cast<size_t>(r) * B + b0 + j] : 0.0f;
  }
  float* u = slices + (threadIdx.x >> 5) * kMisfitWarmWarpFloats;
  float* slice = u + kPcnD;  // p, th, tv
  const WarpSmem ws{slice, slice + kStride, slice + 2 * kStride};
  WarpTruncSliceLevel lv = WarpTruncSliceLevel::make(WarpSliceLevel{&a.s, basis, ws}, staged);
  __syncthreads();  // the staged factors, every warp's u and x0
  float x[kC];
#pragma unroll
  for (int k = 0; k < kC; ++k) x[k] = ws.th[WarpSliceLevel::at(k)];
  __syncwarp();  // the reads end before the set-up writes th
  const float v = lv.phi_warm(u, x);  // every warp: the products' CTA barriers
#pragma unroll
  for (int k = 0; k < kC; ++k) ws.th[WarpSliceLevel::at(k)] = x[k];
  const int b = b0 + (threadIdx.x >> 5);
  if ((threadIdx.x & 31) == 0 && b < B) a.phi[b] = v;
  __syncthreads();  // every warp's solution
  for (int e = threadIdx.x; e < kCells * W; e += blockDim.x) {
    const int r = e / W, j = e % W;
    if (b0 + j < B)
      a.x[static_cast<size_t>(r) * B + b0 + j] =
          slices[j * kMisfitWarmWarpFloats + kPcnD + kStride + WarpSliceLevel::pad(r)];
  }
}

// Launches darcy_misfit_warm_warp_kernel on the batch: the status of the
// geometry or of the launch.
inline int launch_misfit_warm_warp(const MisfitBatch& a, void* stream) {
  PcnWarpGeometry geo;
  const int status = misfit_warm_warp_geometry(a.s, a.B, &geo);
  if (status != cudaSuccess) return status;
  if (a.B == 0) return cudaSuccess;
  const int smem = static_cast<int>(geo.smem);
  cudaFuncSetAttribute(darcy_misfit_warm_warp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  darcy_misfit_warm_warp_kernel<<<geo.ctas, 32 * geo.warps, smem,
                                  static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// --- the standalone 16 x 16 dense-dst warm misfit: one draw a warp -----------
//
// (Phi, x) for a (K, B) batch of the warm 16 x 16 dense-dst CG misfit from
// the starts x0 (darcy_smc_warm's mutation: dst / 6 CG at 4096 particles, 8
// sweeps from x0 = 0, then 5 a stage, each from the particle's carried
// solution): one draw a warp on warm MALA's level, WarpDstSliceLevel
// (darcy_misfit.cuh: WarpSliceLevel's set-up, stencil and dot products in
// block_sum's order, the dense dst's four stages on the warp from bf16
// operands, rounded where apply_dst rounds), through
// darcy_phi_warm_warp: the forward half of
// darcy_misfit_grad_warm_warp_kernel (fused_mala.cu), which keeps the bits
// of the one-draw-a-CTA kernels. One draw a CTA of Layout16
// (darcy_misfit_warm_kernel: 0.300 ms a call at 4096 draws on an H100 80GB
// HBM3, 700 W; PERF.md) sums every dot product over its 256 threads behind
// CTA barriers, with no other work for the SM to overlap. What bounds a draw
// here is the latency of its solve's dependent chain (12 stencil applies,
// 7 dense dst applies of four 16-term stages, 20 sums a CG iteration), not
// the bytes (the 64 + 256 floats in, 1 + 256 out) or the operations. So: a
// draw a warp, none waiting on another, 16 a CTA. The KL basis, S, S^T and
// the dst eigenvalues are staged once a CTA; each warp's slice holds its
// draw's u and the solve's p, th, tv and the dst stage buffer. x0 comes in
// and x goes out through the th slices, W consecutive columns of a row at a
// time, behind a CTA barrier at each end; the spare warps of a ragged last
// CTA solve nothing.

// The design (scripts/measure_misfit_warm_dst_design.py times the
// alternatives): kWarps draws a CTA, one a warp; the launch bound's warps
// an SM (kSmWarps).
struct MisfitWarmDstWarpDesign { static constexpr int kWarps = 16, kSmWarps = 16; };
constexpr int kMisfitWarmDstWarpMinCtas =
    MisfitWarmDstWarpDesign::kSmWarps >= 2 * MisfitWarmDstWarpDesign::kWarps
        ? MisfitWarmDstWarpDesign::kSmWarps / MisfitWarmDstWarpDesign::kWarps
        : 1;
// a warp's floats: the draw's u, the slices p, th, tv, the dst stage buffer
constexpr int kMisfitWarmDstWarpFloats = kPcnD + 4 * WarpSliceLevel::kStride;
// Dynamic shared memory of a launch: the staged basis, S, S^T and lam, a
// slice a warp.
constexpr size_t kMisfitWarmDstWarpSmem =
    WarpSliceLevel::staged_bytes() + WarpDstSliceLevel::staged_dst_bytes() +
    sizeof(float) * kMisfitWarmDstWarpFloats * MisfitWarmDstWarpDesign::kWarps;
static_assert(kMisfitWarmDstWarpSmem <= 232448,
              "the design's CTA exceeds the card's shared memory");

// Whether darcy_misfit_warm_dst_warp_kernel takes this spec
// (ipx_darcy_misfit_warm sends it there): WarpDstSliceLevel's, i.e. 16 x
// 16, K = 64, dense dst with no modes, CG, any cg_iters. Mirrored by
// ip_mcmc_tpu_torch/ops/fused_pcn.py misfit_warm_dst_warp_takes.
inline bool misfit_warm_dst_warp_takes(const IpxMisfitSpec& s) {
  return s.n == WarpSliceLevel::kN && s.K == kPcnD && s.precond == kPrecondDst &&
         s.modes == 0 && s.solver == kSolverCg && s.m >= 0;
}

// Mirrored by ip_mcmc_tpu_torch/ops/fused_pcn.py
// misfit_warm_dst_warp_geometry: kWarps draws a CTA; what
// misfit_warm_dst_warp_takes refuses, cudaErrorNotSupported.
inline int misfit_warm_dst_warp_geometry(const IpxMisfitSpec& s, int B, PcnWarpGeometry* geo) {
  if (!misfit_warm_dst_warp_takes(s)) return cudaErrorNotSupported;
  if (B < 0) return cudaErrorInvalidValue;
  geo->warps = MisfitWarmDstWarpDesign::kWarps;
  geo->ctas = (B + geo->warps - 1) / geo->warps;
  geo->smem = kMisfitWarmDstWarpSmem;
  return cudaSuccess;
}

__global__ void __launch_bounds__(32 * MisfitWarmDstWarpDesign::kWarps,
                                  kMisfitWarmDstWarpMinCtas)
    darcy_misfit_warm_dst_warp_kernel(const __grid_constant__ MisfitBatch a) {
  constexpr int kStride = WarpSliceLevel::kStride, kCells = WarpSliceLevel::kCells;
  constexpr int kC = WarpSliceLevel::kC;
  extern __shared__ float4 misfit_warm_dst_warp_smem_buf[];
  unsigned char* const base = reinterpret_cast<unsigned char*>(misfit_warm_dst_warp_smem_buf);
  const float* basis = WarpSliceLevel::stage(a.s, reinterpret_cast<float*>(base));
  unsigned char* const dst = base + WarpSliceLevel::staged_bytes();
  WarpDstSliceLevel::stage_dst(a.s, dst);
  float* slices = reinterpret_cast<float*>(dst + WarpDstSliceLevel::staged_dst_bytes());
  // the CTA's draws' coefficients and starts, W consecutive columns of U and
  // x0 a row (x0 to the slice th, free before the solve)
  const int W = blockDim.x >> 5, b0 = blockIdx.x * W, B = a.B;
  for (int e = threadIdx.x; e < kPcnD * W; e += blockDim.x) {
    const int k = e / W, j = e % W;
    if (b0 + j < B)
      slices[j * kMisfitWarmDstWarpFloats + k] = a.U[static_cast<size_t>(k) * B + b0 + j];
  }
  for (int e = threadIdx.x; e < kCells * W; e += blockDim.x) {
    const int r = e / W, j = e % W;
    if (b0 + j < B)
      slices[j * kMisfitWarmDstWarpFloats + kPcnD + kStride + WarpSliceLevel::pad(r)] =
          a.x0[static_cast<size_t>(r) * B + b0 + j];
  }
  __syncthreads();  // the staged factors, every warp's u and x0
  const int b = b0 + (threadIdx.x >> 5);
  float* u = slices + (threadIdx.x >> 5) * kMisfitWarmDstWarpFloats;
  float* slice = u + kPcnD;  // p, th, tv, q
  if (b < B) {  // a spare warp solves nothing
    const WarpSmem ws{slice, slice + kStride, slice + 2 * kStride};
    const __nv_bfloat16* S = WarpDstSliceLevel::staged_S(dst);
    WarpDstSliceLevel lv{WarpSliceLevel{&a.s, basis, ws},
                         S,
                         S + WarpSliceLevel::kN * WarpDstSliceLevel::kRow,
                         WarpDstSliceLevel::staged_lam(dst),
                         reinterpret_cast<__nv_bfloat16*>(slice + 3 * kStride),
                         1.0f};
    float x[kC];
#pragma unroll
    for (int k = 0; k < kC; ++k) x[k] = ws.th[WarpSliceLevel::at(k)];
    __syncwarp();  // the reads end before the set-up writes th
    const float v = darcy_phi_warm_warp(lv, u, x);
#pragma unroll
    for (int k = 0; k < kC; ++k) ws.th[WarpSliceLevel::at(k)] = x[k];
    if ((threadIdx.x & 31) == 0) a.phi[b] = v;
  }
  __syncthreads();  // every warp's solution
  for (int e = threadIdx.x; e < kCells * W; e += blockDim.x) {
    const int r = e / W, j = e % W;
    if (b0 + j < B)
      a.x[static_cast<size_t>(r) * B + b0 + j] =
          slices[j * kMisfitWarmDstWarpFloats + kPcnD + kStride + WarpSliceLevel::pad(r)];
  }
}

// Launches darcy_misfit_warm_dst_warp_kernel on the batch: the status of the
// geometry or of the launch.
inline int launch_misfit_warm_dst_warp(const MisfitBatch& a, void* stream) {
  PcnWarpGeometry geo;
  const int status = misfit_warm_dst_warp_geometry(a.s, a.B, &geo);
  if (status != cudaSuccess) return status;
  if (a.B == 0) return cudaSuccess;
  const int smem = static_cast<int>(geo.smem);
  cudaFuncSetAttribute(darcy_misfit_warm_dst_warp_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  darcy_misfit_warm_dst_warp_kernel<<<geo.ctas, 32 * geo.warps, smem,
                                      static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// --- one chain a warp: K6 on Burgers -----------------------------------------
//
// burgers_pcn and burgers_multitime_pcn (128 cells; 154 Godunov steps a pCN step, one segment or
// three). One chain a CTA of 128 threads, one thread a cell (0.0558 ms a step at 2048 chains on an
// H100 80GB HBM3, PERF.md), paid a block barrier a Godunov step. So every spec that
// burgers_warp_takes runs a chain a warp on run_warp_chain<RECORD, 16>, as the three-level DA
// kernel does: lanes 0..15 hold the coordinates of pos and prop in the warp's shared memory, the
// level's basis and mean are staged once a CTA, and Phi comes from burgers_phi_warp in the
// one-chain-a-CTA kernel's block_sum order (its CTA had as many threads as the level has cells), so
// the chains keep that kernel's bits. The design is the line PcnBurgersWarpDesign
// (scripts/measure_burgers_warp_design.py times the alternatives, PERF.md the numbers).

// The design: kWarps chains a CTA at most, one a warp; the launch bound's
// warps an SM (kSmWarps: 32 caps a thread at 64 registers, which the solve
// fits without a spill, 16 at 128; 2048 chains on 132 SMs are 16 warps an
// SM at most).
struct PcnBurgersWarpDesign { static constexpr int kWarps = 16, kSmWarps = 32; };
constexpr int kPcnBurgersWarpMinCtas =
    PcnBurgersWarpDesign::kSmWarps >= 2 * PcnBurgersWarpDesign::kWarps
        ? PcnBurgersWarpDesign::kSmWarps / PcnBurgersWarpDesign::kWarps
        : 1;
constexpr int kPcnBurgersD = kBurgersWarpK;  // coordinates, one a lane of lanes 0..15
// a warp's slice: pos, prop (kPcnBurgersD each), then the gather buffer;
// before the slices, the level's staged basis and mean
constexpr int kPcnBurgersWarpFloats = 2 * kPcnBurgersD + kBurgersWarpCells;

// K6 on a warp: prop = m + sqrt(1 - beta^2) (pos - m) + beta scale xi
// (normals tags 0, 1), accepted when log u < Phi(pos) - Phi(prop) (tag 2),
// so a NaN Phi(prop) rejects. Lane t < 16 holds coordinate t of pos and
// prop.
struct PcnBurgersWarpStep {
  using Ctx = WarpChainCtxT<kPcnBurgersD>;
  const PcnArgs<BurgersPotential>& a;
  BurgersWarpLevel lv;
  float* pos;
  float* prop;
  float phi;

  __device__ void init(const Ctx& x) { phi = x.live ? a.phi0[x.c] : 0.0f; }

  __device__ bool step(const Ctx& x, uint32_t i) {
    const int t = threadIdx.x & 31;
    const bool own = Ctx::holds(0);
    if (own) {
      const float xi = x.scale[0] * x.normal1(i, 0u);
      prop[t] = x.mean[0] + a.contraction * (pos[t] - x.mean[0]) + a.beta * xi;
    }
    __syncwarp();
    // the one-chain-a-CTA kernel's CTA: a thread a cell
    const float phi_prop = a.pot.n_cells == 64 ? burgers_phi_warp<2, 64>(lv, prop)
                                               : burgers_phi_warp<4, 128>(lv, prop);
    const bool accept = logf(x.uniform(i, 2u)) < phi - phi_prop;  // the same in every lane
    if (accept) {
      phi = phi_prop;
      if (own) pos[t] = prop[t];
    }
    return accept;
  }
};

template <bool RECORD>
__global__ void __launch_bounds__(32 * PcnBurgersWarpDesign::kWarps, kPcnBurgersWarpMinCtas)
    fused_pcn_burgers_warp_kernel(const __grid_constant__ PcnArgs<BurgersPotential> a) {
  extern __shared__ float4 pcn_burgers_warp_smem[];
  BurgersWarpLevel lv{&a.pot};
  float* w = lv.stage(reinterpret_cast<float*>(pcn_burgers_warp_smem)) +
             (threadIdx.x >> 5) * kPcnBurgersWarpFloats;
  lv.state = w + 2 * kPcnBurgersD;
  __syncthreads();  // the staged level
  PcnBurgersWarpStep step{a, lv, w, w + kPcnBurgersD, 0.0f};
  run_warp_chain<RECORD, kPcnBurgersD>(a.chain, step, w);
}

// Mirrored by ip_mcmc_tpu_torch/ops/fused_pcn.py burgers_warp_geometry:
// what burgers_warp_takes refuses, cudaErrorNotSupported (the entry point
// sends it to fused_pcn_kernel<BurgersPotential, ·>). W: the largest power
// of two up to kWarps that divides block_chains; a ragged last CTA runs
// spare warps.
inline int pcn_burgers_warp_geometry(const IpxBurgersSpec& s, const IpxChainArgs& chain,
                                     PcnWarpGeometry* geo) {
  if (!burgers_warp_takes(s, chain.d)) return cudaErrorNotSupported;
  if (chain.block_chains <= 0 || chain.n < 0 || chain.n_steps < 0 ||
      (chain.samples != nullptr && chain.thin <= 0))
    return cudaErrorInvalidValue;
  int w = PcnBurgersWarpDesign::kWarps;
  while (chain.block_chains % w) w /= 2;
  geo->warps = w;
  geo->ctas = (chain.n + w - 1) / w;
  geo->smem = sizeof(float) * (BurgersWarpLevel::staged_floats(s.n_cells) +
                               kPcnBurgersWarpFloats * w);
  return geo->smem <= 232448 ? cudaSuccess : cudaErrorInvalidValue;
}

// Launches fused_pcn_burgers_warp_kernel<RECORD> (RECORD: chain.samples
// given).
inline int launch_pcn_burgers_warp(const IpxBurgersSpec& pot, const IpxChainArgs& chain,
                                   const float* phi0, float beta, float contraction,
                                   void* stream) {
  PcnWarpGeometry geo;
  const int status = pcn_burgers_warp_geometry(pot, chain, &geo);
  if (status != cudaSuccess) return status;
  if (chain.n == 0) return cudaSuccess;
  const PcnArgs<BurgersPotential> a{pot, chain, phi0, nullptr, beta, contraction};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = 32 * geo.warps, smem = static_cast<int>(geo.smem);
  if (chain.samples != nullptr) {
    cudaFuncSetAttribute(fused_pcn_burgers_warp_kernel<true>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    fused_pcn_burgers_warp_kernel<true><<<geo.ctas, threads, smem, st>>>(a);
  } else {
    cudaFuncSetAttribute(fused_pcn_burgers_warp_kernel<false>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    fused_pcn_burgers_warp_kernel<false><<<geo.ctas, threads, smem, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launches fused_pcn_kernel<Pot, RECORD> or, with x0 given (Darcy),
// fused_pcn_warm_kernel<Pot, RECORD> (RECORD: chain.samples given).
template <class Pot>
int launch_pcn(const typename Pot::Spec& pot, const IpxChainArgs& chain, const float* phi0,
               const float* x0, float beta, float contraction, void* stream) {
  const typename Pot::Extent extent = Pot::extent(pot);
  const int threads =
      chain_threads(chain, extent.cells, pot.K, Pot::kMaxThreads, Pot::kCellsPerThread);
  if (threads == 0 || !Pot::valid(pot)) return cudaErrorInvalidValue;
  if (chain.n == 0) return cudaSuccess;
  const PcnArgs<Pot> a{pot, chain, phi0, x0, beta, contraction};
  const size_t smem = sizeof(float) * (2 * chain.d + Pot::workspace_floats(extent));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool record = chain.samples != nullptr;
  if (x0 == nullptr) {
    if (record) fused_pcn_kernel<Pot, true><<<chain.n, threads, smem, st>>>(a);
    else fused_pcn_kernel<Pot, false><<<chain.n, threads, smem, st>>>(a);
  } else if constexpr (std::is_same_v<typename Pot::Spec, IpxMisfitSpec>) {
    if (record) fused_pcn_warm_kernel<Pot, true><<<chain.n, threads, smem, st>>>(a);
    else fused_pcn_warm_kernel<Pot, false><<<chain.n, threads, smem, st>>>(a);
  } else {
    return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}

// Launches darcy_misfit_warm_kernel<Pot> (or its bounded form).
template <class Pot>
int launch_misfit_warm(const IpxMisfitSpec& s, const float* U, const float* x0, int B,
                       float* phi, float* x, void* stream) {
  const int cells = s.n * s.n;
  const int threads = round_up32((cells + Pot::kCellsPerThread - 1) / Pot::kCellsPerThread);
  if (threads > Pot::kMaxThreads || !Pot::valid(s) || B < 0) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  const size_t smem = sizeof(float) * (s.K + misfit_smem_floats(cells, s.modes));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if constexpr (Pot::kMaxThreads <= 256)
    darcy_misfit_warm_kernel<Pot><<<B, threads, smem, st>>>(s, U, x0, B, phi, x);
  else
    darcy_misfit_warm_wide_kernel<Pot><<<B, threads, smem, st>>>(s, U, x0, B, phi, x);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ipx

extern "C" {

// The one-draw-a-CTA kernel of the spec's layout (darcy_misfit_warm_kernel up
// to 16 x 16), whatever the rules above say: the kernel a spec no rule takes
// runs on, and the reference that the kernels a draw a warp are held to.
int ipx_darcy_misfit_warm_layout(const IpxMisfitSpec* s, const float* U, const float* x0, int B,
                                 float* phi, float* x, void* stream) {
  return ipx::with_darcy_layout<kSolverCg>(*s, [&](auto pot) {
    return ipx::launch_misfit_warm<decltype(pot)>(*s, U, x0, B, phi, x, stream);
  });
}

// A spec of the 16 x 16 warm pCN (misfit_warm_warp_takes) goes to
// darcy_misfit_warm_warp_kernel; a 16 x 16 dense-dst one
// (misfit_warm_dst_warp_takes) to darcy_misfit_warm_dst_warp_kernel; one of
// a cluster sampler's level that a warm sampler solves on
// (misfit_cluster_warm_takes) to darcy_misfit_warm_cluster_kernel (64 x 64)
// or darcy_misfit_warm_cluster32_kernel (32 x 32); for every other, a spec of
// the 64 x 64 DA kernel's surrogate level among them, the layout follows the
// spec's grid (ipx_darcy_misfit_warm_layout).
int ipx_darcy_misfit_warm(const IpxMisfitSpec* s, const float* U, const float* x0, int B,
                          float* phi, float* x, void* stream) {
  if (ipx::misfit_warm_warp_takes(*s))
    return ipx::launch_misfit_warm_warp({*s, U, x0, B, phi, x}, stream);
  if (ipx::misfit_warm_dst_warp_takes(*s))
    return ipx::launch_misfit_warm_dst_warp({*s, U, x0, B, phi, x}, stream);
  if (ipx::misfit_cluster_warm_takes(*s))
    return ipx::launch_misfit_cluster(ipx::darcy_misfit_warm_cluster_kernel,
                                      ipx::darcy_misfit_warm_cluster32_kernel, nullptr,
                                      {*s, U, x0, B, phi, x}, stream);
  return ipx_darcy_misfit_warm_layout(s, U, x0, B, phi, x, stream);
}

// x0 == null: cold pCN, else warm. pcn_route picks the kernel: what
// fused_pcn_warp_kernel takes (pcn_warp_takes: 16 x 16, d = K = 64, Jacobi
// cold or dst_trunc warm) goes to it; a warm spec of the cluster kernels
// (pcn_cluster_takes: 32 x 32 and 64 x 64 with a dst_trunc CG solve) to
// them; the rest to fused_pcn_kernel or fused_pcn_warm_kernel, whose layout
// follows the spec's grid; a warm spec above 64 x 64 is refused with
// cudaErrorNotSupported.
int ipx_fused_pcn(const IpxMisfitSpec* pot, const IpxChainArgs* chain, const float* phi0,
                  const float* x0, float beta, float contraction, void* stream) {
  switch (ipx::pcn_route(*pot, chain->d, x0 != nullptr)) {
    case ipx::kRouteWarp:
      return ipx::launch_pcn_warps(*pot, *chain, phi0, x0, beta, contraction, stream);
    case ipx::kRouteCluster:
      return ipx::launch_pcn_warm_cluster(*pot, *chain, phi0, x0, beta, contraction, stream);
    case ipx::kRouteCta:
      return ipx::with_darcy_layout<kSolverCg>(*pot, [&](auto p) {
        return ipx::launch_pcn<decltype(p)>(*pot, *chain, phi0, x0, beta, contraction, stream);
      });
    default:
      return cudaErrorNotSupported;
  }
}

// The kernel ipx_fused_pcn sends this spec to, for chains of d coordinates
// and warm (0: cold; ipx::kRoute*; the wrapper's mirror is checked against
// this on the card).
int ipx_pcn_route(const IpxMisfitSpec* pot, int d, int warm) {
  return ipx::pcn_route(*pot, d, warm != 0);
}

// The warp kernel's launch geometry for this spec, these chain arguments
// and warm (0: cold, Jacobi; else warm, dst_trunc): out = {chains a CTA,
// CTAs, dynamic shared-memory bytes}; the status the launch would return
// for them, cudaErrorNotSupported for a spec that goes to another kernel
// (the wrapper's mirror is checked against this on the card).
int ipx_pcn_warp_geometry(const IpxMisfitSpec* pot, const IpxChainArgs* chain, int warm,
                          int* out) {
  ipx::PcnWarpGeometry geo{0, 0, 0};
  const int status = ipx::pcn_warp_geometry(*pot, *chain, warm != 0, &geo);
  out[0] = geo.warps;
  out[1] = geo.ctas;
  out[2] = static_cast<int>(geo.smem);
  return status;
}

// The standalone 16 x 16 warm misfit's launch geometry
// (darcy_misfit_warm_warp_kernel) for this spec and B draws: out = {draws a
// CTA, CTAs, dynamic shared-memory bytes}; the status the launch would
// return for them, cudaErrorNotSupported for a spec that goes to another
// kernel (the wrapper's mirror is checked against this on the card).
int ipx_darcy_misfit_warm_warp_geometry(const IpxMisfitSpec* s, int B, int* out) {
  ipx::PcnWarpGeometry geo{0, 0, 0};
  const int status = ipx::misfit_warm_warp_geometry(*s, B, &geo);
  out[0] = geo.warps;
  out[1] = geo.ctas;
  out[2] = static_cast<int>(geo.smem);
  return status;
}

// The standalone 16 x 16 dense-dst warm misfit's launch geometry
// (darcy_misfit_warm_dst_warp_kernel) for this spec and B draws: out =
// {draws a CTA, CTAs, dynamic shared-memory bytes}; the status the launch
// would return for them, cudaErrorNotSupported for a spec that goes to
// another kernel (the wrapper's mirror is checked against this on the card).
int ipx_darcy_misfit_warm_dst_warp_geometry(const IpxMisfitSpec* s, int B, int* out) {
  ipx::PcnWarpGeometry geo{0, 0, 0};
  const int status = ipx::misfit_warm_dst_warp_geometry(*s, B, &geo);
  out[0] = geo.warps;
  out[1] = geo.ctas;
  out[2] = static_cast<int>(geo.smem);
  return status;
}

// What fused_pcn_burgers_warp_kernel takes (burgers_warp_takes: 64 or 128
// cells, d = K = 16) goes to it, the rest to
// fused_pcn_kernel<BurgersPotential, ·>, one chain a CTA.
int ipx_fused_pcn_burgers(const IpxBurgersSpec* pot, const IpxChainArgs* chain,
                          const float* phi0, float beta, float contraction, void* stream) {
  if (ipx::burgers_warp_takes(*pot, chain->d))
    return ipx::launch_pcn_burgers_warp(*pot, *chain, phi0, beta, contraction, stream);
  return ipx::launch_pcn<ipx::BurgersPotential>(*pot, *chain, phi0, nullptr, beta, contraction,
                                                stream);
}

// A linear-Gaussian spec that linear_cta_takes goes to
// fused_pcn_kernel<LinearGaussianPotential, ·>, one chain a CTA; any other
// is refused (cudaErrorNotSupported).
int ipx_fused_pcn_linear(const IpxGaussianSpec* pot, const IpxChainArgs* chain,
                         const float* phi0, float beta, float contraction, void* stream) {
  if (ipx::linear_route(*pot, chain->d) != ipx::kRouteCta) return cudaErrorNotSupported;
  return ipx::launch_pcn<ipx::LinearGaussianPotential>(*pot, *chain, phi0, nullptr, beta,
                                                       contraction, stream);
}

// The kernel ipx_fused_pcn_linear sends this spec to, for chains of d
// coordinates (ipx::kRoute*; the wrapper's mirror is checked against this
// on the card).
int ipx_pcn_linear_route(const IpxGaussianSpec* pot, int d) { return ipx::linear_route(*pot, d); }

// The Burgers warp kernel's launch geometry for this spec and these chain
// arguments: out = {chains a CTA, CTAs, dynamic shared-memory bytes}; the
// status the launch would return for them, cudaErrorNotSupported for a
// spec that goes to the one-chain-a-CTA kernel (the wrapper's mirror is
// checked against this on the card).
int ipx_pcn_burgers_warp_geometry(const IpxBurgersSpec* pot, const IpxChainArgs* chain,
                                  int* out) {
  ipx::PcnWarpGeometry geo{0, 0, 0};
  const int status = ipx::pcn_burgers_warp_geometry(*pot, *chain, &geo);
  out[0] = geo.warps;
  out[1] = geo.ctas;
  out[2] = static_cast<int>(geo.smem);
  return status;
}

}  // extern "C"
