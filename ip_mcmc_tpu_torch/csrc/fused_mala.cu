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
//                                  solves from zero, one draw a CTA.
//   darcy_misfit_grad_warp_kernel  the same on the cold MALA kernel's spec,
//                                  one draw a warp (WarpSliceLevel).
//   darcy_misfit_grad_warm_kernel  (U, aux0 (2 n*n, B)) -> Phi, grad, aux:
//                                  rows [0, n*n) of aux carry the forward
//                                  solution, rows [n*n, 2 n*n) the adjoint
//                                  one; both solves start from aux0. One
//                                  draw a CTA (darcy_misfit_grad_kernel<true>).
//   darcy_misfit_grad_warm_warp_kernel
//                                  the same on the warm MALA kernel's spec,
//                                  one draw a warp (WarpDstSliceLevel).
//   fused_mala_warp_kernel<RECORD, PRECOND>
//                                  MALA on Phi + the whitened prior, one
//                                  chain a warp: PRECOND kPrecondJacobi is
//                                  the cold kernel (K10), kPrecondDst the
//                                  warm one (K11), each chain carrying the
//                                  two solutions of its current state.
//   fused_mala_kernel<Pot, RECORD>, fused_mala_warm_kernel<RECORD>
//                                  cold and warm MALA one chain a CTA, on
//                                  the specs the warp kernel leaves: any
//                                  CG Darcy misfit up to 16 x 16 with K =
//                                  d, any preconditioner. mala_route sends
//                                  each spec to one kernel or the other.
//                                  Cold, Pot LinearGaussianPotential: every
//                                  linear-Gaussian spec that
//                                  linear_cta_takes (ipx_fused_mala_linear),
//                                  the gradient -A^T ((y - A (u - c)) /
//                                  sigma^2) a thread a coordinate
//                                  (gaussian_potential.cuh).
//
// One step: prop = pos - eps^2/2 g + eps xi, value and gradient at prop,
// log ratio (phi - phi') + log q(pos | prop) - log q(prop | pos) with NaN
// mapped to -inf, accept when log u < log ratio. phi and g include the
// prior term 1/2 |z|^2, z = (u - mean) / scale (gradient z / scale): the
// TPU kernel inlines a closure that adds it (K10) or adds it in the step
// builder (K11); a CUDA kernel takes the prior as arguments.
// Tags: normals 0 (keys 0, 1), MH uniform 2.
//
// What bounds them on the H100: per chain and step a forward and an
// adjoint solve on one operator, Jacobi / 48 + 48 CG (cold) or dense dst
// / 6 + 6 CG (warm), each ~0.3 M (cold) or ~0.1 M (warm) multiply-adds,
// but chains of dependent dot products and preconditioner stages. One
// chain a CTA of 256 threads (the first design, 0.83 / 0.64 ms a step at
// 4096 chains) paid a CTA barrier for every stencil, dst stage and block
// reduction, ~480 / ~110 a step. So the kernel runs one chain a warp on
// fused_scaffold.cuh's run_warp_chain: lane l holds coordinates l, l + 32
// of d = 64 and eight cells of one 32-cell slice of the 16 x 16 grid
// (WarpSliceLevel in darcy_misfit.cuh); the whole step (proposal, both
// solves, dPhi/da, g = basis (a (-dPhi/da)), prior fold, MH test) runs in
// the warp with no CTA barrier after the staging. Every sum adds in the
// order of the one-chain-a-CTA kernel's threads, so the chains keep its
// bits: the dot products and a_bar in block_sum's (WarpSliceLevel::sum),
// the dense dst's 16 terms a cell in sequence on the CUDA cores with its
// four bf16 roundings (WarpDstSliceLevel), the KL product's partials over
// the parent's lane-strided cells, reduced and scattered in the pairs of
// warp_sum's butterfly (darcy_value_and_grad_warp), the prior and proposal
// sums as a block_sum whose warps 0 and 1 hold the 64 coordinates. The KL
// basis, S, S^T (bf16) and the dst eigenvalues are staged in shared memory
// once a CTA; a warp's slices hold the state, the solve's vectors, the
// forward solution and (warm) the carried solutions. W and the launch
// bound are the line MalaWarpDesign (scripts/measure_mala_warp_design.py
// times the alternatives, PERF.md the numbers). The one-chain-a-CTA
// kernels are that first design, kept for the specs the warp kernel's two
// levels do not hold, on darcy_value_and_grad<WARM> (the solve of the
// standalone gradient misfits on such specs); no shipped config sends them
// one.
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

#include "darcy_misfit.cuh"
#include "fused_scaffold.cuh"
#include "gaussian_potential.cuh"

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

template <class Spec>
struct MalaArgsT {
  Spec pot;
  IpxChainArgs chain;
  const float* phi0;  // (n,) misfit at pos_in
  const float* g0;    // (d, n) its gradient
  const float* aux0;  // (2 cells, n) solutions at pos_in (warm only)
  float eps;
};
using MalaArgs = MalaArgsT<IpxMisfitSpec>;

// MALA (K10 / K11) one chain a CTA: thread t < d holds coordinate t of pos,
// prop and the gradient; WARM (Darcy only): the accepted state's forward
// and adjoint solutions in xs, ls (thread t's cell t), the starts of both
// solves. Pot: DarcyPotential (the adjoint gradient of both solves,
// darcy_value_and_grad, in gs) or LinearGaussianPotential (its
// value_and_grad; gs unused).
template <class Pot, bool WARM>
struct MalaStep {
  static constexpr bool kDarcy = std::is_same_v<Pot, DarcyPotential>;
  static_assert(kDarcy || !WARM, "warm MALA carries the Darcy solutions");
  const MalaArgsT<typename Pot::Spec>& a;
  float* pos;
  float* prop;
  float* gp;  // gradient of the misfit at the proposal
  typename Pot::Workspace ws;
  GradSmem gs;
  float* xs;  // [cells] forward solution of the accepted state (warm)
  float* ls;  // [cells] adjoint solution of the accepted state (warm)
  float phi, g;

  __device__ int cells() const {
    if constexpr (WARM) return a.pot.n * a.pot.n;
    else return 0;
  }

  // the misfit at prop, its gradient in gp (thread t's coordinate t)
  __device__ float value_and_grad() {
    if constexpr (kDarcy) return darcy_value_and_grad<WARM>(a.pot, prop, ws, gs, gp);
    else return Pot::value_and_grad(a.pot, prop, ws, gp);
  }

  // adds the prior's 1/2 |z|^2 to phi_v and z / scale to this thread's g_v
  __device__ void fold(const ChainCtx& c, const float* u, float& phi_v, float& g_v) const {
    const float z = c.own ? (u[c.t] - c.mean_t) / c.scale_t : 0.0f;
    phi_v = phi_v + 0.5f * block_sum(z * z, ws.red);
    if (c.own) g_v = g_v + z / c.scale_t;
  }

  __device__ void init(const ChainCtx& c) {
    const int n = a.chain.n;
    phi = a.phi0[c.c];
    g = c.own ? a.g0[static_cast<size_t>(c.t) * n + c.c] : 0.0f;
    fold(c, pos, phi, g);
    if (WARM && c.t < cells()) {
      xs[c.t] = a.aux0[static_cast<size_t>(c.t) * n + c.c];
      ls[c.t] = a.aux0[static_cast<size_t>(cells() + c.t) * n + c.c];
    }
  }

  __device__ bool step(const ChainCtx& c, uint32_t i) {
    const float eps = a.eps;
    const float half_eps2 = 0.5f * eps * eps;
    const float inv2e2 = 1.0f / (2.0f * eps * eps);
    float xi = 0.0f;
    if (c.own) {
      xi = c.normal(i, 0u);
      prop[c.t] = (pos[c.t] - half_eps2 * g) + eps * xi;
    }
    if (WARM && c.t < cells()) {
      gs.x[c.t] = xs[c.t];
      gs.lam[c.t] = ls[c.t];
    }
    __syncthreads();
    float phi_p = value_and_grad();
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
      if (WARM && c.t < cells()) {
        xs[c.t] = gs.x[c.t];
        ls[c.t] = gs.lam[c.t];
      }
    }
    return accept;
  }
};

// Shared memory of a chain: pos, prop, the gradient, the misfit's and the
// gradient's workspaces, (warm) the accepted state's two solutions.
inline size_t mala_smem_floats(int d, int cells, int modes, int m, bool warm) {
  return 3 * d + misfit_smem_floats(cells, modes) + grad_smem_floats(cells, m) +
         (warm ? 2 * cells : 0);
}

template <class Pot, bool RECORD, bool WARM>
__device__ void mala_chain(const MalaArgsT<typename Pot::Spec>& a) {
  extern __shared__ float mala_smem[];
  const int d = a.chain.d;
  float* pos = mala_smem;
  float* prop = pos + d;
  float* gp = prop + d;
  float* work = gp + d;
  if constexpr (MalaStep<Pot, WARM>::kDarcy) {
    const int cells = a.pot.n * a.pot.n;
    float* grad = work + misfit_smem_floats(cells, a.pot.modes);
    float* xs = grad + grad_smem_floats(cells, a.pot.m);
    MalaStep<Pot, WARM> step{a,  pos, prop, gp, carve_misfit_smem(work, cells, a.pot.modes),
                             carve_grad_smem(grad, cells), xs, xs + cells, 0.0f, 0.0f};
    run_chain<RECORD>(a.chain, step, pos);
  } else {
    MalaStep<Pot, WARM> step{a,       pos,     prop, gp, Pot::carve(work, Pot::extent(a.pot)),
                             GradSmem{}, nullptr, nullptr, 0.0f, 0.0f};
    run_chain<RECORD>(a.chain, step, pos);
  }
}

template <class Pot, bool RECORD>
__global__ void __launch_bounds__(Pot::kMaxThreads, Pot::kMinCtasPerSm)
    fused_mala_kernel(const __grid_constant__ MalaArgsT<typename Pot::Spec> a) {
  mala_chain<Pot, RECORD, false>(a);
}

template <bool RECORD>
__global__ void __launch_bounds__(DarcyPotential::kMaxThreads, DarcyPotential::kMinCtasPerSm)
    fused_mala_warm_kernel(const __grid_constant__ MalaArgs a) {
  mala_chain<DarcyPotential, RECORD, true>(a);
}

// Launches fused_mala_kernel<DarcyPotential, RECORD> or, with aux0 given,
// fused_mala_warm_kernel<RECORD> (RECORD: chain.samples given) on a spec of
// mala_route's kRouteCta.
inline int launch_mala_cta(const MalaArgs& a, void* stream) {
  const int cells = a.pot.n * a.pot.n;
  const int threads = chain_threads(a.chain, cells, a.pot.K, DarcyPotential::kMaxThreads);
  if (threads == 0) return cudaErrorInvalidValue;
  if (a.chain.n == 0) return cudaSuccess;
  const bool warm = a.aux0 != nullptr, record = a.chain.samples != nullptr;
  const size_t smem =
      sizeof(float) * mala_smem_floats(a.chain.d, cells, a.pot.modes, a.pot.m, warm);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n = a.chain.n;
  if (!warm) {
    if (record) fused_mala_kernel<DarcyPotential, true><<<n, threads, smem, st>>>(a);
    else fused_mala_kernel<DarcyPotential, false><<<n, threads, smem, st>>>(a);
  } else {
    if (record) fused_mala_warm_kernel<true><<<n, threads, smem, st>>>(a);
    else fused_mala_warm_kernel<false><<<n, threads, smem, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launches fused_mala_kernel<LinearGaussianPotential, RECORD> on a
// linear-Gaussian spec of linear_route's kRouteCta: pos, prop, the
// gradient and value_and_grad's workspace (the m weights) in shared memory.
inline int launch_mala_linear(const MalaArgsT<IpxGaussianSpec>& a, void* stream) {
  using Pot = LinearGaussianPotential;
  const int threads = chain_threads(a.chain, Pot::extent(a.pot).cells, a.pot.K, Pot::kMaxThreads);
  if (threads == 0 || !Pot::valid(a.pot) || a.aux0 != nullptr) return cudaErrorInvalidValue;
  if (a.chain.n == 0) return cudaSuccess;
  const size_t smem = sizeof(float) * (3 * a.chain.d + Pot::grad_workspace_floats(a.pot));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n = a.chain.n;
  if (a.chain.samples != nullptr) fused_mala_kernel<Pot, true><<<n, threads, smem, st>>>(a);
  else fused_mala_kernel<Pot, false><<<n, threads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The design: kWarps chains a CTA at most, one a warp; the launch bound's
// warps an SM (kSmWarps: 32 caps a thread at 65536 / 1024 = 64 registers,
// 24 at 80, 16 at 128).
struct MalaWarpDesign { static constexpr int kWarps = 16, kSmWarps = 16; };
constexpr int kMalaWarpMinCtas = MalaWarpDesign::kSmWarps >= 2 * MalaWarpDesign::kWarps
                                     ? MalaWarpDesign::kSmWarps / MalaWarpDesign::kWarps
                                     : 1;
constexpr int kMalaD = WarpSliceLevel::kK;

// MALA (K10 / K11) on a warp: the lane holds coordinates l and l + 32 of
// pos, prop and the gradient g.
template <int PRECOND>
struct MalaWarpStep {
  static constexpr bool kWarm = PRECOND == kPrecondDst;
  static constexpr int kStride = WarpSliceLevel::kStride;
  using Level = std::conditional_t<kWarm, WarpDstSliceLevel, WarpSliceLevel>;
  // a warp's floats: pos, prop, then slices: the field a, the forward
  // solution, p, th, tv, (warm) the dst stage buffer and the carried x and
  // lam
  static constexpr int kWarpFloats = 2 * kMalaD + (kWarm ? 8 : 5) * kStride;
  // the CTA's staged floats before the warps: the basis, (warm) S, S^T, lam
  static constexpr size_t kStagedBytes =
      WarpSliceLevel::staged_bytes() + (kWarm ? WarpDstSliceLevel::staged_dst_bytes() : 0);

  const MalaArgs& a;
  Level lv;
  float* pos;
  float* prop;
  float* af;  // the field a at prop
  float* xf;  // the forward solution at prop
  float* xs;  // warm: the accepted state's forward solution
  float* ls;  // ... and adjoint solution
  float phi, g[2];

  // block_sum over the parent's 256 threads of the terms v0, v1 of the
  // coordinates l, l + 32: warps 0 and 1 hold them, the six others 0
  static __device__ __forceinline__ float sum64(float v0, float v1) {
    return 0.0f + warp_sum(v0) + warp_sum(v1);
  }

  // adds the prior's 1/2 |z|^2 to phi_v and z / scale to g_v
  __device__ void fold(const WarpChainCtx& x, const float* u, float& phi_v,
                       float (&g_v)[2]) const {
    const int l = threadIdx.x & 31;
    float z[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) z[h] = (u[l + 32 * h] - x.mean[h]) / x.scale[h];
    phi_v = phi_v + 0.5f * sum64(z[0] * z[0], z[1] * z[1]);
#pragma unroll
    for (int h = 0; h < 2; ++h) g_v[h] = g_v[h] + z[h] / x.scale[h];
  }

  __device__ void init(const WarpChainCtx& x) {
    const int l = threadIdx.x & 31, n = a.chain.n;
    phi = x.live ? a.phi0[x.c] : 0.0f;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      g[h] = x.live ? a.g0[static_cast<size_t>(l + 32 * h) * n + x.c] : 0.0f;
    fold(x, pos, phi, g);
    if constexpr (kWarm) {
      constexpr int cells = WarpSliceLevel::kCells;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const size_t t = Level::cell(k);
        xs[Level::at(k)] = x.live ? a.aux0[t * n + x.c] : 0.0f;
        ls[Level::at(k)] = x.live ? a.aux0[(cells + t) * n + x.c] : 0.0f;
      }
    }
  }

  __device__ bool step(const WarpChainCtx& x, uint32_t i) {
    const int l = threadIdx.x & 31;
    const float eps = a.eps;
    const float half_eps2 = 0.5f * eps * eps;
    const float inv2e2 = 1.0f / (2.0f * eps * eps);
    float xi[2];
    x.normal2(i, 0u, xi);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      prop[l + 32 * h] = (pos[l + 32 * h] - half_eps2 * g[h]) + eps * xi[h];
    __syncwarp();
    float x0[8], l0[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      x0[k] = kWarm ? xs[Level::at(k)] : 0.0f;
      l0[k] = kWarm ? ls[Level::at(k)] : 0.0f;
    }
    float g_p[2];
    float phi_p = darcy_value_and_grad_warp<kWarm>(lv, prop, af, xf, x0, l0, g_p);
    fold(x, prop, phi_p, g_p);
    float d_rev[2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      d_rev[h] = pos[l + 32 * h] - (prop[l + 32 * h] - half_eps2 * g_p[h]);
    const float log_q_rev = -sum64(d_rev[0] * d_rev[0], d_rev[1] * d_rev[1]) * inv2e2;
    const float log_q_fwd = -sum64(xi[0] * xi[0], xi[1] * xi[1]) * 0.5f;
    float log_ratio = (phi - phi_p) + log_q_rev - log_q_fwd;
    if (isnan(log_ratio)) log_ratio = -INFINITY;
    const bool accept = logf(x.uniform(i, 2u)) < log_ratio;
    if (accept) {
      phi = phi_p;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        g[h] = g_p[h];
        pos[l + 32 * h] = prop[l + 32 * h];
      }
      if constexpr (kWarm) {
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          xs[Level::at(k)] = xf[Level::at(k)];
          ls[Level::at(k)] = lv.ws.th[Level::at(k)];
        }
      }
    }
    return accept;
  }
};

template <bool RECORD, int PRECOND>
__global__ void __launch_bounds__(32 * MalaWarpDesign::kWarps, kMalaWarpMinCtas)
    fused_mala_warp_kernel(const __grid_constant__ MalaArgs a) {
  using Step = MalaWarpStep<PRECOND>;
  constexpr int kStride = WarpSliceLevel::kStride;
  extern __shared__ float4 mala_warp_smem[];
  float* staged = reinterpret_cast<float*>(mala_warp_smem);
  unsigned char* dst =
      reinterpret_cast<unsigned char*>(mala_warp_smem) + WarpSliceLevel::staged_bytes();
  float* w = staged + Step::kStagedBytes / sizeof(float) + (threadIdx.x >> 5) * Step::kWarpFloats;
  float* slice = w + 2 * kMalaD;  // af, xf, p, th, tv, (q), (xs, ls)
  const WarpSmem ws{slice + 2 * kStride, slice + 3 * kStride, slice + 4 * kStride};
  const WarpSliceLevel base{&a.pot, WarpSliceLevel::stage(a.pot, staged), ws};
  float* carry = slice + (Step::kWarm ? 6 : 5) * kStride;  // (xs, ls)
  typename Step::Level lv;
  if constexpr (Step::kWarm) {
    WarpDstSliceLevel::stage_dst(a.pot, dst);
    const __nv_bfloat16* S = WarpDstSliceLevel::staged_S(dst);
    lv = WarpDstSliceLevel{base,
                           S,
                           S + WarpSliceLevel::kN * WarpDstSliceLevel::kRow,
                           WarpDstSliceLevel::staged_lam(dst),
                           reinterpret_cast<__nv_bfloat16*>(slice + 5 * kStride),
                           1.0f};
  } else {
    lv = base;
  }
  __syncthreads();  // the staged factors
  Step step{a,     lv,    w, w + kMalaD, slice, slice + kStride, carry, carry + kStride,
            0.0f,  {0.0f, 0.0f}};
  run_warp_chain<RECORD>(a.chain, step, w);
}

// What a launch takes: warps (chains) a CTA, CTAs, dynamic shared memory.
struct MalaWarpGeometry {
  int warps, ctas;
  size_t smem;
};

// Whether the warp kernel takes the spec for chains of d coordinates: a
// 16 x 16 CG misfit with d = K = 64, Jacobi (cold) or dense dst (warm).
// Mirrored by ip_mcmc_tpu_torch/ops/fused_mala.py warp_takes.
inline bool mala_warp_takes(const IpxMisfitSpec& s, int d, bool warm) {
  return s.n == WarpSliceLevel::kN && s.K == kMalaD && d == kMalaD &&
         s.precond == (warm ? kPrecondDst : kPrecondJacobi) && s.modes == 0 &&
         s.solver == kSolverCg && s.m >= 0;
}

// The kernel a spec goes to: the warp kernel for what it takes, the
// one-chain-a-CTA kernels for any other CG misfit up to 16 x 16 with K = d,
// none above. Mirrored by ip_mcmc_tpu_torch/ops/fused_mala.py route.
inline int mala_route(const IpxMisfitSpec& s, int d, bool warm) {
  if (mala_warp_takes(s, d, warm)) return kRouteWarp;
  if (darcy_cta_spec(s, d, DarcyPotential::kMaxCells, DarcyPotential::kMaxThreads))
    return kRouteCta;
  return kRouteRefused;
}

// Mirrored by ip_mcmc_tpu_torch/ops/fused_mala.py warp_geometry: what
// mala_warp_takes, else cudaErrorNotSupported. W: the largest power of two
// up to kWarps that divides block_chains; a ragged last CTA runs spare
// warps.
inline int mala_warp_geometry(const IpxMisfitSpec& s, const IpxChainArgs& chain, bool warm,
                              MalaWarpGeometry* geo) {
  if (!mala_warp_takes(s, chain.d, warm)) return cudaErrorNotSupported;
  if (chain.block_chains <= 0 || chain.n < 0 || chain.n_steps < 0 ||
      (chain.samples != nullptr && chain.thin <= 0))
    return cudaErrorInvalidValue;
  int w = MalaWarpDesign::kWarps;
  while (chain.block_chains % w) w /= 2;
  geo->warps = w;
  geo->ctas = (chain.n + w - 1) / w;
  geo->smem = warm ? MalaWarpStep<kPrecondDst>::kStagedBytes +
                         sizeof(float) * MalaWarpStep<kPrecondDst>::kWarpFloats * w
                   : MalaWarpStep<kPrecondJacobi>::kStagedBytes +
                         sizeof(float) * MalaWarpStep<kPrecondJacobi>::kWarpFloats * w;
  return geo->smem <= 232448 ? cudaSuccess : cudaErrorInvalidValue;
}

template <bool RECORD, int PRECOND>
int launch_mala_warp(const MalaArgs& a, const MalaWarpGeometry& geo, cudaStream_t st) {
  const int smem = static_cast<int>(geo.smem);
  cudaFuncSetAttribute(fused_mala_warp_kernel<RECORD, PRECOND>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  fused_mala_warp_kernel<RECORD, PRECOND><<<geo.ctas, 32 * geo.warps, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// --- the standalone cold gradient misfit: one draw a warp ----------------------
//
// Phi and its gradient for a (K, B) batch of the cold 16 x 16 Jacobi CG
// misfit (darcy_mala_fused's start positions: Jacobi / 48 + 48 CG, 4096
// draws) on the solve of the cold MALA kernel: one draw a warp,
// darcy_value_and_grad_warp<false> on WarpSliceLevel (both solves from
// zero, no prior folded), every sum in the order of the one-draw-a-CTA
// kernel's threads, so that Phi and the gradient have the bits of
// darcy_misfit_grad_kernel<false> (256 threads, a CTA barrier on every
// stencil and block_sum). The KL basis is staged once a CTA; each warp's
// slice holds its draw's u, the field a, the forward solution and the
// solve's p, th, tv. Each lane writes its coordinates l and l + 32 of the
// gradient to its draw's column.

// The design (scripts/measure_misfit_slice_design.py times the
// alternatives): kWarps draws a CTA, one a warp; the launch bound's warps
// an SM (kSmWarps). Measured on the H100 at 4096 draws (PERF.md): W = 16
// at 109 registers 0.21 ms a call; the gradient's rows handed through
// shared memory and written W consecutive columns a row after a CTA
// barrier, as fast (0.2110 / 0.2106); W = 8 0.275; a 64- or 80-register
// bound spills (0.231, 0.293); the basis through L2 0.258. W = 32 does not
// fit: 266 KB of shared memory.
struct MisfitGradWarpDesign { static constexpr int kWarps = 16, kSmWarps = 16; };
constexpr int kMisfitGradWarpMinCtas =
    MisfitGradWarpDesign::kSmWarps >= 2 * MisfitGradWarpDesign::kWarps
        ? MisfitGradWarpDesign::kSmWarps / MisfitGradWarpDesign::kWarps
        : 1;
// a warp's floats: u, then slices: the field a, the forward solution, p,
// th, tv
constexpr int kMisfitGradWarpFloats = kMalaD + 5 * WarpSliceLevel::kStride;

// What the kernel takes: U (K, B) in; Phi (B,), the gradient (K, B) out.
struct GradBatch {
  IpxMisfitSpec s;
  const float* U;
  int B;
  float* phi;
  float* grad;
};

// Dynamic shared memory of a launch: the staged basis, a slice a warp.
constexpr size_t kMisfitGradWarpSmem =
    WarpSliceLevel::staged_bytes() + sizeof(float) * kMisfitGradWarpFloats * MisfitGradWarpDesign::kWarps;
static_assert(kMisfitGradWarpSmem <= 232448, "the design's CTA exceeds the card's shared memory");

// Whether darcy_misfit_grad_warp_kernel takes this spec (ipx_darcy_misfit_grad
// sends it there when no aux0 is given): WarpSliceLevel's, i.e. 16 x 16, K
// = 64, Jacobi, CG (warp_slice_spec), the cold MALA kernel's. Mirrored by
// ip_mcmc_tpu_torch/ops/fused_mala.py misfit_grad_warp_takes.
inline bool misfit_grad_warp_takes(const IpxMisfitSpec& s) { return warp_slice_spec(s); }

// Mirrored by ip_mcmc_tpu_torch/ops/fused_mala.py misfit_grad_warp_geometry:
// kWarps draws a CTA, the spare warps of a ragged last CTA solve nothing;
// what misfit_grad_warp_takes refuses, cudaErrorNotSupported.
inline int misfit_grad_warp_geometry(const IpxMisfitSpec& s, int B, MalaWarpGeometry* geo) {
  if (!misfit_grad_warp_takes(s)) return cudaErrorNotSupported;
  if (B < 0) return cudaErrorInvalidValue;
  geo->warps = MisfitGradWarpDesign::kWarps;
  geo->ctas = (B + geo->warps - 1) / geo->warps;
  geo->smem = kMisfitGradWarpSmem;
  return cudaSuccess;
}

__global__ void __launch_bounds__(32 * MisfitGradWarpDesign::kWarps, kMisfitGradWarpMinCtas)
    darcy_misfit_grad_warp_kernel(const __grid_constant__ GradBatch a) {
  constexpr int kStride = WarpSliceLevel::kStride;
  extern __shared__ float4 misfit_grad_warp_smem_buf[];
  float* staged = reinterpret_cast<float*>(misfit_grad_warp_smem_buf);
  const float* basis = WarpSliceLevel::stage(a.s, staged);
  float* slices = staged + WarpSliceLevel::staged_bytes() / sizeof(float);
  // the CTA's draws' coefficients, W consecutive columns of U a row
  const int W = blockDim.x >> 5, b0 = blockIdx.x * W, B = a.B;
  for (int e = threadIdx.x; e < kMalaD * W; e += blockDim.x) {
    const int k = e / W, j = e % W;
    if (b0 + j < B) slices[j * kMisfitGradWarpFloats + k] = a.U[static_cast<size_t>(k) * B + b0 + j];
  }
  __syncthreads();  // the staged basis and every warp's u
  const int l = threadIdx.x & 31, b = b0 + (threadIdx.x >> 5);
  float* u = slices + (threadIdx.x >> 5) * kMisfitGradWarpFloats;
  if (b < B) {  // a spare warp solves nothing
    float* slice = u + kMalaD;  // af, xf, p, th, tv
    WarpSliceLevel lv{&a.s, basis, {slice + 2 * kStride, slice + 3 * kStride, slice + 4 * kStride}};
    const float zeros[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    float g[2];
    const float v = darcy_value_and_grad_warp<false>(lv, u, slice, slice + kStride, zeros, zeros, g);
    if (l == 0) a.phi[b] = v;
    a.grad[static_cast<size_t>(l) * B + b] = g[0];
    a.grad[static_cast<size_t>(l + 32) * B + b] = g[1];
  }
}

// Launches darcy_misfit_grad_warp_kernel on the batch: the status of the
// geometry or of the launch.
inline int launch_misfit_grad_warp(const GradBatch& a, void* stream) {
  MalaWarpGeometry geo;
  const int status = misfit_grad_warp_geometry(a.s, a.B, &geo);
  if (status != cudaSuccess) return status;
  if (a.B == 0) return cudaSuccess;
  const int smem = static_cast<int>(geo.smem);
  cudaFuncSetAttribute(darcy_misfit_grad_warp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  darcy_misfit_grad_warp_kernel<<<geo.ctas, 32 * geo.warps, smem,
                                  static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// --- the standalone warm gradient misfit: one draw a warp ----------------------
//
// Phi, its gradient and the two solutions for a (K, B) batch of the warm
// 16 x 16 dense-dst CG misfit (darcy_mala_warm's start positions: dst / 6 +
// 6 CG from aux0 = 0, 4096 draws) on the solve of the warm MALA kernel: one
// draw a warp, darcy_value_and_grad_warp<true> on WarpDstSliceLevel (both
// solves from the draw's cells of aux0, no prior folded), every sum in the
// order of the one-draw-a-CTA kernel's threads and the dense dst's four bf16
// roundings where apply_dst rounds, so that Phi, the gradient and the
// solutions have the bits of darcy_misfit_grad_kernel<true>. The KL basis,
// S, S^T and the dst eigenvalues are staged once a CTA; each warp's slice
// holds its draw's u, the field a, the forward solution, the solve's p, th,
// tv and the dst stage buffer. aux0 comes in and aux goes out through the
// warps' slices, W consecutive columns of a row at a time, behind a CTA
// barrier at each end of the solves (the spare warps of a ragged last CTA
// solve nothing); each lane writes its coordinates l and l + 32 of the
// gradient to its draw's column.

// The design (scripts/measure_misfit_warm_surr_design.py times the
// alternatives): kWarps draws a CTA, one a warp; the launch bound's warps an
// SM (kSmWarps). Measured on the H100 at 4096 draws from aux0 = 0 (PERF.md):
// W = 16 at 128 registers 0.178-0.181 ms a call; each lane reading its
// cells of aux0 and writing those of aux straight from its registers (32
// rows a warp load, 4 bytes of each 32-byte sector), no CTA barrier after
// the staging, 0.199-0.204; W = 8 0.298; W = 4 0.330; an 80-register bound
// spills and loses (0.323). W = 32 does not fit: 306 KB of shared memory.
struct MisfitGradWarmWarpDesign { static constexpr int kWarps = 16, kSmWarps = 16; };
constexpr int kMisfitGradWarmWarpMinCtas =
    MisfitGradWarmWarpDesign::kSmWarps >= 2 * MisfitGradWarmWarpDesign::kWarps
        ? MisfitGradWarmWarpDesign::kSmWarps / MisfitGradWarmWarpDesign::kWarps
        : 1;
// a warp's floats: u, then slices: the field a, the forward solution, p,
// th, tv, the dst stage buffer
constexpr int kMisfitGradWarmWarpFloats = kMalaD + 6 * WarpSliceLevel::kStride;

// What the kernel takes: U (K, B) and aux0 (2 cells, B) in; Phi (B,), the
// gradient (K, B) and aux (2 cells, B) out.
struct GradWarmBatch {
  IpxMisfitSpec s;
  const float* U;
  const float* aux0;
  int B;
  float* phi;
  float* grad;
  float* aux;
};

// Dynamic shared memory of a launch: the staged basis, S, S^T and lam (as
// the warm MALA kernel stages them), a slice a warp.
constexpr size_t kMisfitGradWarmWarpSmem =
    MalaWarpStep<kPrecondDst>::kStagedBytes +
    sizeof(float) * kMisfitGradWarmWarpFloats * MisfitGradWarmWarpDesign::kWarps;
static_assert(kMisfitGradWarmWarpSmem <= 232448,
              "the design's CTA exceeds the card's shared memory");

// Whether darcy_misfit_grad_warm_warp_kernel takes this spec
// (ipx_darcy_misfit_grad sends it there when aux0 is given): the warm MALA
// kernel's, i.e. 16 x 16, K = 64, dense dst with no modes, CG. Mirrored by
// ip_mcmc_tpu_torch/ops/fused_mala.py misfit_grad_warm_warp_takes.
inline bool misfit_grad_warm_warp_takes(const IpxMisfitSpec& s) {
  return s.n == WarpSliceLevel::kN && s.K == kMalaD && s.precond == kPrecondDst &&
         s.modes == 0 && s.solver == kSolverCg && s.m >= 0;
}

// Mirrored by ip_mcmc_tpu_torch/ops/fused_mala.py
// misfit_grad_warm_warp_geometry: kWarps draws a CTA, the spare warps of a
// ragged last CTA solve nothing; what misfit_grad_warm_warp_takes refuses,
// cudaErrorNotSupported.
inline int misfit_grad_warm_warp_geometry(const IpxMisfitSpec& s, int B, MalaWarpGeometry* geo) {
  if (!misfit_grad_warm_warp_takes(s)) return cudaErrorNotSupported;
  if (B < 0) return cudaErrorInvalidValue;
  geo->warps = MisfitGradWarmWarpDesign::kWarps;
  geo->ctas = (B + geo->warps - 1) / geo->warps;
  geo->smem = kMisfitGradWarmWarpSmem;
  return cudaSuccess;
}

__global__ void __launch_bounds__(32 * MisfitGradWarmWarpDesign::kWarps,
                                  kMisfitGradWarmWarpMinCtas)
    darcy_misfit_grad_warm_warp_kernel(const __grid_constant__ GradWarmBatch a) {
  constexpr int kStride = WarpSliceLevel::kStride, kCells = WarpSliceLevel::kCells;
  extern __shared__ float4 misfit_grad_warm_warp_smem_buf[];
  float* staged = reinterpret_cast<float*>(misfit_grad_warm_warp_smem_buf);
  unsigned char* dst = reinterpret_cast<unsigned char*>(misfit_grad_warm_warp_smem_buf) +
                       WarpSliceLevel::staged_bytes();
  const float* basis = WarpSliceLevel::stage(a.s, staged);
  WarpDstSliceLevel::stage_dst(a.s, dst);
  float* slices = staged + MalaWarpStep<kPrecondDst>::kStagedBytes / sizeof(float);
  // the CTA's draws' coefficients, W consecutive columns of U a row
  const int W = blockDim.x >> 5, b0 = blockIdx.x * W, B = a.B;
  for (int e = threadIdx.x; e < kMalaD * W; e += blockDim.x) {
    const int k = e / W, j = e % W;
    if (b0 + j < B)
      slices[j * kMisfitGradWarmWarpFloats + k] = a.U[static_cast<size_t>(k) * B + b0 + j];
  }
  // the draws' aux0, rows [0, cells) to the slice a and [cells, 2 cells) to
  // the slice x, W consecutive columns a row (both slices are free before
  // the solve)
  for (int e = threadIdx.x; e < 2 * kCells * W; e += blockDim.x) {
    const int r = e / W, j = e % W;
    if (b0 + j < B)
      slices[j * kMisfitGradWarmWarpFloats + kMalaD + (r < kCells ? 0 : kStride) +
             WarpSliceLevel::pad(r % kCells)] = a.aux0[static_cast<size_t>(r) * B + b0 + j];
  }
  __syncthreads();  // the staged factors, every warp's u and aux0
  const int l = threadIdx.x & 31, b = b0 + (threadIdx.x >> 5);
  float* u = slices + (threadIdx.x >> 5) * kMisfitGradWarmWarpFloats;
  float* slice = u + kMalaD;  // af, xf, p, th, tv, q
  if (b < B) {  // a spare warp solves nothing
    const __nv_bfloat16* S = WarpDstSliceLevel::staged_S(dst);
    const WarpSmem ws{slice + 2 * kStride, slice + 3 * kStride, slice + 4 * kStride};
    WarpDstSliceLevel lv{
        WarpSliceLevel{&a.s, basis, ws},
        S,
        S + WarpSliceLevel::kN * WarpDstSliceLevel::kRow,
        WarpDstSliceLevel::staged_lam(dst),
        reinterpret_cast<__nv_bfloat16*>(slice + 5 * kStride),
        1.0f};
    float x0[8], l0[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      x0[k] = slice[WarpSliceLevel::at(k)];
      l0[k] = slice[kStride + WarpSliceLevel::at(k)];
    }
    float g[2];
    const float v = darcy_value_and_grad_warp<true>(lv, u, slice, slice + kStride, x0, l0, g);
    if (l == 0) a.phi[b] = v;
    a.grad[static_cast<size_t>(l) * B + b] = g[0];
    a.grad[static_cast<size_t>(l + 32) * B + b] = g[1];
    // the adjoint solution (where darcy_value_and_grad_warp leaves it,
    // lv.ws.th) to the slice a, free after the solve, beside the forward
    // one in x
#pragma unroll
    for (int k = 0; k < 8; ++k) slice[WarpSliceLevel::at(k)] = lv.ws.th[WarpSliceLevel::at(k)];
  }
  __syncthreads();  // every warp's solutions
  for (int e = threadIdx.x; e < 2 * kCells * W; e += blockDim.x) {
    const int r = e / W, j = e % W;
    if (b0 + j < B)
      a.aux[static_cast<size_t>(r) * B + b0 + j] =
          slices[j * kMisfitGradWarmWarpFloats + kMalaD + (r < kCells ? kStride : 0) +
                 WarpSliceLevel::pad(r % kCells)];
  }
}

// Launches darcy_misfit_grad_warm_warp_kernel on the batch: the status of
// the geometry or of the launch.
inline int launch_misfit_grad_warm_warp(const GradWarmBatch& a, void* stream) {
  MalaWarpGeometry geo;
  const int status = misfit_grad_warm_warp_geometry(a.s, a.B, &geo);
  if (status != cudaSuccess) return status;
  if (a.B == 0) return cudaSuccess;
  const int smem = static_cast<int>(geo.smem);
  cudaFuncSetAttribute(darcy_misfit_grad_warm_warp_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  darcy_misfit_grad_warm_warp_kernel<<<geo.ctas, 32 * geo.warps, smem,
                                       static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ipx

extern "C" {

// aux0 == null: both solves from zero, on darcy_misfit_grad_warp_kernel for
// the cold MALA kernel's spec (misfit_grad_warp_takes), else on
// darcy_misfit_grad_kernel<false>; aux0 given: from aux0, and aux receives
// the solutions, on darcy_misfit_grad_warm_warp_kernel for the warm MALA
// kernel's spec (misfit_grad_warm_warp_takes), else on
// darcy_misfit_grad_kernel<true> (darcy_misfit_grad_warm_kernel).
int ipx_darcy_misfit_grad(const IpxMisfitSpec* s, const float* U, const float* aux0, int B,
                          float* phi, float* grad, float* aux, void* stream) {
  if (aux0 == nullptr && ipx::misfit_grad_warp_takes(*s))
    return ipx::launch_misfit_grad_warp({*s, U, B, phi, grad}, stream);
  if (aux0 != nullptr && ipx::misfit_grad_warm_warp_takes(*s))
    return ipx::launch_misfit_grad_warm_warp({*s, U, aux0, B, phi, grad, aux}, stream);
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

// aux0 == null: cold MALA, else warm. mala_route picks the kernel: the warp
// kernel (fused_mala_warp_kernel<RECORD, kPrecondJacobi> cold, <RECORD,
// kPrecondDst> warm), the one-chain-a-CTA kernels (fused_mala_kernel,
// fused_mala_warm_kernel), or none (cudaErrorNotSupported).
int ipx_fused_mala(const IpxMisfitSpec* pot, const IpxChainArgs* chain, const float* phi0,
                   const float* g0, const float* aux0, float eps, void* stream) {
  const bool warm = aux0 != nullptr;
  const int route = ipx::mala_route(*pot, chain->d, warm);
  if (route == ipx::kRouteCta)
    return ipx::launch_mala_cta({*pot, *chain, phi0, g0, aux0, eps}, stream);
  if (route != ipx::kRouteWarp) return cudaErrorNotSupported;
  ipx::MalaWarpGeometry geo;
  const int status = ipx::mala_warp_geometry(*pot, *chain, warm, &geo);
  if (status != cudaSuccess) return status;
  if (chain->n == 0) return cudaSuccess;
  const ipx::MalaArgs a{*pot, *chain, phi0, g0, aux0, eps};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool record = chain->samples != nullptr;
  if (!warm)
    return record ? ipx::launch_mala_warp<true, kPrecondJacobi>(a, geo, st)
                  : ipx::launch_mala_warp<false, kPrecondJacobi>(a, geo, st);
  return record ? ipx::launch_mala_warp<true, kPrecondDst>(a, geo, st)
                : ipx::launch_mala_warp<false, kPrecondDst>(a, geo, st);
}

// The kernel's launch geometry for this spec, these chain arguments and
// warm (0: cold, Jacobi; else warm, dst): out = {chains a CTA, CTAs,
// dynamic shared-memory bytes}; the status the launch would return for them
// (the wrapper's mirror is checked against this on the card).
int ipx_mala_warp_geometry(const IpxMisfitSpec* pot, const IpxChainArgs* chain, int warm,
                           int* out) {
  ipx::MalaWarpGeometry geo{0, 0, 0};
  const int status = ipx::mala_warp_geometry(*pot, *chain, warm != 0, &geo);
  out[0] = geo.warps;
  out[1] = geo.ctas;
  out[2] = static_cast<int>(geo.smem);
  return status;
}

// The kernel ipx_fused_mala sends this spec to, for chains of d coordinates
// and warm (0: cold; ipx::kRoute*; the wrapper's mirror is checked against
// this on the card).
int ipx_mala_route(const IpxMisfitSpec* pot, int d, int warm) {
  return ipx::mala_route(*pot, d, warm != 0);
}

// Cold MALA on a linear-Gaussian spec: what linear_cta_takes goes to
// fused_mala_kernel<LinearGaussianPotential, ·>, one chain a CTA; any
// other is refused (cudaErrorNotSupported). Phi0 and g0 come from
// ipx_linear_gaussian_misfit_grad (fused_rwm.cu).
int ipx_fused_mala_linear(const IpxGaussianSpec* pot, const IpxChainArgs* chain,
                          const float* phi0, const float* g0, float eps, void* stream) {
  if (ipx::linear_route(*pot, chain->d) != ipx::kRouteCta) return cudaErrorNotSupported;
  return ipx::launch_mala_linear({*pot, *chain, phi0, g0, nullptr, eps}, stream);
}

// The kernel ipx_fused_mala_linear sends this spec to (ipx::kRoute*).
int ipx_mala_linear_route(const IpxGaussianSpec* pot, int d) {
  return ipx::linear_route(*pot, d);
}

// The standalone cold gradient misfit's launch geometry
// (darcy_misfit_grad_warp_kernel) for this spec and B draws: out = {draws a
// CTA, CTAs, dynamic shared-memory bytes}; the status the launch would
// return for them, cudaErrorNotSupported for a spec that goes to
// darcy_misfit_grad_kernel (the wrapper's mirror is checked against this on
// the card).
int ipx_darcy_misfit_grad_warp_geometry(const IpxMisfitSpec* s, int B, int* out) {
  ipx::MalaWarpGeometry geo{0, 0, 0};
  const int status = ipx::misfit_grad_warp_geometry(*s, B, &geo);
  out[0] = geo.warps;
  out[1] = geo.ctas;
  out[2] = static_cast<int>(geo.smem);
  return status;
}

// The standalone warm gradient misfit's launch geometry
// (darcy_misfit_grad_warm_warp_kernel) for this spec and B draws: out =
// {draws a CTA, CTAs, dynamic shared-memory bytes}; the status the launch
// would return for them, cudaErrorNotSupported for a spec that goes to
// darcy_misfit_grad_kernel<true> (the wrapper's mirror is checked against
// this on the card).
int ipx_darcy_misfit_grad_warm_warp_geometry(const IpxMisfitSpec* s, int B, int* out) {
  ipx::MalaWarpGeometry geo{0, 0, 0};
  const int status = ipx::misfit_grad_warm_warp_geometry(*s, B, &geo);
  out[0] = geo.warps;
  out[1] = geo.ctas;
  out[2] = static_cast<int>(geo.smem);
  return status;
}

}  // extern "C"
