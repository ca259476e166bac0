// Hand-written Hopper kernel of the fused functional ensemble sampler on
// Darcy.
//
// Replaces the Pallas TPU kernel of ip_mcmc_tpu/ops/fused_mcmc.py as
// instantiated by fused_fes_chain (l.1105) / fused_fes_chain_recorded
// (l.1148) with _make_fes_step_builder (K9, l.571).
//
//   fused_fes_warp_kernel<RECORD>  one step of the chains of one lane
//                                  parity, one chain a warp: the affine
//                                  stretch move on the first M whitened
//                                  coordinates against a partner chain of
//                                  the other parity, then pCN on the rest.
//   fused_fes_kernel<Pot, RECORD>  the same launch one chain a CTA, on the
//                                  specs the warp kernel leaves: any CG
//                                  Darcy misfit up to 16 x 16 with K = d.
//                                  fes_route sends each spec to one of the
//                                  two. Pot LinearGaussianPotential: every
//                                  linear-Gaussian spec that
//                                  linear_cta_takes (ipx_fused_fes_linear),
//                                  two launches a step as on Darcy.
//
// Each block of block_chains chains is one walker ensemble. A step is two
// red-black sub-steps: in sub-step `sub` the chains whose lane has parity
// `sub` move, w' = partner + z (w - partner) on rows < M with
// z = ((a - 1) u + 1)^2 / a, partner = lane - shift (mod block_chains), the
// shift odd and drawn once for the block, so the partner has the other
// parity and stands still during the sub-step. The log ratio is
// (M - 1) log z - (Phi' - Phi) - 1/2 sum_{rows < M} (w'^2 - w^2), NaN mapped
// to -inf. The pCN move on rows >= M follows.
//
// Synchronisation. A chain reads another chain's state, and all chains of
// parity 0 must have finished sub-step 0 before a chain of parity 1 reads
// them in sub-step 1 (and sub-step 1 of step i before sub-step 0 of step
// i + 1). The state lives in global memory and the host launches this
// kernel twice per step, once per parity, on one stream: stream order is
// the barrier (scripts/measure_fes_warp_design.py weighs this against one
// launch for all steps). The host loop takes the place of run_warp_chain's
// step loop. Within a launch only chains of one parity write and only
// chains of the other are read, so the update is in place. A chain of the
// wrong parity can never accept in a sub-step, so it is not evaluated there
// (the TPU kernel evaluates every lane in both sub-steps behind the parity
// mask: 3 misfit calls per step; here 2 per chain and step). Its pCN move
// touches rows >= M only, which no partner reads, so a chain does its
// stretch and its pCN move in the same launch; the counter RNG makes the
// order of the draws irrelevant.
//
// Tags: sub-step 0 shift 32, z 34, MH 36; sub-step 1 40, 42, 44; pCN
// normals 48 (keys 48, 49), MH 52.
//
// What bounds it on the H100: two cold Darcy solves (16 x 16, Jacobi, 48
// CG) per chain and step. One chain a CTA of 256 threads (the first
// design, 0.92 ms a step at 4096 chains) paid three CTA barriers a CG
// iteration, two of them block reductions. So a launch runs one chain a
// warp, the chains of one parity (2048 of 4096) in one wave, on
// darcy_misfit.cuh's WarpSliceLevel (elliptical slice sampling's solve: the
// basis staged once a CTA, the dot products in block_sum's order), and
// adds d_prior in block_sum's order too, so that the chains take the
// one-chain-a-CTA kernel's bits. The design is the line FesWarpDesign.
// fused_fes_kernel is that first design, kept for the specs the warp
// kernel's one level does not hold (no shipped config sends it one).
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "darcy_misfit.cuh"
#include "fused_scaffold.cuh"
#include "gaussian_potential.cuh"

namespace ipx {

// The design: kWarps chains a CTA at most, one a warp; the launch bound's
// warps an SM (kSmWarps: 32 caps a thread at 64 registers, 16 at 128).
struct FesWarpDesign { static constexpr int kWarps = 16, kSmWarps = 16; };
constexpr int kFesWarpMinCtas = FesWarpDesign::kSmWarps >= 2 * FesWarpDesign::kWarps
                                    ? FesWarpDesign::kSmWarps / FesWarpDesign::kWarps
                                    : 1;
constexpr int kFesD = WarpSliceLevel::kK;
// a warp's slice: prop (64), then p, th, tv (the level's padded cells);
// before the slices, the staged basis
constexpr int kFesWarpFloats = kFesD + 3 * WarpSliceLevel::kStride;

template <class Spec>
struct FesArgsT {
  Spec pot;
  IpxChainArgs chain;  // pos_in: the state (n, d), updated in place; out and acc are null
  float* phi;          // (n,) Phi of the state, updated in place
  float* pcn_acc;      // (n,) accepted pCN moves so far
  float* st_acc;       // (n,) accepted stretch moves so far
  float* record;       // (n, d) where <true> stores the new state
  float beta, contraction, stretch_a;
  int n_low, step, sub;
};
using FesArgs = FesArgsT<IpxMisfitSpec>;

// Warp g of the launch runs the chain of lane 2 (g mod bc/2) + sub in
// block g / (bc/2); the lane holds coordinates l and l + 32.
template <bool RECORD>
__global__ void __launch_bounds__(32 * FesWarpDesign::kWarps, kFesWarpMinCtas)
    fused_fes_warp_kernel(const __grid_constant__ FesArgs a) {
  extern __shared__ float4 fes_warp_smem[];
  constexpr int kStride = WarpSliceLevel::kStride;
  float* staged = reinterpret_cast<float*>(fes_warp_smem);
  float* prop = staged + WarpSliceLevel::staged_bytes() / sizeof(float) +
                (threadIdx.x >> 5) * kFesWarpFloats;
  const WarpSmem ws{prop + kFesD, prop + kFesD + kStride, prop + kFesD + 2 * kStride};
  const WarpSliceLevel lv{&a.pot, WarpSliceLevel::stage(a.pot, staged), ws};
  __syncthreads();  // the staged basis
  const int g = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (g >= a.chain.n / 2) return;  // a spare warp of a ragged last CTA: no barrier follows
  const int l = threadIdx.x & 31, d = kFesD, bc = a.chain.block_chains, half = bc / 2;
  const int blk = g / half, my_lane = 2 * (g % half) + a.sub;
  WarpChainCtx x = warp_chain_ctx<kFesD>(a.chain, blk * bc + my_lane);
  float* pos = const_cast<float*>(a.chain.pos_in);
  const uint32_t i = static_cast<uint32_t>(a.step);
  const size_t row = static_cast<size_t>(x.c) * d;

  float phi = a.phi[x.c];
  float w[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int t = l + 32 * h;
    x.mean[h] = a.chain.mean[t];
    x.scale[h] = a.chain.scale[t];
    w[h] = (pos[row + t] - x.mean[h]) / x.scale[h];
  }

  // the stretch move of sub-step a.sub
  const uint32_t tag0 = a.sub ? 40u : 32u;
  const int shift =
      static_cast<int>(floorf(x.block_uniform(i, tag0) * static_cast<float>(half))) * 2 + 1;
  const int partner = blk * bc + ((my_lane - shift) % bc + bc) % bc;
  const float uz = x.uniform(i, tag0 + 2u);
  const float zq = (a.stretch_a - 1.0f) * uz + 1.0f;
  const float z = zq * zq / a.stretch_a;
  float w_prop[2], dp[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int t = l + 32 * h;
    const bool low = t < a.n_low;
    w_prop[h] = w[h];
    if (low) {
      const float wp = (pos[static_cast<size_t>(partner) * d + t] - x.mean[h]) / x.scale[h];
      w_prop[h] = wp + z * (w[h] - wp);
    }
    prop[t] = x.mean[h] + x.scale[h] * w_prop[h];
    dp[h] = low ? w_prop[h] * w_prop[h] - w[h] * w[h] : 0.0f;
  }
  __syncwarp();
  float phi_p = lv.phi(prop);
  // block_sum's order over the one-chain-a-CTA kernel's 256 threads: warps
  // 0 and 1 hold the 64 coordinates, warps 2..7 add +0
  const float d_prior = 0.5f * (0.0f + warp_sum(dp[0]) + warp_sum(dp[1]));
  float log_ratio = static_cast<float>(a.n_low - 1) * logf(z) - (phi_p - phi) - d_prior;
  if (isnan(log_ratio)) log_ratio = -INFINITY;
  const bool st_ok = logf(x.uniform(i, tag0 + 4u)) < log_ratio;
  if (st_ok) {
    w[0] = w_prop[0];
    w[1] = w_prop[1];
    phi = phi_p;
  }

  // pCN on the complement rows
  float xi[2];
  x.normal2(i, 48u, xi);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int t = l + 32 * h;
    w_prop[h] = w[h];
    if (t >= a.n_low) w_prop[h] = a.contraction * w[h] + a.beta * xi[h];
    prop[t] = x.mean[h] + x.scale[h] * w_prop[h];
  }
  __syncwarp();
  phi_p = lv.phi(prop);
  const bool ok = logf(x.uniform(i, 52u)) < phi - phi_p;
  if (ok) {
    w[0] = w_prop[0];
    w[1] = w_prop[1];
    phi = phi_p;
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int t = l + 32 * h;
    const float v = x.mean[h] + x.scale[h] * w[h];
    pos[row + t] = v;
    if (RECORD) a.record[row + t] = v;
  }
  if (l == 0) {
    a.phi[x.c] = phi;
    if (st_ok) a.st_acc[x.c] += 1.0f;
    if (ok) a.pcn_acc[x.c] += 1.0f;
  }
}

// The same one chain a CTA: CTA b runs the chain of lane 2 (b mod bc/2) +
// sub in block b / (bc/2); thread t < d holds coordinate t.
template <class Pot, bool RECORD>
__global__ void __launch_bounds__(Pot::kMaxThreads, Pot::kMinCtasPerSm)
    fused_fes_kernel(const __grid_constant__ FesArgsT<typename Pot::Spec> a) {
  extern __shared__ float fes_smem[];
  const int d = a.chain.d, bc = a.chain.block_chains, half = bc / 2;
  const int blk = blockIdx.x / half, my_lane = 2 * (blockIdx.x % half) + a.sub;
  const ChainCtx c = make_chain_ctx(a.chain, blk * bc + my_lane);
  float* pos = const_cast<float*>(a.chain.pos_in);
  float* prop = fes_smem;
  const typename Pot::Workspace ws = Pot::carve(prop + d, Pot::extent(a.pot));
  const uint32_t i = static_cast<uint32_t>(a.step);
  const bool low = c.t < a.n_low;
  const size_t row = static_cast<size_t>(c.c) * d;

  float phi = a.phi[c.c];
  float w = c.own ? (pos[row + c.t] - c.mean_t) / c.scale_t : 0.0f;

  // the stretch move of sub-step a.sub; the shift is the (1, 1) draw of the
  // block
  const uint32_t tag0 = a.sub ? 40u : 32u;
  const int shift =
      static_cast<int>(floorf(uniform01(mix_key(c.bseed, i, tag0), 0u) * static_cast<float>(half))) *
          2 + 1;
  const int partner = blk * bc + ((my_lane - shift) % bc + bc) % bc;
  const float uz = c.uniform(i, tag0 + 2u);
  const float zq = (a.stretch_a - 1.0f) * uz + 1.0f;
  const float z = zq * zq / a.stretch_a;
  float w_prop = w;
  if (c.own && low) {
    const float wp = (pos[static_cast<size_t>(partner) * d + c.t] - c.mean_t) / c.scale_t;
    w_prop = wp + z * (w - wp);
  }
  if (c.own) prop[c.t] = c.mean_t + c.scale_t * w_prop;
  __syncthreads();
  float phi_p = Pot::phi(a.pot, prop, ws);
  const float d_prior =
      0.5f * block_sum((c.own && low) ? w_prop * w_prop - w * w : 0.0f, ws.red);
  float log_ratio = static_cast<float>(a.n_low - 1) * logf(z) - (phi_p - phi) - d_prior;
  if (isnan(log_ratio)) log_ratio = -INFINITY;
  const bool st_ok = logf(c.uniform(i, tag0 + 4u)) < log_ratio;
  if (st_ok) {
    w = w_prop;
    phi = phi_p;
  }

  // pCN on the complement rows
  w_prop = w;
  if (c.own && !low) w_prop = a.contraction * w + a.beta * c.normal(i, 48u);
  if (c.own) prop[c.t] = c.mean_t + c.scale_t * w_prop;
  __syncthreads();
  phi_p = Pot::phi(a.pot, prop, ws);
  const bool ok = logf(c.uniform(i, 52u)) < phi - phi_p;
  if (ok) {
    w = w_prop;
    phi = phi_p;
  }

  if (c.own) {
    const float v = c.mean_t + c.scale_t * w;
    pos[row + c.t] = v;
    if (RECORD) a.record[row + c.t] = v;
  }
  if (c.t == 0) {
    a.phi[c.c] = phi;
    if (st_ok) a.st_acc[c.c] += 1.0f;
    if (ok) a.pcn_acc[c.c] += 1.0f;
  }
}

// What a launch takes: warps (chains) a CTA, CTAs, dynamic shared memory.
struct FesWarpGeometry {
  int warps, ctas;
  size_t smem;
};

// Whether the warp kernel takes the spec for chains of d coordinates: a
// 16 x 16 Jacobi CG misfit with d = K = 64 (elliptical slice sampling's
// level). Mirrored by ip_mcmc_tpu_torch/ops/fused_fes.py warp_takes.
inline bool fes_warp_takes(const IpxMisfitSpec& s, int d) {
  return s.n == WarpSliceLevel::kN && s.K == kFesD && d == kFesD &&
         s.precond == kPrecondJacobi && s.modes == 0 && s.solver == kSolverCg && s.m >= 0;
}

// The kernel a spec goes to: the warp kernel for what it takes, the
// one-chain-a-CTA kernel for any other CG misfit up to 16 x 16 with K = d,
// none above. Mirrored by ip_mcmc_tpu_torch/ops/fused_fes.py route.
inline int fes_route(const IpxMisfitSpec& s, int d) {
  if (fes_warp_takes(s, d)) return kRouteWarp;
  if (darcy_cta_spec(s, d, DarcyPotential::kMaxCells, DarcyPotential::kMaxThreads))
    return kRouteCta;
  return kRouteRefused;
}

// Whole ensembles of an even block_chains, n_low in [0, d]: what both
// kernels check.
inline bool fes_ensembles_ok(const IpxChainArgs& chain, int n_low) {
  return chain.block_chains > 0 && chain.block_chains % 2 == 0 && chain.n >= 0 &&
         chain.n % chain.block_chains == 0 && n_low >= 0 && n_low <= chain.d;
}

// Launches fused_fes_kernel<Pot, RECORD> (RECORD: a.record given) for the
// chains of parity a.sub, on a spec of fes_route's (or, linear-Gaussian,
// linear_route's) kRouteCta.
template <class Pot>
int launch_fes_cta(const FesArgsT<typename Pot::Spec>& a, cudaStream_t st) {
  const typename Pot::Extent extent = Pot::extent(a.pot);
  const int threads =
      chain_threads(a.chain, extent.cells, a.pot.K, Pot::kMaxThreads, Pot::kCellsPerThread);
  if (threads == 0 || !Pot::valid(a.pot) || !fes_ensembles_ok(a.chain, a.n_low) || a.step < 0 ||
      (a.sub != 0 && a.sub != 1))
    return cudaErrorInvalidValue;
  if (a.chain.n == 0) return cudaSuccess;
  const size_t smem = sizeof(float) * (a.chain.d + Pot::workspace_floats(extent));
  if (a.record != nullptr) fused_fes_kernel<Pot, true><<<a.chain.n / 2, threads, smem, st>>>(a);
  else fused_fes_kernel<Pot, false><<<a.chain.n / 2, threads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Mirrored by ip_mcmc_tpu_torch/ops/fused_fes.py warp_geometry: what
// fes_warp_takes (else cudaErrorNotSupported), whole ensembles of an even
// block_chains. A launch runs the n / 2 chains of one parity. W: the
// largest power of two up to kWarps that divides block_chains; a ragged
// last CTA runs spare warps, which return.
inline int fes_warp_geometry(const IpxMisfitSpec& s, const IpxChainArgs& chain, int n_low,
                             FesWarpGeometry* geo) {
  if (!fes_warp_takes(s, chain.d)) return cudaErrorNotSupported;
  if (!fes_ensembles_ok(chain, n_low)) return cudaErrorInvalidValue;
  int w = FesWarpDesign::kWarps;
  while (chain.block_chains % w) w /= 2;
  geo->warps = w;
  geo->ctas = (chain.n / 2 + w - 1) / w;
  geo->smem = WarpSliceLevel::staged_bytes() + sizeof(float) * kFesWarpFloats * w;
  return geo->smem <= 232448 ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace ipx

extern "C" {

// One launch: step `step`, the chains of parity `sub`. `record`: where this
// launch stores its chains' new state, or null.
// fes_route picks the kernel: the warp kernel, the one-chain-a-CTA
// kernel, or none (cudaErrorNotSupported).
int ipx_fused_fes(const IpxMisfitSpec* pot, const IpxChainArgs* chain, float* phi,
                  float* pcn_acc, float* st_acc, float* record, float beta, float contraction,
                  float stretch_a, int n_low, int step, int sub, void* stream) {
  const int route = ipx::fes_route(*pot, chain->d);
  if (route == ipx::kRouteRefused) return cudaErrorNotSupported;
  const ipx::FesArgs a{*pot, *chain, phi, pcn_acc, st_acc, record, beta, contraction,
                       stretch_a, n_low, step, sub};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == ipx::kRouteCta) return ipx::launch_fes_cta<ipx::DarcyPotential>(a, st);
  ipx::FesWarpGeometry geo;
  const int status = ipx::fes_warp_geometry(*pot, *chain, n_low, &geo);
  if (status != cudaSuccess) return status;
  if (step < 0 || (sub != 0 && sub != 1)) return cudaErrorInvalidValue;
  if (chain->n == 0) return cudaSuccess;
  const int threads = 32 * geo.warps, smem = static_cast<int>(geo.smem);
  if (record != nullptr) {
    cudaFuncSetAttribute(ipx::fused_fes_warp_kernel<true>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    ipx::fused_fes_warp_kernel<true><<<geo.ctas, threads, smem, st>>>(a);
  } else {
    cudaFuncSetAttribute(ipx::fused_fes_warp_kernel<false>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    ipx::fused_fes_warp_kernel<false><<<geo.ctas, threads, smem, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// The kernel's launch geometry for this spec and these chain arguments:
// out = {chains a CTA, CTAs, dynamic shared-memory bytes}; the status the
// launch would return for them (the wrapper's mirror is checked against
// this on the card).
int ipx_fes_warp_geometry(const IpxMisfitSpec* pot, const IpxChainArgs* chain, int n_low,
                          int* out) {
  ipx::FesWarpGeometry geo{0, 0, 0};
  const int status = ipx::fes_warp_geometry(*pot, *chain, n_low, &geo);
  out[0] = geo.warps;
  out[1] = geo.ctas;
  out[2] = static_cast<int>(geo.smem);
  return status;
}

// The kernel ipx_fused_fes sends this spec to, for chains of d coordinates
// (ipx::kRoute*; the wrapper's mirror is checked against this on the card).
int ipx_fes_route(const IpxMisfitSpec* pot, int d) { return ipx::fes_route(*pot, d); }

// The same launch on a linear-Gaussian spec: what linear_cta_takes goes to
// fused_fes_kernel<LinearGaussianPotential, ·>, one chain a CTA; any other
// is refused (cudaErrorNotSupported).
int ipx_fused_fes_linear(const IpxGaussianSpec* pot, const IpxChainArgs* chain, float* phi,
                         float* pcn_acc, float* st_acc, float* record, float beta,
                         float contraction, float stretch_a, int n_low, int step, int sub,
                         void* stream) {
  if (ipx::linear_route(*pot, chain->d) != ipx::kRouteCta) return cudaErrorNotSupported;
  const ipx::FesArgsT<IpxGaussianSpec> a{*pot,      *chain, phi,   pcn_acc, st_acc, record,
                                         beta,      contraction, stretch_a, n_low,   step,   sub};
  return ipx::launch_fes_cta<ipx::LinearGaussianPotential>(a, static_cast<cudaStream_t>(stream));
}

// The kernel ipx_fused_fes_linear sends this spec to (ipx::kRoute*).
int ipx_fes_linear_route(const IpxGaussianSpec* pot, int d) { return ipx::linear_route(*pot, d); }

}  // extern "C"
