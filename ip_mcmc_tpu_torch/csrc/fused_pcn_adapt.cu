// Hand-written Hopper kernels of burn-in pCN with Robbins-Monro adaptation
// of beta on the block-pooled acceptance probability (K16).
//
// Replaces the Pallas TPU kernel of ip_mcmc_tpu/ops/fused_mcmc.py as
// instantiated by fused_pcn_chain_adapt (l.992) with
// _make_pcn_adapt_step_builder (K16, l.520). Per step, with one log beta
// per block of block_chains chains:
//
//   beta = exp(log beta), prop = m + sqrt(1 - beta^2) (pos - m) + beta s xi,
//   p = min(1, exp(Phi - Phi')), accepted when log u < log p;
//   log beta <- clip(log beta + gamma_i (mean over the block of p - target),
//                    log 1e-4, log 0.999),  gamma_i = gain (1 + i)^-0.6.
//
// Every chain of a block reads the block's beta, so the chains of a block
// meet once a step. The JAX kernel runs a block as one grid program; a
// block of 256 chains fits no CTA here, but it fits one thread-block
// cluster:
//
//   fused_pcn_adapt_group_kernel<D, G>  the whole burn-in in one launch, for
//       the specs that pcn_adapt_group_takes (gaussian_group_takes: d = 2 or
//       32, K = d, m <= d; a block of at most 256 chains that fits one
//       cluster; whole blocks): each block on one cluster, a chain on each
//       group of G = d lanes (run_group_pooled in fused_scaffold.cuh; at d =
//       32 a warp running 2 chains in turn, 16 warps a CTA, 8 CTAs a
//       cluster), the state and the potential's row in registers, Phi by
//       GaussianGroupRow (the one-warp CTA's gaussian_phi bit for bit). Once
//       a step every chain stores its p into every CTA of the cluster
//       (distributed shared memory; two buffers, alternating with the
//       step's parity), then one cluster barrier (arrive: release, the next
//       step's draws, wait: acquire); every warp then folds the block's p
//       from its own CTA's copy in pcn_adapt_update_kernel's order
//       (fold_sum) and forms the new log beta as that kernel does, so every
//       warp of the cluster holds the same log beta without a CTA barrier.
//
// Every other spec (d = 3, m > d, a block of more than 256 chains, ...)
// keeps the host loop, two launches a step, with the state in device memory
// and stream order as the barrier:
//
//   fused_pcn_adapt_kernel<Pot>  one CTA per chain: the pCN move in place,
//                                Phi in place, the acceptance count, and
//                                the chain's p;
//   pcn_adapt_update_kernel      one CTA per block: the sum of the block's p
//                                in a fixed pairwise order (fold the upper
//                                half onto the lower until one is left),
//                                the update of log beta, and beta for every
//                                chain of the block (the extra output).
//
// Both routes and the plain version sum in the same order and the update is
// written with __fmul_rn / __fadd_rn (no FMA contraction), so from the same
// p they give the same beta to the bit; the group kernel's move is the
// one-chain-a-CTA kernel's expression, so on the specs it takes it gives the
// two launches' chains, acceptance rates and beta bit for bit. gamma_i, the
// clip bounds and the initial log beta come from the host, identical for
// all. Tags: normals 0 (keys 0, 1), MH uniform 2.
//
// What bounds it on the H100: per chain and step one potential and d draws
// (a few MFLOP a step at 2048 chains, far below the f32 rate), no memory
// traffic. The two-launch loop pays two launches and the host's loop a
// step (about 20 us at the configs' sizes, PERF.md). The group kernel pays
// a step's dependent latency: its chains' moves in turn (K15's step), one
// cluster barrier and the fold of the block's p (PERF.md breaks it down,
// scripts/measure_pcn_adapt_design.py times the designs). Eight blocks of
// 256 chains fill 64 SMs at 8 CTAs a cluster; 16 CTAs a cluster would fill
// 128 but fit the card only 7 at a time.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "fused_scaffold.cuh"
#include "gaussian_potential.cuh"

namespace ipx {

template <class Pot>
struct PcnAdaptArgs {
  typename Pot::Spec pot;
  IpxChainArgs chain;      // pos_in: the state (n, d), updated in place; out, acc null
  float* phi;              // (n,) Phi of the state, updated in place
  float* acc;              // (n,) accepted moves so far
  float* accept_prob;      // (n,) this step's min(1, exp(Phi - Phi'))
  const float* log_beta;   // (n / block_chains,) each block's log beta
  int step;
};

template <class Pot>
__global__ void __launch_bounds__(Pot::kMaxThreads, Pot::kMinCtasPerSm)
    fused_pcn_adapt_kernel(PcnAdaptArgs<Pot> a) {
  extern __shared__ float smem[];
  const ChainCtx c = make_chain_ctx(a.chain, blockIdx.x);
  const int d = a.chain.d;
  float* pos = const_cast<float*>(a.chain.pos_in);
  float* prop = smem;
  const typename Pot::Workspace ws = Pot::carve(prop + d, Pot::extent(a.pot));
  const uint32_t i = static_cast<uint32_t>(a.step);
  const size_t row = static_cast<size_t>(c.c) * d;

  const float beta = expf(a.log_beta[c.c / a.chain.block_chains]);
  const float contraction = sqrtf(__fsub_rn(1.0f, __fmul_rn(beta, beta)));
  if (c.own) {
    const float xi = c.scale_t * c.normal(i, 0u);
    prop[c.t] = c.mean_t + contraction * (pos[row + c.t] - c.mean_t) + beta * xi;
  }
  __syncthreads();
  const float phi = a.phi[c.c];
  const float phi_prop = Pot::phi(a.pot, prop, ws);
  const float delta = phi - phi_prop;
  const float log_ratio = (delta < 0.0f || isnan(delta)) ? delta : 0.0f;  // NaN stays NaN
  const bool accept = logf(c.uniform(i, 2u)) < log_ratio;
  if (accept && c.own) pos[row + c.t] = prop[c.t];
  if (c.t == 0) {
    a.accept_prob[c.c] = expf(log_ratio);
    if (accept) {
      a.phi[c.c] = phi_prop;
      a.acc[c.c] += 1.0f;
    }
  }
}

// One CTA per block; `pooled` holds block_chains floats of shared memory.
__global__ void pcn_adapt_update_kernel(const float* __restrict__ accept_prob,
                                        float* __restrict__ log_beta,
                                        float* __restrict__ beta_out, int block_chains,
                                        float gamma, float target, float lo, float hi) {
  extern __shared__ float pooled[];
  __shared__ float new_log_beta;
  const int blk = blockIdx.x, t = threadIdx.x;
  const size_t first = static_cast<size_t>(blk) * block_chains;
  for (int e = t; e < block_chains; e += blockDim.x) pooled[e] = accept_prob[first + e];
  __syncthreads();
  // fold: element e < n - h takes e + h (>= h, which no thread writes in
  // this round)
  for (int n = block_chains; n > 1;) {
    const int h = (n + 1) / 2;
    for (int e = t; e < n - h; e += blockDim.x) pooled[e] = __fadd_rn(pooled[e], pooled[e + h]);
    __syncthreads();
    n = h;
  }
  if (t == 0) {
    const float mean = pooled[0] / static_cast<float>(block_chains);
    float lb = __fadd_rn(log_beta[blk], __fmul_rn(gamma, __fsub_rn(mean, target)));
    lb = lb < lo ? lo : (lb > hi ? hi : lb);  // a NaN stays NaN, as in the clip
    log_beta[blk] = lb;
    new_log_beta = lb;
  }
  __syncthreads();
  const float beta = expf(new_log_beta);
  for (int e = t; e < block_chains; e += blockDim.x) beta_out[first + e] = beta;
}

template <class Pot>
int launch_pcn_adapt(const typename Pot::Spec& pot, const IpxChainArgs& chain, float* phi,
                     float* acc, float* accept_prob, const float* log_beta, int step,
                     void* stream) {
  const typename Pot::Extent extent = Pot::extent(pot);
  const int threads = chain_threads(chain, extent.cells, pot.K, Pot::kMaxThreads);
  if (threads == 0 || !Pot::valid(pot) || chain.n % chain.block_chains || step < 0)
    return cudaErrorInvalidValue;
  if (chain.n == 0) return cudaSuccess;
  const PcnAdaptArgs<Pot> a{pot, chain, phi, acc, accept_prob, log_beta, step};
  const size_t smem = sizeof(float) * (chain.d + Pot::workspace_floats(extent));
  fused_pcn_adapt_kernel<Pot><<<chain.n, threads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}


// --- the whole burn-in in one launch: a block of chains on one cluster -----

namespace cg = cooperative_groups;

// The design of fused_pcn_adapt_group_kernel
// (scripts/measure_pcn_adapt_design.py times the alternatives, PERF.md the
// numbers): kWarps warps a CTA, kTurns chains that each group runs in turn,
// at most kMaxCluster CTAs a cluster, kMinCtas CTAs an SM for the launch
// bound.
struct PcnAdaptGroupDesign {
  static constexpr int kWarps = 16, kTurns = 2, kMaxCluster = 8, kMinCtas = 1;
};

// p values a lane of the folding warp: blocks of up to 32 kFoldSlots chains
constexpr int kFoldSlots = 8;

// Chains a CTA, for chains of d coordinates.
__host__ __device__ constexpr int pcn_adapt_group_chains(int d) {
  return PcnAdaptGroupDesign::kWarps * PcnAdaptGroupDesign::kTurns * (32 / gaussian_group_width(d));
}

// The largest block the group kernel takes: one cluster's chains, and what
// the folding warp holds.
__host__ __device__ constexpr int pcn_adapt_group_max_block(int d) {
  return PcnAdaptGroupDesign::kMaxCluster * pcn_adapt_group_chains(d) < 32 * kFoldSlots
             ? PcnAdaptGroupDesign::kMaxCluster * pcn_adapt_group_chains(d)
             : 32 * kFoldSlots;
}

// Whether the group kernel takes a burn-in of n chains in blocks of
// block_chains on this spec: what gaussian_group_takes takes, a block that
// fits one cluster and whole blocks. ipx_fused_pcn_adapt_chain refuses
// every other (the wrapper runs it two launches a step). Mirrored by
// ip_mcmc_tpu_torch/ops/fused_pcn_adapt.py group_takes.
inline bool pcn_adapt_group_takes(const IpxGaussianSpec& s, int d, int block_chains, int n) {
  return gaussian_group_takes(s, d) && block_chains >= 1 &&
         block_chains <= pcn_adapt_group_max_block(d) && n % block_chains == 0;
}

struct PcnAdaptGroupGeometry {
  int width;    // G: lanes a chain
  int warps;    // warps a CTA
  int cluster;  // CTAs a cluster: a block
  int ctas;
};

// Mirrored by ip_mcmc_tpu_torch/ops/fused_pcn_adapt.py group_geometry:
// what pcn_adapt_group_takes refuses, cudaErrorNotSupported. Block b runs on
// cluster b; chain e of the block on CTA e / chains-a-CTA of it.
inline int pcn_adapt_group_geometry(const IpxGaussianSpec& s, const IpxChainArgs& chain,
                                    PcnAdaptGroupGeometry* geo) {
  if (!pcn_adapt_group_takes(s, chain.d, chain.block_chains, chain.n))
    return cudaErrorNotSupported;
  if (chain.n < 0 || chain.n_steps < 0 || chain.samples != nullptr) return cudaErrorInvalidValue;
  const int per = pcn_adapt_group_chains(chain.d);
  geo->width = gaussian_group_width(chain.d);
  geo->warps = PcnAdaptGroupDesign::kWarps;
  geo->cluster = (chain.block_chains + per - 1) / per;
  geo->ctas = chain.n / chain.block_chains * geo->cluster;
  return cudaSuccess;
}

// v[j] with j known at compile time, 0 past the slots
template <int S>
__device__ __forceinline__ float slot_or_zero(const float (&v)[S], int j) {
  return j < S ? v[j < S ? j : S - 1] : 0.0f;
}

// One round of the fold of n values, lane l holding value l + 32 k in v[k]:
// value e < n - h takes value e + h, h = 32 Q + r, which lane (l + r) mod 32
// holds in slot k + Q, or k + Q + 1 where l + r wraps. A source e + h >= h
// >= n - h is never a destination, so the round runs in place.
template <int Q, int S>
__device__ __forceinline__ void fold_round(float (&v)[S], int n, int h) {
  const int l = threadIdx.x & 31, r = h & 31;
#pragma unroll
  for (int k = 0; k < S; ++k) {
    float s = slot_or_zero(v, k + Q);
    if (r != 0) {  // the same in every lane
      const float lo = __shfl_sync(0xffffffffu, s, (l + r) & 31);
      const float hi = __shfl_sync(0xffffffffu, slot_or_zero(v, k + Q + 1), (l + r) & 31);
      s = l + r < 32 ? lo : hi;
    }
    if (l + 32 * k < n - h) v[k] = __fadd_rn(v[k], s);
  }
}

template <int Q, int S>
__device__ __forceinline__ void fold_round_at(float (&v)[S], int n, int h) {
  if constexpr (Q <= S / 2) {
    if (h >> 5 == Q)
      fold_round<Q>(v, n, h);
    else
      fold_round_at<Q + 1>(v, n, h);
  }
}

// The sum of n <= 32 S values held as fold_round says, in
// pcn_adapt_update_kernel's (and _fold_sum's) order: value e < n - h takes
// value e + h, h = ceil(n / 2), until one is left. Rounds of n > 32 add in
// the registers (shuffling where h is no multiple of 32); the last rounds
// shuffle down by h in slot 0. The sum in lane 0. Every lane of the warp
// calls. tests/test_torch_pcn_adapt_group.py mirrors it in NumPy.
template <int S>
__device__ __forceinline__ float fold_sum(float (&v)[S], int n) {
  while (n > 32) {
    const int h = (n + 1) / 2;
    fold_round_at<0>(v, n, h);
    n = h;
  }
  const int l = threadIdx.x & 31;
  float s = v[0];
  while (n > 1) {
    const int h = (n + 1) / 2;
    const float o = __shfl_down_sync(0xffffffffu, s, h);
    if (l < n - h) s = __fadd_rn(s, o);
    n = h;
  }
  return s;
}

struct PcnAdaptGroupArgs {
  IpxGaussianSpec pot;
  IpxChainArgs chain;   // pos_in (n, d), mean, scale; out (n, d); acc (n,): the rate
  float* beta;          // (n,) the adapted beta per chain
  const float* gamma;   // (n_steps,) gamma_i
  float target, lo, hi;
  float log_beta0, beta0;  // log beta at the start, and beta0 (the output of 0 steps)
  float inv_steps;         // 1 / n_steps in f32: the rate is count * inv_steps
};

// K16 on G lanes a chain, the block on one cluster: the move, Phi and the
// MH test of fused_pcn_adapt_kernel, and the pool of pcn_adapt_update_kernel.
template <int D, int G>
struct PcnAdaptGroupStep {
  using Ctx = GroupChainCtxT<D, G>;
  static constexpr int kTurns = PcnAdaptGroupDesign::kTurns;
  static constexpr int kChains = pcn_adapt_group_chains(D);
  static constexpr int kBlock = 32 * kFoldSlots;  // the largest block
  const PcnAdaptGroupArgs& a;
  float (&pooled)[2][kBlock];  // the block's p, a buffer a step's parity
  int ctas;                    // CTAs in the cluster
  GaussianGroupRow<D, G, PcnAdaptGroupDesign::kWarps> row;
  float pos[kTurns], phi[kTurns];
  float xi[kTurns], log_u[kTurns];  // this step's draws
  float log_beta, beta, contraction;

  __device__ __forceinline__ void draw(const Ctx (&x)[kTurns], uint32_t i) {
#pragma unroll
    for (int turn = 0; turn < kTurns; ++turn) {
      xi[turn] = x[turn].scale * x[turn].normal1(i, 0u);
      log_u[turn] = logf(x[turn].uniform(i, 2u));
    }
  }

  __device__ __forceinline__ void set_beta(float lb) {
    log_beta = lb;
    beta = expf(lb);
    contraction = sqrtf(__fsub_rn(1.0f, __fmul_rn(beta, beta)));
  }

  __device__ void init(const Ctx (&x)[kTurns]) {
#pragma unroll
    for (int turn = 0; turn < kTurns; ++turn) phi[turn] = row.phi(pos[turn]);
    set_beta(a.log_beta0);
    draw(x, 0u);
    cg::this_cluster().sync();  // every CTA runs before a peer stores into it
  }

  // The group's kTurns chains in turn, each in the one-chain-a-CTA kernel's
  // order and form.
  __device__ void step(const Ctx (&x)[kTurns], uint32_t i, bool (&accepted)[kTurns]) {
#pragma unroll
    for (int turn = 0; turn < kTurns; ++turn) {
      const float prop = x[turn].mean + contraction * (pos[turn] - x[turn].mean) + beta * xi[turn];
      const float phi_prop = row.phi(prop);
      const float delta = phi[turn] - phi_prop;
      const float log_ratio = (delta < 0.0f || isnan(delta)) ? delta : 0.0f;  // NaN stays NaN
      const bool accept = log_u[turn] < log_ratio;  // the same in the group
      const float p = expf(log_ratio);              // the same in the group
      if (x[turn].live)  // into every CTA of the cluster: lane t stores into CTAs t, t + G, ...
        for (int r = Ctx::t(); r < ctas; r += G)
          *cg::this_cluster().map_shared_rank(&pooled[i & 1u][x[turn].lane], r) = p;
      phi[turn] = accept ? phi_prop : phi[turn];
      pos[turn] = accept ? prop : pos[turn];
      accepted[turn] = accept;
    }
  }

  __device__ void pool(const Ctx (&x)[kTurns], uint32_t i) {
    __syncwarp();
    // the cluster barrier, split: arrive (release: the p this CTA stored),
    // the next step's draws while the others arrive, wait (acquire: every
    // CTA's)
    asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
    const float gamma = a.gamma[i];
    draw(x, i + 1u);
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    const int bc = a.chain.block_chains;
    float v[kFoldSlots];  // every warp folds the block's p from its CTA's copy
#pragma unroll
    for (int k = 0; k < kFoldSlots; ++k) {
      const int e = static_cast<int>(threadIdx.x & 31) + 32 * k;
      v[k] = e < bc ? pooled[i & 1u][e] : 0.0f;
    }
    // a block of kBlock (the shipped 256) folds with every round known at
    // compile time: a few adds and shuffles, no loop
    const float lb = bc == kBlock ? next_log_beta(fold_sum(v, kBlock), kBlock, gamma)
                                  : next_log_beta(fold_sum(v, bc), bc, gamma);
    set_beta(__shfl_sync(0xffffffffu, lb, 0));
  }

  // log beta after a step whose p add to `sum`, as pcn_adapt_update_kernel
  // forms it
  __device__ __forceinline__ float next_log_beta(float sum, int bc, float gamma) const {
    const float mean = sum / static_cast<float>(bc);
    const float lb = __fadd_rn(log_beta, __fmul_rn(gamma, __fsub_rn(mean, a.target)));
    return lb < a.lo ? a.lo : (lb > a.hi ? a.hi : lb);  // a NaN stays NaN, as in the clip
  }

  __device__ void finish(const Ctx& x, float accepted) {
    if (Ctx::t() != 0) return;
    a.chain.acc[x.c] = __fmul_rn(accepted, a.inv_steps);
    a.beta[x.c] = a.chain.n_steps > 0 ? beta : a.beta0;
  }
};

template <int D, int G>
__global__ void __launch_bounds__(32 * PcnAdaptGroupDesign::kWarps, PcnAdaptGroupDesign::kMinCtas)
    fused_pcn_adapt_group_kernel(const __grid_constant__ PcnAdaptGroupArgs a) {
  using Step = PcnAdaptGroupStep<D, G>;
  __shared__ float pooled[2][Step::kBlock];
  cg::cluster_group cluster = cg::this_cluster();
  const int first = static_cast<int>(cluster.block_rank()) * Step::kChains;
  Step step{a, pooled, static_cast<int>(cluster.num_blocks())};
  step.row.load(a.pot);
  run_group_pooled<D, G, Step::kTurns>(
      a.chain, step, static_cast<int>(blockIdx.x / cluster.num_blocks()), first);
  cluster.sync();  // no peer stores into this CTA after it exits
}

// pcn_adapt_group_geometry as launch_cluster takes it.
inline ClusterGeometry pcn_adapt_cluster(const PcnAdaptGroupGeometry& geo) {
  return {geo.cluster, geo.ctas / geo.cluster, geo.ctas, 32 * geo.warps, 0};
}

// Launches fused_pcn_adapt_group_kernel<d, G> for a spec that
// pcn_adapt_group_takes, in clusters of geo.cluster CTAs.
inline int launch_pcn_adapt_group(const PcnAdaptGroupArgs& a, void* stream) {
  PcnAdaptGroupGeometry geo;
  const int status = pcn_adapt_group_geometry(a.pot, a.chain, &geo);
  if (status != cudaSuccess) return status;
  if (a.gamma == nullptr && a.chain.n_steps > 0) return cudaErrorInvalidValue;
  if (a.chain.n == 0) return cudaSuccess;
  constexpr int G2 = gaussian_group_width(2), G32 = gaussian_group_width(32);
  const ClusterGeometry cl = pcn_adapt_cluster(geo);
  if (a.chain.d == 2) return launch_cluster(fused_pcn_adapt_group_kernel<2, G2>, cl, stream, a);
  return launch_cluster(fused_pcn_adapt_group_kernel<32, G32>, cl, stream, a);
}

}  // namespace ipx

extern "C" {

// One step of every chain: the move, Phi and the acceptance count in place,
// and each chain's acceptance probability.
int ipx_fused_pcn_adapt(const IpxGaussianSpec* pot, const IpxChainArgs* chain, float* phi,
                        float* acc, float* accept_prob, const float* log_beta, int step,
                        void* stream) {
  return ipx::launch_pcn_adapt<ipx::LinearGaussianPotential>(*pot, *chain, phi, acc,
                                                             accept_prob, log_beta, step,
                                                             stream);
}

// The blocks' pooled acceptance, log beta in place, beta per chain.
int ipx_pcn_adapt_update(const float* accept_prob, float* log_beta, float* beta_out, int n,
                         int block_chains, float gamma, float target, float lo, float hi,
                         void* stream) {
  if (block_chains <= 0 || n < 0 || n % block_chains) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const int threads = ipx::round_up32(block_chains < 1024 ? block_chains : 1024);
  ipx::pcn_adapt_update_kernel<<<n / block_chains, threads, sizeof(float) * block_chains,
                                 static_cast<cudaStream_t>(stream)>>>(
      accept_prob, log_beta, beta_out, block_chains, gamma, target, lo, hi);
  return static_cast<int>(cudaGetLastError());
}

// The whole burn-in in one launch, for what pcn_adapt_group_takes (else
// cudaErrorNotSupported): chain->out the final positions, chain->acc the
// acceptance rates, beta (n,) the adapted beta per chain; gamma (n_steps,).
int ipx_fused_pcn_adapt_chain(const IpxGaussianSpec* pot, const IpxChainArgs* chain, float* beta,
                              const float* gamma, float target, float lo, float hi,
                              float log_beta0, float beta0, float inv_steps, void* stream) {
  const ipx::PcnAdaptGroupArgs a{*pot, *chain, beta, gamma, target, lo, hi,
                                 log_beta0, beta0, inv_steps};
  return ipx::launch_pcn_adapt_group(a, stream);
}

// The group kernel's launch: out (5,) = (G, warps a CTA, CTAs a cluster,
// CTAs, such clusters the card holds at once); cudaErrorNotSupported for
// what pcn_adapt_group_takes refuses.
int ipx_pcn_adapt_group_geometry(const IpxGaussianSpec* pot, const IpxChainArgs* chain,
                                 int* out) {
  ipx::PcnAdaptGroupGeometry geo;
  int status = ipx::pcn_adapt_group_geometry(*pot, *chain, &geo);
  if (status != cudaSuccess) return status;
  out[0] = geo.width;
  out[1] = geo.warps;
  out[2] = geo.cluster;
  out[3] = geo.ctas;
  ipx::ClusterGeometry cl = ipx::pcn_adapt_cluster(geo);
  cl.clusters = 1;  // the query's grid: one cluster
  cl.ctas = cl.g;
  constexpr int G2 = ipx::gaussian_group_width(2), G32 = ipx::gaussian_group_width(32);
  return static_cast<int>(
      chain->d == 2 ? ipx::max_active_clusters(ipx::fused_pcn_adapt_group_kernel<2, G2>, cl, &out[4])
                    : ipx::max_active_clusters(ipx::fused_pcn_adapt_group_kernel<32, G32>, cl,
                                               &out[4]));
}

}  // extern "C"
