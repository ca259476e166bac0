// Batched Darcy misfit as device functions run by one CTA per chain: the
// arithmetic of ip_mcmc_tpu/models/darcy.py make_batched_misfit (K5, l.542;
// with differentiable=True its adjoint phi_bwd, l.637; with
// solver="richardson" _richardson_flat, K17, l.401),
// make_batched_misfit_warm (K7, l.669) and make_batched_misfit_mala_warm
// (l.783) with _flat_transmissibilities l.337, _apply_operator_flat l.347,
// _operator_diagonal_flat l.357, _cg_flat l.363, _flat_dst_preconditioner
// l.445 and _flat_truncated_dst_preconditioner l.490.
//
// The solve comes in three parts, so that a second right-hand side can be
// solved on the same operator: darcy_setup (field, face transmissibilities,
// diagonal, mean coefficient), darcy_cg (fixed-count PCG on any right-hand
// side, from 0 or from a carried start) or darcy_richardson (fixed-omega
// preconditioned Richardson from 0), and darcy_observe (residuals at the
// observed cells and Phi). darcy_solve chains them for the misfit alone;
// darcy_value_and_grad adds the adjoint solve and the closed-form
// derivative of the harmonic means.
//
// Thread t of a CTA of T threads owns the cells t, t + T, ..., t + (C-1) T
// of the n x n grid (cells past n*n belong to no one). C, the cells per
// thread, is a compile-time parameter of every function here: 1 up to
// 16 x 16, more on the larger grids (DarcyPot's layouts below). Strided
// ownership keeps the reads of basis and V rows coalesced across a warp.
// The CG vectors x, r, z, p, Ap and each cell's face transmissibilities
// live in registers, C of each per thread. Shared memory holds what
// neighbours or reductions read: the search direction p (stencil), bf16(r)
// and the spectral coefficients (preconditioner), and the warp partial
// sums; a thread sums over its own cells before a block reduction. Every
// thread of the CTA calls these functions (cells it does not own contribute
// zeros), so every __syncthreads is reached by the whole block.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>

#include <cstdint>

#include "block_reduce.cuh"
#include "fused_scaffold.cuh"

extern "C" {
// Mirrored by ip_mcmc_tpu_torch/ops/_build.py MisfitSpec.
typedef struct {
  const float* basis;   // (K, n*n) scaled KL basis, f32
  const void* V;        // (modes, n*n) dst_trunc modes, bf16
  const float* lam;     // dst_trunc: (modes,) eigenvalues; dst: (n*n,) flat
  const void* S;        // dst: (n, n) sine matrix, bf16
  const float* source;  // (n*n,)
  const int* obs;       // (m,) observed cells
  const float* data;    // (m,)
  const float* noise;   // (m,) noise standard deviations
  int n, K, modes, cg_iters, m;
  int precond;  // kPrecondJacobi / kPrecondDstTrunc / kPrecondDst
  float log_a_mean;
  int solver;   // kSolverCg / kSolverRichardson
  float omega;  // Richardson's relaxation
} IpxMisfitSpec;
}

enum { kPrecondJacobi = 0, kPrecondDstTrunc = 1, kPrecondDst = 2 };
enum { kSolverCg = 0, kSolverRichardson = 1 };

namespace ipx {

struct MisfitSmem {
  float* cell_a;  // [cells]: a, then t_h, then p, then x; dst stages
  float* cell_b;  // [cells]: t_v, then bf16(r); dst stages
  float* modes;   // [modes]: bf16(V bf16(r) / (lam * a_bar))
  float* red;     // [32] warp partials
  float* scalar;  // [1] broadcast of the result
};

// Carves a MisfitSmem from `base`; returns the float count used.
__host__ __device__ inline int misfit_smem_floats(int cells, int modes) {
  return 2 * cells + modes + 33;
}

__device__ inline MisfitSmem carve_misfit_smem(float* base, int cells, int modes) {
  MisfitSmem ws;
  ws.cell_a = base;
  ws.cell_b = base + cells;
  ws.modes = base + 2 * cells;
  ws.red = base + 2 * cells + modes;
  ws.scalar = ws.red + 32;
  return ws;
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// The c-th cell of this thread.
__device__ __forceinline__ int own_cell(int c) { return threadIdx.x + c * blockDim.x; }

// Sums over this thread's cells, the first term first.
template <int C>
__device__ __forceinline__ float cells_sum(const float (&a)[C]) {
  float v = a[0];
#pragma unroll
  for (int c = 1; c < C; ++c) v += a[c];
  return v;
}
template <int C>
__device__ __forceinline__ float cells_dot(const float (&a)[C], const float (&b)[C]) {
  float v = a[0] * b[0];
#pragma unroll
  for (int c = 1; c < C; ++c) v += a[c] * b[c];
  return v;
}

// Dense fast-Poisson apply (precond "dst"): the 2-D sine transform along
// columns then rows, a divide by lam * a_bar, and the transposed transforms
// back; n multiply-adds per cell per stage. Inputs of every stage are
// rounded to bf16 (the four rounding points of _flat_dst_preconditioner's
// Kronecker matmuls), sums are f32. No Jacobi term.
template <int C>
__device__ void apply_dst(const IpxMisfitSpec& s, const float (&r)[C], float a_bar,
                          const MisfitSmem& ws, float (&z)[C]) {
  const int n = s.n;
  const __nv_bfloat16* S = static_cast<const __nv_bfloat16*>(s.S);
  bool own[C];
  int i[C], j[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int t = own_cell(c);
    own[c] = t < n * n;
    i[c] = own[c] ? t / n : 0;
    j[c] = own[c] ? t % n : 0;
    if (own[c]) ws.cell_b[t] = bf16_round(r[c]);
  }
  __syncthreads();
#pragma unroll
  for (int c = 0; c < C; ++c)
    if (own[c]) {  // y[i, k=j] = sum_q S[k, q] r[i, q]
      float acc = 0.0f;
      for (int q = 0; q < n; ++q)
        acc += __bfloat162float(S[j[c] * n + q]) * ws.cell_b[i[c] * n + q];
      ws.cell_a[own_cell(c)] = bf16_round(acc);
    }
  __syncthreads();
#pragma unroll
  for (int c = 0; c < C; ++c)
    if (own[c]) {  // rt[k1=i, k2=j] = sum_q S[k1, q] y[q, k2] / (lam a_bar)
      const int t = own_cell(c);
      float acc = 0.0f;
      for (int q = 0; q < n; ++q)
        acc += __bfloat162float(S[i[c] * n + q]) * ws.cell_a[q * n + j[c]];
      ws.cell_b[t] = bf16_round(acc / (s.lam[t] * a_bar));
    }
  __syncthreads();
#pragma unroll
  for (int c = 0; c < C; ++c)
    if (own[c]) {  // w[i, k2=j] = sum_q S[q, i] rt[q, k2]
      float acc = 0.0f;
      for (int q = 0; q < n; ++q)
        acc += __bfloat162float(S[q * n + i[c]]) * ws.cell_b[q * n + j[c]];
      ws.cell_a[own_cell(c)] = bf16_round(acc);
    }
  __syncthreads();
#pragma unroll
  for (int c = 0; c < C; ++c) {
    float acc = 0.0f;
    if (own[c])  // z[i, j] = sum_q S[q, j] w[i, q]
      for (int q = 0; q < n; ++q)
        acc += __bfloat162float(S[q * n + j[c]]) * ws.cell_a[i[c] * n + q];
    z[c] = acc;
  }
  __syncthreads();
}

// dst_trunc: M^-1 r = D^-1 r + V^T bf16(V bf16(r) / (lam a_bar)), bf16
// inputs, f32 accumulation; jacobi (modes == 0): D^-1 r; dst: apply_dst.
template <int C>
__device__ void apply_precond(const IpxMisfitSpec& s, const float (&r)[C],
                              const float (&inv_diag)[C], float a_bar, const MisfitSmem& ws,
                              float (&z)[C]) {
  if (s.precond == kPrecondDst) {
    apply_dst<C>(s, r, a_bar, ws, z);
    return;
  }
  const int cells = s.n * s.n;
#pragma unroll
  for (int c = 0; c < C; ++c) z[c] = inv_diag[c] * r[c];
  if (s.modes == 0) return;
  const __nv_bfloat16* V = static_cast<const __nv_bfloat16*>(s.V);
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int t = own_cell(c);
    if (t < cells) ws.cell_b[t] = bf16_round(r[c]);
  }
  __syncthreads();
  const int t = threadIdx.x, lane = t & 31, nw = blockDim.x >> 5;
  for (int m = t >> 5; m < s.modes; m += nw) {
    const __nv_bfloat16* row = V + static_cast<size_t>(m) * cells;
    float acc = 0.0f;
    for (int c = lane; c < cells; c += 32) acc += __bfloat162float(row[c]) * ws.cell_b[c];
    acc = warp_sum(acc);
    if (lane == 0) ws.modes[m] = bf16_round(acc / (s.lam[m] * a_bar));
  }
  __syncthreads();
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int cell = own_cell(c);
    if (cell < cells) {
      float acc = 0.0f;
      for (int m = 0; m < s.modes; ++m)
        acc += __bfloat162float(V[static_cast<size_t>(m) * cells + cell]) * ws.modes[m];
      z[c] = z[c] + acc;
    }
  }
}

// The cell's stencil coefficients: faces right (th), left (th_l), below
// (tv), above (tv_u) and the Dirichlet boundary term (bnd).
struct CellStencil {
  float th, th_l, tv, tv_u, bnd;
};

// One chain's operator A(a): what darcy_setup leaves in this thread's
// registers for the solves that follow, per cell the thread owns.
template <int C>
struct DarcyOperator {
  CellStencil k[C];
  float a[C], inv_diag[C];
  float a_bar;
  int i[C], j[C];
  bool own[C];  // own_cell(c) < n*n
};

// (A p) on this thread's cells with p handed round through shared memory.
// The caller's next write to cell_a must come after a later barrier (a
// block_sum has two).
template <int C>
__device__ __forceinline__ void apply_operator(const DarcyOperator<C>& op, const float (&p)[C],
                                               int n, const MisfitSmem& ws, float (&Ap)[C]) {
#pragma unroll
  for (int c = 0; c < C; ++c)
    if (op.own[c]) ws.cell_a[own_cell(c)] = p[c];
  __syncthreads();
#pragma unroll
  for (int c = 0; c < C; ++c) {
    Ap[c] = 0.0f;
    if (op.own[c]) {
      const int t = own_cell(c), i = op.i[c], j = op.j[c];
      const CellStencil& k = op.k[c];
      const float pr = j < n - 1 ? ws.cell_a[t + 1] : 0.0f;
      const float pd = i < n - 1 ? ws.cell_a[t + n] : 0.0f;
      const float pl = j > 0 ? ws.cell_a[t - 1] : 0.0f;
      const float pu = i > 0 ? ws.cell_a[t - n] : 0.0f;
      Ap[c] = k.th * (p[c] - pr) - k.th_l * (pl - p[c]) + k.tv * (p[c] - pd) -
              k.tv_u * (pu - p[c]) + k.bnd * p[c];
    }
  }
}

// a = exp(log_a_mean + basis^T u) for the chain whose coefficients u[0..K)
// sit in shared memory, the stencil of each of this thread's cells, the
// inverse diagonal and the geometric-mean coefficient a_bar.
template <int C>
__device__ DarcyOperator<C> darcy_setup(const IpxMisfitSpec& s, const float* u,
                                        const MisfitSmem& ws) {
  const int n = s.n, cells = n * n;
  const float h2 = static_cast<float>(cells);
  DarcyOperator<C> op;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int t = own_cell(c);
    op.own[c] = t < cells;
    op.i[c] = op.own[c] ? t / n : 0;
    op.j[c] = op.own[c] ? t % n : 0;
  }

  // KL reconstruction log a = log_a_mean + basis^T u, and a = exp(log a)
#pragma unroll
  for (int c = 0; c < C; ++c) {
    op.a[c] = 1.0f;
    if (op.own[c]) {
      const int t = own_cell(c);
      float acc = 0.0f;
      for (int k = 0; k < s.K; ++k) acc += s.basis[static_cast<size_t>(k) * cells + t] * u[k];
      op.a[c] = expf(s.log_a_mean + acc);
      ws.cell_a[t] = op.a[c];
    }
  }
  __syncthreads();
  // harmonic-mean transmissibilities of the faces right of and below the cell
#pragma unroll
  for (int c = 0; c < C; ++c) {
    CellStencil k{0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    if (op.own[c]) {
      const int t = own_cell(c);
      const float a = op.a[c];
      if (op.j[c] < n - 1) {
        const float ar = ws.cell_a[t + 1];
        k.th = 2.0f * a * ar / (a + ar + 1e-38f) * h2;
      }
      if (op.i[c] < n - 1) {
        const float ad = ws.cell_a[t + n];
        k.tv = 2.0f * a * ad / (a + ad + 1e-38f) * h2;
      }
    }
    op.k[c] = k;
  }
  __syncthreads();
#pragma unroll
  for (int c = 0; c < C; ++c)
    if (op.own[c]) {
      ws.cell_a[own_cell(c)] = op.k[c].th;
      ws.cell_b[own_cell(c)] = op.k[c].tv;
    }
  __syncthreads();
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int t = own_cell(c), i = op.i[c], j = op.j[c];
    CellStencil& k = op.k[c];
    if (op.own[c]) {
      if (j > 0) k.th_l = ws.cell_a[t - 1];
      if (i > 0) k.tv_u = ws.cell_b[t - n];
    }
    // Dirichlet faces at half-cell distance: 2 h^-2 a per boundary side
    const float edge = static_cast<float>((i == 0) + (i == n - 1) + (j == 0) + (j == n - 1));
    k.bnd = 2.0f * h2 * op.a[c] * edge;
    op.inv_diag[c] = op.own[c] ? 1.0f / (k.th + k.th_l + k.tv + k.tv_u + k.bnd) : 0.0f;
  }
  float log_a[C];
#pragma unroll
  for (int c = 0; c < C; ++c) log_a[c] = op.own[c] ? logf(op.a[c]) : 0.0f;
  op.a_bar = expf(block_sum(cells_sum<C>(log_a), ws.red) / h2);
  return op;
}

// Fixed-count PCG on A x = b, b being this thread's cells of the right-hand
// side. WARM: starts from this thread's cells of a previous solution,
// passed in x (r = b - A x0); otherwise from 0. On return x holds this
// thread's cells of the solution. alpha = 0 when pAp <= 0 and beta = 0
// when rz <= 0, so a converged solve freezes instead of producing NaN.
template <bool WARM, int C>
__device__ void darcy_cg(const IpxMisfitSpec& s, const DarcyOperator<C>& op, const float (&b)[C],
                         const MisfitSmem& ws, float (&x)[C]) {
  const int n = s.n;
  float r[C], z[C], p[C], Ap[C];
#pragma unroll
  for (int c = 0; c < C; ++c) r[c] = b[c];
  if (WARM) {
#pragma unroll
    for (int c = 0; c < C; ++c)
      if (!op.own[c]) x[c] = 0.0f;
    apply_operator<C>(op, x, n, ws, Ap);
#pragma unroll
    for (int c = 0; c < C; ++c) r[c] = r[c] - Ap[c];
    __syncthreads();  // the stencil's reads end before the preconditioner writes
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) x[c] = 0.0f;
  }
  apply_precond<C>(s, r, op.inv_diag, op.a_bar, ws, z);
#pragma unroll
  for (int c = 0; c < C; ++c) p[c] = z[c];
  float rz = block_sum(cells_dot<C>(r, z), ws.red);
  for (int it = 0; it < s.cg_iters; ++it) {
    apply_operator<C>(op, p, n, ws, Ap);
    const float pAp = block_sum(cells_dot<C>(p, Ap), ws.red);
    const float alpha = pAp > 0.0f ? rz / pAp : 0.0f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      x[c] = x[c] + alpha * p[c];
      r[c] = r[c] - alpha * Ap[c];
    }
    apply_precond<C>(s, r, op.inv_diag, op.a_bar, ws, z);
    const float rz_new = block_sum(cells_dot<C>(r, z), ws.red);
    const float beta = rz > 0.0f ? rz_new / rz : 0.0f;
#pragma unroll
    for (int c = 0; c < C; ++c) p[c] = z[c] + beta * p[c];
    rz = rz_new;
  }
}

// K17: fixed-omega preconditioned Richardson on A x = b from 0:
// x_1 = omega M^-1 b, then cg_iters - 1 updates x <- x + omega M^-1 (b - A x)
// (cg_iters <= 1 leaves x_1). No dot products, so nothing reduces but the
// preconditioner's own products, and no guards: the iteration divides by
// nothing. With no block_sum inside the loop, the barrier after the stencil
// is the one that lets the next write to cell_a (the next stencil, or
// darcy_observe) and to cell_b (dst_trunc) follow its neighbour reads.
template <int C>
__device__ void darcy_richardson(const IpxMisfitSpec& s, const DarcyOperator<C>& op,
                                 const float (&b)[C], const MisfitSmem& ws, float (&x)[C]) {
  const float omega = s.omega;
  float z[C];
  apply_precond<C>(s, b, op.inv_diag, op.a_bar, ws, z);
#pragma unroll
  for (int c = 0; c < C; ++c) x[c] = omega * z[c];
  for (int it = 1; it < s.cg_iters; ++it) {
    float r[C];
    apply_operator<C>(op, x, s.n, ws, r);
    __syncthreads();
#pragma unroll
    for (int c = 0; c < C; ++c) r[c] = b[c] - r[c];
    apply_precond<C>(s, r, op.inv_diag, op.a_bar, ws, z);
#pragma unroll
    for (int c = 0; c < C; ++c) x[c] = x[c] + omega * z[c];
  }
}

// Pressure at the observed cells and Phi = 1/2 ||(y - pred) / sigma||^2,
// the same value in every thread. The residuals (y - pred) / sigma go to
// res[0..m) in shared memory when res is given.
template <int C>
__device__ float darcy_observe(const IpxMisfitSpec& s, const float (&x)[C], const bool (&own)[C],
                               const MisfitSmem& ws, float* res_out) {
  const int t = threadIdx.x;
#pragma unroll
  for (int c = 0; c < C; ++c)
    if (own[c]) ws.cell_a[own_cell(c)] = x[c];
  __syncthreads();
  if (t < 32) {
    float acc = 0.0f;
    for (int o = t; o < s.m; o += 32) {
      const float res = (s.data[o] - ws.cell_a[s.obs[o]]) / s.noise[o];
      if (res_out != nullptr) res_out[o] = res;
      acc += res * res;
    }
    acc = warp_sum(acc);
    if (t == 0) ws.scalar[0] = 0.5f * acc;
  }
  __syncthreads();
  return ws.scalar[0];
}

// Phi(u) for the chain whose coefficients u[0..K) sit in shared memory;
// the same value in every thread. WARM (CG only): the solve starts from
// this thread's cells of the previous solution, passed in x; otherwise
// from 0. On return x holds this thread's cells of the solution.
template <bool WARM, int C = 1, int SOLVER = kSolverCg>
__device__ float darcy_solve(const IpxMisfitSpec& s, const float* u, const MisfitSmem& ws,
                             float (&x)[C]) {
  static_assert(!WARM || SOLVER == kSolverCg, "a warm start is a CG start");
  const DarcyOperator<C> op = darcy_setup<C>(s, u, ws);
  float b[C];
#pragma unroll
  for (int c = 0; c < C; ++c) b[c] = op.own[c] ? s.source[own_cell(c)] : 0.0f;
  if constexpr (SOLVER == kSolverRichardson) darcy_richardson<C>(s, op, b, ws, x);
  else darcy_cg<WARM, C>(s, op, b, ws, x);
  return darcy_observe<C>(s, x, op.own, ws, nullptr);
}

// The cold misfit (K5; K17 with SOLVER kSolverRichardson): Phi(u) from a
// zero start.
template <int C = 1, int SOLVER = kSolverCg>
__device__ __forceinline__ float darcy_phi(const IpxMisfitSpec& s, const float* u,
                                           const MisfitSmem& ws) {
  float x[C];
  return darcy_solve<false, C, SOLVER>(s, u, ws, x);
}

// What the gradient keeps in shared memory beside the misfit's workspace:
// the field a, the forward solution x and the adjoint solution lam, where
// neighbours read them, and the residuals at the observed cells.
struct GradSmem {
  float* a;    // [cells]
  float* x;    // [cells] WARM: the start on entry; the solution on return
  float* lam;  // [cells] likewise for the adjoint solve
  float* res;  // [m]
};

__host__ __device__ inline int grad_smem_floats(int cells, int m) { return 3 * cells + m; }

__device__ inline GradSmem carve_grad_smem(float* base, int cells) {
  return GradSmem{base, base + cells, base + 2 * cells, base + 3 * cells};
}

// Phi(u) and its gradient g[0..K) (shared memory, valid in every thread on
// return) by the adjoint method: forward solve, adjoint solve
// A lam = -O^T(res / sigma) on the same operator and preconditioner, then
// dPhi/da per cell from x, lam and the harmonic means' closed-form
// derivative dt/da_i = 2 h^-2 (a_j / (a_i + a_j))^2 over the cell's four
// faces plus the Dirichlet term, and g = basis (a (-dPhi/da)). WARM: both
// solves start from gs.x / gs.lam (thread t's own cell, written by thread
// t before the call); the solutions are left there either way. One cell a
// thread (grids up to 32 x 32).
template <bool WARM>
__device__ float darcy_value_and_grad(const IpxMisfitSpec& s, const float* u,
                                      const MisfitSmem& ws, const GradSmem& gs, float* g) {
  const int t = threadIdx.x, n = s.n, cells = n * n;
  const DarcyOperator<1> op = darcy_setup<1>(s, u, ws);
  const bool own = op.own[0];
  const int i = op.i[0], j = op.j[0];
  if (own) gs.a[t] = op.a[0];

  float x[1] = {(WARM && own) ? gs.x[t] : 0.0f};
  const float src[1] = {own ? s.source[t] : 0.0f};
  darcy_cg<WARM, 1>(s, op, src, ws, x);
  const float phi = darcy_observe<1>(s, x, op.own, ws, gs.res);
  if (own) gs.x[t] = x[0];

  // dPhi/dx = -O^T(res / sigma): a scatter to the observed cells
  float b[1] = {0.0f};
  if (own) {
    for (int o = 0; o < s.m; ++o)
      if (s.obs[o] == t) b[0] += gs.res[o] / s.noise[o];
    b[0] = -b[0];
  }
  float lam[1] = {(WARM && own) ? gs.lam[t] : 0.0f};
  darcy_cg<WARM, 1>(s, op, b, ws, lam);
  if (own) gs.lam[t] = lam[0];
  __syncthreads();

  if (own) {
    const float two_h2 = 2.0f * static_cast<float>(cells);
    const float a = gs.a[t], xc = gs.x[t], lc = lam[0];
    float t_r = 0.0f, t_l = 0.0f, t_d = 0.0f, t_u = 0.0f;
    if (j < n - 1) {  // the face to the right: this cell's own share
      const float ar = gs.a[t + 1], den = 1.0f / (a + ar + 1e-38f), q = ar * den;
      t_r = two_h2 * (q * q) * ((xc - gs.x[t + 1]) * (lc - gs.lam[t + 1]));
    }
    if (j > 0) {  // the left neighbour's right face: the neighbour share
      const float al = gs.a[t - 1], den = 1.0f / (al + a + 1e-38f), q = al * den;
      t_l = two_h2 * (q * q) * ((gs.x[t - 1] - xc) * (gs.lam[t - 1] - lc));
    }
    if (i < n - 1) {
      const float ad = gs.a[t + n], den = 1.0f / (a + ad + 1e-38f), q = ad * den;
      t_d = two_h2 * (q * q) * ((xc - gs.x[t + n]) * (lc - gs.lam[t + n]));
    }
    if (i > 0) {
      const float au = gs.a[t - n], den = 1.0f / (au + a + 1e-38f), q = au * den;
      t_u = two_h2 * (q * q) * ((gs.x[t - n] - xc) * (gs.lam[t - n] - lc));
    }
    const float edge = static_cast<float>((i == 0) + (i == n - 1) + (j == 0) + (j == n - 1));
    const float g_a = t_r + t_l + t_d + t_u + two_h2 * xc * lc * edge;
    ws.cell_a[t] = a * (-g_a);  // chain rule through a = exp(log a)
  }
  __syncthreads();
  // g[k] = sum_cells basis[k, cell] (a (-g_a))[cell]: a warp per mode
  const int lane = t & 31, nw = blockDim.x >> 5;
  for (int k = t >> 5; k < s.K; k += nw) {
    const float* row = s.basis + static_cast<size_t>(k) * cells;
    float acc = 0.0f;
    for (int c = lane; c < cells; c += 32) acc += row[c] * ws.cell_a[c];
    acc = warp_sum(acc);
    if (lane == 0) g[k] = acc;
  }
  __syncthreads();
  return phi;
}

// The CTA layouts of the Darcy kernels, by the largest grid they take:
// cells per thread (kCells), threads (kThreads) and the least CTAs per SM
// of the launch bound (kMinCtas), which caps the registers of a thread at
// 65536 / (kThreads kMinCtas). Up to 16 x 16: one thread per cell, 256
// threads, 4 CTAs per SM (64 registers). The larger grids keep about a
// dozen floats of CG state per cell in registers (x, r, z, p, Ap, five
// stencil terms, the inverse diagonal), so their layouts trade cells per
// thread against the register cap. Their solves wait on L2 (the basis and
// the modes are re-read by every chain), and measured on the H100 on the
// one-chain-a-CTA warm pCN kernels (PERF.md; the warm pCN now runs in
// thread-block clusters above 16 x 16) the layouts with the most warps
// per SM win even where they spill: 32 x 32 one cell a thread at 1024
// threads (64 registers), 64 x 64 eight cells a thread at 512 threads and
// 2 CTAs per SM (64 registers, spilling) before 8 x 512 x 1 (128 registers).
struct Layout16 {
  static constexpr int kCells = 1, kThreads = 256, kMinCtas = 4;
};
struct Layout32 {
  static constexpr int kCells = 1, kThreads = 1024, kMinCtas = 1;
};
struct Layout64 {
  static constexpr int kCells = 8, kThreads = 512, kMinCtas = 2;
};

// The Darcy misfit as the potential type of the samplers that take one
// (DaStep, PcnStep, RwmStep): what a step needs to know of a potential.
// Layout: the CTA (above); SOLVER: the solve of phi (CG, or K17's
// Richardson for a surrogate).
template <class Layout, int SOLVER = kSolverCg>
struct DarcyPot {
  using Spec = IpxMisfitSpec;
  using Workspace = MisfitSmem;
  static constexpr int kCellsPerThread = Layout::kCells;
  static constexpr int kMaxThreads = Layout::kThreads;
  static constexpr int kMinCtasPerSm = Layout::kMinCtas;
  static constexpr int kMaxCells = kCellsPerThread * kMaxThreads;

  // What a workspace must hold; one workspace serves every spec it was
  // joined over.
  struct Extent {
    int cells, modes;
  };
  static __host__ __device__ __forceinline__ Extent extent(const Spec& s) {
    return {s.n * s.n, s.modes};
  }
  static __host__ __device__ __forceinline__ Extent join(Extent a, Extent b) {
    return {a.cells > b.cells ? a.cells : b.cells, a.modes > b.modes ? a.modes : b.modes};
  }
  static __host__ __device__ __forceinline__ int workspace_floats(Extent e) {
    return misfit_smem_floats(e.cells, e.modes);
  }
  static __device__ __forceinline__ Workspace carve(float* base, Extent e) {
    return carve_misfit_smem(base, e.cells, e.modes);
  }
  static bool valid(const Spec& s) {
    return s.K > 0 && s.modes >= 0 && s.n > 0 && s.n * s.n <= kMaxCells && s.solver == SOLVER;
  }

  static __device__ __forceinline__ float phi(const Spec& s, const float* u,
                                              const Workspace& ws) {
    return darcy_phi<kCellsPerThread, SOLVER>(s, u, ws);
  }

};

using DarcyPotential = DarcyPot<Layout16>;

// The layout of a surrogate solved in the CTA of an exact level whose
// layout is Exact (the one-chain-a-CTA DA kernel runs both levels in one
// CTA): Exact's threads and CTAs per SM, and as many cells a thread as the
// surrogate's N x N grid needs on them.
template <class Exact, int N>
struct SurrogateLayout {
  static constexpr int kThreads = Exact::kThreads, kMinCtas = Exact::kMinCtas;
  static constexpr int kCells = (N * N + kThreads - 1) / kThreads;
};

// A spec that a one-chain-a-CTA sampler takes where its Hopper design
// leaves it: an n x n grid of up to max_cells cells, K = d up to max_d (a
// thread a coordinate), a preconditioner the solve knows (Jacobi or dense
// dst with no modes, dst_trunc with some), solved by `solver`. Mirrored by
// ip_mcmc_tpu_torch/ops/_scaffold.py cta_spec.
inline bool darcy_cta_spec(const IpxMisfitSpec& s, int d, int max_cells, int max_d,
                           int solver = kSolverCg) {
  const bool precond = s.precond == kPrecondDstTrunc
                           ? s.modes > 0
                           : (s.precond == kPrecondJacobi || s.precond == kPrecondDst) &&
                                 s.modes == 0;
  return s.n > 0 && s.n * s.n <= max_cells && s.K == d && d > 0 && d <= max_d && precond &&
         s.solver == solver && s.m >= 0;
}

// The threads of the layout that with_darcy_layout picks for a grid of
// `cells` cells: the most coordinates a one-chain-a-CTA sampler on it takes.
inline int darcy_layout_threads(int cells) {
  if (cells <= DarcyPot<Layout16>::kMaxCells) return Layout16::kThreads;
  return cells <= DarcyPot<Layout32>::kMaxCells ? Layout32::kThreads : Layout64::kThreads;
}

// Calls f(Pot{}) with the Darcy potential type whose layout takes the n x n
// grid of `s` (the smallest that does) and whose solver is SOLVER; the
// launchers refuse what no layout takes (Pot::valid).
template <int SOLVER, class F>
int with_darcy_layout(const IpxMisfitSpec& s, F&& f) {
  const int cells = s.n * s.n;
  if (cells <= DarcyPot<Layout16, SOLVER>::kMaxCells) return f(DarcyPot<Layout16, SOLVER>{});
  if (cells <= DarcyPot<Layout32, SOLVER>::kMaxCells) return f(DarcyPot<Layout32, SOLVER>{});
  return f(DarcyPot<Layout64, SOLVER>{});
}

// --- one chain a warp: the 16 x 16 delayed-acceptance kernel ----------------
//
// The functions below run the same arithmetic for one chain on one warp
// of a CTA that holds several chains. Lane l owns the cells l, l + 32,
// ... of the N x N grid: C = N^2 / 32 of them (8 x 8: 2; 16 x 16: 8), so
// every lane owns C cells and no cell is left over. Dot products are
// warp_sum; neighbours are read from the warp's own slice of shared memory
// (WarpSmem) after __syncwarp. The stencil's face terms stay in that slice,
// so that at 16 x 16 a lane keeps in registers only x, r, z, p and Ap, the
// boundary term and the inverse diagonal of its 8 cells. The dst_trunc
// preconditioner's two products run over all the CTA's chains at once, as
// bf16 tensor-core products with f32 accumulation (apply_precond_cta): every
// warp of the CTA calls the solves together, with the same iteration
// counts, so each of their CTA barriers is reached by every warp.

struct WarpSmem {
  float* p;   // [N^2] a during the set-up; then the vector the stencil reads
  float* th;  // [N^2] transmissibility of the face right of each cell
  float* tv;  // [N^2] ... of the face below it
};

// The CTA's exchange for the preconditioner's products: a row per chain
// (rows: the chains of the CTA rounded up to the 8 columns of an mma
// tile), strides of 4 words mod 32 so that the eight rows of a fragment
// load fall in distinct banks. Sized for up to 256 cells and modes.
constexpr int kXRbStride = 264, kXCbStride = 264, kXBackStride = 260;
struct PrecondXchg {
  __nv_bfloat16* rb;  // [rows][kXRbStride]: bf16(r)
  __nv_bfloat16* cb;  // [rows][kXCbStride]: bf16(V bf16(r) / (lam a_bar))
  float* back;        // [rows][kXBackStride]: V^T cb
  float* abar;        // [rows]: each chain's a_bar
};

__host__ __device__ inline size_t xchg_bytes(int rows) {
  return static_cast<size_t>(rows) *
         (sizeof(__nv_bfloat16) * (kXRbStride + kXCbStride) + sizeof(float) * (kXBackStride + 1));
}

__device__ inline PrecondXchg carve_xchg(unsigned char* base, int rows) {
  PrecondXchg x;
  x.rb = reinterpret_cast<__nv_bfloat16*>(base);
  x.cb = x.rb + rows * kXRbStride;
  x.back = reinterpret_cast<float*>(x.cb + rows * kXCbStride);
  x.abar = x.back + rows * kXBackStride;
  return x;
}

// A level's factors as a warp-level solve reads them: staged in shared
// memory (SHARED; V's rows padded to cells + 8 elements, so that the eight
// 16-byte rows of an ldmatrix fall in distinct banks) or in global memory,
// read through L2.
template <bool SHARED>
struct WarpFactors {
  const float* basis;        // (64, cells)
  const __nv_bfloat16* V;    // (modes, v_stride)
  const float* lam;          // (modes,)
  int v_stride;
};

// Bytes of a level's staged factors, a multiple of 16.
__host__ __device__ inline size_t warp_staged_bytes(const IpxMisfitSpec& s) {
  const size_t cells = static_cast<size_t>(s.n) * s.n;
  const size_t b = sizeof(float) * (s.K * cells + s.modes) +
                   sizeof(__nv_bfloat16) * s.modes * (cells + 8);
  return (b + 15) / 16 * 16;
}

__device__ inline WarpFactors<false> global_factors(const IpxMisfitSpec& s) {
  return {s.basis, static_cast<const __nv_bfloat16*>(s.V), s.lam, s.n * s.n};
}

// Copies the factors of `s` to `base` (every thread of the CTA calls; a
// barrier must follow before they are read).
__device__ inline WarpFactors<true> stage_factors(const IpxMisfitSpec& s, unsigned char* base) {
  const int cells = s.n * s.n, stride = cells + 8;
  __nv_bfloat16* V = reinterpret_cast<__nv_bfloat16*>(base);
  float* basis = reinterpret_cast<float*>(V + s.modes * stride);
  float* lam = basis + s.K * cells;
  const __nv_bfloat16* gV = static_cast<const __nv_bfloat16*>(s.V);
  for (int e = threadIdx.x; e < s.modes * cells; e += blockDim.x)
    V[(e / cells) * stride + e % cells] = gV[e];
  for (int e = threadIdx.x; e < s.K * cells; e += blockDim.x) basis[e] = s.basis[e];
  for (int e = threadIdx.x; e < s.modes; e += blockDim.x) lam[e] = s.lam[e];
  return {basis, V, lam, stride};
}

// A level's factors where SHARED says: staged at `base`, or in global memory.
template <bool SHARED>
__device__ inline WarpFactors<SHARED> level_factors(const IpxMisfitSpec& s, unsigned char* base) {
  if constexpr (SHARED) return stage_factors(s, base);
  else return global_factors(s);
}

// m16n8k16 bf16 x bf16 + f32 on the tensor cores: d += a b (A row-major
// 16 x 16, B 16 x 8 "col"; PTX ISA fragment layouts: with g = lane / 4 and
// t = lane % 4, a holds A[g][2t..], A[g+8][2t..], A[g][2t+8..],
// A[g+8][2t+8..]; b holds B[2t..][g], B[2t+8..][g]; d holds D[g][2t],
// D[g][2t+1], D[g+8][2t], D[g+8][2t+1]).
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Eight bf16 values (a 16-byte load) as floats, in memory order.
__device__ __forceinline__ void unpack_bf16x8(const uint4& q, float (&v)[8]) {
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint32_t pack_pair(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// The A fragment of V's tile (modes m0.., cells k0..): A[i][k] = V[m0+i][k0+k].
template <bool SHARED>
__device__ __forceinline__ void load_a_v(uint32_t (&a)[4], const __nv_bfloat16* V, int stride,
                                         int m0, int k0) {
  const int l = threadIdx.x & 31;
  if constexpr (SHARED) {
    const int q = l >> 3;  // 8x8 matrix q: rows (q & 1) * 8, columns (q >> 1) * 8
    ldmatrix_x4(a, V + (m0 + (q & 1) * 8 + (l & 7)) * stride + k0 + (q >> 1) * 8);
  } else {
    const __nv_bfloat16* p = V + (m0 + (l >> 2)) * stride + k0 + 2 * (l & 3);
    a[0] = ld_pair(p);
    a[1] = ld_pair(p + 8 * stride);
    a[2] = ld_pair(p + 8);
    a[3] = ld_pair(p + 8 * stride + 8);
  }
}

// The A fragment of V^T's tile (cells c0.., modes k0..): A[i][k] = V[k0+k][c0+i].
template <bool SHARED>
__device__ __forceinline__ void load_a_vt(uint32_t (&a)[4], const __nv_bfloat16* V, int stride,
                                          int c0, int k0) {
  const int l = threadIdx.x & 31;
  if constexpr (SHARED) {
    const int q = l >> 3;  // the stored rows are modes, the columns cells
    ldmatrix_x4_trans(a, V + (k0 + (q >> 1) * 8 + (l & 7)) * stride + c0 + (q & 1) * 8);
  } else {
    const __nv_bfloat16* p = V + (k0 + 2 * (l & 3)) * stride + c0 + (l >> 2);
    a[0] = pack_pair(p[0], p[stride]);
    a[1] = pack_pair(p[8], p[stride + 8]);
    a[2] = pack_pair(p[8 * stride], p[9 * stride]);
    a[3] = pack_pair(p[8 * stride + 8], p[9 * stride + 8]);
  }
}

template <int C>
__device__ __forceinline__ float lane_dot(const float (&a)[C], const float (&b)[C]) {
  float v = a[0] * b[0];
#pragma unroll
  for (int c = 1; c < C; ++c) v += a[c] * b[c];
  return v;
}

// One level of the warp-level solve: its spec, its factors, the CTA's
// exchange and the warp's workspace. N: the grid side (8 or 16); NT: mma
// tiles of 8 chains the CTA's chains take; MMA: the preconditioner's
// products on the tensor cores (else as f32 loops on the CUDA cores, the
// same roundings).
template <int N, int NT, bool SHARED, bool MMA>
struct WarpLevel {
  static constexpr int kN = N, kCells = N * N, kC = N * N / 32;
  static constexpr bool kShared = SHARED;
  static_assert(kCells % 32 == 0 && kCells <= 256, "every lane owns N^2 / 32 cells");
  const IpxMisfitSpec* s;
  WarpFactors<SHARED> f;
  PrecondXchg xg;
  WarpSmem ws;

  // z = D^-1 r + V^T bf16(V bf16(r) / (lam a_bar)) for the CTA's chains at
  // once (dst_trunc), z = D^-1 r with no modes (Jacobi). Every warp of the
  // CTA calls; three CTA barriers.
  __device__ void precond(const float (&r)[kC], const float (&inv_diag)[kC],
                          float (&z)[kC]) const {
#pragma unroll
    for (int c = 0; c < kC; ++c) z[c] = inv_diag[c] * r[c];
    const int modes = s->modes;
    if (modes == 0) return;
    const int l = threadIdx.x & 31, w = threadIdx.x >> 5, nw = blockDim.x >> 5;
    const int g = l >> 2, t = l & 3;
#pragma unroll
    for (int c = 0; c < kC; ++c) xg.rb[w * kXRbStride + l + 32 * c] = __float2bfloat16(r[c]);
    __syncthreads();
    // coef[m][ch] = sum_cell V[m][cell] bf16(r)[ch][cell]; M modes, N chains
    if constexpr (MMA) {
      for (int mt = w; mt < modes / 16; mt += nw) {
        float acc[NT][4] = {};
#pragma unroll 4
        for (int k0 = 0; k0 < kCells; k0 += 16) {
          uint32_t a[4];
          load_a_v<SHARED>(a, f.V, f.v_stride, mt * 16, k0);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const __nv_bfloat16* b = xg.rb + (nt * 8 + g) * kXRbStride + k0 + 2 * t;
            mma_16816(acc[nt], a, ld_pair(b), ld_pair(b + 8));
          }
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int m = mt * 16 + g + 8 * (e >> 1), ch = nt * 8 + 2 * t + (e & 1);
            if (ch < nw)
              xg.cb[ch * kXCbStride + m] = __float2bfloat16(acc[nt][e] / (f.lam[m] * xg.abar[ch]));
          }
      }
    } else {
      for (int e = threadIdx.x; e < modes * nw; e += blockDim.x) {
        const int m = e % modes, ch = e / modes;
        float acc = 0.0f;
        for (int q = 0; q < kCells; ++q)
          acc += __bfloat162float(f.V[m * f.v_stride + q]) *
                 __bfloat162float(xg.rb[ch * kXRbStride + q]);
        xg.cb[ch * kXCbStride + m] = __float2bfloat16(acc / (f.lam[m] * xg.abar[ch]));
      }
    }
    __syncthreads();
    // back[cell][ch] = sum_m V[m][cell] coef[m][ch]; M cells, N chains
    if constexpr (MMA) {
      for (int mt = w; mt < kCells / 16; mt += nw) {
        float acc[NT][4] = {};
#pragma unroll 4
        for (int k0 = 0; k0 < modes; k0 += 16) {
          uint32_t a[4];
          load_a_vt<SHARED>(a, f.V, f.v_stride, mt * 16, k0);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const __nv_bfloat16* b = xg.cb + (nt * 8 + g) * kXCbStride + k0 + 2 * t;
            mma_16816(acc[nt], a, ld_pair(b), ld_pair(b + 8));
          }
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int cell = mt * 16 + g + 8 * (e >> 1), ch = nt * 8 + 2 * t + (e & 1);
            if (ch < nw) xg.back[ch * kXBackStride + cell] = acc[nt][e];
          }
      }
    } else {
      for (int e = threadIdx.x; e < kCells * nw; e += blockDim.x) {
        const int cell = e % kCells, ch = e / kCells;
        float acc = 0.0f;
        for (int m = 0; m < modes; ++m)
          acc += __bfloat162float(f.V[m * f.v_stride + cell]) *
                 __bfloat162float(xg.cb[ch * kXCbStride + m]);
        xg.back[ch * kXBackStride + cell] = acc;
      }
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < kC; ++c) z[c] = z[c] + xg.back[w * kXBackStride + l + 32 * c];
  }

  // a dot product over the warp's cells: the lane's own sum first
  __device__ static float dot(const float (&a)[kC], const float (&b)[kC]) {
    return warp_sum(lane_dot<kC>(a, b));
  }
};

// One chain's operator on a warp: what lies in registers (the face terms
// lie in WarpSmem::th, tv).
template <int C>
struct WarpOperator {
  float bnd[C], inv_diag[C];
  float a_bar;
};

// (A p) on the lane's cells, p handed round through the warp's slice.
template <class L>
__device__ __forceinline__ void apply_operator_warp(const L& lv, const WarpOperator<L::kC>& op,
                                                    const float (&p)[L::kC],
                                                    float (&Ap)[L::kC]) {
  constexpr int n = L::kN;
  const int l = threadIdx.x & 31;
  const WarpSmem& ws = lv.ws;
#pragma unroll
  for (int c = 0; c < L::kC; ++c) ws.p[l + 32 * c] = p[c];
  __syncwarp();
#pragma unroll
  for (int c = 0; c < L::kC; ++c) {
    const int t = l + 32 * c, i = t / n, j = t % n;
    const float pr = j < n - 1 ? ws.p[t + 1] : 0.0f;
    const float pd = i < n - 1 ? ws.p[t + n] : 0.0f;
    const float pl = j > 0 ? ws.p[t - 1] : 0.0f;
    const float pu = i > 0 ? ws.p[t - n] : 0.0f;
    const float th_l = j > 0 ? ws.th[t - 1] : 0.0f;
    const float tv_u = i > 0 ? ws.tv[t - n] : 0.0f;
    Ap[c] = ws.th[t] * (p[c] - pr) - th_l * (pl - p[c]) + ws.tv[t] * (p[c] - pd) -
            tv_u * (pu - p[c]) + op.bnd[c] * p[c];
  }
  __syncwarp();  // the reads end before the next write to p
}

// a = exp(log_a_mean + basis^T u) for the chain whose 64 coefficients sit
// in the warp's u[0..64), the face terms (to ws.th, ws.tv), the boundary
// terms, the inverse diagonal and a_bar (also to the exchange's abar row of
// this warp, for the preconditioner).
template <class L>
__device__ WarpOperator<L::kC> darcy_setup_warp(const L& lv, const float* u) {
  constexpr int n = L::kN, C = L::kC, cells = L::kCells, K = 64;
  const float h2 = static_cast<float>(cells);
  const int l = threadIdx.x & 31;
  const WarpSmem& ws = lv.ws;
  WarpOperator<C> op;
  if constexpr (L::kShared) __builtin_assume(__isShared(lv.f.basis));
  float a[C], acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.0f;
#pragma unroll 8
  for (int k = 0; k < K; ++k) {
    const float uk = u[k];
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] += lv.f.basis[k * cells + l + 32 * c] * uk;
  }
#pragma unroll
  for (int c = 0; c < C; ++c) {
    a[c] = expf(lv.s->log_a_mean + acc[c]);
    ws.p[l + 32 * c] = a[c];
  }
  __syncwarp();
  float th[C], tv[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int t = l + 32 * c, i = t / n, j = t % n;
    th[c] = 0.0f;
    tv[c] = 0.0f;
    if (j < n - 1) {
      const float ar = ws.p[t + 1];
      th[c] = 2.0f * a[c] * ar / (a[c] + ar + 1e-38f) * h2;
    }
    if (i < n - 1) {
      const float ad = ws.p[t + n];
      tv[c] = 2.0f * a[c] * ad / (a[c] + ad + 1e-38f) * h2;
    }
    ws.th[t] = th[c];
    ws.tv[t] = tv[c];
  }
  __syncwarp();
  float log_a = 0.0f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int t = l + 32 * c, i = t / n, j = t % n;
    const float th_l = j > 0 ? ws.th[t - 1] : 0.0f;
    const float tv_u = i > 0 ? ws.tv[t - n] : 0.0f;
    // Dirichlet faces at half-cell distance: 2 h^-2 a per boundary side
    const float edge = static_cast<float>((i == 0) + (i == n - 1) + (j == 0) + (j == n - 1));
    op.bnd[c] = 2.0f * h2 * a[c] * edge;
    op.inv_diag[c] = 1.0f / (th[c] + th_l + tv[c] + tv_u + op.bnd[c]);
    log_a = c == 0 ? logf(a[c]) : log_a + logf(a[c]);
  }
  op.a_bar = expf(warp_sum(log_a) / h2);
  if (l == 0) lv.xg.abar[threadIdx.x >> 5] = op.a_bar;
  return op;
}

// darcy_cg on a warp: fixed-count PCG on A x = b from 0, or (WARM) from
// the lane's cells of a start passed in x, with the same guards (alpha = 0
// when pAp <= 0, beta = 0 when rz <= 0) and the level's dot products.
template <bool WARM = false, class L>
__device__ void darcy_cg_warp(const L& lv, const WarpOperator<L::kC>& op,
                              const float (&b)[L::kC], float (&x)[L::kC]) {
  constexpr int C = L::kC;
  float r[C], z[C], p[C], Ap[C];
  if constexpr (WARM) {  // from the start in x: r = b - A x
    apply_operator_warp(lv, op, x, Ap);
#pragma unroll
    for (int c = 0; c < C; ++c) r[c] = b[c] - Ap[c];
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      r[c] = b[c];
      x[c] = 0.0f;
    }
  }
  lv.precond(r, op.inv_diag, z);
#pragma unroll
  for (int c = 0; c < C; ++c) p[c] = z[c];
  float rz = lv.dot(r, z);
  for (int it = 0; it < lv.s->cg_iters; ++it) {
    apply_operator_warp(lv, op, p, Ap);
    const float pAp = lv.dot(p, Ap);
    const float alpha = pAp > 0.0f ? rz / pAp : 0.0f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      x[c] = x[c] + alpha * p[c];
      r[c] = r[c] - alpha * Ap[c];
    }
    lv.precond(r, op.inv_diag, z);
    const float rz_new = lv.dot(r, z);
    const float beta = rz > 0.0f ? rz_new / rz : 0.0f;
#pragma unroll
    for (int c = 0; c < C; ++c) p[c] = z[c] + beta * p[c];
    rz = rz_new;
  }
}

// darcy_richardson (K17) on a warp: x_1 = omega M^-1 b, then cg_iters - 1
// updates x <- x + omega M^-1 (b - A x).
template <class L>
__device__ void darcy_richardson_warp(const L& lv, const WarpOperator<L::kC>& op,
                                      const float (&b)[L::kC], float (&x)[L::kC]) {
  constexpr int C = L::kC;
  const float omega = lv.s->omega;
  float z[C];
  lv.precond(b, op.inv_diag, z);
#pragma unroll
  for (int c = 0; c < C; ++c) x[c] = omega * z[c];
  for (int it = 1; it < lv.s->cg_iters; ++it) {
    float r[C];
    apply_operator_warp(lv, op, x, r);
#pragma unroll
    for (int c = 0; c < C; ++c) r[c] = b[c] - r[c];
    lv.precond(r, op.inv_diag, z);
#pragma unroll
    for (int c = 0; c < C; ++c) x[c] = x[c] + omega * z[c];
  }
}

// Phi(u) for the chain of this warp, whose coefficients sit in the warp's
// u[0..64): the same value in every lane. Every warp of the CTA calls.
template <int SOLVER, class L>
__device__ float darcy_phi_warp(const L& lv, const float* u) {
  constexpr int C = L::kC;
  const int l = threadIdx.x & 31;
  const IpxMisfitSpec& s = *lv.s;
  const WarpOperator<C> op = darcy_setup_warp(lv, u);
  float b[C], x[C];
#pragma unroll
  for (int c = 0; c < C; ++c) b[c] = s.source[l + 32 * c];
  if constexpr (SOLVER == kSolverRichardson) darcy_richardson_warp(lv, op, b, x);
  else darcy_cg_warp(lv, op, b, x);
  // the residuals at the observed cells, as darcy_observe sums them
#pragma unroll
  for (int c = 0; c < C; ++c) lv.ws.p[l + 32 * c] = x[c];
  __syncwarp();
  float acc = 0.0f;
  for (int o = l; o < s.m; o += 32) {
    const float res = (s.data[o] - lv.ws.p[s.obs[o]]) / s.noise[o];
    acc += res * res;
  }
  const float phi = 0.5f * warp_sum(acc);
  __syncwarp();
  return phi;
}

// --- the Jacobi solve on a warp: elliptical slice sampling -------------------
//
// With the Jacobi preconditioner (z = D^-1 r) a warp's solve needs no other
// chain and no CTA barrier, so each warp of fused_ess.cu's kernel runs its
// own data-dependent number of solves. WarpSliceLevel gives it, its dot
// products added in the order in which block_sum adds on a CTA that holds
// one cell a thread (darcy_cg), so that its solves give that CTA's bits.
//
// The 16 x 16 grid in block_sum's order. block_sum over a CTA of 256
// threads, one cell a thread, adds warp w's cells 32 w + j by warp_sum's
// butterfly (pairs j ^ 16, then j ^ 8, ^ 4, ^ 2, ^ 1), then 0 + warp 0 + ...
// + warp 7. Here lane l owns the eight cells 32 (l / 4) + (l % 4) + 4 k of
// one such slice, k = 0..7: the butterfly's first three levels pair cells
// of one lane (k ^ 4, ^ 2, ^ 1), so they are adds in registers, and the
// last two pair lanes l ^ 2, l ^ 1: two shuffles, the same pairs of the
// same values as block_sum. Lanes 0, 4, ..., 28 then hand the eight slice
// sums round through the warp's shared memory, and every lane adds them in
// order. Shared memory holds the cells padded by 4 after every 32 (cell t
// at t + 4 (t / 32)), so that the 32 lanes' k-th cells, and each of their
// neighbours, fall in 32 distinct banks; the basis, staged once a CTA in
// shared memory, likewise.
struct WarpSliceLevel {
  static constexpr int kN = 16, kCells = 256, kC = 8, kStride = 288, kK = 64;
  static constexpr int kPrecond = kPrecondJacobi;
  const IpxMisfitSpec* s;
  const float* basis;  // (64, kStride) staged, padded
  WarpSmem ws;         // p, th, tv: kStride floats each

  static __device__ __forceinline__ int pad(int t) { return t + 4 * (t >> 5); }
  // the lane's k-th cell and its padded index
  static __device__ __forceinline__ int cell(int k) {
    const int l = threadIdx.x & 31;
    return 32 * (l >> 2) + (l & 3) + 4 * k;
  }
  static __device__ __forceinline__ int at(int k) {
    const int l = threadIdx.x & 31;
    return 36 * (l >> 2) + (l & 3) + 4 * k;
  }

  // Copies the basis of `s` padded to `base` (every thread of the CTA
  // calls; a barrier must follow before it is read).
  static __device__ const float* stage(const IpxMisfitSpec& s, float* base) {
    for (int e = threadIdx.x; e < kK * kCells; e += blockDim.x)
      base[(e / kCells) * kStride + pad(e % kCells)] = s.basis[e];
    return base;
  }
  __host__ __device__ static constexpr size_t staged_bytes() {
    return sizeof(float) * kK * kStride;
  }

  __device__ void precond(const float (&r)[kC], const float (&inv_diag)[kC],
                          float (&z)[kC]) const {
#pragma unroll
    for (int c = 0; c < kC; ++c) z[c] = inv_diag[c] * r[c];
  }

  // sum over the warp's cells of a b, in block_sum's order, in every lane
  // (the products rounded before any add, as block_sum's threads round them)
  __device__ float dot(const float (&a)[kC], const float (&b)[kC]) const {
    float v[kC];
#pragma unroll
    for (int k = 0; k < kC; ++k) v[k] = __fmul_rn(a[k], b[k]);
    return sum(v);
  }

  // sum over the warp's cells of v, in block_sum's order, in every lane
  __device__ float sum(const float (&v)[kC]) const {
    const float b0 = (v[0] + v[4]) + (v[2] + v[6]), b1 = (v[1] + v[5]) + (v[3] + v[7]);
    float t = b0 + b1;
    t += __shfl_xor_sync(0xffffffffu, t, 2);
    t += __shfl_xor_sync(0xffffffffu, t, 1);  // the slice's warp_sum
    float* sums = ws.p;  // free: no one reads it between a stencil's reads and the next write
    const int l = threadIdx.x & 31;
    if ((l & 3) == 0) sums[l >> 2] = t;
    __syncwarp();
    const float4 lo = *reinterpret_cast<const float4*>(sums);
    const float4 hi = *reinterpret_cast<const float4*>(sums + 4);
    __syncwarp();  // the reads end before the next write
    return 0.0f + lo.x + lo.y + lo.z + lo.w + hi.x + hi.y + hi.z + hi.w;
  }

  // darcy_setup on the lane's cells: the field, the face terms (to ws.th,
  // ws.tv), the boundary terms and the inverse diagonal (Jacobi: no a_bar).
  __device__ WarpOperator<kC> setup(const float* u) const {
    constexpr int n = kN;
    const float h2 = static_cast<float>(kCells);
    WarpOperator<kC> op;
    op.a_bar = 1.0f;
    float a[kC], acc[kC];
#pragma unroll
    for (int k = 0; k < kC; ++k) acc[k] = 0.0f;
    __builtin_assume(__isShared(basis));
#pragma unroll 8
    for (int m = 0; m < kK; ++m) {
      const float um = u[m];
#pragma unroll
      for (int k = 0; k < kC; ++k) {
        acc[k] += basis[m * kStride + at(k)] * um;
      }
    }
#pragma unroll
    for (int k = 0; k < kC; ++k) {
      a[k] = expf(s->log_a_mean + acc[k]);
      ws.p[at(k)] = a[k];
    }
    __syncwarp();
    float th[kC], tv[kC];
#pragma unroll
    for (int k = 0; k < kC; ++k) {
      const int t = cell(k), i = t / n, j = t % n, q = at(k);
      th[k] = 0.0f;
      tv[k] = 0.0f;
      if (j < n - 1) {
        const float ar = ws.p[q + 1];
        th[k] = 2.0f * a[k] * ar / (a[k] + ar + 1e-38f) * h2;
      }
      if (i < n - 1) {
        const float ad = ws.p[q + (k < 4 ? 16 : 20)];
        tv[k] = 2.0f * a[k] * ad / (a[k] + ad + 1e-38f) * h2;
      }
      ws.th[q] = th[k];
      ws.tv[q] = tv[k];
    }
    __syncwarp();
#pragma unroll
    for (int k = 0; k < kC; ++k) {
      const int t = cell(k), i = t / n, j = t % n, q = at(k);
      const float th_l = j > 0 ? ws.th[q - 1] : 0.0f;
      const float tv_u = i > 0 ? ws.tv[q - (k < 4 ? 20 : 16)] : 0.0f;
      // Dirichlet faces at half-cell distance: 2 h^-2 a per boundary side
      const float edge = static_cast<float>((i == 0) + (i == n - 1) + (j == 0) + (j == n - 1));
      op.bnd[k] = 2.0f * h2 * a[k] * edge;
      op.inv_diag[k] = 1.0f / (th[k] + th_l + tv[k] + tv_u + op.bnd[k]);
    }
    return op;
  }

  // (A p) on the lane's cells, p handed round through ws.p
  __device__ void stencil(const WarpOperator<kC>& op, const float (&p)[kC],
                          float (&Ap)[kC]) const {
    constexpr int n = kN;
#pragma unroll
    for (int k = 0; k < kC; ++k) ws.p[at(k)] = p[k];
    __syncwarp();
#pragma unroll
    for (int k = 0; k < kC; ++k) {
      const int t = cell(k), i = t / n, j = t % n, q = at(k);
      const int down = k < 4 ? 16 : 20, up = k < 4 ? 20 : 16;
      const float pr = j < n - 1 ? ws.p[q + 1] : 0.0f;
      const float pd = i < n - 1 ? ws.p[q + down] : 0.0f;
      const float pl = j > 0 ? ws.p[q - 1] : 0.0f;
      const float pu = i > 0 ? ws.p[q - up] : 0.0f;
      const float th_l = j > 0 ? ws.th[q - 1] : 0.0f;
      const float tv_u = i > 0 ? ws.tv[q - up] : 0.0f;
      Ap[k] = ws.th[q] * (p[k] - pr) - th_l * (pl - p[k]) + ws.tv[q] * (p[k] - pd) -
              tv_u * (pu - p[k]) + op.bnd[k] * p[k];
    }
    __syncwarp();  // the reads end before the next write to p
  }

  // Phi(u) for the chain of this warp, as darcy_phi_warp.
  __device__ float phi(const float* u) const {
    const WarpOperator<kC> op = setup(u);
    float b[kC], x[kC];
#pragma unroll
    for (int k = 0; k < kC; ++k) b[k] = s->source[cell(k)];
    darcy_cg_warp(*this, op, b, x);
    return observe(x);
  }

  // Phi from the lane's cells x of the solution: the residuals at the
  // observed cells, as darcy_observe sums them; the same value in every lane.
  __device__ __forceinline__ float observe(const float (&x)[kC]) const {
#pragma unroll
    for (int k = 0; k < kC; ++k) ws.p[at(k)] = x[k];
    __syncwarp();
    const int l = threadIdx.x & 31;
    float acc = 0.0f;
    for (int o = l; o < s->m; o += 32) {
      const float res = (s->data[o] - ws.p[pad(s->obs[o])]) / s->noise[o];
      acc += res * res;
    }
    const float phi = 0.5f * warp_sum(acc);
    __syncwarp();
    return phi;
  }
};

// apply_operator_warp on a WarpSliceLevel (darcy_cg_warp's stencil)
__device__ __forceinline__ void apply_operator_warp(const WarpSliceLevel& lv,
                                                    const WarpOperator<8>& op, const float (&p)[8],
                                                    float (&Ap)[8]) {
  lv.stencil(op, p, Ap);
}

// Whether a cold misfit is WarpSliceLevel's: its grid and K, Jacobi (no
// modes), CG. The standalone misfits a draw a warp on it
// (darcy_misfit_slice_kernel, darcy_misfit_grad_warp_kernel) take what
// this takes.
inline bool warp_slice_spec(const IpxMisfitSpec& s) {
  return s.n == WarpSliceLevel::kN && s.K == WarpSliceLevel::kK && s.precond == kPrecondJacobi &&
         s.modes == 0 && s.solver == kSolverCg && s.m >= 0;
}

// --- the adjoint gradient on a warp: MALA ------------------------------------
//
// The value and gradient of darcy_value_and_grad for one chain on one warp,
// in WarpSliceLevel's layout: the lane's eight cells of one 32-cell slice,
// every sum in the order of the one-chain-a-CTA kernel's threads, so that
// its chains keep their bits. Jacobi (cold MALA) solves on WarpSliceLevel;
// the dense dst preconditioner (warm MALA) on WarpDstSliceLevel below.

// The dense fast-Poisson apply (apply_dst) on a warp. A stage computes each
// output cell as its 16 multiply-adds q = 0..15 in sequence, in f32 on the
// CUDA cores, from inputs rounded to bf16 at apply_dst's four points; the
// stages are handed round through the warp's slices p and q between
// __syncwarp. The lane's cells are (i, j) = (2 (l / 4) + h, l % 4 + 4 m),
// k = 4 h + m. Each stage reads whole rows: the column stages' inputs are
// written transposed by the stage before (y^T, rt^T), and S^T is staged
// beside S. Every operand of a stage is a bf16 value (S, and the stages'
// rounded inputs), so the stages keep them as bf16, 16 x 16 with rows of
// kRow elements (48 bytes: the lanes' rows fall in distinct banks), and a
// 16-byte load brings 8 of them: half the shared-memory traffic of f32, the
// same bits. S, S^T and lam (f32, padded as the cells) are staged once a
// CTA.
struct WarpDstSliceLevel : WarpSliceLevel {
  static constexpr int kPrecond = kPrecondDst;
  static constexpr int kRow = 24;  // a bf16 row's stride in elements
  const __nv_bfloat16* S;   // (16, kRow)
  const __nv_bfloat16* St;  // its transpose
  const float* lam;         // (16, 16) padded: the eigenvalues of the flat grid
  __nv_bfloat16* q;         // the warp's second stage buffer (in a slice)
  float a_bar;              // the chain's geometric-mean coefficient

  // Copies S, S^T and lam of `s` to `base` (every thread of the CTA calls;
  // a barrier must follow).
  static __device__ void stage_dst(const IpxMisfitSpec& s, unsigned char* base) {
    const __nv_bfloat16* gS = static_cast<const __nv_bfloat16*>(s.S);
    __nv_bfloat16* Sb = reinterpret_cast<__nv_bfloat16*>(base);
    float* lb = reinterpret_cast<float*>(Sb + 2 * kN * kRow);
    for (int e = threadIdx.x; e < kCells; e += blockDim.x) {
      Sb[kRow * (e / kN) + e % kN] = gS[e];
      Sb[kN * kRow + kRow * (e % kN) + e / kN] = gS[e];
      lb[pad(e)] = s.lam[e];
    }
  }
  __host__ __device__ static constexpr size_t staged_dst_bytes() {
    return sizeof(__nv_bfloat16) * 2 * kN * kRow + sizeof(float) * kStride;
  }
  __device__ static const __nv_bfloat16* staged_S(unsigned char* base) {
    return reinterpret_cast<const __nv_bfloat16*>(base);
  }
  __device__ static const float* staged_lam(unsigned char* base) {
    return reinterpret_cast<const float*>(base + sizeof(__nv_bfloat16) * 2 * kN * kRow);
  }

  // half `half` (8 values) of row `row` as floats
  static __device__ __forceinline__ void row8(const __nv_bfloat16* base, int row, int half,
                                              float (&v)[8]) {
    unpack_bf16x8(*reinterpret_cast<const uint4*>(base + kRow * row + 8 * half), v);
  }

  // One stage: f(h, m, sum_q A[i0 + h, q] B[j0 + 4 m, q]) for the lane's
  // eight outputs, each adding q = 0..15 in sequence as apply_dst's loops
  // do (a product inside an fma is exact: which factor comes first is no
  // matter). The eight sums run side by side over q's two halves, the two
  // rows of A in registers, B's rows read in turn.
  template <class F>
  static __device__ __forceinline__ void stage(const __nv_bfloat16* A, const __nv_bfloat16* B,
                                               F&& f) {
    const int l = threadIdx.x & 31, i0 = 2 * (l >> 2), j0 = l & 3;
    float acc[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int m = 0; m < 4; ++m) acc[h][m] = 0.0f;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float a[2][8];
      row8(A, i0, half, a[0]);
      row8(A, i0 + 1, half, a[1]);
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        float b[8];
        row8(B, j0 + 4 * m, half, b);
#pragma unroll
        for (int e = 0; e < 8; ++e)
#pragma unroll
          for (int h = 0; h < 2; ++h) acc[h][m] += a[h][e] * b[e];
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int m = 0; m < 4; ++m) f(h, m, acc[h][m]);
  }

  __device__ void precond(const float (&r)[kC], const float (&inv_diag)[kC],
                          float (&z)[kC]) const {
    const int l = threadIdx.x & 31, i0 = 2 * (l >> 2), j0 = l & 3;
    __nv_bfloat16* const y = reinterpret_cast<__nv_bfloat16*>(ws.p);
    __nv_bfloat16* const qb = q;
    const float* const lm = lam;
    const float ab = a_bar;
    __builtin_assume(__isShared(S) && __isShared(St) && __isShared(lam) && __isShared(q) &&
                     __isShared(y));
#pragma unroll
    for (int k = 0; k < kC; ++k)
      qb[kRow * (i0 + (k >> 2)) + j0 + 4 * (k & 3)] = __float2bfloat16(r[k]);
    __syncwarp();
    // y[i, j] = sum_q S[j, q] r[i, q], stored as y^T
    stage(qb, S, [&](int h, int m, float v) {
      y[kRow * (j0 + 4 * m) + i0 + h] = __float2bfloat16(v);
    });
    __syncwarp();
    // rt[i, j] = sum_q S[i, q] y[q, j] / (lam a_bar), stored as rt^T
    stage(S, y, [&](int h, int m, float v) {
      const int t = kN * (i0 + h) + j0 + 4 * m;
      qb[kRow * (j0 + 4 * m) + i0 + h] = __float2bfloat16(v / (lm[pad(t)] * ab));
    });
    __syncwarp();
    // w[i, j] = sum_q S[q, i] rt[q, j]
    stage(St, qb, [&](int h, int m, float v) {
      y[kRow * (i0 + h) + j0 + 4 * m] = __float2bfloat16(v);
    });
    __syncwarp();
    // z[i, j] = sum_q S[q, j] w[i, q]
    stage(y, St, [&](int h, int m, float v) { z[4 * h + m] = v; });
    __syncwarp();  // the reads end before the next write to p
  }
};

// apply_operator_warp on a WarpDstSliceLevel (darcy_cg_warp's stencil)
__device__ __forceinline__ void apply_operator_warp(const WarpDstSliceLevel& lv,
                                                    const WarpOperator<8>& op, const float (&p)[8],
                                                    float (&Ap)[8]) {
  lv.stencil(op, p, Ap);
}

// Phi(u) for the chain of this warp from the lane's cells x of a previous
// solution, which the solve replaces by its own, on a level whose
// preconditioner scales by a_bar (WarpDstSliceLevel, WarpTruncSliceLevel):
// the set-up, a_bar (Sum log a in block_sum's order), the warm CG, the
// residuals.
template <class L>
__device__ float darcy_phi_warm_warp(L& lv, const float* u, float (&x)[L::kC]) {
  constexpr int C = L::kC;
  const WarpOperator<C> op = lv.setup(u);
  float log_a[C], b[C];
#pragma unroll
  for (int k = 0; k < C; ++k) {
    log_a[k] = logf(lv.ws.p[L::at(k)]);  // a, where setup left it
    b[k] = lv.s->source[L::cell(k)];
  }
  __syncwarp();  // the reads end before sum writes p
  lv.a_bar = expf(lv.sum(log_a) / static_cast<float>(L::kCells));
  darcy_cg_warp<true>(lv, op, b, x);
  return lv.observe(x);
}

// One level of the KL product's reduce-and-scatter: the lane's 2 O sums
// v[0..2 O) become the O of its half (v[e + O] when bit O of the lane is
// set, else v[e]), each plus the other lane's sum of the same mode.
template <int O>
__device__ __forceinline__ void scatter_level(float (&v)[32]) {
  const bool upper = (threadIdx.x & O) != 0;
#pragma unroll
  for (int e = 0; e < O; ++e) {
    const float keep = upper ? v[e + O] : v[e];
    const float send = upper ? v[e] : v[e + O];
    v[e] = keep + __shfl_xor_sync(0xffffffffu, send, O);
  }
}

// Phi(u) and g (coordinates l, l + 32 of the 64-mode gradient) for the chain
// of this warp, whose coefficients sit in the warp's u[0..64): the adjoint
// method of darcy_value_and_grad, the same value in every lane. WARM: both
// solves start from the lane's cells x0, lam0. af and xf are slices of
// kStride floats: the field a waits in af through the solves (not in
// registers), and on return the lane's cells of the forward solution are in
// xf, those of the adjoint solution in lv.ws.th. No CTA barrier.
template <bool WARM, class L>
__device__ float darcy_value_and_grad_warp(L& lv, const float* u, float* af, float* xf,
                                           const float (&x0)[8], const float (&lam0)[8],
                                           float (&g)[2]) {
  constexpr int n = L::kN, C = L::kC, kStride = L::kStride;
  const int l = threadIdx.x & 31;
  const IpxMisfitSpec& s = *lv.s;
  const WarpOperator<C> op = lv.setup(u);
  float a[C];
#pragma unroll
  for (int k = 0; k < C; ++k) {
    a[k] = lv.ws.p[L::at(k)];  // where setup left it
    af[L::at(k)] = a[k];
  }
  __syncwarp();  // the reads end before the next write to p
  if constexpr (L::kPrecond == kPrecondDst) {
    float log_a[C];
#pragma unroll
    for (int k = 0; k < C; ++k) log_a[k] = logf(a[k]);
    lv.a_bar = expf(lv.sum(log_a) / static_cast<float>(L::kCells));
  }

  float b[C], x[C];
#pragma unroll
  for (int k = 0; k < C; ++k) {
    b[k] = s.source[L::cell(k)];
    x[k] = WARM ? x0[k] : 0.0f;
  }
  darcy_cg_warp<WARM>(lv, op, b, x);
  // the residuals at the observed cells, as darcy_observe sums them, and the
  // adjoint right-hand side -O^T(res / sigma), o in order, per cell
#pragma unroll
  for (int k = 0; k < C; ++k) {
    lv.ws.p[L::at(k)] = x[k];
    xf[L::at(k)] = x[k];
    b[k] = 0.0f;
  }
  __syncwarp();
  float acc = 0.0f;
  for (int o0 = 0; o0 < s.m; o0 += 32) {
    const int o = o0 + l;
    float q = 0.0f;
    if (o < s.m) {
      const float res = (s.data[o] - lv.ws.p[L::pad(s.obs[o])]) / s.noise[o];
      acc += res * res;
      q = res / s.noise[o];
    }
    const int count = s.m - o0 < 32 ? s.m - o0 : 32;
    for (int e = 0; e < count; ++e) {
      const float qe = __shfl_sync(0xffffffffu, q, e);
      const int t = s.obs[o0 + e];
#pragma unroll
      for (int k = 0; k < C; ++k)
        if (t == L::cell(k)) b[k] += qe;
    }
  }
  const float phi = 0.5f * warp_sum(acc);
  __syncwarp();  // the reads end before the adjoint solve writes p
  float lam[C];
#pragma unroll
  for (int k = 0; k < C; ++k) {
    b[k] = -b[k];
    lam[k] = WARM ? lam0[k] : 0.0f;
  }
  darcy_cg_warp<WARM>(lv, op, b, lam);

  // dPhi/da per cell, the parent's expressions; a, x and lam where the
  // neighbours read them: the slice th is free after the solves
  float* const la = lv.ws.th;
  const float* const aa = af;
#pragma unroll
  for (int k = 0; k < C; ++k) la[L::at(k)] = lam[k];
  __syncwarp();
  // Each face term is rounded before the adds (__fmul_rn): the parent's
  // branches on i and j are runtime ones, so its adds take rounded
  // products, where here many of them are known at compile time and the
  // compiler would contract the product into the add.
  const float two_h2 = 2.0f * static_cast<float>(L::kCells);
#pragma unroll
  for (int k = 0; k < C; ++k) {
    const int t = L::cell(k), i = t / n, j = t % n, q = L::at(k);
    const int down = k < 4 ? 16 : 20, up = k < 4 ? 20 : 16;
    const float ac = aa[q], xc = xf[q], lc = lam[k];
    float t_r = 0.0f, t_l = 0.0f, t_d = 0.0f, t_u = 0.0f;
    if (j < n - 1) {  // the face to the right: this cell's own share
      const float ar = aa[q + 1], den = 1.0f / (ac + ar + 1e-38f), qq = ar * den;
      t_r = __fmul_rn(two_h2 * (qq * qq), (xc - xf[q + 1]) * (lc - la[q + 1]));
    }
    if (j > 0) {  // the left neighbour's right face: the neighbour share
      const float al = aa[q - 1], den = 1.0f / (al + ac + 1e-38f), qq = al * den;
      t_l = __fmul_rn(two_h2 * (qq * qq), (xf[q - 1] - xc) * (la[q - 1] - lc));
    }
    if (i < n - 1) {
      const float ad = aa[q + down], den = 1.0f / (ac + ad + 1e-38f), qq = ad * den;
      t_d = __fmul_rn(two_h2 * (qq * qq), (xc - xf[q + down]) * (lc - la[q + down]));
    }
    if (i > 0) {
      const float au = aa[q - up], den = 1.0f / (au + ac + 1e-38f), qq = au * den;
      t_u = __fmul_rn(two_h2 * (qq * qq), (xf[q - up] - xc) * (la[q - up] - lc));
    }
    const float edge = static_cast<float>((i == 0) + (i == n - 1) + (j == 0) + (j == n - 1));
    const float g_a = t_r + t_l + t_d + t_u + two_h2 * xc * lc * edge;
    lv.ws.p[q] = ac * (-g_a);  // chain rule through a = exp(log a)
  }
  __syncwarp();
  // g[k] = sum_cells basis[k, cell] w[cell]: lane l's partial over the
  // cells l + 32 j, j in order, as the parent's lane l adds them; then, per
  // 32 modes, the partials reduced and scattered over the warp, lane l
  // keeping mode l: each level adds the pairs of warp_sum's butterfly, so
  // the parent's bits, with 31 shuffles for 32 modes instead of 160
  float w[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) w[j] = lv.ws.p[36 * j + l];
  __builtin_assume(__isShared(lv.basis));
  __syncwarp();  // the reads end before the next write to p
#pragma unroll
  for (int hb = 0; hb < 2; ++hb) {
    float v[32];
#pragma unroll
    for (int m = 0; m < 32; ++m) {
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) acc += lv.basis[(32 * hb + m) * kStride + 36 * j + l] * w[j];
      v[m] = acc;
    }
    scatter_level<16>(v);
    scatter_level<8>(v);
    scatter_level<4>(v);
    scatter_level<2>(v);
    scatter_level<1>(v);
    g[hb] = v[0];
  }
  return phi;
}

// --- the dst_trunc preconditioner over a CTA's chains: warm pCN -------------
//
// apply_precond's dst_trunc, z = D^-1 r + V^T bf16(V bf16(r) / (lam a_bar)),
// for the chains of a CTA, one a warp in WarpSliceLevel's layout. The
// warps hand bf16(r) and a_bar to the CTA's exchange (PrecondXchg), and
// both products run over all its chains at once, bf16 mma.sync with f32
// accumulation, as WarpLevel::precond runs them for the 16 x 16 DA kernel:
// V bf16(r) on modes tiles, rounded to bf16 over lam a_bar, then V^T coef on
// cells tiles, each warp taking tiles in turn, V staged once a CTA in rows
// of kCells + 8 (the eight 16-byte rows of an ldmatrix in distinct banks).
// Three CTA barriers an apply: every warp of the CTA makes the same applies
// (the warm pCN's fixed CG count), a spare warp on a chain of zeros. The
// tensor cores add the products in another order than apply_precond's
// loops; everything else of the step adds in the parent's order. V read
// through L2, and the products on the warp's CUDA cores in the parent's
// order, are the alternatives that scripts/measure_pcn_warp_design.py
// times.
struct WarpTruncSliceLevel : WarpSliceLevel {
  static constexpr int kPrecond = kPrecondDstTrunc;
  static constexpr int kRows = 16;  // the exchange's chains: two mma tiles of 8, W at most
  static constexpr int kVRow = kCells + 8;  // a staged row of V, in bf16
  // the modes it takes: a multiple of 16 (an mma tile), as many as the
  // shared memory of a CTA of 16 warps holds beside the basis and the
  // exchange (232,448 bytes: 112)
  static constexpr int kModeTile = 16, kMaxModes = 112;
  PrecondXchg xg;          // the CTA's exchange
  const __nv_bfloat16* V;  // (modes, kVRow) staged
  float a_bar;             // the chain's geometric-mean coefficient

  // Bytes the CTA stages before its warps' slices for a misfit of `modes`
  // modes: the exchange, then V.
  __host__ __device__ static size_t staged_bytes(int modes) {
    return xchg_bytes(kRows) + sizeof(__nv_bfloat16) * modes * kVRow;
  }
  // The level of a warp on `base`, the CTA's staged bytes at `staged`
  // (every thread of the CTA calls; a barrier must follow before the level
  // is used).
  static __device__ WarpTruncSliceLevel make(const WarpSliceLevel& base, unsigned char* staged) {
    const IpxMisfitSpec& s = *base.s;
    __nv_bfloat16* Vs = reinterpret_cast<__nv_bfloat16*>(staged + xchg_bytes(kRows));
    const __nv_bfloat16* gV = static_cast<const __nv_bfloat16*>(s.V);
    for (int e = threadIdx.x; e < s.modes * kCells; e += blockDim.x)
      Vs[(e / kCells) * kVRow + e % kCells] = gV[e];
    return {base, carve_xchg(staged, kRows), Vs, 1.0f};
  }

  __device__ void precond(const float (&r)[kC], const float (&inv_diag)[kC],
                          float (&z)[kC]) const {
    const int l = threadIdx.x & 31, w = threadIdx.x >> 5, nw = blockDim.x >> 5;
    const int g = l >> 2, t = l & 3;
#pragma unroll
    for (int k = 0; k < kC; ++k) {
      // rounded before the add below, as the parent's z, which it adds in
      // another block
      z[k] = __fmul_rn(inv_diag[k], r[k]);
      xg.rb[w * kXRbStride + cell(k)] = __float2bfloat16(r[k]);
    }
    if (l == 0) xg.abar[w] = a_bar;
    __syncthreads();
    const int modes = s->modes;
    // coef[m][ch] = sum_cell V[m][cell] bf16(r)[ch][cell]
    for (int mt = w; mt < modes / 16; mt += nw) {
      float acc[2][4] = {};
#pragma unroll 4
      for (int k0 = 0; k0 < kCells; k0 += 16) {
        uint32_t a[4];
        load_a_v<true>(a, V, kVRow, mt * 16, k0);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const __nv_bfloat16* b = xg.rb + (nt * 8 + g) * kXRbStride + k0 + 2 * t;
          mma_16816(acc[nt], a, ld_pair(b), ld_pair(b + 8));
        }
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = mt * 16 + g + 8 * (e >> 1), ch = nt * 8 + 2 * t + (e & 1);
          if (ch < nw)
            xg.cb[ch * kXCbStride + m] = __float2bfloat16(acc[nt][e] / (s->lam[m] * xg.abar[ch]));
        }
    }
    __syncthreads();
    // back[cell][ch] = sum_m V[m][cell] coef[m][ch]
    for (int ct = w; ct < kCells / 16; ct += nw) {
      float acc[2][4] = {};
#pragma unroll 4
      for (int k0 = 0; k0 < modes; k0 += 16) {
        uint32_t a[4];
        load_a_vt<true>(a, V, kVRow, ct * 16, k0);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const __nv_bfloat16* b = xg.cb + (nt * 8 + g) * kXCbStride + k0 + 2 * t;
          mma_16816(acc[nt], a, ld_pair(b), ld_pair(b + 8));
        }
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = ct * 16 + g + 8 * (e >> 1), ch = nt * 8 + 2 * t + (e & 1);
          if (ch < nw) xg.back[ch * kXBackStride + c] = acc[nt][e];
        }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kC; ++k) z[k] = z[k] + xg.back[w * kXBackStride + cell(k)];
  }

  // Phi(u) for the chain of this warp from the lane's cells x of a previous
  // solution (darcy_phi_warm_warp).
  __device__ float phi_warm(const float* u, float (&x)[kC]) {
    return darcy_phi_warm_warp(*this, u, x);
  }
};

// apply_operator_warp on a WarpTruncSliceLevel (darcy_cg_warp's stencil)
__device__ __forceinline__ void apply_operator_warp(const WarpTruncSliceLevel& lv,
                                                    const WarpOperator<8>& op, const float (&p)[8],
                                                    float (&Ap)[8]) {
  lv.stencil(op, p, Ap);
}

// --- one chain a CTA, G chains a thread-block cluster: the 64 x 64 kernels ----
//
// The functions below run darcy_setup / darcy_cg for one chain per CTA, with
// the cells-per-thread layout of the functions above (C cells a thread, the
// CG vectors in registers), for the 64 x 64 grid and its 32 x 32 surrogate,
// whose factors (K = 144: the f32 basis 2.4 MB and 0.59 MB, the bf16 modes
// 2.1 MB and 0.26 MB) fit in no CTA. The G CTAs of a thread-block cluster
// run G chains in lockstep and meet in the three products that read the
// factors, so that each factor byte is read from L2 once a cluster instead
// of once a chain. CTA rho of the cluster computes, for all G chains:
//
//   the KL reconstruction  a = exp(log_a_mean + basis^T u) on cells slice
//                          rho, from the chains' u read through distributed
//                          shared memory (DSMEM); f32 on the CUDA cores, k
//                          in ascending order as darcy_setup sums it, each
//                          a written to its chain's CTA;
//   coef = V bf16(r)       on modes slice rho, bf16 mma.sync.m16n8k16 with
//                          f32 accumulation, the chains as N; bf16(coef /
//                          (lam a_bar)) goes to every CTA of the cluster;
//   back = V^T coef        on cells slice rho, the same way (the
//                          surrogate's on the CUDA cores: see Numerics);
//                          each chain's slice goes to its CTA.
//
// Every output's sum over K runs in one CTA (its warps split the k-steps
// and their partial sums are added in k order), so nothing is added across
// CTAs. Three cluster barriers an apply, two a set-up. Every CTA of a
// cluster calls these functions together with the same iteration counts
// (a spare CTA of a ragged last cluster on a chain of zeros), so every
// cluster barrier is reached by all of them.
//
// The work is a chain of small dependent phases (a surrogate solve: two
// cluster barriers in the set-up, three in each of 4 preconditioner
// applies), so the design runs two chains an SM (two CTAs of 512 threads,
// 8 cells a thread), each hiding the other's waits, and bounds a thread's
// registers at 64. A spilled register goes to L2 when the spills of the
// SM's threads overflow L1, so a thread keeps only the CG vectors x, r, p
// (and z, Ap while they live) in registers; the stencil's face terms,
// boundary terms and the inverse diagonal lie in shared memory, every
// buffer at an offset fixed at compile time (ClusterSmem), so that a
// thread keeps no pointer to one in a register; the products' k-loops are
// not unrolled and the KL sums keep 16 loads in flight, which spill least
// (scripts/measure_da64_cluster_design.py, PERF.md).
//
// Numerics: the tensor cores sum a product in another order, with another
// rounding, than an f32 loop. For V bf16(r) that rarely shows (its result is
// rounded to bf16); for the surrogate's V^T coef, an f32 term of z, it parts
// about 2 % of the chains from the plain twin within two outer steps of
// darcy64_da_fused. So the surrogate's V^T coef runs on the CUDA cores, an
// f32 FMA loop over the modes in ascending order from this CTA's columns of
// V kept in shared memory through an outer step (stage_columns); the exact
// level's products and the surrogate's V bf16(r) run on the tensor cores.

namespace cg = cooperative_groups;

// The cluster design of the 64 x 64 kernels (fused_da_pcn_cluster_kernel,
// fused_pcn_warm_cluster_kernel, and the misfits at their start positions,
// darcy_misfit_cluster_kernel, darcy_misfit_warm_cluster_kernel and, on the
// surrogate level, darcy_misfit_surr_cluster_kernel;
// scripts/measure_da64_cluster_design.py times the alternatives): kG chains (CTAs) a cluster; the CTA's layout
// (kCells cells a thread at 64 x 64 on kThreads threads, kMinCtas CTAs an
// SM for the launch bound); kSurrMmaCoef, kSurrMmaBack: the surrogate's
// V bf16(r) and its V^T coef on the tensor cores (bf16 mma.sync, f32
// accumulation), else as f32 FMAs on the CUDA cores (the same bf16
// roundings, the sums in another order). The exact level's products run
// on the tensor cores (on the CUDA cores its columns of V would not fit in
// shared memory).
struct ClusterDesign { static constexpr int kG = 8, kCells = 8, kThreads = 512, kMinCtas = 2; static constexpr bool kSurrMmaCoef = true, kSurrMmaBack = false; };

// The 32 x 32 warm pCN kernel (fused_pcn_warm_cluster32_kernel, and the
// misfits at its start positions, darcy_misfit_warm_cluster32_kernel and
// its cold twin darcy_misfit_cluster32_kernel;
// scripts/measure_pcn32_cluster_design.py times the alternatives): kG
// chains (CTAs) a cluster, kCells cells a thread on kThreads threads,
// kMinCtas CTAs an SM for the launch bound. It reads the factors through
// L2 and runs both products on the tensor cores, as the 64 x 64 exact
// level does. Keeping a CTA's slices of the factors in shared memory for
// the launch fits at 32 x 32 (two 32 KB slices of V at G = 8) but leaves
// room for two CTAs an SM; the cluster's chain of barriers runs faster at
// seven small CTAs an SM with the factors through L2 (PERF.md).
struct Cluster32Design { static constexpr int kG = 8, kCells = 8, kThreads = 128, kMinCtas = 8; };

// The grids the cluster kernels take, and the largest K (= d) and number
// of dst_trunc modes (the exact level's; the surrogate's) their shared
// memory holds: the 64 x 64 kernels, and the 32 x 32 warm pCN kernel.
constexpr int kClusterExactN = 64, kClusterSurrN = 32, kClusterMaxK = 144;
constexpr int kClusterMaxModes = 256, kClusterSurrMaxModes = 128;
constexpr int kCluster32N = 32, kCluster32MaxK = 64, kCluster32MaxModes = 128;

// The shared memory of a CTA of the cluster kernels (the same in every CTA,
// so that a peer's buffer is this CTA's offset mapped to its rank), for
// levels of up to CELLS cells, G chains a cluster on THREADS threads, K up
// to MAX_K and MAX_MODES dst_trunc modes.
template <int CELLS, int G, int THREADS, int MAX_K, int MAX_MODES>
struct ClusterSmemT {
  static constexpr int kCells = CELLS, kG = G, kMaxK = MAX_K, kMaxModes = MAX_MODES;
  static constexpr int kNT = (kG + 7) / 8, kWarps = THREADS / 32;
  // f32 offsets
  // [5][cells] a level's per-cell arrays (ClusterLevel::kArr*), each of
  // the level's cells, packed from the start: the 32 x 32 surrogate of the
  // 64 x 64 kernels leaves the rest free for its products' staging
  static constexpr int kCellArrays = 0;
  static constexpr int kPart = kCellArrays + 5 * kCells;  // [warps][16][8 NT] partial sums
  static constexpr int kUall = kPart + kWarps * 16 * 8 * kNT;  // [G][K] the cluster's u
  static constexpr int kState = kUall + kG * MAX_K;            // [3][d] the sampler's state
  static constexpr int kRed = kState + 3 * MAX_K;              // [32] warp partials
  static constexpr int kScalar = kRed + 32;                    // [1] broadcast of Phi
  static constexpr int kAbar = kScalar + 1;                    // [1] this chain's a_bar
  static constexpr int kAbarAll = kAbar + 1;                   // [G] the cluster's a_bar
  static constexpr int kLam = kAbarAll + kG;  // [modes] eigenvalues of this CTA's modes slice
  static constexpr int kF32 = (kLam + MAX_MODES + 3) / 4 * 4;  // floats before the bf16 ones
  // bf16 offsets after the floats
  static constexpr int kRb = 0;                                // [cells] this chain's bf16(r)
  static constexpr int kCbStride = MAX_MODES + 8;              // 4 words mod 32: no bank conflict
  static constexpr int kCb = kRb + kCells;                     // [G][kCbStride] the coefficients
  static constexpr int kBytes = 4 * kF32 + 2 * (kCb + kG * kCbStride);
};

// The layout of the 64 x 64 kernels.
using ClusterSmem = ClusterSmemT<kClusterExactN * kClusterExactN, ClusterDesign::kG,
                                 ClusterDesign::kThreads, kClusterMaxK, kClusterMaxModes>;

extern __shared__ float4 ipx_cluster_smem[];

__device__ __forceinline__ float* cluster_f32(int offset) {
  return reinterpret_cast<float*>(ipx_cluster_smem) + offset;
}
template <class Smem>
__device__ __forceinline__ __nv_bfloat16* cluster_bf16(int offset) {
  return reinterpret_cast<__nv_bfloat16*>(cluster_f32(Smem::kF32)) + offset;
}
// The misfit workspace inside it (no modes row: the cluster's products
// keep theirs in the exchange).
// (darcy_observe reads cell_a, the level's first per-cell array).
template <class Smem>
__device__ __forceinline__ MisfitSmem cluster_ws() {
  return {cluster_f32(Smem::kCellArrays), nullptr, nullptr, cluster_f32(Smem::kRed),
          cluster_f32(Smem::kScalar)};
}

// D (rows x G) = A (rows x K) B (K x G) for this CTA's `tiles` row tiles of
// 16: mac(acc, tile, kstep) adds one k-step's mma products (of its
// fragments; zeros in the columns of no chain) to acc, and finish(tile,
// row, ch, value) takes each sum (fragment row 0..16 of the tile, chain ch
// < G). With at least as many tiles as warps a warp takes whole tiles;
// else the W / tiles warps of a tile split its k-steps into chunks, and
// their partial sums are added in chunk order. Every thread of the CTA
// calls (a CTA barrier when the k-steps are split).
template <int G, class Smem, class MAC, class F>
__device__ void cta_tile_products(int tiles, int ksteps, MAC mac, F finish) {
  constexpr int NT = (G + 7) / 8;
  if (tiles == 0) return;
  float* part = cluster_f32(Smem::kPart);
  const int l = threadIdx.x & 31, w = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const int g = l >> 2, t = l & 3;
  const bool split = tiles < nw;
  const int ks_n = split ? nw / tiles : 1;
  const int chunk = (ksteps + ks_n - 1) / ks_n;
  for (int job = w; job < (split ? tiles * ks_n : tiles); job += nw) {
    const int tile = split ? job / ks_n : job, ks = split ? job % ks_n : 0;
    const int k_lo = split ? ks * chunk : 0;
    const int k_hi = split ? min(ksteps, k_lo + chunk) : ksteps;
    float acc[NT][4] = {};
#pragma unroll 1
    for (int k = k_lo; k < k_hi; ++k) mac(acc, tile, k);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = g + 8 * (e >> 1), ch = nt * 8 + 2 * t + (e & 1);
        if (split) part[(job * 16 + row) * 8 * NT + ch] = acc[nt][e];
        else if (ch < G) finish(tile, row, ch, acc[nt][e]);
      }
  }
  if (!split) return;
  __syncthreads();
  for (int e = threadIdx.x; e < tiles * 16 * G; e += blockDim.x) {
    const int tile = e / (16 * G), row = (e / G) % 16, ch = e % G;
    float v = 0.0f;
    for (int ks = 0; ks < ks_n; ++ks) v += part[((tile * ks_n + ks) * 16 + row) * 8 * NT + ch];
    finish(tile, row, ch, v);
  }
}

// One level of the cluster-level solve: an N x N grid on T threads, C cells
// a thread (every thread owns C cells), G chains a cluster, each of the
// preconditioner's products (V bf16(r): MMA_COEF; V^T coef: MMA_BACK) on
// the tensor cores or the CUDA cores, its spec, and the shared-memory
// layout SMEM it runs in.
template <int N, int C, int T, int G, bool MMA_COEF, bool MMA_BACK, class SMEM = ClusterSmem>
struct ClusterLevel {
  using Smem = SMEM;
  static constexpr int kN = N, kCells = N * N, kC = C, kG = G;
  static constexpr int kSlice = kCells / G;  // cells of a CTA's slice
  static_assert(C * T == kCells, "every thread owns C cells");
  static_assert(kSlice % 16 == 0 && (T % kSlice == 0 || kSlice % T == 0),
                "a cells slice is whole mma tiles and fits the threads");
  static_assert(kCells <= Smem::kCells && G == Smem::kG, "the layout holds it");
  // the per-cell arrays (f32 offsets): a, the vector the stencil reads, the
  // cluster's V^T coef, x (cell_a); face terms below (cell_b) and right of
  // each cell (th); boundary terms; inverse diagonal; then free floats
  static constexpr int kArrCellA = Smem::kCellArrays, kArrCellB = kArrCellA + kCells;
  static constexpr int kArrTh = kArrCellB + kCells, kArrBnd = kArrTh + kCells;
  static constexpr int kArrInv = kArrBnd + kCells, kArrFree = kArrInv + kCells;
  static constexpr int kFreeFloats = Smem::kCellArrays + 5 * Smem::kCells - kArrFree;
  static constexpr int kMaxModes = N == kClusterExactN ? kClusterMaxModes : kClusterSurrMaxModes;
  // the staged columns of V: a row of modes a cell, padded to 4 words mod
  // 32 so that 8 lanes' 16-byte loads of 8 cells fall in distinct banks
  static constexpr int kVStride = kMaxModes + 8;
  static constexpr int kKlBatch = 16;  // basis loads a thread keeps in flight
  static_assert(Smem::kMaxModes / 16 / G < T / 32, "the mode tiles of V.r split over warps");
  static_assert(G + Smem::kMaxModes / G <= T, "a thread a cluster a_bar or slice eigenvalue");
  const IpxMisfitSpec* s;

  // a = exp(log_a_mean + basis^T u) on this CTA's cells slice for the
  // cluster's chains, each written to its chain's cell_a; u: this chain's
  // coefficients (the same buffer in every CTA). Two cluster barriers:
  // after them cell_a holds this chain's field.
  __device__ void reconstruct(const float* u) const {
    cg::cluster_group cl = cg::this_cluster();
    const int K = s->K, rho = static_cast<int>(cl.block_rank()), tid = threadIdx.x;
    float* uall = cluster_f32(Smem::kUall);
    float* cell_a = cluster_f32(kArrCellA);
    cl.sync();  // every chain's u is written; the last solve's reads of cell_a are done
    for (int e = tid; e < G * K; e += T) uall[e] = cl.map_shared_rank(u, e / K)[e % K];
    __syncthreads();
    const float* basis = s->basis;
    const float mean = s->log_a_mean;
    const int slice0 = rho * kSlice;
    if constexpr (T % kSlice == 0) {  // a cell a thread, the chains ch0, ch0 + R, ...
      constexpr int R = T / kSlice, J = (G + R - 1) / R;
      const int cell = slice0 + tid % kSlice, ch0 = tid / kSlice;
      float acc[J];
#pragma unroll
      for (int j = 0; j < J; ++j) acc[j] = 0.0f;
      for (int k0 = 0; k0 < K; k0 += kKlBatch) {  // a batch of loads in flight, then the sums
        float b[kKlBatch];
#pragma unroll
        for (int i = 0; i < kKlBatch; ++i)
          b[i] = k0 + i < K ? basis[static_cast<size_t>(k0 + i) * kCells + cell] : 0.0f;
#pragma unroll
        for (int i = 0; i < kKlBatch; ++i)
#pragma unroll
          for (int j = 0; j < J; ++j)
            if (ch0 + j * R < G && k0 + i < K) acc[j] += b[i] * uall[(ch0 + j * R) * K + k0 + i];
      }
#pragma unroll
      for (int j = 0; j < J; ++j)
        if (ch0 + j * R < G) cl.map_shared_rank(cell_a, ch0 + j * R)[cell] = expf(mean + acc[j]);
    } else {  // kSlice / T cells a thread, every chain
      for (int i = 0; i < kSlice / T; ++i) {
        const int cell = slice0 + tid + i * T;
        float acc[G];
#pragma unroll
        for (int ch = 0; ch < G; ++ch) acc[ch] = 0.0f;
        for (int k0 = 0; k0 < K; k0 += kKlBatch) {
          float b[kKlBatch];
#pragma unroll
          for (int i = 0; i < kKlBatch; ++i)
            b[i] = k0 + i < K ? basis[static_cast<size_t>(k0 + i) * kCells + cell] : 0.0f;
#pragma unroll
          for (int i = 0; i < kKlBatch; ++i)
#pragma unroll
            for (int ch = 0; ch < G; ++ch)
              if (k0 + i < K) acc[ch] += b[i] * uall[ch * K + k0 + i];
        }
#pragma unroll
        for (int ch = 0; ch < G; ++ch) cl.map_shared_rank(cell_a, ch)[cell] = expf(mean + acc[ch]);
      }
    }
    cl.sync();
  }

  // With V^T coef on the CUDA cores: copies this CTA's slice of V's
  // columns (every mode on the cells of slice rho) to the free floats,
  // transposed (a row of modes a cell), where precond reads it; 16-byte
  // loads all in flight. They stay there through the level's solves, until
  // a solve of the other level, whose per-cell arrays cover them; every
  // thread of the CTA calls, and a barrier must follow before a solve reads
  // them (the set-up's first).
  __device__ void stage_columns() const {
    if constexpr (!MMA_BACK) {
      static_assert(2 * kSlice * kVStride <= 4 * kFreeFloats,
                    "the free floats hold the slice's columns of V");
      constexpr int kRow = kSlice / 8;  // 16-byte loads a mode
      const int c0 = static_cast<int>(cg::this_cluster().block_rank()) * kSlice;
      const __nv_bfloat16* V = static_cast<const __nv_bfloat16*>(s->V);
      __nv_bfloat16* vs = reinterpret_cast<__nv_bfloat16*>(cluster_f32(kArrFree));
      for (int e = threadIdx.x; e < s->modes * kRow; e += blockDim.x) {
        const int m = e / kRow, cell = 8 * (e % kRow);
        const uint4 q = *reinterpret_cast<const uint4*>(V + static_cast<size_t>(m) * kCells + c0 +
                                                        cell);
        const __nv_bfloat16* v = reinterpret_cast<const __nv_bfloat16*>(&q);
#pragma unroll
        for (int i = 0; i < 8; ++i) vs[(cell + i) * kVStride + m] = v[i];
      }
    }
  }

  // z = D^-1 r + V^T bf16(V bf16(r) / (lam a_bar)) for this chain, the
  // products over the cluster's chains; three cluster barriers.
  __device__ void precond(const float (&r)[C], float (&z)[C]) const {
    cg::cluster_group cl = cg::this_cluster();
    const int modes = s->modes, rho = static_cast<int>(cl.block_rank());
    const int l = threadIdx.x & 31, g = l >> 2, t = l & 3;
    const __nv_bfloat16* V = static_cast<const __nv_bfloat16*>(s->V);
    constexpr int cbs = Smem::kCbStride;
    __nv_bfloat16* rb = cluster_bf16<Smem>(Smem::kRb);
    __nv_bfloat16* cb = cluster_bf16<Smem>(Smem::kCb);
    float* back = cluster_f32(kArrCellA);
    float* abar = cluster_f32(Smem::kAbarAll);
#pragma unroll
    for (int c = 0; c < C; ++c) rb[own_cell(c)] = __float2bfloat16(r[c]);
    cl.sync();  // every chain's bf16(r) is written (and its a_bar, after its set-up)
    // the cluster's a_bar and the eigenvalues of this CTA's modes, which
    // coef_out reads after a CTA barrier: that of the split k-steps below
    // (a CTA holds fewer mode tiles than warps) or of the CUDA-core path
    const int mtiles = modes / 16, per = (mtiles + G - 1) / G;
    const int tile0 = rho * per, tiles = max(0, min(per, mtiles - tile0));
    float* lam = cluster_f32(Smem::kLam);
    if (threadIdx.x < G)
      abar[threadIdx.x] = *cl.map_shared_rank(cluster_f32(Smem::kAbar), threadIdx.x);
    else if (threadIdx.x - G < tiles * 16)
      lam[threadIdx.x - G] = s->lam[tile0 * 16 + threadIdx.x - G];
    // coef[m][ch] = sum_cell V[m][cell] bf16(r)[ch][cell] on modes slice rho
    const auto coef_out = [&](int tile, int row, int ch, float v) {
      const int m = (tile0 + tile) * 16 + row;
      const __nv_bfloat16 c = __float2bfloat16(v / (lam[tile * 16 + row] * abar[ch]));
      for (int q = 0; q < G; ++q) cl.map_shared_rank(cb, q)[ch * cbs + m] = c;
    };
    if constexpr (MMA_COEF) {
      // a k-step is 32 cells, two mma k-steps: lane (g, t) holds cells
      // 8t..8t+7 of the chunk, of V's rows g and g + 8 and of chain g's
      // bf16(r), one 16-byte load each (the sum is over the cells, so their
      // order in the mma's k slots is free: step 0 takes cells 8t..8t+3 in
      // slots 2t, 2t + 1, 2t + 8, 2t + 9; step 1 cells 8t + 4..8t + 7)
      cta_tile_products<G, Smem>(
          tiles, kCells / 32,
          [&](float(&acc)[(G + 7) / 8][4], int tile, int k) {
            const __nv_bfloat16* row = V + static_cast<size_t>((tile0 + tile) * 16 + g) * kCells +
                                       k * 32 + 8 * t;
            const uint4 lo = *reinterpret_cast<const uint4*>(row);
            const uint4 hi = *reinterpret_cast<const uint4*>(row + 8 * kCells);
            const uint32_t a0[4] = {lo.x, hi.x, lo.y, hi.y}, a1[4] = {lo.z, hi.z, lo.w, hi.w};
#pragma unroll
            for (int nt = 0; nt < (G + 7) / 8; ++nt) {
              const int ch = nt * 8 + g;
              const uint4 b = ch < G ? *reinterpret_cast<const uint4*>(
                                           cl.map_shared_rank(rb, ch) + k * 32 + 8 * t)
                                     : make_uint4(0u, 0u, 0u, 0u);
              mma_16816(acc[nt], a0, b.x, b.y);
              mma_16816(acc[nt], a1, b.z, b.w);
            }
          },
          coef_out);
    } else {
      // the cluster's bf16(r) copied to the free floats (after the staged
      // columns of V), then a warp a mode of the slice: lane l sums, for
      // every chain, cells 8 l..8 l + 7 of each block of 256 in order
      // (16-byte loads), the blocks in order, then a warp sum: f32 FMAs on
      // the CUDA cores
      static_assert(2 * G * kCells + (MMA_BACK ? 0 : 2 * kSlice * kVStride) <= 4 * kFreeFloats,
                    "the free floats hold the cluster's r");
      uint4* rb_all = reinterpret_cast<uint4*>(
          cluster_f32(kArrFree + (MMA_BACK ? 0 : kSlice * kVStride / 2)));
      for (int e = threadIdx.x; e < G * kCells / 8; e += blockDim.x)
        rb_all[e] = reinterpret_cast<const uint4*>(cl.map_shared_rank(rb, e / (kCells / 8)))[
            e % (kCells / 8)];
      __syncthreads();  // the cluster's r, a_bar and the eigenvalues
      const int w = threadIdx.x >> 5, nw = blockDim.x >> 5;
      for (int mi = w; mi < tiles * 16; mi += nw) {
        const __nv_bfloat16* row = V + static_cast<size_t>(tile0 * 16 + mi) * kCells;
        float acc[G];
#pragma unroll
        for (int ch = 0; ch < G; ++ch) acc[ch] = 0.0f;
        for (int c8 = l; c8 < kCells / 8; c8 += 32) {
          float v[8];
          unpack_bf16x8(*reinterpret_cast<const uint4*>(row + 8 * c8), v);
#pragma unroll
          for (int ch = 0; ch < G; ++ch) {
            float x[8];
            unpack_bf16x8(rb_all[ch * (kCells / 8) + c8], x);
#pragma unroll
            for (int i = 0; i < 8; ++i) acc[ch] += v[i] * x[i];
          }
        }
#pragma unroll
        for (int ch = 0; ch < G; ++ch) {
          const float sum = warp_sum(acc[ch]);
          if (l == ch) coef_out(mi / 16, mi % 16, ch, sum);
        }
      }
    }
    cl.sync();  // every coefficient is in every CTA
    // back[cell][ch] = sum_m V[m][cell] coef[m][ch] on cells slice rho
    const int c0 = rho * kSlice;
    // fragment row r of a tile is its cell 2 (r % 8) + r / 8 (see below)
    const auto back_out = [&](int tile, int row, int ch, float v) {
      cl.map_shared_rank(back, ch)[c0 + tile * 16 + 2 * (row % 8) + row / 8] = v;
    };
    if constexpr (MMA_BACK) {
      // the tile's rows are its 16 cells in the order 0, 2, ..., 14 (rows
      // g), 1, 3, ..., 15 (rows g + 8), so that lane (g, t) reads cells
      // 2g, 2g + 1 of a mode's row in one 32-bit word and a warp's load
      // covers 32 contiguous bytes of four rows of V; a byte permute pairs
      // the two modes of one cell
      cta_tile_products<G, Smem>(
          kSlice / 16, modes / 16,
          [&](float(&acc)[(G + 7) / 8][4], int tile, int k) {
            const __nv_bfloat16* p =
                V + static_cast<size_t>(k * 16 + 2 * t) * kCells + c0 + tile * 16 + 2 * g;
            const uint32_t w0 = ld_pair(p), w1 = ld_pair(p + kCells);
            const uint32_t w2 = ld_pair(p + 8 * kCells), w3 = ld_pair(p + 9 * kCells);
            const uint32_t a[4] = {__byte_perm(w0, w1, 0x5410), __byte_perm(w0, w1, 0x7632),
                                   __byte_perm(w2, w3, 0x5410), __byte_perm(w2, w3, 0x7632)};
#pragma unroll
            for (int nt = 0; nt < (G + 7) / 8; ++nt) {
              const int ch = nt * 8 + g;
              const __nv_bfloat16* b = cb + ch * cbs + k * 16 + 2 * t;
              mma_16816(acc[nt], a, ch < G ? ld_pair(b) : 0u, ch < G ? ld_pair(b + 8) : 0u);
            }
          },
          back_out);
    } else {
      // a thread a cell of the slice and the chains q, q + R, ...: f32
      // FMAs on the CUDA cores over the modes in ascending order, the order
      // of a plain f32 product, from the slice's columns of V staged by
      // stage_columns (the tensor cores sum V^T coef, an f32 term of z, in
      // another order, and part more chains from the plain twin)
      constexpr int R = T >= kSlice ? T / kSlice : 1, J = (G + R - 1) / R;
      const __nv_bfloat16* vs = reinterpret_cast<const __nv_bfloat16*>(cluster_f32(kArrFree));
      for (int e = threadIdx.x; e < kSlice * R; e += blockDim.x) {
        const int cell = e % kSlice, q = e / kSlice;
        float acc[J];
#pragma unroll
        for (int j = 0; j < J; ++j) acc[j] = 0.0f;
        for (int m0 = 0; m0 < modes; m0 += 8) {  // 8 modes: a 16-byte load of each row
          float v[8];
          unpack_bf16x8(*reinterpret_cast<const uint4*>(vs + cell * kVStride + m0), v);
#pragma unroll
          for (int j = 0; j < J; ++j)
            if (q + j * R < G) {
              float c[8];
              unpack_bf16x8(*reinterpret_cast<const uint4*>(cb + (q + j * R) * cbs + m0), c);
#pragma unroll
              for (int i = 0; i < 8; ++i) acc[j] += v[i] * c[i];
            }
        }
#pragma unroll
        for (int j = 0; j < J; ++j)
          if (q + j * R < G) back_out(cell / 16, cell % 2 * 8 + cell % 16 / 2, q + j * R, acc[j]);
      }
    }
    cl.sync();  // this chain's back is whole
    const float* inv_diag = cluster_f32(kArrInv);
#pragma unroll
    for (int c = 0; c < C; ++c) z[c] = inv_diag[own_cell(c)] * r[c] + back[own_cell(c)];
  }
};

// darcy_setup on a cluster level: the field from the cluster's
// reconstruction, then this chain's face terms, boundary terms, inverse
// diagonal (to shared memory) and a_bar (to the cluster's exchange) as
// darcy_setup computes them.
template <class L>
__device__ void darcy_setup_cluster(const L& lv, const float* u) {
  constexpr int C = L::kC, n = L::kN, cells = L::kCells;
  const float h2 = static_cast<float>(cells);
  float* cell_a = cluster_f32(L::kArrCellA);
  float* cell_b = cluster_f32(L::kArrCellB);
  float* th_s = cluster_f32(L::kArrTh);
  lv.reconstruct(u);
  float a[C], th[C], tv[C];
#pragma unroll
  for (int c = 0; c < C; ++c) a[c] = cell_a[own_cell(c)];
  // harmonic-mean transmissibilities of the faces right of and below the cell
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int t = own_cell(c), i = t / n, j = t % n;
    th[c] = 0.0f;
    tv[c] = 0.0f;
    if (j < n - 1) {
      const float ar = cell_a[t + 1];
      th[c] = 2.0f * a[c] * ar / (a[c] + ar + 1e-38f) * h2;
    }
    if (i < n - 1) {
      const float ad = cell_a[t + n];
      tv[c] = 2.0f * a[c] * ad / (a[c] + ad + 1e-38f) * h2;
    }
    th_s[t] = th[c];
    cell_b[t] = tv[c];
  }
  __syncthreads();
  float log_a[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int t = own_cell(c), i = t / n, j = t % n;
    const float th_l = j > 0 ? th_s[t - 1] : 0.0f;
    const float tv_u = i > 0 ? cell_b[t - n] : 0.0f;
    // Dirichlet faces at half-cell distance: 2 h^-2 a per boundary side
    const float edge = static_cast<float>((i == 0) + (i == n - 1) + (j == 0) + (j == n - 1));
    const float bnd = 2.0f * h2 * a[c] * edge;
    cluster_f32(L::kArrBnd)[t] = bnd;
    cluster_f32(L::kArrInv)[t] = 1.0f / (th[c] + th_l + tv[c] + tv_u + bnd);
    log_a[c] = logf(a[c]);
  }
  const float a_bar = expf(block_sum(cells_sum<C>(log_a), cluster_f32(L::Smem::kRed)) / h2);
  // read by the cluster after the next cluster barrier
  if (threadIdx.x == 0) *cluster_f32(L::Smem::kAbar) = a_bar;
}

// apply_operator on a cluster level: (A p) on this thread's cells, p
// handed round through cell_a, the stencil's terms read from shared
// memory. The caller's next write to cell_a must come after a later
// barrier.
template <class L>
__device__ __forceinline__ void apply_operator_cluster(const float (&p)[L::kC],
                                                       float (&Ap)[L::kC]) {
  constexpr int n = L::kN;
  float* cell = cluster_f32(L::kArrCellA);
  const float* th = cluster_f32(L::kArrTh);
  const float* tv = cluster_f32(L::kArrCellB);
  const float* bnd = cluster_f32(L::kArrBnd);
#pragma unroll
  for (int c = 0; c < L::kC; ++c) cell[own_cell(c)] = p[c];
  __syncthreads();
#pragma unroll
  for (int c = 0; c < L::kC; ++c) {
    const int t = own_cell(c), i = t / n, j = t % n;
    const float pr = j < n - 1 ? cell[t + 1] : 0.0f;
    const float pd = i < n - 1 ? cell[t + n] : 0.0f;
    const float pl = j > 0 ? cell[t - 1] : 0.0f;
    const float pu = i > 0 ? cell[t - n] : 0.0f;
    const float th_l = j > 0 ? th[t - 1] : 0.0f;
    const float tv_u = i > 0 ? tv[t - n] : 0.0f;
    Ap[c] = th[t] * (p[c] - pr) - th_l * (pl - p[c]) + tv[t] * (p[c] - pd) -
            tv_u * (pu - p[c]) + bnd[t] * p[c];
  }
}

// darcy_cg<WARM, C> on a cluster level: the same guards and order of
// operations, the cluster-level preconditioner.
template <bool WARM, class L>
__device__ void darcy_cg_cluster(const L& lv, const float (&b)[L::kC], float (&x)[L::kC]) {
  constexpr int C = L::kC;
  float* red = cluster_f32(L::Smem::kRed);
  float r[C], z[C], p[C], Ap[C];
#pragma unroll
  for (int c = 0; c < C; ++c) r[c] = b[c];
  if (WARM) {
    apply_operator_cluster<L>(x, Ap);
#pragma unroll
    for (int c = 0; c < C; ++c) r[c] = r[c] - Ap[c];
    __syncthreads();
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) x[c] = 0.0f;
  }
  lv.precond(r, z);
#pragma unroll
  for (int c = 0; c < C; ++c) p[c] = z[c];
  float rz = block_sum(cells_dot<C>(r, z), red);
  for (int it = 0; it < lv.s->cg_iters; ++it) {
    apply_operator_cluster<L>(p, Ap);
    const float pAp = block_sum(cells_dot<C>(p, Ap), red);
    const float alpha = pAp > 0.0f ? rz / pAp : 0.0f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      x[c] = x[c] + alpha * p[c];
      r[c] = r[c] - alpha * Ap[c];
    }
    lv.precond(r, z);
    const float rz_new = block_sum(cells_dot<C>(r, z), red);
    const float beta = rz > 0.0f ? rz_new / rz : 0.0f;
#pragma unroll
    for (int c = 0; c < C; ++c) p[c] = z[c] + beta * p[c];
    rz = rz_new;
  }
}

// darcy_solve on a cluster level: Phi(u) for this CTA's chain, whose
// coefficients sit in shared memory at u (the same buffer in every CTA);
// WARM starts from this thread's cells of x. Every CTA of the cluster calls.
template <bool WARM, class L>
__device__ float darcy_solve_cluster(const L& lv, const float* u, float (&x)[L::kC]) {
  constexpr int C = L::kC;
  darcy_setup_cluster(lv, u);
  float b[C];
  bool own[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    b[c] = lv.s->source[own_cell(c)];
    own[c] = true;
  }
  darcy_cg_cluster<WARM>(lv, b, x);
  return darcy_observe<C>(*lv.s, x, own, cluster_ws<typename L::Smem>(), nullptr);
}

// The two levels of the 64 x 64 kernels on the design's threads: the
// 32 x 32 surrogate with as many cells a thread as its grid needs.
constexpr int kClusterSurrC =
    (kClusterSurrN * kClusterSurrN + ClusterDesign::kThreads - 1) / ClusterDesign::kThreads;
using ClusterExact = ClusterLevel<kClusterExactN, ClusterDesign::kCells, ClusterDesign::kThreads,
                                  ClusterDesign::kG, true, true>;
using ClusterSurr = ClusterLevel<kClusterSurrN, kClusterSurrC, ClusterDesign::kThreads,
                                 ClusterDesign::kG, ClusterDesign::kSurrMmaCoef,
                                 ClusterDesign::kSurrMmaBack>;

// The level of the 32 x 32 warm pCN kernel, in a layout of its own sized
// for 32 x 32 cells, K up to 64 and 128 modes.
using Cluster32Smem =
    ClusterSmemT<kCluster32N * kCluster32N, Cluster32Design::kG, Cluster32Design::kThreads,
                 kCluster32MaxK, kCluster32MaxModes>;
using Cluster32Exact =
    ClusterLevel<kCluster32N, Cluster32Design::kCells, Cluster32Design::kThreads,
                 Cluster32Design::kG, true, true, Cluster32Smem>;

// A level the cluster kernels take: an n x n grid, K = d up to max_k,
// dst_trunc with a multiple of 16 modes up to the cells and max_modes,
// solved by CG.
inline bool cluster_level_ok(const IpxMisfitSpec& s, int n, int d, int max_modes,
                             int max_k = kClusterMaxK) {
  return s.n == n && s.K == d && s.K <= max_k && s.precond == kPrecondDstTrunc &&
         s.modes > 0 && s.modes % 16 == 0 && s.modes <= n * n && s.modes <= max_modes &&
         s.solver == kSolverCg && s.m >= 0;
}

// Mirrored by ip_mcmc_tpu_torch/ops/_cluster.py cluster_geometry: the 64 x 64
// kernels (surr: null for the warm pCN kernel, one level) and, for a 32 x 32
// exact level with no surrogate, the 32 x 32 warm pCN kernel. G is the
// design's kG whatever block_chains: a CTA runs chain blockIdx.x with the
// seed and lane of run_chain, so the chains of a cluster need not share an
// RNG block.
inline int cluster_geometry(const IpxMisfitSpec& exact, const IpxMisfitSpec* surr,
                            const IpxChainArgs& chain, ClusterGeometry* geo) {
  const bool n32 = exact.n == kCluster32N;
  if (n32 ? surr != nullptr ||
                !cluster_level_ok(exact, kCluster32N, chain.d, kCluster32MaxModes, kCluster32MaxK)
          : !cluster_level_ok(exact, kClusterExactN, chain.d, kClusterMaxModes) ||
                (surr != nullptr &&
                 !cluster_level_ok(*surr, kClusterSurrN, chain.d, kClusterSurrMaxModes)))
    return cudaErrorNotSupported;
  if (chain.block_chains <= 0 || chain.n < 0 || chain.n_steps < 0 ||
      (chain.samples != nullptr && chain.thin <= 0))
    return cudaErrorInvalidValue;
  geo->g = n32 ? Cluster32Design::kG : ClusterDesign::kG;
  geo->clusters = (chain.n + geo->g - 1) / geo->g;
  geo->ctas = geo->clusters * geo->g;
  geo->threads = n32 ? Cluster32Design::kThreads : ClusterDesign::kThreads;
  geo->smem = n32 ? Cluster32Smem::kBytes : ClusterSmem::kBytes;
  return geo->smem <= 232448 ? cudaSuccess : cudaErrorInvalidValue;
}

// --- the standalone misfits on the samplers' cluster levels -----------------
//
// Phi (and, warm, the CG solution) for a (K, B) batch of draws, the misfit
// that the cluster samplers evaluate at their start positions: one draw a
// CTA, G draws a thread-block cluster, the solve of the samplers' exact
// level, so that Phi0 and every proposal's Phi come from one solve. At
// 64 x 64 (darcy_misfit_cluster_kernel in fused_da_pcn.cu,
// darcy_misfit_warm_cluster_kernel in fused_pcn.cu) on ClusterExact; at
// 32 x 32 (darcy_misfit_cluster32_kernel, darcy_misfit_warm_cluster32_kernel)
// on Cluster32Exact, the level of the 32 x 32 warm pCN; the 64 x 64 DA
// kernel's 32 x 32 surrogate (darcy_misfit_surr_cluster_kernel, Phi* at its
// start positions) on ClusterSurr, so that Phi*0 and every proposal's Phi*
// come from one solve too. One draw a CTA of
// Layout64 / Layout32 read the factors from L2 once a draw (at 64 x 64 the
// f32 basis 2.4 MB once, the bf16 modes 2 MB twice an apply; at 32 x 32
// 256 KB and 256 KB); the cluster reads them once a cluster and runs the
// dst_trunc products on the tensor cores with the draws as N. Spare CTAs of
// a ragged last cluster run on zeros and write nothing.

// What the kernels take: U (K, B); warm: x0 (cells, B) in, x (cells, B)
// out; Phi (B,) out.
struct MisfitBatch {
  IpxMisfitSpec s;
  const float* U;
  const float* x0;
  int B;
  float* phi;
  float* x;
};

// The cluster level a standalone misfit runs on: the exact level of the
// 64 x 64 samplers (ClusterExact), the level of the 32 x 32 warm pCN
// (Cluster32Exact), the 32 x 32 surrogate level of the 64 x 64 DA kernel
// (ClusterSurr), or none. The surrogate level is tried after the 32 x 32
// one, so that a 32 x 32 spec with K up to kCluster32MaxK stays there: it
// takes 32 x 32 specs with kCluster32MaxK < K <= kClusterMaxK.
enum MisfitClusterLevel {
  kNoClusterLevel,
  kClusterLevelExact,
  kClusterLevel32,
  kClusterLevelSurr
};
inline MisfitClusterLevel misfit_cluster_level(const IpxMisfitSpec& s) {
  if (cluster_level_ok(s, kClusterExactN, s.K, kClusterMaxModes)) return kClusterLevelExact;
  if (cluster_level_ok(s, kCluster32N, s.K, kCluster32MaxModes, kCluster32MaxK))
    return kClusterLevel32;
  if (cluster_level_ok(s, kClusterSurrN, s.K, kClusterSurrMaxModes)) return kClusterLevelSurr;
  return kNoClusterLevel;
}

// Whether the cluster misfit kernels take this spec (ipx_darcy_misfit sends
// it to them, every other spec to the kernels of its layout): a spec of
// one of the three levels of misfit_cluster_level. Mirrored by
// ip_mcmc_tpu_torch/ops/_cluster.py misfit_cluster_takes.
inline bool misfit_cluster_takes(const IpxMisfitSpec& s) {
  return misfit_cluster_level(s) != kNoClusterLevel;
}

// The same for a warm misfit (ipx_darcy_misfit_warm): the exact level of
// the 64 x 64 samplers or the level of the 32 x 32 warm pCN. No sampler
// carries a solution on the surrogate level, so a warm spec of it keeps the
// kernel of its layout. Mirrored by misfit_cluster_takes(..., warm=True).
inline bool misfit_cluster_warm_takes(const IpxMisfitSpec& s) {
  const MisfitClusterLevel level = misfit_cluster_level(s);
  return level == kClusterLevelExact || level == kClusterLevel32;
}

// Mirrored by ip_mcmc_tpu_torch/ops/_cluster.py misfit_cluster_geometry: G
// draws a cluster (the design's kG at the level: Cluster32Design at the
// 32 x 32 warm pCN's, ClusterDesign at the two levels of the 64 x 64
// samplers), the spare CTAs of a ragged last cluster; what
// misfit_cluster_takes refuses, cudaErrorNotSupported.
inline int misfit_cluster_geometry(const IpxMisfitSpec& s, int B, ClusterGeometry* geo) {
  if (!misfit_cluster_takes(s)) return cudaErrorNotSupported;
  if (B < 0) return cudaErrorInvalidValue;
  const bool n32 = misfit_cluster_level(s) == kClusterLevel32;
  geo->g = n32 ? Cluster32Design::kG : ClusterDesign::kG;
  geo->clusters = (B + geo->g - 1) / geo->g;
  geo->ctas = geo->clusters * geo->g;
  geo->threads = n32 ? Cluster32Design::kThreads : ClusterDesign::kThreads;
  geo->smem = n32 ? Cluster32Smem::kBytes : ClusterSmem::kBytes;
  return cudaSuccess;
}

// The body of the kernels on level L: draw blockIdx.x's coefficients to
// the buffer the level reads u from (L's kState, as the samplers' state;
// the set-up's first cluster barrier orders these writes before any CTA
// reads them), the level's columns of V where it keeps them in shared
// memory (ClusterSurr, as DaClusterStep stages them before its surrogate
// solves; a no-op on a level with MMA_BACK, which reads V through L2; the
// same barrier orders them), WARM its cells of x0 to registers, one solve,
// then Phi from thread 0 and (WARM) the thread's cells of x.
template <bool WARM, class L>
__device__ void misfit_cluster_draw(const MisfitBatch& a) {
  constexpr int C = L::kC;
  const int b = blockIdx.x, B = a.B;
  const bool live = b < B;
  const L lv{&a.s};
  float* u = cluster_f32(L::Smem::kState);
  for (int k = threadIdx.x; k < a.s.K; k += blockDim.x)
    u[k] = live ? a.U[static_cast<size_t>(k) * B + b] : 0.0f;
  lv.stage_columns();
  float x[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    x[c] = 0.0f;
    if constexpr (WARM)
      if (live) x[c] = a.x0[static_cast<size_t>(own_cell(c)) * B + b];
  }
  const float v = darcy_solve_cluster<WARM>(lv, u, x);
  if (live) {
    if constexpr (WARM) {
#pragma unroll
      for (int c = 0; c < C; ++c) a.x[static_cast<size_t>(own_cell(c)) * B + b] = x[c];
    }
    if (threadIdx.x == 0) a.phi[b] = v;
  }
  cg::this_cluster().sync();  // no peer reads this CTA's shared memory after it exits
}

// Launches the kernel of the spec's level (k64 on ClusterExact, k32 on
// Cluster32Exact, ksurr on ClusterSurr; null: cudaErrorNotSupported) on the
// batch: the status of the geometry, of the occupancy check or of the
// launch.
inline int launch_misfit_cluster(void (*k64)(MisfitBatch), void (*k32)(MisfitBatch),
                                 void (*ksurr)(MisfitBatch), const MisfitBatch& a,
                                 void* stream) {
  ClusterGeometry geo;
  const int status = misfit_cluster_geometry(a.s, a.B, &geo);
  if (status != cudaSuccess) return status;
  const MisfitClusterLevel level = misfit_cluster_level(a.s);
  void (*kernel)(MisfitBatch) =
      level == kClusterLevel32 ? k32 : level == kClusterLevelSurr ? ksurr : k64;
  if (kernel == nullptr) return cudaErrorNotSupported;
  if (a.B == 0) return cudaSuccess;
  return launch_cluster(kernel, geo, stream, a);
}

}  // namespace ipx
