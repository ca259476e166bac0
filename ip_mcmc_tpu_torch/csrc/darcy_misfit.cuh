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

#include <cuda_bf16.h>

#include <cstdint>

#include "block_reduce.cuh"

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
// the modes are re-read by every chain), and measured on the H100
// (scripts/measure_darcy_layouts.py) the layouts with the most warps per
// SM win even where they spill: 32 x 32 one cell a thread at 1024 threads
// (64 registers), 64 x 64 eight cells a thread at 512 threads and 2 CTAs
// per SM (64 registers, spilling) before 8 x 512 x 1 (128 registers).
struct Layout16 {
  static constexpr int kCells = 1, kThreads = 256, kMinCtas = 4;
};
struct Layout32 {
  static constexpr int kCells = 1, kThreads = 1024, kMinCtas = 1;
};
struct Layout64 {
  static constexpr int kCells = 8, kThreads = 512, kMinCtas = 2;
};

// The layout of a surrogate solved in the CTA of an exact level whose
// layout is Exact (the DA kernel runs both levels in one CTA): Exact's
// threads and CTAs per SM, and as many cells a thread as the surrogate's
// N x N grid needs on them (32 x 32 on 1024 threads: 1; on 512: 2), so that
// no register of a surrogate cell stands empty.
template <class Exact, int N>
struct SurrogateLayout {
  static constexpr int kThreads = Exact::kThreads, kMinCtas = Exact::kMinCtas;
  static constexpr int kCells = (N * N + kThreads - 1) / kThreads;
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

  // A surrogate, evaluated k times per DA step, has its factors staged on
  // chip (stage, staged_bytes) where they fit: the KL basis (f32) and the
  // preconditioner's modes (bf16) of up to 16 x 16 cells, ~24 KB at K = 64.
  // Those of a larger grid do not fit a CTA's 227 KB (32 x 32, K = 144,
  // 128 modes: 0.85 MB) and are read from global memory through L2, as the
  // large grids' warm pCN reads its factors.
  static constexpr bool kStaged = kMaxCells <= 256;

  static __host__ __device__ size_t staged_bytes(const Spec& s) {
    return sizeof(float) * s.K * s.n * s.n + sizeof(__nv_bfloat16) * s.modes * s.n * s.n;
  }
  // Copies the factors of `s` to `base` in shared memory (every thread of
  // the CTA calls) and points `out`, a copy of `s`, at them.
  static __device__ __forceinline__ void stage(const Spec& s, Spec& out, float* base) {
    const int cells = s.n * s.n;
    float* basis = base;
    __nv_bfloat16* V = reinterpret_cast<__nv_bfloat16*>(basis + s.K * cells);
    for (int e = threadIdx.x; e < s.K * cells; e += blockDim.x) basis[e] = s.basis[e];
    const __nv_bfloat16* gV = static_cast<const __nv_bfloat16*>(s.V);
    for (int e = threadIdx.x; e < s.modes * cells; e += blockDim.x) V[e] = gV[e];
    out.basis = basis;
    out.V = V;
  }
};

using DarcyPotential = DarcyPot<Layout16>;

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

}  // namespace ipx
