// Batched Darcy misfit as device functions run by one CTA per chain: the
// arithmetic of ip_mcmc_tpu/models/darcy.py make_batched_misfit (K5, l.542;
// with differentiable=True its adjoint phi_bwd, l.637),
// make_batched_misfit_warm (K7, l.669) and make_batched_misfit_mala_warm
// (l.783) with _flat_transmissibilities l.337, _apply_operator_flat l.347,
// _operator_diagonal_flat l.357, _cg_flat l.363, _flat_dst_preconditioner
// l.445 and _flat_truncated_dst_preconditioner l.490.
//
// The solve comes in three parts, so that a second right-hand side can be
// solved on the same operator: darcy_setup (field, face transmissibilities,
// diagonal, mean coefficient), darcy_cg (fixed-count PCG on any right-hand
// side, from 0 or from a carried start) and darcy_observe (residuals at the
// observed cells and Phi). darcy_solve chains them for the misfit alone;
// darcy_value_and_grad adds the adjoint solve and the closed-form
// derivative of the harmonic means.
//
// Thread t owns cell t of the n x n grid (t < n*n); the CG vectors x, r,
// z, Ap and the cell's face transmissibilities live in its registers.
// Shared memory holds what neighbours or reductions read: the search
// direction p (stencil), bf16(r) and the spectral coefficients
// (preconditioner), and the warp partial sums. Every thread of the CTA
// calls these functions (threads t >= n*n contribute zeros), so every
// __syncthreads is reached by the whole block.
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
} IpxMisfitSpec;
}

enum { kPrecondJacobi = 0, kPrecondDstTrunc = 1, kPrecondDst = 2 };

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

// Dense fast-Poisson apply (precond "dst"): the 2-D sine transform along
// columns then rows, a divide by lam * a_bar, and the transposed transforms
// back; n multiply-adds per thread per stage. Inputs of every stage are
// rounded to bf16 (the four rounding points of _flat_dst_preconditioner's
// Kronecker matmuls), sums are f32. No Jacobi term.
__device__ float apply_dst(const IpxMisfitSpec& s, float r, float a_bar,
                           const MisfitSmem& ws) {
  const int t = threadIdx.x, n = s.n;
  const bool own = t < n * n;
  const int i = own ? t / n : 0, j = own ? t % n : 0;
  const __nv_bfloat16* S = static_cast<const __nv_bfloat16*>(s.S);
  if (own) ws.cell_b[t] = bf16_round(r);
  __syncthreads();
  float acc = 0.0f;
  if (own) {  // y[i, k=j] = sum_q S[k, q] r[i, q]
    for (int q = 0; q < n; ++q) acc += __bfloat162float(S[j * n + q]) * ws.cell_b[i * n + q];
    ws.cell_a[t] = bf16_round(acc);
  }
  __syncthreads();
  if (own) {  // rt[k1=i, k2=j] = sum_q S[k1, q] y[q, k2] / (lam a_bar)
    acc = 0.0f;
    for (int q = 0; q < n; ++q) acc += __bfloat162float(S[i * n + q]) * ws.cell_a[q * n + j];
    ws.cell_b[t] = bf16_round(acc / (s.lam[t] * a_bar));
  }
  __syncthreads();
  if (own) {  // w[i, k2=j] = sum_q S[q, i] rt[q, k2]
    acc = 0.0f;
    for (int q = 0; q < n; ++q) acc += __bfloat162float(S[q * n + i]) * ws.cell_b[q * n + j];
    ws.cell_a[t] = bf16_round(acc);
  }
  __syncthreads();
  acc = 0.0f;
  if (own)  // z[i, j] = sum_q S[q, j] w[i, q]
    for (int q = 0; q < n; ++q) acc += __bfloat162float(S[q * n + j]) * ws.cell_a[i * n + q];
  __syncthreads();
  return acc;
}

// dst_trunc: M^-1 r = D^-1 r + V^T bf16(V bf16(r) / (lam a_bar)), bf16
// inputs, f32 accumulation; jacobi (modes == 0): D^-1 r; dst: apply_dst.
__device__ float apply_precond(const IpxMisfitSpec& s, float r, float inv_diag,
                               float a_bar, const MisfitSmem& ws) {
  if (s.precond == kPrecondDst) return apply_dst(s, r, a_bar, ws);
  const int t = threadIdx.x, cells = s.n * s.n;
  const bool own = t < cells;
  float z = inv_diag * r;
  if (s.modes == 0) return z;
  const __nv_bfloat16* V = static_cast<const __nv_bfloat16*>(s.V);
  if (own) ws.cell_b[t] = bf16_round(r);
  __syncthreads();
  const int lane = t & 31, nw = blockDim.x >> 5;
  for (int m = t >> 5; m < s.modes; m += nw) {
    const __nv_bfloat16* row = V + static_cast<size_t>(m) * cells;
    float acc = 0.0f;
    for (int c = lane; c < cells; c += 32) acc += __bfloat162float(row[c]) * ws.cell_b[c];
    acc = warp_sum(acc);
    if (lane == 0) ws.modes[m] = bf16_round(acc / (s.lam[m] * a_bar));
  }
  __syncthreads();
  if (own) {
    float acc = 0.0f;
    for (int m = 0; m < s.modes; ++m)
      acc += __bfloat162float(V[static_cast<size_t>(m) * cells + t]) * ws.modes[m];
    z = z + acc;
  }
  return z;
}

// The cell's stencil coefficients: faces right (th), left (th_l), below
// (tv), above (tv_u) and the Dirichlet boundary term (bnd).
struct CellStencil {
  float th, th_l, tv, tv_u, bnd;
};

// (A p)[t] with p handed round through shared memory. The caller's next
// write to cell_a must come after a later barrier (a block_sum has two).
__device__ __forceinline__ float apply_operator(const CellStencil& k, float p, bool own,
                                                int i, int j, int n, const MisfitSmem& ws) {
  const int t = threadIdx.x;
  if (own) ws.cell_a[t] = p;
  __syncthreads();
  if (!own) return 0.0f;
  const float pr = j < n - 1 ? ws.cell_a[t + 1] : 0.0f;
  const float pd = i < n - 1 ? ws.cell_a[t + n] : 0.0f;
  const float pl = j > 0 ? ws.cell_a[t - 1] : 0.0f;
  const float pu = i > 0 ? ws.cell_a[t - n] : 0.0f;
  return k.th * (p - pr) - k.th_l * (pl - p) + k.tv * (p - pd) - k.tv_u * (pu - p) + k.bnd * p;
}

// One chain's operator A(a): what darcy_setup leaves in this thread's
// registers for the solves that follow.
struct DarcyOperator {
  CellStencil k;
  float a, inv_diag, a_bar;
  int i, j;
  bool own;  // t < n*n
};

// a = exp(log_a_mean + basis^T u) for the chain whose coefficients u[0..K)
// sit in shared memory, the stencil of this thread's cell, the inverse
// diagonal and the geometric-mean coefficient a_bar.
__device__ DarcyOperator darcy_setup(const IpxMisfitSpec& s, const float* u,
                                     const MisfitSmem& ws) {
  const int t = threadIdx.x, n = s.n, cells = n * n;
  const bool own = t < cells;
  const int i = own ? t / n : 0, j = own ? t % n : 0;
  const float h2 = static_cast<float>(cells);

  // KL reconstruction log a = log_a_mean + basis^T u, and a = exp(log a)
  float a = 1.0f;
  if (own) {
    float acc = 0.0f;
    for (int k = 0; k < s.K; ++k) acc += s.basis[static_cast<size_t>(k) * cells + t] * u[k];
    a = expf(s.log_a_mean + acc);
    ws.cell_a[t] = a;
  }
  __syncthreads();
  // harmonic-mean transmissibilities of the faces right of and below the cell
  CellStencil k{0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (own) {
    if (j < n - 1) {
      const float ar = ws.cell_a[t + 1];
      k.th = 2.0f * a * ar / (a + ar + 1e-38f) * h2;
    }
    if (i < n - 1) {
      const float ad = ws.cell_a[t + n];
      k.tv = 2.0f * a * ad / (a + ad + 1e-38f) * h2;
    }
  }
  __syncthreads();
  if (own) {
    ws.cell_a[t] = k.th;
    ws.cell_b[t] = k.tv;
  }
  __syncthreads();
  if (own) {
    if (j > 0) k.th_l = ws.cell_a[t - 1];
    if (i > 0) k.tv_u = ws.cell_b[t - n];
  }
  // Dirichlet faces at half-cell distance: 2 h^-2 a per boundary side
  const float edge = static_cast<float>((i == 0) + (i == n - 1) + (j == 0) + (j == n - 1));
  k.bnd = 2.0f * h2 * a * edge;
  const float inv_diag = own ? 1.0f / (k.th + k.th_l + k.tv + k.tv_u + k.bnd) : 0.0f;
  const float a_bar = expf(block_sum(own ? logf(a) : 0.0f, ws.red) / h2);
  return DarcyOperator{k, a, inv_diag, a_bar, i, j, own};
}

// Fixed-count PCG on A x = b, b being this thread's cell of the right-hand
// side. WARM: starts from this thread's cell of a previous solution, passed
// in x (r = b - A x0); otherwise from 0. On return x is this thread's cell
// of the solution. alpha = 0 when pAp <= 0 and beta = 0 when rz <= 0, so a
// converged solve freezes instead of producing NaN.
template <bool WARM>
__device__ void darcy_cg(const IpxMisfitSpec& s, const DarcyOperator& op, float b,
                         const MisfitSmem& ws, float& x) {
  const int n = s.n;
  float r = b;
  if (WARM) {
    if (!op.own) x = 0.0f;
    r = r - apply_operator(op.k, x, op.own, op.i, op.j, n, ws);
    __syncthreads();  // the stencil's reads end before the preconditioner writes
  } else {
    x = 0.0f;
  }
  float z = apply_precond(s, r, op.inv_diag, op.a_bar, ws);
  float p = z;
  float rz = block_sum(r * z, ws.red);
  for (int it = 0; it < s.cg_iters; ++it) {
    const float Ap = apply_operator(op.k, p, op.own, op.i, op.j, n, ws);
    const float pAp = block_sum(p * Ap, ws.red);
    const float alpha = pAp > 0.0f ? rz / pAp : 0.0f;
    x = x + alpha * p;
    r = r - alpha * Ap;
    z = apply_precond(s, r, op.inv_diag, op.a_bar, ws);
    const float rz_new = block_sum(r * z, ws.red);
    const float beta = rz > 0.0f ? rz_new / rz : 0.0f;
    p = z + beta * p;
    rz = rz_new;
  }
}

// Pressure at the observed cells and Phi = 1/2 ||(y - pred) / sigma||^2,
// the same value in every thread. The residuals (y - pred) / sigma go to
// res[0..m) in shared memory when res is given.
__device__ float darcy_observe(const IpxMisfitSpec& s, float x, bool own,
                               const MisfitSmem& ws, float* res_out) {
  const int t = threadIdx.x;
  if (own) ws.cell_a[t] = x;
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
// the same value in every thread. WARM: CG starts from this thread's cell
// of the previous solution, passed in x; otherwise from 0. On return x is
// this thread's cell of the solution.
template <bool WARM>
__device__ float darcy_solve(const IpxMisfitSpec& s, const float* u,
                             const MisfitSmem& ws, float& x) {
  const DarcyOperator op = darcy_setup(s, u, ws);
  darcy_cg<WARM>(s, op, op.own ? s.source[threadIdx.x] : 0.0f, ws, x);
  return darcy_observe(s, x, op.own, ws, nullptr);
}

// The cold misfit (K5): Phi(u) from a zero start.
__device__ __forceinline__ float darcy_phi(const IpxMisfitSpec& s, const float* u,
                                           const MisfitSmem& ws) {
  float x;
  return darcy_solve<false>(s, u, ws, x);
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
// t before the call); the solutions are left there either way.
template <bool WARM>
__device__ float darcy_value_and_grad(const IpxMisfitSpec& s, const float* u,
                                      const MisfitSmem& ws, const GradSmem& gs, float* g) {
  const int t = threadIdx.x, n = s.n, cells = n * n;
  const DarcyOperator op = darcy_setup(s, u, ws);
  const bool own = op.own;
  const int i = op.i, j = op.j;
  if (own) gs.a[t] = op.a;

  float x = (WARM && own) ? gs.x[t] : 0.0f;
  darcy_cg<WARM>(s, op, own ? s.source[t] : 0.0f, ws, x);
  const float phi = darcy_observe(s, x, own, ws, gs.res);
  if (own) gs.x[t] = x;

  // dPhi/dx = -O^T(res / sigma): a scatter to the observed cells
  float b = 0.0f;
  if (own) {
    for (int o = 0; o < s.m; ++o)
      if (s.obs[o] == t) b += gs.res[o] / s.noise[o];
    b = -b;
  }
  float lam = (WARM && own) ? gs.lam[t] : 0.0f;
  darcy_cg<WARM>(s, op, b, ws, lam);
  if (own) gs.lam[t] = lam;
  __syncthreads();

  if (own) {
    const float two_h2 = 2.0f * static_cast<float>(cells);
    const float a = gs.a[t], xc = gs.x[t];
    float t_r = 0.0f, t_l = 0.0f, t_d = 0.0f, t_u = 0.0f;
    if (j < n - 1) {  // the face to the right: this cell's own share
      const float ar = gs.a[t + 1], den = 1.0f / (a + ar + 1e-38f), q = ar * den;
      t_r = two_h2 * (q * q) * ((xc - gs.x[t + 1]) * (lam - gs.lam[t + 1]));
    }
    if (j > 0) {  // the left neighbour's right face: the neighbour share
      const float al = gs.a[t - 1], den = 1.0f / (al + a + 1e-38f), q = al * den;
      t_l = two_h2 * (q * q) * ((gs.x[t - 1] - xc) * (gs.lam[t - 1] - lam));
    }
    if (i < n - 1) {
      const float ad = gs.a[t + n], den = 1.0f / (a + ad + 1e-38f), q = ad * den;
      t_d = two_h2 * (q * q) * ((xc - gs.x[t + n]) * (lam - gs.lam[t + n]));
    }
    if (i > 0) {
      const float au = gs.a[t - n], den = 1.0f / (au + a + 1e-38f), q = au * den;
      t_u = two_h2 * (q * q) * ((gs.x[t - n] - xc) * (gs.lam[t - n] - lam));
    }
    const float edge = static_cast<float>((i == 0) + (i == n - 1) + (j == 0) + (j == n - 1));
    const float g_a = t_r + t_l + t_d + t_u + two_h2 * xc * lam * edge;
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

// The Darcy misfit as the potential type of the samplers that take one
// (DaStep, PcnStep, Da3Step): what a step needs to know of a potential.
struct DarcyPotential {
  using Spec = IpxMisfitSpec;
  using Workspace = MisfitSmem;
  // the CTA of the samplers: one thread per cell of a 16x16 grid and at
  // least 4 CTAs per SM, which caps registers at 64 a thread
  static constexpr int kMaxThreads = 256;
  static constexpr int kMinCtasPerSm = 4;

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
  static bool valid(const Spec& s) { return s.K > 0 && s.modes >= 0 && s.n > 0; }

  static __device__ __forceinline__ float phi(const Spec& s, const float* u,
                                              const Workspace& ws) {
    return darcy_phi(s, u, ws);
  }

  // A spec evaluated many times per step has its factors staged on chip:
  // the KL basis (f32) and the preconditioner's modes (bf16).
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

}  // namespace ipx
