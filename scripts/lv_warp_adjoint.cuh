// Design B of lv_misfit_grad_kernel: a warp a chain, the adjoint composed
// across the lanes. scripts/measure_lv_design.py builds it in a copy of
// csrc/ in place of the text between the markers "the stages kernel
// (LvStagesDesign)" and "end of the stages kernel" of csrc/lv_rk4.cu (inside
// namespace ipx; the helpers above the markers are the package's) and times
// it beside the shipped kernel. ops/lv_rk4.py adjoint_scan_reference spells
// out its association in PyTorch.
//
// The forward runs in every lane in lockstep (the same bits in each), each
// lane writing the warp's e^Y slice ([chain][step][value]) and the misfit's
// injections, as the stages kernel keeps them. Given the e^Y the
// backward is linear in lam: lam_{i-1} = M_i lam_i (+ the injections at step
// i - 1), with M_i the 2 x 2 adjoint of step i. Lane l owns steps a..b,
// ceil(n_steps / 32) of them: it composes its steps' affine map T_l (lam^+_b
// -> lam^+_{a-1}, the injections inside), a 5-round __shfl_down_sync scan
// composes S_l = T_l o ... o T_31, lane l starts from S_{l+1}(lam^+_N), sweeps
// its steps once more adding (c, s)'s cotangents, and a butterfly sums them.
// Phi is the stages kernel's, in the spec's order.

struct LvWarpDesign { static constexpr int kChains = 2; };  // chains (warps) a CTA

inline size_t lv_stages_smem(const IpxLvSpec& s) {
  return (static_cast<size_t>(s.n_steps) * kLvStageValues + static_cast<size_t>(s.T) * s.S) *
         sizeof(float) * LvWarpDesign::kChains;
}
inline bool lv_stages_takes(const IpxLvSpec& s) { return lv_stages_smem(s) <= kLvMaxSmem; }

// lam -> A lam + v, A column-major (a[0], a[1] its first column)
struct LvAffine {
  float a[4], v[2];

  __device__ __forceinline__ void apply(const float (&x)[2], float (&y)[2]) const {
    y[0] = a[0] * x[0] + a[2] * x[1] + v[0];
    y[1] = a[1] * x[0] + a[3] * x[1] + v[1];
  }
  // this o g: g first
  __device__ __forceinline__ LvAffine after(const LvAffine& g) const {
    LvAffine r;
    r.a[0] = a[0] * g.a[0] + a[2] * g.a[1];
    r.a[1] = a[1] * g.a[0] + a[3] * g.a[1];
    r.a[2] = a[0] * g.a[2] + a[2] * g.a[3];
    r.a[3] = a[1] * g.a[2] + a[3] * g.a[3];
    r.v[0] = a[0] * g.v[0] + a[2] * g.v[1] + v[0];
    r.v[1] = a[1] * g.v[0] + a[3] * g.v[1] + v[1];
    return r;
  }
  __device__ __forceinline__ LvAffine down(int off) const {
    LvAffine r;
#pragma unroll
    for (int k = 0; k < 4; ++k) r.a[k] = __shfl_down_sync(0xffffffffu, a[k], off);
#pragma unroll
    for (int k = 0; k < 2; ++k) r.v[k] = __shfl_down_sync(0xffffffffu, v[k], off);
    return r;
  }
};

// the last index t with obs_step[t] <= step, -1 if none (the steps ascend)
__device__ __forceinline__ int lv_obs_cursor(const IpxLvSpec& s, int step) {
  int lo = 0, hi = s.T;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s.obs_step[mid] <= step) lo = mid + 1;
    else hi = mid;
  }
  return lo - 1;
}

__global__ void __launch_bounds__(32 * LvWarpDesign::kChains)
    lv_misfit_grad_kernel(const __grid_constant__ IpxLvSpec s, const float* __restrict__ theta,
                          int n, float* __restrict__ phi, float* __restrict__ grad) {
  extern __shared__ __align__(16) float lv_e[];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int ch = blockIdx.x * LvWarpDesign::kChains + w;
  if (ch >= n) return;  // the whole warp; no CTA barrier below
  const int N = s.n_steps;
  // the warp's e^Y [step][v], then after every chain's the injections
  const auto E = [&](int i) {
    return lv_e + (static_cast<size_t>(w) * N + i - 1) * kLvStageValues;
  };
  float* const dz = lv_e + static_cast<size_t>(N) * LvWarpDesign::kChains * kLvStageValues +
                    w * s.T * s.S;
  const float ra = expf(theta[4 * ch + 0]), rb = expf(theta[4 * ch + 1]);
  const float rg = expf(theta[4 * ch + 2]), rd = expf(theta[4 * ch + 3]);
  const float c[2] = {ra, -rg}, sc[2] = {-rb, rd};
  float y[2] = {s.z0[0], s.z0[1]};
  for (int i = 1; i <= N; ++i) {
    LvStage st[4];
    float out[2];
    lv_rk4_step(s, c, sc, y, st, out);
    lv_store_stages(E(i), st);
    y[0] = out[0];
    y[1] = out[1];
  }
  __syncwarp();
  const float ezN[2] = {expf(y[0]), expf(y[1])};
  const auto ez = [&](int i, int sp) {
    return i == N ? (sp == 0 ? ezN[0] : ezN[1]) : E(i + 1)[sp];
  };
  const float phi_ch = lv_misfit_dz(s, ez, dz);
  __syncwarp();

  const int per = (N + 31) / 32;
  const int a = lane * per + 1, b = min(a + per - 1, N);  // a > b: no step
  const int cursor = a <= b ? lv_obs_cursor(s, b - 1) : -1;
  // pass 1: T_l, the injections at a - 1 .. b - 1 inside (none at step 0)
  LvAffine T = {{1.0f, 0.0f, 0.0f, 1.0f}, {0.0f, 0.0f}};
  int t = cursor;
  for (int i = b; i >= a; --i) {
    LvStage st[4];
    lv_load_stages(E(i), st);
    float g0[2] = {0.0f, 0.0f}, g1[2] = {0.0f, 0.0f};  // unused
    float c0[2] = {T.a[0], T.a[1]}, c1[2] = {T.a[2], T.a[3]}, v[2] = {T.v[0], T.v[1]};
    lv_step_adjoint(s, st, sc, c0, g0, g1);
    lv_step_adjoint(s, st, sc, c1, g0, g1);
    lv_step_adjoint(s, st, sc, v, g0, g1);
    if (i - 1 >= 1) t = lv_inject_dz(s, t, i - 1, dz, v);
    T = {{c0[0], c0[1], c1[0], c1[1]}, {v[0], v[1]}};
  }
  // S_l = T_l o T_{l+1} o ... o T_31
  LvAffine S = T;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const LvAffine up = S.down(off);
    if (lane + off < 32) S = S.after(up);
  }
  const LvAffine next = S.down(1);
  float lam[2] = {0.0f, 0.0f};
  lv_inject_dz(s, s.T - 1, N, dz, lam);  // lam^+_N
  if (lane < 31) {
    const float top[2] = {lam[0], lam[1]};
    next.apply(top, lam);
  }
  // pass 2: lane l's steps from lam^+_b, the cotangents of (c, s)
  float gc[2] = {0.0f, 0.0f}, gs[2] = {0.0f, 0.0f};
  t = cursor;
  for (int i = b; i >= a; --i) {
    LvStage st[4];
    lv_load_stages(E(i), st);
    lv_step_adjoint(s, st, sc, lam, gc, gs);
    if (i - 1 >= a) t = lv_inject_dz(s, t, i - 1, dz, lam);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      gc[q] += __shfl_xor_sync(0xffffffffu, gc[q], off);
      gs[q] += __shfl_xor_sync(0xffffffffu, gs[q], off);
    }
  }
  if (lane == 0) {
    phi[ch] = phi_ch;
    grad[4 * ch + 0] = gc[0] * ra;
    grad[4 * ch + 1] = -gs[0] * rb;
    grad[4 * ch + 2] = -gc[1] * rg;
    grad[4 * ch + 3] = gs[1] * rd;
  }
}

inline int lv_stages_geometry(const IpxLvSpec& s, int n, int* out) {
  if (!lv_stages_takes(s)) return cudaErrorNotSupported;
  out[0] = LvWarpDesign::kChains;
  out[1] = (n + LvWarpDesign::kChains - 1) / LvWarpDesign::kChains;
  out[2] = static_cast<int>(lv_stages_smem(s));
  return cudaSuccess;
}

inline int launch_lv_stages(const IpxLvSpec& s, const float* theta, int n, float* phi,
                            float* grad, cudaStream_t stream) {
  int geo[3];
  const int status = lv_stages_geometry(s, n, geo);
  if (status != cudaSuccess) return status;
  cudaFuncSetAttribute(lv_misfit_grad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       geo[2]);
  lv_misfit_grad_kernel<<<geo[1], 32 * geo[0], geo[2], stream>>>(s, theta, n, phi, grad);
  return static_cast<int>(cudaGetLastError());
}

