// The Lotka-Volterra misfit and its gradient, hand-written Hopper kernels.
//
// Replaces no Pallas kernel: the JAX package computes this function with
// jax.value_and_grad of potentials.misfit_potential around
// ip_mcmc_tpu/models/ode.py make_lotka_volterra_forward (l.56: rk4_integrate
// l.18 over lotka_volterra_log_field l.44 in lax.scan), one XLA program. The
// port's plain version (autograd through the RK4 loop of
// ip_mcmc_tpu_torch/models/ode.py) launches about 13,000 small kernels for
// one gradient, 95 % of them waiting on the host (PERF.md), and the gradient
// samplers of the ODE configs (MALA, HMC, NUTS, ChEES) take one to 255 of
// them a step. Added so that those configs run at the card's pace.
//
//   lv_misfit_grad_kernel  (theta (n, 4), the spec) -> (Phi (n,), dPhi/dtheta
//                          (n, 4)): one thread a chain, LvStagesDesign's
//                          chains a CTA. The forward follows the plain
//                          version's arithmetic (rates formed once, a stage
//                          c + s * swap(e^z) as one multiply-add, the stage
//                          inputs and the update as fused adds in its order)
//                          and keeps each step's four stages' e^Y in shared
//                          memory; the misfit sums the observed values'
//                          whitened residuals in the spec's order, e^z of an
//                          observed state being stage 1's e^Y of the next
//                          step. The backward is the discrete adjoint of the
//                          RK4 step, injected at the observed steps, from the
//                          kept e^Y: each stage's Jacobian [[0, s0 e^z1],
//                          [s1 e^z0, 0]] transposed, chained through (c, s)
//                          to the log-rates. Nothing is recomputed.
//   lv_misfit_grad_states_kernel  the same function, one thread a chain, the
//                          states in the caller's global scratch and each
//                          step's stages recomputed in the backward: the
//                          kernel of the specs whose e^Y do not fit a CTA's
//                          shared memory (lv_stages_takes), reachable for any
//                          spec through ipx_lv_misfit_grad_states. Its
//                          arithmetic is the stages kernel's, so both give
//                          the same bits.
//
// What bounds it on the H100: per chain a few hundred operations a step
// (8 exp a step forward, the adjoint a dozen dependent multiply-adds). The
// bytes it must move (theta in, Phi and the gradient out, the spec) are a few
// kilobytes, the operations a few tens of MFLOP at 1024 chains: far under a
// microsecond either way. What sets its time is the latency of one thread's
// dependent chain: n_steps RK4 steps of four stages (a multiply-add, two exp,
// a multiply-add) forward, then n_steps adjoint steps. So every chain gets a
// thread of its own and nothing waits on another (no barrier); the forward
// stores its e^Y beside the chain (layout [step][value][chain], consecutive
// chains in consecutive banks), off its dependency chain; the backward's
// shared-memory reads do not depend on the adjoint, so they issue ahead of
// it, and between two observed steps it runs a counted loop with no branch.
// Two chains a CTA spread 256 to 1024 chains over every SM.

#include <cuda_runtime.h>

// Mirrored by ip_mcmc_tpu_torch/ops/lv_rk4.py LvSpec: the observations sorted
// by step (ties in the caller's order); data and noise (T, S) time-major.
struct IpxLvSpec {
  const int* obs_step;  // (T,) ascending, each in [0, n_steps]
  const int* species;   // (S,) 0 or 1
  const float* data;    // (T, S) observed populations
  const float* noise;   // (T, S) their standard deviations
  float z0[2];          // log of the initial populations
  float half_dt, dt, dt6;  // 0.5 dt, dt and dt / 6 as f32, as the plain version rounds them
  int n_steps, T, S;
};

namespace ipx {

struct LvDesign { static constexpr int kThreads = 64; };  // the states kernel
// The stages kernel: chains (threads) a CTA. Mirrored by ops/lv_rk4.py STAGES_CHAINS.
struct LvStagesDesign { static constexpr int kChains = 2; };
constexpr int kLvStageValues = 8;        // e^Y of a step: 4 stages x 2 species
constexpr size_t kLvMaxSmem = 232448;    // a CTA's shared memory on the H100

// One RK4 stage's derivative: c + s * swap(e^y), as one multiply-add a
// component (the plain version's addcmul); e = e^y is kept for the adjoint.
struct LvStage {
  float e0, e1;
  __device__ __forceinline__ void eval(const float (&y)[2], const float (&c)[2],
                                       const float (&s)[2], float (&k)[2]) {
    e0 = expf(y[0]);
    e1 = expf(y[1]);
    k[0] = fmaf(s[0], e1, c[0]);
    k[1] = fmaf(s[1], e0, c[1]);
  }
};

// One RK4 step from y, its four stages' e^Y in st (the plain version's
// _rk4_step: each stage input y + a k as one fused add, the increment
// k1 + 2 k2 + 2 k3 + k4 added in that order, the update y + dt/6 incr).
__device__ __forceinline__ void lv_rk4_step(const IpxLvSpec& s, const float (&c)[2],
                                            const float (&sc)[2], const float (&y)[2],
                                            LvStage (&st)[4], float (&out)[2]) {
  float k1[2], k2[2], k3[2], k4[2], Y[2];
  st[0].eval(y, c, sc, k1);
  Y[0] = fmaf(s.half_dt, k1[0], y[0]);
  Y[1] = fmaf(s.half_dt, k1[1], y[1]);
  st[1].eval(Y, c, sc, k2);
  Y[0] = fmaf(s.half_dt, k2[0], y[0]);
  Y[1] = fmaf(s.half_dt, k2[1], y[1]);
  st[2].eval(Y, c, sc, k3);
  Y[0] = fmaf(s.dt, k3[0], y[0]);
  Y[1] = fmaf(s.dt, k3[1], y[1]);
  st[3].eval(Y, c, sc, k4);
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    float incr = fmaf(2.0f, k2[q], k1[q]);
    incr = fmaf(2.0f, k3[q], incr);
    incr = incr + k4[q];
    out[q] = fmaf(s.dt6, incr, y[q]);
  }
}

// The adjoint of one stage: the cotangent kb of its derivative k = c + s *
// swap(e^Y) adds kb to gc and kb * swap(e^Y) to gs, and returns J(Y)^T kb
// in yb: (s1 e^Y0 kb1, s0 e^Y1 kb0).
__device__ __forceinline__ void lv_stage_adjoint(const LvStage& st, const float (&sc)[2],
                                                 const float (&kb)[2], float (&gc)[2],
                                                 float (&gs)[2], float (&yb)[2]) {
  gc[0] += kb[0];
  gc[1] += kb[1];
  gs[0] = fmaf(kb[0], st.e1, gs[0]);
  gs[1] = fmaf(kb[1], st.e0, gs[1]);
  yb[0] = sc[1] * st.e0 * kb[1];
  yb[1] = sc[0] * st.e1 * kb[0];
}

// The adjoint of one RK4 step from its stages' e^Y: lam = dPhi/dz_i in,
// dPhi/dz_{i-1} (less the injections at step i - 1) out; the cotangents of
// (c, s) added to gc, gs. out = yp + dt/6 (k1 + 2 k2 + 2 k3 + k4), the stage
// inputs yp + a k.
__device__ __forceinline__ void lv_step_adjoint(const IpxLvSpec& s, const LvStage (&st)[4],
                                                const float (&sc)[2], float (&lam)[2],
                                                float (&gc)[2], float (&gs)[2]) {
  float kb4[2], kb3[2], kb2[2], kb1[2], yb[2];
  float ybar[2] = {lam[0], lam[1]};
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    kb4[q] = s.dt6 * lam[q];
    kb3[q] = 2.0f * kb4[q];
    kb2[q] = kb3[q];
    kb1[q] = kb4[q];
  }
  lv_stage_adjoint(st[3], sc, kb4, gc, gs, yb);  // Y4 = yp + dt k3
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    ybar[q] += yb[q];
    kb3[q] = fmaf(s.dt, yb[q], kb3[q]);
  }
  lv_stage_adjoint(st[2], sc, kb3, gc, gs, yb);  // Y3 = yp + dt/2 k2
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    ybar[q] += yb[q];
    kb2[q] = fmaf(s.half_dt, yb[q], kb2[q]);
  }
  lv_stage_adjoint(st[1], sc, kb2, gc, gs, yb);  // Y2 = yp + dt/2 k1
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    ybar[q] += yb[q];
    kb1[q] = fmaf(s.half_dt, yb[q], kb1[q]);
  }
  lv_stage_adjoint(st[0], sc, kb1, gc, gs, yb);  // Y1 = yp
  lam[0] = ybar[0] + yb[0];
  lam[1] = ybar[1] + yb[1];
}

// Adds to lam the misfit's derivative at the observations of step `step`,
// d(1/2 w^2)/dz = -w e^z / sigma for w = (y - e^z) / sigma, e^z of species
// sp being pred(sp): those from the cursor t down while obs_step[t] == step
// (the steps ascend); returns the cursor past them.
template <class Pred>
__device__ __forceinline__ int lv_inject(const IpxLvSpec& s, int t, int step, Pred pred,
                                         float (&lam)[2]) {
  for (; t >= 0 && s.obs_step[t] == step; --t) {
    for (int j = 0; j < s.S; ++j) {
      const int sp = s.species[j];
      const float e = pred(sp);
      const float sigma = s.noise[t * s.S + j];
      const float w = (s.data[t * s.S + j] - e) / sigma;
      const float dz = -w * e / sigma;
      if (sp == 0) lam[0] += dz;
      else lam[1] += dz;
    }
  }
  return t;
}

// The misfit, observation by observation in the spec's order; ez(step, sp)
// is e^z of species sp at the step.
template <class Ez>
__device__ __forceinline__ float lv_misfit(const IpxLvSpec& s, Ez ez) {
  float acc = 0.0f;
  for (int t = 0; t < s.T; ++t) {
    for (int j = 0; j < s.S; ++j) {
      const float w = (s.data[t * s.S + j] - ez(s.obs_step[t], s.species[j] == 0 ? 0 : 1)) /
                      s.noise[t * s.S + j];
      acc += w * w;
    }
  }
  return 0.5f * acc;
}

// A step's four stages' e^Y as two float4 at p (16-byte aligned): e0, e1 of
// stages 1 and 2, then of stages 3 and 4.
__device__ __forceinline__ void lv_store_stages(float* p, const LvStage (&st)[4]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(st[0].e0, st[0].e1, st[1].e0, st[1].e1);
  reinterpret_cast<float4*>(p)[1] = make_float4(st[2].e0, st[2].e1, st[3].e0, st[3].e1);
}
__device__ __forceinline__ void lv_load_stages(const float* p, LvStage (&st)[4]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  st[0].e0 = a.x;
  st[0].e1 = a.y;
  st[1].e0 = a.z;
  st[1].e1 = a.w;
  st[2].e0 = b.x;
  st[2].e1 = b.y;
  st[3].e0 = b.z;
  st[3].e1 = b.w;
}

// lv_misfit, keeping each observed value's injection for the adjoint:
// dz[t S + j] = -w e^z / sigma, lv_inject's value.
template <class Ez>
__device__ __forceinline__ float lv_misfit_dz(const IpxLvSpec& s, Ez ez, float* dz) {
  float acc = 0.0f;
  for (int t = 0; t < s.T; ++t) {
    for (int j = 0; j < s.S; ++j) {
      const float e = ez(s.obs_step[t], s.species[j] == 0 ? 0 : 1);
      const float sigma = s.noise[t * s.S + j];
      const float w = (s.data[t * s.S + j] - e) / sigma;
      acc += w * w;
      dz[t * s.S + j] = -w * e / sigma;
    }
  }
  return 0.5f * acc;
}

// lv_inject with the kept injections: the same adds in the same order.
__device__ __forceinline__ int lv_inject_dz(const IpxLvSpec& s, int t, int step, const float* dz,
                                            float (&lam)[2]) {
  for (; t >= 0 && s.obs_step[t] == step; --t) {
    for (int j = 0; j < s.S; ++j) {
      const float d = dz[t * s.S + j];
      if (s.species[j] == 0) lam[0] += d;
      else lam[1] += d;
    }
  }
  return t;
}

__global__ void __launch_bounds__(LvDesign::kThreads)
    lv_misfit_grad_states_kernel(const __grid_constant__ IpxLvSpec s,
                                 const float* __restrict__ theta, int n,
                                 float* __restrict__ states, float* __restrict__ phi,
                                 float* __restrict__ grad) {
  const int ch = blockIdx.x * blockDim.x + threadIdx.x;
  if (ch >= n) return;
  // the rates alpha, beta, gamma, delta; (c, s) = ((alpha, -gamma), (-beta, delta))
  const float ra = expf(theta[4 * ch + 0]), rb = expf(theta[4 * ch + 1]);
  const float rg = expf(theta[4 * ch + 2]), rd = expf(theta[4 * ch + 3]);
  const float c[2] = {ra, -rg}, sc[2] = {-rb, rd};
  const size_t stride = static_cast<size_t>(n);
  float y[2] = {s.z0[0], s.z0[1]};
  states[ch] = y[0];
  states[stride + ch] = y[1];
  for (int i = 1; i <= s.n_steps; ++i) {
    LvStage st[4];
    float out[2];
    lv_rk4_step(s, c, sc, y, st, out);
    y[0] = out[0];
    y[1] = out[1];
    states[(2 * static_cast<size_t>(i)) * stride + ch] = y[0];
    states[(2 * static_cast<size_t>(i) + 1) * stride + ch] = y[1];
  }
  phi[ch] = lv_misfit(s, [&](int step, int sp) {
    return expf(states[(2 * static_cast<size_t>(step) + sp) * stride + ch]);
  });

  // the discrete adjoint: lam = dPhi/dz_i from i = n_steps down to 1
  float lam[2] = {0.0f, 0.0f}, gc[2] = {0.0f, 0.0f}, gs[2] = {0.0f, 0.0f};
  int t = s.T - 1;
  float zi[2] = {y[0], y[1]};  // the state of step i
  for (int i = s.n_steps; i >= 1; --i) {
    t = lv_inject(s, t, i, [&](int sp) { return expf(sp == 0 ? zi[0] : zi[1]); }, lam);
    const float yp[2] = {states[(2 * static_cast<size_t>(i - 1)) * stride + ch],
                         states[(2 * static_cast<size_t>(i - 1) + 1) * stride + ch]};
    LvStage st[4];
    float out[2];
    lv_rk4_step(s, c, sc, yp, st, out);  // the stages of step i again
    lv_step_adjoint(s, st, sc, lam, gc, gs);
    zi[0] = yp[0];
    zi[1] = yp[1];
  }
  // through (c, s) = ((alpha, -gamma), (-beta, delta)) and rate = e^theta
  grad[4 * ch + 0] = gc[0] * ra;
  grad[4 * ch + 1] = -gs[0] * rb;
  grad[4 * ch + 2] = -gc[1] * rg;
  grad[4 * ch + 3] = gs[1] * rd;
}

// --- the stages kernel (LvStagesDesign) ---------------------------------------

// Mirrored by ip_mcmc_tpu_torch/ops/lv_rk4.py stages_takes: each of a CTA's
// chains keeps n_steps x 8 e^Y and T x S injections in shared memory.
inline size_t lv_stages_smem(const IpxLvSpec& s) {
  return (static_cast<size_t>(s.n_steps) * kLvStageValues + static_cast<size_t>(s.T) * s.S) *
         sizeof(float) * LvStagesDesign::kChains;
}
inline bool lv_stages_takes(const IpxLvSpec& s) { return lv_stages_smem(s) <= kLvMaxSmem; }

__global__ void __launch_bounds__(LvStagesDesign::kChains)
    lv_misfit_grad_kernel(const __grid_constant__ IpxLvSpec s, const float* __restrict__ theta,
                          int n, float* __restrict__ phi, float* __restrict__ grad) {
  constexpr int C = LvStagesDesign::kChains;
  extern __shared__ __align__(16) float lv_e[];
  const int ch = blockIdx.x * C + threadIdx.x;
  if (ch >= n) return;  // no barrier below
  const int N = s.n_steps;
  // e^Y of step i (1..N) at E(i)[v], v = 2 stage + species: [step][chain][v],
  // a chain's 32 bytes a step beside its neighbour's; then the chains'
  // injections, T x S each
  const auto E = [&](int i) {
    return lv_e + (static_cast<size_t>(i - 1) * C + threadIdx.x) * kLvStageValues;
  };
  float* const dz = lv_e + static_cast<size_t>(N) * C * kLvStageValues + threadIdx.x * s.T * s.S;
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
  // e^z of the state of step i: stage 1's e^Y of step i + 1, the last one here
  const float ezN[2] = {expf(y[0]), expf(y[1])};
  const auto ez = [&](int i, int sp) {
    return i == N ? (sp == 0 ? ezN[0] : ezN[1]) : E(i + 1)[sp];
  };
  phi[ch] = lv_misfit_dz(s, ez, dz);

  // the discrete adjoint from i = n_steps down to 1: at an observed step the
  // injections, then the steps down to the next observed one, each step's
  // e^Y read while the step before it runs
  float lam[2] = {0.0f, 0.0f}, gc[2] = {0.0f, 0.0f}, gs[2] = {0.0f, 0.0f};
  int t = s.T - 1;
  for (int i = N;;) {
    t = lv_inject_dz(s, t, i, dz, lam);
    const int lo = t >= 0 ? s.obs_step[t] : 0;
    LvStage cur[4];
    lv_load_stages(E(i), cur);
    for (; i > lo; --i) {
      LvStage next[4];
      lv_load_stages(E(i > 1 ? i - 1 : 1), next);
      lv_step_adjoint(s, cur, sc, lam, gc, gs);
#pragma unroll
      for (int q = 0; q < 4; ++q) cur[q] = next[q];
    }
    if (i == 0) break;
  }
  grad[4 * ch + 0] = gc[0] * ra;
  grad[4 * ch + 1] = -gs[0] * rb;
  grad[4 * ch + 2] = -gc[1] * rg;
  grad[4 * ch + 3] = gs[1] * rd;
}

// (chains a CTA, CTAs, dynamic shared bytes) of a launch on n chains;
// cudaErrorNotSupported for a spec lv_stages_takes refuses.
inline int lv_stages_geometry(const IpxLvSpec& s, int n, int* out) {
  if (!lv_stages_takes(s)) return cudaErrorNotSupported;
  out[0] = LvStagesDesign::kChains;
  out[1] = (n + LvStagesDesign::kChains - 1) / LvStagesDesign::kChains;
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
  lv_misfit_grad_kernel<<<geo[1], geo[0], geo[2], stream>>>(s, theta, n, phi, grad);
  return static_cast<int>(cudaGetLastError());
}

// --- end of the stages kernel -------------------------------------------------

// The latency floor of both kernels, on no path: one thread runs the
// forward's stage chain of theta[0] (n_steps x 4 stages) and stores only the
// last state. chip_smoke.py and scripts/measure_lv_design.py time it beside
// the kernels.
__global__ void __launch_bounds__(1)
    lv_forward_floor_kernel(const __grid_constant__ IpxLvSpec s, const float* __restrict__ theta,
                            float* __restrict__ out) {
  const float ra = expf(theta[0]), rb = expf(theta[1]), rg = expf(theta[2]), rd = expf(theta[3]);
  const float c[2] = {ra, -rg}, sc[2] = {-rb, rd};
  float y[2] = {s.z0[0], s.z0[1]};
  for (int i = 1; i <= s.n_steps; ++i) {
    LvStage st[4];
    float o[2];
    lv_rk4_step(s, c, sc, y, st, o);
    y[0] = o[0];
    y[1] = o[1];
  }
  out[0] = y[0];
  out[1] = y[1];
}

inline bool lv_spec_ok(const IpxLvSpec& s, int n) {
  return n >= 0 && s.n_steps >= 1 && s.T >= 0 && s.S >= 1;
}

}  // namespace ipx

extern "C" {

// The states kernel on n chains whatever the rule says: theta (n, 4), states
// ((n_steps + 1) * 2 * n, the caller's scratch), Phi (n,), the gradient
// (n, 4); the status of the launch (cudaErrorInvalidValue for a spec the
// kernel does not take).
int ipx_lv_misfit_grad_states(const IpxLvSpec* s, const float* theta, int n, float* states,
                              float* phi, float* grad, void* stream) {
  if (!ipx::lv_spec_ok(*s, n) || (n > 0 && states == nullptr)) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const int threads = ipx::LvDesign::kThreads;
  ipx::lv_misfit_grad_states_kernel<<<(n + threads - 1) / threads, threads, 0,
                                      static_cast<cudaStream_t>(stream)>>>(*s, theta, n, states,
                                                                           phi, grad);
  return static_cast<int>(cudaGetLastError());
}

// A spec whose e^Y fit (lv_stages_takes) goes to lv_misfit_grad_kernel, and
// states may be null; every other to the states kernel, which needs them.
int ipx_lv_misfit_grad(const IpxLvSpec* s, const float* theta, int n, float* states, float* phi,
                       float* grad, void* stream) {
  if (!ipx::lv_stages_takes(*s))
    return ipx_lv_misfit_grad_states(s, theta, n, states, phi, grad, stream);
  if (!ipx::lv_spec_ok(*s, n)) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  return ipx::launch_lv_stages(*s, theta, n, phi, grad, static_cast<cudaStream_t>(stream));
}

// (chains a CTA, CTAs, dynamic shared bytes) of lv_misfit_grad_kernel on n
// chains in out (3,); cudaErrorNotSupported for a spec it does not take.
int ipx_lv_stages_geometry(const IpxLvSpec* s, int n, int* out) {
  return ipx::lv_stages_geometry(*s, n, out);
}

// lv_forward_floor_kernel on theta (4,): the last state in out (2,)
int ipx_lv_forward_floor(const IpxLvSpec* s, const float* theta, float* out, void* stream) {
  if (!ipx::lv_spec_ok(*s, 1)) return cudaErrorInvalidValue;
  ipx::lv_forward_floor_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(*s, theta, out);
  return static_cast<int>(cudaGetLastError());
}

// sizeof(IpxLvSpec), for the wrapper's check of its mirror
int ipx_lv_spec_size() { return static_cast<int>(sizeof(IpxLvSpec)); }

}  // extern "C"
