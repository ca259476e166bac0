// The Lotka-Volterra misfit and its gradient, one hand-written Hopper kernel.
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
//                          (n, 4)): one thread a chain. The forward follows
//                          the plain version's arithmetic (rates formed once,
//                          a stage c + s * swap(e^z) as one multiply-add, the
//                          stage inputs and the update as fused adds in its
//                          order) and writes each step's state to the
//                          caller's scratch; the misfit sums the observed
//                          values' whitened residuals in the spec's order.
//                          The backward is the discrete adjoint of the RK4
//                          step, injected at the observed steps: each step's
//                          four stages recomputed from its stored state, each
//                          stage's Jacobian [[0, s0 e^z1], [s1 e^z0, 0]]
//                          transposed, chained through (c, s) to the
//                          log-rates.
//
// What bounds it on the H100: per chain 2 n_steps + 1 stored states and a few
// hundred operations a step (8 exp a step forward, 8 again backward). The
// bytes it must move (theta in, Phi and the gradient out, the spec) are a few
// kilobytes, the operations a few tens of MFLOP at 1024 chains: far under a
// microsecond either way. What sets its time is the latency of one thread's
// dependent chain over 2 n_steps steps, so every chain gets a thread of its
// own and nothing waits on another: no barrier, no shared memory, the scratch
// states (one 8-byte state a step, consecutive chains on consecutive
// addresses) held in L2. LvDesign's CTAs spread the chains over the SMs.

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

struct LvDesign { static constexpr int kThreads = 64; };

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

// Adds to lam the misfit's derivative at the observations of step `step`,
// d(1/2 w^2)/dz = -w e^z / sigma for w = (y - e^z) / sigma: those from the
// cursor t down while obs_step[t] == step (the steps ascend); returns the
// cursor past them.
__device__ __forceinline__ int lv_inject(const IpxLvSpec& s, int t, int step, const float (&z)[2],
                                         float (&lam)[2]) {
  for (; t >= 0 && s.obs_step[t] == step; --t) {
    for (int j = 0; j < s.S; ++j) {
      const int sp = s.species[j];
      const float pred = expf(sp == 0 ? z[0] : z[1]);
      const float sigma = s.noise[t * s.S + j];
      const float w = (s.data[t * s.S + j] - pred) / sigma;
      const float dz = -w * pred / sigma;
      if (sp == 0) lam[0] += dz;
      else lam[1] += dz;
    }
  }
  return t;
}

__global__ void __launch_bounds__(LvDesign::kThreads)
    lv_misfit_grad_kernel(const __grid_constant__ IpxLvSpec s, const float* __restrict__ theta,
                          int n, float* __restrict__ states, float* __restrict__ phi,
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
  // the misfit, observation by observation in the spec's order
  float acc = 0.0f;
  for (int t = 0; t < s.T; ++t) {
    const size_t at = 2 * static_cast<size_t>(s.obs_step[t]) * stride + ch;
    for (int j = 0; j < s.S; ++j) {
      const float z = states[at + (s.species[j] == 0 ? 0 : stride)];
      const float w = (s.data[t * s.S + j] - expf(z)) / s.noise[t * s.S + j];
      acc += w * w;
    }
  }
  phi[ch] = 0.5f * acc;

  // the discrete adjoint: lam = dPhi/dz_i from i = n_steps down to 1
  float lam[2] = {0.0f, 0.0f}, gc[2] = {0.0f, 0.0f}, gs[2] = {0.0f, 0.0f};
  int t = s.T - 1;
  float zi[2] = {y[0], y[1]};  // the state of step i
  for (int i = s.n_steps; i >= 1; --i) {
    t = lv_inject(s, t, i, zi, lam);
    const float yp[2] = {states[(2 * static_cast<size_t>(i - 1)) * stride + ch],
                         states[(2 * static_cast<size_t>(i - 1) + 1) * stride + ch]};
    LvStage st[4];
    float out[2];
    lv_rk4_step(s, c, sc, yp, st, out);  // the stages of step i again
    // out = yp + dt/6 (k1 + 2 k2 + 2 k3 + k4), the stage inputs yp + a k
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
    zi[0] = yp[0];
    zi[1] = yp[1];
  }
  // through (c, s) = ((alpha, -gamma), (-beta, delta)) and rate = e^theta
  grad[4 * ch + 0] = gc[0] * ra;
  grad[4 * ch + 1] = -gs[0] * rb;
  grad[4 * ch + 2] = -gc[1] * rg;
  grad[4 * ch + 3] = gs[1] * rd;
}

}  // namespace ipx

extern "C" {

// The kernel on n chains: theta (n, 4), states ((n_steps + 1) * 2 * n, the
// caller's scratch), Phi (n,), the gradient (n, 4); the status of the launch
// (cudaErrorInvalidValue for a spec the kernel does not take).
int ipx_lv_misfit_grad(const IpxLvSpec* s, const float* theta, int n, float* states, float* phi,
                       float* grad, void* stream) {
  if (n < 0 || s->n_steps < 1 || s->T < 0 || s->S < 1) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const int threads = ipx::LvDesign::kThreads;
  ipx::lv_misfit_grad_kernel<<<(n + threads - 1) / threads, threads, 0,
                               static_cast<cudaStream_t>(stream)>>>(*s, theta, n, states, phi,
                                                                    grad);
  return static_cast<int>(cudaGetLastError());
}

// sizeof(IpxLvSpec), for the wrapper's check of its mirror
int ipx_lv_spec_size() { return static_cast<int>(sizeof(IpxLvSpec)); }

}  // extern "C"
