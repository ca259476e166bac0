"""The Lotka–Volterra misfit and its gradient in one kernel
(``csrc/lv_rk4.cu``), behind autograd.

No Pallas kernel stands behind it: the JAX package takes this function's
value and gradient with ``jax.value_and_grad`` of
``potentials.misfit_potential`` around ``models/ode.py``
``make_lotka_volterra_forward`` (RK4 in ``lax.scan``). The port's plain
version is that function in PyTorch, differentiated by autograd through the
RK4 loop (``models.ode.LotkaVolterraMisfit``'s CPU path): about 13,000
launches a gradient on the card. The kernel computes Φ and ∇Φ of every chain
in one launch: the forward in the plain version's arithmetic, then the
discrete adjoint of each RK4 step (``adjoint_reference`` spells it out in
PyTorch, and the CPU tests hold it against autograd).

Two kernels compute it. ``lv_misfit_grad_kernel`` keeps each step's stage
exponentials in shared memory, two chains a CTA, and its backward recomputes
nothing; it takes the specs whose exponentials fit a CTA (``stages_takes``,
the mirror of ``lv_stages_takes``: with the configs' 40 observed values up
to 3,627 steps; the configs have 200).
``lv_misfit_grad_states_kernel`` takes every other spec: the states in a
global scratch that the wrapper allocates, each step's stages recomputed in
the backward; ``misfit_and_grad_states`` reaches it for any spec. Both give
the same bits.

``LvMisfitFunction`` wraps it for autograd: the forward launches the kernel
and keeps ∇Φ, the backward returns ``grad_out[:, None] * ∇Φ``; a second
derivative raises. ``base.value_and_grad``, ``map_localize``'s Adam and the
gradient samplers reach it through autograd with no change of their own.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from ip_mcmc_tpu_torch.ops import _build

KERNEL = "lv_misfit_grad_kernel"  # the launch counts' names
STATES_KERNEL = "lv_misfit_grad_states_kernel"
# Mirrors of LvStagesDesign::kChains, kLvStageValues and kLvMaxSmem
STAGES_CHAINS, STAGE_VALUES, MAX_SMEM = 2, 8, 232448


def stages_smem(spec) -> int:
    """Dynamic shared-memory bytes of a CTA of ``lv_misfit_grad_kernel``
    (``lv_stages_smem``): each chain's 8 f32 stage exponentials a step and
    its T · S injections."""
    return (spec.n_steps * STAGE_VALUES + spec.data.numel()) * 4 * STAGES_CHAINS


def stages_takes(spec) -> bool:
    """Whether ``ipx_lv_misfit_grad`` sends ``spec`` to
    ``lv_misfit_grad_kernel``, as ``lv_stages_takes`` decides: a CTA's
    chains keep their stages and injections in its shared memory (the
    configs' 200 steps and 40 observed values: 13,120 bytes)."""
    return stages_smem(spec) <= MAX_SMEM


def stages_geometry(n: int, spec):
    """(chains a CTA, CTAs, dynamic shared-memory bytes) of
    ``lv_misfit_grad_kernel`` on n chains (``lv_stages_geometry``); raises
    ``ValueError`` for a spec that ``stages_takes`` refuses."""
    if not stages_takes(spec):
        raise ValueError(f"{KERNEL} keeps the stages of a CTA's chains in {MAX_SMEM} bytes; "
                         f"{spec.n_steps} steps need {stages_smem(spec)}")
    return STAGES_CHAINS, -(-n // STAGES_CHAINS), stages_smem(spec)


@dataclasses.dataclass
class LvSpec:
    """What the kernel needs of a Lotka–Volterra misfit: log y0, the step
    and the step count, and the observations sorted by step (ties in the
    given order): ``obs_step`` (T,) int32, ``species`` (S,) int32, ``data``
    and ``noise`` (T, S) f32, rows in the order of ``obs_step``."""

    z0: tuple
    dt: float
    n_steps: int
    obs_step: torch.Tensor
    species: torch.Tensor
    data: torch.Tensor
    noise: torch.Tensor

    @classmethod
    def build(cls, y0, dt, n_steps, obs_indices, obs_species, data, noise_scale, device):
        """From the forward's arguments and the flattened time-major data
        and noise (len(obs_indices) · len(obs_species),). Raises
        ``ValueError`` for what the kernel does not take: no step, an
        observation outside [0, n_steps], a species other than 0 or 1."""
        obs = np.asarray(obs_indices, np.int64).reshape(-1)
        species = np.asarray(obs_species, np.int64).reshape(-1)
        n_steps = int(n_steps)
        if n_steps < 1 or not np.isfinite(dt) or dt <= 0.0:
            raise ValueError(f"the LV kernel integrates n_steps >= 1 of dt > 0; got "
                             f"{n_steps} of {dt}")
        if obs.size == 0 or obs.min() < 0 or obs.max() > n_steps:
            raise ValueError(f"observed steps must lie in [0, {n_steps}], got {obs.tolist()}")
        if species.size == 0 or not np.isin(species, (0, 1)).all():
            raise ValueError(f"observed species must be 0 or 1, got {species.tolist()}")
        shape = (obs.size, species.size)
        data = np.asarray(data, np.float32).reshape(shape)
        noise = np.asarray(noise_scale, np.float32).reshape(shape)
        order = np.argsort(obs, kind="stable")
        z0 = torch.log(torch.as_tensor(np.asarray(y0, np.float32))).tolist()  # the plain z0
        as_t = lambda a, dt_: torch.tensor(np.ascontiguousarray(a), dtype=dt_,  # noqa: E731
                                           device=device)
        return cls(z0=(float(z0[0]), float(z0[1])), dt=float(dt), n_steps=n_steps,
                   obs_step=as_t(obs[order], torch.int32),
                   species=as_t(species, torch.int32),
                   data=as_t(data[order], torch.float32),
                   noise=as_t(noise[order], torch.float32))

    @functools.cached_property
    def c_struct(self) -> _build.LvSpec:
        """The spec as the kernel takes it (built once; the tensors it
        points to live as long as the spec); 0.5 dt, dt and dt / 6 formed in
        float64 and rounded to f32, as the plain version's ``alpha``s."""
        return _build.LvSpec(self.obs_step.data_ptr(), self.species.data_ptr(),
                             self.data.data_ptr(), self.noise.data_ptr(),
                             (ctypes.c_float * 2)(*self.z0), 0.5 * self.dt, self.dt,
                             self.dt / 6.0, self.n_steps, int(self.obs_step.numel()),
                             int(self.species.numel()))


def _check(theta, spec):
    if theta.device.type != "cuda":
        raise ValueError(f"{KERNEL} runs on the card; got a tensor on {theta.device}")
    if theta.dtype != torch.float32 or theta.dim() != 2 or theta.shape[1] != 4:
        raise ValueError(f"theta: expected f32 (n, 4), got {theta.dtype} "
                         f"{tuple(theta.shape)}")
    if spec.data.device != theta.device:
        raise ValueError(f"the spec lies on {spec.data.device}, theta on {theta.device}")
    lib = _build.library()
    if lib.ipx_lv_spec_size() != ctypes.sizeof(_build.LvSpec):
        raise RuntimeError("_build.LvSpec does not mirror IpxLvSpec")
    return theta.contiguous(), lib


def _launch(entry, name, theta, spec, states):
    n = theta.shape[0]
    phi = torch.empty(n, dtype=torch.float32, device=theta.device)
    grad = torch.empty(n, 4, dtype=torch.float32, device=theta.device)
    status = entry(ctypes.byref(spec.c_struct), theta.data_ptr(), n,
                   None if states is None else states.data_ptr(), phi.data_ptr(),
                   grad.data_ptr(), torch.cuda.current_stream(theta.device).cuda_stream)
    _build.check(status, name)
    _build.launch_counts[name] += 1
    return phi, grad


def _states(theta, spec):
    return torch.empty((spec.n_steps + 1) * 2 * max(theta.shape[0], 1), dtype=torch.float32,
                       device=theta.device)


def misfit_and_grad(theta: torch.Tensor, spec: LvSpec):
    """Φ (n,) and ∇Φ (n, 4) of the (n, 4) log-rates ``theta`` on the card:
    one launch of ``lv_misfit_grad_kernel``, or of
    ``lv_misfit_grad_states_kernel`` with its scratch for a spec that
    ``stages_takes`` refuses. CUDA tensors only (the CPU's is the plain
    version, ``models.ode.LotkaVolterraMisfit``)."""
    theta, lib = _check(theta, spec)
    if stages_takes(spec):
        return _launch(lib.ipx_lv_misfit_grad, KERNEL, theta, spec, None)
    return _launch(lib.ipx_lv_misfit_grad, STATES_KERNEL, theta, spec, _states(theta, spec))


def misfit_and_grad_states(theta: torch.Tensor, spec: LvSpec):
    """The same by ``lv_misfit_grad_states_kernel`` whatever the rule says:
    the kernel ``lv_misfit_grad_kernel`` replaced on the configs' specs, the
    reference it is held to bit for bit."""
    theta, lib = _check(theta, spec)
    return _launch(lib.ipx_lv_misfit_grad_states, STATES_KERNEL, theta, spec,
                   _states(theta, spec))


FLOOR_KERNEL = "lv_forward_floor_kernel"


def forward_floor(theta: torch.Tensor, spec: LvSpec):
    """The latency floor of both kernels, on no path: one thread runs the
    forward's stage chain of ``theta`` (4,) and returns the last state (2,),
    the plain version's z_N. For timing beside the kernels."""
    theta, lib = _check(theta.reshape(1, 4), spec)
    out = torch.empty(2, dtype=torch.float32, device=theta.device)
    _build.check(lib.ipx_lv_forward_floor(ctypes.byref(spec.c_struct), theta.data_ptr(),
                                          out.data_ptr(),
                                          torch.cuda.current_stream(theta.device).cuda_stream),
                 FLOOR_KERNEL)
    _build.launch_counts[FLOOR_KERNEL] += 1
    return out


class LvMisfitFunction(torch.autograd.Function):
    """Φ(θ) of an (n, 4) batch by the kernel; its backward is the kernel's
    ∇Φ scaled by the incoming cotangent. Once differentiable."""

    @staticmethod
    def forward(ctx, theta, spec):
        phi, grad = misfit_and_grad(theta.detach(), spec)
        ctx.save_for_backward(grad)
        return phi

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        (grad,) = ctx.saved_tensors
        return grad_out[:, None] * grad, None


def _forward_stages(theta, spec):
    """The rates' (c, s), every state and each step's four stages' e^Y, the
    kernel's forward in PyTorch (any float type)."""
    rate = torch.exp(theta)
    c = torch.stack([rate[:, 0], -rate[:, 2]], -1)
    s = torch.stack([-rate[:, 1], rate[:, 3]], -1)
    h, hh, h6 = spec.dt, 0.5 * spec.dt, spec.dt / 6.0

    def stage(y):
        e = torch.exp(y)
        return c + s * e.flip(-1), e

    y = torch.tensor(spec.z0, dtype=theta.dtype, device=theta.device).expand(theta.shape[0], 2)
    states, stages = [y], [None]
    for _ in range(spec.n_steps):
        k1, e1 = stage(y)
        k2, e2 = stage(y + hh * k1)
        k3, e3 = stage(y + hh * k2)
        k4, e4 = stage(y + h * k3)
        y = y + h6 * (k1 + 2.0 * k2 + 2.0 * k3 + k4)
        states.append(y)
        stages.append((e1, e2, e3, e4))
    return rate, c, s, states, stages


def _misfit_and_injections(theta, spec, states):
    """Φ summed observation by observation in the spec's order, and each
    observed step's derivatives of Φ by its state, (species, value) in the
    kernel's order of injection (observations down, species up)."""
    f = theta.dtype
    data, noise = spec.data.to(f), spec.noise.to(f)
    species = spec.species.tolist()
    phi = torch.zeros(theta.shape[0], dtype=f, device=theta.device)
    rows = {}
    for t, i in enumerate(spec.obs_step.tolist()):
        row = rows.setdefault(i, [])
        row.append([])
        for j, sp in enumerate(species):
            pred = torch.exp(states[i][:, sp])
            w = (data[t, j] - pred) / noise[t, j]
            phi = phi + w * w
            row[-1].append((sp, -w * pred / noise[t, j]))
    inject = {i: [x for row in reversed(r) for x in row] for i, r in rows.items()}
    return 0.5 * phi, inject


def _step_adjoint(spec, s, es, lam, gc, gs):
    """The adjoint of one RK4 step from its stages' e^Y: λ_i → λ_{i-1} (less
    the injections at i − 1), the cotangents of (c, s) added to gc, gs."""
    h, hh, h6 = spec.dt, 0.5 * spec.dt, spec.dt / 6.0
    kb = [h6 * lam, 2.0 * h6 * lam, 2.0 * h6 * lam, h6 * lam]
    ybar = lam
    for q, coef in ((3, h), (2, hh), (1, hh), (0, None)):
        gc = gc + kb[q]
        gs = gs + kb[q] * es[q].flip(-1)
        e = es[q]
        yb = torch.stack([s[:, 1] * e[:, 0] * kb[q][:, 1], s[:, 0] * e[:, 1] * kb[q][:, 0]], -1)
        ybar = ybar + yb
        if coef is not None:
            kb[q - 1] = kb[q - 1] + coef * yb
    return ybar, gc, gs


def _inject(lam, inject, i):
    for sp, dz in inject.get(i, ()):
        lam = lam.clone()
        lam[:, sp] += dz
    return lam


def _gradient(rate, gc, gs):
    """Through (c, s) = ((α, −γ), (−β, δ)) and rate = e^θ."""
    return torch.stack([gc[:, 0] * rate[:, 0], -gs[:, 0] * rate[:, 1],
                        -gc[:, 1] * rate[:, 2], gs[:, 1] * rate[:, 3]], -1)


def adjoint_reference(theta: torch.Tensor, spec: LvSpec):
    """The kernel's algorithm in PyTorch over the chains (any float type):
    the forward with every state kept, Φ summed observation by observation,
    then the discrete adjoint of each RK4 step from n_steps down to 1, the
    injections at the observed steps, the cotangents of (c, s) carried to
    the log-rates. Returns (Φ, ∇Φ). For the tests, which hold it against
    autograd through the plain version."""
    rate, _, s, states, stages = _forward_stages(theta, spec)
    phi, inject = _misfit_and_injections(theta, spec, states)
    lam = torch.zeros_like(states[0])
    gc, gs = torch.zeros_like(lam), torch.zeros_like(lam)
    for i in range(spec.n_steps, 0, -1):
        lam = _inject(lam, inject, i)
        lam, gc, gs = _step_adjoint(spec, s, stages[i], lam, gc, gs)
    return phi, _gradient(rate, gc, gs)


def adjoint_scan_reference(theta: torch.Tensor, spec: LvSpec, lanes: int = 32):
    """The same gradient in the association of the warp-parallel adjoint
    (``scripts/lv_warp_adjoint.cuh``): lane l of ``lanes`` owns steps a..b,
    ⌈n_steps / lanes⌉ of them, and composes its affine map
    T_l: λ⁺_b → λ⁺_{a−1} (A λ + v, the injections at a − 1 .. b − 1 but
    step 0 inside); a Hillis–Steele scan composes S_l = T_l ∘ S_{l+off} for
    off = 1, 2, 4, …; lane l sweeps its steps again from S_{l+1}(λ⁺_N),
    adding the cotangents of (c, s), which a butterfly sums over the lanes.
    Returns (Φ, ∇Φ)."""
    rate, _, s, states, stages = _forward_stages(theta, spec)
    phi, inject = _misfit_and_injections(theta, spec, states)
    N = spec.n_steps
    per = -(-N // lanes)
    zero = torch.zeros_like(states[0])
    one = torch.ones_like(zero[:, 0])
    identity = (torch.stack([one, 0 * one], -1), torch.stack([0 * one, one], -1), zero)

    def step_only(es, lam):
        return _step_adjoint(spec, s, es, lam, zero, zero)[0]

    blocks, maps = [], []
    for lane in range(lanes):
        a, b = lane * per + 1, min(lane * per + per, N)
        blocks.append((a, b))
        c0, c1, v = identity
        for i in range(b, a - 1, -1):
            c0, c1, v = (step_only(stages[i], c0), step_only(stages[i], c1),
                         step_only(stages[i], v))
            if i - 1 >= 1:
                v = _inject(v, inject, i - 1)
        maps.append((c0, c1, v))

    def after(f, g):  # f ∘ g: the columns f A g's and f(g's offset)
        def mat(x):
            return torch.stack([f[0][:, 0] * x[:, 0] + f[1][:, 0] * x[:, 1],
                                f[0][:, 1] * x[:, 0] + f[1][:, 1] * x[:, 1]], -1)
        return mat(g[0]), mat(g[1]), mat(g[2]) + f[2]

    off = 1
    while off < lanes:
        maps = [after(maps[l], maps[l + off]) if l + off < lanes else maps[l]
                for l in range(lanes)]
        off *= 2
    top = _inject(zero, inject, N)
    g = []
    for lane, (a, b) in enumerate(blocks):
        lam = top if lane == lanes - 1 else after(maps[lane + 1], (zero, zero, top))[2]
        gc, gs = zero, zero
        for i in range(b, a - 1, -1):
            lam, gc, gs = _step_adjoint(spec, s, stages[i], lam, gc, gs)
            if i - 1 >= a:
                lam = _inject(lam, inject, i - 1)
        g.append(torch.cat([gc, gs], -1))
    off = lanes // 2
    while off:
        g = [g[l] + g[l ^ off] for l in range(lanes)]
        off //= 2
    return phi, _gradient(rate, g[0][:, :2], g[0][:, 2:])
