"""The Lotka–Volterra misfit and its gradient in one kernel
(``csrc/lv_rk4.cu`` ``lv_misfit_grad_kernel``), behind autograd.

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

KERNEL = "lv_misfit_grad_kernel"  # the launch count's name


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


def misfit_and_grad(theta: torch.Tensor, spec: LvSpec):
    """Φ (n,) and ∇Φ (n, 4) of the (n, 4) log-rates ``theta`` on the card:
    one launch of ``lv_misfit_grad_kernel``. CUDA tensors only (the CPU's
    is the plain version, ``models.ode.LotkaVolterraMisfit``)."""
    if theta.device.type != "cuda":
        raise ValueError(f"{KERNEL} runs on the card; got a tensor on {theta.device}")
    if theta.dtype != torch.float32 or theta.dim() != 2 or theta.shape[1] != 4:
        raise ValueError(f"theta: expected f32 (n, 4), got {theta.dtype} "
                         f"{tuple(theta.shape)}")
    if spec.data.device != theta.device:
        raise ValueError(f"the spec lies on {spec.data.device}, theta on {theta.device}")
    theta = theta.contiguous()
    n = theta.shape[0]
    states = torch.empty((spec.n_steps + 1) * 2 * max(n, 1), dtype=torch.float32,
                         device=theta.device)
    phi = torch.empty(n, dtype=torch.float32, device=theta.device)
    grad = torch.empty(n, 4, dtype=torch.float32, device=theta.device)
    lib = _build.library()
    if lib.ipx_lv_spec_size() != ctypes.sizeof(_build.LvSpec):
        raise RuntimeError("_build.LvSpec does not mirror IpxLvSpec")
    status = lib.ipx_lv_misfit_grad(
        ctypes.byref(spec.c_struct), theta.data_ptr(), n, states.data_ptr(), phi.data_ptr(),
        grad.data_ptr(), torch.cuda.current_stream(theta.device).cuda_stream)
    _build.check(status, KERNEL)
    _build.launch_counts[KERNEL] += 1
    return phi, grad


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


def adjoint_reference(theta: torch.Tensor, spec: LvSpec):
    """The kernel's algorithm in PyTorch over the chains (any float type):
    the forward with every state kept, Φ summed observation by observation,
    then the discrete adjoint of each RK4 step from n_steps down to 1, the
    injections at the observed steps, the cotangents of (c, s) carried to
    the log-rates. Returns (Φ, ∇Φ). For the tests, which hold it against
    autograd through the plain version."""
    f = theta.dtype
    rate = torch.exp(theta)
    c = torch.stack([rate[:, 0], -rate[:, 2]], -1)
    s = torch.stack([-rate[:, 1], rate[:, 3]], -1)
    h, hh, h6 = spec.dt, 0.5 * spec.dt, spec.dt / 6.0

    def stage(y):
        e = torch.exp(y)
        return c + s * e.flip(-1), e

    def step(y):
        k1, e1 = stage(y)
        k2, e2 = stage(y + hh * k1)
        k3, e3 = stage(y + hh * k2)
        k4, e4 = stage(y + h * k3)
        return y + h6 * (k1 + 2.0 * k2 + 2.0 * k3 + k4), (e1, e2, e3, e4)

    y = torch.tensor(spec.z0, dtype=f, device=theta.device).expand(theta.shape[0], 2)
    states = [y]
    for _ in range(spec.n_steps):
        y = step(y)[0]
        states.append(y)
    obs = spec.obs_step.tolist()
    species = spec.species.tolist()
    data, noise = spec.data.to(f), spec.noise.to(f)
    phi = torch.zeros(theta.shape[0], dtype=f, device=theta.device)
    inject = {}
    for t, i in enumerate(obs):
        for j, sp in enumerate(species):
            pred = torch.exp(states[i][:, sp])
            w = (data[t, j] - pred) / noise[t, j]
            phi = phi + w * w
            lam = inject.setdefault(i, torch.zeros_like(y))
            lam[:, sp] -= w * pred / noise[t, j]
    phi = 0.5 * phi

    def jt(e, kb):  # J(Y)^T kb
        return torch.stack([s[:, 1] * e[:, 0] * kb[:, 1], s[:, 0] * e[:, 1] * kb[:, 0]], -1)

    lam = torch.zeros_like(y)
    gc, gs = torch.zeros_like(y), torch.zeros_like(y)
    for i in range(spec.n_steps, 0, -1):
        lam = lam + inject.get(i, 0.0)
        es = step(states[i - 1])[1]
        kb = [h6 * lam, 2.0 * h6 * lam, 2.0 * h6 * lam, h6 * lam]
        ybar = lam
        for q, coef in ((3, h), (2, hh), (1, hh), (0, None)):
            gc = gc + kb[q]
            gs = gs + kb[q] * es[q].flip(-1)
            yb = jt(es[q], kb[q])
            ybar = ybar + yb
            if coef is not None:
                kb[q - 1] = kb[q - 1] + coef * yb
        lam = ybar
    grad = torch.stack([gc[:, 0] * rate[:, 0], -gs[:, 0] * rate[:, 1],
                        -gc[:, 1] * rate[:, 2], gs[:, 1] * rate[:, 3]], -1)
    return phi, grad
