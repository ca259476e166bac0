"""Burgers' equation misfit: u_t + (u²/2)_x = 0 on the periodic unit
interval, finite-volume Godunov (mirrors ``ip_mcmc_tpu/models/burgers.py``).

``burgers_aux`` builds the constants of ``make_burgers_forward`` (scaled
Fourier KL basis, mean profile, observation cells, the CFL-safe time step
and the step count of each inter-observation segment) in numpy.
``make_burgers_forward`` and ``integrate`` are the single-particle forward
of the scan path (chains on the leading dimensions, plain PyTorch: some ten
small operations a Godunov step). ``BurgersMisfit`` is
``make_batched_misfit`` (K12): Φ for a features-first
(K, B) batch of whitened KL coefficients — initial state ``mean + Bᵀu``,
per segment that many Godunov steps, the state at the observed cells after
each segment, ½‖(y − pred)/σ‖². Shocks make the map non-differentiable:
there is no gradient.

For CUDA tensors the module launches ``burgers_misfit_warp_kernel``, a
draw a warp on the Burgers samplers' solve, on a level that it takes
(``_burgers_warp.misfit_takes``: 64 or 128 cells, K = 16; the shipped
configs'), and ``burgers_misfit_kernel``, a draw a CTA, on any other
(``csrc/fused_da3_pcn.cu``, device code in ``csrc/burgers_misfit.cuh``);
for CPU tensors it runs the plain version. That observes with a gather; the
JAX one-hot observation matmul exists only because Mosaic lowers no gather.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
from torch import nn

from ip_mcmc_tpu_torch._device import resolve_device
from ip_mcmc_tpu_torch.models import kl
from ip_mcmc_tpu_torch.ops import _build, _burgers_warp


def burgers_aux(n_cells: int = 128, n_modes: int = 16, alpha: float = 1.5,
                field_scale: float = 2.0, t_final: float = 0.3,
                cfl_amax: float = 3.0, obs_indices=None, mean_profile=None,
                obs_times=None):
    """The constants of ``make_burgers_forward``'s aux dict, as numpy:
    scaled_basis (K, cells) f32, eigenvalues (K,), obs_indices (m,),
    n_cells, dt, n_steps, mean (cells,) f32, segment_steps.

    ``cfl_amax`` bounds |u| for the static time step dt = ½·h/amax, then
    shortened so that ``n_steps`` of it hit ``t_final``. ``obs_times``:
    increasing times in (0, t_final], snapped to that grid; the state is
    observed after each segment."""
    centers = (np.arange(n_cells) + 0.5) / n_cells
    basis = kl.fourier_basis(n_modes, centers)
    k_eff = np.maximum(1, (np.arange(n_modes) + 1) // 2)  # mode frequency
    lam = field_scale * (2.0 * np.pi * k_eff) ** (-2.0 * alpha)
    if mean_profile is None:
        mean = np.zeros(n_cells, np.float32)
    else:
        mean = np.asarray(mean_profile, np.float32)
    h = 1.0 / n_cells
    dt = 0.5 * h / cfl_amax
    n_steps = int(np.ceil(t_final / dt))
    dt = t_final / n_steps  # hit t_final exactly, still CFL-safe
    if obs_indices is None:
        obs_indices = np.linspace(0, n_cells - 1, 16).round().astype(int)

    if obs_times is None:
        segment_steps = [n_steps]
    else:
        ts = np.asarray(obs_times, float)
        if not (np.all(np.diff(ts) > 0) and ts[0] > 0 and ts[-1] <= t_final + 1e-9):
            raise ValueError(
                f"obs_times must be increasing in (0, t_final={t_final}], got {ts}"
            )
        step_idx = np.clip(np.round(ts / dt).astype(int), 1, n_steps)
        if len(np.unique(step_idx)) != len(step_idx):
            raise ValueError(f"obs_times collapse onto the same CFL steps: {step_idx}")
        segment_steps = np.diff(np.concatenate([[0], step_idx])).tolist()

    return {
        "scaled_basis": (np.sqrt(lam)[:, None] * basis).astype(np.float32),
        "eigenvalues": lam,
        "obs_indices": np.asarray(obs_indices),
        "n_cells": n_cells,
        "dt": dt,
        "n_steps": n_steps,
        "mean": mean,
        "segment_steps": segment_steps,
    }


def godunov_flux2(u_left: torch.Tensor, u_right: torch.Tensor) -> torch.Tensor:
    """Twice the exact Godunov flux of f(u) = u²/2:
    2F = max(max(u_l, 0)², min(u_r, 0)²). The ½ goes into the time-step
    constant of the caller. NaN propagates, as in ``jnp.maximum``."""
    fl = torch.square(torch.clamp(u_left, min=0.0))
    fr = torch.square(torch.clamp(u_right, max=0.0))
    return torch.maximum(fl, fr)


def step_burgers(state: torch.Tensor, dt_over_h: float, dim: int = 0) -> torch.Tensor:
    """One periodic finite-volume step u_i −= dt/h (F_{i+½} − F_{i−½}) with
    the cells on ``dim``: the first axis of a (cells, B) state, as the body
    of the JAX batched misfit, or the last (``dim=-1``) of a chains-first
    (..., cells) one, as JAX's ``step_burgers``."""
    flux2_right = godunov_flux2(state, torch.roll(state, -1, dim))  # 2F_{i+½}
    flux2_left = torch.roll(flux2_right, 1, dim)                    # 2F_{i−½}
    return state - (0.5 * dt_over_h) * (flux2_right - flux2_left)


def integrate(u0: torch.Tensor, dt: float, n_steps: int, record_every: int = 0):
    """``n_steps`` Godunov steps of a chains-first (..., cells) state, cell
    width 1/cells. ``record_every`` 0: the final state; else also the
    states after every ``record_every``-th step, (steps // record_every,
    ..., cells)."""
    dt_over_h = dt * u0.shape[-1]
    state, traj = u0, []
    for i in range(1, int(n_steps) + 1):
        state = step_burgers(state, dt_over_h, dim=-1)
        if record_every and i % record_every == 0:
            traj.append(state)
    if record_every == 0:
        return state
    return state, torch.stack(traj) if traj else state.new_zeros((0,) + state.shape)


def make_burgers_forward(n_cells: int = 128, n_modes: int = 16, alpha: float = 1.5,
                         field_scale: float = 2.0, t_final: float = 0.3,
                         cfl_amax: float = 3.0, obs_indices=None, mean_profile=None,
                         obs_times=None, device="cuda"):
    """(forward, aux): forward(u) maps whitened KL coefficients u (..., K)
    to the state at the observation cells after each segment of
    ``burgers_aux`` (at ``t_final``, or at each of ``obs_times``),
    concatenated segment-major: (..., segments · m). The initial state is
    mean + u · scaled_basis; chains stay on the leading dimensions. ``aux``
    holds ``burgers_aux``'s keys, the arrays as tensors on ``device`` (the
    card unless the caller asks for the CPU)."""
    device = resolve_device(str(device))
    consts = burgers_aux(n_cells, n_modes, alpha, field_scale, t_final, cfl_amax,
                         obs_indices, mean_profile, obs_times)
    aux = dict(consts)
    for k in ("scaled_basis", "mean"):
        aux[k] = torch.tensor(consts[k], device=device)
    aux["eigenvalues"] = torch.tensor(consts["eigenvalues"], dtype=torch.float32,
                                      device=device)
    aux["obs_indices"] = torch.as_tensor(consts["obs_indices"], dtype=torch.long,
                                         device=device)
    basis, mean, obs, dt = aux["scaled_basis"], aux["mean"], aux["obs_indices"], aux["dt"]

    def forward(u):
        state = mean + u @ basis
        outs = []
        for seg in consts["segment_steps"]:
            state = integrate(state, dt, int(seg))
            outs.append(state[..., obs])
        return torch.cat(outs, dim=-1)

    return forward, aux


class BurgersMisfit(nn.Module):
    """Batched Burgers misfit Φ: (K, B) f32 → (B,) f32.

    Buffers: ``basis`` (K, cells) scaled KL basis; ``mean`` (cells,);
    ``obs`` (m,) int32 cells, observed after every segment; ``data`` and
    ``noise`` (segments·m,), segment-major. ``segments``: the Godunov steps
    of each segment; ``dt_over_h`` = dt·cells in float64, whose half enters
    the f32 arithmetic as one rounded f32 (``half_dt_over_h``)."""

    MAX_SEGMENTS = 8  # IPX_MAX_SEGMENTS of csrc/burgers_misfit.cuh

    def __init__(self, scaled_basis, mean, obs_indices, data, noise_scale,
                 n_cells: int, dt: float, segment_steps):
        super().__init__()
        n = int(n_cells)
        basis = np.ascontiguousarray(scaled_basis, np.float32)  # read row-major by the kernel
        mean = np.asarray(mean, np.float32).reshape(-1)
        if basis.ndim != 2 or basis.shape[1] != n or mean.shape != (n,):
            raise ValueError(
                f"basis {basis.shape} / mean {mean.shape} do not match "
                f"n_cells {n}"
            )
        obs = np.asarray(obs_indices).reshape(-1)
        if obs.size and (obs.min() < 0 or obs.max() >= n):
            raise ValueError(f"observation cells outside [0, {n})")
        segments = tuple(int(s) for s in segment_steps)
        if not 1 <= len(segments) <= self.MAX_SEGMENTS or min(segments) < 0:
            raise ValueError(
                f"segment_steps: 1 to {self.MAX_SEGMENTS} non-negative step "
                f"counts, got {segments}"
            )
        data = np.asarray(data, np.float32).reshape(-1)
        if data.size != len(segments) * obs.size:
            raise ValueError(
                f"data has {data.size} values for {len(segments)} segments "
                f"of {obs.size} observations"
            )
        noise = np.broadcast_to(
            np.asarray(noise_scale, np.float32), data.shape
        ).copy()
        self.n, self.K, self.segments = n, basis.shape[0], segments
        self.dt_over_h = float(dt) * n
        self.register_buffer("basis", torch.tensor(basis))
        self.register_buffer("mean", torch.tensor(mean))
        self.register_buffer("obs", torch.tensor(obs.astype(np.int32)))
        self.register_buffer("data", torch.tensor(data))
        self.register_buffer("noise", torch.tensor(noise))

    @property
    def half_dt_over_h(self) -> float:
        """½·dt/h formed in float64 and rounded once to f32, the constant
        of the update in both versions."""
        return float(np.float32(0.5 * self.dt_over_h))

    @property
    def _tag(self) -> str:
        return f"[n={self.n},steps={'+'.join(str(s) for s in self.segments)}]"

    @property
    def kernel_label(self) -> str:
        """This misfit's name in the launch counts: the kernel that its
        spec goes to."""
        if _burgers_warp.misfit_takes(self.n, self.K):
            return _burgers_warp.MISFIT_WARP_KERNEL + self._tag
        return "burgers_misfit_kernel" + self._tag

    def forward(self, U: torch.Tensor) -> torch.Tensor:
        if U.device.type == "cuda":
            return self._forward_kernel(U)
        if U.device.type == "cpu":
            return self._forward_plain(U)
        raise ValueError(f"BurgersMisfit: unsupported device {U.device}")

    # --- the kernel -------------------------------------------------------

    def spec(self) -> _build.BurgersSpec:
        """The C view of this misfit (device pointers into the buffers)."""
        steps = (ctypes.c_int * self.MAX_SEGMENTS)(*self.segments)
        return _build.BurgersSpec(
            basis=self.basis.data_ptr(), mean=self.mean.data_ptr(),
            obs=self.obs.data_ptr(), data=self.data.data_ptr(),
            noise=self.noise.data_ptr(), n_cells=self.n, K=self.K,
            m=int(self.obs.numel()), n_segments=len(self.segments),
            seg_steps=steps, half_dt_over_h=self.half_dt_over_h,
        )

    def check_input(self, U: torch.Tensor, what: str = "U"):
        if U.dtype != torch.float32 or U.dim() != 2 or U.shape[0] != self.K:
            raise ValueError(
                f"{what}: expected f32 (K={self.K}, B), got {U.dtype} "
                f"{tuple(U.shape)}"
            )
        if U.device != self.basis.device:
            raise ValueError(
                f"{what} on {U.device} but the misfit's buffers are on "
                f"{self.basis.device}"
            )

    def _forward_kernel(self, U: torch.Tensor) -> torch.Tensor:
        self.check_input(U)
        U = U.contiguous()
        B = U.shape[1]
        phi = torch.empty(B, dtype=torch.float32, device=U.device)
        spec = self.spec()
        status = _build.library().ipx_burgers_misfit(
            ctypes.byref(spec), U.data_ptr(), B, phi.data_ptr(),
            torch.cuda.current_stream(U.device).cuda_stream,
        )
        _build.check(status, self.kernel_label)
        _build.launch_counts[self.kernel_label] += 1
        return phi

    # --- the plain version ------------------------------------------------

    def final_states(self, U: torch.Tensor):
        """The (cells, B) state at the end of each segment, plain PyTorch."""
        state = self.mean[:, None] + self.basis.T @ U
        states = []
        for seg in self.segments:
            for _ in range(seg):
                state = step_burgers(state, self.dt_over_h)
            states.append(state)
        return states

    def _forward_plain(self, U: torch.Tensor) -> torch.Tensor:
        """Plain Φ on any device."""
        self.check_input(U)
        _build.launch_counts["burgers_misfit_plain" + self._tag] += 1
        obs = self.obs.long()
        pred = torch.cat([s[obs] for s in self.final_states(U)], dim=0)
        r = (self.data[:, None] - pred) / self.noise[:, None]
        return 0.5 * torch.sum(r * r, dim=0)
