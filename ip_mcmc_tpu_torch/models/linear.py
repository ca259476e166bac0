"""Linear forward model G(u) = A u (+ b) and the linear-Gaussian potential
(mirrors ``ip_mcmc_tpu/models/linear.py``; the potential is the form that
the JAX package's RWM / dense-pCN / adaptive-pCN Pallas kernels are fed as
closures).

``make_forward`` and ``conjugate_posterior`` are the scan path's: the
forward map on a (d,) position or an (n, d) batch of chains, and the exact
Gaussian posterior of y = A u + η in numpy (the oracle of ``lingauss_pcn``).

``LinearGaussianPotential`` is Φ(U) = ½‖(y − A(U − c))/σ‖² for a
features-first (d, B) batch, the potential type that the samplers of K14–K16
take. One form expresses every target the JAX package gives those kernels:
the analytic Gaussian of ``benchmarks/compare_paths.py`` (A = I, c = mean,
σ = √var), ``gauss2d_rwm``'s ½ dᵀ P d (A = Lᵀ with P = L Lᵀ, c = mean),
``lingauss_pcn``'s misfit (c = 0, σ = 0.05) and the tests' potentials (m = 0
gives Φ ≡ 0). It carries no prior term: a sampler that targets misfit +
prior adds the prior in its step. For CUDA tensors the module launches
``linear_gaussian_misfit_kernel`` (``csrc/fused_rwm.cu``, device code in
``csrc/gaussian_potential.cuh``); for CPU tensors it runs the plain version.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
from torch import nn

from ip_mcmc_tpu_torch.ops import _build


def make_forward(A, b=None):
    """u ↦ A u (+ b) on a (d,) position or an (n, d) batch of chains."""
    A = torch.as_tensor(A)
    b = None if b is None else torch.as_tensor(b)

    def forward(u):
        out = u @ A.T
        return out if b is None else out + b

    return forward


def conjugate_posterior(A, prior_mean, prior_cov, noise_cov, y):
    """Exact Gaussian posterior (mean, cov) for y = A u + η (numpy)."""
    A = np.asarray(A, dtype=float)
    prior_cov = np.asarray(prior_cov, dtype=float)
    if prior_cov.ndim == 1:
        prior_cov = np.diag(prior_cov)
    noise_cov = np.asarray(noise_cov, dtype=float)
    if noise_cov.ndim == 1:
        noise_cov = np.diag(noise_cov)
    prec = np.linalg.inv(prior_cov) + A.T @ np.linalg.solve(noise_cov, A)
    cov = np.linalg.inv(prec)
    mean = cov @ (
        np.linalg.solve(prior_cov, np.asarray(prior_mean, dtype=float))
        + A.T @ np.linalg.solve(noise_cov, np.asarray(y, dtype=float))
    )
    return mean, cov


class LinearGaussianPotential(nn.Module):
    """Φ: (d, B) f32 → (B,) f32, Φ(U) = ½‖(y − A(U − c))/σ‖².

    Buffers: ``A`` (m, d) and its transpose ``At`` (the kernel's, row-major),
    ``center`` c (d,), ``data`` y (m,), ``noise`` σ (m,); m = 0 is allowed
    and gives Φ ≡ 0. The CUDA side runs one thread
    per coordinate, so d is at most ``MAX_DIM``."""

    MAX_DIM = 256  # LinearGaussianPotential::kMaxThreads, csrc/gaussian_potential.cuh
    kernel_label = "linear_gaussian_misfit_kernel"
    grad_kernel_label = "linear_gaussian_misfit_grad_kernel"

    def __init__(self, A, data, noise_scale, center=None):
        super().__init__()
        A = np.asarray(A, np.float32)
        if A.ndim != 2 or not 1 <= A.shape[1] <= self.MAX_DIM:
            raise ValueError(
                f"A: expected (m, d) with 1 <= d <= {self.MAX_DIM}, got {A.shape}"
            )
        m, d = A.shape
        data = np.asarray(data, np.float32).reshape(-1)
        if data.shape != (m,):
            raise ValueError(f"data has shape {data.shape}, A has {m} rows")
        noise = np.broadcast_to(np.asarray(noise_scale, np.float32), (m,)).copy()
        center = (np.zeros(d, np.float32) if center is None
                  else np.asarray(center, np.float32).reshape(-1))
        if center.shape != (d,):
            raise ValueError(f"center has shape {center.shape}, expected ({d},)")
        self.m, self.K = m, d
        self.register_buffer("A", torch.tensor(A))
        # the kernel's copy, A transposed and row-major: (d, m), read by
        # position (a transposed input keeps its strides in ``A``)
        self.register_buffer("At", torch.tensor(np.ascontiguousarray(A.T)))
        self.register_buffer("center", torch.tensor(center))
        self.register_buffer("data", torch.tensor(data))
        self.register_buffer("noise", torch.tensor(noise))

    def forward(self, U: torch.Tensor) -> torch.Tensor:
        if U.device.type == "cuda":
            return self._forward_kernel(U)
        if U.device.type == "cpu":
            return self._forward_plain(U)
        raise ValueError(f"LinearGaussianPotential: unsupported device {U.device}")

    # --- the kernel -------------------------------------------------------

    def spec(self) -> _build.GaussianSpec:
        """The C view of this potential (device pointers into the buffers,
        which the kernel reads as dense row-major arrays)."""
        if not all(t.is_contiguous() for t in (self.At, self.center, self.data,
                                               self.noise)):
            raise ValueError("LinearGaussianPotential buffers must be contiguous")
        return _build.GaussianSpec(
            At=self.At.data_ptr(), center=self.center.data_ptr(),
            data=self.data.data_ptr(), noise=self.noise.data_ptr(),
            m=self.m, K=self.K,
        )

    def check_input(self, U: torch.Tensor, what: str = "U", dtype=torch.float32):
        if U.dtype != dtype or U.dim() != 2 or U.shape[0] != self.K:
            want = "f32" if dtype == torch.float32 else str(dtype)
            raise ValueError(
                f"{what}: expected {want} (d={self.K}, B), got {U.dtype} "
                f"{tuple(U.shape)}"
            )
        if U.device != self.A.device:
            raise ValueError(
                f"{what} on {U.device} but the potential's buffers are on "
                f"{self.A.device}"
            )

    def _forward_kernel(self, U: torch.Tensor) -> torch.Tensor:
        self.check_input(U)
        U = U.contiguous()
        B = U.shape[1]
        phi = torch.empty(B, dtype=torch.float32, device=U.device)
        spec = self.spec()
        status = _build.library().ipx_linear_gaussian_misfit(
            ctypes.byref(spec), U.data_ptr(), B, phi.data_ptr(),
            torch.cuda.current_stream(U.device).cuda_stream,
        )
        _build.check(status, self.kernel_label)
        _build.launch_counts[self.kernel_label] += 1
        return phi

    def value_and_grad(self, U: torch.Tensor):
        """(Φ (B,), ∇Φ (d, B)) with ∇Φ = −Aᵀ((y − A(U − c))/σ²): for CUDA
        tensors one launch of ``linear_gaussian_misfit_grad_kernel``
        (``csrc/fused_rwm.cu``; the start positions of cold MALA), for CPU
        tensors the plain version."""
        if U.device.type == "cuda":
            self.check_input(U)
            U = U.contiguous()
            B = U.shape[1]
            phi = torch.empty(B, dtype=torch.float32, device=U.device)
            grad = torch.empty_like(U)
            spec = self.spec()
            status = _build.library().ipx_linear_gaussian_misfit_grad(
                ctypes.byref(spec), U.data_ptr(), B, phi.data_ptr(), grad.data_ptr(),
                torch.cuda.current_stream(U.device).cuda_stream,
            )
            _build.check(status, self.grad_kernel_label)
            _build.launch_counts[self.grad_kernel_label] += 1
            return phi, grad
        if U.device.type == "cpu":
            return self._value_and_grad_plain(U)
        raise ValueError(f"LinearGaussianPotential: unsupported device {U.device}")

    # --- the plain version ------------------------------------------------

    def _value_and_grad_plain(self, U: torch.Tensor):
        """Plain (Φ, ∇Φ) on any device, in the kernel's form: the weights
        r/σ, then ∇Φ = −Aᵀ(r/σ). In the buffers' dtype (f64 after
        ``.double()``)."""
        self.check_input(U, dtype=self.A.dtype)
        _build.launch_counts["linear_gaussian_misfit_grad_plain"] += 1
        r = (self.data[:, None] - self.A @ (U - self.center[:, None])) / self.noise[:, None]
        return 0.5 * torch.sum(r * r, dim=0), -(self.A.T @ (r / self.noise[:, None]))

    def _forward_plain(self, U: torch.Tensor) -> torch.Tensor:
        """Plain Φ on any device."""
        self.check_input(U)
        _build.launch_counts["linear_gaussian_misfit_plain"] += 1
        r = (self.data[:, None] - self.A @ (U - self.center[:, None])) / self.noise[:, None]
        return 0.5 * torch.sum(r * r, dim=0)
