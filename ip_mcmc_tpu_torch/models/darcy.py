"""Darcy-flow misfit: −∇·(a(x)∇p) = f on the unit square, p|∂Ω = 0
(mirrors ``ip_mcmc_tpu/models/darcy.py``).

``darcy_aux`` builds the constants of ``make_darcy_forward`` (scaled KL
basis, observation cells, source) in numpy. ``DarcyMisfit`` is
``make_batched_misfit``: Φ for a features-first (K, B) batch of whitened KL
coefficients — KL reconstruction, exp, harmonic-mean face
transmissibilities, fixed-count PCG on the 5-point finite-volume operator
with the Jacobi or ``dst_trunc`` preconditioner (or, with
``solver="richardson"``, fixed-ω preconditioned Richardson: K17,
``_richardson_flat``), pressure at the observation cells,
½‖(y − pred)/σ‖². Its ``value_and_grad`` is the adjoint
method of ``differentiable=True`` (one more CG solve A λ = −Oᵀ(res/σ) and
the closed-form derivative of the harmonic means), and a tensor that
requires grad goes through a ``torch.autograd.Function`` with that adjoint
as its backward. ``DarcyMisfitWarm`` is ``make_batched_misfit_warm``:
(U, x0) → (Φ, x), the CG started from ``x0`` and its solution returned,
with the dense ``dst`` preconditioner as a third choice.
``DarcyMisfitMalaWarm`` is ``make_batched_misfit_mala_warm``: (U, aux0) →
(Φ, ∇Φ, aux), aux stacking the forward and the adjoint solution, both
solves started from aux0.
``choose_pod_rank``, ``make_pod_surrogate`` and
``make_pod_surrogate_online`` are the POD reduced-order surrogates of the
scan delayed-acceptance path (plain PyTorch and a batched Cholesky; no TPU
kernel runs them).

For CUDA tensors the modules launch ``darcy_misfit_kernel``
(``csrc/fused_da_pcn.cu``), ``darcy_misfit_warm_kernel``
(``csrc/fused_pcn.cu``), ``darcy_misfit_grad_kernel`` or
``darcy_misfit_grad_warm_kernel`` (``csrc/fused_mala.cu``), one draw a CTA;
a misfit on the level of a cluster sampler
(``_cluster.misfit_cluster_takes``: 64×64 or 32×32, dst_trunc, CG) goes to
``darcy_misfit_cluster_kernel`` / ``darcy_misfit_warm_cluster_kernel`` (64×64)
or ``darcy_misfit_cluster32_kernel`` / ``darcy_misfit_warm_cluster32_kernel``
(32×32) instead, G draws a thread-block cluster on the samplers' solve, a
cold one on the 64×64 DA kernel's 32×32 surrogate level (K above 64) to
``darcy_misfit_surr_cluster_kernel``; the warm MALA kernel's value and
gradient (``fused_mala.misfit_grad_warm_warp_takes``: 16×16, K 64, dense
dst, CG) to ``darcy_misfit_grad_warm_warp_kernel``, a draw a warp on its
solve; the warm misfit of the 16×16 warm pCN
(``fused_pcn.misfit_warm_warp_takes``: 16×16, K 64, dst_trunc of up to 112
modes, CG) to ``darcy_misfit_warm_warp_kernel``, a draw a warp on that
kernel's solve; a cold misfit on a
level of the 16×16 DA kernel
(``fused_da_pcn.misfit_warp_takes``: 16×16, K 64, dst_trunc, CG, its exact
level; 8×8, K 64, dst_trunc or Jacobi, CG or Richardson, its surrogate
level) to ``darcy_misfit_warp_kernel``, a draw a warp on that kernel's
solve; the
cold 16×16 Jacobi CG misfit of the ESS, pCN, FES and MALA kernels
(``fused_da_pcn.misfit_slice_takes``, ``fused_mala.misfit_grad_warp_takes``:
16×16, K 64, Jacobi, CG) to ``darcy_misfit_slice_kernel`` and, for its
value and gradient, ``darcy_misfit_grad_warp_kernel``, a draw a warp on
their samplers' solve. The launch counts name the kernel (``kernel_label``,
``grad_kernel_label``, ``warm_kernel_label``).
For CPU tensors they run the plain versions. Those use the readable 2-D (n, n, B) layout;
the JAX flat layout with wrap masks, Kronecker factors and one-hot
observation matmuls exists only because Mosaic lacks in-kernel reshapes
and gathers.
"""

from __future__ import annotations

import copy
import ctypes

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ip_mcmc_tpu_torch._device import resolve_device
from ip_mcmc_tpu_torch.kernels.base import normals
from ip_mcmc_tpu_torch.models import kl
from ip_mcmc_tpu_torch.ops import _build, _cluster, fused_da_pcn, fused_mala, fused_pcn
from ip_mcmc_tpu_torch.parallel import grid_shard


def default_observation_indices(n: int, n_obs_per_dim: int = 4):
    """Evenly spaced interior observation cells (flattened indices)."""
    pos = np.linspace(0, n - 1, n_obs_per_dim + 2)[1:-1].round().astype(int)
    ii, jj = np.meshgrid(pos, pos, indexing="ij")
    return (ii * n + jj).ravel()


def darcy_aux(n_grid: int = 16, n_modes_per_dim: int = 8, alpha: float = 2.0,
              field_scale: float = 10.0, obs_indices=None):
    """The constants of ``make_darcy_forward``'s aux dict, as numpy:
    scaled_basis (K, n²) f32, eigenvalues (K,), obs_indices (m,), n_grid,
    source (n²,) f32 (the unit source)."""
    basis, ij = kl.sine_basis_2d(n_modes_per_dim, n_grid)
    lam = kl.laplacian_eigenvalues_2d(ij, alpha=alpha, scale=field_scale)
    if obs_indices is None:
        obs_indices = default_observation_indices(n_grid)
    return {
        "scaled_basis": (np.sqrt(lam)[:, None] * basis).astype(np.float32),
        "eigenvalues": lam,
        "obs_indices": np.asarray(obs_indices),
        "n_grid": n_grid,
        "source": np.ones(n_grid * n_grid, np.float32),
    }


def dst_factors(n: int):
    """The orthonormal sine matrix S (n, n) (mode k along rows) and the
    eigenvalues λ (n, n) = n²(e_k1 + e_k2) of the constant-coefficient
    operator, f64, as in ``_flat_dst_preconditioner``."""
    j = np.arange(n) + 0.5
    k = np.arange(1, n + 1)[:, None]
    S = np.sin(np.pi * k * j[None, :] / n) * np.sqrt(2.0 / n)
    S[-1] *= np.sqrt(0.5)
    e = 2.0 - 2.0 * np.cos(np.pi * np.arange(1, n + 1) / n)
    return S, float(n * n) * (e[:, None] + e[None, :])


def truncated_dst_modes(n: int, k_modes: int):
    """The ``k_modes`` lowest-eigenvalue 2-D sine modes of the constant-
    coefficient operator: (V (k_modes, n²) f64 rows, λ (k_modes,) f64), as
    in ``_flat_truncated_dst_preconditioner``."""
    S, lam2d = dst_factors(n)
    order = np.argsort(lam2d.reshape(-1), kind="stable")[:k_modes]
    k1, k2 = order // n, order % n
    V = (S[k1][:, :, None] * S[k2][:, None, :]).reshape(k_modes, n * n)
    return V, lam2d.reshape(-1)[order]


class DarcyMisfit(nn.Module):
    """Batched Darcy misfit Φ: (K, B) f32 → (B,) f32.

    Buffers: ``basis`` (K, n²) scaled KL basis; ``V`` (modes, n²) bf16
    preconditioner modes and ``lam`` (modes,) their eigenvalues (modes = 0
    unless ``dst_trunc``); for ``dst`` the bf16 sine matrix ``S`` (n, n)
    and ``lam`` (n²,); ``source`` (n²,); ``obs`` (m,) int32 cells;
    ``data`` and ``noise`` (m,).

    ``solver``: "cg" or "richardson" (``cg_iters`` iterations either way;
    ``omega`` is Richardson's relaxation). As in JAX, Richardson takes
    either preconditioner and has no adjoint gradient."""

    PRECONDS = ("jacobi", "dst_trunc")
    SOLVERS = ("cg", "richardson")

    def __init__(self, scaled_basis, obs_indices, source, data, noise_scale,
                 n_grid: int, cg_iters: int = 48, precond: str = "jacobi",
                 precond_modes: int = 128, log_a_mean: float = 0.0,
                 solver: str = "cg", omega: float = 1.0):
        super().__init__()
        if precond not in self.PRECONDS:
            raise ValueError(
                f"precond must be one of {self.PRECONDS}, got {precond!r}"
            )
        if solver not in self.SOLVERS:
            raise ValueError(
                f"solver must be one of {self.SOLVERS}, got {solver!r}"
            )
        n = int(n_grid)
        basis = np.ascontiguousarray(scaled_basis, np.float32)  # read row-major by the kernel
        if basis.shape[1] != n * n:
            raise ValueError(f"basis {basis.shape} does not match n_grid {n}")
        obs = np.asarray(obs_indices).reshape(-1)
        data = np.asarray(data, np.float32).reshape(-1)
        noise = np.broadcast_to(
            np.asarray(noise_scale, np.float32), data.shape
        ).copy()
        modes = int(precond_modes) if precond == "dst_trunc" else 0
        V, lam, S = np.zeros((0, n * n)), np.zeros((0,)), np.zeros((0, 0))
        if modes:
            V, lam = truncated_dst_modes(n, modes)
        elif precond == "dst":
            S, lam = dst_factors(n)
            lam = lam.reshape(-1)
        self.n, self.K, self.modes = n, basis.shape[0], modes
        self.precond, self.solver = precond, solver
        self.cg_iters, self.log_a_mean = int(cg_iters), float(log_a_mean)
        self.omega = float(np.float32(omega))  # the f32 ω of the JAX solve
        self.register_buffer("basis", torch.tensor(basis))
        self.register_buffer(
            "V", torch.tensor(V.astype(np.float32)).to(torch.bfloat16)
        )
        self.register_buffer("lam", torch.tensor(lam.astype(np.float32)))
        self.register_buffer(
            "S", torch.tensor(S.astype(np.float32)).to(torch.bfloat16)
        )
        self.register_buffer(
            "source", torch.tensor(np.asarray(source, np.float32).reshape(-1))
        )
        self.register_buffer("obs", torch.tensor(obs.astype(np.int32)))
        self.register_buffer("data", torch.tensor(data))
        self.register_buffer("noise", torch.tensor(noise))
        i, j = np.divmod(np.arange(n * n), n)
        edge = (i == 0).astype(np.float32) + (i == n - 1) + (j == 0) + (j == n - 1)
        self.register_buffer("edge", torch.tensor(edge.reshape(n, n, 1)))

    def forward(self, U: torch.Tensor) -> torch.Tensor:
        if U.requires_grad and torch.is_grad_enabled():
            return _MisfitWithAdjoint.apply(U, self, False)
        if U.device.type == "cuda":
            return self._forward_kernel(U)
        if U.device.type == "cpu":
            return self._forward_plain(U)
        raise ValueError(f"DarcyMisfit: unsupported device {U.device}")

    def value_and_grad(self, U: torch.Tensor):
        """(Φ (B,), ∇Φ (K, B)) by the adjoint method, both solves from 0."""
        self._require_cg("the adjoint gradient")
        if U.device.type == "cuda":
            return self._grad_kernel(U, None)[:2]
        if U.device.type == "cpu":
            _build.launch_counts[f"darcy_misfit_grad_plain[n={self.n}]"] += 1
            return self._value_and_grad_plain(U)[:2]
        raise ValueError(f"DarcyMisfit: unsupported device {U.device}")

    def _require_cg(self, what: str):
        """JAX refuses solver="richardson" with differentiable=True: the
        adjoint solve reuses the forward solver, and Richardson is meant
        for surrogates, which are never differentiated."""
        if self.solver != "cg":
            raise ValueError(
                f"{what} needs solver='cg' (solver={self.solver!r} is for "
                "surrogate misfits, which are never differentiated)"
            )

    @property
    def spec_fields(self) -> dict:
        """The fields the kernels' dispatch rules read (grid, K,
        preconditioner, modes, solver), as keyword arguments of the rules'
        Python mirrors."""
        return dict(n=self.n, K=self.K, precond=self.precond, modes=self.modes,
                    solver=self.solver)

    @property
    def on_cluster(self) -> bool:
        """Whether the card solves this misfit on a cluster sampler's level:
        the 64×64 samplers' exact level, the 32×32 warm pCN's or the 64×64 DA
        kernel's 32×32 surrogate level (``_cluster.misfit_cluster_takes``,
        ``misfit_cluster_takes`` of ``csrc/darcy_misfit.cuh``)."""
        return _cluster.misfit_cluster_takes(**self.spec_fields)

    @property
    def kernel_label(self) -> str:
        """The launch count's name of the kernel that ``ipx_darcy_misfit``
        sends this misfit to: a draw a warp on a level of the 16×16 DA
        kernel, the exact one or the 8×8 surrogate by its solver
        (``fused_da_pcn.misfit_warp_takes``), a draw a warp on the
        16×16 Jacobi solve of the ESS, cold pCN and FES kernels
        (``fused_da_pcn.misfit_slice_takes``), G draws a cluster on a
        cluster sampler's level (``_cluster.misfit_cluster_level``: the
        64×64 samplers' exact level, the 32×32 warm pCN's, the 64×64 DA
        kernel's 32×32 surrogate level), or one draw a CTA."""
        tag = "" if self.solver == "cg" else f",{self.solver}"
        if fused_da_pcn.misfit_warp_takes(**self.spec_fields):
            return f"{fused_da_pcn.MISFIT_WARP_KERNEL}[n={self.n}{tag}]"
        if fused_da_pcn.misfit_slice_takes(**self.spec_fields):
            return f"darcy_misfit_slice_kernel[n={self.n}]"
        level = _cluster.misfit_cluster_level(**self.spec_fields)
        if level is not None:
            return f"{_cluster.MISFIT_KERNELS[level]}[n={self.n}]"
        return f"darcy_misfit_kernel[n={self.n}{tag}]"

    # --- the kernel -------------------------------------------------------

    def spec(self) -> _build.MisfitSpec:
        """The C view of this misfit (device pointers into the buffers)."""
        if self.V.dtype != torch.bfloat16 or self.S.dtype != torch.bfloat16:
            raise ValueError(
                "the kernel takes bf16 preconditioner factors, got "
                f"{self.V.dtype} / {self.S.dtype}"
            )
        return _build.MisfitSpec(
            basis=self.basis.data_ptr(), V=self.V.data_ptr(),
            lam=self.lam.data_ptr(), S=self.S.data_ptr(),
            source=self.source.data_ptr(),
            obs=self.obs.data_ptr(), data=self.data.data_ptr(),
            noise=self.noise.data_ptr(), n=self.n, K=self.K, modes=self.modes,
            cg_iters=self.cg_iters, m=int(self.obs.numel()),
            precond=_build.PRECOND_CODES[self.precond],
            log_a_mean=self.log_a_mean,
            solver=_build.SOLVER_CODES[self.solver], omega=self.omega,
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
        lib = _build.library()
        spec = self.spec()
        status = lib.ipx_darcy_misfit(
            ctypes.byref(spec), U.data_ptr(), B, phi.data_ptr(),
            torch.cuda.current_stream(U.device).cuda_stream,
        )
        _build.check(status, self.kernel_label)
        _build.launch_counts[self.kernel_label] += 1
        return phi

    @property
    def grad_kernel_label(self) -> str:
        """The launch count's name of the kernel that ``ipx_darcy_misfit_grad``
        sends this misfit's cold value and gradient to: a draw a warp on the
        cold MALA kernel's solve (``fused_mala.misfit_grad_warp_takes``), or
        one draw a CTA."""
        if fused_mala.misfit_grad_warp_takes(**self.spec_fields):
            return f"{fused_mala.GRAD_WARP_KERNEL}[n={self.n}]"
        return f"darcy_misfit_grad_kernel[n={self.n}]"

    @property
    def grad_warm_kernel_label(self) -> str:
        """The launch count's name of the kernel that ``ipx_darcy_misfit_grad``
        sends this misfit's warm value and gradient to (aux0 given): a draw a
        warp on the warm MALA kernel's solve
        (``fused_mala.misfit_grad_warm_warp_takes``), or one draw a CTA."""
        if fused_mala.misfit_grad_warm_warp_takes(**self.spec_fields):
            return f"{fused_mala.GRAD_WARM_WARP_KERNEL}[n={self.n}]"
        return "darcy_misfit_grad_warm_kernel"

    def _grad_kernel(self, U, aux0):
        """``grad_kernel_label``'s kernel (``aux0`` None) or
        ``grad_warm_kernel_label``'s: (Φ, ∇Φ, aux or None)."""
        self.check_input(U)
        U = U.contiguous()
        B = U.shape[1]
        phi = torch.empty(B, dtype=torch.float32, device=U.device)
        grad = torch.empty_like(U)
        warm = aux0 is not None
        aux = None
        if warm:
            aux0 = aux0.contiguous()
            aux = torch.empty_like(aux0)
        spec = self.spec()
        status = _build.library().ipx_darcy_misfit_grad(
            ctypes.byref(spec), U.data_ptr(),
            aux0.data_ptr() if warm else None, B, phi.data_ptr(),
            grad.data_ptr(), aux.data_ptr() if warm else None,
            torch.cuda.current_stream(U.device).cuda_stream,
        )
        name = self.grad_warm_kernel_label if warm else self.grad_kernel_label
        _build.check(status, name)
        _build.launch_counts[name] += 1
        return phi, grad, aux

    # --- the plain version ------------------------------------------------

    def _precond(self, r, inv_diag, a_bar):
        """``dst_trunc``: M⁻¹r = D⁻¹r + Vᵀ q(V q(r) / (λ ā)); ``dst``: the
        dense fast-Poisson apply Sᵀ-transforms(q(S-transforms(q(r)) / (λ ā)))
        along columns then rows, no D⁻¹ term; q rounds to the factors'
        dtype (bf16: bf16 inputs with f32 accumulation — products of bf16
        values are exact in f32), the rest in r's dtype."""
        if self.precond == "dst":
            return self._precond_dst(r, a_bar)
        z = inv_diag * r
        if not self.modes:
            return z
        dt, Vf = self.V.dtype, self.V.to(r.dtype)
        rt = (Vf @ r.to(dt).to(r.dtype)) / (
            self.lam[:, None] * a_bar[None, :]
        )
        return z + Vf.T @ rt.to(dt).to(r.dtype)

    def _precond_dst(self, r, a_bar):
        n, dt, S = self.n, self.S.dtype, self.S.to(r.dtype)

        def q(v):
            return v.to(dt).to(r.dtype)

        y = torch.einsum("kj,ijb->ikb", S, q(r.reshape(n, n, -1)))
        rt = torch.einsum("ki,ijb->kjb", S, q(y)) / (
            self.lam.reshape(n, n, 1) * a_bar
        )
        w = torch.einsum("ki,kjb->ijb", S, q(rt))
        return torch.einsum("kj,ikb->ijb", S, q(w)).reshape(n * n, -1)

    def _forward_plain(self, U: torch.Tensor) -> torch.Tensor:
        """Plain Φ on any device; differentiable by the plain adjoint."""
        if U.requires_grad and torch.is_grad_enabled():
            return _MisfitWithAdjoint.apply(U, self, True)
        _build.launch_counts[f"darcy_misfit_plain[n={self.n}]"] += 1
        return self._solve_plain(U)[0]

    def _operator(self, U):
        """A(a) for the batch: (a (n, n, B), apply (N, B) → (N, B), inv_diag
        (N, B), a_bar (B,))."""
        n, B = self.n, U.shape[1]
        N, h2 = n * n, float(n * n)
        a = torch.exp(self.log_a_mean + self.basis.T @ U).reshape(n, n, B)
        # face transmissibilities, zero-padded to (n, n, B): t_h at the
        # face right of a cell, t_v at the face below it
        t_h = F.pad(
            2.0 * a[:, :-1] * a[:, 1:] / (a[:, :-1] + a[:, 1:] + 1e-38) * h2,
            (0, 0, 0, 1),
        )
        t_v = F.pad(
            2.0 * a[:-1] * a[1:] / (a[:-1] + a[1:] + 1e-38) * h2,
            (0, 0, 0, 0, 0, 1),
        )
        t_h_left = F.pad(t_h[:, :-1], (0, 0, 1, 0))
        t_v_up = F.pad(t_v[:-1], (0, 0, 0, 0, 1, 0))
        boundary = 2.0 * h2 * a * self.edge
        diag = t_h + t_h_left + t_v + t_v_up + boundary
        inv_diag = (1.0 / diag).reshape(N, B)
        a_bar = torch.exp(torch.mean(torch.log(a.reshape(N, B)), dim=0))

        def apply(p):  # A(a) p on (N, B)
            p = p.reshape(n, n, B)
            flux_h = t_h * (p - F.pad(p[:, 1:], (0, 0, 0, 1)))
            flux_v = t_v * (p - F.pad(p[1:], (0, 0, 0, 0, 0, 1)))
            out = flux_h - F.pad(flux_h[:, :-1], (0, 0, 1, 0))
            out = out + flux_v - F.pad(flux_v[:-1], (0, 0, 0, 0, 1, 0))
            return (out + boundary * p).reshape(N, B)

        return a, apply, inv_diag, a_bar

    def _cg(self, apply, inv_diag, a_bar, b, x0=None):
        """Fixed-count PCG on A x = b (N, B), from ``x0`` when given
        (r = b − A x0), else from 0."""

        def dots(u, v):
            return torch.sum(u * v, dim=0)

        if x0 is None:
            x, r = torch.zeros_like(b), b
        else:
            x, r = x0, b - apply(x0)
        z = self._precond(r, inv_diag, a_bar)
        p = z
        rz = dots(r, z)
        zero = torch.zeros_like(rz)
        for _ in range(self.cg_iters):
            Ap = apply(p)
            pAp = dots(p, Ap)
            # guards: once converged (r = 0) the recurrences hit 0/0 — the
            # iteration count is fixed, so freeze instead of emitting NaN
            alpha = torch.where(pAp > 0.0, rz / torch.where(pAp > 0.0, pAp, 1.0), zero)
            x = x + alpha * p
            r = r - alpha * Ap
            z = self._precond(r, inv_diag, a_bar)
            rz_new = dots(r, z)
            beta = torch.where(rz > 0.0, rz_new / torch.where(rz > 0.0, rz, 1.0), zero)
            p = z + beta * p
            rz = rz_new
        return x

    def _richardson(self, apply, inv_diag, a_bar, b):
        """Fixed-ω preconditioned Richardson on A x = b (N, B) from 0
        (``_richardson_flat``): x₁ = ω M⁻¹b, then ``cg_iters`` − 1 updates
        x ← x + ω M⁻¹(b − A x); ``cg_iters`` ≤ 1 leaves x₁. No dot products
        and no guards."""
        om = self.omega
        x = om * self._precond(b, inv_diag, a_bar)
        for _ in range(self.cg_iters - 1):
            x = x + om * self._precond(b - apply(x), inv_diag, a_bar)
        return x

    def _residuals(self, x):
        """(y − x at the observed cells) / σ, (m, B)."""
        return (self.data[:, None] - x[self.obs.long()]) / self.noise[:, None]

    def float64_twin(self):
        """A copy whose plain version computes in f64 with the same bf16
        roundings: its f32 buffers in f64, the preconditioner's bf16
        factors kept (``_precond`` rounds r and the coefficients to them and
        works in r's dtype). Feed it f64 inputs. From x0 = 0 a few CG
        iterations stop unconverged, where f32 summation order alone moves
        Φ by about 2e-5 relative at the 16×16 warm pCN's spec (PERF.md):
        against this copy, a kernel's distance is its own rounding, not the
        f32 twin's as well."""
        twin = copy.deepcopy(self)
        for name, buf in twin.named_buffers():
            if buf.dtype == torch.float32:
                setattr(twin, name, buf.double())
        return twin

    def _solve_plain(self, U, x0=None):
        """(Φ (B,), x (n², B)); the CG starts from ``x0`` (n², B) when given,
        else from 0."""
        N, B = self.n * self.n, U.shape[1]
        _, apply, inv_diag, a_bar = self._operator(U)
        b = self.source[:, None].expand(N, B)
        if self.solver == "richardson":
            x = self._richardson(apply, inv_diag, a_bar, b)
        else:
            x = self._cg(apply, inv_diag, a_bar, b, x0)
        res = self._residuals(x)
        return 0.5 * torch.sum(res * res, dim=0), x

    def _value_and_grad_plain(self, U, x0=None, lam0=None):
        """(Φ (B,), ∇Φ (K, B), x, λ (n², B)): the adjoint method written out
        (``phi_bwd`` and ``make_batched_misfit_mala_warm`` of the JAX
        package). Forward solve, adjoint solve A λ = ∂Φ/∂x = −Oᵀ(res/σ) on
        the same operator and preconditioner, then ∂Φ/∂a = −∇_a[λᵀ A(a) x]
        per cell: each face contributes t(a_i, a_j)(x_i − x_j)(λ_i − λ_j)
        with ∂t/∂a_i = 2h⁻²(a_j / (a_i + a_j))², the Dirichlet faces
        2h⁻² x λ per boundary side; ∇Φ = basis · (a · (−∂Φ/∂a))."""
        n, B = self.n, U.shape[1]
        N, h2 = n * n, float(n * n)
        a, apply, inv_diag, a_bar = self._operator(U)
        x = self._cg(apply, inv_diag, a_bar,
                     self.source[:, None].expand(N, B), x0)
        res = self._residuals(x)
        phi = 0.5 * torch.sum(res * res, dim=0)
        dphi_dx = torch.zeros_like(x).index_add_(
            0, self.obs.long(), res / self.noise[:, None]).neg_()
        lam = self._cg(apply, inv_diag, a_bar, dphi_dx, lam0)

        xg, lg = x.reshape(n, n, B), lam.reshape(n, n, B)
        den_h = 1.0 / (a[:, :-1] + a[:, 1:] + 1e-38)  # faces right of a cell
        den_v = 1.0 / (a[:-1] + a[1:] + 1e-38)        # faces below a cell
        s_h = (xg[:, :-1] - xg[:, 1:]) * (lg[:, :-1] - lg[:, 1:])
        s_v = (xg[:-1] - xg[1:]) * (lg[:-1] - lg[1:])
        g_a = (
            F.pad(2.0 * h2 * torch.square(a[:, 1:] * den_h) * s_h, (0, 0, 0, 1))
            + F.pad(2.0 * h2 * torch.square(a[:, :-1] * den_h) * s_h, (0, 0, 1, 0))
            + F.pad(2.0 * h2 * torch.square(a[1:] * den_v) * s_v, (0, 0, 0, 0, 0, 1))
            + F.pad(2.0 * h2 * torch.square(a[:-1] * den_v) * s_v, (0, 0, 0, 0, 1, 0))
            + 2.0 * h2 * xg * lg * self.edge
        )
        grad = self.basis @ (a * (-g_a)).reshape(N, B)
        return phi, grad, x, lam


class _MisfitWithAdjoint(torch.autograd.Function):
    """Φ(U) whose backward is the adjoint method (the ``custom_vjp`` of
    ``make_batched_misfit(differentiable=True)``): ∇Φ comes from
    ``value_and_grad`` together with Φ (``plain``: from the plain version
    whatever the device), and a cotangent t (B,) gives ∇Φ · t per draw."""

    @staticmethod
    def forward(ctx, U, misfit, plain):
        misfit._require_cg("the autograd path (the adjoint gradient)")
        if plain:
            _build.launch_counts[f"darcy_misfit_grad_plain[n={misfit.n}]"] += 1
            phi, grad = misfit._value_and_grad_plain(U.detach())[:2]
        else:
            phi, grad = misfit.value_and_grad(U.detach())
        ctx.save_for_backward(grad)
        return phi

    @staticmethod
    def backward(ctx, t):
        (grad,) = ctx.saved_tensors
        return grad * t[None, :], None, None


class DarcyMisfitWarm(DarcyMisfit):
    """Warm-started batched Darcy misfit: (U (K, B), x0 (n², B)) →
    (Φ (B,), x (n², B)). The fused warm pCN carries ``x`` (``aux_dim`` rows
    per chain) so each proposal's solve starts from the current state's
    solution; Φ then depends weakly on the chain's history through x0."""

    PRECONDS = ("jacobi", "dst", "dst_trunc")
    SOLVERS = ("cg",)  # JAX's warm builders take no solver

    @property
    def aux_dim(self) -> int:
        return self.n * self.n

    @property
    def warm_kernel_label(self) -> str:
        """The launch count's name of the kernel that
        ``ipx_darcy_misfit_warm`` sends this misfit to: a draw a warp on the
        16×16 warm pCN's solve (``fused_pcn.misfit_warm_warp_takes``) or, at
        dense dst, on warm MALA's (``fused_pcn.misfit_warm_dst_warp_takes``),
        the cluster levels a warm sampler solves on
        (``_cluster.misfit_cluster_takes`` with ``warm=True``), or one draw a
        CTA."""
        if fused_pcn.misfit_warm_warp_takes(**self.spec_fields):
            return f"{fused_pcn.MISFIT_WARM_WARP_KERNEL}[n={self.n}]"
        if fused_pcn.misfit_warm_dst_warp_takes(**self.spec_fields):
            return f"{fused_pcn.MISFIT_WARM_DST_WARP_KERNEL}[n={self.n}]"
        if not _cluster.misfit_cluster_takes(**self.spec_fields, warm=True):
            return "darcy_misfit_warm_kernel"
        return ("darcy_misfit_warm_cluster32_kernel" if self.n == _cluster.N32
                else "darcy_misfit_warm_cluster_kernel")

    def forward(self, U: torch.Tensor, x0: torch.Tensor):
        self.check_input(U)
        if (x0.dtype != torch.float32 or x0.shape != (self.aux_dim, U.shape[1])
                or x0.device != U.device):
            raise ValueError(
                f"x0: expected f32 ({self.aux_dim}, {U.shape[1]}) on "
                f"{U.device}, got {x0.dtype} {tuple(x0.shape)} on {x0.device}"
            )
        if U.device.type == "cuda":
            return self._forward_warm_kernel(U, x0)
        if U.device.type == "cpu":
            return self._forward_warm_plain(U, x0)
        raise ValueError(f"DarcyMisfitWarm: unsupported device {U.device}")

    def _forward_warm_kernel(self, U, x0, layout=False):
        U, x0 = U.contiguous(), x0.contiguous()
        B = U.shape[1]
        phi = torch.empty(B, dtype=torch.float32, device=U.device)
        x = torch.empty_like(x0)
        spec = self.spec()
        lib = _build.library()
        launch = lib.ipx_darcy_misfit_warm_layout if layout else lib.ipx_darcy_misfit_warm
        label = "darcy_misfit_warm_kernel" if layout else self.warm_kernel_label
        status = launch(
            ctypes.byref(spec), U.data_ptr(), x0.data_ptr(), B, phi.data_ptr(),
            x.data_ptr(), torch.cuda.current_stream(U.device).cuda_stream,
        )
        _build.check(status, label)
        _build.launch_counts[label] += 1
        return phi, x

    def forward_layout(self, U: torch.Tensor, x0: torch.Tensor):
        """(Φ, x) on the one-draw-a-CTA kernel of the grid's layout
        (``darcy_misfit_warm_kernel`` up to 16×16), whatever kernel the
        rules pick for this misfit: the reference that the kernels a draw a
        warp are held to on the card. CUDA tensors only."""
        if U.device.type != "cuda":
            raise ValueError(f"forward_layout launches a kernel: got {U.device}")
        return self._forward_warm_kernel(U, x0, layout=True)

    def _forward_warm_plain(self, U, x0):
        _build.launch_counts["darcy_misfit_warm_plain"] += 1
        return self._solve_plain(U, x0)


class DarcyMisfitMalaWarm(DarcyMisfit):
    """Warm-started value-and-gradient batched Darcy misfit for the fused
    warm MALA: (U (K, B), aux0 (2n², B)) → (Φ (B,), ∇Φ (K, B), aux
    (2n², B)). ``aux`` stacks the forward solution x (rows [0, n²)) and the
    adjoint solution λ (rows [n², 2n²)) of the chain's accepted state; both
    solves start from them. No prior term: the sampler folds it in."""

    PRECONDS = ("jacobi", "dst", "dst_trunc")
    SOLVERS = ("cg",)

    @property
    def aux_dim(self) -> int:
        return 2 * self.n * self.n

    def forward(self, U: torch.Tensor, aux0: torch.Tensor):
        self.check_input(U)
        if (aux0.dtype != torch.float32
                or aux0.shape != (self.aux_dim, U.shape[1])
                or aux0.device != U.device):
            raise ValueError(
                f"aux0: expected f32 ({self.aux_dim}, {U.shape[1]}) on "
                f"{U.device}, got {aux0.dtype} {tuple(aux0.shape)} on "
                f"{aux0.device}"
            )
        if U.device.type == "cuda":
            return self._grad_kernel(U, aux0)
        if U.device.type == "cpu":
            return self._forward_warm_plain(U, aux0)
        raise ValueError(f"DarcyMisfitMalaWarm: unsupported device {U.device}")

    def _forward_warm_plain(self, U, aux0):
        _build.launch_counts["darcy_misfit_grad_warm_plain"] += 1
        N = self.n * self.n
        phi, grad, x, lam = self._value_and_grad_plain(U, aux0[:N], aux0[N:])
        return phi, grad, torch.cat([x, lam], dim=0)


# --- the single-particle forward (make_darcy_forward) -------------------------
#
# The scan path's Darcy forward: one coefficient vector u (K,) → pressure at
# the observation cells, with the chains written out as leading batch
# dimensions (the JAX package vmaps it). Plain PyTorch on (..., n, n) grids:
# no TPU kernel of the JAX package runs it, so no kernel of the port does.


def _stencil_indices(n: int):
    """Static scatter indices of the 5-point finite-volume stencil on an
    n×n grid: the cells on either side of each horizontal face (h_left,
    h_right) and vertical face (v_top, v_bot), and the boundary cells of
    each edge (b_cells; a corner twice)."""
    idx = np.arange(n * n).reshape(n, n)
    return (idx[:, :-1].ravel(), idx[:, 1:].ravel(), idx[:-1, :].ravel(),
            idx[1:, :].ravel(),
            np.concatenate([idx[0, :], idx[-1, :], idx[:, 0], idx[:, -1]]))


def assemble_operator(a, indices, n: int):
    """The dense SPD operator A(a) (..., n², n²) of a conductivity field a
    (..., n, n), in ``assemble_operator``'s order of additions."""
    h_left, h_right, v_top, v_bot, b_cells = (torch.as_tensor(i, device=a.device)
                                              for i in indices)
    h2 = float(n * n)
    af = a.reshape(*a.shape[:-2], n * n)
    N = n * n
    t_h = 2.0 * af[..., h_left] * af[..., h_right] / (af[..., h_left] + af[..., h_right]) * h2
    t_v = 2.0 * af[..., v_top] * af[..., v_bot] / (af[..., v_top] + af[..., v_bot]) * h2
    t_b = 2.0 * af[..., b_cells] * h2  # Dirichlet: half a cell to the boundary
    A = torch.zeros(*a.shape[:-2], N, N, dtype=a.dtype, device=a.device)
    A[..., h_left, h_right] += -t_h
    A[..., h_right, h_left] += -t_h
    A[..., v_top, v_bot] += -t_v
    A[..., v_bot, v_top] += -t_v
    diag = torch.zeros_like(af)
    for cells, t in ((h_left, t_h), (h_right, t_h), (v_top, t_v), (v_bot, t_v), (b_cells, t_b)):
        diag = diag.index_add(-1, cells, t)  # b_cells holds each corner twice
    return A + torch.diag_embed(diag)


def _face_transmissibilities(a, n: int):
    """Harmonic-mean face transmissibilities × 1/h² of a field (..., n, n):
    t_h (..., n, n − 1), t_v (..., n − 1, n)."""
    h2 = float(n * n)
    left, right = a[..., :, :-1], a[..., :, 1:]
    top, bot = a[..., :-1, :], a[..., 1:, :]
    return 2.0 * left * right / (left + right) * h2, 2.0 * top * bot / (top + bot) * h2


def apply_operator(a, p, n: int):
    """Matrix-free A(a) p on (..., n, n) grids: the stencil arithmetic of
    ``assemble_operator``'s matrix, in ``apply_operator``'s order of
    additions (the faces, then the Dirichlet edges: top, bottom, left,
    right)."""
    tb = 2.0 * float(n * n)
    t_h, t_v = _face_transmissibilities(a, n)
    flux_h = t_h * (p[..., :, :-1] - p[..., :, 1:])
    flux_v = t_v * (p[..., :-1, :] - p[..., 1:, :])
    out = torch.zeros(torch.broadcast_shapes(a.shape, p.shape), dtype=p.dtype, device=p.device)
    out[..., :, :-1] += flux_h
    out[..., :, 1:] += -flux_h
    out[..., :-1, :] += flux_v
    out[..., 1:, :] += -flux_v
    out[..., 0, :] += tb * a[..., 0, :] * p[..., 0, :]
    out[..., -1, :] += tb * a[..., -1, :] * p[..., -1, :]
    out[..., :, 0] += tb * a[..., :, 0] * p[..., :, 0]
    out[..., :, -1] += tb * a[..., :, -1] * p[..., :, -1]
    return out


def _operator_diagonal(a, n: int):
    """diag(A(a)) as a (..., n, n) grid, for the Jacobi preconditioner."""
    tb = 2.0 * float(n * n)
    t_h, t_v = _face_transmissibilities(a, n)
    d = torch.zeros_like(a)
    d[..., :, :-1] += t_h
    d[..., :, 1:] += t_h
    d[..., :-1, :] += t_v
    d[..., 1:, :] += t_v
    d[..., 0, :] += tb * a[..., 0, :]
    d[..., -1, :] += tb * a[..., -1, :]
    d[..., :, 0] += tb * a[..., :, 0]
    d[..., :, -1] += tb * a[..., :, -1]
    return d


def dst_basis(n: int, device=None):
    """The orthonormal sine basis S (n, n) of ``dst_factors`` and the 1-D
    eigenvalues 2 − 2cos(πk/n), k = 1..n (in units of a·n²), both f32."""
    S, _ = dst_factors(n)
    eig = 2.0 - 2.0 * np.cos(np.pi * np.arange(1, n + 1) / n)
    return (torch.tensor(S, dtype=torch.float32, device=device),
            torch.tensor(eig, dtype=torch.float32, device=device))


def make_dst_preconditioner(a, n: int):
    """The fast-Poisson preconditioner M = A(ā), ā the geometric mean of
    each chain's field: M⁻¹r = Sᵀ[(S r Sᵀ) / λ]S in f32 (not the bf16 flat
    apply of the batched misfits), λ_ij = ā n²(e_i + e_j). ``a`` (..., n,
    n); returns r (..., n, n) ↦ (..., n, n)."""
    S, e = dst_basis(n, a.device)
    a_bar = torch.exp(torch.mean(torch.log(a), dim=(-2, -1)))
    lam = a_bar[..., None, None] * float(n * n) * (e[:, None] + e[None, :])

    def inv_m(r):
        return S.T @ ((S @ r @ S.T) / lam) @ S

    return inv_m


def _solver(a, n, n_iters, precond, solver, omega):
    """b ↦ x ≈ A(a)⁻¹ b on (..., n, n): ``n_iters`` CG iterations (α = 0
    where pAp ≤ 0, β = 0 where rz ≤ 0: a converged solve stays put) or
    fixed-ω preconditioned Richardson, Jacobi or ``dst``."""
    if precond == "dst":
        inv_m = make_dst_preconditioner(a, n)
    elif precond == "jacobi":
        inv_diag = 1.0 / _operator_diagonal(a, n)
        inv_m = lambda r: inv_diag * r  # noqa: E731
    else:
        raise ValueError(f"precond must be 'jacobi' or 'dst', got {precond!r}")
    if solver not in ("cg", "richardson"):
        raise ValueError(f"solver must be 'cg' or 'richardson', got {solver!r}")

    def dots(u, v):
        return torch.sum(u * v, dim=(-2, -1))[..., None, None]

    def richardson(b):
        x = omega * inv_m(b)
        for _ in range(n_iters - 1):
            x = x + omega * inv_m(b - apply_operator(a, x, n))
        return x

    def cg(b):
        x, r = torch.zeros_like(b), b
        z = inv_m(r)
        p, rz = z, dots(r, z)
        zero = torch.zeros_like(rz)
        for _ in range(n_iters):
            Ap = apply_operator(a, p, n)
            denom = dots(p, Ap)
            alpha = torch.where(denom > 0.0, rz / torch.where(denom > 0.0, denom, 1.0), zero)
            x = x + alpha * p
            r = r - alpha * Ap
            z = inv_m(r)
            rz_new = dots(r, z)
            beta = torch.where(rz > 0.0, rz_new / torch.where(rz > 0.0, rz, 1.0), zero)
            p = z + beta * p
            rz = rz_new
        return x

    return richardson if solver == "richardson" else cg


class _ImplicitSolve(torch.autograd.Function):
    """x = solve(b) for A(a) x = b whose backward is the implicit adjoint
    (``lax.custom_linear_solve(symmetric=True)``): λ = solve(x̄) with the
    same solver (A is symmetric), b̄ = λ, ā = −∂_a[λᵀ A(a) x]. The solver's
    own dependence on a (the preconditioner) is not differentiated, as in
    JAX: Richardson's adjoint is Richardson."""

    @staticmethod
    def forward(ctx, a, b, n, make_solve):
        x = make_solve(a)(b)
        ctx.save_for_backward(a, x)
        ctx.n, ctx.make_solve = n, make_solve
        return x

    @staticmethod
    def backward(ctx, x_bar):
        a, x = ctx.saved_tensors
        lam = ctx.make_solve(a)(x_bar)
        with torch.enable_grad():
            a_ = a.detach().requires_grad_()
            (a_bar,) = torch.autograd.grad(apply_operator(a_, x, ctx.n), a_, grad_outputs=-lam)
        return a_bar, lam, None, None


def solve_cg(a, f, n: int, n_iters: int = 48, precond: str = "jacobi",
             solver: str = "cg", omega: float = 1.0):
    """A(a) p = f by ``n_iters`` iterations of preconditioned CG (or
    Richardson), matrix-free, for fields a (..., n, n) and a source f (n²,)
    or (..., n²); returns p (..., n²). Differentiable by the implicit
    adjoint (``_ImplicitSolve``), not through the iterations."""
    b = f.reshape(*f.shape[:-1], n, n).expand(a.shape)

    def make_solve(field):
        return _solver(field, n, n_iters, precond, solver, float(omega))

    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        p = _ImplicitSolve.apply(a, b, n, make_solve)
    else:
        p = make_solve(a)(b)
    return p.reshape(*a.shape[:-2], n * n)


def make_darcy_forward(n_grid: int = 16, n_modes_per_dim: int = 8, alpha: float = 2.0,
                       field_scale: float = 10.0, obs_indices=None, source=None,
                       log_a_mean: float = 0.0, method: str = "cg", cg_iters: int = 48,
                       precond: str = "jacobi", solver: str = "cg", omega: float = 1.0,
                       device="cuda", mesh=None):
    """(forward, aux): forward(u) maps whitened KL coefficients u (..., K)
    to the pressure at the observation cells (..., m), chains on the
    leading dimensions: log a = log_a_mean + u · scaled_basis, then
    ``solve_cg`` (``method="cg"``), a dense Cholesky solve of
    ``assemble_operator`` (``"dense"``), or (``"sharded"``) the Jacobi-PCG
    solve with the grid's rows sharded over the 'model' axis of ``mesh``
    (``parallel.grid_shard.sharded_solve_cg``: one halo exchange and two
    ``all_reduce`` sums an iteration; every rank of the model group calls
    the forward together; no gradient). ``mesh`` None there: the 'model'
    mesh of the whole world (a world of one on ``device`` if none runs);
    ``n_grid`` must divide over its ranks. ``aux`` holds the JAX package's
    keys: scaled_basis (K, n²), eigenvalues (K,), obs_indices (m,), n_grid,
    stencil_indices, source (n²,), tensors on ``device`` (the card unless
    the caller asks for the CPU)."""
    if method not in ("cg", "dense", "sharded"):
        raise ValueError(f"method must be 'cg', 'dense' or 'sharded', got {method!r}")
    device = resolve_device(str(device))
    if method == "sharded":
        if mesh is None:
            mesh = grid_shard.make_model_mesh(device=device)
        if n_grid % mesh.shape[1]:
            raise ValueError(
                f"n_grid {n_grid} must divide over the {mesh.shape[1]}-device 'model' "
                "axis (row-block decomposition)")
    consts = darcy_aux(n_grid, n_modes_per_dim, alpha, field_scale, obs_indices)
    if source is not None:
        consts["source"] = np.asarray(source, np.float32).reshape(-1)
    aux = {
        "scaled_basis": torch.tensor(consts["scaled_basis"], device=device),
        "eigenvalues": torch.tensor(consts["eigenvalues"], dtype=torch.float32, device=device),
        "obs_indices": torch.as_tensor(consts["obs_indices"], dtype=torch.long, device=device),
        "n_grid": n_grid,
        "stencil_indices": _stencil_indices(n_grid),
        "source": torch.tensor(consts["source"], device=device),
    }
    basis, obs, f = aux["scaled_basis"], aux["obs_indices"], aux["source"]

    def forward(u):
        a = torch.exp(log_a_mean + u @ basis).reshape(*u.shape[:-1], n_grid, n_grid)
        if method == "cg":
            p = solve_cg(a, f, n_grid, n_iters=cg_iters, precond=precond, solver=solver,
                         omega=omega)
        elif method == "sharded":
            p = grid_shard.sharded_solve_cg(a, f, n_grid, mesh, n_iters=cg_iters)
        else:
            p = _dense_solve(a, aux)
        return p[..., obs]

    return forward, aux


def _dense_solve(a, aux):
    """A(a)⁻¹ f by Cholesky (``method="dense"``), (..., n²)."""
    A = assemble_operator(a, aux["stencil_indices"], aux["n_grid"])
    L = torch.linalg.cholesky(A)
    f = aux["source"].expand(*a.shape[:-2], -1)
    return torch.cholesky_solve(f[..., None], L)[..., 0]


def solve_pressure(u, aux, log_a_mean: float = 0.0):
    """The whole pressure field (..., n, n) of coefficients u (..., K), by
    the dense Cholesky solve (diagnostics, plots)."""
    n = aux["n_grid"]
    a = torch.exp(log_a_mean + u @ aux["scaled_basis"]).reshape(*u.shape[:-1], n, n)
    return _dense_solve(a, aux).reshape(*u.shape[:-1], n, n)


# --- the POD reduced-order surrogates (make_pod_surrogate{,_online}) ----------
#
# Offline, full solves at prior draws (120 dst-preconditioned CG iterations)
# and the rank-r POD basis V of the pressure snapshots; online, the chain's
# operator projected onto V, (Vᵀ A(a) V) c = Vᵀ f solved by a batched r × r
# Cholesky (a library call, as in the JAX package: no TPU kernel runs it).
# Delayed acceptance removes any surrogate error.


def choose_pod_rank(singular_values, energy_tol: float = 1e-6, min_rank: int = 2,
                    max_rank=None):
    """The smallest r whose discarded squared-singular-value mass is below
    ``energy_tol`` of the total, at least ``min_rank``, at most ``max_rank``
    and the number of values (numpy, offline)."""
    s2 = np.square(np.asarray(singular_values, np.float64))
    if s2.size == 0 or s2.sum() <= 0:
        raise ValueError("singular values must be a nonempty positive set")
    tail = 1.0 - np.cumsum(s2) / s2.sum()
    r = int(np.searchsorted(-tail, -energy_tol) + 1)
    r = max(r, int(min_rank))
    if max_rank is not None:
        r = min(r, int(max_rank))
    return min(r, int(s2.size))


class _Pod:
    """The constants of a POD surrogate on ``aux`` (``make_darcy_forward``'s:
    tensors on one device) and the snapshot-to-basis step."""

    def __init__(self, aux, data, noise_scale, log_a_mean, energy_tol):
        self.basis, self.n = aux["scaled_basis"], int(aux["n_grid"])
        self.f, self.obs = aux["source"], aux["obs_indices"]
        dev = self.basis.device
        self.data = torch.tensor(np.asarray(data, np.float32), device=dev)
        self.noise = torch.tensor(np.asarray(noise_scale, np.float32), device=dev)
        self.log_a_mean, self.energy_tol = log_a_mean, energy_tol

    def field(self, u):
        """(..., K) -> a (..., n, n)."""
        return torch.exp(self.log_a_mean + u @ self.basis).reshape(
            *u.shape[:-1], self.n, self.n)

    def full_solve(self, u):
        """Snapshots (S, n²) of coefficients (S, K)."""
        return solve_cg(self.field(u), self.f, self.n, n_iters=120, precond="dst")

    def pod(self, snapshots, rank):
        """(V (n², r) orthonormal columns, singular values, r)."""
        _, s, vt = torch.linalg.svd(snapshots, full_matrices=False)
        r = (choose_pod_rank(s.cpu().numpy(), self.energy_tol, max_rank=snapshots.shape[0])
             if rank == "auto" else int(rank))
        return vt[:r].T.contiguous(), s, r

    def reduced(self, V, u):
        """(A(a) V (..., n², r), the reduced solution c (..., r)). The
        Galerkin matrix is symmetrised, as ``jnp.linalg.cholesky`` does with
        its input; a factorisation that fails gives NaN, as in JAX."""
        n, r = self.n, V.shape[1]
        a = self.field(u)[..., None, :, :]
        AV = apply_operator(a, V.T.reshape(r, n, n), n).reshape(
            *u.shape[:-1], r, n * n).transpose(-1, -2)
        Ar = V.T @ AV
        L, info = torch.linalg.cholesky_ex(0.5 * (Ar + Ar.transpose(-1, -2)))
        L = torch.where((info == 0)[..., None, None], L, torch.full_like(L, torch.nan))
        rhs = (V.T @ self.f).expand(*u.shape[:-1], r)[..., None]
        return AV, torch.cholesky_solve(rhs, L)[..., 0]

    def misfit(self, V):
        """Φ_r: (..., K) -> (...,), ½‖(y − V_obs c)/σ‖²."""
        obs_V = V[self.obs]

        def phi_r(u):
            _, c = self.reduced(V, u)
            res = (self.data - c @ obs_V.T) / self.noise
            return 0.5 * torch.sum(res * res, dim=-1)

        return phi_r

    def indicator(self, V, u):
        """‖A(a) V c − f‖ / ‖f‖ of the reduced solution: the reduced-basis
        a-posteriori indicator, no full solve."""
        AV, c = self.reduced(V, u)
        r = (AV @ c[..., None])[..., 0] - self.f
        return torch.linalg.vector_norm(r, dim=-1) / torch.linalg.vector_norm(self.f)


def make_pod_surrogate(aux, data, noise_scale, draws, rank=20, log_a_mean: float = 0.0,
                       energy_tol: float = 1e-6, greedy_rounds: int = 0,
                       n_candidates: int = 128, greedy_batch: int = 8, generator=None,
                       prior_scale=None, return_info: bool = False):
    """Data-driven reduced-order misfit (Cui–Marzouk–Willcox 1403.4290):
    snapshots by full solves at the prior draws ``draws`` (S, K), the rank-r
    POD basis (``rank="auto"``: ``choose_pod_rank(energy_tol)``), and Φ_r of
    the Galerkin-projected operator. ``greedy_rounds > 0`` enriches the
    snapshots by the weak-greedy recipe: each round scores ``n_candidates``
    prior draws from ``generator`` (times ``prior_scale``) by the reduced
    residual and full-solves the ``greedy_batch`` worst. ``aux``:
    ``make_darcy_forward``'s. Returns Φ_r: (..., K) -> (...,), or (Φ_r,
    info) with ``return_info`` (rank, snapshot count, singular values, the
    rounds' max / mean indicators)."""
    pod = _Pod(aux, data, noise_scale, log_a_mean, energy_tol)
    dev = pod.basis.device
    snapshots = pod.full_solve(torch.as_tensor(draws, dtype=torch.float32).to(dev))
    scale = (torch.ones(pod.basis.shape[0], device=dev) if prior_scale is None
             else torch.as_tensor(prior_scale, dtype=torch.float32).to(dev))
    history = []
    for _ in range(int(greedy_rounds)):
        V, _, _ = pod.pod(snapshots, rank)
        cands = scale * normals(generator, (n_candidates, pod.basis.shape[0]), dev)
        res = pod.indicator(V, cands)
        history.append({"max": float(res.max()), "mean": float(res.mean())})
        worst = torch.argsort(res)[-int(greedy_batch):]
        snapshots = torch.cat([snapshots, pod.full_solve(cands[worst])], dim=0)
    V, s, r = pod.pod(snapshots, rank)
    phi_r = pod.misfit(V)
    if return_info:
        return phi_r, {"rank": int(r), "n_snapshots": int(snapshots.shape[0]),
                       "singular_values": s.cpu().numpy(), "residual_history": history}
    return phi_r


def make_pod_surrogate_online(aux, data, noise_scale, draws, rank="auto",
                              log_a_mean: float = 0.0, energy_tol: float = 1e-6,
                              enrich_batch: int = 8):
    """A POD surrogate that chain positions can enrich: returns (Φ_r,
    enrich), ``enrich(positions (n, K)) -> (Φ_r', stats)`` scoring the
    positions by the reduced residual, full-solving the ``enrich_batch``
    worst, appending them to the snapshots and rebuilding the basis.
    ``stats``: the indicator's max and mean over the positions before the
    enrichment, and the snapshot count. The runner freezes the surrogate
    before any recorded sample, so delayed acceptance keeps the posterior
    exact."""
    pod = _Pod(aux, data, noise_scale, log_a_mean, energy_tol)
    state = {"snapshots": pod.full_solve(
        torch.as_tensor(draws, dtype=torch.float32).to(pod.basis.device))}

    def build():
        V, _, _ = pod.pod(state["snapshots"], rank)
        state["V"] = V
        return pod.misfit(V)

    def enrich(positions):
        positions = torch.as_tensor(positions).to(pod.basis.device)
        res = pod.indicator(state["V"], positions)
        stats = {"indicator_max": float(res.max()), "indicator_mean": float(res.mean()),
                 "n_snapshots": int(state["snapshots"].shape[0])}
        worst = torch.argsort(res)[-int(enrich_batch):]
        state["snapshots"] = torch.cat(
            [state["snapshots"], pod.full_solve(positions[worst])], dim=0)
        return build(), stats

    return build(), enrich
