"""Karhunen–Loève pieces of the priors (mirrors ``ip_mcmc_tpu/models/kl.py``:
``sine_basis_2d`` and ``laplacian_eigenvalues_2d`` for Darcy,
``fourier_basis`` for Burgers, ``laplacian_eigenvalues`` for the
linear-Gaussian problem). Pure numpy: these are build-time constants."""

from __future__ import annotations

import numpy as np


def fourier_basis(n_modes: int, grid: np.ndarray) -> np.ndarray:
    """Orthonormal periodic basis (n_modes, len(grid)): 1, √2 cos(2πx),
    √2 sin(2πx), √2 cos(4πx), ... ."""
    rows = [np.ones_like(grid)]
    j = 1
    while len(rows) < n_modes:
        rows.append(np.sqrt(2.0) * np.cos(2.0 * np.pi * j * grid))
        if len(rows) < n_modes:
            rows.append(np.sqrt(2.0) * np.sin(2.0 * np.pi * j * grid))
        j += 1
    return np.stack(rows[:n_modes])


def laplacian_eigenvalues(n_modes: int, alpha: float = 2.0, scale: float = 1.0):
    """λ_k = scale · (πk)^(−2α), k = 1..n: the KL spectrum of
    C = scale·(−Δ)^(−α)."""
    k = np.arange(1, n_modes + 1)
    return scale * (np.pi * k) ** (-2.0 * alpha)


def sine_basis_2d(n_modes_per_dim: int, n_grid: int):
    """(basis (K, n_grid²), eigen_index (K, 2)) with K = n_modes_per_dim²;
    rows φ_ij(x, y) = 2 sin(iπx) sin(jπy) at the cell centres."""
    centers = (np.arange(n_grid) + 0.5) / n_grid
    b1 = np.sqrt(2.0) * np.sin(
        np.pi * np.arange(1, n_modes_per_dim + 1)[:, None] * centers[None, :]
    )
    basis = np.einsum("ix,jy->ijxy", b1, b1).reshape(
        n_modes_per_dim * n_modes_per_dim, n_grid * n_grid
    )
    ij = np.stack(
        np.meshgrid(
            np.arange(1, n_modes_per_dim + 1),
            np.arange(1, n_modes_per_dim + 1),
            indexing="ij",
        ),
        axis=-1,
    ).reshape(-1, 2)
    return basis, ij


def laplacian_eigenvalues_2d(eigen_index, alpha: float = 2.0,
                             scale: float = 1.0):
    """λ_ij = scale · (π²(i² + j²))^(−α)."""
    k2 = np.pi**2 * (eigen_index[:, 0] ** 2 + eigen_index[:, 1] ** 2)
    return scale * k2 ** (-alpha)
