"""Priors and noise models (mirrors ``ip_mcmc_tpu.distributions``:
``DiagGaussian``, ``Gaussian``, ``LogNormal``, ``IndependentProduct`` and
``gaussian_kl_prior``).

Draws come from an explicit ``torch.Generator``; batches of chains are a
leading dimension written out (the JAX package ``vmap``s single draws).
"""

from __future__ import annotations

import dataclasses
import math

import torch

_LOG_2PI = math.log(2.0 * math.pi)


def _normals(generator: torch.Generator, n: int, d: int, device):
    """(n, d) standard normals from ``generator`` on its own device, moved to
    ``device``: a seed gives the same draws whichever device the
    distribution lives on."""
    z = torch.randn((n, d), generator=generator, dtype=torch.float32,
                    device=generator.device)
    return z.to(device)


@dataclasses.dataclass
class DiagGaussian:
    """N(mean, diag(scale**2)) — the whitened KL-coefficient prior."""

    mean: torch.Tensor  # (d,)
    scale: torch.Tensor  # (d,) standard deviations

    @property
    def dim(self) -> int:
        return self.mean.shape[-1]

    def sample(self, generator: torch.Generator, n: int) -> torch.Tensor:
        """(n, d) draws."""
        return self.mean + self.sample_centered(generator, n)

    def sample_centered(self, generator: torch.Generator, n: int) -> torch.Tensor:
        """(n, d) draws of ξ ~ N(0, C): the pCN proposal noise."""
        return self.scale_apply(_normals(generator, n, self.dim, self.mean.device))

    def scale_apply(self, z):
        """C^{1/2} z."""
        return self.scale * z

    def whiten(self, x):
        """C^{-1/2} (x − mean)."""
        return (x - self.mean) / self.scale

    def log_prob(self, x):
        z = (x - self.mean) / self.scale
        return (-0.5 * torch.sum(z * z, dim=-1) - torch.sum(torch.log(self.scale), dim=-1)
                - 0.5 * self.dim * _LOG_2PI)

    def potential(self, x):
        """Negative log-density up to a constant: ½‖C^{-1/2}(x − m)‖²."""
        z = (x - self.mean) / self.scale
        return 0.5 * torch.sum(z * z, dim=-1)


@dataclasses.dataclass
class Gaussian:
    """N(mean, cov) with a dense covariance, stored as its lower Cholesky
    factor ``chol`` (cov = chol cholᵀ)."""

    mean: torch.Tensor  # (d,)
    chol: torch.Tensor  # (d, d) lower triangular

    @classmethod
    def from_covariance(cls, mean, cov):
        mean = torch.as_tensor(mean, dtype=torch.float32)
        cov = torch.as_tensor(cov, dtype=torch.float32).to(mean.device)
        return cls(mean=mean, chol=torch.linalg.cholesky(cov))

    @property
    def dim(self) -> int:
        return self.mean.shape[-1]

    @property
    def covariance(self):
        return self.chol @ self.chol.T

    def sample(self, generator: torch.Generator, n: int) -> torch.Tensor:
        return self.mean + self.sample_centered(generator, n)

    def sample_centered(self, generator: torch.Generator, n: int) -> torch.Tensor:
        return self.scale_apply(_normals(generator, n, self.dim, self.mean.device))

    def scale_apply(self, z):
        return z @ self.chol.T

    def whiten(self, x):
        """L⁻¹ (x − mean) by a triangular solve; ``x`` may have leading
        dimensions."""
        d = (x - self.mean)[..., None]
        return torch.linalg.solve_triangular(self.chol, d, upper=False)[..., 0]

    def log_prob(self, x):
        w = self.whiten(x)
        logdet = torch.sum(torch.log(torch.diagonal(self.chol)))
        return -0.5 * torch.sum(w * w, dim=-1) - logdet - 0.5 * self.dim * _LOG_2PI

    def potential(self, x):
        w = self.whiten(x)
        return 0.5 * torch.sum(w * w, dim=-1)


@dataclasses.dataclass
class LogNormal:
    """Componentwise log-normal: log x ~ N(mu, diag(sigma²)) (the
    reference's ``LogNormalDistribution``: positive parameters)."""

    mu: torch.Tensor  # (d,)
    sigma: torch.Tensor  # (d,)

    @property
    def dim(self) -> int:
        return self.mu.shape[-1]

    def sample(self, generator: torch.Generator, n: int) -> torch.Tensor:
        """(n, d) draws."""
        return torch.exp(self.mu + self.sigma * _normals(generator, n, self.dim,
                                                         self.mu.device))

    def log_prob(self, x):
        logx = torch.log(x)
        z = (logx - self.mu) / self.sigma
        return torch.sum(-0.5 * z * z - logx - torch.log(self.sigma) - 0.5 * _LOG_2PI,
                         dim=-1)

    def potential(self, x):
        return -self.log_prob(x)


@dataclasses.dataclass
class IndependentProduct:
    """Independent blocks over consecutive coordinate slices (the
    reference's ``IndependentDistributions``): ``dists`` the blocks,
    ``dims`` their dimensions."""

    dists: tuple
    dims: tuple

    @classmethod
    def of(cls, *dists):
        return cls(dists=tuple(dists), dims=tuple(int(d.dim) for d in dists))

    @property
    def dim(self) -> int:
        return sum(self.dims)

    def _split(self, x):
        return torch.split(x, list(self.dims), dim=-1)

    def sample(self, generator: torch.Generator, n: int) -> torch.Tensor:
        """(n, d) draws, block after block from ``generator``."""
        return torch.cat([d.sample(generator, n) for d in self.dists], dim=-1)

    def log_prob(self, x):
        return sum(d.log_prob(p) for d, p in zip(self.dists, self._split(x)))

    def potential(self, x):
        return -self.log_prob(x)


def gaussian_kl_prior(eigenvalues, mean=None, device="cpu") -> DiagGaussian:
    """KL-truncated GP prior in KL coordinates: N(mean, diag(eigenvalues)),
    in f32 as the JAX package builds it."""
    lam = torch.as_tensor(eigenvalues, dtype=torch.float32, device=device)
    mean = torch.zeros_like(lam) if mean is None else torch.as_tensor(
        mean, dtype=torch.float32, device=device)
    return DiagGaussian(mean=mean, scale=torch.sqrt(lam))
