"""Priors (mirrors ``ip_mcmc_tpu.distributions``; only ``DiagGaussian``)."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class DiagGaussian:
    """N(mean, diag(scale**2)) — the whitened KL-coefficient prior."""

    mean: torch.Tensor  # (d,)
    scale: torch.Tensor  # (d,) standard deviations

    @property
    def dim(self) -> int:
        return self.mean.shape[-1]

    def sample(self, generator: torch.Generator, n: int) -> torch.Tensor:
        """(n, d) draws. The normals come from ``generator`` on its own
        device and are then moved to the prior's device, so a seed gives
        the same draws whichever device the prior lives on."""
        z = torch.randn(
            (n, self.dim), generator=generator, dtype=torch.float32,
            device=generator.device,
        )
        return self.mean + self.scale * z.to(self.mean.device)
