"""Named configurations of the port (mirrors ``ip_mcmc_tpu/configs``).

Only the main path is ported so far: ``darcy_da_fused``. The deterministic
constants (KL basis, observation cells, source, preconditioner modes) are
computed here in numpy; the arrays the JAX config draws with JAX keys are
read from the committed fixture ``darcy16_da.npz`` (written by
``scripts/freeze_torch_fixtures.py``).
"""

from __future__ import annotations

import dataclasses
import pathlib
from typing import Callable, Optional

import numpy as np
import torch

from ip_mcmc_tpu_torch import distributions as dist
from ip_mcmc_tpu_torch.convert import darcy_misfit_from_arrays
from ip_mcmc_tpu_torch.models import darcy

FIXTURE = pathlib.Path(__file__).resolve().parent / "darcy16_da.npz"


@dataclasses.dataclass
class Problem:
    name: str
    dim: int
    prior: dist.DiagGaussian
    kernel: str
    kernel_params: dict
    n_chains: int
    n_samples: int
    burn_in: int
    thin: int = 1
    data: Optional[np.ndarray] = None
    truth: Optional[np.ndarray] = None
    notes: str = ""
    batched_potential_fn: Optional[Callable] = None  # (d, B) -> (B,)
    batched_surrogate_fn: Optional[Callable] = None  # fused da_pcn Φ*

    def init_positions(self, generator: torch.Generator, n=None):
        """(n, d) prior draws from ``generator`` (host-side, so a seed gives
        the same start on every device; they differ from the JAX package's
        threefry draws by construction)."""
        return self.prior.sample(generator, n or self.n_chains)


REGISTRY: dict = {}


def register(fn):
    REGISTRY[fn.__name__] = fn
    return fn


def build(name: str, device) -> Problem:
    """Build a named Problem with its tensors on ``device``."""
    if name not in REGISTRY:
        raise KeyError(f"unknown config '{name}'; have {sorted(REGISTRY)}")
    return REGISTRY[name](torch.device(device))


@register
def darcy_da_fused(device) -> Problem:
    """Fused 2-level delayed-acceptance pCN on the 16×16 Darcy problem:
    48-step subchain on a calibrated 8×8-grid surrogate (3 CG iterations,
    dst_trunc over all 64 modes), one exact correction per outer step
    (12 CG iterations, dst_trunc with 128 modes)."""
    fx = np.load(FIXTURE)
    K = 64
    prior = dist.DiagGaussian(
        mean=torch.zeros(K, device=device), scale=torch.ones(K, device=device)
    )
    aux16 = darcy.darcy_aux(n_grid=16, n_modes_per_dim=8, alpha=2.0,
                            field_scale=10.0)
    aux8 = darcy.darcy_aux(n_grid=8, n_modes_per_dim=8, alpha=2.0,
                           field_scale=10.0, obs_indices=fx["obs_coarse"])
    exact = darcy_misfit_from_arrays(aux16, fx["y"], 0.002, cg_iters=12,
                                     precond="dst_trunc", precond_modes=128)
    surrogate = darcy_misfit_from_arrays(aux8, fx["y_surr"], fx["surr_scale"],
                                         cg_iters=3, precond="dst_trunc",
                                         precond_modes=64)
    return Problem(
        name="darcy_da_fused",
        dim=K,
        prior=prior,
        kernel="da_pcn",
        kernel_params={"beta": 0.35, "subchain_len": 48, "fused": True},
        n_chains=4096,
        n_samples=400,
        burn_in=40,  # outer steps (each = 48 inner surrogate steps)
        thin=4,
        data=fx["y"],
        truth=fx["u_true"],
        notes="8x8 calibrated surrogate subchain + exact correction; "
        "exact posterior",
        batched_potential_fn=exact.to(device),
        batched_surrogate_fn=surrogate.to(device),
    )
