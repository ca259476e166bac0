"""Warm-up adaptation of the scan path (mirrors ``ip_mcmc_tpu/adapt``:
``dual_averaging``, ``warmup_rwm`` / ``warmup_pcn`` / ``warmup_mala`` /
``warmup_hmc`` / ``warmup_nuts`` and ``map_localize``; ChEES's warm-up is
``kernels.chees_hmc.warmup_chees``, as in JAX)."""

from ip_mcmc_tpu_torch.adapt import dual_averaging
from ip_mcmc_tpu_torch.adapt.warmup import (
    map_localize,
    warmup_hmc,
    warmup_mala,
    warmup_nuts,
    warmup_pcn,
    warmup_rwm,
)

__all__ = ["dual_averaging", "map_localize", "warmup_hmc", "warmup_mala",
           "warmup_nuts", "warmup_pcn", "warmup_rwm"]
