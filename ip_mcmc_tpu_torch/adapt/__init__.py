"""Warm-up adaptation of the scan path (mirrors ``ip_mcmc_tpu/adapt``:
``dual_averaging`` and ``warmup_rwm`` / ``warmup_pcn``)."""

from ip_mcmc_tpu_torch.adapt import dual_averaging
from ip_mcmc_tpu_torch.adapt.warmup import warmup_pcn, warmup_rwm

__all__ = ["dual_averaging", "warmup_pcn", "warmup_rwm"]
