"""The fused samplers of the port, under the names of ``ip_mcmc_tpu.ops``."""

from ip_mcmc_tpu_torch.ops.fused_da3_pcn import (
    fused_da3_pcn_chain,
    fused_da3_pcn_chain_recorded,
)
from ip_mcmc_tpu_torch.ops.fused_da_pcn import (
    fused_da_pcn_chain,
    fused_da_pcn_chain_recorded,
)
from ip_mcmc_tpu_torch.ops.fused_ess import (
    fused_ess_chain,
    fused_ess_chain_recorded,
)
from ip_mcmc_tpu_torch.ops.fused_fes import (
    fused_fes_chain,
    fused_fes_chain_recorded,
)
from ip_mcmc_tpu_torch.ops.fused_mala import (
    fused_mala_chain,
    fused_mala_chain_recorded,
    fused_mala_chain_warm,
    fused_mala_chain_warm_recorded,
)
from ip_mcmc_tpu_torch.ops.fused_pcn import (
    fused_pcn_chain,
    fused_pcn_chain_recorded,
    fused_pcn_chain_warm,
    fused_pcn_chain_warm_recorded,
)
from ip_mcmc_tpu_torch.ops.fused_pcn_adapt import fused_pcn_chain_adapt
from ip_mcmc_tpu_torch.ops.fused_pcn_dense import (
    fused_pcn_chain_dense,
    fused_pcn_chain_dense_recorded,
)
from ip_mcmc_tpu_torch.ops.fused_rwm import (
    fused_rwm_chain,
    fused_rwm_chain_recorded,
)

__all__ = [
    "fused_da3_pcn_chain",
    "fused_da3_pcn_chain_recorded",
    "fused_da_pcn_chain",
    "fused_da_pcn_chain_recorded",
    "fused_ess_chain",
    "fused_ess_chain_recorded",
    "fused_fes_chain",
    "fused_fes_chain_recorded",
    "fused_mala_chain",
    "fused_mala_chain_recorded",
    "fused_mala_chain_warm",
    "fused_mala_chain_warm_recorded",
    "fused_pcn_chain",
    "fused_pcn_chain_adapt",
    "fused_pcn_chain_dense",
    "fused_pcn_chain_dense_recorded",
    "fused_pcn_chain_recorded",
    "fused_pcn_chain_warm",
    "fused_pcn_chain_warm_recorded",
    "fused_rwm_chain",
    "fused_rwm_chain_recorded",
]
