"""The multi-device layer of the port (mirrors ``ip_mcmc_tpu/parallel``):
one process a device, a ``torch.distributed`` world as the mesh (NCCL on
the card, gloo on the CPU)."""

from ip_mcmc_tpu_torch.parallel.fused_shard import (sharded_fused_chain,
                                                    sharded_fused_chain_composed)
from ip_mcmc_tpu_torch.parallel.mesh import (
    CHAIN_AXIS,
    MODEL_AXIS,
    Mesh,
    check_world_size,
    distributed_init,
    gather_chains,
    make_chain_mesh,
    make_mesh,
    mesh_device,
    replicate,
    sample_chains_sharded,
    shard_chains,
    shutdown,
)

__all__ = [
    "CHAIN_AXIS",
    "MODEL_AXIS",
    "Mesh",
    "check_world_size",
    "distributed_init",
    "gather_chains",
    "make_chain_mesh",
    "make_mesh",
    "mesh_device",
    "shard_chains",
    "replicate",
    "sample_chains_sharded",
    "sharded_fused_chain",
    "sharded_fused_chain_composed",
    "shutdown",
]
