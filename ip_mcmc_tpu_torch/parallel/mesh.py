"""The device mesh of the port (mirrors ``ip_mcmc_tpu/parallel/mesh.py``).

JAX runs one SPMD program over N devices in one process; PyTorch's
collectives are per process, so here a mesh is a ``torch.distributed``
world with one process per device: NCCL on ``cuda`` (rank r on
``cuda:<local rank>``), gloo on ``cpu``, never one for the other. A
``Mesh`` has the shape (n_chain_groups, n_model) with axes ``('chains',
'model')``; rank r sits at (r // n_model, r % n_model), JAX's device
order. Its ``'model'`` group holds the ranks of r's row, its ``'chains'``
group those of r's column. A world of one rank is a real world (a process
group of size 1 on a ``TCPStore`` at 127.0.0.1), and its collectives run
as a larger world's do.

Chain state is an (n, ...) batch on every rank (the global view,
computed identically everywhere); ``shard_chains`` keeps a rank's rows,
``gather_chains`` puts the rows of every rank back together.
``sample_chains_sharded`` runs the scan driver on a rank's rows and gives
the single-process run's samples bit for bit: each rank draws the whole
batch's numbers from the shared generator and keeps its rows
(``kernels.base.RowShard``; at these sizes the extra draws cost nothing),
and the cross-chain statistics (the info means) are taken over the
gathered chains, as in one process.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any

import torch
import torch.distributed as dist

CHAIN_AXIS = "chains"
MODEL_AXIS = "model"


def _local_rank(rank: int) -> int:
    return int(os.environ.get("LOCAL_RANK", rank))


def distributed_init(coordinator_address=None, num_processes=None, process_id=None,
                     device="cuda") -> torch.device:
    """Start this process's rank of the world (a no-op if one is running)
    and return the rank's device. The backend follows ``device``: NCCL for
    ``cuda`` (the rank takes ``cuda:<local rank>``, ``LOCAL_RANK`` or the
    rank; more ranks than visible cards raise), gloo for ``cpu``. One
    process with no coordinator is a world of one, on a ``TCPStore`` at
    127.0.0.1; more take ``coordinator_address`` ("host:port", rank 0's),
    ``num_processes`` and ``process_id``."""
    kind = torch.device(device).type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    if dist.is_initialized():
        return mesh_device()
    world = int(num_processes or 1)
    rank = int(process_id or 0)
    if world > 1 and coordinator_address is None:
        raise ValueError(
            f"a world of {world} processes needs coordinator_address (host:port "
            "of process 0)")
    if not 0 <= rank < world:
        raise ValueError(f"process_id {rank} is outside a world of {world}")
    backend = "gloo"
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch.cuda.is_available() is False "
                "(pass device='cpu' for a gloo world)")
        local = _local_rank(rank)
        if local >= torch.cuda.device_count():
            raise ValueError(
                f"rank {rank} (local rank {local}) has no card: "
                f"{torch.cuda.device_count()} visible, and NCCL takes one rank a card")
        torch.cuda.set_device(local)
        backend = "nccl"
    if world == 1 and coordinator_address is None:
        store = dist.TCPStore("127.0.0.1", 0, 1, is_master=True)
        dist.init_process_group(backend, store=store, rank=0, world_size=1)
    else:
        dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                rank=rank, world_size=world)
    return mesh_device()


def mesh_device() -> torch.device:
    """The device of this rank's world: its card under NCCL, else the CPU."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


@dataclasses.dataclass
class Mesh:
    """A ('chains', 'model') grid over the ranks of the world: ``shape``
    (n_chain_groups, n_model), this ``rank``, its ``device``, and the
    process groups of its ``'chains'`` column and ``'model'`` row."""

    shape: tuple
    rank: int
    device: torch.device
    chains_group: Any
    model_group: Any

    @property
    def size(self) -> int:
        return self.shape[0] * self.shape[1]

    @property
    def chains_index(self) -> int:
        return self.rank // self.shape[1]

    @property
    def model_index(self) -> int:
        return self.rank % self.shape[1]

    def model_ranks(self):
        """The world ranks of this rank's 'model' row, in model order."""
        c, m = self.chains_index, self.shape[1]
        return [c * m + j for j in range(m)]

    def chain_rows(self, n: int):
        """(start, stop) of this rank's rows of an n-chain batch sharded
        over 'chains' (replicated over 'model')."""
        groups = self.shape[0]
        if n % groups:
            raise ValueError(f"chain axis {n} must be divisible by the {groups} "
                             "chain groups of the mesh")
        per = n // groups
        return self.chains_index * per, (self.chains_index + 1) * per


_MESHES: dict = {}


def make_mesh(n_chain_groups: int, n_model: int, device=None) -> Mesh:
    """The (n_chain_groups, n_model) mesh of the running world, whose size
    must be their product; with no world running, a world of one rank on
    ``device`` (default: the card) first. Every rank makes the same groups
    in the same order (a collective call); a shape made before is reused."""
    if not dist.is_initialized():
        distributed_init(device="cuda" if device is None else device)
    world, rank = dist.get_world_size(), dist.get_rank()
    c, m = int(n_chain_groups), int(n_model)
    if c < 1 or m < 1 or c * m != world:
        raise ValueError(
            f"a ({c}, {m}) mesh needs {c * m} ranks; the world has {world} (one "
            f"process a device: launch {c * m} processes, e.g. `python -m "
            f"ip_mcmc_tpu_torch.run --num-processes {c * m} --process-id i "
            "--coordinator host:port`)")
    key = (c, m, id(dist.group.WORLD))
    if key not in _MESHES:
        model_groups = [dist.new_group([i * m + j for j in range(m)]) for i in range(c)]
        chain_groups = [dist.new_group([i * m + j for i in range(c)]) for j in range(m)]
        _MESHES[key] = Mesh(shape=(c, m), rank=rank, device=mesh_device(),
                            chains_group=chain_groups[rank % m],
                            model_group=model_groups[rank // m])
    return _MESHES[key]


def shutdown():
    """End this process's rank of the world (if one runs) and forget its
    meshes."""
    _MESHES.clear()
    if dist.is_initialized():
        dist.destroy_process_group()


def check_world_size(n_devices) -> None:
    """``n_devices`` (None: any) must be the running world's size: one
    process drives one device, so N devices are N processes
    (``--num-processes``); the port spawns no workers."""
    world = dist.get_world_size()
    if n_devices is not None and int(n_devices) != world:
        raise ValueError(
            f"--devices {n_devices} in a world of {world} process(es): the port runs "
            f"one process a device, so launch {n_devices} processes with "
            f"--num-processes {n_devices} --process-id i --coordinator host:port")


def make_chain_mesh(n_devices=None, device=None) -> Mesh:
    """The 1-D chain mesh (world, 1); ``n_devices`` other than the world's
    size raises (``check_world_size``)."""
    if not dist.is_initialized():
        distributed_init(device="cuda" if device is None else device)
    check_world_size(n_devices)
    return make_mesh(dist.get_world_size(), 1)


def _map(tree, fn):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: _map(getattr(tree, f.name), fn) for f in dataclasses.fields(tree)})
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(x, fn) for x in tree)
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return tree


def shard_chains(tree, mesh: Mesh):
    """This rank's rows of every tensor of a chain-batched tree (a tensor,
    a state dataclass, a tuple, list or dict), on the mesh's device."""
    def cut(x):
        lo, hi = mesh.chain_rows(x.shape[0])
        return x[lo:hi].to(mesh.device)

    return _map(tree, cut)


def gather_chains(tree, mesh: Mesh, axis: int = 0):
    """Every rank's rows put back in rank order along ``axis`` (an
    ``all_gather`` over 'chains'); the inverse of ``shard_chains``."""
    def gather(x):
        flag = x.dtype == torch.bool  # gloo gathers no bool: as bytes
        x = (x.to(torch.uint8) if flag else x).contiguous()
        parts = [torch.empty_like(x) for _ in range(mesh.shape[0])]
        dist.all_gather(parts, x, group=mesh.chains_group)
        out = torch.cat(parts, dim=axis)
        return out.to(torch.bool) if flag else out

    return _map(tree, gather)


def replicate(tree, mesh: Mesh):
    """Every tensor of the tree on the mesh's device, rank 0's values on
    every rank (a broadcast over the world)."""
    def bcast(x):
        x = x.to(mesh.device).contiguous()
        dist.broadcast(x, src=0)
        return x

    return _map(tree, bcast)


def sample_chains_sharded(kernel, state, generator, mesh: Mesh, **kwargs):
    """``driver.sample_chains`` with the chains sharded over the mesh's
    'chains' axis: ``state`` is the whole (n, ...) batch, the same on every
    rank; a rank steps its rows, drawing from ``generator`` through a
    ``RowShard``. Returns what the single-process run returns, bit for bit:
    the final state and the samples of all chains (gathered), and the info
    means over all chains."""
    from ip_mcmc_tpu_torch import driver
    from ip_mcmc_tpu_torch.kernels.base import RowShard

    n = state.position.shape[0]
    lo, hi = mesh.chain_rows(n)
    local = shard_chains(state, mesh)
    final, samples, rows = driver.sample_chains(
        kernel, local, RowShard(generator, n, lo, hi),
        info_fn=lambda info: {f.name: getattr(info, f.name)
                              for f in dataclasses.fields(info)},
        **kwargs)
    full = {k: gather_chains(v, mesh, axis=1) for k, v in vars(rows).items()}
    # each retained step's chain mean over the gathered chains, as the
    # single-process driver takes it
    means = type(rows)(**{k: torch.stack([torch.mean(v[s].to(torch.float32), dim=0)
                                          for s in range(v.shape[0])])
                          for k, v in full.items()})
    return gather_chains(final, mesh), gather_chains(samples, mesh, axis=1), means
