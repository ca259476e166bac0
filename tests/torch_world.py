"""Spawned gloo worlds for the port's multi-rank CPU tests.

``run_worlds`` starts, all at once, one process per rank of each world
asked for (``python <worker> <rank> <world> <store> <out>``, torch pinned to
one thread, the repo root on the path) and returns, for each world, the
list of what each rank saved with ``save_result``. A rank that fails fails
the call with its standard error. Workers import torch and the port, never
JAX.
"""

from __future__ import annotations

import os
import pathlib
import socket
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent


def env():
    e = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    e.setdefault("GLOO_SOCKET_IFNAME", "lo")
    return e


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_worlds(worker, worlds, tmp_path, timeout=300):
    """{world size: [rank 0's result, ...]} for each size in ``worlds``."""
    procs = {}
    for w in worlds:
        out = pathlib.Path(tmp_path) / f"world{w}"
        out.mkdir(parents=True, exist_ok=True)
        store = out / "store"
        procs[w] = [subprocess.Popen(
            [sys.executable, str(worker), str(r), str(w), str(store), str(out)],
            env=env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(w)]
    failures = []
    for w, ps in procs.items():
        for r, p in enumerate(ps):
            try:
                _, err = p.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                p.kill()
                _, err = p.communicate()
                failures.append(f"world {w} rank {r}: timed out\n{err[-3000:]}")
                continue
            if p.returncode:
                failures.append(f"world {w} rank {r}: exit {p.returncode}\n{err[-3000:]}")
    if failures:
        raise AssertionError("\n".join(failures))
    return {w: [torch.load(pathlib.Path(tmp_path) / f"world{w}" / f"rank{r}.pt")
                for r in range(w)] for w in worlds}


def init(argv):
    """In a worker: (rank, world, out dir) after joining the gloo world."""
    import torch.distributed as dist

    rank, world, store, out = int(argv[1]), int(argv[2]), argv[3], argv[4]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world)
    return rank, world, pathlib.Path(out)


def save_result(out, rank, result):
    torch.save(result, pathlib.Path(out) / f"rank{rank}.pt")
