"""The port's multi-device layer (ip_mcmc_tpu_torch/parallel: mesh,
resample, fused_shard, dryrun) and the CLI's multi-process launch, on gloo
worlds of 2 and 4 ranks spawned on the CPU (tests/torch_parallel_worker.py
runs every case in one world of each size; the two worlds and the CLI's
processes start together).

Tolerances: none. A sharded run must give the single-process run's bits:
- the scan path (pCN, RWM, delayed acceptance, elliptical slice sampling
  on the linear-Gaussian and 2-D Gaussian configs): each rank draws the
  whole batch's numbers and keeps its rows, and the info means are taken
  over the gathered chains, so samples, final state and info means equal
  ``driver.sample_chains`` on the whole batch exactly;
- ``distributed_systematic_resample`` equals ``smc.systematic_resample``
  on every mesh shape (the same ancestry from the same weights);
- ``sharded_fused_chain``: rank r's rows equal an unsharded launch of them
  with seed + r·1,000,003 (the plain versions here; the same counter-hash
  draws);
- the CLI as two processes (``lingauss_pcn``, ``--num-processes 2``)
  prints one JSON line, process 0's, whose statistics equal the
  single-process run's exactly; only timings differ.
"""

import json
import subprocess
import sys

import pytest
import torch

from torch_world import ROOT, env, free_port, run_worlds

WORKER = ROOT / "tests" / "torch_parallel_worker.py"
CLI = ["-m", "ip_mcmc_tpu_torch.run", "--config", "lingauss_pcn", "--device", "cpu",
       "--n-chains", "64", "--n-samples", "40"]
# metrics that are timings (or, for the multi-process run, its world)
TIMINGS = {"first_dispatch_s", "run_s", "sampling_steps_per_s", "steps_per_s", "ess_per_s",
           "total_wall_s", "unattributed_s", "ess_per_total_wall_s", "setup_s", "cli_total_s"}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel")
    port = free_port()
    cli = [subprocess.Popen([sys.executable, *CLI, "--num-processes", "2", "--process-id", str(r),
                             "--coordinator", f"127.0.0.1:{port}"], env=env(), cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
           for r in range(2)]
    single = subprocess.Popen([sys.executable, *CLI], env=env(), cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    results = run_worlds(WORKER, (2, 4), tmp)
    outs = []
    for p in cli + [single]:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-3000:]
        outs.append(out)
    results["cli"] = outs
    return results


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("kernel", ["pcn", "rwm", "da_pcn", "elliptical"])
def test_sharded_scan_equals_single_process_bitwise(worlds, world, kernel):
    assert all(r["scan"][kernel] for r in worlds[world])


@pytest.mark.parametrize("world", [2, 4])
def test_distributed_resample_equals_serial_on_every_shape(worlds, world):
    for r in worlds[world]:
        assert len(r["resample"]["by_shape"]) == (2 if world == 2 else 3)
        for shape, got in r["resample"]["by_shape"].items():
            assert torch.equal(got, r["resample"]["serial"]), shape
        assert r["resample"]["unequal_shards_refused"]


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case", ["rwm", "da_recorded", "rwm_composed", "block_refused"])
def test_sharded_fused_chain_is_each_ranks_seeded_run(worlds, world, case):
    assert all(r["fused"][case] for r in worlds[world])


@pytest.mark.parametrize("world", [2, 4])
def test_mesh_refuses_what_the_world_cannot_hold(worlds, world):
    for r in worlds[world]:
        assert r["refusals"] == {"devices": True, "shape": True, "chees": True, "pt": True}


@pytest.mark.parametrize("world", [2, 4])
def test_dryrun_multichip(worlds, world):
    stats = [r["dryrun"] for r in worlds[world]]
    assert all(s == stats[0] for s in stats)  # the pooled statistics on every rank
    assert 0.0 <= stats[0]["pooled_accept"] <= 1.0 and 0.0 < stats[0]["fused_accept"] <= 1.0
    assert len(stats[0]["pooled_mean"]) == 16 and min(stats[0]["pooled_var"]) >= 0.0


def test_cli_two_processes_prints_one_line_with_the_single_process_statistics(worlds):
    rank0, rank1, single = worlds["cli"]
    assert rank1.strip() == ""
    lines = [ln for ln in rank0.splitlines() if ln.strip()]
    assert len(lines) == 1
    got, want = json.loads(lines[0]), json.loads(single)
    assert (got["process_count"], got["process_id"], got["global_devices"]) == (2, 0, 2)
    assert set(got) - set(want) == {"process_count", "process_id", "global_devices"}
    for k in set(want) - TIMINGS:
        assert got[k] == want[k], k
