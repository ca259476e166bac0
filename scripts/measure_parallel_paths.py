"""Where the time goes on the multi-device paths of the port, on one NVIDIA
GPU in a world of one NCCL rank.

    python scripts/measure_parallel_paths.py [--composed-samples N] [--composed-burn-in N]
        [--ess-samples N] [--ess-burn-in N]

- ``darcy_da_fused`` through the runner without a mesh and with the chain
  mesh (``parallel.sharded_fused_chain``), in turns (plain, sharded,
  sharded, plain): each run's ``run_s`` and whether the statistics agree
  digit for digit; the recorded DA launch at 4096 chains sharded against
  unsharded, bit for bit; the sharded run once more under
  ``torch.profiler`` (the device's idle share).
- the host time of one ``all_reduce`` of a (512,) f32 vector in the
  world of one (CUDA events around 200 calls, and the host clock), the
  collective every CG iteration of a composed solve makes twice.
- ``darcy_composed_pcn`` / ``_mala`` / ``_ess`` at their 512 chains, the
  burn-in and samples cut as given (defaults 10 and 10; ESS 1 and 4),
  through the runner: ``run_s``, ``steps_per_s``; then one transition of
  each alone: its host time, the aten operations and ``all_reduce`` calls
  it dispatches, and under ``torch.profiler`` the device's busy time and
  idle share (a whole run under the profiler takes minutes a step).

Prints the card's name and power limit and one JSON line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys
import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402
from measure_linear_paths import profiled, summary  # noqa: E402

STATS = ("min_ess", "max_rhat", "accept_rate", "inner_accept_rate", "posterior_mean")


class _OpCount(TorchDispatchMode):
    """Counts the aten operations dispatched (each a kernel launch or a
    copy on the card, but for views)."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def one_transition(p, kind):
    """One transition of the composed sampler ``kind`` at the config's 512
    chains on the (1, 1) mesh, from the stream of seed 2: its host time
    (three, after one to warm up), the aten operations and the
    ``all_reduce`` calls it dispatches, and, profiled alone, the device's
    busy time and idle share."""
    import torch.distributed as dist

    from ip_mcmc_tpu_torch.parallel import composed

    kp = p.kernel_params
    mesh = composed.make_composed_mesh(1, 1)
    blk = composed._Block(kp["aux"], p.data, kp["noise_scale"], mesh, p.n_chains,
                          kp["cg_iters"], 0.0)
    u = p.init_positions(torch.Generator().manual_seed(0), p.n_chains).to(mesh.device)
    if kind == "mala":
        phi, g = blk.value_and_grad(u)
        step = lambda: composed.mala_transition(  # noqa: E731
            blk.value_and_grad, u, phi, g, blk.normals(2, 0),
            torch.log(blk.uniforms(2, 0, 2)), kp["step_size"])
    elif kind == "ess":
        phi = blk.misfit(u)
        step = lambda: composed.ess_transition(  # noqa: E731
            blk.misfit, u, phi, blk.normals(2, 0), torch.log(blk.uniforms(2, 0, 2)),
            blk.uniforms(2, 0, 3) * (2.0 * 3.141592653589793),
            lambda i: blk.uniforms(2, 0, 8 + i), kp["max_shrink"])
    else:
        phi = blk.misfit(u)
        step = lambda: composed.pcn_transition(  # noqa: E731
            blk.misfit, u, phi, blk.normals(2, 0), torch.log(blk.uniforms(2, 0, 2)), kp["beta"])
    step()
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    calls = {"all_reduce": 0}
    real = dist.all_reduce

    def counted(*a, **k):
        calls["all_reduce"] += 1
        return real(*a, **k)

    dist.all_reduce = counted
    try:
        with _OpCount() as ops:
            step()
    finally:
        dist.all_reduce = real
    torch.cuda.synchronize()
    wall, busy, _ = profiled(step)
    return {"transition_ms": [1e3 * t for t in times], "aten_ops": ops.n,
            "all_reduce_calls": calls["all_reduce"], "profiled_wall_s": wall,
            "device_busy_s": busy, "device_idle_share": 1 - busy / wall}


def main() -> int:
    if not torch.cuda.is_available():
        print("measure_parallel_paths: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--composed-samples", type=int, default=10)
    ap.add_argument("--composed-burn-in", type=int, default=10)
    ap.add_argument("--ess-samples", type=int, default=4)
    ap.add_argument("--ess-burn-in", type=int, default=1)
    args = ap.parse_args()
    card = chip_smoke.card_line()
    print(f"card: {card}", flush=True)
    import torch.distributed as dist

    from ip_mcmc_tpu_torch import configs, ops, parallel, runner

    parallel.distributed_init(device="cuda")
    assert dist.get_backend() == "nccl", dist.get_backend()
    mesh = parallel.make_chain_mesh()
    out = {"card": card, "backend": dist.get_backend(), "world": dist.get_world_size()}

    p = configs.build("darcy_da_fused", "cuda")
    runs = {}
    for tag in ("plain", "sharded", "sharded", "plain"):
        m = runner.run_problem(p, "cuda", seed=0, mesh=mesh if tag == "sharded" else None)
        runs.setdefault(tag, []).append(m)
    ref = runs["plain"][0]
    out["darcy_da_fused"] = {
        "run_s_in_turns": [runs[t][i]["run_s"] for t, i in
                           (("plain", 0), ("sharded", 0), ("sharded", 1), ("plain", 1))],
        "statistics_equal": all(m[k] == ref[k] for ms in runs.values() for m in ms
                                for k in STATS if k in ref),
        "outer_steps_per_s_sharded": [m["outer_steps_per_s"] for m in runs["sharded"]],
    }
    # the recorded launch itself, sharded against unsharded, bit for bit
    kp = p.kernel_params
    pos = p.init_positions(torch.Generator().manual_seed(3), p.n_chains).cuda()
    kw = dict(prior_mean=p.prior.mean, prior_scale=p.prior.scale, beta=kp["beta"],
              subchain_len=kp["subchain_len"], block_chains=kp.get("block_chains", 512), n_steps=40,
              thin=4)
    direct = ops.fused_da_pcn_chain_recorded(p.batched_potential_fn, p.batched_surrogate_fn,
                                              pos, seed=2, **kw)
    sharded = parallel.sharded_fused_chain(
        lambda phi, x, **k: ops.fused_da_pcn_chain_recorded(phi, p.batched_surrogate_fn, x, **k),
        mesh, p.batched_potential_fn, pos, seed=2, **kw)
    out["darcy_da_fused"]["recorded_launch_bitwise"] = all(
        torch.equal(a, b) for a, b in zip(direct, sharded))
    row = summary(*profiled(lambda: runner.run_problem(p, "cuda", seed=0, mesh=mesh)))
    out["darcy_da_fused"]["profiled_sharded"] = row
    print("darcy_da_fused: " + json.dumps(out["darcy_da_fused"]), flush=True)

    x = torch.ones(512, device="cuda")
    for _ in range(10):
        dist.all_reduce(x)
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(200):
        dist.all_reduce(x)
    stop.record()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    out["all_reduce_512"] = {"host_us_per_call": 1e6 * host_s / 200,
                             "events_us_per_call": 1e3 * start.elapsed_time(stop) / 200}
    print("all_reduce (512,): " + json.dumps(out["all_reduce_512"]), flush=True)

    for name in ("darcy_composed_pcn", "darcy_composed_mala", "darcy_composed_ess"):
        ess = name.endswith("ess")
        n_samples = args.ess_samples if ess else args.composed_samples
        p = dataclasses.replace(configs.build(name, "cuda"),
                                burn_in=args.ess_burn_in if ess else args.composed_burn_in)
        steps = p.burn_in + n_samples * p.thin
        t0 = time.perf_counter()
        m = runner.run_problem(p, "cuda", seed=0, n_samples=n_samples)
        row = {"burn_in": p.burn_in, "n_samples": n_samples, "mesh_shape": m["mesh_shape"],
               "run_s": m["run_s"], "steps_per_s": m["steps_per_s"],
               "ms_per_step": 1e3 * m["run_s"] / steps,
               "stat": m.get("accept_rate", m.get("mean_evals_per_step")),
               "max_rhat": m["max_rhat"], "min_ess": m["min_ess"],
               "run_problem_wall_s": time.perf_counter() - t0}
        row.update(one_transition(p, name.split("_")[-1]))
        out[name] = row
        print(name + ": " + json.dumps(row), flush=True)
    parallel.shutdown()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
