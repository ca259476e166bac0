"""One rank of the gloo world of tests/test_torch_parallel.py:

    python tests/torch_parallel_worker.py RANK WORLD STORE OUT

Runs every case of that file on this world (every mesh shape it has) and
saves what it found to OUT/rank{RANK}.pt: the sharded scan path against the
single-process run on the same rank, the distributed resampling against
the serial one, the sharded fused samplers against unsharded launches with
each rank's seed, the mesh's refusals, and ``dryrun_multichip``.
"""

from __future__ import annotations

import dataclasses
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))

import torch  # noqa: E402
from torch_world import init, save_result  # noqa: E402


def scan_cases(mesh):
    """Each scan kernel sharded over the chain mesh against
    ``driver.sample_chains`` on the whole batch: the samples, the final
    state and the info means, each bit for bit."""
    from ip_mcmc_tpu_torch import configs, driver, parallel
    from ip_mcmc_tpu_torch.kernels import da_pcn, elliptical, pcn, rwm

    lg = configs.build("lingauss_pcn", "cpu")
    g2 = configs.build("gauss2d_rwm", "cpu")
    phi, prior = lg.potential_fn, lg.prior
    surrogate = lambda u: 0.9 * phi(u)  # noqa: E731
    cases = {
        "pcn": (pcn.build_kernel(phi, prior, beta=0.2), pcn.init, (phi,), lg),
        "rwm": (rwm.build_kernel(g2.log_density_fn, step_size=0.9), rwm.init,
                (g2.log_density_fn,), g2),
        "da_pcn": (da_pcn.build_kernel(phi, surrogate, prior, beta=0.2, subchain_len=3),
                   da_pcn.init, (phi, surrogate), lg),
        "elliptical": (elliptical.build_kernel(phi, prior, max_shrink=8), elliptical.init,
                       (phi,), lg),
    }
    out = {}
    for name, (kernel, init_fn, args, problem) in cases.items():
        pos = problem.init_positions(torch.Generator().manual_seed(7), 32)
        state = driver.init_chains(init_fn, pos, *args)
        got = parallel.sample_chains_sharded(kernel, state, torch.Generator().manual_seed(9),
                                             mesh, n_samples=12, burn_in=4, thin=2)
        want = driver.sample_chains(kernel, state, torch.Generator().manual_seed(9),
                                    n_samples=12, burn_in=4, thin=2)
        fields = lambda x: [getattr(x, f.name) for f in dataclasses.fields(x)]  # noqa: E731
        out[name] = (torch.equal(got[1], want[1])
                     and all(torch.equal(a, b) for a, b in zip(fields(got[0]), fields(want[0])))
                     and all(torch.equal(a, b) for a, b in zip(fields(got[2]), fields(want[2]))))
    return out


def resample_cases(world):
    """``distributed_systematic_resample`` on every mesh shape of the world
    against ``smc.systematic_resample``; the unequal-shard refusal."""
    from ip_mcmc_tpu_torch import parallel, smc
    from ip_mcmc_tpu_torch.parallel.resample import distributed_systematic_resample

    n, d = 48, 5
    g = torch.Generator().manual_seed(11)
    lw = 3.0 * torch.randn(n, generator=g)
    particles = torch.randn(n, d, generator=g)
    u0 = torch.rand((), generator=g) / n
    serial = particles[smc.systematic_resample(lw, u0)]
    out = {}
    for shape in sorted({(world, 1), (1, world), (world // 2, 2)}):
        mesh = parallel.make_mesh(*shape)
        lo, hi = mesh.chain_rows(n)
        local = distributed_systematic_resample(u0, lw[lo:hi], particles[lo:hi], mesh)
        out[shape] = parallel.gather_chains(local, mesh)
    mesh = parallel.make_chain_mesh()
    lo, hi = mesh.chain_rows(n)
    extra = 1 if mesh.rank == 0 else 0
    try:
        distributed_systematic_resample(u0, lw[lo:hi + extra], particles[lo:hi + extra], mesh)
        refused = False
    except ValueError:
        refused = True
    return {"serial": serial, "by_shape": out, "unequal_shards_refused": refused}


def fused_cases(world):
    """The sharded fused samplers (their plain versions here) against an
    unsharded launch of this rank's rows with its seed, seed + r·SEED_STRIDE."""
    from ip_mcmc_tpu_torch import configs, ops, parallel
    from ip_mcmc_tpu_torch.parallel.fused_shard import SEED_STRIDE

    rank = torch.distributed.get_rank()
    out = {}
    pot = configs.gauss2d_batched_potential()
    pos = torch.randn(world * 16, 2, generator=torch.Generator().manual_seed(3))
    mesh = parallel.make_chain_mesh()
    got = parallel.sharded_fused_chain(ops.fused_rwm_chain, mesh, pot, pos, seed=4,
                                       step_size=0.9, n_steps=20, block_chains=8)
    lo, hi = mesh.chain_rows(pos.shape[0])
    want = ops.fused_rwm_chain(pot, pos[lo:hi], 0.9, 4 + rank * SEED_STRIDE, n_steps=20,
                               block_chains=8)
    out["rwm"] = all(torch.equal(a[lo:hi], b) for a, b in zip(got, want))
    # the recorded DA sampler on the Darcy configs' misfits: samples gather
    # along their chain axis (axis 1)
    p = configs.build("darcy_da_fused", "cpu")
    pos = p.init_positions(torch.Generator().manual_seed(5), world * 4)
    kw = dict(prior_mean=p.prior.mean, prior_scale=p.prior.scale, beta=0.35, subchain_len=2,
              n_steps=2, thin=1, block_chains=4)
    got = parallel.sharded_fused_chain(
        lambda phi, x, **k: ops.fused_da_pcn_chain_recorded(phi, p.batched_surrogate_fn, x, **k),
        mesh, p.batched_potential_fn, pos, seed=6, **kw)
    lo, hi = mesh.chain_rows(pos.shape[0])
    want = ops.fused_da_pcn_chain_recorded(p.batched_potential_fn, p.batched_surrogate_fn,
                                           pos[lo:hi], seed=6 + rank * SEED_STRIDE, **kw)
    out["da_recorded"] = (torch.equal(got[0][lo:hi], want[0]) and torch.equal(got[1][lo:hi], want[1])
                          and torch.equal(got[2][:, lo:hi], want[2])
                          and got[2].shape[1] == pos.shape[0])
    # the composed mesh as one flat pool: rank r's rows, its world rank's seed
    cmesh = parallel.make_mesh(world // 2, 2)
    pos = torch.randn(world * 8, 2, generator=torch.Generator().manual_seed(8))
    got = parallel.sharded_fused_chain_composed(ops.fused_rwm_chain, cmesh, pot, pos, seed=1,
                                                step_size=0.9, n_steps=10, block_chains=8)
    per = pos.shape[0] // world
    want = ops.fused_rwm_chain(pot, pos[rank * per:(rank + 1) * per], 0.9,
                               1 + rank * SEED_STRIDE, n_steps=10, block_chains=8)
    out["rwm_composed"] = all(torch.equal(a[rank * per:(rank + 1) * per], b)
                              for a, b in zip(got, want))
    try:
        parallel.sharded_fused_chain(ops.fused_rwm_chain, mesh, pot, torch.zeros(world * 12, 2),
                                     seed=0, step_size=0.9, n_steps=1, block_chains=8)
        out["block_refused"] = False
    except ValueError:
        out["block_refused"] = True
    return out


def refusals(world):
    """A --devices or mesh shape the world cannot hold, and a path that does
    not shard (ChEES, PT) given a mesh of several ranks."""
    from ip_mcmc_tpu_torch import configs, parallel, runner

    out = {}
    mesh = parallel.make_chain_mesh()
    for name, fn in {"devices": lambda: parallel.make_chain_mesh(n_devices=world + 1),
                     "shape": lambda: parallel.make_mesh(world + 1, 1),
                     "chees": lambda: runner.run_problem(configs.build("ode_chees", "cpu"),
                                                         "cpu", mesh=mesh),
                     "pt": lambda: runner.run_problem(configs.build("multimodal_pt", "cpu"),
                                                      "cpu", mesh=mesh)}.items():
        try:
            fn()
            out[name] = False
        except ValueError:
            out[name] = True
    return out


def main(argv):
    rank, world, out = init(argv)
    from ip_mcmc_tpu_torch import parallel
    from ip_mcmc_tpu_torch.parallel.dryrun import dryrun_multichip

    mesh = parallel.make_chain_mesh()
    result = {"scan": scan_cases(mesh), "resample": resample_cases(world),
              "fused": fused_cases(world), "refusals": refusals(world),
              "dryrun": dryrun_multichip(world, device="cpu")}
    save_result(out, rank, result)
    parallel.shutdown()


if __name__ == "__main__":
    main(sys.argv)
