"""One rank of the gloo worlds of tests/test_torch_composed.py:

    python tests/torch_composed_worker.py RANK WORLD STORE OUT

Reads the inputs the test wrote (OUT/../inputs.npz: fields, data, starts
and JAX's draws), runs every case of that file on this world and saves
what it found to OUT/rank{RANK}.pt. A world of 4 runs the sharded operator
and solve on 2 and 4 'model' ranks, the distributed value and gradient,
one transition of each composed sampler from JAX's draws, the samplers on
the (4, 1), (2, 2) and (1, 4) meshes and the sharded ensemble sampler on
4, 2 and 1 chain groups, and the runner on a given and on its own mesh; a
world of 1 the samplers on the (1, 1) mesh and the composed configs
through the CLI.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch_world import init, save_result  # noqa: E402

# the small problem of the sampler cases: 8 x 8 grid, 16 modes, 40 Jacobi
# CG iterations (converged on 64 cells), 8 chains
SMALL = dict(n_grid=8, n_modes_per_dim=4)
CG_SMALL, NOISE = 40, 0.05
STEPS = dict(n_samples=2, burn_in=1)
MAX_SHRINK = 8
MALA_STEP = 1.0  # the MALA transition's step (its samplers run at 0.05)


def t(x):
    return torch.as_tensor(np.asarray(x))


def grid_cases(inp):
    """The sharded operator, solve and forward on 2 and 4 'model' ranks."""
    from ip_mcmc_tpu_torch import parallel
    from ip_mcmc_tpu_torch.models import darcy
    from ip_mcmc_tpu_torch.parallel import grid_shard

    a, p, f = t(inp["a"]), t(inp["p"]), t(inp["f"])
    n = a.shape[-1]
    out = {}
    for m in (2, 4):
        mesh = parallel.make_mesh(4 // m, m)
        rows = n // m
        r0 = mesh.model_index * rows
        blk = grid_shard.sharded_apply_operator(a[:, r0:r0 + rows].contiguous(),
                                                p[:, r0:r0 + rows].contiguous(), n, mesh)
        parts = [torch.empty_like(blk) for _ in range(m)]
        torch.distributed.all_gather(parts, blk.contiguous(), group=mesh.model_group)
        out[f"apply{m}"] = torch.cat(parts, dim=-2)
        out[f"solve{m}"] = grid_shard.sharded_solve_cg(a, f, n, mesh, n_iters=150)
        fwd, _ = darcy.make_darcy_forward(n_grid=16, n_modes_per_dim=4, cg_iters=100,
                                          method="sharded", device="cpu", mesh=mesh)
        out[f"forward{m}"] = fwd(t(inp["u_fwd"]))
    try:
        darcy.make_darcy_forward(n_grid=10, n_modes_per_dim=4, method="sharded", device="cpu",
                                 mesh=parallel.make_mesh(1, 4))
        out["indivisible_refused"] = False
    except ValueError:
        out["indivisible_refused"] = True
    return out


def _aux(small):
    from ip_mcmc_tpu_torch.models import darcy

    return darcy.darcy_aux(**(SMALL if small else dict(n_grid=16, n_modes_per_dim=8)))


def transition_cases(inp):
    """(Φ, ∇Φ) of the 16 x 16 problem on the (2, 2) mesh, and one pCN,
    MALA and ESS transition of the 8 x 8 one from JAX's draws."""
    from ip_mcmc_tpu_torch import parallel
    from ip_mcmc_tpu_torch.parallel import composed

    mesh = parallel.make_mesh(2, 2)
    out = {}
    out["phi"], out["grad"] = composed.composed_misfit_and_grad(
        _aux(False), inp["y16"], NOISE, mesh, t(inp["u16"]), cg_iters=150)
    u0 = t(inp["u0"])
    blk = composed._Block(_aux(True), inp["y8"], NOISE, mesh, u0.shape[0], CG_SMALL, 0.0)
    lo, hi = blk.lo, blk.lo + blk.c
    u = u0[lo:hi]
    phi = blk.misfit(u)
    new, _, acc = composed.pcn_transition(blk.misfit, u, phi, t(inp["xi"])[lo:hi],
                                          t(inp["log_u"])[lo:hi], 0.3)
    out["pcn"] = (parallel.gather_chains(new, mesh), parallel.gather_chains(acc, mesh))
    phi, g = blk.value_and_grad(u)
    new, _, _, acc = composed.mala_transition(blk.value_and_grad, u, phi, g,
                                              t(inp["xi"])[lo:hi], t(inp["log_u"])[lo:hi],
                                              MALA_STEP)
    out["mala"] = (parallel.gather_chains(new, mesh), parallel.gather_chains(acc, mesh))
    shrink = t(inp["shrink"])
    new, _, n_ev = composed.ess_transition(
        blk.misfit, u, blk.misfit(u), t(inp["nu"])[lo:hi], t(inp["log_w"])[lo:hi],
        t(inp["theta0"])[lo:hi], lambda i: shrink[i, lo:hi], MAX_SHRINK)
    out["ess"] = (parallel.gather_chains(new, mesh), parallel.gather_chains(n_ev, mesh))
    return out


def sampler_cases(inp, shapes):
    """The three composed samplers on each mesh shape: (samples, rate)."""
    from ip_mcmc_tpu_torch import parallel
    from ip_mcmc_tpu_torch.parallel import composed

    out = {}
    common = dict(mesh=None, u0=t(inp["u0"]), seed=9, cg_iters=CG_SMALL, **STEPS)
    for shape in shapes:
        common["mesh"] = parallel.make_mesh(*shape)
        out[shape] = {
            "pcn": composed.sample_composed_pcn(_aux(True), inp["y8"], NOISE, beta=0.3, **common),
            "mala": composed.sample_composed_mala(_aux(True), inp["y8"], NOISE, step_size=0.05,
                                                  **common),
            "ess": composed.sample_composed_elliptical(_aux(True), inp["y8"], NOISE,
                                                       max_shrink=MAX_SHRINK, **common),
        }
    return out


def fes_cases():
    """The sharded ensemble sampler on 4, 2 and 1 chain groups (a small
    run each), and its moments on a Gaussian posterior (4 groups)."""
    from ip_mcmc_tpu_torch import distributions, parallel
    from ip_mcmc_tpu_torch.parallel import fes_shard

    D, M = 16, 4
    w = torch.tensor([1.0 / 0.25 - 1.0] * M + [1.0 / 0.5 - 1.0] * (D - M))
    phi = lambda u: 0.5 * torch.sum(w * u * u, dim=-1)  # noqa: E731  N(0, diag(var)) posterior
    prior = distributions.DiagGaussian(mean=torch.zeros(D), scale=torch.ones(D))
    out = {}
    for shape in ((4, 1), (2, 2), (1, 4)):
        mesh = parallel.make_mesh(*shape)
        u0 = torch.randn(32, D, generator=torch.Generator().manual_seed(0))
        out[shape] = fes_shard.sample_fes_sharded(phi, prior, mesh=mesh, u0=u0, seed=7,
                                                  n_low_modes=M, n_samples=25, burn_in=10)
    u0 = torch.randn(256, D, generator=torch.Generator().manual_seed(3))
    out["moments"] = fes_shard.sample_fes_sharded(phi, prior, mesh=parallel.make_mesh(4, 1),
                                                  u0=u0, seed=7, n_low_modes=M, n_samples=300,
                                                  burn_in=200)
    return out


def cli_cases():
    """The composed configs through the CLI in this world of one (the
    burn-in cut to 1 and the solves to 20 iterations, 16 chains, 5
    samples): the JSON line's keys and values."""
    from ip_mcmc_tpu_torch import configs, run

    out = {}
    for name in ("darcy_composed_pcn", "darcy_composed_mala", "darcy_composed_ess"):
        shipped = configs.REGISTRY[name]

        def cut(device, f=shipped):
            p = f(device)
            return dataclasses.replace(p, burn_in=1,
                                       kernel_params={**p.kernel_params, "cg_iters": 20})

        configs.REGISTRY[name] = cut
        buf = io.StringIO()
        try:
            with contextlib.redirect_stdout(buf):
                rc = run.main(["--config", name, "--device", "cpu", "--n-chains", "16",
                               "--n-samples", "5", "--devices", "1"])
        finally:
            configs.REGISTRY[name] = shipped
        assert rc == 0
        out[name] = json.loads(buf.getvalue().strip().splitlines()[-1])
    return out


def runner_mesh_cases():
    """darcy_composed_pcn through ``runner.run_problem`` (burn-in 1, 20
    solve iterations, 16 chains, 5 samples): on the caller's (2, 2) mesh,
    and with no mesh on one of the world's size, (1, 4) by JAX's rule."""
    from ip_mcmc_tpu_torch import configs, parallel, runner

    p = configs.build("darcy_composed_pcn", "cpu")
    p = dataclasses.replace(p, burn_in=1, kernel_params={**p.kernel_params, "cg_iters": 20})
    run = lambda mesh: runner.run_problem(p, "cpu", n_chains=16, n_samples=5,  # noqa: E731
                                          mesh=mesh)["mesh_shape"]
    return {"given": run(parallel.make_mesh(2, 2)), "world": run(None)}


def main(argv):
    rank, world, out = init(argv)
    from ip_mcmc_tpu_torch import parallel

    inp = dict(np.load(out.parent / "inputs.npz"))
    if world == 4:
        result = {"grid": grid_cases(inp), "transitions": transition_cases(inp),
                  "samplers": sampler_cases(inp, ((4, 1), (2, 2), (1, 4))),
                  "fes": fes_cases(), "runner_mesh": runner_mesh_cases()}
    else:
        result = {"samplers": sampler_cases(inp, ((1, 1),)), "cli": cli_cases()}
    save_result(out, rank, result)
    parallel.shutdown()


if __name__ == "__main__":
    main(sys.argv)
