"""Old against new on one card: do two trees of the port give the same
chains bit for bit, and at what speed?

    git archive --prefix=_archive/parent/ <parent commit> | tar -x
    python scripts/compare_kernels_with_parent.py --parent _archive/parent
    python scripts/compare_kernels_with_parent.py --parent _archive/parent --rows mala,mala_warm
    python scripts/compare_kernels_with_parent.py --parent _archive/parent \
        --cli darcy_da_fused darcy32_pcn_warm darcy_da_richardson:cg3

Runs the 16x16 Darcy kernels that both trees have (the misfit kernels with
and without the adjoint gradient, DA-pCN with the CG and with the rich3
Richardson surrogate, cold and warm pCN, ESS, cold and warm MALA, the
ensemble sampler and the Darcy RWM, each recorded, at 4096 chains on the
16x16 Darcy configs), the Burgers DA-pCN, three-level DA-pCN and pCN
kernels (``burgers_da_pcn``, ``burgers_da3_pcn``, ``burgers_pcn`` and
``burgers_multitime_pcn``: 2048 chains), the cold
and warm misfit kernels at 32x32 (darcy32_pcn_warm's, at 4096 draws, and
a cold dst_trunc-128 / 16 CG one) and 64x64, the 64x64 DA-pCN
(``darcy64_da_fused``: 1024 chains, blocks of 128, k = 48) and warm pCN
(``darcy64_pcn_warm``: 2048 chains) kernels and the 32x32 warm pCN kernel
(``darcy32_pcn_warm``: 4096 chains, blocks of 128), each recorded, and
the linear-Gaussian samplers on their shipped specs, plain and recorded:
RWM on the compare_paths target (8192 chains, blocks of 1024) and on
gauss2d_rwm's with its prior (1024, blocks of 512), dense-prior pCN on
lingauss_pcn's misfit with L = diag √λ (2048, blocks of 256), and the
adaptive pCN burn-in on it (``pcn_adapt_lingauss``: β adapted per block of
256, 20 steps; times: the slope between burn-ins of 20 and 2020 steps), in
the order parent, this tree, this tree, parent, each in a process of its
own with that tree first on the import path (each tree builds its own
kernels). Each tree's two runs must equal one another bit for bit. Every
output tensor of this tree must equal the parent's bit for bit, except
those of the kernels in ``OLD_VS_NEW``, which this tree replaced by
another design (the 16x16 DA kernel, one warp per chain; the 64x64 DA and
warm pCN kernels and the 32x32 warm pCN kernel, G chains a thread-block
cluster; the 16x16 warm pCN, whose dst_trunc products run on the tensor
cores; the 64x64 dst_trunc misfits, cold and warm, on the 64x64 samplers'
cluster level; the 32x32 dst_trunc misfits, warm and cold, on the 32x32
warm pCN's level; the 16x16 exact misfit of darcy_da_fused a draw a warp on
the DA kernel's exact level; darcy64_da_fused's 32x32 surrogate on the 64x64
DA kernel's surrogate level; darcy_pcn_warm's warm misfit, from x0 = 0
(``misfit_warm``) and from those solutions after a pCN move
(``misfit_warm_prev``), a draw a warp on the warm pCN's level, its
products on the tensor cores; the 8x8
surrogates of darcy_da_fused (``misfit_surrogate``) and of the Richardson
runs (``misfit_surr_rich3`` / ``_rich4`` / ``_rich2``) a draw a warp on the
16x16 DA kernel's surrogate level; their sums run in another order): there whether the outputs
equal the parent's all the same, the share of chains (final state and
records) within ``CHAIN_ATOL`` of the parent's and both acceptance rates
are printed (two kernels that each round differently from the plain twin;
chip_smoke.py holds each against the twin); for a misfit, Φ's relative
difference (median, largest, share within 1e-3) and the solution's. The per-step times
(CUDA events, slope between two launch lengths) are printed side by side
with the parent's over this tree's, with the card's name and power limit;
a misfit row's time a call (CUDA events around its calls, which a small
call can leave waiting on the host) has its device time beside it
(``<row>@device``: what torch.profiler records in its kernel).
Then the registers and spill bytes that ptxas reported for each kernel of
both trees' builds (``_build/nvcc.log``) are set side by side. Exits
non-zero on any difference beyond these, in the outputs or in ptxas'
report. ``--rows`` runs only the named rows (``misfits`` names all the
misfit kernels' rows; ``misfit_burgers`` the four Burgers levels' (K12,
2048 draws, bit for bit whether a tree runs them a draw a CTA or a draw a
warp); ``misfit_jacobi48`` and ``misfit_grad`` are the 16x16
Jacobi / 48 CG value and value-and-gradient misfits, and ``misfit_grad_warm``
darcy_mala_warm's warm value and gradient (from aux0 = 0, then from those
solutions after a MALA-sized move), which a tree may run a draw a CTA or a
draw a warp and which must agree bit for bit either way),
to compare two designs of a few kernels in turns.

``--cli`` runs CLI configs in place of the kernel rows, in the same turns:
each through ``runner.run_problem`` as ``python -m ip_mcmc_tpu_torch.run
--config <name>`` runs it (a name ``darcy_da_richardson:<variant>`` builds
``configs.darcy_da_richardson(variant)``, which has no CLI name;
``gauss2d_rwm:fused`` runs the runner's fused RWM branch with the config's
``phi_batched`` set, and ``lingauss_pcn:fused`` the K16 burn-in and K15
sampling run, each as that tree's ``chip_smoke.py`` drives it; any other
``<name>:fused`` is the CLI's ``--fused``, e.g. ``darcy_pcn_4096:fused``). Prints
each run's ``run_s`` (and ``burn_s``, the burn-in of ``lingauss_pcn:fused``)
and statistics, whether the two trees' statistics
(acceptance rates, ``min_ess``, ``max_rhat``, the posterior mean, the
adapted β and the error against the exact posterior mean) are equal digit
for digit in the four runs, and one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parent.parent
# kernels this tree replaced by another design: compared, not bit for bit
OLD_VS_NEW = ("da_pcn", "da_pcn_richardson", "da_pcn_64", "pcn_warm_64", "pcn_warm_32",
              "pcn_warm", "misfit64_exact", "misfit64_cold", "misfit64_warm", "misfit_exact",
              "misfit32_warm", "misfit32_dst", "misfit64_surrogate", "misfit_warm",
              "misfit_warm_prev", "misfit_surrogate", "misfit_surr_rich3", "misfit_surr_rich4",
              "misfit_surr_rich2")
CHAIN_ATOL = 1e-4  # chip_smoke.py's
MISFIT_RTOL = 1e-3  # the rtol of chip_smoke.py's LARGE_BF16_TOL
TURNS = ("parent", "new", "new", "parent")
# a CLI run's statistics that the two trees should share, and what is shown
CLI_STATS = ("accept_rate", "inner_accept_rate", "mid_accept_rate", "min_ess", "max_rhat",
             "posterior_mean", "beta", "burn_accept_rate", "mean_error_vs_exact")
CLI_SHOWN = ("run_s", "burn_s", "ess_per_s", "min_ess", "max_rhat", "accept_rate",
             "inner_accept_rate", "beta", "mean_error_vs_exact")


def _row(key: str) -> str:
    return key.rsplit("_", 1)[0]


def old_vs_new(parent: dict, new: dict, rows) -> None:
    """Prints the OLD_VS_NEW rows (those of ``rows``, when given): whether
    their outputs equal the parent's, the share of chains within CHAIN_ATOL
    over the final states and the records, the parent's and the new
    acceptance."""
    import torch

    for row in OLD_VS_NEW:
        if row.startswith("misfit"):
            if rows is None or "misfits" in rows or row in rows:
                misfit_old_vs_new(parent, new, row)
            continue
        if rows is not None and row not in rows:
            continue
        final = (new[f"{row}_0"] - parent[f"{row}_0"]).abs().amax(dim=1)
        rec = (new[f"{row}_2"] - parent[f"{row}_2"]).abs().amax(dim=(0, 2))
        frac = float((torch.maximum(final, rec) <= CHAIN_ATOL).double().mean())
        acc_p, acc_n = float(parent[f"{row}_1"].mean()), float(new[f"{row}_1"].mean())
        equal = all(torch.equal(parent[f"{row}_{i}"], new[f"{row}_{i}"]) for i in range(3))
        print(f"  {row}: bit for bit {equal}; {frac:.4f} of chains within {CHAIN_ATOL} of the "
              f"parent's (final state and records), acceptance parent {acc_p:.4f} new {acc_n:.4f}")


def misfit_old_vs_new(parent: dict, new: dict, row: str) -> None:
    """A misfit row of OLD_VS_NEW: bit for bit or not; Φ's relative
    difference to the parent's, and (warm) the solution's per draw relative
    to the draw's largest cell."""
    import torch

    keys = sorted(k for k in parent if k.rsplit("_", 1)[0] == row)
    equal = all(torch.equal(parent[k], new[k]) for k in keys)
    phi_p, phi_n = parent[f"{row}_phi"], new[f"{row}_phi"]
    rel = (phi_n - phi_p).abs() / phi_p.abs()
    line = (f"  {row}: bit for bit {equal}; Phi relative to the parent's: median "
            f"{float(rel.median()):.3e}, max {float(rel.max()):.3e}, "
            f"{float((rel <= MISFIT_RTOL).double().mean()):.4f} within {MISFIT_RTOL}")
    if f"{row}_x" in parent:
        x_p, x_n = parent[f"{row}_x"], new[f"{row}_x"]
        err = (x_n - x_p).abs().amax(dim=0) / x_p.abs().amax(dim=0)
        line += f"; solution: max {float(err.max()):.3e} of its largest cell"
    print(line)


def worker(out_path: str, rows) -> int:
    import numpy as np
    import torch

    from ip_mcmc_tpu_torch import configs, ops
    from ip_mcmc_tpu_torch.convert import darcy_misfit_from_arrays
    from ip_mcmc_tpu_torch.models import darcy
    from ip_mcmc_tpu_torch.convert import linear_gaussian_from_arrays
    from ip_mcmc_tpu_torch.ops import fused_fes, fused_mala, fused_rwm

    from _kernel_variants import device_ms

    def time_ms(fn, reps=3):
        fn()
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    def timed(name, fn, reps):
        """The row's time a call (CUDA events) and, beside it as
        ``<name>@device``, the device time that the profiler records in its
        misfit kernel (a small call's event time can be the host's)."""
        times[name] = time_ms(fn, reps)
        times[f"{name}@device"] = device_ms(fn, reps, ("misfit",))

    def slope(run, short, long):
        return (time_ms(lambda: run(long)) - time_ms(lambda: run(short))) / (long - short)

    n = 4096
    gen = torch.Generator().manual_seed(99)
    da = configs.build("darcy_da_fused", "cuda")
    warm_p = configs.build("darcy_pcn_warm", "cuda")
    pos = da.init_positions(gen, n).cuda()
    U = da.prior.sample(gen, n).T.contiguous()
    pm, ps = da.prior.mean, da.prior.scale
    exact, surr = da.batched_potential_fn, da.batched_surrogate_fn
    jacobi = warm_p.batched_potential_fn
    warm, aux_dim = warm_p.batched_warm_potential
    pag, pag_dim = configs.build("darcy_mala_warm", "cuda").batched_warm_potential
    rich = configs.darcy_da_richardson("rich3_w0.9", "cuda")
    burgers = configs.build("burgers_da_pcn", "cuda")
    bpos = burgers.init_positions(gen, 2048).cuda()
    bfine, bmulti = (configs.build(c, "cuda").batched_potential_fn
                     for c in ("burgers_pcn", "burgers_multitime_pcn"))
    da3 = configs.build("burgers_da3_pcn", "cuda")
    da3_kp = da3.kernel_params

    # the large grids: darcy64_da_fused's two misfits and darcy32_pcn_warm's
    # and darcy64_pcn_warm's cold misfits, 1024 draws each; their warm
    # misfits at their configs' widths (2048 at 64x64, 4096 at 32x32); a
    # cold 32x32 dst_trunc-128 / 16 CG misfit (no config) at 4096
    da64 = configs.build("darcy64_da_fused", "cuda")
    pcn64, pcn32 = (configs.build(c, "cuda") for c in ("darcy64_pcn_warm", "darcy32_pcn_warm"))
    U144 = da64.prior.sample(gen, 1024).T.contiguous()
    U64 = pcn32.prior.sample(gen, 1024).T.contiguous()
    U144w = da64.prior.sample(gen, 2048).T.contiguous()
    U64w = pcn32.prior.sample(gen, n).T.contiguous()
    aux32 = darcy.darcy_aux(n_grid=32, n_modes_per_dim=8, alpha=2.0, field_scale=10.0)
    dst32 = darcy_misfit_from_arrays(aux32, pcn32.data, 0.002, cg_iters=16, precond="dst_trunc",
                                     precond_modes=128).cuda()

    outputs, times = {}, {}

    def misfit_row(name):  # "misfits" runs every misfit row
        return (rows is None or "misfits" in rows or name in rows
                or (name.startswith("misfit_burgers_") and "misfit_burgers" in rows))

    rich_surr = {f"misfit_surr_{v.split('_')[0]}": configs.darcy_da_richardson(
        v, "cuda").batched_surrogate_fn for v in ("rich3_w0.9", "rich4_w0.8", "rich2_w0.9")}
    for name, pot in (("misfit_exact", exact), ("misfit_surrogate", surr),
                      ("misfit_jacobi48", jacobi), *rich_surr.items()):
        if misfit_row(name):
            outputs[f"{name}_phi"] = pot(U)
            timed(name, lambda: pot(U), 20)
    # K12 at the Burgers configs' four levels, 2048 draws (the levels that a
    # tree runs a draw a CTA or a draw a warp, with the same bits either way)
    bU = da3.prior.sample(torch.Generator().manual_seed(96), 2048).T.contiguous()
    for name, pot in (("misfit_burgers_fine", da3.batched_potential_fn),
                      ("misfit_burgers_mid", da3.batched_mid_fn),
                      ("misfit_burgers_coarse", da3.batched_surrogate_fn),
                      ("misfit_burgers_multitime", bmulti)):
        if misfit_row(name):
            outputs[f"{name}_phi"] = pot(bU)
            timed(name, lambda: pot(bU), 200)
    if misfit_row("misfit_warm") or misfit_row("misfit_warm_prev"):
        zeros = torch.zeros(aux_dim, n, device="cuda")
        outputs["misfit_warm_phi"], outputs["misfit_warm_x"] = warm(U, zeros)
        timed("misfit_warm", lambda: warm(U, zeros), 20)
        step = da.prior.sample(torch.Generator().manual_seed(97), n).T
        U2 = (0.9968 * U + 0.08 * step).contiguous()  # a pCN move
        x1 = outputs["misfit_warm_x"]
        outputs["misfit_warm_prev_phi"], outputs["misfit_warm_prev_x"] = warm(U2, x1)
        timed("misfit_warm_prev", lambda: warm(U2, x1), 20)
    if misfit_row("misfit_grad"):
        outputs["misfit_grad_phi"], outputs["misfit_grad_g"] = jacobi.value_and_grad(U)
        timed("misfit_grad", lambda: jacobi.value_and_grad(U), 20)
    if misfit_row("misfit_grad_warm"):
        pag_zeros = torch.zeros(pag_dim, n, device="cuda")
        first = pag(U, pag_zeros)
        step = da.prior.sample(torch.Generator().manual_seed(98), n).T
        U2 = (U + 0.012 * step).contiguous()  # a MALA-sized move
        for i, t in enumerate((*first, *pag(U2, first[2]))):
            outputs[f"misfit_grad_warm_{i}"] = t
        timed("misfit_grad_warm", lambda: pag(U, pag_zeros), 20)
    for name, pot, V in (("misfit64_exact", da64.batched_potential_fn, U144),
                         ("misfit64_surrogate", da64.batched_surrogate_fn, U144),
                         ("misfit64_cold", pcn64.batched_potential_fn, U144),
                         ("misfit32_cold", pcn32.batched_potential_fn, U64),
                         ("misfit32_dst", dst32, U64w)):
        if misfit_row(name):
            outputs[f"{name}_phi"] = pot(V)
            timed(name, lambda: pot(V), 20 if name == "misfit64_surrogate" else 5)
    for name, p, V in (("misfit64_warm", pcn64, U144w), ("misfit32_warm", pcn32, U64w)):
        if misfit_row(name):
            w, dim = p.batched_warm_potential
            z = torch.zeros(dim, V.shape[1], device="cuda")
            outputs[f"{name}_phi"], outputs[f"{name}_x"] = w(V, z)
            timed(name, lambda: w(V, z), 5)
    w64, w64_dim = pcn64.batched_warm_potential
    pos64 = da64.init_positions(gen, 2048).cuda()
    w32, w32_dim = pcn32.batched_warm_potential
    pos32 = pcn32.init_positions(gen, n).cuda()

    # the linear-Gaussian samplers' shipped specs (chip_smoke.py's)
    cp = linear_gaussian_from_arrays(np.eye(2), np.zeros(2), np.sqrt([2.0, 0.5]),
                                     center=[1.0, -0.5]).cuda()
    pos_cp = torch.randn(8192, 2, generator=gen).cuda()
    g2p = configs.build("gauss2d_rwm", "cuda")
    g2 = configs.gauss2d_batched_potential().cuda()
    pos_g2 = g2p.init_positions(gen, g2p.n_chains).cuda()
    A, lam, y, sigma = configs.lingauss_arrays()
    lg = linear_gaussian_from_arrays(A, y, sigma).cuda()
    sqrt_lam = torch.tensor(lam, dtype=torch.float32, device="cuda").sqrt()
    pos_lg = (torch.randn(2048, 32, generator=gen).cuda() * sqrt_lam).contiguous()
    zeros32 = torch.zeros(32, device="cuda")

    def linear_rows(name, plain, recorded):
        return {name: (plain, 20, 20, 2020),
                f"{name}_rec": (recorded, 20, 20, 2020)}

    runs = {
        **linear_rows(
            "rwm_compare_paths",
            lambda s: ops.fused_rwm_chain(cp, pos_cp, 0.9, 41, n_steps=s, block_chains=1024),
            lambda s: ops.fused_rwm_chain_recorded(cp, pos_cp, 0.9, 41, n_steps=s, thin=1,
                                                   block_chains=1024)),
        **linear_rows(
            "rwm_gauss2d",
            lambda s: ops.fused_rwm_chain(g2, pos_g2, 1.0, 43, n_steps=s, block_chains=512,
                                          prior_mean=g2p.prior.mean,
                                          prior_scale=g2p.prior.scale),
            lambda s: ops.fused_rwm_chain_recorded(g2, pos_g2, 1.0, 43, n_steps=s, thin=1,
                                                   block_chains=512, prior_mean=g2p.prior.mean,
                                                   prior_scale=g2p.prior.scale)),
        **linear_rows(
            "pcn_dense_lingauss",
            lambda s: ops.fused_pcn_chain_dense(lg, pos_lg, zeros32, torch.diag(sqrt_lam), 0.2,
                                                53, n_steps=s, block_chains=256),
            lambda s: ops.fused_pcn_chain_dense_recorded(lg, pos_lg, zeros32,
                                                         torch.diag(sqrt_lam), 0.2, 53,
                                                         n_steps=s, thin=1, block_chains=256)),
        # K16's burn-in on lingauss_pcn's misfit (2048, blocks of 256)
        "pcn_adapt_lingauss": (lambda s: ops.fused_pcn_chain_adapt(
            lg, pos_lg, zeros32, sqrt_lam, 0.5, 59, n_steps=s, target_accept=0.3,
            block_chains=256), 20, 20, 2020),
        "da_pcn": (lambda s: ops.fused_da_pcn_chain_recorded(
            exact, surr, pos, pm, ps, 0.35, 11, n_steps=s, thin=1, subchain_len=48,
            block_chains=512), 4, 2, 10),
        "da_pcn_richardson": (lambda s: ops.fused_da_pcn_chain_recorded(
            rich.batched_potential_fn, rich.batched_surrogate_fn, pos, pm, ps, 0.35, 11,
            n_steps=s, thin=1, subchain_len=48, block_chains=512), 4, 2, 10),
        "da_pcn_burgers": (lambda s: ops.fused_da_pcn_chain_recorded(
            burgers.batched_potential_fn, burgers.batched_surrogate_fn, bpos,
            burgers.prior.mean, burgers.prior.scale, 0.15, 11, n_steps=s, thin=1,
            subchain_len=16, block_chains=512), 16, 8, 72),
        "pcn_burgers": (lambda s: ops.fused_pcn_chain_recorded(
            bfine, bpos, burgers.prior.mean, burgers.prior.scale, 0.15, 13, n_steps=s, thin=1,
            block_chains=512), 16, 8, 264),
        "pcn_burgers_multitime": (lambda s: ops.fused_pcn_chain_recorded(
            bmulti, bpos, burgers.prior.mean, burgers.prior.scale, 0.15, 13, n_steps=s, thin=1,
            block_chains=512), 16, 8, 264),
        "da3_burgers": (lambda s: ops.fused_da3_pcn_chain_recorded(
            da3.batched_potential_fn, da3.batched_mid_fn, da3.batched_surrogate_fn, bpos,
            da3.prior.mean, da3.prior.scale, da3_kp["beta"], 11, n_steps=s, thin=1,
            k_inner=da3_kp["k_inner"], k_mid=da3_kp["k_mid"], block_chains=512), 2, 2, 8),
        "da_pcn_64": (lambda s: ops.fused_da_pcn_chain_recorded(
            da64.batched_potential_fn, da64.batched_surrogate_fn, pos64[:1024],
            da64.prior.mean, da64.prior.scale, 0.4, 11, n_steps=s, thin=1, subchain_len=48,
            block_chains=128), 2, 2, 6),
        "pcn_warm_64": (lambda s: ops.fused_pcn_chain_warm_recorded(
            w64, pos64, da64.prior.mean, da64.prior.scale, 0.06, 13, n_steps=s, thin=1,
            aux_dim=w64_dim, block_chains=128), 8, 4, 36),
        "pcn_warm_32": (lambda s: ops.fused_pcn_chain_warm_recorded(
            w32, pos32, pcn32.prior.mean, pcn32.prior.scale, 0.08, 13, n_steps=s, thin=1,
            aux_dim=w32_dim, block_chains=128), 8, 4, 36),
        "pcn": (lambda s: ops.fused_pcn_chain_recorded(
            jacobi, pos, pm, ps, 0.08, 13, n_steps=s, thin=1, block_chains=512),
            16, 8, 72),
        "pcn_warm": (lambda s: ops.fused_pcn_chain_warm_recorded(
            warm, pos, pm, ps, 0.08, 13, n_steps=s, thin=1, aux_dim=aux_dim,
            block_chains=256), 16, 8, 72),
        "ess": (lambda s: ops.fused_ess_chain_recorded(
            jacobi, pos, pm, ps, 17, n_steps=s, thin=1, max_shrink=6,
            block_chains=256), 16, 8, 72),
        "mala": (lambda s: fused_mala._launch(
            jacobi, pos, pm, ps, 0.012, 19, s, 256, thin=1), 8, 4, 36),
        "mala_warm": (lambda s: fused_mala._launch(
            pag, pos, pm, ps, 0.012, 19, s, 256, thin=1, aux_dim=pag_dim), 8, 4, 36),
        "fes": (lambda s: fused_fes._launch(
            jacobi, pos, pm, ps, 8, 23, 0.08, 2.0, s, 256, thin=1), 8, 4, 36),
        "rwm_darcy": (lambda s: fused_rwm._launch(
            jacobi, pos, 0.01, 47, s, 256, prior_mean=pm, prior_scale=ps, thin=1),
            16, 8, 72),
    }
    for name, (run, steps, short, long) in runs.items():
        if rows is not None and name not in rows:
            continue
        out = run(steps)
        for i, t in enumerate(out):
            outputs[f"{name}_{i}"] = t
        times[name] = slope(run, short, long)
    torch.cuda.synchronize()
    torch.save({k: v.cpu() for k, v in outputs.items()}, out_path)
    print(json.dumps(times))
    return 0


def cli_worker(names) -> int:
    import torch

    from ip_mcmc_tpu_torch import configs, runner

    out = {}
    for name in names:
        if name in ("gauss2d_rwm:fused", "lingauss_pcn:fused"):
            import chip_smoke  # this tree's: its fused linear-Gaussian runs

            p = configs.build(name.split(":")[0], "cuda")
            run = (chip_smoke.run_gauss2d_fused if name.startswith("gauss2d")
                   else chip_smoke.run_lingauss_fused)
            out[name] = run(p)
        else:
            if name.startswith("darcy_da_richardson:"):
                p = configs.darcy_da_richardson(name.split(":", 1)[1], "cuda")
            else:
                p = configs.build(name.split(":")[0], "cuda")
            if name.endswith(":fused"):  # the CLI's --fused
                p.kernel_params = {**p.kernel_params, "fused": True}
            out[name] = runner.run_problem(p, "cuda")
        torch.cuda.synchronize()
    print(json.dumps(out))
    return 0


def run_worker(tree: pathlib.Path, args) -> dict | None:
    """This script's worker on ``args`` in a process of its own with
    ``tree`` first on the import path: its last line as JSON, or None (its
    output printed) if it failed."""
    env = dict(os.environ, PYTHONPATH=str(tree))
    proc = subprocess.run([sys.executable, str(pathlib.Path(__file__).resolve()), *args],
                          cwd=tree, env=env, capture_output=True, text=True)
    if proc.returncode != 0:
        print(proc.stdout, proc.stderr, file=sys.stderr)
        return None
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="directory holding the other tree")
    ap.add_argument("--rows", help="comma-separated rows to run (default: all)")
    ap.add_argument("--cli", nargs="+", metavar="CONFIG",
                    help="run these CLI configs in place of the kernel rows")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    rows = None if args.rows is None else set(args.rows.split(","))
    if args.worker:
        return cli_worker(args.cli) if args.cli else worker(args.worker, rows)
    if not args.parent:
        ap.error("--parent is required")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    trees = {"parent": pathlib.Path(args.parent).resolve(), "new": ROOT}
    if args.cli:
        return compare_cli(trees, args.cli, card)
    return compare_kernels(trees, args.rows, rows)


def compare_cli(trees, names, card) -> int:
    runs = []
    for which in TURNS:
        stats = run_worker(trees[which], ["--worker", "cli", "--cli", *names])
        if stats is None:
            return 1
        runs.append((which, stats))
    report = {"card": card}
    for name in names:
        rows = [(which, m[name]) for which, m in runs]
        for which, m in rows:
            print(f"{name} {which}: " + ", ".join(f"{k} {m[k]}" for k in CLI_SHOWN if k in m),
                  flush=True)
        equal = all(rows[0][1].get(k) == m.get(k) for k in CLI_STATS for _, m in rows)
        print(f"{name}: statistics equal in the four runs digit for digit {equal}", flush=True)
        report[name] = {"runs": [{"tree": w, **{k: m[k] for k in CLI_SHOWN if k in m}}
                                 for w, m in rows], "statistics_equal": equal}
    print(json.dumps(report))
    return 0


def compare_kernels(trees, rows_arg, rows) -> int:
    import torch

    results = []
    with tempfile.TemporaryDirectory() as tmp:
        for i, which in enumerate(TURNS):
            out = os.path.join(tmp, f"{i}_{which}.pt")
            times = run_worker(trees[which],
                               ["--worker", out, *(["--rows", rows_arg] if rows_arg else [])])
            if times is None:
                return 1
            results.append((which, times, torch.load(out)))
            print(f"{which}: " + json.dumps(times), flush=True)
    ref = {"parent": results[0][2], "new": results[1][2]}
    differing = []
    # each tree against its own first run, then the new tree against the
    # parent but for the rows of another design
    pairs = [(f"{which} (run {i})", ref[which], tensors)
             for i, (which, _, tensors) in enumerate(results) if i > 1]
    pairs.append(("new against parent", ref["parent"], ref["new"]))
    for what, a, b in pairs:
        assert set(a) == set(b)
        for k in sorted(a):
            if what == "new against parent" and _row(k) in OLD_VS_NEW:
                continue
            if not torch.equal(a[k], b[k]):
                differing.append(f"{k} ({what}): max abs diff "
                                 f"{float((a[k] - b[k]).abs().max()):.3e}")
    print("times in ms (per call for the misfits, per step for the samplers): "
          "parent, new, new, parent; parent / new")
    for k in results[0][1]:
        t = [r[1][k] for r in results]
        print(f"  {k:18s} " + "  ".join(f"{v:9.4f}" for v in t)
              + f"  {(t[0] + t[3]) / (t[1] + t[2]):7.3f}x")
    print(f"another design ({', '.join(OLD_VS_NEW)}), new against parent:")
    old_vs_new(ref["parent"], ref["new"], rows)
    bad = compare_ptxas(trees)
    if differing:
        print("NOT bit for bit:\n  " + "\n  ".join(differing))
        return 1
    n_equal = sum(_row(k) not in OLD_VS_NEW for k in ref["parent"])
    print(f"{n_equal} output tensors equal bit for bit in the four runs; each tree's "
          f"{len(ref['parent']) - n_equal} of another design equal in its two runs")
    return 1 if bad else 0


def compare_ptxas(trees) -> bool:
    """Registers and spills of every kernel that both trees' builds hold,
    side by side; True if any differ (or a log is missing)."""
    sys.path.insert(0, str(ROOT))
    from ip_mcmc_tpu_torch.ops import _build

    reports = {which: {r["kernel"]: r for r in _build.ptxas_report(
        tree / "ip_mcmc_tpu_torch" / "_build" / "nvcc.log")} for which, tree in trees.items()}
    if not all(reports.values()):
        print("ptxas: a tree has no nvcc.log (its kernels were built earlier): not compared")
        return True
    common = sorted(set(reports["parent"]) & set(reports["new"]))
    keys = ("registers", "spill_stores", "spill_loads")
    changed = [k for k in common
               if any(reports["parent"][k][f] != reports["new"][k][f] for f in keys)]
    print(f"ptxas: {len(common)} kernels in both builds (registers, spill stores, spill "
          f"loads: parent -> new), {len(changed)} changed; only in the new build: "
          f"{len(set(reports['new']) - set(common))}")
    for k in common:
        a, b = (tuple(reports[w][k][f] for f in keys) for w in ("parent", "new"))
        print(f"  {'CHANGED ' if k in changed else ''}{k}: {a} -> {b}")
    return bool(changed)


if __name__ == "__main__":
    sys.exit(main())
