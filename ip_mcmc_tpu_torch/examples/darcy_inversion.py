"""Darcy-flow log-permeability inversion (BASELINE config 4 as a narrative
experiment): a 64-dimensional KL field, many pCN chains, the posterior
field's mean and spread against the truth.

Run: python -m ip_mcmc_tpu_torch.examples.darcy_inversion [--plot out.png]
[--smc | --fused] [--device cpu]
"""

import argparse
import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.dirname(
    _os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from ip_mcmc_tpu_torch import (diagnostics, distributions, driver, potentials,  # noqa: E402
                               resolve_device, smc)
from ip_mcmc_tpu_torch.kernels import pcn  # noqa: E402
from ip_mcmc_tpu_torch.models import darcy  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--plot", default=None)
    ap.add_argument("--n-chains", type=int, default=1024)
    ap.add_argument("--n-samples", type=int, default=500)
    ap.add_argument("--burn-in", type=int, default=500,
                    help="pCN steps before the recorded ones (the fused path's too)")
    ap.add_argument("--smc", action="store_true", help="use adaptive SMC instead of pCN")
    ap.add_argument("--fused", action="store_true",
                    help="the fused warm-started pCN kernel on the dense-dst misfit")
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    n_grid, K = 16, 64
    fwd, aux = darcy.make_darcy_forward(n_grid=n_grid, n_modes_per_dim=8, device=dev)
    prior = distributions.DiagGaussian(mean=torch.zeros(K, device=dev),
                                       scale=torch.ones(K, device=dev))
    u_true = prior.sample(torch.Generator().manual_seed(30), 1)[0]
    m = len(aux["obs_indices"])
    noise = distributions.DiagGaussian(mean=torch.zeros(m, device=dev),
                                       scale=0.002 * torch.ones(m, device=dev))
    y = fwd(u_true) + noise.sample(torch.Generator().manual_seed(31), 1)[0]
    phi = potentials.misfit_potential(fwd, y, noise)
    out = {}

    if args.smc:
        state, info = smc.run(phi, prior, torch.Generator(dev).manual_seed(0),
                              n_particles=args.n_chains, mutation_steps=5, pcn_step=0.15)
        coeffs = state.particles.cpu().numpy()
        out.update(n_stages=int(info.n_stages), log_z=float(state.log_z))
        print(f"SMC stages: {out['n_stages']}, log Z: {out['log_z']:.2f}")
    elif args.fused:
        from ip_mcmc_tpu_torch.convert import darcy_warm_misfit_from_arrays
        from ip_mcmc_tpu_torch.ops import fused_pcn_chain_warm, fused_pcn_chain_warm_recorded

        phi_w, aux_dim = darcy_warm_misfit_from_arrays(
            darcy.darcy_aux(n_grid=n_grid, n_modes_per_dim=8), y.cpu().numpy(), 0.002,
            cg_iters=6, precond="dst")
        phi_w = phi_w.to(dev)
        pm, ps = np.zeros(K), np.ones(K)
        block = min(256, args.n_chains)
        pos = prior.sample(torch.Generator().manual_seed(0), args.n_chains)
        pos, _ = fused_pcn_chain_warm(
            phi_w, pos, prior_mean=pm, prior_scale=ps, beta=0.08, seed=1,
            n_steps=args.burn_in, aux_dim=aux_dim, block_chains=block)
        _, acc, samples = fused_pcn_chain_warm_recorded(
            phi_w, pos, prior_mean=pm, prior_scale=ps, beta=0.08, seed=2,
            n_steps=args.n_samples, thin=1, aux_dim=aux_dim, block_chains=block)
        coeffs = samples.reshape(-1, K).cpu().numpy()
        out.update(accept_rate=float(acc.mean()),
                   min_ess=float(diagnostics.ess_per_param(samples).min()))
        print(f"accept rate: {out['accept_rate']:.3f}")
        print(f"min ESS    : {out['min_ess']:.0f}")
    else:
        kernel = pcn.build_kernel(phi, prior, beta=0.08)
        state = driver.init_chains(
            pcn.init, prior.sample(torch.Generator().manual_seed(0), args.n_chains), phi)
        _, samples, infos = driver.sample_chains(
            kernel, state, torch.Generator(dev).manual_seed(1), n_samples=args.n_samples,
            burn_in=args.burn_in)
        coeffs = samples.reshape(-1, K).cpu().numpy()
        out.update(accept_rate=float(infos.accepted.mean()),
                   min_ess=float(diagnostics.ess_per_param(samples).min()))
        print(f"accept rate: {out['accept_rate']:.3f}")
        print(f"min ESS    : {out['min_ess']:.0f}")

    basis = aux["scaled_basis"].cpu().numpy()
    field_post = (coeffs.mean(axis=0) @ basis).reshape(n_grid, n_grid)
    field_true = (u_true.cpu().numpy() @ basis).reshape(n_grid, n_grid)
    field_std = (coeffs @ basis).std(axis=0).reshape(n_grid, n_grid)
    out.update(field_error=float(np.abs(field_post - field_true).max()),
               field_std=float(field_std.mean()))
    print("log-permeability field: max|post-mean − truth| ="
          f" {out['field_error']:.3f}, mean posterior std = {out['field_std']:.3f}")

    if args.plot:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, axes = plt.subplots(1, 3, figsize=(13, 4))
        for ax, (f, title) in zip(axes, [(field_true, "true log a"),
                                         (field_post, "posterior mean"),
                                         (field_std, "posterior std")]):
            im = ax.imshow(f, origin="lower", extent=[0, 1, 0, 1])
            ax.set_title(title)
            fig.colorbar(im, ax=ax, shrink=0.8)
        fig.savefig(args.plot, dpi=100, bbox_inches="tight")
        print(f"plot saved to {args.plot}")
    return out


if __name__ == "__main__":
    main()
