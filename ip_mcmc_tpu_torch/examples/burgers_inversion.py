"""Burgers initial-data inversion: a shock-forming flow observed at one
time, 16 KL modes of the initial profile, pCN; the posterior-mean profile
and its ±2σ band against the truth.

Run: python -m ip_mcmc_tpu_torch.examples.burgers_inversion [--plot out.png]
[--device cpu]
"""

import argparse
import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.dirname(
    _os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from ip_mcmc_tpu_torch import (diagnostics, distributions, driver, potentials,  # noqa: E402
                               resolve_device)
from ip_mcmc_tpu_torch.kernels import pcn  # noqa: E402
from ip_mcmc_tpu_torch.models import burgers  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--plot", default=None)
    ap.add_argument("--n-chains", type=int, default=512)
    ap.add_argument("--n-samples", type=int, default=800)
    ap.add_argument("--burn-in", type=int, default=800,
                    help="pCN steps before the recorded ones")
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    n_cells, n_modes = 128, 16
    x = (np.arange(n_cells) + 0.5) / n_cells
    fwd, aux = burgers.make_burgers_forward(
        n_cells=n_cells, n_modes=n_modes, t_final=0.2, mean_profile=np.sin(2 * np.pi * x),
        device=dev)
    prior = distributions.DiagGaussian(mean=torch.zeros(n_modes, device=dev),
                                       scale=torch.ones(n_modes, device=dev))
    u_true = prior.sample(torch.Generator().manual_seed(10), 1)[0]
    m = len(aux["obs_indices"])
    noise = distributions.DiagGaussian(mean=torch.zeros(m, device=dev),
                                       scale=0.02 * torch.ones(m, device=dev))
    y = fwd(u_true) + noise.sample(torch.Generator().manual_seed(11), 1)[0]
    phi = potentials.misfit_potential(fwd, y, noise)

    kernel = pcn.build_kernel(phi, prior, beta=0.15)
    state = driver.init_chains(
        pcn.init, prior.sample(torch.Generator().manual_seed(0), args.n_chains), phi)
    _, samples, infos = driver.sample_chains(
        kernel, state, torch.Generator(dev).manual_seed(1), n_samples=args.n_samples,
        burn_in=args.burn_in)
    coeffs = samples.reshape(-1, n_modes).cpu().numpy()
    out = {"accept_rate": float(infos.accepted.mean()),
           "min_ess": float(diagnostics.ess_per_param(samples).min())}
    print(f"accept rate: {out['accept_rate']:.3f}")
    print(f"min ESS    : {out['min_ess']:.0f}")

    # the posterior-mean initial data against the truth
    basis = aux["scaled_basis"].cpu().numpy()
    mean_profile = aux["mean"].cpu().numpy()
    u0_post = mean_profile + coeffs.mean(axis=0) @ basis
    u0_true = mean_profile + u_true.cpu().numpy() @ basis
    u0_std = (coeffs @ basis).std(axis=0)
    out["rel_error"] = float(np.abs(u0_post - u0_true).max() / np.abs(u0_true).max())
    print(f"initial-data max rel error of posterior mean: {out['rel_error']:.3f}")

    if args.plot:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(8, 4))
        ax.plot(x, u0_true, "k-", label="true initial data")
        ax.plot(x, u0_post, "r--", label="posterior mean")
        ax.fill_between(x, u0_post - 2 * u0_std, u0_post + 2 * u0_std, alpha=0.25,
                        label="±2σ")
        ax.legend()
        ax.set_title("Burgers initial-data inversion (pCN)")
        fig.savefig(args.plot, dpi=100, bbox_inches="tight")
        print(f"plot saved to {args.plot}")
    return out


if __name__ == "__main__":
    main()
