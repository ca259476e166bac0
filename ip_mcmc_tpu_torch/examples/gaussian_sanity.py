"""Sanity experiment: RWM on an analytic 2-D Gaussian target, checked
against the closed form, with the posterior histogram plot.

Run: python -m ip_mcmc_tpu_torch.examples.gaussian_sanity [--plot out.png]
[--device cpu]
"""

import argparse
import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.dirname(
    _os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from ip_mcmc_tpu_torch import diagnostics, driver, resolve_device  # noqa: E402
from ip_mcmc_tpu_torch.distributions import Gaussian  # noqa: E402
from ip_mcmc_tpu_torch.kernels import rwm  # noqa: E402

MEAN = np.array([1.0, -0.5])
COV = np.array([[2.0, 0.8], [0.8, 1.0]])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--plot", default=None, help="save posterior plot to file")
    ap.add_argument("--n-chains", type=int, default=256)
    ap.add_argument("--n-samples", type=int, default=1000)
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    target = Gaussian.from_covariance(torch.tensor(MEAN, dtype=torch.float32, device=dev),
                                      torch.tensor(COV, dtype=torch.float32))
    kernel = rwm.build_kernel(target.log_prob, step_size=0.8)
    start = torch.randn(args.n_chains, 2, generator=torch.Generator().manual_seed(0)).to(dev)
    state = driver.init_chains(rwm.init, start, target.log_prob)
    _, samples, infos = driver.sample_chains(
        kernel, state, torch.Generator(dev).manual_seed(1), n_samples=args.n_samples,
        burn_in=500)
    flat = samples.reshape(-1, 2).cpu().numpy()
    summ = diagnostics.summarize(samples)

    accept = float(infos.accepted.mean())
    print(f"accept rate : {accept:.3f}")
    print(f"mean        : {flat.mean(axis=0)}  (exact {MEAN})")
    print(f"cov         :\n{np.cov(flat.T)}\n(exact)\n{COV}")
    print(f"min ESS     : {float(summ['min_ess']):.0f}")
    print(f"max R-hat   : {float(summ['max_rhat']):.4f}")

    if args.plot:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, axes = plt.subplots(1, 2, figsize=(10, 4))
        axes[0].hist2d(flat[:, 0], flat[:, 1], bins=60)
        axes[0].plot(*MEAN, "r+", markersize=12)
        axes[0].set_title("posterior samples")
        axes[1].hist(flat[:, 0], bins=80, density=True, alpha=0.6, label="samples")
        g = np.linspace(flat[:, 0].min(), flat[:, 0].max(), 200)
        axes[1].plot(g, np.exp(-0.5 * (g - MEAN[0]) ** 2 / COV[0, 0])
                     / np.sqrt(2 * np.pi * COV[0, 0]), "r-", label="exact marginal")
        axes[1].legend()
        fig.savefig(args.plot, dpi=100, bbox_inches="tight")
        print(f"plot saved to {args.plot}")
    return {"accept_rate": accept, "mean": flat.mean(axis=0), "cov": np.cov(flat.T),
            "min_ess": float(summ["min_ess"]), "max_rhat": float(summ["max_rhat"])}


if __name__ == "__main__":
    main()
