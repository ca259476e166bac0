"""A bimodal posterior, three ways: plain pCN stays in the mode it starts
in; parallel tempering on an adapted ladder and tempered SMC find both
(right-mode occupancy 0.5).

Run: python -m ip_mcmc_tpu_torch.examples.multimodal_inversion [--plot out.png]
[--device cpu]
"""

import argparse
import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.dirname(
    _os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from ip_mcmc_tpu_torch import driver, resolve_device, smc  # noqa: E402
from ip_mcmc_tpu_torch.distributions import DiagGaussian  # noqa: E402
from ip_mcmc_tpu_torch.kernels import pcn, tempering  # noqa: E402

SEP, SIG = 2.5, 0.35


def build_problem(device):
    prior = DiagGaussian(mean=torch.zeros(1, device=device),
                         scale=3.0 * torch.ones(1, device=device))

    def log_mix(u):
        a = -0.5 * torch.sum((u - SEP) ** 2, dim=-1) / SIG ** 2
        b = -0.5 * torch.sum((u + SEP) ** 2, dim=-1) / SIG ** 2
        return torch.logaddexp(a, b)

    def phi(u):
        return -log_mix(u) - prior.potential(u)

    return prior, phi


def occupancy(x):
    """The share of samples in the right mode (0.5 is right)."""
    return float((torch.as_tensor(x).reshape(-1) > 0).to(torch.float32).mean())


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--plot", default=None)
    ap.add_argument("--n-chains", type=int, default=256)
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    prior, phi = build_problem(dev)
    n = args.n_chains

    # 1. plain pCN: each chain stays in its starting mode
    kernel = pcn.build_kernel(phi, prior, beta=0.3)
    # every chain starts in the left mode, to make the failure visible
    positions = (-SEP + 0.1 * torch.randn(n, 1, generator=torch.Generator().manual_seed(0))
                 ).to(dev)
    state = driver.init_chains(pcn.init, positions, phi)
    _, s_pcn, _ = driver.sample_chains(kernel, state, torch.Generator(dev).manual_seed(1),
                                       n_samples=500, burn_in=200)
    out = {"pcn": occupancy(s_pcn)}
    print(f"plain pCN   : right-mode occupancy {out['pcn']:.3f} "
          "(should be 0.5; stuck near 0.0)")

    # 2. PT with a swap-rate-adapted ladder
    pt_states, betas, _ = tempering.adapt_ladder(
        phi, prior, positions, torch.Generator(dev).manual_seed(2), n_temps=6, num_steps=300,
        swap_center=0.4, pcn_step=0.4)
    pt_kernel = tempering.build_kernel(phi, prior, betas, pcn_step=0.4)
    _, s_pt, _ = driver.sample_chains(pt_kernel, pt_states, torch.Generator(dev).manual_seed(3),
                                      n_samples=500, burn_in=100,
                                      record_fn=tempering.cold_chain)
    out["pt"] = occupancy(s_pt.cpu())
    print(f"PT (adapted ladder {np.round(torch.as_tensor(betas).cpu().numpy(), 3)}): "
          f"right-mode occupancy {out['pt']:.3f}")

    # 3. tempered SMC
    final, sinfo = smc.run(phi, prior, torch.Generator(dev).manual_seed(4), n_particles=4 * n,
                           mutation_steps=10, pcn_step=0.3)
    out.update(smc=occupancy(final.particles.cpu()), smc_stages=int(sinfo.n_stages),
               log_z=float(final.log_z))
    print(f"SMC ({out['smc_stages']} stages): right-mode occupancy {out['smc']:.3f}, "
          f"log Z = {out['log_z']:.3f}")

    if args.plot:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, axes = plt.subplots(1, 3, figsize=(12, 3), sharex=True)
        for ax, (x, title) in zip(axes, [(s_pcn, "plain pCN (stuck)"),
                                         (s_pt, "parallel tempering"),
                                         (final.particles, "tempered SMC")]):
            ax.hist(x.cpu().numpy().reshape(-1), bins=80, density=True)
            ax.set_title(title)
        fig.tight_layout()
        fig.savefig(args.plot, dpi=120)
        print(f"wrote {args.plot}")
    return out


if __name__ == "__main__":
    main()
