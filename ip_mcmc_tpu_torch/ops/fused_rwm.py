"""Random-walk Metropolis, fused (K14; mirrors
``ip_mcmc_tpu/ops/fused_mcmc.py``: ``fused_rwm_chain`` l.1419,
``fused_rwm_chain_recorded`` l.1483 with ``_rwm_step_builder`` l.284).

One step: prop = pos + step_size·ξ, accepted when log u < Φ(pos) − Φ(prop)
(a NaN Φ(prop) rejects). Without a prior the potential is used as given
(the JAX signature). ``prior_mean`` / ``prior_scale`` make the target
Φ + ½‖(U − μ)/s‖²: that is how the runner's fused RWM branch targets
misfit + whitened prior (``ip_mcmc_tpu/runner.py`` l.637), the prior added
in the step rather than folded into the potential.

For CUDA tensors the entry points launch one kernel for the whole
``n_steps`` loop (``csrc/fused_rwm.cu``): on a ``LinearGaussianPotential``
that ``_gaussian_group.takes`` (d = 2 or 32, m ≤ d: the shipped targets)
``fused_rwm_group_kernel<RECORD, d, G>``, a chain on each group of G = d
lanes; on any other linear-Gaussian spec ``fused_rwm_kernel<Pot, RECORD>``,
one chain a CTA; on a ``DarcyMisfit`` ``fused_rwm_darcy_kernel`` (picked
by the potential's family and spec). For CPU tensors they run the step
builder below on the plain scaffold ``_scaffold.run_plain``, with any
features-first callable. Tags: normals 0 (keys 0, 1), MH uniform 2.
"""

from __future__ import annotations

import ctypes

import torch

from ip_mcmc_tpu_torch.ops import _build, _gaussian_group, _scaffold

# --- the plain version ------------------------------------------------------


def _rwm_step_builder(pot, step_size):
    def init(pos):
        return (pos, pot(pos))

    def step(carry, rand_n, rand_u):
        pos, phi = carry
        prop = pos + step_size * rand_n(pos.shape, 0)
        phi_prop = pot(prop)
        log_u = torch.log(rand_u((1, pos.shape[1]), 2))[0]
        accept = log_u < (phi - phi_prop)
        return (
            torch.where(accept[None, :], prop, pos),
            torch.where(accept, phi_prop, phi),
        ), accept[None, :]

    return init, step


def _with_prior(potential_fn, prior_mean, prior_scale):
    """Φ + ½‖(U − μ)/s‖² for a features-first (d, B) batch."""
    def phi_full(U):
        m = _scaffold.as_param(prior_mean, U.device)[:, None]
        s = _scaffold.as_param(prior_scale, U.device)[:, None]
        z = (U - m) / s
        return potential_fn(U) + 0.5 * torch.sum(z * z, dim=0)

    return phi_full


def _run_plain(potential_fn, positions, step_size, seed, n_steps, block_chains,
               thin=None, prior_mean=None, prior_scale=None):
    """Plain twin of ``fused_rwm_kernel``: (final (n, d), acceptance (n,))
    and, when ``thin`` is given, samples (n_steps // thin, n, d)."""
    _build.launch_counts[
        f"fused_rwm_plain{'' if thin is None else '_recorded'}"] += 1
    if prior_mean is not None:
        potential_fn = _with_prior(potential_fn, prior_mean, prior_scale)
    final, acc, _, samples = _scaffold.run_plain(
        _rwm_step_builder, potential_fn, positions, [step_size], seed, n_steps,
        block_chains, thin,
    )
    return (final, acc) if thin is None else (final, acc, samples)


# --- the kernel -------------------------------------------------------------


def stem(potential_fn, d) -> str:
    """The launch count's stem of the kernel that the card runs for
    ``potential_fn`` and chains of d coordinates: ``fused_rwm_group_kernel``
    for a linear-Gaussian spec that ``_gaussian_group.takes``,
    ``fused_rwm_kernel`` for any other, ``fused_rwm_darcy_kernel`` for a
    ``DarcyMisfit``."""
    family = _scaffold.require_family({"potential_fn": potential_fn},
                                      families=("darcy", "linear"))
    if family == "darcy":
        return "fused_rwm_darcy_kernel"
    return ("fused_rwm_group_kernel" if _gaussian_group.takes(d, potential_fn.m, potential_fn.K)
            else "fused_rwm_kernel")


def _launch(potential_fn, positions, step_size, seed, n_steps, block_chains,
            thin=None, prior_mean=None, prior_scale=None):
    family = _scaffold.require_family({"potential_fn": potential_fn},
                                      families=("darcy", "linear"))
    d = positions.shape[1]
    prior = prior_mean is not None
    if not prior:  # the scaffold's mean / scale, unread by the step
        prior_mean, prior_scale = torch.zeros(d), torch.ones(d)
    args, keep = _scaffold.chain_args(positions, prior_mean, prior_scale,
                                      seed, n_steps, block_chains, thin)
    potential_fn.check_input(keep[0].T, "positions.T")
    spec = potential_fn.spec()
    lib = _build.library()
    fn = lib.ipx_fused_rwm if family == "linear" else lib.ipx_fused_rwm_darcy
    status = fn(ctypes.byref(spec), ctypes.byref(args), float(step_size),
                int(prior), torch.cuda.current_stream(positions.device).cuda_stream)
    name = _scaffold.kernel_name(stem(potential_fn, d), thin is not None)
    _build.check(status, name)
    _build.launch_counts[name] += 1
    _, _, _, out, acc, samples = keep
    return (out, acc) if thin is None else (out, acc, samples)


def _run(potential_fn, positions, *args, prior_mean=None, prior_scale=None,
         **kw):
    if (prior_mean is None) != (prior_scale is None):
        raise ValueError("give both prior_mean and prior_scale, or neither")
    return _scaffold.on_device(positions, _launch, _run_plain)(
        potential_fn, positions, *args, prior_mean=prior_mean,
        prior_scale=prior_scale, **kw)


# --- entry points -----------------------------------------------------------


def fused_rwm_chain(potential_fn, positions, step_size, seed, n_steps=100,
                    block_chains=256, prior_mean=None, prior_scale=None):
    """``n_steps`` of random-walk Metropolis on exp(−potential), with the
    prior ½‖(U − μ)/s‖² added when ``prior_mean`` / ``prior_scale`` are
    given. ``potential_fn``: (d, B) → (B,). Returns (final positions (n, d),
    acceptance rate per chain (n,))."""
    _scaffold.validate(positions, n_steps, block_chains)
    return _run(potential_fn, positions, step_size, seed, n_steps, block_chains,
                prior_mean=prior_mean, prior_scale=prior_scale)


def fused_rwm_chain_recorded(potential_fn, positions, step_size, seed,
                             n_steps=100, thin=1, block_chains=256,
                             prior_mean=None, prior_scale=None):
    """RWM recording every ``thin``-th state: (final positions, acceptance
    rate, samples (n_steps // thin, n, d))."""
    _scaffold.validate(positions, n_steps, block_chains, thin)
    return _run(potential_fn, positions, step_size, seed, n_steps, block_chains,
                thin=thin, prior_mean=prior_mean, prior_scale=prior_scale)
