"""pCN with a dense Gaussian prior N(m, L Lᵀ), fused (K15; mirrors
``ip_mcmc_tpu/ops/fused_mcmc.py``: ``fused_pcn_chain_dense`` l.1186,
``fused_pcn_chain_dense_recorded`` l.1218 with ``_pcn_dense_step_builder``
l.653).

One step: ξ = L z, prop = m + √(1 − β²)(pos − m) + β·ξ, accepted when
log u < Φ(pos) − Φ(prop) (a NaN Φ(prop) rejects). ``prior_chol`` is the
lower Cholesky factor of the prior covariance.

For CUDA tensors the entry points launch one kernel for the whole
``n_steps`` loop (``csrc/fused_pcn_dense.cu``) on a
``LinearGaussianPotential``, the product L z written out in the kernel:
``fused_pcn_dense_group_kernel<RECORD, d, G>`` (a chain on each group of G
= d lanes, a warp at d = 32) for what ``_gaussian_group.takes`` (d = 2 or
32, m ≤ d: the lingauss_pcn target), else ``fused_pcn_dense_kernel<Pot,
RECORD>``, one chain a CTA; for CPU tensors they run the
step builder below on ``_scaffold.run_plain``, with any features-first
callable. Tags: normals 0 (keys 0, 1), MH uniform 2.
"""

from __future__ import annotations

import ctypes

import torch

from ip_mcmc_tpu_torch.ops import _build, _gaussian_group, _scaffold

# --- the plain version ------------------------------------------------------


def _pcn_dense_step_builder(pot, beta, mean, chol):
    contraction = torch.sqrt(1.0 - beta * beta)
    m = mean[:, None]

    def init(pos):
        return (pos, pot(pos))

    def step(carry, rand_n, rand_u):
        pos, phi = carry
        xi = chol @ rand_n(pos.shape, 0)
        prop = m + contraction * (pos - m) + beta * xi
        phi_prop = pot(prop)
        log_u = torch.log(rand_u((1, pos.shape[1]), 2))[0]
        accept = log_u < (phi - phi_prop)
        return (
            torch.where(accept[None, :], prop, pos),
            torch.where(accept, phi_prop, phi),
        ), accept[None, :]

    return init, step


def _run_plain(potential_fn, positions, prior_mean, prior_chol, beta, seed,
               n_steps, block_chains, thin=None):
    """Plain twin of ``fused_pcn_dense_kernel``: (final (n, d), acceptance
    (n,)) and, when ``thin`` is given, samples (n_steps // thin, n, d)."""
    _build.launch_counts[
        f"fused_pcn_dense_plain{'' if thin is None else '_recorded'}"] += 1
    final, acc, _, samples = _scaffold.run_plain(
        _pcn_dense_step_builder, potential_fn, positions,
        [beta, prior_mean, prior_chol], seed, n_steps, block_chains, thin,
    )
    return (final, acc) if thin is None else (final, acc, samples)


# --- the kernel -------------------------------------------------------------


def stem(potential_fn, d) -> str:
    """The launch count's stem of the kernel that the card runs for the
    linear-Gaussian ``potential_fn`` and chains of d coordinates:
    ``fused_pcn_dense_group_kernel`` for what ``_gaussian_group.takes``,
    else ``fused_pcn_dense_kernel``."""
    return ("fused_pcn_dense_group_kernel"
            if _gaussian_group.takes(d, potential_fn.m, potential_fn.K)
            else "fused_pcn_dense_kernel")


def _launch(potential_fn, positions, prior_mean, prior_chol, beta, seed,
            n_steps, block_chains, thin=None):
    _scaffold.require_family({"potential_fn": potential_fn},
                             families=("linear",))
    d = positions.shape[1]
    # the scaffold's per-coordinate scale does not enter this step: ones
    args, keep = _scaffold.chain_args(positions, prior_mean, torch.ones(d),
                                      seed, n_steps, block_chains, thin)
    potential_fn.check_input(keep[0].T, "positions.T")
    chol = _scaffold.as_param(prior_chol, positions.device)
    if chol.shape != (d, d):
        raise ValueError(f"prior_chol must have shape ({d}, {d})")
    chol_t = chol.T.contiguous()  # the kernel reads L column by column
    beta_t, contraction = _scaffold.contraction(beta)
    spec = potential_fn.spec()
    status = _build.library().ipx_fused_pcn_dense(
        ctypes.byref(spec), ctypes.byref(args), chol_t.data_ptr(), float(beta_t),
        float(contraction), torch.cuda.current_stream(positions.device).cuda_stream,
    )
    name = _scaffold.kernel_name(stem(potential_fn, d), thin is not None)
    _build.check(status, name)
    _build.launch_counts[name] += 1
    _, _, _, out, acc, samples = keep
    return (out, acc) if thin is None else (out, acc, samples)


# --- entry points -----------------------------------------------------------


def fused_pcn_chain_dense(potential_fn, positions, prior_mean, prior_chol, beta,
                          seed, n_steps=100, block_chains=256):
    """``n_steps`` of pCN with the dense prior N(prior_mean, L Lᵀ).
    ``potential_fn``: (d, B) → (B,). Returns (final positions (n, d),
    acceptance rate per chain (n,))."""
    _scaffold.validate(positions, n_steps, block_chains)
    return _scaffold.on_device(positions, _launch, _run_plain)(
        potential_fn, positions, prior_mean, prior_chol, beta, seed, n_steps,
        block_chains)


def fused_pcn_chain_dense_recorded(potential_fn, positions, prior_mean,
                                   prior_chol, beta, seed, n_steps=100, thin=1,
                                   block_chains=256):
    """Dense-prior pCN recording every ``thin``-th state: (final positions,
    acceptance rate, samples (n_steps // thin, n, d))."""
    _scaffold.validate(positions, n_steps, block_chains, thin)
    return _scaffold.on_device(positions, _launch, _run_plain)(
        potential_fn, positions, prior_mean, prior_chol, beta, seed, n_steps,
        block_chains, thin=thin)
