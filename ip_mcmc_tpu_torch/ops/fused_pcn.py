"""Single-level pCN, fused: cold (K6) and warm-started (K7). Mirrors
``ip_mcmc_tpu/ops/fused_mcmc.py``: ``fused_pcn_chain`` l.1502,
``fused_pcn_chain_recorded`` l.1387 with ``_pcn_step_builder`` l.303;
``fused_pcn_chain_warm`` l.1313, ``fused_pcn_chain_warm_recorded`` l.1351
with ``_make_pcn_warm_step_builder`` l.486.

One step: prop = m + √(1 − β²)(pos − m) + β·s·ξ, accepted when
log u < Φ(pos) − Φ(prop) (a NaN Φ(prop) rejects). The warm form's
potential is ``pot(U, x0) -> (Φ, x)``: each chain carries the CG solution
of its current state (``aux_dim`` rows), the proposal's solve starts from
it, and x follows the accept/reject select. ``init`` solves from zeros, in
every launch: the carried x is not an output.

For CUDA tensors the entry points launch ``fused_pcn_kernel<Pot, RECORD>`` /
``fused_pcn_warm_kernel<RECORD>`` (``csrc/fused_pcn.cu``), the whole
``n_steps`` loop in one launch: the cold kernel on a ``DarcyMisfit`` or a
``BurgersMisfit`` (picked by the potential's family), the warm one on a
``DarcyMisfitWarm``; on a 64×64 grid the warm one is
``fused_pcn_warm_cluster_kernel<RECORD>`` and on a 32×32 grid
``fused_pcn_warm_cluster32_kernel<RECORD>``, whose thread-block clusters of
``_cluster.cluster_geometry``'s chains share each read of the factors.
For CPU tensors they run the step builders below on the plain scaffold
``_scaffold.run_plain``, with any features-first callable.
Tags: normals 0 (keys 0, 1), MH uniform 2.
"""

from __future__ import annotations

import ctypes

import torch

from ip_mcmc_tpu_torch.ops import _build, _scaffold

# --- the plain version ------------------------------------------------------


def _pcn_step_builder(pot, beta, mean, scale):
    contraction = torch.sqrt(1.0 - beta * beta)
    m = mean[:, None]

    def init(pos):
        return (pos, pot(pos))

    def step(carry, rand_n, rand_u):
        pos, phi = carry
        xi = scale[:, None] * rand_n(pos.shape, 0)
        prop = m + contraction * (pos - m) + beta * xi
        phi_prop = pot(prop)
        log_u = torch.log(rand_u((1, pos.shape[1]), 2))[0]
        accept = log_u < (phi - phi_prop)
        return (
            torch.where(accept[None, :], prop, pos),
            torch.where(accept, phi_prop, phi),
        ), accept[None, :]

    return init, step


def _make_pcn_warm_step_builder(aux_dim):
    def builder(pot, beta, mean, scale):
        contraction = torch.sqrt(1.0 - beta * beta)
        m = mean[:, None]

        def init(pos):
            x0 = torch.zeros((aux_dim, pos.shape[1]), dtype=pos.dtype,
                             device=pos.device)
            phi0, x0 = pot(pos, x0)
            return (pos, phi0, x0)

        def step(carry, rand_n, rand_u):
            pos, phi, x = carry
            xi = scale[:, None] * rand_n(pos.shape, 0)
            prop = m + contraction * (pos - m) + beta * xi
            phi_prop, x_prop = pot(prop, x)
            log_u = torch.log(rand_u((1, pos.shape[1]), 2))[0]
            accept = log_u < (phi - phi_prop)
            acc2 = accept[None, :]
            return (
                torch.where(acc2, prop, pos),
                torch.where(accept, phi_prop, phi),
                torch.where(acc2, x_prop, x),
            ), acc2

        return init, step

    return builder


def _run_plain(potential_fn, positions, prior_mean, prior_scale, beta, seed,
               n_steps, block_chains, thin=None, aux_dim=None):
    """Plain twin of the four kernels: (final (n, d), acceptance (n,)) and,
    when ``thin`` is given, samples (n_steps // thin, n, d). ``aux_dim``
    selects the warm step."""
    warm = aux_dim is not None
    _build.launch_counts[
        f"fused_pcn{'_warm' if warm else ''}_plain"
        f"{'' if thin is None else '_recorded'}"
    ] += 1
    builder = _make_pcn_warm_step_builder(aux_dim) if warm else _pcn_step_builder
    final, acc, _, samples = _scaffold.run_plain(
        builder, potential_fn, positions, [beta, prior_mean, prior_scale],
        seed, n_steps, block_chains, thin,
    )
    return (final, acc) if thin is None else (final, acc, samples)


# --- the kernels ------------------------------------------------------------


def _darcy_stem(pot, warm):
    """The launch count's name of the Darcy kernel: the warm one above
    16×16 runs in thread-block clusters (``_cluster``), on the 64×64 class
    and on the 32×32 class (which takes 32×32 only)."""
    if not warm:
        return "fused_pcn_kernel"
    if pot.n > 32:
        return "fused_pcn_warm_cluster_kernel"
    return "fused_pcn_warm_cluster32_kernel" if pot.n > 16 else "fused_pcn_warm_kernel"


def _launch(potential_fn, positions, prior_mean, prior_scale, beta, seed,
            n_steps, block_chains, thin=None, aux_dim=None):
    warm = aux_dim is not None
    family = _scaffold.require_family(
        {"potential_fn": potential_fn},
        families=("darcy",) if warm else ("darcy", "burgers"), warm=warm)
    if warm and aux_dim != potential_fn.aux_dim:
        raise ValueError(
            f"aux_dim {aux_dim} is not the misfit's {potential_fn.aux_dim}"
        )
    args, keep = _scaffold.chain_args(positions, prior_mean, prior_scale,
                                      seed, n_steps, block_chains, thin)
    U = keep[0].T.contiguous()
    potential_fn.check_input(U, "positions.T")
    # Φ (and x) at the start positions come from the standalone misfit
    # kernels (the Pallas step builders' init evaluates the potential; the
    # warm one from x0 = 0)
    if warm:
        phi0, x0 = potential_fn(U, torch.zeros(
            (aux_dim, U.shape[1]), dtype=torch.float32, device=U.device))
    else:
        phi0, x0 = potential_fn(U), None
    beta_t, contraction = _scaffold.contraction(beta)
    spec = potential_fn.spec()
    stream = torch.cuda.current_stream(U.device).cuda_stream
    lib = _build.library()
    # family -> (C entry point, kernel, its arguments after Φ0): the Darcy
    # entry takes the carried solution, null for the cold kernel
    fn, stem, carried = {
        "darcy": (lib.ipx_fused_pcn, _darcy_stem(potential_fn, warm),
                  (x0.data_ptr() if warm else None,)),
        "burgers": (lib.ipx_fused_pcn_burgers, "fused_pcn_burgers_kernel", ()),
    }[family]
    status = fn(
        ctypes.byref(spec), ctypes.byref(args), phi0.data_ptr(), *carried,
        float(beta_t), float(contraction), stream,
    )
    name = _scaffold.kernel_name(stem, thin is not None)
    _build.check(status, name)
    _build.launch_counts[name] += 1
    _, _, _, out, acc, samples = keep
    return (out, acc) if thin is None else (out, acc, samples)


def _run(potential_fn, positions, *args, **kw):
    return _scaffold.on_device(positions, _launch, _run_plain)(
        potential_fn, positions, *args, **kw)


# --- entry points -----------------------------------------------------------


def fused_pcn_chain(potential_fn, positions, prior_mean, prior_scale, beta,
                    seed, n_steps=100, block_chains=256):
    """``n_steps`` of pCN with a diagonal (KL-coordinate) Gaussian prior.
    ``potential_fn``: (d, B) → (B,). Returns (final positions (n, d),
    acceptance rate per chain (n,))."""
    _scaffold.validate(positions, n_steps, block_chains)
    return _run(potential_fn, positions, prior_mean, prior_scale, beta, seed,
                n_steps, block_chains)


def fused_pcn_chain_recorded(potential_fn, positions, prior_mean, prior_scale,
                             beta, seed, n_steps=100, thin=1,
                             block_chains=256):
    """pCN recording every ``thin``-th state: (final positions, acceptance
    rate, samples (n_steps // thin, n, d))."""
    _scaffold.validate(positions, n_steps, block_chains, thin)
    return _run(potential_fn, positions, prior_mean, prior_scale, beta, seed,
                n_steps, block_chains, thin=thin)


def fused_pcn_chain_warm(potential_fn, positions, prior_mean, prior_scale,
                         beta, seed, n_steps=100, aux_dim=None,
                         block_chains=256):
    """Warm-started pCN: ``potential_fn(U, x0) -> (Φ, x)`` carries a
    per-chain (aux_dim, B) solver state (the Darcy CG solution of
    ``DarcyMisfitWarm``). Returns (final positions, acceptance rate)."""
    if aux_dim is None:
        raise ValueError("fused_pcn_chain_warm requires aux_dim (solver rows)")
    _scaffold.validate(positions, n_steps, block_chains)
    return _run(potential_fn, positions, prior_mean, prior_scale, beta, seed,
                n_steps, block_chains, aux_dim=aux_dim)


def fused_pcn_chain_warm_recorded(potential_fn, positions, prior_mean,
                                  prior_scale, beta, seed, n_steps=100, thin=1,
                                  aux_dim=None, block_chains=256):
    """Warm-started pCN recording every ``thin``-th state."""
    if aux_dim is None:
        raise ValueError("fused_pcn_chain_warm_recorded requires aux_dim")
    _scaffold.validate(positions, n_steps, block_chains, thin)
    return _run(potential_fn, positions, prior_mean, prior_scale, beta, seed,
                n_steps, block_chains, thin=thin, aux_dim=aux_dim)
