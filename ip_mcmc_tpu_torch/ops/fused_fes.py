"""The functional ensemble sampler, fused (K9; mirrors
``ip_mcmc_tpu/ops/fused_mcmc.py`` ``fused_fes_chain`` l.1105,
``fused_fes_chain_recorded`` l.1148 and ``_make_fes_step_builder`` l.571;
``choose_n_low_modes`` lives in ``kernels/ensemble.py``, as in JAX).

Each block of ``block_chains`` chains is one walker ensemble. One step, in
whitened coordinates w = (pos − m)/s: two red-black sub-steps, in which the
chains of one lane parity make the affine stretch move w' = partner +
z·(w − partner) on the first ``n_low_modes`` rows, z = ((a − 1)u + 1)²/a,
against the chain ``shift`` lanes before them (an odd shift, drawn once per
block and sub-step, so the partner has the other parity and stands still),
accepted with log ratio (M − 1)·log z − (Φ' − Φ) − ½Σ_{rows<M}(w'² − w²);
then pCN on the other rows. Returns the pCN move's acceptance and, third,
the stretch move's (both sub-steps count, the steps divide).

For CUDA tensors the entry points launch a kernel of ``csrc/fused_fes.cu``,
as ``route`` says (``fes_route`` there decides): ``fused_fes_warp_kernel<RECORD>``
on what ``warp_takes``, a 16×16 Jacobi ``DarcyMisfit`` with d = 64 (one
chain a warp, ``warp_geometry``'s chains a CTA), and
``fused_fes_kernel<RECORD>`` on any other CG ``DarcyMisfit`` up to 16×16
with K = d (one chain a CTA); the kernels refuse a larger grid and the
wrapper raises. A ``LinearGaussianPotential`` with K = d up to 256
(``_scaffold.linear_route``) runs on
``fused_fes_kernel<LinearGaussianPotential, RECORD>``, one chain a CTA
(``ipx_fused_fes_linear``); another d raises ``ValueError`` before any
launch. A chain reads other chains of its block
there, so the state lives in device memory and the step loop is here: two
launches per step, each running the chains of one parity, stream order
being the barrier between the sub-steps. A chain is evaluated only in its own parity's sub-step (the
JAX kernel evaluates every lane in both behind the parity mask, 3 misfit
calls per step; here 2 per chain and step: a masked lane can never accept,
and the counter RNG needs no draws consumed). For CPU tensors they run the
step builder below on ``_scaffold.run_plain``, all three evaluations as in
JAX. Tags: shift 32 / 40, z 34 / 42, stretch MH 36 / 44, pCN normals 48
(keys 48, 49), pCN MH 52.
"""

from __future__ import annotations

import ctypes

import torch

from ip_mcmc_tpu_torch.kernels.ensemble import choose_n_low_modes  # noqa: F401
from ip_mcmc_tpu_torch.ops import _build, _scaffold, fused_ess


def _check_block(block_chains):
    if block_chains % 2:
        raise ValueError(
            f"block_chains {block_chains} must be even: the red-black scheme "
            "relies on an odd lane shift landing on the opposite parity"
        )


# --- the plain version ------------------------------------------------------


def _make_fes_step_builder(n_low_modes, stretch_a, block_chains):
    M, a, bc = int(n_low_modes), float(stretch_a), int(block_chains)

    def builder(pot, pcn_beta, mean, scale):
        contraction = torch.sqrt(1.0 - pcn_beta * pcn_beta)
        m, s = mean[:, None], scale[:, None]

        def init(pos):
            n = pos.shape[1]
            return (pos, pot(pos),
                    torch.zeros((1, n), dtype=torch.float32, device=pos.device),
                    0.0)

        def step(carry, rand_n, rand_u):
            pos, phi, st_acc, cnt = carry
            d, n = pos.shape
            low = (torch.arange(d, device=pos.device) < M)[:, None]
            chain = torch.arange(n, device=pos.device)
            lane = chain % bc
            w = (pos - m) / s

            for sub, tag0 in ((0, 32), (1, 40)):
                u_s = rand_u((1, 1), tag0)[0]  # the block's draw, per chain
                shift = torch.floor(u_s * (bc // 2)).to(torch.int64) * 2 + 1
                # lane i reads lane i − shift of its block (a roll by shift)
                partner = w[:, chain - lane + (lane - shift) % bc]
                uz = rand_u((1, n), tag0 + 2)[0]
                z = torch.square((a - 1.0) * uz + 1.0) / a  # g(z) ∝ 1/√z
                w_prop = torch.where(low, partner + z[None, :] * (w - partner), w)
                phi_p = pot(m + s * w_prop)
                d_prior = 0.5 * torch.sum(
                    low * (torch.square(w_prop) - torch.square(w)), dim=0)
                log_ratio = (M - 1) * torch.log(z) - (phi_p - phi) - d_prior
                log_ratio = torch.where(
                    torch.isnan(log_ratio),
                    torch.full_like(log_ratio, -torch.inf), log_ratio)
                log_u = torch.log(rand_u((1, n), tag0 + 4)[0])
                acc = (lane % 2 == sub) & (log_u < log_ratio)
                # each lane is attempted in exactly one of the two subs
                st_acc = st_acc + acc[None, :].to(torch.float32)
                w = torch.where(acc[None, :], w_prop, w)
                phi = torch.where(acc, phi_p, phi)

            # pCN on the complement rows (prior-reversible: only Φ enters)
            xi = rand_n((d, n), 48)
            w_prop = torch.where(low, w, contraction * w + pcn_beta * xi)
            phi_p = pot(m + s * w_prop)
            log_u = torch.log(rand_u((1, n), 52)[0])
            acc = log_u < (phi - phi_p)
            w = torch.where(acc[None, :], w_prop, w)
            phi = torch.where(acc, phi_p, phi)
            return (m + s * w, phi, st_acc, cnt + 1.0), acc[None, :]

        return init, step

    # stretch-move acceptance per chain (the main channel reports the pCN
    # complement move)
    builder.extra_out = lambda carry: carry[2][0] / max(carry[3], 1.0)
    return builder


def _run_plain(potential_fn, positions, prior_mean, prior_scale, n_low_modes,
               seed, pcn_beta, stretch_a, n_steps, block_chains, thin=None):
    """Plain twin of ``fused_fes_warp_kernel``: (final (n, d), pCN acceptance
    (n,), stretch acceptance (n,)); with ``thin``, samples in third place
    as from the JAX recorded entry point."""
    _build.launch_counts[
        f"fused_fes_plain{'' if thin is None else '_recorded'}"] += 1
    final, acc, stretch, samples = _scaffold.run_plain(
        _make_fes_step_builder(n_low_modes, stretch_a, block_chains),
        potential_fn, positions, [pcn_beta, prior_mean, prior_scale], seed,
        n_steps, block_chains, thin,
    )
    return (final, acc, stretch) if thin is None else (final, acc, samples)


# --- the kernel -------------------------------------------------------------

# ``FesWarpDesign`` in ``csrc/fused_fes.cu``: chains (warps) a CTA at most.
# What it takes: a WARP_N² grid, d = K = WARP_D, Jacobi (no modes); its
# solve is elliptical slice sampling's (``fused_ess``: the staged basis and
# a warp's slice, here without pos)
WARP_CHAINS = 16
WARP_N, WARP_D = fused_ess.WARP_N, fused_ess.WARP_D
BASIS_BYTES = fused_ess.BASIS_BYTES
WARP_SLICE_BYTES = fused_ess.WARP_SLICE_BYTES - 4 * WARP_D
MAX_SMEM_BYTES = fused_ess.MAX_SMEM_BYTES
KERNEL = "fused_fes_warp_kernel"  # the launch count's stem
CTA_KERNEL = "fused_fes_kernel"  # the one-chain-a-CTA kernel's
LINEAR_KERNEL = "fused_fes_kernel[linear]"  # its instantiation on LinearGaussianPotential


def warp_takes(*, n, d, K, precond, modes, solver):
    """Whether the warp kernel takes a misfit of these fields for chains of
    d coordinates, as ``fes_warp_takes`` in ``csrc/fused_fes.cu`` decides:
    elliptical slice sampling's (``fused_ess.warp_takes``)."""
    return fused_ess.warp_takes(n=n, d=d, K=K, precond=precond, modes=modes, solver=solver)


def route(*, n, d, K, precond, modes, solver):
    """The kernel ``ipx_fused_fes`` sends a misfit of these fields to, as
    ``fes_route`` decides: elliptical slice sampling's rule
    (``fused_ess.route``): "warp", "cta" or None."""
    return fused_ess.route(n=n, d=d, K=K, precond=precond, modes=modes, solver=solver)


def warp_geometry(n_chains, block_chains, *, n=WARP_N, d=WARP_D,
                  precond="jacobi", modes=0):
    """A launch of the kernel, which runs the ``n_chains // 2`` chains of
    one parity: (CTAs, chains a CTA, dynamic shared-memory bytes), as
    ``fes_warp_geometry`` in ``csrc/fused_fes.cu`` computes it. Chains a
    CTA: the largest power of two up to WARP_CHAINS that divides
    ``block_chains``; a ragged last CTA runs spare warps. Raises
    ``ValueError`` for a grid, d or preconditioner the kernel does not
    take (``warp_takes``), for an odd ``block_chains`` or a ragged last
    ensemble."""
    if not warp_takes(n=n, d=d, K=d, precond=precond, modes=modes, solver="cg"):
        raise ValueError(
            f"the ensemble kernel takes a {WARP_N}x{WARP_N} grid, d = {WARP_D} and the "
            f"Jacobi preconditioner; got {n}x{n}, d = {d}, {precond} with {modes} modes")
    if block_chains <= 0 or block_chains % 2 or n_chains < 0 or n_chains % block_chains:
        raise ValueError(f"n_chains {n_chains}, block_chains {block_chains}: whole "
                         "ensembles of an even block_chains")
    w = WARP_CHAINS
    while block_chains % w:
        w //= 2
    smem = BASIS_BYTES + w * WARP_SLICE_BYTES
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"{smem} bytes of shared memory a CTA: the card gives "
                         f"{MAX_SMEM_BYTES}")
    return -(-(n_chains // 2) // w), w, smem


def _launch(potential_fn, positions, prior_mean, prior_scale, n_low_modes,
            seed, pcn_beta, stretch_a, n_steps, block_chains, thin=None):
    family = _scaffold.require_family({"potential_fn": potential_fn},
                                      families=("darcy", "linear"))
    if family == "linear":
        _scaffold.require_linear_route("ensemble", positions.shape[1], potential_fn)
    # the chain's state: updated in place by every launch
    state = positions.clone(memory_format=torch.contiguous_format)
    args, keep = _scaffold.chain_args(state, prior_mean, prior_scale, seed,
                                      n_steps, block_chains, thin,
                                      in_place=True)
    n, d = state.shape
    if not 0 <= int(n_low_modes) <= d:
        raise ValueError(f"n_low_modes {n_low_modes} outside [0, {d}]")
    U = state.T.contiguous()
    potential_fn.check_input(U, "positions.T")
    phi = potential_fn(U)  # the step builder's init, by the misfit kernel
    pcn_acc = torch.zeros(n, dtype=torch.float32, device=state.device)
    st_acc = torch.zeros_like(pcn_acc)
    samples = keep[5]
    beta_t, contraction = _scaffold.contraction(pcn_beta)
    spec = potential_fn.spec()
    lib = _build.library()
    stream = torch.cuda.current_stream(state.device).cuda_stream
    if family == "linear":
        fes, stem = lib.ipx_fused_fes_linear, LINEAR_KERNEL
    else:
        fes = lib.ipx_fused_fes
        stem = CTA_KERNEL if route(**potential_fn.spec_fields, d=d) == "cta" else KERNEL
    for i in range(n_steps):
        record = None
        if thin is not None and (i + 1) % thin == 0:
            record = samples[(i + 1) // thin - 1].data_ptr()
        name = _scaffold.kernel_name(stem, record is not None)
        for sub in (0, 1):  # stream order is the barrier between them
            status = fes(
                ctypes.byref(spec), ctypes.byref(args), phi.data_ptr(),
                pcn_acc.data_ptr(), st_acc.data_ptr(), record, float(beta_t),
                float(contraction), float(stretch_a), int(n_low_modes), i, sub,
                stream,
            )
            _build.check(status, name)
            _build.launch_counts[name] += 1
    # the counts as rates: the kernel's acc / n_steps and extra_out
    acc = pcn_acc / n_steps
    if thin is not None:
        return state, acc, samples
    return state, acc, st_acc / max(n_steps, 1)


# --- entry points -----------------------------------------------------------


def fused_fes_chain(potential_fn, positions, prior_mean, prior_scale,
                    n_low_modes, seed, pcn_beta=0.2, stretch_a=2.0,
                    n_steps=100, block_chains=256):
    """``n_steps`` of the functional ensemble sampler: stretch moves on the
    first ``n_low_modes`` whitened coordinates, pCN on the rest; each block
    of ``block_chains`` chains is one interacting ensemble.
    ``potential_fn``: (d, B) → (B,). Returns (final positions (n, d), pCN
    acceptance per chain (n,), stretch acceptance per chain (n,))."""
    _check_block(block_chains)
    _scaffold.validate(positions, n_steps, block_chains)
    run = _scaffold.on_device(positions, _launch, _run_plain)
    return run(potential_fn, positions, prior_mean, prior_scale, n_low_modes,
               seed, pcn_beta, stretch_a, n_steps, block_chains)


def fused_fes_chain_recorded(potential_fn, positions, prior_mean, prior_scale,
                             n_low_modes, seed, pcn_beta=0.2, stretch_a=2.0,
                             n_steps=100, thin=1, block_chains=256):
    """The ensemble sampler recording every ``thin``-th state: (final
    positions, pCN acceptance, samples (n_steps // thin, n, d))."""
    _check_block(block_chains)
    _scaffold.validate(positions, n_steps, block_chains, thin)
    run = _scaffold.on_device(positions, _launch, _run_plain)
    return run(potential_fn, positions, prior_mean, prior_scale, n_low_modes,
               seed, pcn_beta, stretch_a, n_steps, block_chains, thin=thin)
