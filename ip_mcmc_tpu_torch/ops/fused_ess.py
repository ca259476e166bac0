"""Elliptical slice sampling, fused (K8; mirrors
``ip_mcmc_tpu/ops/fused_mcmc.py`` ``fused_ess_chain`` l.1250,
``fused_ess_chain_recorded`` l.1282 and ``_make_ess_step_builder`` l.680).

Tuning-free sampling of exp(−Φ)dμ₀ under a diagonal Gaussian prior. One
step draws ν ~ N(0, s²), a slice level log y = −Φ(pos) + log u and an
angle θ on a bracket of width 2π, then proposes (pos − m)·cos θ + ν·sin θ
+ m and shrinks the bracket towards 0 until −Φ(prop) > log y, at most
``max_shrink`` times. A chain that exhausts the budget stays put (θ → 0 is
always in the slice); the returned "acceptance" is the share of steps that
found a point within the budget. A NaN Φ(prop) never accepts.

For CUDA tensors the entry points launch a kernel of ``csrc/fused_ess.cu``,
as ``route`` says (``ess_route`` there decides):
``fused_ess_warp_kernel<RECORD>`` on what ``warp_takes``, a 16×16 Jacobi
``DarcyMisfit`` with d = 64 (one chain a warp, ``warp_geometry``'s chains
a CTA), and ``fused_ess_kernel<RECORD>`` on any other CG ``DarcyMisfit`` up
to 16×16 with K = d (one chain a CTA); the kernels refuse a larger grid and
the wrapper raises. A ``LinearGaussianPotential`` with K = d up to 256
(``_scaffold.linear_route``) runs on
``fused_ess_kernel<LinearGaussianPotential, RECORD>``, one chain a CTA
(``ipx_fused_ess_linear``); another d raises ``ValueError`` before any
launch. There a chain that is done leaves the shrink loop,
where the plain version (and the JAX kernel) evaluate every chain
``max_shrink`` times behind done masks: the masked evaluations change
nothing. For CPU tensors they run the step builder below on
``_scaffold.run_plain``. Tags: ν 0 (keys 0, 1), log y uniform 2, θ uniform
4, shrink draw k 16 + k.
"""

from __future__ import annotations

import ctypes

import torch

from ip_mcmc_tpu_torch.ops import _build, _scaffold, rng


# --- the plain version ------------------------------------------------------


def _make_ess_step_builder(max_shrink):
    def builder(pot, mean, scale):
        two_pi = torch.tensor(rng.TWO_PI, dtype=torch.float32)
        m = mean[:, None]

        def init(pos):
            return (pos, pot(pos))

        def step(carry, rand_n, rand_u):
            pos, phi = carry
            row = (1, pos.shape[1])
            nu = scale[:, None] * rand_n(pos.shape, 0)
            log_y = -phi + torch.log(rand_u(row, 2))[0]
            theta = two_pi * rand_u(row, 4)[0]
            lo, hi = theta - two_pi, theta
            done = torch.zeros(row[1], dtype=torch.bool, device=pos.device)
            centered = pos - m
            new_pos, new_phi = pos, phi
            for k in range(max_shrink):
                prop = (centered * torch.cos(theta)[None, :]
                        + nu * torch.sin(theta)[None, :] + m)
                phi_p = pot(prop)
                ok = (-phi_p > log_y) & (~done)
                new_pos = torch.where(ok[None, :], prop, new_pos)
                new_phi = torch.where(ok, phi_p, new_phi)
                done = done | ok
                # shrink the bracket toward 0 where still searching
                lo = torch.where(done | (theta >= 0.0), lo, theta)
                hi = torch.where(done | (theta < 0.0), hi, theta)
                u = rand_u(row, 16 + k)[0]
                theta = torch.where(done, theta, lo + (hi - lo) * u)
            return (new_pos, new_phi), done[None, :]

        return init, step

    return builder


def _run_plain(potential_fn, positions, prior_mean, prior_scale, seed,
               n_steps, max_shrink, block_chains, thin=None):
    """Plain twin of ``fused_ess_kernel``: (final (n, d), within-budget
    acceptance (n,)) and, when ``thin`` is given, samples."""
    _build.launch_counts[
        f"fused_ess_plain{'' if thin is None else '_recorded'}"] += 1
    final, acc, _, samples = _scaffold.run_plain(
        _make_ess_step_builder(int(max_shrink)), potential_fn, positions,
        [prior_mean, prior_scale], seed, n_steps, block_chains, thin,
    )
    return (final, acc) if thin is None else (final, acc, samples)


# --- the kernel -------------------------------------------------------------

# ``EssWarpDesign`` in ``csrc/fused_ess.cu``: chains (warps) a CTA at most.
# What it takes: a WARP_N² grid, d = K = WARP_D, Jacobi (no modes).
WARP_CHAINS = 16
WARP_N, WARP_D = 16, 64
# ``WarpSliceLevel`` in ``csrc/darcy_misfit.cuh`` pads the cells by 4 after
# every 32 in shared memory: the staged basis (d rows) and, a warp, pos and
# prop (d floats each) and the stencil's vector and face terms
PADDED_CELLS = WARP_N * WARP_N + 4 * WARP_N * WARP_N // 32
BASIS_BYTES = 4 * WARP_D * PADDED_CELLS
WARP_SLICE_BYTES = 4 * (2 * WARP_D + 3 * PADDED_CELLS)
MAX_SMEM_BYTES = 232_448  # what a CTA of the H100 may use
KERNEL = "fused_ess_warp_kernel"  # the launch count's stem
CTA_KERNEL = "fused_ess_kernel"  # the one-chain-a-CTA kernel's
LINEAR_KERNEL = "fused_ess_kernel[linear]"  # its instantiation on LinearGaussianPotential
CTA_N = 16  # the largest grid side the one-chain-a-CTA kernel takes (Layout16)


def warp_takes(*, n, d, K, precond, modes, solver):
    """Whether the warp kernel takes a misfit of these fields for chains of
    d coordinates, as ``ess_warp_takes`` in ``csrc/fused_ess.cu`` decides: a
    WARP_N² Jacobi CG misfit with d = K = WARP_D."""
    return (n, d, K, precond, modes, solver) == (WARP_N, WARP_D, WARP_D, "jacobi", 0, "cg")


def route(*, n, d, K, precond, modes, solver):
    """The kernel ``ipx_fused_ess`` sends a misfit of these fields to, as
    ``ess_route`` decides: "warp" for what ``warp_takes``, "cta" for any
    other CG misfit up to CTA_N² with K = d (up to its 256 threads), None
    (refused) above."""
    if warp_takes(n=n, d=d, K=K, precond=precond, modes=modes, solver=solver):
        return "warp"
    if _scaffold.cta_spec(n=n, K=K, precond=precond, modes=modes, solver=solver, d=d,
                          max_cells=CTA_N * CTA_N, max_d=CTA_N * CTA_N):
        return "cta"
    return None


def warp_geometry(n_chains, block_chains, *, n=WARP_N, d=WARP_D, precond="jacobi",
                  modes=0):
    """The kernel's launch: (CTAs, chains a CTA, dynamic shared-memory
    bytes), as ``ess_warp_geometry`` in ``csrc/fused_ess.cu`` computes it.
    Chains a CTA: the largest power of two up to WARP_CHAINS that divides
    ``block_chains``; a ragged last CTA runs spare warps. The bytes: the
    staged basis and a slice a warp (BASIS_BYTES, WARP_SLICE_BYTES).
    Raises ``ValueError`` for a grid, d or preconditioner the kernel does
    not take (``warp_takes``: the card runs it on another kernel or refuses
    it) and for shared memory the card cannot give a CTA."""
    if not warp_takes(n=n, d=d, K=d, precond=precond, modes=modes, solver="cg"):
        raise ValueError(
            f"the ESS kernel takes a {WARP_N}x{WARP_N} grid, d = {WARP_D} and the Jacobi "
            f"preconditioner; got {n}x{n}, d = {d}, {precond} with {modes} modes")
    if block_chains <= 0 or n_chains < 0:
        raise ValueError(f"n_chains {n_chains}, block_chains {block_chains}")
    w = WARP_CHAINS
    while block_chains % w:
        w //= 2
    smem = BASIS_BYTES + w * WARP_SLICE_BYTES
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"{smem} bytes of shared memory a CTA: the card gives "
                         f"{MAX_SMEM_BYTES}")
    return -(-n_chains // w), w, smem


def _launch(potential_fn, positions, prior_mean, prior_scale, seed, n_steps,
            max_shrink, block_chains, thin=None):
    family = _scaffold.require_family({"potential_fn": potential_fn},
                                      families=("darcy", "linear"))
    if family == "linear":
        _scaffold.require_linear_route("ESS", positions.shape[1], potential_fn)
    args, keep = _scaffold.chain_args(positions, prior_mean, prior_scale,
                                      seed, n_steps, block_chains, thin)
    U = keep[0].T.contiguous()
    potential_fn.check_input(U, "positions.T")
    phi0 = potential_fn(U)  # the step builder's init, by the misfit kernel
    spec = potential_fn.spec()
    lib = _build.library()
    if family == "linear":
        fn, stem = lib.ipx_fused_ess_linear, LINEAR_KERNEL
    else:
        kernel = route(**potential_fn.spec_fields, d=U.shape[0])
        fn, stem = lib.ipx_fused_ess, CTA_KERNEL if kernel == "cta" else KERNEL
    status = fn(
        ctypes.byref(spec), ctypes.byref(args), phi0.data_ptr(),
        int(max_shrink), torch.cuda.current_stream(U.device).cuda_stream,
    )
    name = _scaffold.kernel_name(stem, thin is not None)
    _build.check(status, name)
    _build.launch_counts[name] += 1
    _, _, _, out, acc, samples = keep
    return (out, acc) if thin is None else (out, acc, samples)


# --- entry points -----------------------------------------------------------


def fused_ess_chain(potential_fn, positions, prior_mean, prior_scale, seed,
                    n_steps=100, max_shrink=8, block_chains=256):
    """``n_steps`` of elliptical slice sampling. ``potential_fn``: (d, B) →
    (B,). Returns (final positions (n, d), within-budget acceptance per
    chain (n,))."""
    _scaffold.validate(positions, n_steps, block_chains)
    run = _scaffold.on_device(positions, _launch, _run_plain)
    return run(potential_fn, positions, prior_mean, prior_scale, seed,
               n_steps, max_shrink, block_chains)


def fused_ess_chain_recorded(potential_fn, positions, prior_mean, prior_scale,
                             seed, n_steps=100, thin=1, max_shrink=8,
                             block_chains=256):
    """Elliptical slice sampling recording every ``thin``-th state: (final
    positions, acceptance, samples (n_steps // thin, n, d))."""
    _scaffold.validate(positions, n_steps, block_chains, thin)
    run = _scaffold.on_device(positions, _launch, _run_plain)
    return run(potential_fn, positions, prior_mean, prior_scale, seed,
               n_steps, max_shrink, block_chains, thin=thin)
