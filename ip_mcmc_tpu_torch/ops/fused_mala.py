"""MALA, fused: with the adjoint gradient from cold solves (K10) and with
both solves warm-started (K11). Mirrors ``ip_mcmc_tpu/ops/fused_mcmc.py``:
``fused_mala_chain`` l.1439, ``fused_mala_chain_recorded`` l.1462 with
``_mala_step_builder`` l.784; ``fused_mala_chain_warm`` l.1028,
``fused_mala_chain_warm_recorded`` l.1068 with
``_make_mala_warm_step_builder`` l.732.

One step: prop = pos − ε²/2·g + ε·ξ, (φ', g') at prop, log ratio
(φ − φ') + log q(pos | prop) − log q(prop | pos) with NaN mapped to −∞,
accepted when log u < log ratio. The target is the full posterior: φ is the
misfit plus the whitened prior's ½‖(u − m)/s‖².

The cold form differs from JAX's in one argument. There the caller hands in
a closure that already adds the prior, and the kernel differentiates it. A
CUDA kernel cannot inline a closure, so ``fused_mala_chain`` takes the
misfit and, as ``prior_mean`` / ``prior_scale``, the prior to fold in
(required, on the CPU as on the card). The warm form's potential is
``pag(U, aux) -> (Φ, ∇Φ, aux)`` with the forward and the adjoint CG
solution carried (``aux_dim`` rows per chain); its prior is
folded in by the step builder, as in JAX. ``init`` solves from zeros in
every launch: the carried aux is not an output, and the chain is weakly
non-Markov through it, by design.

For CUDA tensors the entry points launch a kernel of ``csrc/fused_mala.cu``,
the whole ``n_steps`` loop in one launch, as ``route`` says (``mala_route``
there decides): ``fused_mala_warp_kernel<RECORD, PRECOND>`` on what
``warp_takes``, one chain a warp, ``warp_geometry``'s chains a CTA: the
cold form on a 16×16 Jacobi CG ``DarcyMisfit``, the warm one on a 16×16
dense-``dst`` CG ``DarcyMisfitMalaWarm``, both with d = K = 64; and
``fused_mala_kernel<RECORD>`` / ``fused_mala_warm_kernel<RECORD>``, one
chain a CTA, on any other CG misfit up to 16×16 with K = d, any
preconditioner. A larger grid raises ``ValueError`` before any launch. The
cold form also takes a ``LinearGaussianPotential`` with K = d up to 256
(``_scaffold.linear_route``): ``fused_mala_kernel<LinearGaussianPotential,
RECORD>``, one chain a CTA, its gradient −Aᵀ((y − A(u − c))/σ²) a thread a
coordinate, Φ0 and ∇Φ0 from ``LinearGaussianPotential.value_and_grad``
(``linear_gaussian_misfit_grad_kernel``); another d raises ``ValueError``.
For CPU tensors they run the step builders below on the
plain scaffold ``_scaffold.run_plain``, which take every misfit; the cold
one takes any differentiable features-first callable (a ``DarcyMisfit``
differentiates by its adjoint). Tags: normals 0 (keys 0, 1), MH uniform 2.

``misfit_grad_warp_takes`` and ``misfit_grad_warp_geometry`` mirror the
rule and the launch geometry of ``darcy_misfit_grad_warp_kernel``, which
evaluates Φ and ∇Φ at the cold kernel's start positions a draw a warp on
its solve (``models.darcy.DarcyMisfit.value_and_grad`` launches it);
``misfit_grad_warm_warp_takes`` and ``misfit_grad_warm_warp_geometry`` those
of ``darcy_misfit_grad_warm_warp_kernel``, the same for the warm kernel
(Φ, ∇Φ and the two solutions from aux0, a draw a warp on its solve;
``models.darcy.DarcyMisfitMalaWarm`` launches it).
"""

from __future__ import annotations

import ctypes

import torch

from ip_mcmc_tpu_torch.ops import _build, _scaffold, fused_da_pcn

# --- the plain versions -----------------------------------------------------


def _mala_transition(full, carry, rand_n, rand_u, eps):
    """One MALA step on ``carry`` = (pos, φ, g, *rest); ``full(prop, *rest)
    -> (φ', g', *rest')``."""
    pos, phi, g, *rest = carry
    xi = rand_n(pos.shape, 0)
    half_eps2 = 0.5 * eps * eps
    mean_fwd = pos - half_eps2 * g  # ∇log π = −∇φ
    prop = mean_fwd + eps * xi
    phi_p, g_p, *rest_p = full(prop, *rest)
    mean_rev = prop - half_eps2 * g_p
    inv2e2 = 1.0 / (2.0 * eps * eps)
    d_rev = pos - mean_rev
    log_q_rev = -torch.sum(d_rev * d_rev, dim=0) * inv2e2
    log_q_fwd = -torch.sum(xi * xi, dim=0) * 0.5  # ‖prop − mean_fwd‖² = ε²‖ξ‖²
    log_ratio = (phi - phi_p) + log_q_rev - log_q_fwd
    log_ratio = torch.where(torch.isnan(log_ratio),
                            torch.full_like(log_ratio, -torch.inf), log_ratio)
    log_u = torch.log(rand_u((1, pos.shape[1]), 2))[0]
    accept = log_u < log_ratio
    acc2 = accept[None, :]
    return (
        torch.where(acc2, prop, pos),
        torch.where(accept, phi_p, phi),
        torch.where(acc2, g_p, g),
        *(torch.where(acc2, new, old) for new, old in zip(rest_p, rest)),
    ), acc2


def _mala_step_builder(pot_and_grad, step_size):
    """``pot_and_grad(x) -> (φ, ∇φ)`` of the full target."""

    def init(pos):
        phi, g = pot_and_grad(pos)
        return (pos, phi, g)

    def step(carry, rand_n, rand_u):
        return _mala_transition(pot_and_grad, carry, rand_n, rand_u, step_size)

    return init, step


def _make_mala_warm_step_builder(aux_dim):
    def builder(pag, step_size, pm, ps):
        def full(pos, aux):
            phi_m, g_m, aux_out = pag(pos, aux)
            z = (pos - pm[:, None]) / ps[:, None]
            return phi_m + 0.5 * torch.sum(z * z, dim=0), g_m + z / ps[:, None], aux_out

        def init(pos):
            aux0 = torch.zeros((aux_dim, pos.shape[1]), dtype=pos.dtype,
                               device=pos.device)
            return (pos, *full(pos, aux0))

        def step(carry, rand_n, rand_u):
            return _mala_transition(full, carry, rand_n, rand_u, step_size)

        return init, step

    return builder


def value_and_grad_of(potential_fn, prior_mean, prior_scale):
    """``x -> (φ, ∇φ)`` of ``potential_fn`` plus the whitened prior's
    ½‖(x − m)/s‖²: the vector-Jacobian product with ones that the JAX
    scaffold traces (``_trace_potential``)."""

    def pot_and_grad(x):
        x = x.detach().requires_grad_(True)
        with torch.enable_grad():
            z = (x - prior_mean[:, None]) / prior_scale[:, None]
            phi = potential_fn(x) + 0.5 * torch.sum(z * z, dim=0)
            (g,) = torch.autograd.grad(phi, x, torch.ones_like(phi))
        return phi.detach(), g

    return pot_and_grad


def _prior_pair(prior_mean, prior_scale, d, device):
    pm = _scaffold.as_param(prior_mean, device)
    ps = _scaffold.as_param(prior_scale, device)
    if pm.shape != (d,) or ps.shape != (d,):
        raise ValueError(f"prior mean/scale must have shape ({d},)")
    return pm, ps


def _run_plain(potential_fn, positions, prior_mean, prior_scale, step_size,
               seed, n_steps, block_chains, thin=None, aux_dim=None):
    """Plain twin of the four kernels: (final (n, d), acceptance (n,)) and,
    when ``thin`` is given, samples (n_steps // thin, n, d). ``aux_dim``
    selects the warm step."""
    warm = aux_dim is not None
    _build.launch_counts[
        f"fused_mala{'_warm' if warm else ''}_plain"
        f"{'' if thin is None else '_recorded'}"
    ] += 1
    if warm:
        builder, pot = _make_mala_warm_step_builder(aux_dim), potential_fn
        params = [step_size, prior_mean, prior_scale]
    else:
        pm, ps = _prior_pair(prior_mean, prior_scale, positions.shape[1],
                             positions.device)
        builder, pot = _mala_step_builder, value_and_grad_of(potential_fn, pm, ps)
        params = [step_size]
    final, acc, _, samples = _scaffold.run_plain(
        builder, pot, positions, params, seed, n_steps, block_chains, thin)
    return (final, acc) if thin is None else (final, acc, samples)


# --- the kernels ------------------------------------------------------------

# ``MalaWarpDesign`` in ``csrc/fused_mala.cu``: chains (warps) a CTA at most.
WARP_CHAINS = 16
# What it takes: a WARP_N² CG grid, d = K = WARP_D, Jacobi (cold) or dense
# dst (warm).
WARP_N, WARP_D = 16, 64
# ``WarpSliceLevel`` in ``csrc/darcy_misfit.cuh`` pads the cells by 4 after
# every 32 in shared memory (a slice): the staged basis (d rows); warm: S
# and Sᵀ as bf16 rows of DST_ROW elements and the dst eigenvalues (a slice);
# a warp: pos and prop (d floats each) and the slices of the field a, the
# forward solution and the solve (p, th, tv); warm: the dst stage buffer
# and the carried x and λ
SLICE_FLOATS = WARP_N * WARP_N + 4 * WARP_N * WARP_N // 32
DST_ROW = 24
BASIS_BYTES = 4 * WARP_D * SLICE_FLOATS
DST_BYTES = 2 * 2 * WARP_N * DST_ROW + 4 * SLICE_FLOATS
MAX_SMEM_BYTES = 232_448  # what a CTA of the H100 may use
KERNEL = "fused_mala_warp_kernel"  # the launch count's stem, with the preconditioner


def warp_slice_bytes(warm):
    """Bytes of one warp's part of the kernel's shared memory."""
    return 4 * (2 * WARP_D + (8 if warm else 5) * SLICE_FLOATS)


# the one-chain-a-CTA kernels' stems, cold and warm, and the largest grid
# side they take (Layout16)
CTA_KERNELS = {False: "fused_mala_kernel", True: "fused_mala_warm_kernel"}
LINEAR_KERNEL = "fused_mala_kernel[linear]"  # the cold one on LinearGaussianPotential
CTA_N = 16


def stem(warm):
    """The launch count's stem of the cold (Jacobi) or warm (dst) kernel."""
    return f"{KERNEL}[{'dst' if warm else 'jacobi'}]"


def warp_takes(warm, *, n, d, K, precond, modes, solver):
    """Whether the warp kernel takes a misfit of these fields for chains of
    d coordinates, as ``mala_warp_takes`` in ``csrc/fused_mala.cu`` decides:
    a WARP_N² CG misfit with d = K = WARP_D, Jacobi (cold) or dense dst
    (warm), no modes."""
    want = "dst" if warm else "jacobi"
    return (n, d, K, precond, modes, solver) == (WARP_N, WARP_D, WARP_D, want, 0, "cg")


def route(warm, *, n, d, K, precond, modes, solver):
    """The kernel ``ipx_fused_mala`` sends a misfit of these fields to, as
    ``mala_route`` decides: "warp" for what ``warp_takes``, "cta" for any
    other CG misfit up to CTA_N² with K = d (up to its 256 threads), None
    (refused) above."""
    if warp_takes(warm, n=n, d=d, K=K, precond=precond, modes=modes, solver=solver):
        return "warp"
    if _scaffold.cta_spec(n=n, K=K, precond=precond, modes=modes, solver=solver, d=d,
                          max_cells=CTA_N * CTA_N, max_d=CTA_N * CTA_N):
        return "cta"
    return None


def warp_geometry(n_chains, block_chains, *, warm=False, n=WARP_N, d=WARP_D,
                  precond=None, modes=0, solver="cg"):
    """The kernel's launch: (CTAs, chains a CTA, dynamic shared-memory
    bytes), as ``mala_warp_geometry`` in ``csrc/fused_mala.cu`` computes it.
    Chains a CTA: the largest power of two up to WARP_CHAINS that divides
    ``block_chains``; a ragged last CTA runs spare warps. The bytes: the
    staged basis (warm: and S, Sᵀ, λ) and a slice a warp. Raises
    ``ValueError`` for a grid, d, preconditioner or solver the kernel does
    not take (``warp_takes``; cold: Jacobi, warm: dense ``dst``; ``precond``
    None is the one it takes) and for shared memory the card cannot give a
    CTA."""
    want = "dst" if warm else "jacobi"
    precond = want if precond is None else precond
    if not warp_takes(warm, n=n, d=d, K=d, precond=precond, modes=modes, solver=solver):
        raise ValueError(
            f"the {'warm' if warm else 'cold'} MALA kernel takes a {WARP_N}x{WARP_N} "
            f"CG grid, d = {WARP_D} and the {want} preconditioner; got {n}x{n}, "
            f"d = {d}, {solver}, {precond} with {modes} modes")
    if block_chains <= 0 or n_chains < 0:
        raise ValueError(f"n_chains {n_chains}, block_chains {block_chains}")
    w = WARP_CHAINS
    while block_chains % w:
        w //= 2
    smem = BASIS_BYTES + (DST_BYTES if warm else 0) + w * warp_slice_bytes(warm)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"{smem} bytes of shared memory a CTA: the card gives "
                         f"{MAX_SMEM_BYTES}")
    return -(-n_chains // w), w, smem


# The standalone cold gradient misfit ``darcy_misfit_grad_warp_kernel``
# (``MisfitGradWarpDesign`` in ``csrc/fused_mala.cu``): draws (warps) a CTA;
# after the staged basis, a warp's u (d floats) and the slices of the field
# a, the forward solution and the solve (p, th, tv).
GRAD_WARP_DRAWS = 16
GRAD_WARP_KERNEL = "darcy_misfit_grad_warp_kernel"
_GRAD_WARP_BYTES = 4 * (WARP_D + 5 * SLICE_FLOATS)


def misfit_grad_warp_takes(*, n, K, precond, modes, solver):
    """Whether ``ipx_darcy_misfit_grad`` sends a cold misfit of these fields
    (no aux0) to ``darcy_misfit_grad_warp_kernel``, as
    ``misfit_grad_warp_takes`` in ``csrc/fused_mala.cu`` decides: the rule
    of ``fused_da_pcn.misfit_slice_takes`` (``WarpSliceLevel``'s misfits:
    16×16, K = 64, Jacobi, CG; the cold MALA kernel's). Every other cold
    gradient misfit goes to the one-draw-a-CTA ``darcy_misfit_grad_kernel``;
    a warm one follows ``misfit_grad_warm_warp_takes``."""
    return fused_da_pcn.misfit_slice_takes(n=n, K=K, precond=precond, modes=modes,
                                           solver=solver)


def misfit_grad_warp_geometry(B, *, n=WARP_N, K=WARP_D, precond="jacobi", modes=0,
                              solver="cg"):
    """(draws a CTA, CTAs, dynamic shared-memory bytes) of a launch of
    ``darcy_misfit_grad_warp_kernel`` on B draws, as
    ``misfit_grad_warp_geometry`` in ``csrc/fused_mala.cu`` computes it: a
    draw a warp, the design's draws a CTA, the spare warps of a ragged
    last CTA solve nothing. Raises ``ValueError`` for a misfit that
    ``misfit_grad_warp_takes`` leaves to the other kernels, or B < 0."""
    if not misfit_grad_warp_takes(n=n, K=K, precond=precond, modes=modes, solver=solver):
        raise ValueError(f"the warp gradient misfit kernel takes a {WARP_N}x{WARP_N} Jacobi "
                         f"CG misfit with K = {WARP_D}; got {n}x{n} {precond} ({modes} modes) "
                         f"{solver}, K {K}")
    if B < 0:
        raise ValueError(f"B {B}")
    return (GRAD_WARP_DRAWS, -(-B // GRAD_WARP_DRAWS),
            BASIS_BYTES + GRAD_WARP_DRAWS * _GRAD_WARP_BYTES)


# The standalone warm gradient misfit ``darcy_misfit_grad_warm_warp_kernel``
# (``MisfitGradWarmWarpDesign`` in ``csrc/fused_mala.cu``): draws (warps) a
# CTA; after the staged basis, S, Sᵀ and λ, a warp's u (d floats) and the
# slices of the field a, the forward solution, the solve (p, th, tv) and the
# dst stage buffer.
GRAD_WARM_WARP_DRAWS = 16
GRAD_WARM_WARP_KERNEL = "darcy_misfit_grad_warm_warp_kernel"
_GRAD_WARM_WARP_BYTES = 4 * (WARP_D + 6 * SLICE_FLOATS)


def misfit_grad_warm_warp_takes(*, n, K, precond, modes, solver):
    """Whether ``ipx_darcy_misfit_grad`` sends a warm misfit of these fields
    (aux0 given) to ``darcy_misfit_grad_warm_warp_kernel``, as
    ``misfit_grad_warm_warp_takes`` in ``csrc/fused_mala.cu`` decides: the
    warm MALA kernel's (a WARP_N grid, K = WARP_D, the dense dst
    preconditioner with no modes, CG). Every other warm misfit (Jacobi or
    dst_trunc, another grid or K) goes to the one-draw-a-CTA
    ``darcy_misfit_grad_warm_kernel``."""
    return (n == WARP_N and K == WARP_D and precond == "dst" and modes == 0
            and solver == "cg")


def misfit_grad_warm_warp_geometry(B, *, n=WARP_N, K=WARP_D, precond="dst", modes=0,
                                   solver="cg"):
    """(draws a CTA, CTAs, dynamic shared-memory bytes) of a launch of
    ``darcy_misfit_grad_warm_warp_kernel`` on B draws, as
    ``misfit_grad_warm_warp_geometry`` in ``csrc/fused_mala.cu`` computes
    it: a draw a warp, the design's draws a CTA, the spare warps of a
    ragged last CTA solve nothing. Raises ``ValueError`` for a misfit that
    ``misfit_grad_warm_warp_takes`` leaves to the other kernel, or B < 0."""
    if not misfit_grad_warm_warp_takes(n=n, K=K, precond=precond, modes=modes, solver=solver):
        raise ValueError(f"the warm warp gradient misfit kernel takes a {WARP_N}x{WARP_N} dense "
                         f"dst CG misfit with K = {WARP_D}; got {n}x{n} {precond} ({modes} "
                         f"modes) {solver}, K {K}")
    if B < 0:
        raise ValueError(f"B {B}")
    return (GRAD_WARM_WARP_DRAWS, -(-B // GRAD_WARM_WARP_DRAWS),
            BASIS_BYTES + DST_BYTES + GRAD_WARM_WARP_DRAWS * _GRAD_WARM_WARP_BYTES)


def _launch(potential_fn, positions, prior_mean, prior_scale, step_size, seed,
            n_steps, block_chains, thin=None, aux_dim=None):
    warm = aux_dim is not None
    family = _scaffold.require_family(
        {"potential_fn": potential_fn},
        families=("darcy",) if warm else ("darcy", "linear"), warm="mala" if warm else False)
    if warm and aux_dim != potential_fn.aux_dim:
        raise ValueError(
            f"aux_dim {aux_dim} is not the misfit's {potential_fn.aux_dim}"
        )
    n, d = positions.shape
    if family == "linear":
        _scaffold.require_linear_route("MALA", d, potential_fn)
        kernel = "linear"
    else:
        kernel = route(warm, **potential_fn.spec_fields, d=d)
    if kernel is None:  # refused here, before any launch, with the reason
        f = potential_fn.spec_fields
        raise ValueError(
            f"the {'warm' if warm else 'cold'} MALA kernels take a CG grid of up to "
            f"{CTA_N}x{CTA_N} with K = d; got {f['n']}x{f['n']}, K = {f['K']}, d = {d}, "
            f"{f['solver']}")
    args, keep = _scaffold.chain_args(positions, prior_mean, prior_scale,
                                      seed, n_steps, block_chains, thin)
    U = keep[0].T.contiguous()
    potential_fn.check_input(U, "positions.T")
    # Φ, ∇Φ (and the solutions) of the misfit at the start positions come
    # from the standalone kernels (the Pallas step builders' init evaluates
    # the potential; the warm one from aux0 = 0); the kernel adds the prior
    if warm:
        phi0, g0, aux0 = potential_fn(U, torch.zeros(
            (aux_dim, n), dtype=torch.float32, device=U.device))
    else:
        (phi0, g0), aux0 = potential_fn.value_and_grad(U), None
    spec = potential_fn.spec()
    lib = _build.library()
    # the Darcy entry takes the carried solutions, null for the cold kernels
    fn, carried = ((lib.ipx_fused_mala_linear, ()) if kernel == "linear"
                   else (lib.ipx_fused_mala, (aux0.data_ptr() if warm else None,)))
    status = fn(
        ctypes.byref(spec), ctypes.byref(args), phi0.data_ptr(), g0.data_ptr(), *carried,
        float(torch.as_tensor(step_size, dtype=torch.float32)),
        torch.cuda.current_stream(U.device).cuda_stream,
    )
    stems = {"linear": LINEAR_KERNEL, "cta": CTA_KERNELS[warm], "warp": stem(warm)}
    name = _scaffold.kernel_name(stems[kernel], thin is not None)
    _build.check(status, name)
    _build.launch_counts[name] += 1
    _, _, _, out, acc, samples = keep
    return (out, acc) if thin is None else (out, acc, samples)


def _run(potential_fn, positions, prior_mean, prior_scale, *args, **kw):
    if prior_mean is None or prior_scale is None:
        raise ValueError(
            "the prior is folded into the target: give both prior_mean and "
            "prior_scale"
        )
    return _scaffold.on_device(positions, _launch, _run_plain)(
        potential_fn, positions, prior_mean, prior_scale, *args, **kw)


# --- entry points -----------------------------------------------------------


def fused_mala_chain(potential_fn, positions, step_size, seed, n_steps=100,
                     block_chains=256, prior_mean=None, prior_scale=None):
    """``n_steps`` of MALA on exp(−``potential_fn``)·N(prior_mean,
    prior_scale²), with the gradient computed inside the kernel.
    ``potential_fn``: (d, B) → (B,), differentiable; on the card a
    ``DarcyMisfit``. The prior is required: the defaults only keep the
    JAX entry point's argument order. Returns (final positions (n, d),
    acceptance rate per chain (n,))."""
    _scaffold.validate(positions, n_steps, block_chains)
    return _run(potential_fn, positions, prior_mean, prior_scale, step_size,
                seed, n_steps, block_chains)


def fused_mala_chain_recorded(potential_fn, positions, step_size, seed,
                              n_steps=100, thin=1, block_chains=256,
                              prior_mean=None, prior_scale=None):
    """MALA recording every ``thin``-th state: (final positions, acceptance
    rate, samples (n_steps // thin, n, d))."""
    _scaffold.validate(positions, n_steps, block_chains, thin)
    return _run(potential_fn, positions, prior_mean, prior_scale, step_size,
                seed, n_steps, block_chains, thin=thin)


def fused_mala_chain_warm(potential_fn, positions, prior_mean, prior_scale,
                          step_size, seed, n_steps=100, aux_dim=None,
                          block_chains=256):
    """Warm-started MALA: ``potential_fn(U, aux) -> (Φ, ∇Φ, aux)`` carries
    the forward and the adjoint solver solution (``DarcyMisfitMalaWarm``);
    the whitened prior is folded into the target here. Returns (final
    positions, acceptance rate)."""
    if aux_dim is None:
        raise ValueError("fused_mala_chain_warm requires aux_dim")
    _scaffold.validate(positions, n_steps, block_chains)
    return _run(potential_fn, positions, prior_mean, prior_scale, step_size,
                seed, n_steps, block_chains, aux_dim=aux_dim)


def fused_mala_chain_warm_recorded(potential_fn, positions, prior_mean,
                                   prior_scale, step_size, seed, n_steps=100,
                                   thin=1, aux_dim=None, block_chains=256):
    """Warm-started MALA recording every ``thin``-th state."""
    if aux_dim is None:
        raise ValueError("fused_mala_chain_warm_recorded requires aux_dim")
    _scaffold.validate(positions, n_steps, block_chains, thin)
    return _run(potential_fn, positions, prior_mean, prior_scale, step_size,
                seed, n_steps, block_chains, thin=thin, aux_dim=aux_dim)
