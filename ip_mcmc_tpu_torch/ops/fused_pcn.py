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

For CUDA tensors the entry points launch a kernel of ``csrc/fused_pcn.cu``,
the whole ``n_steps`` loop in one launch, picked by the spec
(``_darcy_stem`` names it; ``ipx_fused_pcn`` picks it):

- ``fused_pcn_warp_kernel<RECORD, PRECOND>`` for what ``warp_takes``: a
  16×16 CG ``DarcyMisfit`` with d = K = 64, Jacobi (cold), or a
  ``DarcyMisfitWarm`` with dst_trunc of a multiple of ``MODE_TILE`` modes
  up to ``MAX_WARP_MODES`` (warm); one chain a warp, ``warp_geometry``'s
  chains a CTA;
- ``fused_pcn_burgers_warp_kernel<RECORD>`` for a ``BurgersMisfit`` that
  ``_burgers_warp.takes`` (64 or 128 cells, d = K = 16: the shipped
  configs'), one chain a warp, ``burgers_warp_geometry``'s chains a CTA
  (``ipx_fused_pcn_burgers`` picks it; ``_burgers_stem`` names it);
- for a warm ``DarcyMisfitWarm`` that ``cluster_takes`` (a 64×64 or a
  32×32 dst_trunc CG misfit), ``fused_pcn_warm_cluster_kernel<RECORD>``
  (64×64) or ``fused_pcn_warm_cluster32_kernel<RECORD>`` (32×32), whose
  thread-block clusters of ``_cluster.cluster_geometry``'s chains share
  each read of the factors;
- else, one chain a CTA in the layout of the grid, ``fused_pcn_kernel<Pot,
  RECORD>``, the cold kernel on a ``DarcyMisfit`` or a ``BurgersMisfit``
  (picked by the potential's family), and ``fused_pcn_warm_kernel<Pot,
  RECORD>`` on any other CG ``DarcyMisfitWarm`` up to 64×64 with K = d; a
  warm grid above 64×64 is refused and the wrapper raises;
- a cold ``LinearGaussianPotential`` with K = d up to 256
  (``_scaffold.linear_route``) on ``fused_pcn_kernel<LinearGaussianPotential,
  RECORD>``, one chain a CTA (``ipx_fused_pcn_linear``; count
  ``fused_pcn_kernel[linear]``); any other d raises ``ValueError`` before
  any launch.

``route`` mirrors ``pcn_route``, the rule of ``ipx_fused_pcn``.

``misfit_warm_warp_takes`` and ``misfit_warm_warp_geometry`` mirror the rule
and the launch geometry of ``darcy_misfit_warm_warp_kernel``, which
evaluates the warm misfit at the start positions from x0 a draw a warp on
the warm warp kernel's level (``models.darcy.DarcyMisfitWarm`` launches it);
``misfit_warm_dst_warp_takes`` and ``misfit_warm_dst_warp_geometry`` those of
``darcy_misfit_warm_dst_warp_kernel``, the dense-dst warm misfit of
``darcy_smc_warm`` a draw a warp on warm MALA's level.

For CPU tensors they run the step builders below on the plain scaffold
``_scaffold.run_plain``, with any features-first callable.
Tags: normals 0 (keys 0, 1), MH uniform 2.
"""

from __future__ import annotations

import ctypes

import torch

from ip_mcmc_tpu_torch.ops import _build, _burgers_warp, _cluster, _scaffold

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


# ``PcnWarpDesign`` in ``csrc/fused_pcn.cu``: chains (warps) a CTA at most.
WARP_CHAINS = 16
# What it takes (``pcn_warp_takes``): a WARP_N² CG grid, d = K = WARP_D;
# Jacobi cold, dst_trunc of a multiple of MODE_TILE modes (an mma tile) up
# to MAX_WARP_MODES warm (what the shared memory of 16 warps holds).
WARP_N, WARP_D, MODE_TILE, MAX_WARP_MODES = 16, 64, 16, 112
# ``WarpSliceLevel`` in ``csrc/darcy_misfit.cuh`` pads the cells by 4 after
# every 32 in shared memory (a slice): the staged basis (d rows); warm
# (``WarpTruncSliceLevel``): the exchange of the dst_trunc products over
# the CTA's chains (``PrecondXchg``: 16 rows of bf16(r), of the bf16
# coefficients, of the f32 back products and a_bar), then V staged in rows
# of V_ROW bf16; a warp: pos and prop (d floats each), the slices p, th, tv
SLICE_FLOATS = WARP_N * WARP_N + 4 * WARP_N * WARP_N // 32
BASIS_BYTES = 4 * WARP_D * SLICE_FLOATS
XCHG_ROWS = 16
XCHG_BYTES = XCHG_ROWS * (2 * (264 + 264) + 4 * (260 + 1))
V_ROW = WARP_N * WARP_N + 8
WARP_SLICE_BYTES = 4 * (2 * WARP_D + 3 * SLICE_FLOATS)
MAX_SMEM_BYTES = 232_448  # what a CTA of the H100 may use
KERNEL = "fused_pcn_warp_kernel"  # the launch count's stem, with the preconditioner


def stem(warm):
    """The launch count's stem of the cold (Jacobi) or warm (dst_trunc)
    warp kernel."""
    return f"{KERNEL}[{'dst_trunc' if warm else 'jacobi'}]"


def warp_takes(warm, *, n, d, precond, modes, solver="cg"):
    """Whether ``fused_pcn_warp_kernel`` takes the spec, as
    ``pcn_warp_takes`` in ``csrc/fused_pcn.cu`` decides: the card sends it
    there, and every other spec to another kernel."""
    if (n, d, solver) != (WARP_N, WARP_D, "cg"):
        return False
    if warm:
        return precond == "dst_trunc" and 0 < modes <= MAX_WARP_MODES and modes % MODE_TILE == 0
    return precond == "jacobi" and modes == 0


def cluster_takes(*, n, d, K, precond, modes, solver):
    """Whether a cluster kernel takes a warm misfit of these fields for
    chains of d coordinates, as ``pcn_cluster_takes`` in ``csrc/fused_pcn.cu``
    decides (``_cluster.cluster_geometry`` with no surrogate): the 64×64
    samplers' exact level or the 32×32 warm pCN's, K = d."""
    fields = dict(n=n, K=K, precond=precond, modes=modes, solver=solver)
    if n == _cluster.N32:
        ok = _cluster.level_ok(**fields, grid=_cluster.N32, most_k=_cluster.MAX_K32,
                               most_modes=_cluster.MAX_MODES32)
    else:
        ok = _cluster.level_ok(**fields, grid=_cluster.EXACT_N, most_k=_cluster.MAX_K,
                               most_modes=_cluster.MAX_MODES)
    return K == d and ok


def route(warm, *, n, d, K, precond, modes, solver):
    """The kernel ``ipx_fused_pcn`` sends a Darcy misfit of these fields to,
    as ``pcn_route`` decides: "warp" for what ``warp_takes``; cold, "cta"
    for every other (the kernel of the grid's layout, which refuses a grid
    above 64×64); warm, "cluster" for what ``cluster_takes``, "cta" for any
    other CG misfit up to 64×64 with K = d (up to its layout's threads),
    None (refused) above."""
    if warp_takes(warm, n=n, d=d, precond=precond, modes=modes, solver=solver) and K == d:
        return "warp"
    if not warm:
        return "cta"
    if cluster_takes(n=n, d=d, K=K, precond=precond, modes=modes, solver=solver):
        return "cluster"
    cells = n * n
    if _scaffold.cta_spec(n=n, K=K, precond=precond, modes=modes, solver=solver, d=d,
                          max_cells=_scaffold.LAYOUTS[-1][0],
                          max_d=_scaffold.layout_threads(cells)):
        return "cta"
    return None


def warp_geometry(n_chains, block_chains, *, warm=False, n=WARP_N, d=WARP_D,
                  precond=None, modes=None, solver="cg"):
    """The warp kernel's launch: (CTAs, chains a CTA, dynamic shared-memory
    bytes), as ``pcn_warp_geometry`` in ``csrc/fused_pcn.cu`` computes it.
    Chains a CTA: the largest power of two up to WARP_CHAINS that divides
    ``block_chains``; a ragged last CTA runs spare warps. The bytes: the
    staged basis (warm: and the products' exchange and V) and a slice a
    warp (BASIS_BYTES, XCHG_BYTES + 2 V_ROW modes, WARP_SLICE_BYTES).
    ``precond`` and ``modes`` None are the shipped configs' (cold Jacobi;
    warm dst_trunc of 64 modes). Raises ``ValueError`` for a spec the kernel does not take
    (``warp_takes``: the card runs it on another kernel) and for shared
    memory the card cannot give a CTA."""
    precond = precond or ("dst_trunc" if warm else "jacobi")
    modes = (64 if warm else 0) if modes is None else modes
    if not warp_takes(warm, n=n, d=d, precond=precond, modes=modes, solver=solver):
        raise ValueError(
            f"the {'warm' if warm else 'cold'} pCN warp kernel takes a {WARP_N}x{WARP_N} "
            f"CG grid, d = {WARP_D} and "
            + (f"dst_trunc with a multiple of {MODE_TILE} modes up to {MAX_WARP_MODES}"
               if warm else "Jacobi")
            + f"; got {n}x{n}, d = {d}, {solver}, {precond} with {modes} modes")
    if block_chains <= 0 or n_chains < 0:
        raise ValueError(f"n_chains {n_chains}, block_chains {block_chains}")
    w = WARP_CHAINS
    while block_chains % w:
        w //= 2
    smem = BASIS_BYTES + (XCHG_BYTES + 2 * V_ROW * modes if warm else 0) + w * WARP_SLICE_BYTES
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"{smem} bytes of shared memory a CTA: the card gives "
                         f"{MAX_SMEM_BYTES}")
    return -(-n_chains // w), w, smem


# The standalone 16×16 warm misfit ``darcy_misfit_warm_warp_kernel``
# (``MisfitWarmWarpDesign`` in ``csrc/fused_pcn.cu``): draws (warps) a CTA on
# the warm warp kernel's level (``WarpTruncSliceLevel``); after the staged
# basis, the exchange and V (XCHG_BYTES + 2 V_ROW modes), a warp's u (d
# floats) and the slices p, th, tv.
MISFIT_WARM_WARP_DRAWS = 16
MISFIT_WARM_WARP_KERNEL = "darcy_misfit_warm_warp_kernel"
_MISFIT_WARM_WARP_BYTES = 4 * (WARP_D + 3 * SLICE_FLOATS)


def _misfit_warm_warp_smem(modes):
    return (BASIS_BYTES + XCHG_BYTES + 2 * V_ROW * modes
            + MISFIT_WARM_WARP_DRAWS * _MISFIT_WARM_WARP_BYTES)


def misfit_warm_warp_takes(*, n, K, precond, modes, solver):
    """Whether ``ipx_darcy_misfit_warm`` sends a warm misfit of these fields
    to ``darcy_misfit_warm_warp_kernel``, as ``misfit_warm_warp_takes`` in
    ``csrc/fused_pcn.cu`` decides: the warm branch of ``warp_takes`` with d
    = K (a WARP_N grid, K = WARP_D, CG, dst_trunc of a multiple of
    MODE_TILE modes up to MAX_WARP_MODES; the design's CTA holds them all).
    Every other warm misfit (dense dst, Jacobi, more modes, another grid or
    K) goes to the cluster levels or to the one-draw-a-CTA
    ``darcy_misfit_warm_kernel``."""
    return warp_takes(True, n=n, d=K, precond=precond, modes=modes, solver=solver)


def misfit_warm_warp_geometry(B, *, n=WARP_N, K=WARP_D, precond="dst_trunc", modes=64,
                              solver="cg"):
    """(draws a CTA, CTAs, dynamic shared-memory bytes) of a launch of
    ``darcy_misfit_warm_warp_kernel`` on B draws, as
    ``misfit_warm_warp_geometry`` in ``csrc/fused_pcn.cu`` computes it: a
    draw a warp, the design's draws a CTA, the spare warps of a ragged last
    CTA solving on zeros. Raises ``ValueError`` for a misfit that
    ``misfit_warm_warp_takes`` leaves to the other kernels, or B < 0."""
    if not misfit_warm_warp_takes(n=n, K=K, precond=precond, modes=modes, solver=solver):
        raise ValueError(f"the warm warp misfit kernel takes a {WARP_N}x{WARP_N} dst_trunc CG "
                         f"misfit with K = {WARP_D} and a multiple of {MODE_TILE} modes up to "
                         f"{MAX_WARP_MODES}; got {n}x{n} {precond} ({modes} modes) {solver}, "
                         f"K {K}")
    if B < 0:
        raise ValueError(f"B {B}")
    return (MISFIT_WARM_WARP_DRAWS, -(-B // MISFIT_WARM_WARP_DRAWS),
            _misfit_warm_warp_smem(modes))


# The standalone 16×16 dense-dst warm misfit ``darcy_misfit_warm_dst_warp_kernel``
# (``MisfitWarmDstWarpDesign`` in ``csrc/fused_pcn.cu``): draws (warps) a CTA
# on warm MALA's level (``WarpDstSliceLevel``); after the staged basis, S, Sᵀ
# and λ (DST_BYTES), a warp's u (d floats), the slices p, th, tv and the dst
# stage buffer.
MISFIT_WARM_DST_WARP_DRAWS = 16
MISFIT_WARM_DST_WARP_KERNEL = "darcy_misfit_warm_dst_warp_kernel"
DST_BYTES = 2 * 2 * WARP_N * 24 + 4 * SLICE_FLOATS  # S and Sᵀ in bf16 rows of 24, λ
_MISFIT_WARM_DST_WARP_BYTES = 4 * (WARP_D + 4 * SLICE_FLOATS)


def misfit_warm_dst_warp_takes(*, n, K, precond, modes, solver):
    """Whether ``ipx_darcy_misfit_warm`` sends a warm misfit of these fields
    to ``darcy_misfit_warm_dst_warp_kernel``, as
    ``misfit_warm_dst_warp_takes`` in ``csrc/fused_pcn.cu`` decides: a
    WARP_N grid, K = WARP_D, the dense dst preconditioner with no modes, CG,
    any number of CG iterations (``darcy_smc_warm``'s mutation misfit). The
    dst_trunc specs of ``misfit_warm_warp_takes`` are tried first; Jacobi,
    another grid or K go to the cluster levels or to the one-draw-a-CTA
    ``darcy_misfit_warm_kernel``."""
    return (n == WARP_N and K == WARP_D and precond == "dst" and modes == 0
            and solver == "cg")


def misfit_warm_dst_warp_geometry(B, *, n=WARP_N, K=WARP_D, precond="dst", modes=0,
                                  solver="cg"):
    """(draws a CTA, CTAs, dynamic shared-memory bytes) of a launch of
    ``darcy_misfit_warm_dst_warp_kernel`` on B draws, as
    ``misfit_warm_dst_warp_geometry`` in ``csrc/fused_pcn.cu`` computes it:
    a draw a warp, the design's draws a CTA, the spare warps of a ragged
    last CTA solve nothing. Raises ``ValueError`` for a misfit that
    ``misfit_warm_dst_warp_takes`` leaves to the other kernels, or B < 0."""
    if not misfit_warm_dst_warp_takes(n=n, K=K, precond=precond, modes=modes, solver=solver):
        raise ValueError(f"the dense-dst warm warp misfit kernel takes a {WARP_N}x{WARP_N} "
                         f"dense dst CG misfit with K = {WARP_D}; got {n}x{n} {precond} "
                         f"({modes} modes) {solver}, K {K}")
    if B < 0:
        raise ValueError(f"B {B}")
    return (MISFIT_WARM_DST_WARP_DRAWS, -(-B // MISFIT_WARM_DST_WARP_DRAWS),
            BASIS_BYTES + DST_BYTES + MISFIT_WARM_DST_WARP_DRAWS * _MISFIT_WARM_DST_WARP_BYTES)


def _darcy_stem(pot, warm, d=None):
    """The launch count's name of the Darcy kernel that ``ipx_fused_pcn``
    picks for the misfit ``pot`` and d (``route``; d None: the misfit's K):
    the warp kernel; the
    cluster kernel of the grid (64×64 or 32×32); one chain a CTA, the warm
    one named by its layout above 16×16 (``[layout32]``, ``[layout64]``).
    A refused spec keeps the name of the CTA kernel it would have run on."""
    kernel = route(warm, **pot.spec_fields, d=pot.K if d is None else d)
    if kernel == "warp":
        return stem(warm)
    if kernel == "cluster":
        return ("fused_pcn_warm_cluster32_kernel" if pot.n == _cluster.N32
                else "fused_pcn_warm_cluster_kernel")
    if not warm:
        return "fused_pcn_kernel"
    side = _scaffold.layout_side(pot.n * pot.n)
    return "fused_pcn_warm_kernel" if side == 16 else f"fused_pcn_warm_kernel[layout{side}]"


# ``PcnBurgersWarpDesign`` in ``csrc/fused_pcn.cu``: chains (warps) a CTA
# at most; a warp's slice holds pos and prop.
BURGERS_WARP_CHAINS = 16
BURGERS_KERNEL = "fused_pcn_burgers_warp_kernel"


def burgers_warp_geometry(n_chains, block_chains, *, cells=128, d=_burgers_warp.WARP_D,
                          K=_burgers_warp.WARP_D):
    """The Burgers warp kernel's launch: (CTAs, chains a CTA, dynamic
    shared-memory bytes), as ``pcn_burgers_warp_geometry`` in
    ``csrc/fused_pcn.cu`` computes it: the staged level and a slice a warp
    (``_burgers_warp.geometry``). Raises ``ValueError`` for a level the
    kernel does not take (the card runs it on ``fused_pcn_kernel``) and for
    shared memory the card cannot give a CTA."""
    return _burgers_warp.geometry("Burgers pCN warp kernel", n_chains, block_chains,
                                  cells=(cells,), d=d, K=K, chains=BURGERS_WARP_CHAINS,
                                  positions=2)


def _burgers_stem(pot, d=_burgers_warp.WARP_D):
    """The launch count's name of the Burgers kernel that
    ``ipx_fused_pcn_burgers`` picks for the misfit ``pot`` and d: the warp
    kernel for what ``_burgers_warp.takes``, else one chain a CTA."""
    if _burgers_warp.takes(pot.n, pot.K, d):
        return BURGERS_KERNEL
    return "fused_pcn_burgers_kernel"


# the launch count's stem of fused_pcn_kernel<LinearGaussianPotential, ·>
LINEAR_KERNEL = "fused_pcn_kernel[linear]"


def _launch(potential_fn, positions, prior_mean, prior_scale, beta, seed,
            n_steps, block_chains, thin=None, aux_dim=None):
    warm = aux_dim is not None
    family = _scaffold.require_family(
        {"potential_fn": potential_fn},
        families=("darcy",) if warm else ("darcy", "burgers", "linear"), warm=warm)
    if family == "linear":
        _scaffold.require_linear_route("pCN", positions.shape[1], potential_fn)
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
    # the C entry point, the kernel, its arguments after Φ0: the Darcy entry
    # takes the carried solution, null for the cold kernel
    if family == "darcy":
        fn, name = lib.ipx_fused_pcn, _darcy_stem(potential_fn, warm, positions.shape[1])
        carried = (x0.data_ptr() if warm else None,)
    elif family == "linear":
        fn, carried, name = lib.ipx_fused_pcn_linear, (), LINEAR_KERNEL
    else:
        fn, carried = lib.ipx_fused_pcn_burgers, ()
        name = _burgers_stem(potential_fn, positions.shape[1])
    status = fn(
        ctypes.byref(spec), ctypes.byref(args), phi0.data_ptr(), *carried,
        float(beta_t), float(contraction), stream,
    )
    name = _scaffold.kernel_name(name, thin is not None)
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
