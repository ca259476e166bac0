"""Two-level delayed-acceptance pCN, fused (K2–K4; mirrors
``ip_mcmc_tpu/ops/fused_mcmc.py``: ``fused_da_pcn_chain`` l.1535,
``fused_da_pcn_chain_recorded`` l.1653, the step builder
``_make_da_pcn_step_builder`` l.325 and the scaffolds ``_run_fused`` l.152 /
``_run_fused_recorded`` l.826).

Each outer step runs ``subchain_len`` pCN steps against the surrogate Φ*,
then one exact correction (Christen–Fox): accept with
log u < (Φ(u) − Φ(v)) − (Φ*(u) − Φ*(v)), a NaN ratio rejecting.

For CUDA tensors the entry points launch a kernel of
``csrc/fused_da_pcn.cu`` that runs the whole ``n_steps`` loop in one
launch, picked by the potentials' family and grids: for a 16×16 exact
level with an 8×8 surrogate (solved by CG or Richardson),
``fused_da_pcn_warp_kernel<SOLVER, RECORD>``, one warp per chain and
``warp_geometry``'s chains a CTA, the preconditioner's products on the
tensor cores; for a 64×64 exact level with a 32×32 dst_trunc CG
surrogate (``darcy64_da_fused``), ``fused_da_pcn_cluster_kernel<RECORD>``,
one CTA per chain and ``_cluster.cluster_geometry``'s chains a thread-block
cluster sharing each read of the factors, the preconditioner's products on
the tensor cores; for a pair of ``BurgersMisfit`` potentials that
``_burgers_warp.takes`` (64 or 128 cells each, d = K = 16: the shipped
config's), ``fused_da_pcn_burgers_warp_kernel<RECORD>``, one warp per chain
and ``burgers_warp_geometry``'s chains a CTA, and for any other Burgers
pair ``fused_da_pcn_kernel<Pot, RECORD>``, one CTA per chain
(``_burgers_stem`` names the kernel the pair gets). A Darcy pair that the
warp and cluster kernels leave runs on ``fused_da_pcn_kernel<Pot, RECORD,
Surr>``, one chain per CTA: both levels up to 16×16 (the surrogate no finer
than the exact grid, by CG or Richardson), or an exact grid of 33×33 to
64×64 with a CG surrogate of 17×17 to 32×32. ``route`` mirrors
``da_route``, the rule of ``ipx_fused_da_pcn``; the kernels refuse any
other Darcy pair and the wrapper raises. A pair of
``LinearGaussianPotential`` levels with K = d up to 256
(``_scaffold.linear_route``) runs on
``fused_da_pcn_kernel<LinearGaussianPotential, RECORD>``, one chain a CTA
(``ipx_fused_da_pcn_linear``); another d raises ``ValueError`` before any
launch. For CPU tensors they run
``_run_plain`` / ``_run_plain_recorded``: the step builder below on the
plain scaffold ``_scaffold.run_plain``, which takes any features-first
callable (d, B) → (B,), so the algorithm tests can use analytic targets.
Both draw from the counter-hash stream of ``ops/rng.py`` with the JAX
tags: inner step j uses 4j, 4j+1 (normals) and 4j+2 (MH uniform); the
outer correction 4k+2.

``misfit_warp_takes`` and ``misfit_warp_geometry`` mirror the rule and the
launch geometry of ``darcy_misfit_warp_kernel<N, SOLVER>``, which evaluates
the 16×16 exact misfit and the 8×8 surrogate (CG or Richardson) at the
start positions a draw a warp on this module's levels
(``models.darcy.DarcyMisfit`` launches it); ``misfit_slice_takes``
and ``misfit_slice_geometry`` those of ``darcy_misfit_slice_kernel``, the
16×16 Jacobi misfit a draw a warp on the solve of the ESS, cold pCN and
FES kernels.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ip_mcmc_tpu_torch.ops import _build, _burgers_warp, _cluster, _scaffold


# --- the plain version ------------------------------------------------------


def _make_da_pcn_step_builder(subchain_len):
    """Step builder on features-first (d, n) state for ``_scaffold.run_plain``;
    mirrors ``_make_da_pcn_step_builder``. ``pots`` is the (exact,
    surrogate) pair; ``extra_out`` is the inner acceptance rate."""
    k = int(subchain_len)

    def builder(pots, beta, mean, scale):
        pot_exact, pot_surr = pots
        contraction = torch.sqrt(1.0 - beta * beta)
        m, s = mean[:, None], scale[:, None]

        def init(pos):
            in_acc = torch.zeros((1, pos.shape[1]), dtype=torch.float32,
                                 device=pos.device)
            return (pos, pot_exact(pos), pot_surr(pos), in_acc, 0.0)

        def step(carry, rand_n, rand_u):
            pos0, phi0, surr0, in_acc, cnt = carry
            row = (1, pos0.shape[1])
            pos, surr = pos0, surr0
            for j in range(k):
                xi = s * rand_n(pos.shape, 4 * j)
                prop = m + contraction * (pos - m) + beta * xi
                surr_prop = pot_surr(prop)
                log_u = torch.log(rand_u(row, 4 * j + 2))[0]
                take = log_u < (surr - surr_prop)  # NaN ratio -> False
                in_acc = in_acc + take[None, :].to(torch.float32)
                pos = torch.where(take[None, :], prop, pos)
                surr = torch.where(take, surr_prop, surr)
            phi_end = pot_exact(pos)
            log_ratio = (phi0 - phi_end) - (surr0 - surr)
            log_ratio = torch.where(torch.isnan(log_ratio), -math.inf, log_ratio)
            accept = torch.log(rand_u(row, 4 * k + 2))[0] < log_ratio
            acc2 = accept[None, :]
            return (
                torch.where(acc2, pos, pos0),
                torch.where(accept, phi_end, phi0),
                torch.where(accept, surr, surr0),
                in_acc,
                cnt + 1.0,
            ), acc2

        return init, step

    builder.extra_out = lambda carry: carry[3][0] / max(carry[4] * k, 1.0)
    return builder


def _plain(pot_exact, pot_surr, positions, prior_mean, prior_scale, beta,
           seed, n_steps, subchain_len, block_chains, thin=None):
    return _scaffold.run_plain(
        _make_da_pcn_step_builder(subchain_len), (pot_exact, pot_surr),
        positions, [beta, prior_mean, prior_scale], seed, n_steps,
        block_chains, thin,
    )


def _run_plain(pot_exact, pot_surr, positions, prior_mean, prior_scale, beta,
               seed, n_steps, subchain_len, block_chains):
    """Plain twin of the DA kernels, not recording: (final (n, d),
    exact acceptance (n,), inner acceptance (n,))."""
    _build.launch_counts["fused_da_pcn_plain"] += 1
    final, acc, inner, _ = _plain(
        pot_exact, pot_surr, positions, prior_mean, prior_scale, beta, seed,
        n_steps, subchain_len, block_chains,
    )
    return final, acc, inner


def _run_plain_recorded(pot_exact, pot_surr, positions, prior_mean,
                        prior_scale, beta, seed, n_steps, thin, subchain_len,
                        block_chains):
    """Plain twin of the DA kernels, recording: (final (n, d),
    exact acceptance (n,), samples (n_steps // thin, n, d))."""
    _build.launch_counts["fused_da_pcn_plain_recorded"] += 1
    final, acc, _, samples = _plain(
        pot_exact, pot_surr, positions, prior_mean, prior_scale, beta, seed,
        n_steps, subchain_len, block_chains, thin,
    )
    return final, acc, samples


# --- the kernel -------------------------------------------------------------


# The 16×16 kernel's design (``DaWarpDesign`` in ``csrc/fused_da_pcn.cu``):
# chains a CTA at most, and whether the exact level's factors are staged in
# shared memory (else read through L2). What it takes: an exact grid of
# WARP_EXACT_N², a surrogate of WARP_SURR_N², d = K = WARP_D.
WARP_CHAINS, WARP_EXACT_STAGED = 8, False
WARP_EXACT_N, WARP_SURR_N, WARP_D = 16, 8, 64
MAX_SMEM_BYTES = 232_448  # what a CTA of the H100 may use
# the CTA's exchange rows (bf16 r, bf16 coefficients, f32 back-projection,
# a_bar) and a warp's slice (pos0, pos, prop; p, th, tv of 256 cells)
_XCHG_ROW_BYTES = 2 * (264 + 264) + 4 * (260 + 1)
_WARP_SLICE_BYTES = 4 * (3 * WARP_D + 3 * WARP_EXACT_N ** 2)


def _staged_bytes(n, modes, K=WARP_D):
    """A level's factors staged in shared memory: the f32 basis and
    eigenvalues, the bf16 modes with rows padded by 8 (a multiple of 16)."""
    b = 4 * (K * n * n + modes) + 2 * modes * (n * n + 8)
    return -(-b // 16) * 16


def _warp_level(n, K, precond, modes, solver, *, grid, want):
    """``da_warp_level_ok``: a level of the warp kernel, d = K = WARP_D."""
    ok = (precond == "dst_trunc" and 0 < modes <= n * n and modes % 16 == 0
          or precond == "jacobi" and modes == 0)
    return n == grid and K == WARP_D and ok and solver == want


def warp_takes(exact, surr, d):
    """Whether the 16×16 warp kernel takes the pair (each a dict of the
    misfit's ``spec_fields``) for chains of d coordinates, as
    ``da_warp_takes`` in ``csrc/fused_da_pcn.cu`` decides: a WARP_EXACT_N²
    CG exact level and a WARP_SURR_N² surrogate (CG or Richardson), Jacobi
    or dst_trunc of a multiple of 16 modes, d = K = WARP_D."""
    return (d == WARP_D and _warp_level(**exact, grid=WARP_EXACT_N, want="cg")
            and _warp_level(**surr, grid=WARP_SURR_N,
                            want="richardson" if surr["solver"] == "richardson" else "cg"))


def route(exact, surr, d):
    """The kernel ``ipx_fused_da_pcn`` sends a Darcy pair (each a dict of
    the misfit's ``spec_fields``) to, as ``da_route`` decides: "warp" for
    what ``warp_takes``; "cluster" for a 64×64 dst_trunc CG exact level
    with a 32×32 one (``_cluster``'s exact and surrogate levels); "cta" for
    both levels up to 16×16 (the surrogate no finer, by CG or Richardson;
    d up to 256) and for an exact grid of 33×33 to 64×64 with a CG
    surrogate of 17×17 to 32×32 (d up to 1024), K = d at both; None
    (refused) for every other pair."""
    if warp_takes(exact, surr, d):
        return "warp"
    if (exact["K"] == surr["K"] == d
            and _cluster.level_ok(**exact, grid=_cluster.EXACT_N, most_k=_cluster.MAX_K,
                                  most_modes=_cluster.MAX_MODES)
            and _cluster.level_ok(**surr, grid=_cluster.SURR_N, most_k=_cluster.MAX_K,
                                  most_modes=_cluster.MAX_SURR_MODES)):
        return "cluster"
    e, s = exact["n"] ** 2, surr["n"] ** 2
    if surr["n"] <= exact["n"] and e <= 256:
        if (_scaffold.cta_spec(**exact, d=d, max_cells=256, max_d=256)
                and _scaffold.cta_spec(**surr, d=d, max_cells=256, max_d=256,
                                       want=surr["solver"])):
            return "cta"
    elif (e > 1024 and s > 256 and _scaffold.cta_spec(**exact, d=d, max_cells=4096, max_d=1024)
          and _scaffold.cta_spec(**surr, d=d, max_cells=1024, max_d=1024)):
        return "cta"
    return None


def warp_geometry(n_chains, block_chains, *, exact_n=WARP_EXACT_N,
                  exact_modes=128, surr_n=WARP_SURR_N, surr_modes=64,
                  d=WARP_D, chains=WARP_CHAINS, exact_staged=WARP_EXACT_STAGED):
    """The 16×16 kernel's launch: (CTAs, chains a CTA, dynamic shared-memory
    bytes), as ``da_warp_geometry`` in ``csrc/fused_da_pcn.cu`` computes
    it. Chains a CTA: the largest power of two up to ``chains`` that divides
    ``block_chains`` (a CTA's chains share an RNG block); a ragged last CTA
    runs spare warps. Raises ``ValueError`` for grids, d or modes the kernel
    does not take and for shared memory the card cannot give a CTA."""
    if (exact_n, surr_n, d) != (WARP_EXACT_N, WARP_SURR_N, WARP_D):
        raise ValueError(
            f"the 16x16 DA kernel takes a {WARP_EXACT_N}x{WARP_EXACT_N} exact grid, "
            f"a {WARP_SURR_N}x{WARP_SURR_N} surrogate and d = {WARP_D}; got "
            f"{exact_n}x{exact_n}, {surr_n}x{surr_n}, d = {d}")
    for n, modes in ((exact_n, exact_modes), (surr_n, surr_modes)):
        if modes % 16 or not 0 <= modes <= n * n:
            raise ValueError(f"{n}x{n}: {modes} preconditioner modes are not a "
                             f"multiple of 16 up to {n * n}")
    if block_chains <= 0 or n_chains < 0:
        raise ValueError(f"n_chains {n_chains}, block_chains {block_chains}")
    w = chains
    while block_chains % w:
        w //= 2
    tiles = -(-chains // 8)
    smem = (8 * tiles * _XCHG_ROW_BYTES + _staged_bytes(surr_n, surr_modes)
            + (_staged_bytes(exact_n, exact_modes) if exact_staged else 0)
            + w * _WARP_SLICE_BYTES)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"{smem} bytes of shared memory a CTA: the card gives "
                         f"{MAX_SMEM_BYTES}")
    return -(-n_chains // w), w, smem


# The standalone misfits on the 16×16 DA kernel's levels
# ``darcy_misfit_warp_kernel<N, SOLVER>`` (``MisfitWarpDesign`` and, at 8×8,
# ``MisfitSurrWarpDesign`` in ``csrc/fused_da_pcn.cu``): draws (warps) a CTA,
# and whether the exact level's factors are staged in shared memory (else
# read through L2; the 8×8 level's are staged). Its slice a warp: the draw's
# u, then p, th, tv of the level's cells.
MISFIT_WARP_DRAWS, MISFIT_WARP_STAGED = 16, True
MISFIT_SURR_WARP_DRAWS = 16
MISFIT_WARP_KERNEL = "darcy_misfit_warp_kernel"


def _misfit_warp_draws(n):
    return MISFIT_WARP_DRAWS if n == WARP_EXACT_N else MISFIT_SURR_WARP_DRAWS


def _misfit_warp_smem(modes, n=WARP_EXACT_N):
    draws = _misfit_warp_draws(n)
    staged = MISFIT_WARP_STAGED if n == WARP_EXACT_N else True
    return (8 * -(-draws // 8) * _XCHG_ROW_BYTES
            + (_staged_bytes(n, modes) if staged else 0)
            + draws * 4 * (WARP_D + 3 * n * n))


def misfit_warp_takes(*, n, K, precond, modes, solver):
    """Whether ``ipx_darcy_misfit`` sends a misfit of these fields to
    ``darcy_misfit_warp_kernel``, as ``misfit_warp_takes`` in
    ``csrc/fused_da_pcn.cu`` decides: a level of the 16×16 DA kernel whose
    factors fit a CTA's shared memory with the design's slices, K = WARP_D:
    its exact level with dst_trunc (a WARP_EXACT_N grid, a positive multiple
    of 16 modes up to the cells, CG; up to 144 modes staged), or its
    surrogate level as ``warp_geometry`` takes it (a WARP_SURR_N grid,
    dst_trunc with a multiple of 16 modes up to the cells or Jacobi, CG or
    Richardson). Every other misfit goes to the cluster level
    (``_cluster.misfit_cluster_takes``) or runs one draw a CTA on the layout
    of its grid."""
    if K != WARP_D or _misfit_warp_smem(modes, n) > MAX_SMEM_BYTES:
        return False
    if n == WARP_EXACT_N:
        return (precond == "dst_trunc" and modes > 0 and modes % 16 == 0 and modes <= n * n
                and solver == "cg")
    if n == WARP_SURR_N:
        return (((precond == "dst_trunc" and modes > 0 and modes % 16 == 0 and modes <= n * n)
                 or (precond == "jacobi" and modes == 0))
                and solver in ("cg", "richardson"))
    return False


def misfit_warp_geometry(B, *, n=WARP_EXACT_N, K=WARP_D, precond="dst_trunc", modes=128,
                         solver="cg"):
    """(draws a CTA, CTAs, dynamic shared-memory bytes) of a launch of
    ``darcy_misfit_warp_kernel`` on B draws, as ``misfit_warp_geometry`` in
    ``csrc/fused_da_pcn.cu`` computes it: a draw a warp, the level's draws
    a CTA, the spare warps of a ragged last CTA run on zeros. Raises
    ``ValueError`` for a misfit that ``misfit_warp_takes`` leaves to the
    other kernels, or B < 0."""
    if not misfit_warp_takes(n=n, K=K, precond=precond, modes=modes, solver=solver):
        raise ValueError(f"the warp misfit kernel takes a {WARP_EXACT_N}x{WARP_EXACT_N} "
                         f"dst_trunc CG misfit or a {WARP_SURR_N}x{WARP_SURR_N} dst_trunc or "
                         f"Jacobi misfit by CG or Richardson, K = {WARP_D}, a multiple of 16 "
                         f"modes; got {n}x{n} {precond} ({modes} modes) {solver}, K {K}")
    if B < 0:
        raise ValueError(f"B {B}")
    draws = _misfit_warp_draws(n)
    return draws, -(-B // draws), _misfit_warp_smem(modes, n)


# The standalone 16×16 Jacobi misfit ``darcy_misfit_slice_kernel``
# (``MisfitSliceDesign`` in ``csrc/fused_da_pcn.cu``): draws (warps) a CTA.
# It solves on ``WarpSliceLevel`` (``csrc/darcy_misfit.cuh``), which pads
# the cells by 4 after every 32 (a slice of SLICE_FLOATS): the basis staged
# once a CTA (K rows), and a warp's u, then p, th, tv.
MISFIT_SLICE_DRAWS = 32
SLICE_FLOATS = WARP_EXACT_N ** 2 + 4 * WARP_EXACT_N ** 2 // 32
SLICE_BASIS_BYTES = 4 * WARP_D * SLICE_FLOATS
_MISFIT_SLICE_WARP_BYTES = 4 * (WARP_D + 3 * SLICE_FLOATS)


def misfit_slice_takes(*, n, K, precond, modes, solver):
    """Whether ``ipx_darcy_misfit`` sends a misfit of these fields to
    ``darcy_misfit_slice_kernel``, as ``misfit_slice_takes`` in
    ``csrc/fused_da_pcn.cu`` decides: ``WarpSliceLevel``'s misfits
    (``warp_slice_spec`` in ``csrc/darcy_misfit.cuh``: a WARP_EXACT_N grid,
    K = WARP_D, Jacobi with no modes, CG), the solve of the ESS, cold pCN,
    FES and cold MALA kernels. Every other misfit goes to the other
    kernels (``misfit_warp_takes``, the cluster level, or one draw a CTA on
    the layout of its grid)."""
    return (n == WARP_EXACT_N and K == WARP_D and precond == "jacobi" and modes == 0
            and solver == "cg")


def misfit_slice_geometry(B, *, n=WARP_EXACT_N, K=WARP_D, precond="jacobi", modes=0,
                          solver="cg"):
    """(draws a CTA, CTAs, dynamic shared-memory bytes) of a launch of
    ``darcy_misfit_slice_kernel`` on B draws, as ``misfit_slice_geometry``
    in ``csrc/fused_da_pcn.cu`` computes it: a draw a warp, the design's
    draws a CTA, the spare warps of a ragged last CTA leave after the
    staging. Raises ``ValueError`` for a misfit that ``misfit_slice_takes``
    leaves to the other kernels, or B < 0."""
    if not misfit_slice_takes(n=n, K=K, precond=precond, modes=modes, solver=solver):
        raise ValueError(f"the slice misfit kernel takes a {WARP_EXACT_N}x{WARP_EXACT_N} "
                         f"Jacobi CG misfit with K = {WARP_D}; got {n}x{n} {precond} "
                         f"({modes} modes) {solver}, K {K}")
    if B < 0:
        raise ValueError(f"B {B}")
    return (MISFIT_SLICE_DRAWS, -(-B // MISFIT_SLICE_DRAWS),
            SLICE_BASIS_BYTES + MISFIT_SLICE_DRAWS * _MISFIT_SLICE_WARP_BYTES)


# ``DaBurgersWarpDesign`` in ``csrc/fused_da_pcn.cu``: chains (warps) a CTA
# at most; a warp's slice holds pos0, pos and prop.
BURGERS_WARP_CHAINS = 16
BURGERS_KERNEL = "fused_da_pcn_burgers_warp_kernel"


def burgers_warp_geometry(n_chains, block_chains, *, cells=(128, 64), d=_burgers_warp.WARP_D,
                          K=_burgers_warp.WARP_D):
    """The Burgers warp kernel's launch: (CTAs, chains a CTA, dynamic
    shared-memory bytes), as ``da_burgers_warp_geometry`` in
    ``csrc/fused_da_pcn.cu`` computes it for levels of ``cells`` (exact,
    surrogate): both staged levels and a slice a warp
    (``_burgers_warp.geometry``). Raises ``ValueError`` for levels the
    kernel does not take (the card runs them on ``fused_da_pcn_kernel``)
    and for shared memory the card cannot give a CTA."""
    return _burgers_warp.geometry("Burgers DA warp kernel", n_chains, block_chains,
                                  cells=cells, d=d, K=K, chains=BURGERS_WARP_CHAINS,
                                  positions=3)


def _burgers_stem(pot_exact, pot_surr, d=_burgers_warp.WARP_D):
    """The launch count's name of the Burgers kernel that
    ``ipx_fused_da_pcn_burgers`` picks for the pair and d: the warp kernel
    when ``_burgers_warp.takes`` both levels, else one chain a CTA."""
    if all(_burgers_warp.takes(p.n, p.K, d) for p in (pot_exact, pot_surr)):
        return BURGERS_KERNEL
    return "fused_da_pcn_burgers_kernel"


def _darcy_stem(pot_exact, pot_surr, d=None):
    """The launch count's name of the Darcy kernel that ``ipx_fused_da_pcn``
    picks for the pair and d (``route``; d None: the exact misfit's K): the
    16×16 warp kernel by its
    surrogate's solver, the 64×64 one (thread-block clusters), or one chain
    a CTA by its layout (``[layout16]``, with the surrogate's solver if not
    CG, or ``[layout64]``). A refused pair keeps the name of the kernel of
    its exact grid's class."""
    kernel = route(pot_exact.spec_fields, pot_surr.spec_fields,
                   pot_exact.K if d is None else d)
    tag = "" if pot_surr.solver == "cg" else f"surrogate={pot_surr.solver}"
    if kernel == "warp":
        return f"fused_da_pcn_warp_kernel[{tag}]" if tag else "fused_da_pcn_warp_kernel"
    if kernel == "cluster":
        return "fused_da_pcn_cluster_kernel"
    side = 16 if pot_exact.n <= 16 else 64
    return f"fused_da_pcn_kernel[layout{side}{',' + tag if tag else ''}]"


# the launch count's stem of fused_da_pcn_kernel<LinearGaussianPotential, ·>
LINEAR_KERNEL = "fused_da_pcn_kernel[linear]"


def _launch(pot_exact, pot_surr, positions, prior_mean, prior_scale, beta,
            seed, n_steps, subchain_len, block_chains, thin=None):
    family = _scaffold.require_family(
        {"potential_fn": pot_exact, "surrogate_fn": pot_surr},
        families=("darcy", "burgers", "linear"), richardson=("surrogate_fn",))
    if family == "linear":
        _scaffold.require_linear_route("DA-pCN", positions.shape[1], pot_exact, pot_surr)
    args, keep = _scaffold.chain_args(positions, prior_mean, prior_scale,
                                      seed, n_steps, block_chains, thin)
    U = keep[0].T.contiguous()
    pot_exact.check_input(U, "positions.T (exact)")
    pot_surr.check_input(U, "positions.T (surrogate)")
    # Φ and Φ* at the start positions come from the standalone misfit
    # kernel (the Pallas step builder's init evaluates both potentials)
    phi0, surr0 = pot_exact(U), pot_surr(U)
    inner = torch.empty(U.shape[1], dtype=torch.float32, device=U.device)
    beta_t, contraction = _scaffold.contraction(beta)
    es, ss = pot_exact.spec(), pot_surr.spec()
    lib = _build.library()
    if family == "darcy":
        fn, stem = lib.ipx_fused_da_pcn, _darcy_stem(pot_exact, pot_surr, U.shape[0])
    elif family == "linear":
        fn, stem = lib.ipx_fused_da_pcn_linear, LINEAR_KERNEL
    else:
        fn = lib.ipx_fused_da_pcn_burgers
        stem = _burgers_stem(pot_exact, pot_surr, U.shape[0])
    status = fn(
        ctypes.byref(es), ctypes.byref(ss), ctypes.byref(args),
        phi0.data_ptr(), surr0.data_ptr(), float(beta_t), float(contraction),
        int(subchain_len), inner.data_ptr(),
        torch.cuda.current_stream(U.device).cuda_stream,
    )
    name = _scaffold.kernel_name(stem, thin is not None)
    _build.check(status, name)
    _build.launch_counts[name] += 1
    _, _, _, out, acc, samples = keep
    return out, acc, (inner if thin is None else samples)


# --- entry points -----------------------------------------------------------


def fused_da_pcn_chain(potential_fn, surrogate_fn, positions, prior_mean,
                       prior_scale, beta, seed, n_steps=100, subchain_len=4,
                       block_chains=256):
    """Delayed-acceptance pCN: (final positions (n, d), exact acceptance
    rate (n,), inner acceptance rate (n,)). Potentials take (d, B) → (B,)."""
    _scaffold.validate(positions, n_steps, block_chains)
    run = _scaffold.on_device(positions, _launch, _run_plain)
    return run(potential_fn, surrogate_fn, positions, prior_mean, prior_scale,
               beta, seed, n_steps, subchain_len, block_chains)


def fused_da_pcn_chain_recorded(potential_fn, surrogate_fn, positions,
                                prior_mean, prior_scale, beta, seed,
                                n_steps=100, thin=1, subchain_len=4,
                                block_chains=256):
    """Delayed-acceptance pCN recording every ``thin``-th outer step:
    (final positions, exact acceptance rate, samples (n_steps // thin, n, d))."""
    _scaffold.validate(positions, n_steps, block_chains, thin)
    run = _scaffold.on_device(positions, _launch, _run_plain_recorded)
    if run is _launch:
        return _launch(potential_fn, surrogate_fn, positions, prior_mean,
                       prior_scale, beta, seed, n_steps, subchain_len,
                       block_chains, thin=thin)
    return _run_plain_recorded(potential_fn, surrogate_fn, positions,
                               prior_mean, prior_scale, beta, seed, n_steps,
                               thin, subchain_len, block_chains)
