"""The launch geometry of the Darcy kernels that run in thread-block
clusters: at 64×64 ``fused_da_pcn_cluster_kernel`` (``darcy64_da_fused``)
and ``fused_pcn_warm_cluster_kernel`` (``darcy64_pcn_warm``), at 32×32
``fused_pcn_warm_cluster32_kernel`` (``darcy32_pcn_warm``); and the
standalone misfits on those samplers' levels: at 64×64
``darcy_misfit_cluster_kernel`` and ``darcy_misfit_warm_cluster_kernel``
(Φ and x at the start positions of the two 64×64 configs), at 32×32
``darcy_misfit_warm_cluster32_kernel`` (``darcy32_pcn_warm``'s) and its
cold twin ``darcy_misfit_cluster32_kernel``, and on the 64×64 DA kernel's
32×32 surrogate level ``darcy_misfit_surr_cluster_kernel``
(``darcy64_da_fused``'s Φ* at its start positions).

One chain (or draw) runs per CTA, and the G CTAs of a cluster share each
read of the factors (``ClusterLevel`` in ``csrc/darcy_misfit.cuh``), read
through L2; at 32×32 in a layout of its own, at seven CTAs an SM.
``cluster_geometry`` mirrors ``cluster_geometry`` there,
``misfit_cluster_level``, ``misfit_cluster_takes`` and
``misfit_cluster_geometry`` mirror ``misfit_cluster_level``,
``misfit_cluster_takes`` / ``misfit_cluster_warm_takes`` and
``misfit_cluster_geometry``;
``ipx_darcy_cluster_geometry`` and ``ipx_darcy_misfit_cluster_geometry``
return the C side's, and the card tests and ``chip_smoke.py`` hold each
pair equal.
"""

from __future__ import annotations

# ClusterDesign in csrc/darcy_misfit.cuh: chains (CTAs) a cluster, threads a CTA
CLUSTER_G, CLUSTER_THREADS = 8, 512
EXACT_N, SURR_N = 64, 32  # the grids the kernels take
MAX_SMEM_BYTES = 232_448  # what a CTA of the H100 may use
# the largest K (= d) and dst_trunc modes (exact level, surrogate) the
# kernels' shared memory holds
MAX_K, MAX_MODES, MAX_SURR_MODES = 144, 256, 128
# Cluster32Design: chains a cluster, threads a CTA
CLUSTER32_G, CLUSTER32_THREADS = 8, 128
N32, MAX_K32, MAX_MODES32 = 32, 64, 128  # its grid, largest K and modes


def _layout_bytes(cells, G, threads, max_k, max_modes):
    """``ClusterSmemT<...>::kBytes``: five f32 arrays of the cells (the
    stencil's vector, the face terms right of and below each cell, the
    boundary terms, the inverse diagonal), the warps' partial sums (16 rows
    × 8 columns an mma tile of chains), the cluster's coefficients u, the
    sampler's state (3 × max_k), the warp partials (32), Φ, a_bar, the
    cluster's G a_bar and the eigenvalues of a modes slice (max_modes),
    rounded to 16 bytes; then bf16(r) on the cells and the cluster's
    coefficients in rows of max_modes + 8."""
    nt = -(-G // 8)
    f32 = (5 * cells + threads // 32 * 16 * 8 * nt + G * max_k + 3 * max_k + 32 + 1 + 1 + G
           + max_modes)
    return 4 * (-(-f32 // 4) * 4) + 2 * (cells + G * (max_modes + 8))


def smem_bytes(G=CLUSTER_G, threads=CLUSTER_THREADS):
    """The 64×64 kernels' ``ClusterSmem::kBytes``."""
    return _layout_bytes(EXACT_N * EXACT_N, G, threads, MAX_K, MAX_MODES)


def smem_bytes32(G=CLUSTER32_G, threads=CLUSTER32_THREADS):
    """The 32×32 kernel's ``Cluster32Smem::kBytes``: its layout sized for
    32×32 cells, K up to 64 and 128 modes."""
    return _layout_bytes(N32 * N32, G, threads, MAX_K32, MAX_MODES32)


def cluster_geometry(n_chains, block_chains, *, d=144, exact_n=EXACT_N, exact_modes=256,
                     surr_n=SURR_N, surr_modes=128, G=None, threads=None):
    """(chains a cluster, clusters, CTAs, dynamic shared-memory bytes) of a
    launch: the 64×64 DA kernel with a surrogate, the 64×64 warm pCN kernel
    with ``surr_n=None``, the 32×32 warm pCN kernel with ``exact_n=32`` and
    ``surr_n=None``. Every cluster has G CTAs (the design's, unless given),
    the spare ones of a ragged last cluster run on zeros. A CTA runs chain
    ``blockIdx.x`` with the seed and lane of the one-chain-a-CTA kernels, so
    G does not depend on ``block_chains``; the shared memory is laid out at
    compile time, so it depends on the design alone. Raises ``ValueError``
    for grids, d or modes the kernels do not take (a 64×64 exact level with
    a 32×32 surrogate or none, d up to MAX_K; a 32×32 exact level with none,
    d up to MAX_K32; dst_trunc with a multiple of 16 modes up to the cells
    and MAX_MODES, MAX_SURR_MODES for the surrogate, MAX_MODES32 at 32×32)
    and for shared memory the card cannot give a CTA."""
    n32 = exact_n == N32
    if n32:
        if surr_n is not None:
            raise ValueError(f"the {N32}x{N32} cluster kernel takes no surrogate; got "
                             f"{surr_n}x{surr_n}")
        levels, most_k = [(exact_n, N32, exact_modes, MAX_MODES32)], MAX_K32
        G, threads = G or CLUSTER32_G, threads or CLUSTER32_THREADS
    else:
        levels, most_k = [(exact_n, EXACT_N, exact_modes, MAX_MODES)], MAX_K
        if surr_n is not None:
            levels.append((surr_n, SURR_N, surr_modes, MAX_SURR_MODES))
        G, threads = G or CLUSTER_G, threads or CLUSTER_THREADS
    for n, want, modes, most in levels:
        if n != want:
            raise ValueError(f"the cluster kernels take a {EXACT_N}x{EXACT_N} exact grid and a "
                             f"{SURR_N}x{SURR_N} surrogate, or a {N32}x{N32} exact grid alone; "
                             f"got {n}x{n} for {want}x{want}")
        if modes <= 0 or modes % 16 or modes > min(n * n, most):
            raise ValueError(f"{n}x{n}: {modes} dst_trunc modes are not a positive multiple "
                             f"of 16 up to {min(n * n, most)}")
    if block_chains <= 0 or n_chains < 0 or not 0 < d <= most_k:
        raise ValueError(f"n_chains {n_chains}, block_chains {block_chains}, d {d} (at most "
                         f"{most_k})")
    smem = smem_bytes32(G, threads) if n32 else smem_bytes(G, threads)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"{smem} bytes of shared memory a CTA: the card gives {MAX_SMEM_BYTES}")
    clusters = -(-n_chains // G)
    return G, clusters, clusters * G, smem


# The levels a standalone misfit runs on (``misfit_cluster_level`` in
# ``csrc/darcy_misfit.cuh``) and the launch count's stem of each one's
# cold kernel: the exact level of the 64×64 samplers, the level of the
# 32×32 warm pCN, the 64×64 DA kernel's 32×32 surrogate level
EXACT, EXACT32, SURR = "exact", "exact32", "surrogate"
MISFIT_KERNELS = {EXACT: "darcy_misfit_cluster_kernel", EXACT32: "darcy_misfit_cluster32_kernel",
                  SURR: "darcy_misfit_surr_cluster_kernel"}


def level_ok(*, n, K, precond, modes, solver, grid, most_k, most_modes):
    """``cluster_level_ok`` in ``csrc/darcy_misfit.cuh``: a ``grid``² level,
    K up to ``most_k``, dst_trunc with a positive multiple of 16 modes up to
    the cells and ``most_modes``, solved by CG."""
    return (n == grid and K <= most_k and precond == "dst_trunc" and modes > 0
            and modes % 16 == 0 and modes <= min(n * n, most_modes) and solver == "cg")


def misfit_cluster_level(*, n, K, precond, modes, solver):
    """The cluster level a misfit of these fields runs on, as
    ``misfit_cluster_level`` in ``csrc/darcy_misfit.cuh`` decides: EXACT, a
    level the 64×64 samplers take (an EXACT_N grid, K up to MAX_K, dst_trunc
    with a positive multiple of 16 modes up to MAX_MODES, solved by CG);
    EXACT32, the 32×32 warm pCN's (an N32 grid, K up to MAX_K32, up to
    MAX_MODES32 modes); SURR, the 64×64 DA kernel's surrogate (a SURR_N grid,
    K up to MAX_K, up to MAX_SURR_MODES modes), tried after EXACT32, so that
    it takes MAX_K32 < K ≤ MAX_K; or None."""
    fields = dict(n=n, K=K, precond=precond, modes=modes, solver=solver)
    if level_ok(**fields, grid=EXACT_N, most_k=MAX_K, most_modes=MAX_MODES):
        return EXACT
    if level_ok(**fields, grid=N32, most_k=MAX_K32, most_modes=MAX_MODES32):
        return EXACT32
    if level_ok(**fields, grid=SURR_N, most_k=MAX_K, most_modes=MAX_SURR_MODES):
        return SURR
    return None


def misfit_cluster_takes(*, n, K, precond, modes, solver, warm=False):
    """Whether ``ipx_darcy_misfit`` (``warm``: ``ipx_darcy_misfit_warm``)
    sends a misfit of these fields to the cluster misfit kernels: a spec of
    one of the three levels of ``misfit_cluster_level`` (the 64×64
    samplers' exact level, the 32×32 warm pCN's, the 64×64 DA kernel's
    32×32 surrogate level), or, warm, of the first two (no sampler carries a
    solution on the surrogate level). Every other misfit runs one draw a CTA
    on the layout of its grid (or, at 16×16, on a warp level:
    ``fused_da_pcn.misfit_warp_takes``, ``misfit_slice_takes``)."""
    level = misfit_cluster_level(n=n, K=K, precond=precond, modes=modes, solver=solver)
    return level is not None and not (warm and level == SURR)


def misfit_cluster_geometry(B, *, n=EXACT_N, K=MAX_K, precond="dst_trunc", modes=MAX_MODES,
                            solver="cg"):
    """(draws a cluster, clusters, CTAs, dynamic shared-memory bytes) of a
    launch of the cluster misfit kernels on B draws: G draws a cluster (the
    design's at the level), one a CTA, the spare CTAs of a ragged last
    cluster run on zeros; the samplers' layout (on the 32×32 warm pCN's
    level its own, on the 64×64 DA kernel's surrogate level the 64×64
    one). Raises ``ValueError`` for a misfit that ``misfit_cluster_takes``
    leaves to the other kernels, or B < 0."""
    level = misfit_cluster_level(n=n, K=K, precond=precond, modes=modes, solver=solver)
    if level is None:
        raise ValueError(f"the cluster misfit kernels take a {EXACT_N}x{EXACT_N} dst_trunc CG "
                         f"misfit with K up to {MAX_K} and a multiple of 16 modes up to "
                         f"{MAX_MODES}, or a {N32}x{N32} one with K up to {MAX_K} and up to "
                         f"{MAX_MODES32} modes; got {n}x{n} {precond} ({modes} modes) {solver}, "
                         f"K {K}")
    if B < 0:
        raise ValueError(f"B {B}")
    G, smem = (CLUSTER32_G, smem_bytes32()) if level == EXACT32 else (CLUSTER_G, smem_bytes())
    clusters = -(-B // G)
    return G, clusters, clusters * G, smem
