"""What the Burgers samplers' warp kernels take, and their launch geometry.

The three samplers on the Burgers misfit — three-level DA
(``fused_da3_pcn_warp_kernel``), two-level DA
(``fused_da_pcn_burgers_warp_kernel``) and pCN
(``fused_pcn_burgers_warp_kernel``) — run one chain a warp on the warp solve
of ``csrc/burgers_misfit.cuh``, which takes levels of WARP_CELLS cells and
d = K = WARP_D (``takes`` mirrors ``burgers_warp_takes``). The DA and pCN
entry points send every other spec to their one-chain-a-CTA kernels; the
three-level DA has no other kernel and refuses it. ``geometry`` mirrors
the three kernels' geometry functions.

The standalone misfit (``ipx_burgers_misfit``, ``csrc/fused_da3_pcn.cu``)
runs the same solve a draw a warp (``burgers_misfit_warp_kernel``) on a
level that ``misfit_takes`` (the warp solve's levels at d = K) and one draw
a CTA (``burgers_misfit_kernel``) on any other; ``misfit_geometry``
mirrors ``ipx_burgers_misfit_warp_geometry``.
"""

from __future__ import annotations

WARP_CELLS, WARP_D = (64, 128), 16
# Shared memory: each level's basis and mean staged once a CTA ((K + 1)
# rows of its cells), then a slice a warp: its positions (WARP_D floats
# each) and the gather buffer of the larger level
LEVEL_FLOATS = WARP_D + 1
MAX_SMEM_BYTES = 232_448  # what a CTA of the H100 may use


def takes(cells, K, d) -> bool:
    """Whether the warp solve takes a level of ``cells`` cells and K modes
    for chains of d coordinates, as ``burgers_warp_takes`` decides."""
    return cells in WARP_CELLS and K == WARP_D and d == WARP_D


def slice_bytes(positions: int) -> int:
    """A warp's slice: ``positions`` positions and the gather buffer."""
    return 4 * (positions * WARP_D + max(WARP_CELLS))


def geometry(kernel, n_chains, block_chains, *, cells, d, K, chains, positions):
    """A warp kernel's launch: (CTAs, chains a CTA, dynamic shared-memory
    bytes) for levels of ``cells`` and a slice of ``positions`` positions a
    warp. Chains a CTA: the largest power of two up to ``chains`` that
    divides ``block_chains`` (a CTA's chains share an RNG block); a ragged
    last CTA runs spare warps. Raises ``ValueError`` for levels the warp
    solve does not take and for shared memory the card cannot give a CTA."""
    if not all(takes(c, K, d) for c in cells):
        raise ValueError(
            f"the {kernel} takes levels of {WARP_CELLS} cells and d = K = {WARP_D}; "
            f"got {tuple(cells)} cells, d = {d}, K = {K}")
    if block_chains <= 0 or n_chains < 0:
        raise ValueError(f"n_chains {n_chains}, block_chains {block_chains}")
    w = chains
    while block_chains % w:
        w //= 2
    smem = 4 * LEVEL_FLOATS * sum(cells) + w * slice_bytes(positions)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"{smem} bytes of shared memory a CTA: the card gives "
                         f"{MAX_SMEM_BYTES}")
    return -(-n_chains // w), w, smem


# The standalone misfit a draw a warp (``MisfitBurgersWarpDesign`` in
# ``csrc/fused_da3_pcn.cu``): draws (warps) a CTA. Its shared memory: the
# level's basis and mean staged once a CTA, then a slice a warp: the draw's
# WARP_D coefficients and the gather buffer of the level's cells.
MISFIT_WARP_DRAWS = 16
MISFIT_WARP_KERNEL = "burgers_misfit_warp_kernel"


def misfit_takes(cells, K) -> bool:
    """Whether ``ipx_burgers_misfit`` sends a misfit of ``cells`` cells and
    K modes to ``burgers_misfit_warp_kernel``: a level that the warp solve
    takes for chains of K coordinates (``burgers_warp_takes(s, s.K)``).
    Every other misfit runs on ``burgers_misfit_kernel``."""
    return takes(cells, K, K)


def misfit_geometry(B, cells, K=WARP_D):
    """(draws a CTA, CTAs, dynamic shared-memory bytes) of a launch of
    ``burgers_misfit_warp_kernel`` on B draws, as
    ``misfit_burgers_warp_geometry`` computes it: a draw a warp,
    MISFIT_WARP_DRAWS a CTA, the spare warps of a ragged last CTA leave
    after the staging. Raises ``ValueError`` for a misfit that
    ``misfit_takes`` leaves to the one-draw-a-CTA kernel, or B < 0."""
    if not misfit_takes(cells, K):
        raise ValueError(f"the Burgers warp misfit kernel takes levels of {WARP_CELLS} "
                         f"cells and K = {WARP_D}; got {cells} cells, K = {K}")
    if B < 0:
        raise ValueError(f"B {B}")
    smem = 4 * (LEVEL_FLOATS * cells + MISFIT_WARP_DRAWS * (WARP_D + cells))
    return MISFIT_WARP_DRAWS, -(-B // MISFIT_WARP_DRAWS), smem
