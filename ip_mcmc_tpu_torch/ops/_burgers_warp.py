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
