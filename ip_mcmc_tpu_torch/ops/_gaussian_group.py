"""What the linear-Gaussian group kernels take, and their launch geometry.

Random-walk Metropolis (K14, ``fused_rwm_group_kernel``) and dense-prior
pCN (K15, ``fused_pcn_dense_group_kernel``) run a chain on each group of G
= d lanes, 32 / G chains a warp, for the ``LinearGaussianPotential`` specs
that ``gaussian_group_takes`` in ``csrc/gaussian_potential.cuh`` takes
(``takes`` mirrors it): d = 2 or 32 (the widths instantiated), K = d, 0 ≤ m
≤ d — the shipped compare_paths, gauss2d_rwm and lingauss_pcn targets.
Every other spec runs on the one-chain-a-CTA ``fused_rwm_kernel`` /
``fused_pcn_dense_kernel``, as before. ``geometry`` mirrors
``gaussian_group_geometry``.
"""

from __future__ import annotations

# ``GaussianGroupDesign`` in ``csrc/gaussian_potential.cuh``: warps a CTA of
# both group kernels, and the least lanes a chain
WARPS, MIN_WIDTH = 8, 2
DIMS = (2, 32)


def takes(d, m, K) -> bool:
    """Whether the group kernels take a potential of m rows and K columns
    for chains of d coordinates, as ``gaussian_group_takes`` decides."""
    return d in DIMS and K == d and 0 <= m <= d


def width(d) -> int:
    """G, the lanes of a chain of d coordinates: d, or MIN_WIDTH if that is
    more (``gaussian_group_width``)."""
    return max(d, MIN_WIDTH)


def geometry(n_chains, block_chains, *, d, m, K=None):
    """The launch of the group kernels: (lanes a chain G, warps a CTA,
    CTAs), as ``gaussian_group_geometry`` computes it. Chain c runs on group
    c mod (32 / G) of warp c // (32 / G); a ragged last warp or CTA runs
    spare groups. Raises ``ValueError`` for a spec the group kernels do not
    take (the card runs it one chain a CTA) and for a width or block the
    card refuses."""
    K = d if K is None else K
    if not takes(d, m, K):
        raise ValueError(f"the linear-Gaussian group kernels take d = K in {DIMS} and "
                         f"m <= d; got d = {d}, K = {K}, m = {m}")
    if block_chains <= 0 or n_chains < 0:
        raise ValueError(f"n_chains {n_chains}, block_chains {block_chains}")
    g = width(d)
    return g, WARPS, -(-n_chains // (WARPS * (32 // g)))
