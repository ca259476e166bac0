"""Two standalone misfits on their samplers' solves: the warm value and
gradient of ``darcy_mala_warm`` a draw a warp on the warm MALA kernel's
``WarpDstSliceLevel`` (``darcy_misfit_grad_warm_warp_kernel``,
``csrc/fused_mala.cu``), and ``darcy64_da_fused``'s 32² surrogate on the 64²
DA kernel's ``ClusterSurr`` level, a draw a CTA, 8 a thread-block cluster
(``darcy_misfit_surr_cluster_kernel``, ``csrc/fused_da_pcn.cu``).

On the CPU: which misfits the two rules take (the Python mirrors
``fused_mala.misfit_grad_warm_warp_takes`` and ``_cluster.misfit_cluster_level``
of the C rules), which launch-count name each misfit gets, the launch
geometry's mirrors (the card tests and ``chip_smoke.py`` hold them against
the C functions), and the warm pair's plain twin, which the kernel must
match on the card, against the JAX package's ``make_batched_misfit_mala_warm``
on the shipped spec."""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ip_mcmc_tpu.models import darcy as jdarcy
from ip_mcmc_tpu_torch import configs
from ip_mcmc_tpu_torch.convert import darcy_mala_warm_misfit_from_arrays, darcy_misfit_from_arrays
from ip_mcmc_tpu_torch.convert import darcy_warm_misfit_from_arrays
from ip_mcmc_tpu_torch.models import darcy
from ip_mcmc_tpu_torch.ops import _build, _cluster, fused_mala

torch.set_num_threads(1)

WARM = "darcy_misfit_grad_warm_warp_kernel[n=16]"
OLD_WARM = "darcy_misfit_grad_warm_kernel"
SURR = "darcy_misfit_surr_cluster_kernel[n=32]"
# the warm kernel's bytes: the KL basis staged once a CTA (64 rows of 256
# cells padded by 4 after every 32: 288 floats), S and Sᵀ as bf16 rows of 24
# and the dst eigenvalues (288 floats), then a slice a warp for 16 warps: u
# (64), then a, x, p, th, tv and the dst stage buffer (288 each)
WARM_SMEM = 4 * 64 * 288 + (2 * 2 * 16 * 24 + 4 * 288) + 16 * 4 * (64 + 6 * 288)
# the surrogate kernel's: the 64² DA kernel's layout (ClusterSmem: five f32
# arrays of 4096 cells, the warps' partial sums, u, the state, the
# reductions and 256 eigenvalues; bf16 r and the cluster's coefficients)
SURR_SMEM = 4 * 24_412 + 2 * (4096 + 8 * 264)


def _pag():
    return configs.build("darcy_mala_warm", "cpu").batched_warm_potential[0]


def _surrogate():
    return configs.build("darcy64_da_fused", "cpu").batched_surrogate_fn


def _warm_pairs_left():
    """Warm value-and-gradient pairs the warm warp rule leaves: 16² Jacobi
    and dst_trunc-128 (6 CG each), an 8² and a 32² dense dst pair, and a 16²
    dense dst pair with K = 36."""
    y = configs.build("darcy_mala_warm", "cpu").data

    def pair(n_grid=16, modes_per_dim=8, data=y, **kw):
        aux = darcy.darcy_aux(n_grid=n_grid, n_modes_per_dim=modes_per_dim, alpha=2.0,
                              field_scale=10.0)
        return darcy_mala_warm_misfit_from_arrays(aux, data, 0.002, **{"cg_iters": 6, **kw})[0]

    return {
        "jacobi16": pair(precond="jacobi"),
        "dst_trunc16": pair(precond="dst_trunc", precond_modes=128),
        "dst8": pair(n_grid=8, data=y[:4]),
        "dst32": pair(n_grid=32, data=configs.build("darcy32_pcn_warm", "cpu").data),
        "K36": pair(modes_per_dim=6),
    }


def _surrogates_left():
    """32² cold misfits on the surrogate's prior and data that the cluster
    levels leave: K 196 (a finer prior than the layout holds), Jacobi / 16
    CG, K17's Richardson and 144 modes."""
    fx = np.load(configs.DARCY64_DA_FIXTURE)

    def misfit(modes_per_dim=12, **kw):
        aux = darcy.darcy_aux(n_grid=32, n_modes_per_dim=modes_per_dim, alpha=2.0,
                              field_scale=10.0, obs_indices=fx["obs_coarse"])
        kw = {"cg_iters": 3, "precond": "dst_trunc", "precond_modes": 128, **kw}
        return darcy_misfit_from_arrays(aux, fx["y_surr"], fx["surr_scale"], **kw)

    return {
        "K196": misfit(14),
        "jacobi": misfit(precond="jacobi", cg_iters=16),
        "richardson": misfit(solver="richardson", omega=0.9),
        "modes144": misfit(precond_modes=144),
    }


SURR_LEFT_LABELS = {"K196": "darcy_misfit_kernel[n=32]", "jacobi": "darcy_misfit_kernel[n=32]",
                    "richardson": "darcy_misfit_kernel[n=32,richardson]",
                    "modes144": "darcy_misfit_kernel[n=32]"}


# --- the warm value and gradient a draw a warp ---------------------------------


def test_warm_rule_takes_the_warm_pair_of_darcy_mala_warm():
    """darcy_mala_warm's warm pair (16², K 64, dense dst / 6 CG): the rule
    takes it, the label names the kernel a draw a warp, and its geometry at
    the config's width is 256 CTAs of 16 draws."""
    pag = _pag()
    assert (pag.n, pag.K, pag.precond, pag.modes, pag.cg_iters, pag.solver) == (
        16, 64, "dst", 0, 6, "cg")
    assert fused_mala.misfit_grad_warm_warp_takes(**pag.spec_fields)
    assert not fused_mala.misfit_grad_warp_takes(**pag.spec_fields)  # the cold rule's Jacobi
    assert pag.grad_warm_kernel_label == WARM
    assert fused_mala.misfit_grad_warm_warp_geometry(4096, **pag.spec_fields) == (
        16, 256, WARM_SMEM)


@pytest.mark.parametrize("name", ["jacobi16", "dst_trunc16", "dst8", "dst32", "K36"])
def test_warm_rule_leaves_the_other_warm_pairs(name):
    """Each other warm pair keeps the one-draw-a-CTA kernel's name, and the
    geometry mirror refuses it."""
    pag = _warm_pairs_left()[name]
    assert not fused_mala.misfit_grad_warm_warp_takes(**pag.spec_fields)
    assert pag.grad_warm_kernel_label == OLD_WARM
    with pytest.raises(ValueError, match="warm warp gradient misfit kernel takes"):
        fused_mala.misfit_grad_warm_warp_geometry(64, **pag.spec_fields)


@pytest.mark.parametrize("kw", [
    dict(n=32),                            # another grid
    dict(n=8),                             # the 8² grid
    dict(K=36),                            # another K
    dict(precond="jacobi"),                # the cold kernel's preconditioner
    dict(precond="dst_trunc", modes=128),  # the truncated one
    dict(modes=16),                        # dense dst with modes
    dict(solver="richardson"),             # K17's solve
])
def test_warm_rule_leaves_other_specs(kw):
    spec = {**dict(n=16, K=64, precond="dst", modes=0, solver="cg"), **kw}
    assert not fused_mala.misfit_grad_warm_warp_takes(**spec)
    with pytest.raises(ValueError, match="warm warp gradient misfit kernel takes"):
        fused_mala.misfit_grad_warm_warp_geometry(64, **spec)


# --- the 32² surrogate on the 64² DA kernel's level -----------------------------


def test_cluster_rule_takes_the_surrogate_of_darcy64_da():
    """darcy64_da_fused's surrogate (32², K 144, dst_trunc-128 / 3 CG): the
    third level of the cluster rule, in the DA kernel's design (8 draws a
    cluster, the 64² layout); a warm misfit on the same spec keeps the
    Layout32 warm kernel (no sampler carries a solution on this level)."""
    surr = _surrogate()
    assert (surr.n, surr.K, surr.precond, surr.modes, surr.cg_iters, surr.solver) == (
        32, 144, "dst_trunc", 128, 3, "cg")
    assert _cluster.misfit_cluster_level(**surr.spec_fields) == _cluster.SURR
    assert surr.on_cluster and surr.kernel_label == SURR
    assert _cluster.misfit_cluster_geometry(1024, **surr.spec_fields) == (8, 128, 1024, SURR_SMEM)
    assert not _cluster.misfit_cluster_takes(**surr.spec_fields, warm=True)
    fx = np.load(configs.DARCY64_DA_FIXTURE)
    aux = darcy.darcy_aux(n_grid=32, n_modes_per_dim=12, alpha=2.0, field_scale=10.0,
                          obs_indices=fx["obs_coarse"])
    warm, _ = darcy_warm_misfit_from_arrays(aux, fx["y_surr"], fx["surr_scale"], cg_iters=3,
                                            precond="dst_trunc", precond_modes=128)
    assert warm.warm_kernel_label == "darcy_misfit_warm_kernel"


@pytest.mark.parametrize("name", sorted(SURR_LEFT_LABELS))
def test_cluster_rule_leaves_the_other_32_surrogates(name):
    """K 196, Jacobi, Richardson and 144 modes: no cluster level takes them;
    they keep the Layout32 kernel's name, and the geometry refuses them."""
    pot = _surrogates_left()[name]
    assert _cluster.misfit_cluster_level(**pot.spec_fields) is None
    assert not pot.on_cluster and pot.kernel_label == SURR_LEFT_LABELS[name]
    with pytest.raises(ValueError, match="cluster misfit kernels take"):
        _cluster.misfit_cluster_geometry(64, **pot.spec_fields)


@pytest.mark.parametrize("K, level", [(64, _cluster.EXACT32), (36, _cluster.EXACT32),
                                      (100, _cluster.SURR), (144, _cluster.SURR),
                                      (145, None)])
def test_the_32_levels_split_at_K_64(K, level):
    """A 32² dst_trunc-128 CG spec: K up to 64 stays on the 32² warm pCN's
    level (tried first), 64 < K ≤ 144 goes to the surrogate level, above
    144 to neither."""
    spec = dict(n=32, K=K, precond="dst_trunc", modes=128, solver="cg")
    assert _cluster.misfit_cluster_level(**spec) == level
    assert _cluster.misfit_cluster_takes(**spec) == (level is not None)
    assert _cluster.misfit_cluster_takes(**spec, warm=True) == (level == _cluster.EXACT32)


def test_a_32_spec_with_K_64_keeps_the_32_level():
    """A cold 32² dst_trunc-128 / 16 CG misfit with K 64 (darcy32_pcn_warm's
    prior): the 32² warm pCN's level and its kernel's name."""
    aux = darcy.darcy_aux(n_grid=32, n_modes_per_dim=8, alpha=2.0, field_scale=10.0)
    pot = darcy_misfit_from_arrays(aux, configs.build("darcy32_pcn_warm", "cpu").data, 0.002,
                                   cg_iters=16, precond="dst_trunc", precond_modes=128)
    assert _cluster.misfit_cluster_level(**pot.spec_fields) == _cluster.EXACT32
    assert pot.kernel_label == "darcy_misfit_cluster32_kernel[n=32]"


# --- the geometry mirrors -------------------------------------------------------


@pytest.mark.parametrize("B, ctas, clusters", [(4096, 256, 512), (1024, 64, 128), (13, 1, 2),
                                               (1, 1, 1), (0, 0, 0)])
def test_geometry(B, ctas, clusters):
    """The warm kernel: a draw a warp, 16 a CTA (4096: darcy_mala_warm's
    width; a ragged 13, 3 spare warps). The surrogate: a draw a CTA, 8 a
    cluster (1024: darcy64_da_fused's width; 13: two clusters, 3 spare
    CTAs)."""
    pag, surr = _pag(), _surrogate()
    assert fused_mala.misfit_grad_warm_warp_geometry(B, **pag.spec_fields) == (16, ctas, WARM_SMEM)
    assert _cluster.misfit_cluster_geometry(B, **surr.spec_fields) == (
        8, clusters, 8 * clusters, SURR_SMEM)
    assert max(WARM_SMEM, SURR_SMEM) <= fused_mala.MAX_SMEM_BYTES == _cluster.MAX_SMEM_BYTES


@pytest.mark.parametrize("which", ["warm", "surrogate"])
def test_geometry_refuses_a_negative_width(which):
    spec = (_pag() if which == "warm" else _surrogate()).spec_fields
    geometry = (fused_mala.misfit_grad_warm_warp_geometry if which == "warm"
                else _cluster.misfit_cluster_geometry)
    with pytest.raises(ValueError, match="B -1"):
        geometry(-1, **spec)


def test_mirror_constants_follow_the_design_lines():
    """The mirrors' draws a CTA and cluster are the C design lines'."""
    mala = (_build.CSRC / "fused_mala.cu").read_text()
    m = re.search(r"struct MisfitGradWarmWarpDesign \{ static constexpr int kWarps = (\d+), "
                  r"kSmWarps = \d+; \};", mala)
    assert m is not None and int(m.group(1)) == fused_mala.GRAD_WARM_WARP_DRAWS
    solve = (_build.CSRC / "darcy_misfit.cuh").read_text()
    m = re.search(r"struct ClusterDesign \{ static constexpr int kG = (\d+), kCells = \d+, "
                  r"kThreads = (\d+),", solve)
    assert m is not None and (int(m.group(1)), int(m.group(2))) == (
        _cluster.CLUSTER_G, _cluster.CLUSTER_THREADS)


# --- the plain twins ----------------------------------------------------------------


def test_plain_twins_run_on_the_cpu_and_count_themselves():
    """On CPU tensors the two misfits run their plain versions (the
    kernels' twins) and count plain launches, never the kernels'."""
    pag, surr = _pag(), _surrogate()
    before = dict(_build.launch_counts)
    U64 = torch.randn(64, 3, generator=torch.Generator().manual_seed(0))
    phi, g, aux = pag(U64, torch.zeros(pag.aux_dim, 3))
    assert phi.shape == (3,) and g.shape == (64, 3) and aux.shape == (512, 3)
    assert surr(torch.randn(144, 2, generator=torch.Generator().manual_seed(1))).shape == (2,)
    for name in ("darcy_misfit_grad_warm_plain", "darcy_misfit_plain[n=32]"):
        assert _build.launch_counts[name] == before.get(name, 0) + 1
    for name in (WARM, OLD_WARM, SURR):
        assert _build.launch_counts[name] == before.get(name, 0)


def test_warm_twin_matches_jax_on_the_shipped_spec():
    """The warm kernel's twin on darcy_mala_warm's spec (dense dst / 6 + 6
    CG, its constants and data) against the JAX package's
    make_batched_misfit_mala_warm, 4 prior-scale draws, from aux0 = 0 and
    from JAX's aux after a MALA-sized move: bf16 preconditioner inputs, so
    an ulp-level difference can flip a rounding that six iterations do not
    damp (the bounds of tests/test_torch_darcy_grad.py's dst rows: Φ within
    5e-3, the median draw within 2e-5; ∇Φ and λ per draw within 2e-2 of
    their largest entry, x within 5e-3)."""
    pag = _pag()
    _, aux_j = jdarcy.make_darcy_forward(n_grid=16, n_modes_per_dim=8, alpha=2.0,
                                         field_scale=10.0)
    wj, ad = jdarcy.make_batched_misfit_mala_warm(aux_j, jnp.asarray(pag.data.numpy()), 0.002,
                                                  cg_iters=6, precond="dst")
    assert ad == pag.aux_dim == 512
    rng = np.random.default_rng(11)
    U = rng.standard_normal((64, 4)).astype(np.float32)
    U2 = (U + 0.012 * rng.standard_normal((64, 4))).astype(np.float32)
    j1 = wj(jnp.asarray(U), jnp.zeros((ad, 4), jnp.float32))
    j2 = wj(jnp.asarray(U2), j1[2])
    t1 = pag(torch.from_numpy(U), torch.zeros(ad, 4))
    t2 = pag(torch.from_numpy(U2), torch.tensor(np.asarray(j1[2])))
    for want, got in ((j1, t1), (j2, t2)):
        want, got = [np.asarray(w) for w in want], [g.numpy() for g in got]
        rel = np.abs(got[0] - want[0]) / np.abs(want[0])
        assert np.median(rel) <= 2e-5 and rel.max() <= 5e-3
        for rows, worst in ((slice(0, 256), 5e-3), (slice(256, 512), 2e-2), (None, 2e-2)):
            g, w = (got[2][rows], want[2][rows]) if rows is not None else (got[1], want[1])
            err = np.abs(g - w).max(axis=0) / np.abs(w).max(axis=0)
            assert err.max() <= worst, err
