"""The Darcy kernels that run in thread-block clusters (at 64×64
``fused_da_pcn_cluster_kernel``, ``fused_pcn_warm_cluster_kernel``; at
32×32 ``fused_pcn_warm_cluster32_kernel``): their launch geometry's Python
mirror (``ops/_cluster.py``; the card tests hold it against the C
function) and the plain twins on a ragged width, which the kernels' spare
CTAs must match on the card."""

import pytest
import torch

from ip_mcmc_tpu_torch import configs
from ip_mcmc_tpu_torch.ops import _cluster
from ip_mcmc_tpu_torch.ops import fused_da_pcn as da
from ip_mcmc_tpu_torch.ops import fused_pcn

torch.set_num_threads(1)

G = _cluster.CLUSTER_G
# the shipped design's bytes (512 threads, 16 warps): f32 buffers of 5 ×
# 4096 cells, partial sums 16 warps × 16 × 8, u 8 × 144, the state 3 × 144,
# 32 warp partials, Φ and a_bar, 8 a_bar and 256 eigenvalues (24,410
# floats, 24,412 after rounding to 16 bytes), then bf16(r) on 4096 cells
# and the coefficients 8 × 264
SMEM = 4 * 24_412 + 2 * (4096 + 8 * 264)
# the 32² warm pCN kernel's (128 threads, 4 warps, G = 8, the factors
# through L2): f32 buffers of 5 × 1024 cells, partial sums 4 × 16 × 8, u
# 8 × 64, the state 3 × 64, 32 warp partials, Φ and a_bar, 8 a_bar and 128
# eigenvalues (6,506 floats, 6,508 after rounding), then bf16(r) on 1024
# cells and the coefficients 8 × 136
SMEM32 = 4 * 6_508 + 2 * (1024 + 8 * 136)
G32 = _cluster.CLUSTER32_G
KW32 = dict(d=64, exact_n=32, exact_modes=128, surr_n=None)


def test_geometry_of_the_shipped_paths():
    """darcy64_da_fused (1024 chains, blocks of 128) and darcy64_pcn_warm
    (2048): G chains a cluster, every chain a CTA, the bytes counted."""
    for config, surr_n in (("darcy64_da_fused", 32), ("darcy64_pcn_warm", None)):
        p = configs.build(config, "cpu")
        pot = p.batched_potential_fn
        kw = dict(d=p.dim, exact_n=pot.n, exact_modes=pot.modes, surr_n=surr_n)
        if surr_n is not None:
            kw["surr_modes"] = p.batched_surrogate_fn.modes
        else:
            kw["exact_modes"] = p.batched_warm_potential[0].modes
        got = _cluster.cluster_geometry(p.n_chains, p.kernel_params["block_chains"], **kw)
        assert got == (G, p.n_chains // G, p.n_chains, SMEM)
    assert SMEM == _cluster.smem_bytes() <= _cluster.MAX_SMEM_BYTES


@pytest.mark.parametrize("n, block, clusters", [(13, 8, 2), (13, 13, 2), (16, 4, 2),
                                                (1, 128, 1), (0, 128, 0), (1024, 128, 128)])
def test_geometry_ragged_widths_and_any_block(n, block, clusters):
    """G does not follow block_chains (a CTA's draws are those of chain
    blockIdx.x); a ragged n gets a last cluster of spare CTAs."""
    g, c, ctas, _ = _cluster.cluster_geometry(n, block)
    assert (g, c, ctas) == (G, clusters, clusters * G)
    assert ctas - n < G


def test_geometry_refuses_what_the_kernels_do_not_take():
    with pytest.raises(ValueError, match="64x64 exact grid"):
        _cluster.cluster_geometry(64, 64, exact_n=40)
    with pytest.raises(ValueError, match="32x32 surrogate"):
        _cluster.cluster_geometry(64, 64, surr_n=16)
    with pytest.raises(ValueError, match="multiple of 16"):
        _cluster.cluster_geometry(64, 64, exact_modes=100)
    with pytest.raises(ValueError, match="multiple of 16"):
        _cluster.cluster_geometry(64, 64, surr_modes=0)
    with pytest.raises(ValueError, match="block_chains"):
        _cluster.cluster_geometry(64, 0)
    with pytest.raises(ValueError, match="d 200 "):
        _cluster.cluster_geometry(64, 64, d=200)
    with pytest.raises(ValueError, match="up to 256"):
        _cluster.cluster_geometry(64, 64, exact_modes=272)
    with pytest.raises(ValueError, match="up to 128"):
        _cluster.cluster_geometry(64, 64, surr_modes=144)
    # a cluster of 64 chains on 1024 threads would need more shared memory
    # than a CTA has
    with pytest.raises(ValueError, match="232448"):
        _cluster.cluster_geometry(64, 64, G=64, threads=1024)


def _agree(got, ref):
    """Chain by chain, the first 13 of the 16-chain run: the plain solves
    batch the chains into one matrix product, whose sums may round in
    another order at another width."""
    assert (got[0] - ref[0][:13]).abs().max() <= 1e-5
    assert torch.equal(got[1], ref[1][:13])


def test_da_twin_on_a_ragged_width_gives_the_first_chains():
    """The 64² DA twin on 13 chains in blocks of 8 (two clusters of 8 on the
    card, 3 spare CTAs) gives the first 13 chains of the 16-chain run."""
    p = configs.build("darcy64_da_fused", "cpu")
    pos = p.init_positions(torch.Generator().manual_seed(21), 16)
    plain = (p.batched_potential_fn._forward_plain, p.batched_surrogate_fn._forward_plain)
    args = (p.prior.mean, p.prior.scale, p.kernel_params["beta"], 9)
    kw = dict(n_steps=2, subchain_len=3, block_chains=8)
    ref = da._run_plain(*plain, pos, *args, **kw)
    got = da._run_plain(*plain, pos[:13], *args, **kw)
    _agree(got, ref)
    assert torch.equal(got[2], ref[2][:13])
    rec = da._run_plain_recorded(*plain, pos[:13], *args, thin=1, **kw)
    assert rec[2].shape == (2, 13, p.dim) and torch.equal(rec[2][-1], rec[0])


def _warm_twin_ragged(config, seed):
    p = configs.build(config, "cpu")
    warm, aux_dim = p.batched_warm_potential
    pos = p.init_positions(torch.Generator().manual_seed(seed), 16)
    args = (p.prior.mean, p.prior.scale, p.kernel_params["beta"], 9, 3, 8)
    ref = fused_pcn._run_plain(warm._forward_warm_plain, pos, *args, aux_dim=aux_dim)
    got = fused_pcn._run_plain(warm._forward_warm_plain, pos[:13], *args, aux_dim=aux_dim)
    _agree(got, ref)


def test_warm_pcn_twin_on_a_ragged_width_gives_the_first_chains():
    """The 64² warm pCN twin on 13 chains in blocks of 8 gives the first 13
    chains of the 16-chain run."""
    _warm_twin_ragged("darcy64_pcn_warm", 22)


@pytest.mark.parametrize("seed", [22, 23])
def test_warm_pcn_twin_at_32_on_a_ragged_width_gives_the_first_chains(seed):
    """The same at 32² (fused_pcn_warm_cluster32_kernel's twin): 13 chains,
    two clusters of 8 CTAs on the card, 3 of them spare."""
    _warm_twin_ragged("darcy32_pcn_warm", seed)


def test_cluster_kernel_names():
    """The launch counts name the cluster kernels (64² and 32²) apart from
    the warm pCN kernel of 16² (the warp kernel, which takes darcy_pcn_warm's
    dst_trunc spec)."""
    big, mid, small = (configs.build(c, "cpu")
                       for c in ("darcy64_pcn_warm", "darcy32_pcn_warm", "darcy_pcn_warm"))
    assert fused_pcn._darcy_stem(big.batched_warm_potential[0], True) == (
        "fused_pcn_warm_cluster_kernel")
    assert fused_pcn._darcy_stem(mid.batched_warm_potential[0], True) == (
        "fused_pcn_warm_cluster32_kernel")
    assert fused_pcn._darcy_stem(small.batched_warm_potential[0], True) == (
        "fused_pcn_warp_kernel[dst_trunc]")
    assert fused_pcn._darcy_stem(big.batched_potential_fn, False) == "fused_pcn_kernel"


def test_geometry_of_the_32_warm_path():
    """darcy32_pcn_warm (4096 chains, blocks of 128): G chains a cluster,
    every chain a CTA, the bytes counted by hand; seven CTAs fit an SM."""
    p = configs.build("darcy32_pcn_warm", "cpu")
    warm = p.batched_warm_potential[0]
    got = _cluster.cluster_geometry(p.n_chains, p.kernel_params["block_chains"], d=p.dim,
                                    exact_n=warm.n, exact_modes=warm.modes, surr_n=None)
    assert got == (G32, p.n_chains // G32, p.n_chains, SMEM32)
    assert SMEM32 == _cluster.smem_bytes32() and 7 * (SMEM32 + 1024) <= 228 * 1024


@pytest.mark.parametrize("n, block, clusters", [(13, 8, 2), (13, 13, 2), (16, 4, 2),
                                                (1, 128, 1), (0, 128, 0), (4095, 128, 512)])
def test_geometry_32_at_ragged_widths(n, block, clusters):
    """At 32² too G does not follow block_chains, and a ragged n gets a last
    cluster of spare CTAs."""
    assert _cluster.cluster_geometry(n, block, **KW32) == (G32, clusters, clusters * G32, SMEM32)


@pytest.mark.parametrize("kw, why", [
    (dict(surr_n=16), "takes no surrogate"),
    (dict(exact_modes=100), "multiple of 16"),
    (dict(exact_modes=144), "up to 128"),
    (dict(d=65), "d 65 .at most 64"),
])
def test_geometry_32_refuses_what_the_kernel_does_not_take(kw, why):
    """A 32² level with a surrogate, modes not a multiple of 16 or above
    the layout's 128, d above its K = 64."""
    with pytest.raises(ValueError, match=why):
        _cluster.cluster_geometry(64, 64, **{**KW32, **kw})


def test_64_geometry_is_unchanged_by_the_32_layout():
    """The 64² kernels keep their layout: the bytes, G and threads of the
    shipped design, whatever the 32² kernel's."""
    assert _cluster.cluster_geometry(1024, 128) == (8, 128, 1024, SMEM)
    assert _cluster.cluster_geometry(2048, 128, surr_n=None) == (8, 256, 2048, SMEM)
    assert (_cluster.CLUSTER_G, _cluster.CLUSTER_THREADS) == (8, 512)


# --- the standalone 64² misfits on the samplers' cluster level ----------------
# (darcy_misfit_cluster_kernel, darcy_misfit_warm_cluster_kernel)


@pytest.mark.parametrize("B, clusters", [(1024, 128), (2048, 256), (13, 2), (1, 1), (0, 0)])
def test_misfit_cluster_geometry(B, clusters):
    """One draw a CTA, G draws a cluster, in the samplers' layout: the
    widths of darcy64_da_fused's exact misfit (1024) and darcy64_pcn_warm's
    warm misfit (2048), a ragged 13 (two clusters, 16 CTAs, 3 spare) and
    none."""
    assert _cluster.misfit_cluster_geometry(B) == (G, clusters, clusters * G, SMEM)


def _takes(pot):
    return _cluster.misfit_cluster_takes(n=pot.n, K=pot.K, precond=pot.precond,
                                         modes=pot.modes, solver=pot.solver)


def test_misfit_cluster_takes_the_specs_of_both_configs():
    """darcy64_da_fused's exact misfit (dst_trunc-256, 16 CG), and
    darcy64_pcn_warm's warm misfit (dst_trunc-256, 4 CG) and cold misfit
    (dst_trunc-256, 30 CG, on no path): each the exact level of the 64²
    samplers; darcy64_da_fused's 32² surrogate is the DA kernel's other
    level, in the same design."""
    da_p, pcn_p = (configs.build(c, "cpu") for c in ("darcy64_da_fused", "darcy64_pcn_warm"))
    for pot in (da_p.batched_potential_fn, pcn_p.batched_warm_potential[0],
                pcn_p.batched_potential_fn):
        assert _takes(pot) and pot.on_cluster
        assert _cluster.misfit_cluster_geometry(
            1024, n=pot.n, K=pot.K, precond=pot.precond, modes=pot.modes,
            solver=pot.solver) == (G, 128, 1024, SMEM)
    surr = da_p.batched_surrogate_fn  # its 32² surrogate: the other level
    assert _takes(surr) and _cluster.misfit_cluster_level(**surr.spec_fields) == _cluster.SURR


@pytest.mark.parametrize("kw", [
    dict(precond="jacobi", modes=0),     # a 64² Jacobi misfit
    dict(modes=100),                     # not a multiple of 16
    dict(modes=272),                     # more than the layout holds
    dict(K=200),                         # K above the layout's 144
    dict(n=32, modes=144),               # the 32² grid above its levels' 128 modes
    dict(solver="richardson"),           # K17's solve
    dict(precond="dst", modes=0),        # the dense dst preconditioner
])
def test_misfit_cluster_leaves_the_other_specs(kw):
    """What the cluster level does not take stays on the kernels of its
    layout (one draw a CTA), and the geometry refuses it."""
    spec = {**dict(n=64, K=144, precond="dst_trunc", modes=256, solver="cg"), **kw}
    assert not _cluster.misfit_cluster_takes(**spec)
    with pytest.raises(ValueError, match="cluster misfit kernels take"):
        _cluster.misfit_cluster_geometry(64, **spec)


def test_misfit_cluster_geometry_refuses_a_negative_width():
    with pytest.raises(ValueError, match="B -1"):
        _cluster.misfit_cluster_geometry(-1)


def test_misfit_kernel_labels():
    """The launch counts name the cluster kernels for the two 64² configs'
    misfits (darcy64_da_fused's surrogate on the DA kernel's 32² level) and
    darcy32_pcn_warm's warm misfit, the warp kernel for
    darcy_da_fused's exact misfit, the slice kernel for darcy_pcn_warm's
    cold 16² Jacobi misfit, and the kernels of their layout for every other
    shipped one."""
    names = {}
    for c in ("darcy64_da_fused", "darcy64_pcn_warm", "darcy32_pcn_warm", "darcy_pcn_warm",
              "darcy_da_fused"):
        p = configs.build(c, "cpu")
        names[c] = [p.batched_potential_fn.kernel_label]
        if p.batched_surrogate_fn is not None:
            names[c].append(p.batched_surrogate_fn.kernel_label)
        if p.batched_warm_potential is not None:
            names[c].append(p.batched_warm_potential[0].warm_kernel_label)
    assert names == {
        "darcy64_da_fused": ["darcy_misfit_cluster_kernel[n=64]",
                             "darcy_misfit_surr_cluster_kernel[n=32]"],
        "darcy64_pcn_warm": ["darcy_misfit_cluster_kernel[n=64]",
                             "darcy_misfit_warm_cluster_kernel"],
        "darcy32_pcn_warm": ["darcy_misfit_kernel[n=32]", "darcy_misfit_warm_cluster32_kernel"],
        "darcy_pcn_warm": ["darcy_misfit_slice_kernel[n=16]",
                           "darcy_misfit_warm_warp_kernel[n=16]"],
        "darcy_da_fused": ["darcy_misfit_warp_kernel[n=16]", "darcy_misfit_warp_kernel[n=8]"],
    }


def test_misfit_kernel_labels_of_64_specs_the_cluster_leaves():
    """A 64² Jacobi misfit, cold and warm, keeps the Layout64 kernels'
    names."""
    from ip_mcmc_tpu_torch.convert import darcy_misfit_from_arrays, darcy_warm_misfit_from_arrays
    from ip_mcmc_tpu_torch.models import darcy

    aux = darcy.darcy_aux(n_grid=64, n_modes_per_dim=12, alpha=2.0, field_scale=10.0)
    y = configs.build("darcy64_pcn_warm", "cpu").data
    cold = darcy_misfit_from_arrays(aux, y, 0.002, cg_iters=16)
    warm, _ = darcy_warm_misfit_from_arrays(aux, y, 0.002, cg_iters=16, precond="jacobi")
    assert not cold.on_cluster and not warm.on_cluster
    assert cold.kernel_label == "darcy_misfit_kernel[n=64]"
    assert warm.warm_kernel_label == "darcy_misfit_warm_kernel"


# --- the standalone 32² misfits on the 32² warm pCN's cluster level -----------
# (darcy_misfit_warm_cluster32_kernel, darcy_misfit_cluster32_kernel)


def _misfit32(**kw):
    """A cold 32² misfit on darcy32_pcn_warm's prior and data (dst_trunc-128,
    16 CG unless ``kw`` says otherwise)."""
    from ip_mcmc_tpu_torch.convert import darcy_misfit_from_arrays
    from ip_mcmc_tpu_torch.models import darcy

    aux = darcy.darcy_aux(n_grid=32, n_modes_per_dim=8, alpha=2.0, field_scale=10.0)
    data = configs.build("darcy32_pcn_warm", "cpu").data
    return darcy_misfit_from_arrays(
        aux, data, 0.002, **{**dict(cg_iters=16, precond="dst_trunc", precond_modes=128), **kw})


@pytest.mark.parametrize("B, clusters", [(4096, 512), (1024, 128), (13, 2), (1, 1), (0, 0)])
def test_misfit_cluster32_geometry(B, clusters):
    """One draw a CTA, G draws a cluster, in the 32² warm pCN's layout:
    darcy32_pcn_warm's width (4096), a ragged 13 (two clusters, 3 spare
    CTAs) and none."""
    kw = dict(n=32, K=64, precond="dst_trunc", modes=128, solver="cg")
    assert _cluster.misfit_cluster_geometry(B, **kw) == (G32, clusters, clusters * G32, SMEM32)


def test_misfit_cluster_takes_the_32_warm_misfit_and_its_cold_twin():
    """darcy32_pcn_warm's warm misfit (dst_trunc-128 / 4 CG, K 64) is a
    level of the 32² warm pCN, and so is a cold dst_trunc CG misfit on the
    same grid (no config's); the config's cold Jacobi misfit is not."""
    p = configs.build("darcy32_pcn_warm", "cpu")
    warm, cold = p.batched_warm_potential[0], _misfit32()
    for pot in (warm, cold):
        assert _takes(pot) and pot.on_cluster and not da.misfit_warp_takes(**pot.spec_fields)
        assert _cluster.misfit_cluster_geometry(p.n_chains, **pot.spec_fields) == (
            G32, p.n_chains // G32, p.n_chains, SMEM32)
    assert warm.warm_kernel_label == "darcy_misfit_warm_cluster32_kernel"
    assert cold.kernel_label == "darcy_misfit_cluster32_kernel[n=32]"
    assert not _takes(p.batched_potential_fn)


@pytest.mark.parametrize("kw, what", [
    (dict(precond="jacobi", cg_iters=96), "darcy32_pcn_warm's cold misfit"),
    (dict(precond="dst", cg_iters=4), "the dense dst preconditioner"),
    (dict(precond_modes=144), "more modes than the layout holds"),
    (dict(precond_modes=120), "not a multiple of 16"),
    (dict(solver="richardson", omega=0.9, cg_iters=3), "K17's solve"),
])
def test_misfit_cluster_leaves_other_32_specs(kw, what):
    """What the 32² cluster level does not take keeps the Layout32 kernels'
    names (one draw a CTA), and the geometry refuses it."""
    if kw.get("precond") == "dst":
        from ip_mcmc_tpu_torch.convert import darcy_warm_misfit_from_arrays
        from ip_mcmc_tpu_torch.models import darcy

        aux = darcy.darcy_aux(n_grid=32, n_modes_per_dim=8, alpha=2.0, field_scale=10.0)
        pot, _ = darcy_warm_misfit_from_arrays(
            aux, configs.build("darcy32_pcn_warm", "cpu").data, 0.002, **kw)
        assert pot.warm_kernel_label == "darcy_misfit_warm_kernel"
    else:
        pot = _misfit32(**kw)
        tag = ",richardson" if pot.solver == "richardson" else ""
        assert pot.kernel_label == f"darcy_misfit_kernel[n=32{tag}]"
    assert not _takes(pot) and not pot.on_cluster, what
    with pytest.raises(ValueError, match="cluster misfit kernels take"):
        _cluster.misfit_cluster_geometry(64, **pot.spec_fields)


def test_misfit_cluster_leaves_the_32_surrogate_of_darcy64_da():
    """darcy64_da_fused's 32² surrogate (dst_trunc-128 / 3 CG) has K 144,
    above the 32² warm pCN level's 64: the 32² level leaves it, and the
    64² DA kernel's surrogate level, tried after it, takes it
    (darcy_misfit_surr_cluster_kernel, the DA kernel's design)."""
    surr = configs.build("darcy64_da_fused", "cpu").batched_surrogate_fn
    assert (surr.n, surr.K, surr.modes) == (32, 144, 128)
    assert _cluster.misfit_cluster_level(**surr.spec_fields) == _cluster.SURR
    assert _takes(surr) and surr.kernel_label == "darcy_misfit_surr_cluster_kernel[n=32]"


def test_the_left_32_warm_jacobi_spec_is_rounding_sensitive_from_zero():
    """chip_smoke.py holds the Layout32 warm kernel on a 32² Jacobi / 16 CG
    misfit (a spec the cluster level leaves) under UNCONVERGED_32_TOL, the
    32² bounds, and not under F32_TOL: from x0 = 0 the solve stops far from
    convergence, where f32 rounding is not damped. The plain version in f32
    against itself in f64 shows it: the median relative difference of Φ is
    more than ten times F32_TOL's median (2e-6), and every draw stays within
    the 32² bounds' largest (5e-3)."""
    from ip_mcmc_tpu_torch.convert import darcy_warm_misfit_from_arrays
    from ip_mcmc_tpu_torch.models import darcy

    p = configs.build("darcy32_pcn_warm", "cpu")
    aux = darcy.darcy_aux(n_grid=32, n_modes_per_dim=8, alpha=2.0, field_scale=10.0)
    warm, aux_dim = darcy_warm_misfit_from_arrays(aux, p.data, 0.002, cg_iters=16,
                                                  precond="jacobi")
    assert not _takes(warm) and warm.warm_kernel_label == "darcy_misfit_warm_kernel"
    U = p.prior.sample(torch.Generator().manual_seed(37), 32).T.contiguous()
    x0 = torch.zeros(aux_dim, 32)
    phi32 = warm._forward_warm_plain(U, x0)[0].double()
    phi64 = warm.double()._forward_warm_plain(U.double(), x0.double())[0]
    rel = (phi32 - phi64).abs() / phi64.abs()
    assert float(rel.median()) > 2e-5
    assert float(rel.max()) <= 5e-3
