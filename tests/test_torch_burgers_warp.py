"""The Burgers DA and pCN one chain a warp (``fused_da_pcn_burgers_warp_kernel``,
``fused_pcn_burgers_warp_kernel``): which specs the card sends to them and
which to the one-chain-a-CTA kernels (``ops/_burgers_warp.py`` ``takes``,
the C rule ``burgers_warp_takes``), their launch geometry's Python mirrors
(``burgers_warp_geometry`` in ``ops/fused_da_pcn.py`` and
``ops/fused_pcn.py``; the card tests and chip_smoke.py hold them against
the C functions), the order in which the warp solve adds Φ over several
observation segments and over a CTA of 64 or 128 old threads, and the plain
twins on a ragged width and on the warp kernels' specs against JAX."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ip_mcmc_tpu import ops as jops
from ip_mcmc_tpu.models import burgers as jburgers
from ip_mcmc_tpu_torch import configs
from ip_mcmc_tpu_torch.configs import burgers_misfit_from_arrays
from ip_mcmc_tpu_torch.models import burgers
from ip_mcmc_tpu_torch.ops import _burgers_warp, _scaffold, fused_pcn
from ip_mcmc_tpu_torch.ops import fused_da_pcn as da

torch.set_num_threads(1)


def staged(*cells):
    """The levels' bases and means staged once a CTA: 17 rows of each
    level's cells, f32."""
    return 4 * 17 * sum(cells)


DA_SLICE = 4 * (3 * 16 + 128)  # a warp's pos0, pos, prop and gather buffer
PCN_SLICE = 4 * (2 * 16 + 128)  # a warp's pos, prop and gather buffer


@pytest.mark.parametrize("n, block, ctas, w", [
    (2048, 512, 128, 16),  # the Burgers configs
    (13, 8, 2, 8),         # a ragged last CTA of 3 spare warps
    (13, 13, 13, 1),       # an odd block: one chain a CTA
    (20, 4, 5, 4),
    (0, 512, 0, 16),
])
def test_warp_geometry(n, block, ctas, w):
    """(CTAs, chains a CTA, bytes): W is the largest power of two up to 16
    that divides block_chains, the bytes the staged levels and W warps'
    slices."""
    assert da.burgers_warp_geometry(n, block) == (ctas, w, staged(128, 64) + w * DA_SLICE)
    assert da.burgers_warp_geometry(n, block, cells=(64, 64)) == (
        ctas, w, staged(64, 64) + w * DA_SLICE)
    assert fused_pcn.burgers_warp_geometry(n, block) == (ctas, w, staged(128) + w * PCN_SLICE)
    assert fused_pcn.burgers_warp_geometry(n, block, cells=64) == (
        ctas, w, staged(64) + w * PCN_SLICE)


def test_warp_geometry_of_the_shipped_configs():
    """burgers_da_pcn: 128 CTAs of 16 chains, 13,056 + 16 × 704 bytes;
    burgers_pcn and burgers_multitime_pcn: 8,704 + 16 × 640."""
    p = configs.build("burgers_da_pcn", "cpu")
    exact, surr = p.batched_potential_fn, p.batched_surrogate_fn
    assert da.burgers_warp_geometry(p.n_chains, 512, cells=(exact.n, surr.n), d=p.dim,
                                    K=exact.K) == (128, 16, 24_320)
    for config in ("burgers_pcn", "burgers_multitime_pcn"):
        q = configs.build(config, "cpu")
        pot = q.batched_potential_fn
        assert fused_pcn.burgers_warp_geometry(q.n_chains, 512, cells=pot.n, d=q.dim,
                                               K=pot.K) == (128, 16, 18_944)


@pytest.mark.parametrize("geometry, kw, why", [
    (da.burgers_warp_geometry, dict(cells=(96, 64)), "cells"),
    (da.burgers_warp_geometry, dict(cells=(128, 32)), "cells"),
    (da.burgers_warp_geometry, dict(d=8, K=8), "d = K = 16"),
    (da.burgers_warp_geometry, dict(K=24), "d = K = 16"),
    (da.burgers_warp_geometry, dict(block_chains=0), "block_chains 0"),
    (fused_pcn.burgers_warp_geometry, dict(cells=96), "cells"),
    (fused_pcn.burgers_warp_geometry, dict(cells=256), "cells"),
    (fused_pcn.burgers_warp_geometry, dict(d=8), "d = K = 16"),
    (fused_pcn.burgers_warp_geometry, dict(n_chains=-1), "n_chains -1"),
])
def test_warp_geometry_refuses_what_the_kernels_do_not_take(geometry, kw, why):
    """Levels the warp solve does not take (the card runs them on the
    one-chain-a-CTA kernels) and arguments no launch takes: ValueError."""
    block, n = kw.pop("block_chains", 512), kw.pop("n_chains", 64)
    with pytest.raises(ValueError, match=why):
        geometry(n, block, **kw)


def test_warp_geometry_refuses_shared_memory_over_the_limit(monkeypatch):
    monkeypatch.setattr(_burgers_warp, "MAX_SMEM_BYTES", 20_000)
    with pytest.raises(ValueError, match="shared memory"):
        da.burgers_warp_geometry(64, 512)
    assert fused_pcn.burgers_warp_geometry(64, 512)[2] == 18_944


# --- which kernel each spec gets ----------------------------------------------


def _level(n_cells, n_modes=16):
    aux = burgers.burgers_aux(n_cells=n_cells, n_modes=n_modes, alpha=1.5, field_scale=1.0,
                              t_final=0.05)
    return burgers_misfit_from_arrays(aux, np.zeros(16, np.float32), 0.02)


@pytest.mark.parametrize("cells, K, d, warp", [
    (128, 16, 16, True),   # burgers_pcn, burgers_multitime_pcn, DA's exact level
    (64, 16, 16, True),    # DA's surrogate
    (96, 16, 16, False),   # a cell count the warp solve does not lay out
    (32, 16, 16, False),
    (256, 16, 16, False),
    (128, 8, 8, False),    # K = d, but not 16
    (64, 8, 8, False),
    (128, 24, 24, False),
    (128, 16, 8, False),   # d != K
    (64, 16, 24, False),
])
def test_stems_name_the_kernel_the_spec_picks(cells, K, d, warp):
    """_burgers_stem names the warp kernel for what burgers_warp_takes
    accepts and the one-chain-a-CTA kernel for the rest, as the C entry
    points choose: for DA both levels must be taken (with the configs'
    64-cell surrogate or 128-cell exact level beside it)."""
    pot = _level(cells, K)
    assert _burgers_warp.takes(cells, K, d) is warp
    assert fused_pcn._burgers_stem(pot, d) == (
        "fused_pcn_burgers_warp_kernel" if warp else "fused_pcn_burgers_kernel")
    other = _level(64 if cells == 128 else 128)
    for pair in ((pot, other), (other, pot)):
        assert da._burgers_stem(*pair, d) == (
            "fused_da_pcn_burgers_warp_kernel" if warp else "fused_da_pcn_burgers_kernel")


def test_kernel_names():
    """The launch counts' names of both warp kernels, plain and recorded."""
    assert _scaffold.kernel_name(da.BURGERS_KERNEL, False) == (
        "fused_da_pcn_burgers_warp_kernel<false>")
    assert _scaffold.kernel_name(fused_pcn.BURGERS_KERNEL, True) == (
        "fused_pcn_burgers_warp_kernel<true>")


# --- the order of Phi's sum ---------------------------------------------------


def _warp_sum(v):
    """warp_sum (block_reduce.cuh) on 32 lanes' f32 values: the butterfly
    v += shfl_xor(v, o) for o = 16, 8, 4, 2, 1; every lane's result."""
    v = v.astype(np.float32)
    for o in (16, 8, 4, 2, 1):
        v = (v + v[np.arange(32) ^ o]).astype(np.float32)
    return v


def _residuals(m, segments, seed):
    """The squared residuals of each segment's m observations, of widely
    spread magnitude, f32: (segments, m)."""
    rng = np.random.default_rng(seed)
    res = (rng.standard_normal((segments, m))
           * 10.0 ** rng.uniform(-4, 4, (segments, m))).astype(np.float32)
    return (res * res).astype(np.float32)


def _burgers_phi_sum(sq, threads):
    """burgers_phi's sum over a CTA of ``threads`` threads: thread t adds
    o = t, t + threads, ... of every segment in order, then block_sum: each
    warp's warp_sum and 0 + warp 0 + warp 1 + ..."""
    per_thread = np.zeros(threads, np.float32)
    for seg in sq:
        for t in range(threads):
            for o in range(t, len(seg), threads):
                per_thread[t] = np.float32(per_thread[t] + seg[o])
    total = np.float32(0.0)
    for w in range(threads // 32):
        total = np.float32(total + _warp_sum(per_thread[32 * w:32 * w + 32])[0])
    return total


def _burgers_phi_warp_sum(sq, T):
    """burgers_phi_warp<C, T>'s sum: lane l keeps a partial for each old
    warp w, adding o = 32 w + l + T r of every segment in order, runs each
    through the butterfly and adds 0 + w0 + ... over the old warps up to the
    last residual. Every lane's result."""
    m = sq.shape[1]
    partial = np.zeros((T // 32, 32), np.float32)
    for seg in sq:
        for w in range(T // 32):
            for lane in range(32):
                for o in range(32 * w + lane, m, T):
                    partial[w, lane] = np.float32(partial[w, lane] + seg[o])
    old_warps = (m + 31) // 32 if m < T else T // 32
    total = np.zeros(32, np.float32)
    for w in range(old_warps):
        total = (total + _warp_sum(partial[w])).astype(np.float32)
    return total


@pytest.mark.parametrize("T", [128, 64])
@pytest.mark.parametrize("m, segments, seed", [
    (16, 3, 0),   # burgers_multitime_pcn: three segments of 16 observations
    (16, 1, 1),   # burgers_pcn, burgers_da_pcn
    (48, 3, 2), (100, 2, 3), (128, 3, 4), (300, 1, 5),
])
def test_warp_level_sum_adds_in_block_sums_order(T, m, segments, seed):
    """The warp solve's Φ sum gives the bits of block_sum over the
    one-chain-a-CTA kernel's T threads, in every lane, across the segments:
    T = 128 where a level has 128 cells, T = 64 where every level of the
    sampler has 64."""
    sq = _residuals(m, segments, seed)
    got = _burgers_phi_warp_sum(sq, T)
    assert np.all(got == got[0])
    assert got[0] == _burgers_phi_sum(sq, T)


def test_the_old_ctas_width_changes_the_bits():
    """With more than 64 observations the sums over 64 and over 128 old
    threads round otherwise on these values: a 64-cell sampler must add in
    its own CTA's order, not in the 128-thread one."""
    sq = _residuals(300, 2, 8)
    assert _burgers_phi_sum(sq, 64) != _burgers_phi_sum(sq, 128)


def test_segments_in_order_differ_from_a_sum_by_segment():
    """Adding each segment's residuals into the old thread's running sum is
    not the same as summing the segments apart and adding the sums: the
    partials must run across the segments."""
    sq = _residuals(16, 3, 8)
    by_segment = np.float32(0.0)
    for seg in sq:
        by_segment = np.float32(by_segment + _burgers_phi_sum(seg[None, :], 128))
    assert by_segment != _burgers_phi_sum(sq, 128)


# --- the plain twins ------------------------------------------------------------


@pytest.mark.parametrize("kind", ["da", "pcn", "pcn_multitime"])
def test_twin_on_a_ragged_width_gives_the_first_chains(kind):
    """The twins on 13 chains in blocks of 8 (two CTAs of 8 warps on the
    card, 3 of them spare) give the first 13 chains of the 16-chain run,
    plain and recorded: a chain's draws depend on its block and lane
    alone."""
    config = {"da": "burgers_da_pcn", "pcn": "burgers_pcn",
              "pcn_multitime": "burgers_multitime_pcn"}[kind]
    p = configs.build(config, "cpu")
    pos = p.init_positions(torch.Generator().manual_seed(43), 16)
    pm, ps = p.prior.mean, p.prior.scale
    for thin in (None, 1):
        if kind == "da":
            exact, surr = p.batched_potential_fn._forward_plain, p.batched_surrogate_fn._forward_plain
            run = ((lambda x: da._run_plain(exact, surr, x, pm, ps, 0.15, 9, 2, 4, 8))
                   if thin is None else
                   (lambda x: da._run_plain_recorded(exact, surr, x, pm, ps, 0.15, 9, 2, 1, 4, 8)))
        else:
            pot = p.batched_potential_fn._forward_plain
            run = lambda x: fused_pcn._run_plain(pot, x, pm, ps, 0.15, 9, 2, 8,  # noqa: E731
                                                 thin=thin)
        ref, got = run(pos), run(pos[:13])
        assert (got[0] - ref[0][:13]).abs().max() <= 1e-5
        assert torch.equal(got[1], ref[1][:13])
        if len(got) > 2 and got[2].dim() == 3:
            assert (got[2] - ref[2][:, :13]).abs().max() <= 1e-5
        elif len(got) > 2:
            assert torch.equal(got[2], ref[2][:13])


def _sine(n):
    return np.sin(2 * np.pi * (np.arange(n) + 0.5) / n)


def _jax_levels():
    """The JAX package's misfits of the Burgers configs' levels on the
    port's frozen data: fine (128 cells / 154 steps), multi-time (54 + 54 +
    46 steps) and the calibrated 64-cell surrogate."""
    fx = np.load(configs.BURGERS_FIXTURE)
    kw = dict(n_cells=128, n_modes=16, alpha=1.5, field_scale=1.0, t_final=0.2,
              mean_profile=_sine(128))
    _, aux = jburgers.make_burgers_forward(**kw)
    _, aux_m = jburgers.make_burgers_forward(**kw, obs_times=[0.07, 0.14, 0.2])
    obs_c = np.clip(np.round((np.asarray(aux["obs_indices"]) + 0.5) * 64 / 128 - 0.5)
                    .astype(int), 0, 63)
    _, aux_c = jburgers.make_burgers_forward(n_cells=64, n_modes=16, alpha=1.5, field_scale=1.0,
                                             t_final=0.2, mean_profile=_sine(64),
                                             obs_indices=obs_c, cfl_amax=1.0)
    assert aux["n_steps"] == 154 and aux_m["segment_steps"] == [54, 54, 46]
    assert aux_c["n_steps"] == 26
    return {"fine": jburgers.make_batched_misfit(aux, fx["y"], 0.02),
            "multi": jburgers.make_batched_misfit(aux_m, fx["y_multitime"], 0.02),
            "surr": jburgers.make_batched_misfit(aux_c, fx["y_surr_64"], fx["scale_64"])}


@pytest.fixture(scope="module")
def jax_levels():
    return _jax_levels()


def _assert_agree(out_j, out_t, steps):
    """Every input f32 (the strict bound of tests/test_torch_fused_pcn.py,
    at 16 chains): at least 15 of 16 chains end (and record) within 1e-4
    of JAX's, and those accepted the same number of steps."""
    out_j = [np.asarray(o) for o in out_j]
    out_t = [o.numpy() for o in out_t]
    ok = np.abs(out_t[0] - out_j[0]).max(axis=1) <= 1e-4
    if len(out_j) > 2 and out_j[2].ndim == 3:
        ok &= (np.abs(out_t[2] - out_j[2]).max(axis=2) <= 1e-4).all(axis=0)
    assert ok.sum() >= 15
    np.testing.assert_array_equal(np.rint(out_t[1][ok] * steps), np.rint(out_j[1][ok] * steps))
    assert 0.0 < out_t[1].mean() <= 1.0


@pytest.mark.parametrize("recorded", [False, True])
@pytest.mark.parametrize("kind", ["da", "pcn", "pcn_multitime"])
def test_twin_on_the_warp_kernels_specs_matches_jax(jax_levels, kind, recorded):
    """On the specs the warp kernels take (the Burgers configs' own 128 /
    64-cell levels, K = d = 16) the same numpy-drawn positions through the
    JAX Pallas kernel (interpret mode) and the port's twin: 16 chains in
    blocks of 8, 2 steps (DA: k = 4)."""
    config = {"da": "burgers_da_pcn", "pcn": "burgers_pcn",
              "pcn_multitime": "burgers_multitime_pcn"}[kind]
    p = configs.build(config, "cpu")
    pos = (0.5 * np.random.default_rng(47).standard_normal((16, 16))).astype(np.float32)
    pm, ps = np.zeros(16, np.float32), np.ones(16, np.float32)
    common = dict(n_steps=2, block_chains=8, **({"thin": 1} if recorded else {}))
    if kind == "da":
        pots_t = (p.batched_potential_fn, p.batched_surrogate_fn)
        assert da._burgers_stem(*pots_t) == da.BURGERS_KERNEL
        jfn = jops.fused_da_pcn_chain_recorded if recorded else jops.fused_da_pcn_chain
        tfn = da.fused_da_pcn_chain_recorded if recorded else da.fused_da_pcn_chain
        out_j = jfn(jax_levels["fine"], jax_levels["surr"], jnp.asarray(pos), pm, ps, 0.15, 5,
                    subchain_len=4, **common)
        out_t = tfn(*pots_t, torch.from_numpy(pos), pm, ps, 0.15, 5, subchain_len=4, **common)
        if not recorded:  # the inner acceptance, of 2 x 4 surrogate steps
            np.testing.assert_allclose(out_t[2].numpy(), np.asarray(out_j[2]), atol=0.13)
    else:
        pot_t = p.batched_potential_fn
        assert fused_pcn._burgers_stem(pot_t) == fused_pcn.BURGERS_KERNEL
        pot_j = jax_levels["multi" if kind == "pcn_multitime" else "fine"]
        jfn = jops.fused_pcn_chain_recorded if recorded else jops.fused_pcn_chain
        tfn = fused_pcn.fused_pcn_chain_recorded if recorded else fused_pcn.fused_pcn_chain
        out_j = jfn(pot_j, jnp.asarray(pos), pm, ps, 0.15, 5, **common)
        out_t = tfn(pot_t, torch.from_numpy(pos), pm, ps, 0.15, 5, **common)
    if recorded:
        assert out_t[2].shape == (2, 16, 16)
    _assert_agree(out_j, out_t, 2)
