"""The adaptive pCN burn-in in one launch (``fused_pcn_adapt_group_kernel``,
K16): which burn-ins the card runs on it and which keep the two launches a
step (``ops/fused_pcn_adapt.py`` ``group_takes``, the C rule
``pcn_adapt_group_takes``), its launch geometry's Python mirror (the card
tests and chip_smoke.py hold it against the C function), the order in
which its folding warp sums a block's acceptance probabilities against
``_fold_sum``'s, bit for bit, and the plain twin on the shipped spec's
shapes against the JAX Pallas kernel in interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ip_mcmc_tpu import ops as jops
from ip_mcmc_tpu_torch import configs, ops
from ip_mcmc_tpu_torch.convert import linear_gaussian_from_arrays
from ip_mcmc_tpu_torch.ops import _build, fused_pcn_adapt

torch.set_num_threads(1)

GROUP, STEPS = fused_pcn_adapt.GROUP_KERNEL, "fused_pcn_adapt_kernel"


def potential(m, d, seed=0):
    r = np.random.default_rng(seed)
    return linear_gaussian_from_arrays(r.standard_normal((m, d)) / np.sqrt(max(d, 1)),
                                       r.standard_normal(m), 0.5)


def lingauss():
    A, lam, y, sigma = configs.lingauss_arrays()
    return linear_gaussian_from_arrays(A, y, sigma), lam


# --- which route a burn-in takes, and its launch ----------------------------------


@pytest.mark.parametrize("d, m, K, n, block, geometry", [
    (32, 16, 32, 2048, 256, (32, 16, 8, 64)),     # the shipped lingauss_pcn burn-in
    (32, 16, 32, 256, 256, (32, 16, 8, 8)),
    (32, 32, 32, 512, 128, (32, 16, 4, 16)),
    (32, 0, 32, 300, 100, (32, 16, 4, 12)),       # a ragged last CTA: 4 of 32 chains
    (32, 1, 32, 14, 7, (32, 16, 1, 2)),
    (32, 16, 32, 0, 256, (32, 16, 8, 0)),
    (2, 2, 2, 1024, 256, (2, 16, 1, 4)),          # a block of d = 2 in one CTA
    (2, 1, 2, 1, 1, (2, 16, 1, 1)),
])
def test_the_group_kernel_takes(d, m, K, n, block, geometry):
    assert fused_pcn_adapt.group_takes(d, m, K, block, n)
    assert fused_pcn_adapt.group_geometry(n, block, d=d, m=m, K=K) == geometry
    G, warps, cluster, ctas = geometry
    # a block on one cluster, every CTA of it running chains of the block
    per = fused_pcn_adapt.group_chains(d)
    assert per == warps * fused_pcn_adapt.TURNS * 32 // G
    assert (cluster - 1) * per < block <= cluster * per
    assert cluster <= fused_pcn_adapt.MAX_CLUSTER and ctas == n // block * cluster


@pytest.mark.parametrize("d, m, K, n, block", [
    (3, 3, 3, 256, 256),       # d not instantiated
    (16, 8, 16, 256, 256),
    (64, 16, 64, 256, 256),
    (32, 40, 32, 256, 256),    # m > d
    (2, 5, 2, 256, 256),
    (32, 16, 16, 256, 256),    # K != d
    (32, 16, 32, 1024, 512),   # a block larger than one cluster
    (2, 2, 2, 1024, 512),      # larger than the folding warp holds
    (32, 16, 32, 2000, 256),   # n not a multiple of the block
    (32, 16, 32, 256, 0),
], ids=["d3", "d16", "d64", "m40", "d2_m5", "K16", "block512", "d2_block512", "ragged_n",
        "block0"])
def test_the_group_kernel_leaves(d, m, K, n, block):
    assert not fused_pcn_adapt.group_takes(d, m, K, block, n)
    with pytest.raises(ValueError, match="adaptive group kernel takes"):
        fused_pcn_adapt.group_geometry(n, block, d=d, m=m, K=K)


@pytest.mark.parametrize("m, d, block, n, want", [
    (16, 32, 256, 2048, GROUP),
    (2, 2, 64, 128, GROUP),
    (40, 32, 256, 2048, STEPS),
    (3, 3, 64, 128, STEPS),
    (16, 32, 512, 1024, STEPS),
])
def test_which_kernel_a_burn_in_gets(m, d, block, n, want):
    assert fused_pcn_adapt.stem(potential(m, d), d, block, n) == want


def test_the_gain_table_is_gain_at():
    """The group kernel's γ table equals the host loop's γ_i bit for bit."""
    for gain, n in ((0.5, 2020), (np.float32(0.37), 7), (2.0, 0)):
        table = fused_pcn_adapt.gains(gain, n)
        want = np.array([fused_pcn_adapt.gain_at(gain, i) for i in range(n)], np.float32)
        assert table.dtype == np.float32 and table.shape == (n,)
        assert np.array_equal(table.view(np.uint32), want.view(np.uint32))


def test_the_c_constants_are_mirrored():
    """The design line and the fold's slots, as csrc/fused_pcn_adapt.cu
    states them."""
    text = (_build.CSRC / "fused_pcn_adapt.cu").read_text()
    w, t, c = fused_pcn_adapt.WARPS, fused_pcn_adapt.TURNS, fused_pcn_adapt.MAX_CLUSTER
    assert (f"static constexpr int kWarps = {w}, kTurns = {t}, kMaxCluster = {c}"
            in text)
    assert f"constexpr int kFoldSlots = {fused_pcn_adapt.FOLD_SLOTS};" in text
    assert fused_pcn_adapt.group_max_block(32) == fused_pcn_adapt.group_max_block(2) == 256


# --- the folding warp's order -------------------------------------------------------


def kernel_fold(p, slots):
    """NumPy mirror of ``fold_sum`` in csrc/fused_pcn_adapt.cu: lane l of
    one warp holds value l + 32 k in slot k; while more than 32 values are
    left, value e < n − h takes value e + h (h = ⌈n/2⌉ = 32 q + r: slot k +
    q of lane (l + r) mod 32, or slot k + q + 1 where l + r wraps), the
    slots in ascending order and in place; then shuffles down by h in slot
    0. The sum in lane 0."""
    n = len(p)
    assert n <= 32 * slots
    v = np.zeros((32, slots), np.float32)
    v.T.flat[:n] = p
    lane = np.arange(32)
    zero = np.zeros(32, np.float32)
    while n > 32:
        h = (n + 1) // 2
        q, r = divmod(h, 32)
        assert q <= slots // 2  # the kernel instantiates rounds Q = 0 .. S / 2
        for k in range(slots):
            lo = v[:, k + q] if k + q < slots else zero
            hi = v[:, k + q + 1] if k + q + 1 < slots else zero
            src = (lane + r) % 32
            s = np.where(lane + r < 32, lo[src], hi[src]) if r else lo.copy()
            v[:, k] = np.where(lane + 32 * k < n - h, v[:, k] + s, v[:, k])
        n = h
    s = v[:, 0].copy()
    while n > 1:
        h = (n + 1) // 2
        o = np.where(lane + h < 32, s[np.minimum(lane + h, 31)], s)  # __shfl_down_sync
        s = np.where(lane < n - h, s + o, s)
        n = h
    return s[0]


@pytest.mark.parametrize("n", [1, 7, 31, 32, 33, 100, 255, 256, 512])
def test_the_folding_warp_adds_in_fold_sum_order(n):
    """Random f32 p in [0, 1], some exactly 0 and 1: the warp's sum equals
    ``_fold_sum``'s (pcn_adapt_update_kernel's order) bit for bit, at the
    kernel's 8 values a lane (16 for a block of 512, which the kernel
    leaves to the two launches)."""
    rng = np.random.default_rng(n)
    for _ in range(20):
        p = rng.random(n).astype(np.float32)
        p[rng.random(n) < 0.1] = 0.0
        p[rng.random(n) < 0.1] = 1.0
        want = fused_pcn_adapt._fold_sum(torch.from_numpy(p)[None, :])[0].numpy()
        got = kernel_fold(p, max(fused_pcn_adapt.FOLD_SLOTS, -(-n // 32)))
        assert got.view(np.uint32) == want.view(np.uint32)


def test_another_order_differs():
    """The mirror is sharp: summing in index order gives other bits on some
    of these blocks."""
    rng = np.random.default_rng(0)
    differs = 0
    for _ in range(50):
        p = rng.random(256).astype(np.float32)
        seq = np.float32(0.0)
        for x in p:
            seq = np.float32(seq + x)
        differs += seq != kernel_fold(p, 8)
    assert differs > 0


# --- the plain twin on the CPU ------------------------------------------------------


def test_cpu_tensors_run_the_plain_version():
    """A spec the group kernel takes runs plain on the CPU: no kernel count."""
    pot, lam = lingauss()
    pos = torch.from_numpy(np.random.default_rng(1).standard_normal((64, 32)).astype(
        np.float32) * np.sqrt(lam).astype(np.float32))
    before = dict(_build.launch_counts)
    out, acc, beta = ops.fused_pcn_chain_adapt(pot, pos, np.zeros(32), np.sqrt(lam), 0.5, 3,
                                               n_steps=4, block_chains=32)
    counts = _build.launch_counts
    assert counts["fused_pcn_adapt_plain"] == before.get("fused_pcn_adapt_plain", 0) + 1
    assert counts[GROUP] == before.get(GROUP, 0)
    assert out.shape == pos.shape and acc.shape == beta.shape == (64,)
    assert bool(torch.isfinite(out).all())


def test_lingauss_burn_in_matches_jax():
    """The shipped spec's shapes (lingauss_pcn's misfit, d = 32, m = 16, a
    diagonal prior), 64 chains in blocks of 32, 12 steps: the chains and
    acceptance as the other linear-Gaussian tests hold them, β per block
    within 1e-5 relative of JAX's (γ_i and the pooled sum round otherwise
    in JAX, tests/test_torch_fused_rwm.py)."""
    A, lam, y, sigma = configs.lingauss_arrays()
    pot = linear_gaussian_from_arrays(A, y, sigma)
    Aj, yj = jnp.asarray(A, jnp.float32), jnp.asarray(y, jnp.float32)
    phi_j = lambda x: 0.5 * jnp.sum(((yj[:, None] - Aj @ x) / sigma) ** 2, axis=0)
    scale = np.sqrt(lam).astype(np.float32)
    pos = (np.random.default_rng(2).standard_normal((64, 32)) * scale).astype(np.float32)
    kw = dict(prior_mean=np.zeros(32, np.float32), prior_scale=scale, beta0=0.3, seed=5,
              n_steps=12, target_accept=0.234, block_chains=32)
    out_j = [np.asarray(o) for o in jops.fused_pcn_chain_adapt(phi_j, jnp.asarray(pos), **kw)]
    out_t = [o.numpy() for o in ops.fused_pcn_chain_adapt(pot, torch.from_numpy(pos), **kw)]
    assert np.mean(np.abs(out_j[0] - out_t[0]).max(axis=1) <= 1e-4) >= 0.99
    np.testing.assert_array_equal(np.rint(out_t[1] * 12), np.rint(out_j[1] * 12))
    assert 0.0 < out_t[1].mean() < 1.0
    np.testing.assert_allclose(out_t[2], out_j[2], rtol=1e-5)
    assert np.all(out_t[2].reshape(-1, 32) == out_t[2].reshape(-1, 32)[:, :1])
