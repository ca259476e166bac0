"""The linear-Gaussian samplers on a group of lanes a chain
(``fused_rwm_group_kernel``, ``fused_pcn_dense_group_kernel``): which specs
the card sends to them and which to the one-chain-a-CTA kernels
(``ops/_gaussian_group.py`` ``takes``, the C rule ``gaussian_group_takes``),
their launch geometry's Python mirror (the card tests and chip_smoke.py hold
it against the C function), the order in which a group adds Φ's sum of
squares against ``block_sum``'s in a one-warp CTA, bit for bit, and the
plain twins on the shipped specs against the JAX Pallas kernels in
interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ip_mcmc_tpu import ops as jops
from ip_mcmc_tpu_torch import configs
from ip_mcmc_tpu_torch.convert import linear_gaussian_from_arrays
from ip_mcmc_tpu_torch.ops import _gaussian_group, fused_pcn_dense, fused_rwm

torch.set_num_threads(1)

GROUP = ("fused_rwm_group_kernel", "fused_pcn_dense_group_kernel")
ONE_A_CTA = ("fused_rwm_kernel", "fused_pcn_dense_kernel")


def potential(m, d, seed=0):
    r = np.random.default_rng(seed)
    return linear_gaussian_from_arrays(r.standard_normal((m, d)) / np.sqrt(max(d, 1)),
                                       r.standard_normal(m), 0.5)


# --- which kernel a spec gets ---------------------------------------------------


@pytest.mark.parametrize("pot, d, want, width", [
    (lambda: linear_gaussian_from_arrays(np.eye(2), np.zeros(2), [1.0, 0.5]), 2, GROUP, 2),
    (configs.gauss2d_batched_potential, 2, GROUP, 2),  # A = Lᵀ, with the prior
    (lambda: linear_gaussian_from_arrays(*configs.lingauss_arrays()[::2], 0.05), 32,
     GROUP, 32),                                              # lingauss: m 16, d 32
    (lambda: potential(0, 2), 2, GROUP, 2),                   # Φ ≡ 0
    (lambda: potential(1, 2), 2, GROUP, 2),
    (lambda: potential(5, 2), 2, ONE_A_CTA, None),            # m > d
    (lambda: potential(3, 2), 2, ONE_A_CTA, None),
    (lambda: potential(32, 32), 32, GROUP, 32),
    (lambda: potential(0, 32), 32, GROUP, 32),
    (lambda: potential(1, 32), 32, GROUP, 32),
    (lambda: potential(3, 3), 3, ONE_A_CTA, None),            # d not instantiated
    (lambda: potential(8, 16), 16, ONE_A_CTA, None),
    (lambda: potential(40, 32), 32, ONE_A_CTA, None),         # m > d
    (lambda: potential(16, 64), 64, ONE_A_CTA, None),         # d > 32
], ids=["compare_paths", "gauss2d", "lingauss", "m0", "d2_m1", "d2_m5", "d2_m3", "d32_m32",
        "d32_m0", "d32_m1", "d3", "d16", "m40", "d64"])
def test_which_kernel_a_spec_gets(pot, d, want, width):
    """The rule's answer as the launch counts name it, for RWM and dense
    pCN; G for what it takes, ValueError from the geometry for the rest."""
    pot = pot()
    assert (fused_rwm.stem(pot, d), fused_pcn_dense.stem(pot, d)) == want
    assert _gaussian_group.takes(d, pot.m, pot.K) == (width is not None)
    if width is None:
        with pytest.raises(ValueError, match="group kernels take"):
            _gaussian_group.geometry(64, 32, d=d, m=pot.m)
    else:
        assert _gaussian_group.geometry(64, 32, d=d, m=pot.m)[0] == width


def test_darcy_rwm_keeps_its_kernel():
    """A Darcy misfit runs on fused_rwm_darcy_kernel; a callable has no
    kernel."""
    pot = configs.build("darcy_pcn_4096", "cpu").batched_potential_fn
    assert fused_rwm.stem(pot, 64) == "fused_rwm_darcy_kernel"
    with pytest.raises(TypeError, match="potentials only"):
        fused_rwm.stem(lambda U: U.sum(0), 2)


def test_the_rule_asks_k_equal_to_d():
    assert _gaussian_group.takes(2, 2, 2) and not _gaussian_group.takes(2, 2, 3)
    assert not _gaussian_group.takes(32, -1, 32) and not _gaussian_group.takes(2, 3, 2)


# --- launch geometry ----------------------------------------------------------------


def ctas(n, g, warps):
    return -(-n // (warps * (32 // g)))


@pytest.mark.parametrize("n, block, d, m, g", [
    (8192, 1024, 2, 2, 2),  # compare_paths
    (1024, 512, 2, 2, 2),   # gauss2d_rwm --fused
    (2048, 256, 32, 16, 32),  # lingauss_pcn fused
    (13, 8, 2, 2, 2),       # ragged: spare groups in a live warp
    (13, 8, 32, 16, 32),    # ragged: spare warps in the last CTA
    (8193, 1024, 2, 2, 2),  # one chain in the last CTA
    (2049, 256, 32, 16, 32),
    (1, 1, 2, 1, 2),
    (0, 256, 32, 16, 32),
])
def test_group_geometry(n, block, d, m, g):
    """(G, warps a CTA, CTAs): G = d lanes a chain, 32 / G chains a warp,
    the design's warps a CTA, the CTAs rounded up; nothing depends on
    block_chains but its check."""
    w = _gaussian_group.WARPS
    assert _gaussian_group.geometry(n, block, d=d, m=m) == (g, w, ctas(n, g, w))


def test_group_geometry_of_the_shipped_paths():
    """compare_paths: 16 chains a warp, 8 warps a CTA, 64 CTAs; lingauss:
    a chain a warp, 8 a CTA, 256 CTAs."""
    assert _gaussian_group.geometry(8192, 1024, d=2, m=2) == (2, 8, 64)
    assert _gaussian_group.geometry(2048, 256, d=32, m=16) == (32, 8, 256)


@pytest.mark.parametrize("n, block, d, m, K", [
    (64, 32, 3, 3, 3), (64, 32, 32, 33, 32), (64, 32, 2, 2, 4), (64, 0, 2, 2, 2),
    (-1, 32, 2, 2, 2), (64, 32, 2, 3, 2), (64, 32, 2, 5, 2),
])
def test_group_geometry_refuses(n, block, d, m, K):
    with pytest.raises(ValueError):
        _gaussian_group.geometry(n, block, d=d, m=m, K=K)


# --- the group's sum against block_sum's, bit for bit -------------------------------


def butterfly(v, offsets):
    """The xor butterfly of a warp: every lane i adds lane i ^ o's value,
    stage by stage, in f32 (v + shfl_xor(v, o))."""
    lanes = np.arange(v.shape[-1])
    for o in offsets:
        v = (v + v[..., lanes ^ o]).astype(np.float32)
    return v


def squares(rng, m):
    """r r of m rows, rounded to f32, magnitudes over twelve decades (so
    that the order of the sum shows in its last bits)."""
    r = (rng.standard_normal(m) * 10.0 ** rng.uniform(-6, 6, m)).astype(np.float32)
    return (r * r).astype(np.float32)


@pytest.mark.parametrize("m, g", [(2, 2), (2, 16), (2, 32), (16, 16), (16, 32), (32, 32)])
def test_group_sum_is_block_sums_value(m, g):
    """block_sum in a one-warp CTA: 0 + lane 0's butterfly over offsets
    16 ... 1, the lanes at or above m adding zeros. The group kernel: a
    butterfly over offsets G/2 ... 1 inside each group of G lanes of a warp
    that runs 32 / G chains. Equal bit for bit, in every lane of the group,
    over three seeds; a left-to-right sum is not (the order is what is
    tested)."""
    differs = []
    for seed in range(3):
        rng = np.random.default_rng(seed)
        chains = [squares(rng, m) for _ in range(32 // g)]
        warp = np.zeros(32, np.float32)
        for k, sq in enumerate(chains):
            warp[k * g:k * g + m] = sq
        offsets = [o for o in (16, 8, 4, 2, 1) if o < g]
        grouped = butterfly(warp, offsets)
        for k, sq in enumerate(chains):
            cta = np.zeros(32, np.float32)
            cta[:m] = sq
            want = np.float32(0.0) + butterfly(cta, (16, 8, 4, 2, 1))[0]
            got = grouped[k * g:(k + 1) * g]
            assert np.array_equal(got.view(np.uint32),
                                  np.full(g, want, np.float32).view(np.uint32))
            seq = np.float32(0.0)
            for v in sq:
                seq = np.float32(seq + v)
            differs.append(seq != want)
    if m >= 16:
        assert any(differs)


# --- the twins on the shipped specs against JAX -------------------------------------

N, BLOCK, STEPS = 64, 32, 20


def assert_chains_agree(out_j, out_t):
    """Every chain ends, and records, within 1e-4 of JAX's, with the same
    number of accepted steps (the RNG is bit for bit; the sums round in
    other orders)."""
    out_j = [np.asarray(o) for o in out_j]
    out_t = [o.numpy() for o in out_t]
    ok = np.abs(out_t[0] - out_j[0]).max(axis=1) <= 1e-4
    if len(out_j) == 3:
        ok &= (np.abs(out_t[2] - out_j[2]).max(axis=2) <= 1e-4).all(axis=0)
    assert ok.mean() >= 0.99
    np.testing.assert_array_equal(np.rint(out_t[1] * STEPS), np.rint(out_j[1] * STEPS))
    assert 0.0 < out_t[1].mean() < 1.0


def lingauss():
    A, lam, y, sigma = configs.lingauss_arrays()
    L = np.diag(np.sqrt(lam)).astype(np.float32)
    return A, lam, y, sigma, L


def dense_cholesky(lam, seed=7):
    """chip_smoke.py's dense L: every entry below the diagonal nonzero."""
    d = len(lam)
    g = np.random.default_rng(seed).standard_normal((d, d))
    D = np.diag(np.sqrt(np.asarray(lam, np.float64)))
    return np.linalg.cholesky(D @ (g @ g.T / d + 0.5 * np.eye(d)) @ D).astype(np.float32)


@pytest.mark.parametrize("recorded", [False, True])
@pytest.mark.parametrize("case", ["rwm_gauss2d_prior", "pcn_dense_lingauss_diag",
                                  "pcn_dense_lingauss_dense"])
def test_shipped_specs_match_jax(case, recorded):
    """gauss2d_rwm --fused's target (the config's phi_batched + the N(0,
    10²) prior, as the JAX runner's phi_full) and lingauss_pcn's misfit with
    its prior's L (diagonal, and a dense lower-triangular one): the plain
    twins against the JAX kernels."""
    rng = np.random.default_rng(11)
    kw = dict(n_steps=STEPS, block_chains=BLOCK)
    if recorded:
        kw["thin"] = 4
    if case == "rwm_gauss2d_prior":
        mean = jnp.asarray(configs.GAUSS2D_MEAN)
        prec = jnp.asarray(np.linalg.inv(configs.GAUSS2D_COV.astype(np.float64)), jnp.float32)

        def phi_full(U):
            dd = U - mean[:, None]
            z = U / 10.0
            return 0.5 * jnp.sum(dd * (prec @ dd), axis=0) + 0.5 * jnp.sum(z * z, axis=0)

        pos = (3.0 * rng.standard_normal((N, 2))).astype(np.float32)
        args = dict(step_size=1.0, seed=13, **kw)
        fn_j = jops.fused_rwm_chain_recorded if recorded else jops.fused_rwm_chain
        fn_t = ops_fn(fused_rwm, recorded)
        out_j = fn_j(phi_full, jnp.asarray(pos), **args)
        out_t = fn_t(configs.gauss2d_batched_potential(), torch.from_numpy(pos),
                     prior_mean=np.zeros(2, np.float32),
                     prior_scale=np.full(2, 10.0, np.float32), **args)
    else:
        A, lam, y, sigma, L = lingauss()
        if case.endswith("dense"):
            L = dense_cholesky(lam)
        phi_j = lambda U: 0.5 * jnp.sum(((y[:, None] - A @ U) / sigma) ** 2, axis=0)
        pos = (rng.standard_normal((N, 32)) * np.sqrt(lam)).astype(np.float32)
        args = (np.zeros(32, np.float32), L, 0.2, 17)
        fn_j = (jops.fused_pcn_chain_dense_recorded if recorded
                else jops.fused_pcn_chain_dense)
        out_j = fn_j(phi_j, jnp.asarray(pos), *args, **kw)
        out_t = ops_fn(fused_pcn_dense, recorded)(
            linear_gaussian_from_arrays(A, y, sigma), torch.from_numpy(pos), *args, **kw)
    assert_chains_agree(out_j, out_t)


def ops_fn(module, recorded):
    name = {fused_rwm: "fused_rwm_chain", fused_pcn_dense: "fused_pcn_chain_dense"}[module]
    return getattr(module, name + ("_recorded" if recorded else ""))
