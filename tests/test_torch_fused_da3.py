"""The port's fused three-level delayed-acceptance pCN
(ip_mcmc_tpu_torch/ops/fused_da3_pcn.py, plain loop on the CPU) against the
JAX Pallas kernel in interpret mode on a small three-level Burgers problem;
and the algorithm properties of tests/test_fused_da.py::TestDA3 on
analytic targets."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ip_mcmc_tpu import ops as jops
from ip_mcmc_tpu_torch import ops
from ip_mcmc_tpu_torch.ops import fused_da3_pcn as da3
from test_torch_burgers import small_burgers_levels

torch.set_num_threads(1)

N, D, BLOCK, SEED = 64, 16, 32, 5  # two blocks: the block seed is exercised
PM, PS = np.zeros(D, np.float32), np.ones(D, np.float32)


@pytest.fixture(scope="module")
def levels():
    return small_burgers_levels()


def _positions():
    return np.random.default_rng(7).standard_normal((N, D)).astype(np.float32)


def _agreeing(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max(axis=-1) <= 1e-4


def test_da3_chain_matches_jax(levels):
    """Same positions, seed and stream. The misfits agree to ~1e-6 relative
    (tests/test_torch_burgers.py), so an MH decision can differ only where
    log u lies that close to the ratio: at least 62 of 64 chains end within
    1e-4 of JAX's, and those took the same fine and middle decisions."""
    jax_pots, pots = levels
    pos = _positions()
    kw = dict(n_steps=3, k_inner=2, k_mid=3, block_chains=BLOCK)
    fj, aj, mj = jops.fused_da3_pcn_chain(*jax_pots, jnp.asarray(pos), PM, PS,
                                          0.25, SEED, **kw)
    ft, at, mt = ops.fused_da3_pcn_chain(*pots, torch.from_numpy(pos), PM, PS,
                                         0.25, SEED, **kw)
    assert ft.shape == (N, D) and at.shape == mt.shape == (N,)
    ok = _agreeing(ft, fj)
    assert ok.sum() >= 62
    np.testing.assert_array_equal(np.rint(at.numpy()[ok] * 3),
                                  np.rint(np.asarray(aj)[ok] * 3))
    np.testing.assert_array_equal(np.rint(mt.numpy()[ok] * 9),
                                  np.rint(np.asarray(mj)[ok] * 9))
    # the chains move and both corrections are exercised
    assert 0.0 < float(at.mean()) < 1.0 and 0.0 < float(mt.mean()) < 1.0
    assert not torch.equal(ft, torch.from_numpy(pos))


def test_da3_chain_recorded_matches_jax(levels):
    jax_pots, pots = levels
    pos = _positions()
    kw = dict(n_steps=4, thin=2, k_inner=2, k_mid=2, block_chains=BLOCK)
    fj, aj, sj = jops.fused_da3_pcn_chain_recorded(
        *jax_pots, jnp.asarray(pos), PM, PS, 0.25, SEED + 1, **kw)
    ft, at, st = ops.fused_da3_pcn_chain_recorded(
        *pots, torch.from_numpy(pos), PM, PS, 0.25, SEED + 1, **kw)
    assert st.shape == np.asarray(sj).shape == (2, N, D)
    ok = _agreeing(ft, fj) & _agreeing(st, sj).all(axis=0)
    assert ok.sum() >= 62
    np.testing.assert_array_equal(np.rint(at.numpy()[ok] * 4),
                                  np.rint(np.asarray(aj)[ok] * 4))
    assert torch.equal(st[-1], ft)


# --- algorithm properties on analytic targets (TestDA3) ---------------------

DA = 4
PREC = torch.linspace(0.5, 2.0, DA)  # posterior precision = 1 + PREC
TM, TS = torch.zeros(DA), torch.ones(DA)


def phi_exact(U):  # (d, block) -> (block,)
    return 0.5 * torch.sum(PREC[:, None] * U * U, dim=0)


def test_perfect_levels_always_accept():
    """All three potentials equal: both correction ratios are identically
    1, so the fine and the middle acceptance are exactly 1."""
    pos = torch.randn(256, DA, generator=torch.Generator().manual_seed(1))
    _, acc, mid = ops.fused_da3_pcn_chain(
        phi_exact, phi_exact, phi_exact, pos, TM, TS, 0.3, 5, n_steps=30,
        k_inner=4, k_mid=3, block_chains=256)
    np.testing.assert_array_equal(acc.numpy(), 1.0)
    np.testing.assert_array_equal(mid.numpy(), 1.0)


def test_exact_posterior_with_biased_levels():
    """Deliberately wrong coarse and middle levels still yield the exact
    posterior (both corrections are exact MH ratios)."""

    def surr_c(U):  # badly biased coarse level
        return 0.8 * phi_exact(U + 0.3) + 1.7

    def surr_m(U):  # mildly biased middle level
        return 1.05 * phi_exact(U + 0.05) - 0.4

    pos = torch.randn(512, DA, generator=torch.Generator().manual_seed(0))
    n_steps = 400
    _, _, samples = ops.fused_da3_pcn_chain_recorded(
        phi_exact, surr_m, surr_c, pos, TM, TS, 0.3, 3, n_steps=n_steps,
        thin=1, k_inner=4, k_mid=2, block_chains=256)
    flat = samples[n_steps // 4:].reshape(-1, DA).numpy()
    np.testing.assert_allclose(flat.mean(axis=0), np.zeros(DA), atol=0.06)
    np.testing.assert_allclose(flat.var(axis=0), 1.0 / (1.0 + PREC.numpy()),
                               rtol=0.12)


def test_recorded_matches_plain_endpoint_and_extra_out_is_the_middle_rate():
    def surr_c(U):
        return 0.9 * phi_exact(U) + 0.2

    def surr_m(U):
        return phi_exact(U) - 0.1

    pos = torch.randn(256, DA, generator=torch.Generator().manual_seed(3))
    args = (phi_exact, surr_m, surr_c, pos, TM, TS, 0.3, 9)
    f1, a1, mid = ops.fused_da3_pcn_chain(*args, n_steps=40, k_inner=3,
                                          k_mid=2, block_chains=128)
    f2, a2, s2 = ops.fused_da3_pcn_chain_recorded(
        *args, n_steps=40, thin=1, k_inner=3, k_mid=2, block_chains=128)
    assert torch.equal(f1, f2) and torch.equal(a1, a2)
    assert s2.shape == (40, 256, DA) and torch.equal(s2[-1], f2)
    # a constant offset leaves the middle ratio (Φm − Φc differences) to the
    # coarse level's 0.9 scaling: some but not all middle steps accept, and
    # the rate is a count over n_steps · k_mid
    counts = mid.numpy() * 80
    np.testing.assert_allclose(counts, np.rint(counts), atol=1e-3)
    assert 0.0 < float(mid.mean()) < 1.0
    # the fine correction only sees the middle level's constant offset
    np.testing.assert_array_equal(a1.numpy(), 1.0)


def test_shape_checks_and_kernel_potential_types(levels):
    pos = torch.zeros(48, DA)
    with pytest.raises(ValueError, match="multiple of block_chains"):
        ops.fused_da3_pcn_chain(phi_exact, phi_exact, phi_exact, pos, TM, TS,
                                0.3, 0, n_steps=2, block_chains=32)
    with pytest.raises(ValueError, match="multiple of thin"):
        ops.fused_da3_pcn_chain_recorded(phi_exact, phi_exact, phi_exact, pos,
                                         TM, TS, 0.3, 0, n_steps=3, thin=2,
                                         block_chains=16)
    # the CUDA kernel takes BurgersMisfit specs only; it refuses a callable
    # before touching any device
    _, pots = levels
    with pytest.raises(TypeError, match="mid_fn.*BurgersMisfit"):
        da3._launch(pots[0], phi_exact, pots[2], torch.zeros(32, D), PM, PS,
                    0.3, 0, 2, 2, 2, 16)
