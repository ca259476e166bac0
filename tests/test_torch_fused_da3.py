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


# --- levels the card runs one chain a CTA (fused_da3_pcn_kernel) ---------------


def _levels_48(noise=0.05):
    """48 / 48 / 24-cell levels (10, 4 and 2 time steps), K = 24 KL modes, 8
    observations: none a level of the warp solve. ((JAX's), (port's))."""
    from test_torch_burgers import burgers_misfit_from_arrays, jburgers, sine_mean

    from ip_mcmc_tpu_torch.models import burgers

    obs = np.arange(2, 48, 6)
    grids = [dict(n_cells=48, cfl_amax=3.0, obs_indices=obs),
             dict(n_cells=48, cfl_amax=1.0, obs_indices=obs),
             dict(n_cells=24, cfl_amax=1.0, obs_indices=obs // 2)]
    aux = []
    for g in grids:
        kw = dict(n_modes=24, alpha=1.5, field_scale=1.0, t_final=0.05,
                  mean_profile=sine_mean(g["n_cells"]), **g)
        aux.append((jburgers.make_burgers_forward(**kw)[1], burgers.burgers_aux(**kw)))
    y = (0.3 * np.random.default_rng(401).standard_normal(8)).astype(np.float32)
    return (tuple(jburgers.make_batched_misfit(a[0], y, noise) for a in aux),
            tuple(burgers_misfit_from_arrays(a[1], y, noise) for a in aux))


def test_da3_chain_on_48_cell_levels_matches_jax():
    """K = d = 24 on 48 / 48 / 24 cells, 32 chains, 2 outer steps: at least
    30 of 32 chains end within 1e-4 of JAX's with the same decisions."""
    jax_pots, pots = _levels_48()
    d, n = 24, 32
    assert da3.route([(p.n, p.K) for p in pots], d) == "cta"
    pos = (0.5 * np.random.default_rng(9).standard_normal((n, d))).astype(np.float32)
    pm, ps = np.zeros(d, np.float32), np.ones(d, np.float32)
    kw = dict(n_steps=2, k_inner=2, k_mid=2, block_chains=16)
    fj, aj, mj = jops.fused_da3_pcn_chain(*jax_pots, jnp.asarray(pos), pm, ps, 0.25, SEED, **kw)
    ft, at, mt = ops.fused_da3_pcn_chain(*pots, torch.from_numpy(pos), pm, ps, 0.25, SEED, **kw)
    ok = _agreeing(ft, fj)
    assert ok.sum() >= 30
    np.testing.assert_array_equal(np.rint(at.numpy()[ok] * 2), np.rint(np.asarray(aj)[ok] * 2))
    np.testing.assert_array_equal(np.rint(mt.numpy()[ok] * 4), np.rint(np.asarray(mj)[ok] * 4))
    assert 0.0 < float(mt.mean()) < 1.0


# the takes-rule (``da3_route``'s mirror): (cells, K) of the fine, middle and
# coarse levels, d, the kernel
ROUTES = [
    (((128, 16), (128, 16), (64, 16)), 16, "warp"),  # burgers_da3_pcn
    (((64, 16), (64, 16), (64, 16)), 16, "warp"),
    (((96, 32), (96, 32), (48, 32)), 32, "cta"),
    (((48, 24), (48, 24), (24, 24)), 24, "cta"),
    (((32, 16), (32, 16), (16, 16)), 16, "cta"),
    (((128, 16), (128, 16), (32, 16)), 16, "cta"),
    (((128, 128), (128, 128), (64, 128)), 128, "cta"),
    (((256, 16), (128, 16), (64, 16)), 16, None),  # above 128 cells
    (((128, 16), (128, 16), (64, 8)), 16, None),  # K != d
    (((128, 144), (128, 144), (64, 144)), 144, None),
]


@pytest.mark.parametrize("levels, d, kernel", ROUTES)
def test_route_sends_each_spec_to_its_kernel(levels, d, kernel):
    """Shipped levels go to the warp kernel, the rest up to 128 cells and
    K = d up to 128 one chain a CTA, others nowhere; ``warp_takes`` is the
    warp route."""
    assert da3.route(levels, d) == kernel
    assert da3.warp_takes(levels, d) == (kernel == "warp")
