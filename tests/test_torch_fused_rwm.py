"""The port's fused samplers on linear-Gaussian targets — random-walk
Metropolis (K14), dense-prior pCN (K15) and burn-in pCN with in-kernel β
adaptation (K16) — against the JAX Pallas kernels in interpret mode
(plain scaffold on the CPU), 64 chains in blocks of 32, 50 steps.

The RNG is bit for bit the JAX kernels', and every potential here is all
f32, so the chains take the same decisions; what differs is the rounding of
Φ and of the proposal (matmul order, FMA contraction), at 1e-7."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ip_mcmc_tpu import ops as jops
from ip_mcmc_tpu_torch import ops
from ip_mcmc_tpu_torch.convert import linear_gaussian_from_arrays
from ip_mcmc_tpu_torch.ops import fused_pcn_adapt

torch.set_num_threads(1)

N, BLOCK, STEPS = 64, 32, 50
MEAN = np.array([1.0, -0.5], np.float32)
VAR = np.array([2.0, 0.5], np.float32)


def pot_batch(x):
    """benchmarks/compare_paths.py's target, features-first."""
    return 0.5 * jnp.sum((x - MEAN[:, None]) ** 2 / VAR[:, None], axis=0)


def compare_paths_potential():
    return linear_gaussian_from_arrays(np.eye(2), np.zeros(2), np.sqrt(VAR),
                                       center=MEAN)


def positions(d, seed=1, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal((N, d))).astype(
        np.float32)


def assert_chains_agree(out_j, out_t, steps=STEPS):
    """At least 99% of the chains (so all 64) end, and record, within 1e-4
    of JAX's, with the same number of accepted steps."""
    out_j = [np.asarray(o) for o in out_j]
    out_t = [o.numpy() for o in out_t]
    ok = np.abs(out_t[0] - out_j[0]).max(axis=1) <= 1e-4
    if len(out_j) == 3 and out_j[2].ndim == 3:
        assert out_t[2].shape == out_j[2].shape
        ok &= (np.abs(out_t[2] - out_j[2]).max(axis=2) <= 1e-4).all(axis=0)
    assert ok.mean() >= 0.99
    np.testing.assert_array_equal(np.rint(out_t[1] * steps), np.rint(out_j[1] * steps))
    assert 0.0 < out_t[1].mean() < 1.0
    return out_j, out_t


@pytest.mark.parametrize("recorded", [False, True])
def test_rwm_chain_matches_jax(recorded):
    pos = positions(2)
    kw = dict(step_size=0.9, seed=3, n_steps=STEPS, block_chains=BLOCK)
    if recorded:
        out_j = jops.fused_rwm_chain_recorded(pot_batch, jnp.asarray(pos), thin=5, **kw)
        out_t = ops.fused_rwm_chain_recorded(compare_paths_potential(),
                                             torch.from_numpy(pos), thin=5, **kw)
        assert out_t[2].shape == (STEPS // 5, N, 2)
    else:
        out_j = jops.fused_rwm_chain(pot_batch, jnp.asarray(pos), **kw)
        out_t = ops.fused_rwm_chain(compare_paths_potential(),
                                    torch.from_numpy(pos), **kw)
    assert_chains_agree(out_j, out_t)


def test_rwm_chain_with_prior_matches_jax_runner_target():
    """prior_mean / prior_scale: the target of the JAX runner's fused RWM
    branch, phi_full = misfit + ½‖(U − μ)/s‖² (ip_mcmc_tpu/runner.py l.637),
    on the lingauss-shaped misfit of 8 observations in 6 dimensions."""
    r = np.random.default_rng(5)
    A = (r.standard_normal((8, 6)) / np.sqrt(6)).astype(np.float32)
    y = r.standard_normal(8).astype(np.float32)
    pm = np.linspace(-0.5, 0.5, 6).astype(np.float32)
    ps = np.linspace(0.5, 2.0, 6).astype(np.float32)

    def phi_full(U):
        z = (U - pm[:, None]) / ps[:, None]
        misfit = 0.5 * jnp.sum(((y[:, None] - A @ U) / 0.3) ** 2, axis=0)
        return misfit + 0.5 * jnp.sum(z * z, axis=0)

    pos = positions(6, seed=2)
    kw = dict(step_size=0.3, seed=4, n_steps=STEPS, block_chains=BLOCK)
    out_j = jops.fused_rwm_chain(phi_full, jnp.asarray(pos), **kw)
    out_t = ops.fused_rwm_chain(linear_gaussian_from_arrays(A, y, 0.3),
                                torch.from_numpy(pos), prior_mean=pm,
                                prior_scale=ps, **kw)
    assert_chains_agree(out_j, out_t)
    with pytest.raises(ValueError, match="both"):
        ops.fused_rwm_chain(linear_gaussian_from_arrays(A, y, 0.3),
                            torch.from_numpy(pos), prior_mean=pm, **kw)


C = np.array([[2.0, 0.8], [0.8, 1.0]], np.float32)
L = np.linalg.cholesky(C).astype(np.float32)
PRIOR_MEAN = np.array([1.0, -0.5], np.float32)


@pytest.mark.parametrize("recorded", [False, True])
def test_pcn_dense_chain_matches_jax(recorded):
    """tests/test_pallas_ops.py's conjugate case: prior N(mean, C) as its
    Cholesky factor, Φ = ½‖y − x‖² with y = 0."""
    phi_j = lambda x: 0.5 * jnp.sum((jnp.zeros((2, 1)) - x) ** 2, axis=0)
    phi_t = linear_gaussian_from_arrays(np.eye(2), np.zeros(2), 1.0)
    pos = positions(2, seed=6) + PRIOR_MEAN
    args = (PRIOR_MEAN, L, 0.5, 7)
    kw = dict(n_steps=STEPS, block_chains=BLOCK)
    if recorded:
        out_j = jops.fused_pcn_chain_dense_recorded(phi_j, jnp.asarray(pos), *args,
                                                    thin=10, **kw)
        out_t = ops.fused_pcn_chain_dense_recorded(phi_t, torch.from_numpy(pos),
                                                   *args, thin=10, **kw)
    else:
        out_j = jops.fused_pcn_chain_dense(phi_j, jnp.asarray(pos), *args, **kw)
        out_t = ops.fused_pcn_chain_dense(phi_t, torch.from_numpy(pos), *args, **kw)
    assert_chains_agree(out_j, out_t)


def test_pcn_dense_zero_potential_always_accepts():
    """m = 0: Φ ≡ 0, every proposal accepted (as JAX's zero potential)."""
    zero = linear_gaussian_from_arrays(np.zeros((0, 2)), np.zeros(0), 1.0)
    pos = torch.from_numpy(positions(2, seed=8))
    assert torch.equal(zero(pos.T), torch.zeros(N))
    out, acc = ops.fused_pcn_chain_dense(zero, pos, PRIOR_MEAN, L, 0.7, 0,
                                         n_steps=10, block_chains=BLOCK)
    assert bool((acc == 1.0).all()) and not torch.equal(out, pos)


def test_pcn_adapt_matches_jax():
    """test_pallas_ops.py's sharp 16-dim target, Φ = ½‖y − x‖²/0.01. The
    chains as in the other tests; β per block within 1e-5 relative of
    JAX's: the pooled mean (JAX's XLA reduction, here a fixed pairwise
    order) and γ_i (JAX: exp/log in f32, here float64 rounded once) differ
    in the last bits, and they feed every later step."""
    d = 16
    y = np.linspace(-0.5, 0.5, d).astype(np.float32)
    phi_j = lambda x: 0.5 * jnp.sum((y[:, None] - x) ** 2, axis=0) / 0.01
    phi_t = linear_gaussian_from_arrays(np.eye(d), y, 0.1)
    pos = y + positions(d, seed=9, scale=0.05)
    kw = dict(prior_mean=np.zeros(d), prior_scale=np.ones(d), beta0=0.5,
              seed=0, n_steps=STEPS, target_accept=0.3, block_chains=BLOCK)
    out_j = jops.fused_pcn_chain_adapt(phi_j, jnp.asarray(pos), **kw)
    out_t = ops.fused_pcn_chain_adapt(phi_t, torch.from_numpy(pos), **kw)
    out_j, out_t = assert_chains_agree(out_j, out_t)
    beta_j, beta_t = out_j[2], out_t[2]
    assert beta_t.shape == (N,)
    for b in (beta_j, beta_t):  # one β per block
        assert np.all(b.reshape(-1, BLOCK) == b.reshape(-1, BLOCK)[:, :1])
    np.testing.assert_allclose(beta_t, beta_j, rtol=1e-5)
    assert beta_t.max() < 0.5  # adapted down from β0 on the sharp target


def test_fold_sum_is_the_kernels_order():
    """The pooled sum: the upper half folded onto the lower (an odd middle
    element kept) until one is left; exact on integers, and for floats the
    order of that tree."""
    x = torch.arange(1.0, 8.0)[None, :]  # 7 = 3 + 1 (kept) + 3
    assert float(fused_pcn_adapt._fold_sum(x)[0]) == 28.0
    v = torch.tensor([[1e8, 1.0, -1e8, 1.0]])  # (1e8 − 1e8) + (1 + 1)
    assert float(fused_pcn_adapt._fold_sum(v)[0]) == 2.0
    with pytest.raises(ValueError, match="block_chains"):
        ops.fused_pcn_chain_adapt(lambda U: U.sum(0), torch.zeros(4, 2), np.zeros(2),
                                  np.ones(2), 0.5, 0, n_steps=1, block_chains=3)
