"""The six fused samplers that take a ``LinearGaussianPotential`` on the card
(cold pCN K6, DA-pCN K4, three-level DA K13, ESS K8, FES K9, cold MALA K10;
ip_mcmc_tpu_torch/ops/fused_*.py, plain scaffold on the CPU) against the JAX
Pallas kernels in interpret mode, on the targets of the JAX package's own
tests of those kernels (tests/test_pallas_ops.py, tests/test_fused_da.py)
written in linear form: Φ(x) = ½‖(y − A(x − c))/σ‖², the JAX closure built
from the same numpy arrays. Additive constants, which no MH ratio sees, are
left out on both sides.

Per sampler: the uniforms of its tags bit for bit; 64 chains in blocks of
32, at most 40 steps, ending (and recording) within 1e-4 of JAX's with the
same number of accepted steps (every input f32, so the chains take the same
decisions: what differs is the rounding of Φ, at 1e-7); and the closed-form
posterior moments at the sizes of the JAX tests, on the port alone. Also the
value and gradient of the potential against autograd in f64, the takes-rule
``_scaffold.linear_route`` and the refusals before any launch."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ip_mcmc_tpu import ops as jops
from ip_mcmc_tpu.ops import fused_mcmc as fm
from ip_mcmc_tpu_torch import configs, ops
from ip_mcmc_tpu_torch.convert import linear_gaussian_from_arrays
from ip_mcmc_tpu_torch.ops import (
    _scaffold,
    fused_da3_pcn,
    fused_da_pcn,
    fused_ess,
    fused_fes,
    fused_mala,
    fused_pcn,
    rng,
)

torch.set_num_threads(1)

N, BLOCK, STEPS = 64, 32, 40


class Level:
    """A linear-Gaussian level from numpy arrays: the port's potential and
    the JAX closure of the same Φ."""

    def __init__(self, A, y, sigma, center=None):
        self.A = np.asarray(A, np.float32)
        m, d = self.A.shape
        self.y = np.asarray(y, np.float32).reshape(m)
        self.sigma = np.broadcast_to(np.asarray(sigma, np.float32), (m,)).copy()
        self.c = np.zeros(d, np.float32) if center is None else np.asarray(center, np.float32)

    @property
    def torch(self):
        return linear_gaussian_from_arrays(self.A, self.y, self.sigma, center=self.c)

    def jax(self, prior=False):
        A, y, s, c = (jnp.asarray(v) for v in (self.A, self.y, self.sigma, self.c))

        def phi(x):
            r = (y[:, None] - A @ (x - c[:, None])) / s[:, None]
            out = 0.5 * jnp.sum(r * r, axis=0)
            return out + 0.5 * jnp.sum(x * x, axis=0) if prior else out

        return phi


def identity_level(y):
    """Φ = ½‖y − x‖²: the conjugate targets of the pCN and ESS tests."""
    y = np.asarray(y, np.float32)
    return Level(np.eye(len(y)), y, 1.0)


# tests/test_fused_da.py: Φ = ½ Σ PREC x², N(0, I) prior
DA_D = 4
PREC = np.linspace(0.5, 2.0, DA_D).astype(np.float32)


def da_level(scale=1.0, shift=0.0):
    """scale · Φ_exact(x + shift) in linear form: A = diag √PREC, c = −shift,
    σ = 1 / √scale."""
    return Level(np.diag(np.sqrt(PREC)), np.zeros(DA_D), 1.0 / np.sqrt(scale),
                 center=np.full(DA_D, -shift))


def mala_level():
    """tests/test_pallas_ops.py's linear misfit: A (3, 4) from
    default_rng(0), σ 0.5; the N(0, I) prior comes in as prior_mean /
    prior_scale (JAX's closure adds it)."""
    r = np.random.default_rng(0)
    A = (r.standard_normal((3, 4)) / np.sqrt(4)).astype(np.float32)
    return Level(A, r.standard_normal(3).astype(np.float32), 0.5)


# tests/test_pallas_ops.py TestFusedFES: posterior N(μ, C) under a N(0, 9 I)
# prior; the misfit ½(x − μ)ᵀP(x − μ) − ½|x|²/9 is ½‖Lᵀ(x − c)‖² + const
# with L Lᵀ = P − I/9 (positive definite) and c = (P − I/9)⁻¹ P μ
FES_C = np.array([[1.0, 0.9], [0.9, 1.0]])
FES_MU = np.array([0.7, -0.3])


def fes_level():
    P = np.linalg.inv(FES_C)
    Q = P - np.eye(2) / 9.0
    return Level(np.linalg.cholesky(Q).T, np.zeros(2), 1.0,
                 center=np.linalg.solve(Q, P @ FES_MU))


def positions(d, seed=1, n=N, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal((n, d))).astype(np.float32)


def assert_chains_agree(out_j, out_t, steps=STEPS):
    """Every chain ends (and records) within 1e-4 of JAX's, with the same
    number of accepted steps (XLA divides the count through a reciprocal:
    compared as counts)."""
    out_j = [np.asarray(o) for o in out_j]
    out_t = [o.numpy() for o in out_t]
    ok = np.abs(out_t[0] - out_j[0]).max(axis=1) <= 1e-4
    if len(out_j) == 3 and out_j[2].ndim == 3:
        assert out_t[2].shape == out_j[2].shape
        ok &= (np.abs(out_t[2] - out_j[2]).max(axis=2) <= 1e-4).all(axis=0)
    assert ok.mean() >= 0.99, ok.mean()
    np.testing.assert_array_equal(np.rint(out_t[1] * steps), np.rint(out_j[1] * steps))
    if len(out_j) == 3 and out_j[2].ndim == 1:  # DA: inner / middle rate; FES: stretch
        np.testing.assert_allclose(out_t[2], out_j[2], rtol=1e-6, atol=1e-7)
    assert 0.0 < out_t[1].mean() <= 1.0


# --- the value and gradient -------------------------------------------------------


@pytest.mark.parametrize("m,d,centered", [(16, 32, False), (5, 3, True), (0, 4, False)])
def test_value_and_grad_matches_autograd_f64(m, d, centered):
    """∇Φ = −Aᵀ((y − A(u − c))/σ²), the kernel's form, against autograd of
    Φ in f64; in f32 against the f64 values."""
    r = np.random.default_rng(m + d)
    A = r.standard_normal((m, d)) / np.sqrt(d)
    c = r.standard_normal(d) if centered else None
    pot = linear_gaussian_from_arrays(A, r.standard_normal(m), 0.05 + r.random(m), center=c)
    U = torch.from_numpy(r.standard_normal((d, 7)))
    pot64 = linear_gaussian_from_arrays(A, pot.data.numpy(), pot.noise.numpy(),
                                        center=pot.center.numpy()).double()
    phi, g = pot64._value_and_grad_plain(U)
    x = U.clone().requires_grad_(True)
    res = (pot64.data[:, None] - pot64.A @ (x - pot64.center[:, None])) / pot64.noise[:, None]
    phi_ref = 0.5 * torch.sum(res * res, dim=0)
    (g_ref,) = torch.autograd.grad(phi_ref.sum(), x)
    np.testing.assert_allclose(phi.numpy(), phi_ref.detach().numpy(), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(g.numpy(), g_ref.numpy(), rtol=1e-12, atol=1e-12)
    phi32, g32 = pot.value_and_grad(U.float())
    assert phi32.dtype == g32.dtype == torch.float32 and g32.shape == (d, 7)
    np.testing.assert_allclose(phi32.numpy(), phi.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(g32.numpy(), g.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(phi32.numpy(), pot(U.float()).numpy())


# --- the uniforms of each sampler's tags ------------------------------------------

K_INNER, K_MID, SUBCHAIN, SHRINK = 3, 2, 4, 6
TAGS = {
    "pcn": [2],
    "mala": [2],
    "ess": [2, 4] + [16 + k for k in range(SHRINK)],
    "fes": [34, 36, 42, 44, 52],
    "da_pcn": [4 * j + 2 for j in range(SUBCHAIN)] + [4 * SUBCHAIN + 2],
    "da3_pcn": ([4 * j + 2 for j in range(K_INNER * K_MID)]
                + [4 * K_INNER * K_MID + 4 * j + 2 for j in range(K_MID)]
                + [4 * K_INNER * K_MID + 4 * K_MID + 2]),
}


@pytest.mark.parametrize("sampler", sorted(TAGS))
def test_uniforms_bit_for_bit(sampler):
    """The (1, block) uniforms the sampler draws (its MH, slice and shrink
    tags) in the port's plain scaffold, chain c holding lane c % block of its
    block's tile, equal the JAX kernel's per-block draws bit for bit; FES's
    shift is the (1, 1) draw of tags 32 / 40, one number a block."""
    seed, n = 11, 96
    bseed, lane = rng.block_seeds(seed, n, BLOCK, "cpu")
    for step in (0, 1, 17):
        for tag in TAGS[sampler]:
            got = rng.uniform_from_bits(rng.hash_bits(rng.mix_key(bseed, step, tag), lane))
            for b in range(n // BLOCK):
                key = fm._mix_key(jnp.uint32(seed + 7919 * b), jnp.int32(step), tag)
                ref = np.asarray(fm._uniform01(key, (1, BLOCK)))[0]
                np.testing.assert_array_equal(got[b * BLOCK:(b + 1) * BLOCK].numpy(), ref)
    if sampler == "fes":
        for tag in (32, 40):
            got = rng.uniform_from_bits(rng.hash_bits(rng.mix_key(bseed, 3, tag), 0))
            for b in range(n // BLOCK):
                key = fm._mix_key(jnp.uint32(seed + 7919 * b), jnp.int32(3), tag)
                ref = np.asarray(fm._uniform01(key, (1, 1)))[0, 0]
                assert float(got[b * BLOCK]) == float(ref)


# --- each sampler against JAX ------------------------------------------------------


def _pcn(recorded):
    lv, pos = identity_level([1.0, 1.0]), positions(2)
    pm, ps = np.zeros(2, np.float32), np.ones(2, np.float32)
    kw = dict(seed=3, n_steps=STEPS, block_chains=BLOCK)
    if recorded:
        return (jops.fused_pcn_chain_recorded(lv.jax(), jnp.asarray(pos), pm, ps, 0.5, thin=4,
                                              **kw),
                ops.fused_pcn_chain_recorded(lv.torch, torch.from_numpy(pos), pm, ps, 0.5,
                                             thin=4, **kw))
    return (jops.fused_pcn_chain(lv.jax(), jnp.asarray(pos), pm, ps, 0.5, **kw),
            ops.fused_pcn_chain(lv.torch, torch.from_numpy(pos), pm, ps, 0.5, **kw))


def _ess(recorded):
    lv, pos = identity_level([1.0, 1.0]), positions(2, seed=2)
    pm, ps = np.zeros(2, np.float32), np.ones(2, np.float32)
    kw = dict(seed=5, n_steps=STEPS, max_shrink=SHRINK, block_chains=BLOCK)
    if recorded:
        return (jops.fused_ess_chain_recorded(lv.jax(), jnp.asarray(pos), pm, ps, thin=4, **kw),
                ops.fused_ess_chain_recorded(lv.torch, torch.from_numpy(pos), pm, ps, thin=4,
                                             **kw))
    return (jops.fused_ess_chain(lv.jax(), jnp.asarray(pos), pm, ps, **kw),
            ops.fused_ess_chain(lv.torch, torch.from_numpy(pos), pm, ps, **kw))


def _mala(recorded):
    lv, pos = mala_level(), positions(4, seed=3)
    kw = dict(step_size=0.5, seed=7, n_steps=STEPS, block_chains=BLOCK)
    prior = dict(prior_mean=np.zeros(4, np.float32), prior_scale=np.ones(4, np.float32))
    if recorded:
        return (jops.fused_mala_chain_recorded(lv.jax(prior=True), jnp.asarray(pos), thin=4,
                                               **kw),
                ops.fused_mala_chain_recorded(lv.torch, torch.from_numpy(pos), thin=4, **kw,
                                              **prior))
    return (jops.fused_mala_chain(lv.jax(prior=True), jnp.asarray(pos), **kw),
            ops.fused_mala_chain(lv.torch, torch.from_numpy(pos), **kw, **prior))


def _fes(recorded):
    lv, pos = fes_level(), positions(2, seed=4, scale=3.0)
    pm, ps = np.zeros(2, np.float32), np.full(2, 3.0, np.float32)
    kw = dict(n_low_modes=2, seed=9, n_steps=STEPS, block_chains=BLOCK)
    if recorded:
        return (jops.fused_fes_chain_recorded(lv.jax(), jnp.asarray(pos), pm, ps, thin=4,
                                              **kw),
                ops.fused_fes_chain_recorded(lv.torch, torch.from_numpy(pos), pm, ps, thin=4,
                                             **kw))
    return (jops.fused_fes_chain(lv.jax(), jnp.asarray(pos), pm, ps, **kw),
            ops.fused_fes_chain(lv.torch, torch.from_numpy(pos), pm, ps, **kw))


def _da(recorded):
    exact, surr = da_level(), da_level(0.8, 0.3)
    pos = positions(DA_D, seed=5)
    pm, ps = np.zeros(DA_D, np.float32), np.ones(DA_D, np.float32)
    kw = dict(seed=11, n_steps=STEPS, subchain_len=SUBCHAIN, block_chains=BLOCK)
    if recorded:
        return (jops.fused_da_pcn_chain_recorded(exact.jax(), surr.jax(), jnp.asarray(pos), pm,
                                                 ps, 0.3, thin=4, **kw),
                ops.fused_da_pcn_chain_recorded(exact.torch, surr.torch, torch.from_numpy(pos),
                                                pm, ps, 0.3, thin=4, **kw))
    return (jops.fused_da_pcn_chain(exact.jax(), surr.jax(), jnp.asarray(pos), pm, ps, 0.3,
                                    **kw),
            ops.fused_da_pcn_chain(exact.torch, surr.torch, torch.from_numpy(pos), pm, ps, 0.3,
                                   **kw))


def _da3(recorded):
    levels = (da_level(), da_level(1.05, 0.05), da_level(0.8, 0.3))
    pos = positions(DA_D, seed=6)
    pm, ps = np.zeros(DA_D, np.float32), np.ones(DA_D, np.float32)
    kw = dict(seed=13, n_steps=STEPS, k_inner=K_INNER, k_mid=K_MID, block_chains=BLOCK)
    jl, tl = [lv.jax() for lv in levels], [lv.torch for lv in levels]
    if recorded:
        return (jops.fused_da3_pcn_chain_recorded(*jl, jnp.asarray(pos), pm, ps, 0.3, thin=4,
                                                  **kw),
                ops.fused_da3_pcn_chain_recorded(*tl, torch.from_numpy(pos), pm, ps, 0.3,
                                                 thin=4, **kw))
    return (jops.fused_da3_pcn_chain(*jl, jnp.asarray(pos), pm, ps, 0.3, **kw),
            ops.fused_da3_pcn_chain(*tl, torch.from_numpy(pos), pm, ps, 0.3, **kw))


RUNS = {"pcn": _pcn, "ess": _ess, "mala": _mala, "fes": _fes, "da_pcn": _da, "da3_pcn": _da3}


@pytest.mark.parametrize("recorded", [False, True])
@pytest.mark.parametrize("sampler", sorted(RUNS))
def test_chain_matches_jax(sampler, recorded):
    out_j, out_t = RUNS[sampler](recorded)
    if recorded:
        assert out_t[2].shape == (STEPS // 4, N, out_t[0].shape[1])
        assert torch.equal(out_t[2][-1], out_t[0])
    assert_chains_agree(out_j, out_t)


# --- the closed-form posteriors (the port alone, at the JAX tests' sizes) -----------


def _moments(p):
    p = p.numpy() if isinstance(p, torch.Tensor) else p
    return p.mean(axis=0), np.cov(p.T)


def test_pcn_conjugate_posterior():
    """N(0, I) prior, y = (1, 1) with unit noise: N(½, ½ I)."""
    pot, pos = identity_level([1.0, 1.0]).torch, torch.zeros(1024, 2)
    for seed in (0, 1):
        pos, acc = ops.fused_pcn_chain(pot, pos, np.zeros(2), np.ones(2), 0.5, seed,
                                       n_steps=800, block_chains=256)
    mean, cov = _moments(pos)
    np.testing.assert_allclose(mean, [0.5, 0.5], atol=0.08)
    np.testing.assert_allclose(np.diag(cov), [0.5, 0.5], rtol=0.25)
    assert float(acc.mean()) > 0.2


def test_ess_conjugate_posterior():
    pot, pos = identity_level([1.0, 1.0]).torch, torch.zeros(1024, 2)
    for seed in (0, 1):
        pos, acc = ops.fused_ess_chain(pot, pos, np.zeros(2), np.ones(2), seed,
                                       n_steps=300, block_chains=128)
    mean, cov = _moments(pos)
    np.testing.assert_allclose(mean, [0.5, 0.5], atol=0.07)
    np.testing.assert_allclose(np.diag(cov), [0.5, 0.5], atol=0.12)
    assert float(acc.mean()) > 0.95


def test_mala_conjugate_posterior():
    """MALA on the linear misfit, prior N(0, I) folded in: N(μ, H) with
    H = (I + AᵀA/σ²)⁻¹, μ = H Aᵀy/σ²."""
    lv = mala_level()
    A, y = lv.A.astype(np.float64), lv.y.astype(np.float64)
    H = np.linalg.inv(np.eye(4) + A.T @ A / 0.25)
    mu = H @ A.T @ y / 0.25
    pos = torch.zeros(512, 4)
    kw = dict(block_chains=128, prior_mean=np.zeros(4), prior_scale=np.ones(4))
    for seed in (3, 4):
        pos, acc = ops.fused_mala_chain(lv.torch, pos, 0.5, seed, n_steps=800, **kw)
    mean, cov = _moments(pos)
    np.testing.assert_allclose(mean, mu, atol=0.12)
    np.testing.assert_allclose(cov, H, atol=0.15)
    assert float(acc.mean()) > 0.3


def test_fes_correlated_posterior():
    """Affine invariance on the 0.9-correlated N(μ, C), no tuning."""
    pot = fes_level().torch
    pos = torch.from_numpy(positions(2, seed=0, n=512, scale=3.0))
    for seed in (1, 2):
        pos, acc, stretch = ops.fused_fes_chain(pot, pos, np.zeros(2), np.full(2, 3.0), 2,
                                                seed, n_steps=600, block_chains=128)
    mean, cov = _moments(pos)
    np.testing.assert_allclose(mean, FES_MU, atol=0.08)
    np.testing.assert_allclose(cov, FES_C, atol=0.15)
    assert 0.05 < float(stretch.mean()) < 0.95


@pytest.mark.parametrize("levels", [2, 3])
def test_delayed_acceptance_exact_posterior_with_biased_levels(levels):
    """Shifted and rescaled surrogate (and middle) levels: the corrections
    keep the exact posterior N(0, 1/(1 + PREC))."""
    exact, mid, surr = da_level(), da_level(1.05, 0.05), da_level(0.8, 0.3)
    pos = torch.from_numpy(positions(DA_D, seed=0, n=512))
    pm, ps = np.zeros(DA_D), np.ones(DA_D)
    if levels == 2:
        _, acc, s = ops.fused_da_pcn_chain_recorded(exact.torch, surr.torch, pos, pm, ps, 0.3,
                                                    3, n_steps=400, thin=1, subchain_len=4,
                                                    block_chains=256)
    else:
        _, acc, s = ops.fused_da3_pcn_chain_recorded(exact.torch, mid.torch, surr.torch, pos,
                                                     pm, ps, 0.3, 3, n_steps=400, thin=1,
                                                     k_inner=4, k_mid=2, block_chains=256)
    flat = s[100:].reshape(-1, DA_D).numpy()
    np.testing.assert_allclose(flat.mean(axis=0), np.zeros(DA_D), atol=0.06)
    np.testing.assert_allclose(flat.var(axis=0), 1.0 / (1.0 + PREC), rtol=0.12)
    assert 0.0 < float(acc.mean()) < 1.0


# --- the takes-rule and the refusals ------------------------------------------------


def test_linear_route_and_refusals():
    """``_scaffold.linear_route``: one chain a CTA for K = d up to MAX_DIM at
    every level, None else; each wrapper's launch refuses such a d with a
    ValueError before touching any device, and names the families it takes
    for a callable."""
    lv = mala_level().torch  # d = 4
    wide = linear_gaussian_from_arrays(np.ones((2, 256)), np.zeros(2), 1.0)
    assert _scaffold.linear_route(4, lv) == "cta"
    assert _scaffold.linear_route(4, lv, lv, lv) == "cta"
    assert _scaffold.linear_route(256, wide) == "cta"
    assert _scaffold.linear_route(5, lv) is None
    assert _scaffold.linear_route(4, lv, wide) is None
    pos = torch.zeros(32, 5)  # d = 5: K = 4 at every level
    pm, ps = np.zeros(5), np.ones(5)
    launches = {
        "pCN": lambda: fused_pcn._launch(lv, pos, pm, ps, 0.2, 0, 2, 32),
        "ESS": lambda: fused_ess._launch(lv, pos, pm, ps, 0, 2, 4, 32),
        "ensemble": lambda: fused_fes._launch(lv, pos, pm, ps, 2, 0, 0.2, 2.0, 2, 32),
        "MALA": lambda: fused_mala._launch(lv, pos, pm, ps, 0.1, 0, 2, 32),
        "DA-pCN": lambda: fused_da_pcn._launch(lv, lv, pos, pm, ps, 0.2, 0, 2, 4, 32),
        "three-level DA": lambda: fused_da3_pcn._launch(lv, lv, lv, pos, pm, ps, 0.2, 0, 2, 2,
                                                        2, 32),
    }
    for what, launch in launches.items():
        with pytest.raises(ValueError, match=f"the {what} kernel takes linear-Gaussian"):
            launch()
    with pytest.raises(TypeError, match="LinearGaussianPotential or BurgersMisfit or "
                                        "DarcyMisfit potentials only"):
        fused_pcn._launch(lambda U: U.sum(0), pos, pm, ps, 0.2, 0, 2, 32)
    with pytest.raises(TypeError, match="LinearGaussianPotential or DarcyMisfit potentials"):
        fused_mala._launch(lambda U: U.sum(0), pos, pm, ps, 0.1, 0, 2, 32)
    with pytest.raises(TypeError, match="one family"):
        fused_da_pcn._launch(lv, configs.build("burgers_da_pcn", "cpu").batched_potential_fn,
                             pos, pm, ps, 0.2, 0, 2, 4, 32)


def test_build_takes_overrides():
    """``configs.build(name, device, **overrides)``, as the JAX package's
    ``build``: a field given and not None replaces the config's."""
    A, _, y, sigma = configs.lingauss_arrays()
    pot = linear_gaussian_from_arrays(A, y, sigma)
    p = configs.build("lingauss_pcn", "cpu", kernel="mala", batched_potential_fn=pot,
                      kernel_params={"fused": True, "step_size": 0.01}, notes=None)
    assert p.kernel == "mala" and p.batched_potential_fn is pot
    assert p.kernel_params == {"fused": True, "step_size": 0.01}
    assert p.notes == configs.build("lingauss_pcn", "cpu").notes
