"""The port's fused pCN, cold (K6) and warm-started (K7)
(ip_mcmc_tpu_torch/ops/fused_pcn.py, plain scaffold on the CPU), against
the JAX Pallas kernels in interpret mode on an 8×8 Darcy problem; and the
properties tests/test_pallas_ops.py asserts for the warm kernel."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ip_mcmc_tpu import ops as jops
from ip_mcmc_tpu.models import darcy as jdarcy
from ip_mcmc_tpu_torch import ops
from ip_mcmc_tpu_torch.convert import (
    darcy_misfit_from_arrays,
    darcy_warm_misfit_from_arrays,
)
from ip_mcmc_tpu_torch.models import darcy
from ip_mcmc_tpu_torch.ops import fused_pcn

torch.set_num_threads(1)

N, K, BLOCK, STEPS, BETA, NOISE = 64, 16, 32, 6, 0.1, 0.002
PM, PS = np.zeros(K, np.float32), np.ones(K, np.float32)


def small_darcy():
    """8×8 grid, 16 KL modes, 16 observations: (JAX aux, port aux, y), y a
    converged solve at numpy-drawn coefficients plus numpy noise."""
    _, aux_j = jdarcy.make_darcy_forward(n_grid=8, n_modes_per_dim=4,
                                         alpha=2.0, field_scale=10.0)
    aux_t = darcy.darcy_aux(n_grid=8, n_modes_per_dim=4, alpha=2.0,
                            field_scale=10.0)
    r = np.random.default_rng(300)
    u_true = r.standard_normal((K, 1)).astype(np.float32)
    solver = darcy_misfit_from_arrays(aux_t, np.zeros(16), NOISE, cg_iters=100)
    x = solver._solve_plain(torch.from_numpy(u_true))[1].numpy()[:, 0]
    y = x[aux_t["obs_indices"]] + NOISE * r.standard_normal(16)
    return aux_j, aux_t, y.astype(np.float32)


@pytest.fixture(scope="module")
def problem():
    return small_darcy()


def positions(seed=1):
    return (0.3 * np.random.default_rng(seed).standard_normal((N, K))).astype(
        np.float32)


def agreeing(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max(axis=-1) <= 1e-4


def cold_pair(problem, cg_iters=12, **kw):
    aux_j, aux_t, y = problem
    return (jdarcy.make_batched_misfit(aux_j, y, NOISE, cg_iters=cg_iters, **kw),
            darcy_misfit_from_arrays(aux_t, y, NOISE, cg_iters=cg_iters, **kw))


def warm_pair(problem, precond="jacobi", cg_iters=6):
    aux_j, aux_t, y = problem
    kw = dict(cg_iters=cg_iters, precond=precond, precond_modes=32)
    return (jdarcy.make_batched_misfit_warm(aux_j, y, NOISE, **kw),
            darcy_warm_misfit_from_arrays(aux_t, y, NOISE, **kw))


def run_both(jfn, tfn, pot_j, pot_t, pos, seed, **kw):
    out_j = jfn(pot_j, jnp.asarray(pos), PM, PS, BETA, seed, block_chains=BLOCK, **kw)
    out_t = tfn(pot_t, torch.from_numpy(pos), PM, PS, BETA, seed,
                block_chains=BLOCK, **kw)
    return [np.asarray(o) for o in out_j], [o.numpy() for o in out_t]


def assert_strict(out_j, out_t):
    """Every input f32: at least 62 of 64 chains end (and record) within
    1e-4 of JAX's, and those accepted the same number of steps (XLA
    divides the count by n_steps through a reciprocal: one ulp apart)."""
    ok = agreeing(out_t[0], out_j[0])
    if len(out_j) == 3:
        assert out_t[2].shape == out_j[2].shape
        ok &= agreeing(out_t[2], out_j[2]).all(axis=0)
    assert ok.sum() >= 62
    np.testing.assert_array_equal(np.rint(out_t[1][ok] * STEPS),
                                  np.rint(out_j[1][ok] * STEPS))
    np.testing.assert_allclose(out_t[1][ok], out_j[1][ok], rtol=1e-6)
    assert 0.0 < out_t[1].mean() < 1.0


@pytest.mark.parametrize("recorded", [False, True])
def test_pcn_chain_matches_jax(problem, recorded):
    pot_j, pot_t = cold_pair(problem)
    if recorded:
        out = run_both(jops.fused_pcn_chain_recorded, ops.fused_pcn_chain_recorded,
                       pot_j, pot_t, positions(), 5, n_steps=STEPS, thin=2)
        assert out[1][2].shape == (STEPS // 2, N, K)
    else:
        out = run_both(jops.fused_pcn_chain, ops.fused_pcn_chain, pot_j, pot_t,
                       positions(), 5, n_steps=STEPS)
    assert_strict(*out)


@pytest.mark.parametrize("recorded", [False, True])
def test_pcn_warm_chain_matches_jax(problem, recorded):
    (pot_j, aux_dim), (pot_t, aux_dim_t) = warm_pair(problem)
    assert aux_dim == aux_dim_t == 64
    if recorded:
        out = run_both(jops.fused_pcn_chain_warm_recorded,
                       ops.fused_pcn_chain_warm_recorded, pot_j, pot_t,
                       positions(), 6, n_steps=STEPS, thin=3, aux_dim=aux_dim)
    else:
        out = run_both(jops.fused_pcn_chain_warm, ops.fused_pcn_chain_warm,
                       pot_j, pot_t, positions(), 6, n_steps=STEPS,
                       aux_dim=aux_dim)
    assert_strict(*out)


def test_pcn_warm_dst_trunc_chain_matches_jax(problem):
    """bf16 preconditioner factors: a rounding flip can turn an MH decision
    and part a chain from JAX's, so the check is statistical: most chains
    within 1e-4, mean acceptance within 0.05."""
    (pot_j, aux_dim), (pot_t, _) = warm_pair(problem, "dst_trunc", cg_iters=4)
    out_j, out_t = run_both(jops.fused_pcn_chain_warm, ops.fused_pcn_chain_warm,
                            pot_j, pot_t, positions(), 7, n_steps=STEPS,
                            aux_dim=aux_dim)
    assert agreeing(out_t[0], out_j[0]).sum() >= 56
    assert abs(out_t[1].mean() - out_j[1].mean()) <= 0.05


@pytest.mark.parametrize("warm", [False, True])
def test_records_are_the_states_of_the_plain_chain(problem, warm):
    """Recorded final equals plain final; record r is the state after
    (r + 1)·thin steps (the step counter restarts in each launch, so a
    shorter launch is a prefix of a longer one)."""
    if warm:
        pot, aux_dim = warm_pair(problem)[1]
        kw = dict(aux_dim=aux_dim)
        plain, rec = ops.fused_pcn_chain_warm, ops.fused_pcn_chain_warm_recorded
    else:
        pot, kw = cold_pair(problem)[1], {}
        plain, rec = ops.fused_pcn_chain, ops.fused_pcn_chain_recorded
    args = (pot, torch.from_numpy(positions(2)), PM, PS, BETA, 9)
    f, a, s = rec(*args, n_steps=6, thin=2, block_chains=BLOCK, **kw)
    assert s.shape == (3, N, K) and torch.equal(s[-1], f)
    for r in range(3):
        fr, ar = plain(*args, n_steps=2 * (r + 1), block_chains=BLOCK, **kw)
        assert torch.equal(fr, s[r])
    assert torch.equal(ar, a)


def test_warm_matches_cold_acceptance(problem):
    """Same seed, same streams: the warm kernel's acceptance matches the
    cold one (solver error ≪ noise); TestWarmStartPCN."""
    _, cold = cold_pair(problem, cg_iters=40)
    warm, aux_dim = warm_pair(problem, cg_iters=12)[1]
    pos = torch.from_numpy(positions(3))
    _, acc_c = ops.fused_pcn_chain(cold, pos, PM, PS, BETA, 5, n_steps=30,
                                   block_chains=64)
    _, acc_w = ops.fused_pcn_chain_warm(warm, pos, PM, PS, BETA, 5, n_steps=30,
                                        aux_dim=aux_dim, block_chains=64)
    assert abs(float(acc_c.mean()) - float(acc_w.mean())) <= 0.05


def test_conjugate_posterior_on_the_plain_scaffold():
    """pCN on an analytic Gaussian target through the shared scaffold."""
    prec = torch.linspace(0.5, 2.0, 4)
    phi = lambda U: 0.5 * torch.sum(prec[:, None] * U * U, dim=0)
    pos = torch.randn(512, 4, generator=torch.Generator().manual_seed(0))
    _, acc, s = ops.fused_pcn_chain_recorded(
        phi, pos, torch.zeros(4), torch.ones(4), 0.3, 3, n_steps=300, thin=1,
        block_chains=256)
    flat = s[75:].reshape(-1, 4).numpy()
    np.testing.assert_allclose(flat.mean(axis=0), np.zeros(4), atol=0.06)
    np.testing.assert_allclose(flat.var(axis=0), 1.0 / (1.0 + prec.numpy()),
                               rtol=0.12)
    assert 0.3 < float(acc.mean()) < 1.0


def test_argument_checks_and_kernel_potential_types(problem):
    warm, aux_dim = warm_pair(problem)[1]
    cold = cold_pair(problem)[1]
    pos = torch.zeros(64, K)
    for fn in (ops.fused_pcn_chain_warm, ops.fused_pcn_chain_warm_recorded):
        with pytest.raises(ValueError, match="aux_dim"):
            fn(warm, pos, PM, PS, BETA, 0, n_steps=2, block_chains=64)
    with pytest.raises(ValueError, match="multiple of block_chains"):
        ops.fused_pcn_chain(cold, pos, PM, PS, BETA, 0, n_steps=2, block_chains=48)
    with pytest.raises(ValueError, match="multiple of thin"):
        ops.fused_pcn_chain_recorded(cold, pos, PM, PS, BETA, 0, n_steps=3,
                                     thin=2, block_chains=64)
    # the CUDA kernels take Darcy misfit modules only, the cold kernel a
    # cold one and the warm kernel a warm one; refused before any device
    with pytest.raises(TypeError, match="DarcyMisfit"):
        fused_pcn._launch(lambda U: U.sum(0), pos, PM, PS, BETA, 0, 2, 64)
    with pytest.raises(TypeError, match="DarcyMisfit potentials"):
        fused_pcn._launch(warm, pos, PM, PS, BETA, 0, 2, 64)
    with pytest.raises(TypeError, match="DarcyMisfitWarm"):
        fused_pcn._launch(cold, pos, PM, PS, BETA, 0, 2, 64, aux_dim=aux_dim)


# --- the Burgers instantiation of K6 ------------------------------------------


@pytest.mark.parametrize("recorded", [False, True])
def test_burgers_pcn_chain_matches_jax(recorded):
    """Cold pCN on the small Burgers problem of tests/test_torch_burgers.py
    (32 cells, 10 Godunov steps): every input f32, so the strict bound."""
    from test_torch_burgers import small_burgers_levels

    jax_pots, pots = small_burgers_levels()
    pos = np.random.default_rng(4).standard_normal((N, K)).astype(np.float32)
    if recorded:
        out = run_both(jops.fused_pcn_chain_recorded, ops.fused_pcn_chain_recorded,
                       jax_pots[0], pots[0], pos, 6, n_steps=STEPS, thin=2)
        assert out[1][2].shape == (STEPS // 2, N, K)
    else:
        out = run_both(jops.fused_pcn_chain, ops.fused_pcn_chain, jax_pots[0],
                       pots[0], pos, 6, n_steps=STEPS)
    assert_strict(*out)


def test_warm_kernel_refuses_a_burgers_potential():
    """No warm Burgers kernel exists: the launch names what it takes before
    touching any device."""
    from test_torch_burgers import small_burgers_levels

    _, pots = small_burgers_levels()
    with pytest.raises(TypeError, match="DarcyMisfitWarm"):
        fused_pcn._launch(pots[0], torch.zeros(32, K), PM, PS, BETA, 0, 2, 16,
                          aux_dim=32)


# --- a warm spec the card runs one chain a CTA above 16² ------------------------
# --- (fused_pcn_warm_kernel[layout32]) -----------------------------------------


def test_pcn_warm_chain_on_a_20_grid_matches_jax():
    """A 20×20 Jacobi warm misfit (6 CG), 16 KL modes, 64 chains: every input
    f32, so at least 62 chains end within 1e-4 of JAX's, with the same
    acceptance."""
    _, aux_j = jdarcy.make_darcy_forward(n_grid=20, n_modes_per_dim=4, alpha=2.0,
                                         field_scale=10.0)
    aux_t = darcy.darcy_aux(n_grid=20, n_modes_per_dim=4, alpha=2.0, field_scale=10.0)
    y = (0.05 * np.random.default_rng(301).standard_normal(16)).astype(np.float32)
    kw = dict(cg_iters=6, precond="jacobi")
    pot_j, aux_dim = jdarcy.make_batched_misfit_warm(aux_j, y, 0.05, **kw)
    pot_t, _ = darcy_warm_misfit_from_arrays(aux_t, y, 0.05, **kw)
    assert aux_dim == 400
    assert fused_pcn.route(True, **pot_t.spec_fields, d=K) == "cta"
    assert fused_pcn._darcy_stem(pot_t, True) == "fused_pcn_warm_kernel[layout32]"
    out = run_both(jops.fused_pcn_chain_warm, ops.fused_pcn_chain_warm, pot_j, pot_t,
                   positions(8), 8, n_steps=3, aux_dim=aux_dim)
    ok = agreeing(out[1][0], out[0][0])
    assert ok.sum() >= 62
    np.testing.assert_array_equal(np.rint(out[1][1][ok] * 3), np.rint(out[0][1][ok] * 3))
    assert 0.0 < out[1][1].mean() < 1.0


def _f(n, K=64, precond="dst_trunc", modes=64, solver="cg"):
    return dict(n=n, K=K, precond=precond, modes=modes, solver=solver)


# the takes-rule (``pcn_route``'s mirror): warm, a spec's fields, d, the kernel
ROUTES = [
    (False, _f(16, precond="jacobi", modes=0), 64, "warp"),  # darcy_pcn_4096 --fused
    (True, _f(16), 64, "warp"),  # darcy_pcn_warm
    (True, _f(32, modes=128), 64, "cluster"),  # darcy32_pcn_warm
    (True, _f(64, K=144, modes=256), 144, "cluster"),  # darcy64_pcn_warm
    (False, _f(64, K=144, modes=256), 144, "cta"),
    (False, _f(16, modes=128), 64, "cta"),
    (True, _f(16, precond="jacobi", modes=0), 64, "cta"),
    (True, _f(24, modes=128), 64, "cta"),
    (True, _f(32, precond="jacobi", modes=0), 64, "cta"),
    (True, _f(32, modes=100), 64, "cta"),
    (True, _f(32, K=100, modes=128), 100, "cta"),
    (True, _f(48, modes=128), 64, "cta"),
    (True, _f(64, K=144, precond="dst", modes=0), 144, "cta"),
    (True, _f(64, K=144, modes=100), 144, "cta"),
    (True, _f(20, K=16, precond="jacobi", modes=0), 16, "cta"),
    (True, _f(72, K=144), 144, None),  # above 64²
    (True, _f(48, K=600), 600, None),  # more coordinates than Layout64's threads
    (True, _f(24), 32, None),  # K != d
]


@pytest.mark.parametrize("warm, fields, d, kernel", ROUTES)
def test_route_sends_each_spec_to_its_kernel(warm, fields, d, kernel):
    """Shipped specs go to the warp and cluster kernels, the rest one chain a
    CTA in the layout of its grid, a warm grid above 64² nowhere."""
    assert fused_pcn.route(warm, **fields, d=d) == kernel
