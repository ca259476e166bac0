"""Tempered SMC of the port (``ip_mcmc_tpu_torch/smc.py``, the runner's
``_run_smc``, the configs ``darcy_smc`` and ``darcy_smc_warm``) against the
JAX package on the CPU: the ESS, the β bisection, systematic resampling from
JAX's uniform, the thermodynamic evidence, one stage of ``run`` and of
``run_batched`` from JAX's draws, the closed-form posterior and evidence of
``tests/test_smc.py`` with the port's own generator and JAX's bounds, and the
two Darcy configs through the CLI at 256 particles.

Tolerances. The ESS is a pair of f32 log-sum-exps, summed in another order
by XLA: 1e-5 relative. δβ: the 40 bisections compare an f32 ESS with the
target, and where the ESS lies within rounding of it a decision can go the
other way; each later halving then moves δ by less than that step, so δ
agrees within 1e-4 relative rather than bit for bit (measured: 4e-6 at
most). Ancestors: in float64 on both sides exactly equal; in f32 XLA's
cumulative sum of the softmax may differ from ``torch.cumsum`` by an ulp,
so an ancestor may differ only where its position lies within 2 ulp of a
cumulative weight, and those cases are counted. One stage from the same
draws: positions within 1e-5, Φ, β and log Z within 1e-5 relative, the
same accept decisions."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ip_mcmc_tpu import configs as jconfigs
from ip_mcmc_tpu import runner as jrunner
from ip_mcmc_tpu import smc as jsmc
from ip_mcmc_tpu.driver import chain_keys
from ip_mcmc_tpu.models import linear as jlinear
from ip_mcmc_tpu_torch import distributions as dist
from ip_mcmc_tpu_torch import configs, run, smc

torch.set_num_threads(1)

T = lambda x: torch.tensor(np.asarray(x))  # noqa: E731
ESS_RTOL, DELTA_RTOL, POS_ATOL, PHI_RTOL = 1e-5, 1e-4, 1e-5, 1e-5

# the closed-form problem of tests/test_smc.py
A = np.array([[1.0, 0.5], [0.0, 1.0], [1.0, -1.0]])
Y = np.array([1.0, -0.5, 0.3])
NOISE = 0.5


def closed_form():
    """(Φ of an (n, 2) batch, Φ of a chain-last (2, n) batch, the prior,
    the posterior mean and covariance, the log evidence)."""
    At, yt = torch.tensor(A, dtype=torch.float32), torch.tensor(Y, dtype=torch.float32)
    phi = lambda u: 0.5 * torch.sum(((yt - u @ At.T) / NOISE) ** 2, dim=-1)  # noqa: E731
    phi_b = lambda U: 0.5 * torch.sum(((yt[:, None] - At @ U) / NOISE) ** 2, dim=0)  # noqa: E731
    prior = dist.DiagGaussian(mean=torch.zeros(2), scale=torch.ones(2))
    mean, cov = jlinear.conjugate_posterior(A, np.zeros(2), np.eye(2),
                                            NOISE**2 * np.eye(3), Y)
    S = A @ A.T + NOISE**2 * np.eye(3)
    log_z = (-0.5 * Y @ np.linalg.solve(S, Y) - 0.5 * np.linalg.slogdet(S)[1]
             + 0.5 * np.linalg.slogdet(NOISE**2 * np.eye(3))[1])
    return phi, phi_b, prior, mean, cov, log_z


def gen(seed):
    return torch.Generator().manual_seed(seed)


# --- the building blocks -------------------------------------------------------------


def test_ess_and_beta_bisection_match_jax():
    rng = np.random.default_rng(0)
    lw = rng.normal(0.0, 3.0, 512).astype(np.float32)
    np.testing.assert_allclose(float(smc.effective_sample_size(T(lw))),
                               float(jsmc.effective_sample_size(jnp.asarray(lw))),
                               rtol=ESS_RTOL)
    pots = rng.uniform(0, 30, 512).astype(np.float32)
    for beta in (0.0, 0.3, 0.97):
        want = float(jsmc.find_next_beta(jnp.float32(beta), jnp.asarray(pots), 0.5))
        got = float(smc.find_next_beta(torch.tensor(beta, dtype=torch.float32), T(pots), 0.5))
        np.testing.assert_allclose(got, want, rtol=DELTA_RTOL)
    # a flat likelihood takes the whole remaining step
    assert float(smc.find_next_beta(torch.tensor(0.0), torch.zeros(64), 0.5)) == 1.0
    # the floor keeps β moving when one particle holds all the weight
    spike = torch.tensor([0.0] + [1e9] * 63)
    assert float(smc.find_next_beta(torch.tensor(0.5), spike, 0.9)) > 0.0


@pytest.mark.parametrize("n_out", [None, 64])
def test_systematic_resample_matches_jax(n_out):
    """From JAX's u0 for the same weights: in float64 the same ancestors;
    in f32 the same but for positions within 2 ulp of a boundary."""
    rng = np.random.default_rng(1)
    lw = rng.normal(0.0, 2.0, 512)
    n = n_out or 512
    key = jax.random.key(3)
    with jax.enable_x64(True):
        u0 = jax.random.uniform(key, (), jnp.float64, 0.0, 1.0 / n)
        want = np.asarray(jsmc.systematic_resample(key, jnp.asarray(lw), n_out))
    got = smc.systematic_resample(T(lw), T(u0), n_out).numpy()
    np.testing.assert_array_equal(got, want)

    lw32 = lw.astype(np.float32)
    u0 = jax.random.uniform(key, (), minval=0.0, maxval=1.0 / n)
    want = np.asarray(jsmc.systematic_resample(key, jnp.asarray(lw32), n_out))
    got = smc.systematic_resample(T(lw32), T(u0), n_out).numpy()
    cum = torch.cumsum(torch.softmax(T(lw32), 0), 0).numpy()
    pos = np.float32(u0) + np.arange(n, dtype=np.float32) / np.float32(n)
    differ = np.flatnonzero(got != want)
    for i in differ:
        edge = cum[min(got[i], want[i])]
        assert abs(got[i] - want[i]) == 1
        assert abs(pos[i] - edge) <= 2 * np.spacing(np.float32(edge)), i
    assert len(differ) <= 2, f"{len(differ)} ancestors differ at f32 boundaries"


def test_thermodynamic_log_z_matches_jax():
    rng = np.random.default_rng(2)
    n, max_stages = 7, 12
    betas = np.concatenate([np.sort(rng.uniform(0, 1, n - 1)), [1.0]]).astype(np.float32)
    pots = rng.uniform(1, 40, n).astype(np.float32)
    pad = lambda x: np.concatenate([x, np.full(max_stages - n, np.nan, np.float32)])  # noqa: E731
    nan = np.full(max_stages, np.nan, np.float32)
    jinfo = jsmc.SMCInfo(betas=jnp.asarray(pad(betas)), ess=jnp.asarray(nan),
                         accept_rates=jnp.asarray(nan), n_stages=jnp.int32(n),
                         mutation_counts=jnp.asarray(nan),
                         mean_potentials=jnp.asarray(pad(pots)),
                         prior_mean_potential=jnp.float32(55.0))
    info = smc.SMCInfo(betas=T(pad(betas)), ess=T(nan), accept_rates=T(nan), n_stages=n,
                       mutation_counts=T(nan), mean_potentials=T(pad(pots)),
                       prior_mean_potential=torch.tensor(55.0))
    assert smc.thermodynamic_log_z(info) == pytest.approx(jsmc.thermodynamic_log_z(jinfo),
                                                          rel=1e-6)


# --- one stage from JAX's draws -------------------------------------------------------


def test_run_stage_matches_jax():
    """smc.run's first stage on lingauss_pcn at 256 particles: the
    particles and potentials that JAX's run starts from, its resampling
    uniform and each mutation step's per-chain draws (split(key) → the
    proposal's centred prior draw, the MH uniform)."""
    n, k, s = 256, 3, 0.3
    jp, p = jconfigs.build("lingauss_pcn"), configs.build("lingauss_pcn", "cpu")
    key = jax.random.key(5)
    key_init, key_loop = jax.random.split(key)
    particles = np.asarray(jp.prior.sample(key_init, (n,)))
    potentials = np.asarray(jax.vmap(jp.potential_fn)(jnp.asarray(particles)))
    key_res, key_mut = jax.random.split(jax.random.fold_in(key_loop, 0))
    u0 = T(jax.random.uniform(key_res, (), minval=0.0, maxval=1.0 / n))

    def step_draws(i, m):
        def one(kk):
            kp, ka = jax.random.split(kk)
            return jp.prior.sample_centered(kp), jax.random.uniform(ka, ())

        xi, u = jax.vmap(one)(chain_keys(key_mut, i, m))
        return T(xi), T(u)

    jstate, jinfo = jsmc.run(jp.potential_fn, jp.prior, key, n_particles=n,
                             mutation_steps=k, pcn_step=s, max_stages=1)
    zero = torch.tensor(0.0)
    state = smc.SMCState(particles=T(particles), potentials=T(potentials), beta=zero,
                         log_z=zero, stage=0)
    got, rec = smc.stage(state, p.potential_fn, p.prior, u0, step_draws,
                         mutation_steps=k, pcn_step=s)
    np.testing.assert_allclose(float(got.beta), float(jstate.beta), rtol=PHI_RTOL)
    np.testing.assert_allclose(float(got.log_z), float(jstate.log_z), rtol=PHI_RTOL)
    np.testing.assert_allclose(got.particles.numpy(), np.asarray(jstate.particles),
                               atol=POS_ATOL)
    np.testing.assert_allclose(got.potentials.numpy(), np.asarray(jstate.potentials),
                               rtol=PHI_RTOL)
    np.testing.assert_allclose(float(rec[2]), float(jinfo.accept_rates[0]), rtol=PHI_RTOL)
    np.testing.assert_allclose(float(rec[1]), float(jinfo.ess[0]), rtol=ESS_RTOL)


def test_run_batched_stage_matches_jax():
    """run_batched's first stage from JAX's draws (the uniform, each step's
    normals (d, n) and uniforms), with a warm 'solve' whose carried state
    depends on its history, so that the ancestors' gather of warm_aux and
    its update on acceptance both show."""
    n, k, s = 256, 3, 0.5
    jphi_b = lambda U: 0.5 * jnp.sum(  # noqa: E731
        ((jnp.asarray(Y, jnp.float32)[:, None] - jnp.asarray(A, jnp.float32) @ U)
         / NOISE) ** 2, axis=0)
    jphi2 = lambda U, X: (jphi_b(U), 0.5 * X + U[:1])  # noqa: E731
    _, phi_b, *_ = closed_form()
    phi2 = lambda U, X: (phi_b(U), 0.5 * X + U[:1])  # noqa: E731
    key = jax.random.key(6)
    key_init, key_loop = jax.random.split(key)
    U0 = jax.random.normal(key_init, (2, n), jnp.float32)
    X0 = jnp.zeros((1, n))
    for _ in range(8):
        phi0, X0 = jphi2(U0, X0)
    key_res, key_mut = jax.random.split(jax.random.fold_in(key_loop, 0))
    u0 = jax.random.uniform(key_res, (), minval=0.0, maxval=1.0 / n)
    xi, log_u = [], []
    for j in range(k):
        k_prop, k_acc = jax.random.split(jax.random.fold_in(key_mut, j))
        xi.append(jax.random.normal(k_prop, (2, n), jnp.float32))
        log_u.append(jnp.log(jax.random.uniform(k_acc, (n,), jnp.float32)))

    jstate, jinfo = jsmc.run_batched(None, np.zeros(2), np.ones(2), key, n_particles=n,
                                     warm_potential_fn=jphi2, aux_dim=1,
                                     mutation_steps=k, pcn_step=s, max_stages=1)
    zero = torch.tensor(0.0)
    state = smc.SMCState(particles=T(U0), potentials=T(phi0), beta=zero, log_z=zero,
                         stage=0, warm_aux=T(X0))
    got, rec = smc.stage_batched(state, phi2, torch.zeros(2, 1), torch.ones(2, 1), T(u0),
                                 torch.stack([T(x) for x in xi]),
                                 torch.stack([T(x) for x in log_u]), pcn_step=s)
    np.testing.assert_allclose(float(got.log_z), float(jstate.log_z), rtol=PHI_RTOL)
    np.testing.assert_allclose(got.particles.numpy(), np.asarray(jstate.particles),
                               atol=POS_ATOL)
    np.testing.assert_allclose(got.warm_aux.numpy(), np.asarray(jstate.warm_aux),
                               atol=POS_ATOL)
    np.testing.assert_allclose(got.potentials.numpy(), np.asarray(jstate.potentials),
                               rtol=PHI_RTOL)
    assert float(rec[2]) == float(jinfo.accept_rates[0])


# --- the closed form (tests/test_smc.py's bounds) ---------------------------------------


def test_posterior_and_evidence():
    phi, _, prior, mean, cov, log_z = closed_form()
    state, info = smc.run(phi, prior, gen(0), n_particles=4096, mutation_steps=10,
                          pcn_step=0.5)
    assert float(state.beta) == 1.0
    p = state.particles.numpy()
    np.testing.assert_allclose(p.mean(axis=0), mean, atol=0.05)
    np.testing.assert_allclose(np.cov(p.T), cov, atol=0.05)
    np.testing.assert_allclose(float(state.log_z), log_z, atol=0.1)
    assert torch.isnan(info.betas[info.n_stages:]).all()


def test_beta_ladder_monotone():
    phi, _, prior, *_ = closed_form()
    state, info = smc.run(phi, prior, gen(1), n_particles=512, mutation_steps=3)
    n = info.n_stages
    betas = info.betas[:n].numpy()
    assert np.all(np.diff(betas) > 0) and betas[-1] == 1.0
    np.testing.assert_allclose(info.ess[: n - 1].numpy(), 0.5 * 512, rtol=0.05)


def test_waste_free_matches_closed_form():
    phi, _, prior, mean, cov, log_z = closed_form()
    state, _ = smc.run(phi, prior, gen(0), n_particles=4096, mutation_steps=7,
                       pcn_step=0.5, waste_free=True)
    assert float(state.beta) == 1.0
    p = state.particles.numpy()
    np.testing.assert_allclose(p.mean(axis=0), mean, atol=0.05)
    np.testing.assert_allclose(np.cov(p.T), cov, atol=0.06)
    np.testing.assert_allclose(float(state.log_z), log_z, atol=0.12)
    np.testing.assert_allclose(state.potentials.numpy(), phi(state.particles).numpy(),
                               rtol=2e-3, atol=2e-3)
    with pytest.raises(ValueError):
        smc.run(phi, prior, gen(0), n_particles=1000, mutation_steps=5, waste_free=True)
    with pytest.raises(ValueError):
        smc.run(phi, prior, gen(0), n_particles=1024, mutation_steps=7, waste_free=True,
                esjd_target=1.0)


def test_esjd_target_varies_counts():
    phi, _, prior, mean, _, log_z = closed_form()
    state, info = smc.run(phi, prior, gen(0), n_particles=4096, mutation_steps=20,
                          pcn_step=0.5, esjd_target=2.0)
    assert float(state.beta) == 1.0
    np.testing.assert_allclose(state.particles.numpy().mean(axis=0), mean, atol=0.05)
    np.testing.assert_allclose(float(state.log_z), log_z, atol=0.12)
    counts = info.mutation_counts[: info.n_stages].numpy()
    assert np.all(counts >= 1) and np.all(counts <= 20) and counts.min() < 20


def test_thermodynamic_integration_anchors_evidence():
    phi, _, prior, _, _, log_z = closed_form()
    state, info = smc.run(phi, prior, gen(3), n_particles=4096, mutation_steps=10,
                          pcn_step=0.5, ess_target=0.95, max_stages=200)
    assert info.n_stages >= 10
    ti = smc.thermodynamic_log_z(info)
    np.testing.assert_allclose(ti, log_z, atol=0.15)
    np.testing.assert_allclose(ti, float(state.log_z), atol=0.15)


@pytest.mark.parametrize("warm", [False, True])
def test_run_batched_matches_closed_form(warm):
    """Cold: ess_target 0.8, the TI anchor too; warm: an identity 'solve'
    whose carried state is passed through (tests/test_smc.py's
    TestBatchedSMC)."""
    phi, phi_b, prior, mean, _, log_z = closed_form()
    if warm:
        state, _ = smc.run_batched(None, np.zeros(2), np.ones(2), gen(0), n_particles=2048,
                                   warm_potential_fn=lambda U, X: (phi_b(U), X), aux_dim=3,
                                   ess_target=0.5, mutation_steps=10, pcn_step=0.5)
        np.testing.assert_allclose(state.particles.numpy().mean(axis=1), mean, atol=0.07)
        np.testing.assert_allclose(float(state.log_z), log_z, atol=0.15)
        return
    state, info = smc.run_batched(phi_b, np.zeros(2), np.ones(2), gen(0), n_particles=4096,
                                  ess_target=0.8, mutation_steps=10, pcn_step=0.5)
    np.testing.assert_allclose(state.particles.numpy().mean(axis=1), mean, atol=0.05)
    np.testing.assert_allclose(float(state.log_z), log_z, atol=0.12)
    np.testing.assert_allclose(smc.thermodynamic_log_z(info), log_z, atol=0.3)


# --- the Darcy configs through the CLI ---------------------------------------------------


@pytest.fixture(scope="module")
def jax_smc_keys():
    """The JAX runner's SMC keys (darcy_smc at 16 particles, two stages)."""
    jp = jconfigs.build("darcy_smc")
    jp = dataclasses.replace(jp, kernel_params={**jp.kernel_params, "max_stages": 2})
    return set(jrunner.run_problem(jp, key=jax.random.key(0), n_chains=16))


def test_darcy_smc_warm_agrees_with_cold(jax_smc_keys, capsys):
    """Both configs through the CLI at 256 particles: the JAX runner's keys,
    β = 1 at the end, a log evidence within 3.0 of each other and posterior
    means within an RMS of 0.8 (tests/test_smc.py's bounds: two cold runs at
    256 particles differ by an RMS of about 0.55)."""
    out = {}
    for name in ("darcy_smc", "darcy_smc_warm"):
        assert run.main(["--config", name, "--device", "cpu", "--n-chains", "256"]) == 0
        out[name] = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        m = out[name]
        assert set(m) - {"setup_s", "cli_total_s"} == jax_smc_keys
        assert m["n_particles"] == 256 and m["final_beta"] == 1.0
        assert 0.0 < m["mean_mutation_accept"] <= 1.0
        assert np.isfinite([m["log_evidence"], m["log_evidence_ti"]]).all()
    cold, warm = out["darcy_smc"], out["darcy_smc_warm"]
    assert cold["kernel"] == "smc" and warm["kernel"] == "smc(batched+warm)"
    assert abs(warm["log_evidence"] - cold["log_evidence"]) < 3.0
    mc, mw = np.asarray(cold["posterior_mean"]), np.asarray(warm["posterior_mean"])
    assert np.sqrt(((mc - mw) ** 2).mean()) < 0.8
