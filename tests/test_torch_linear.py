"""The linear-Gaussian potential and the scan path's building blocks
(ip_mcmc_tpu_torch/models/linear.py, distributions.py, potentials.py,
models/kl.py) against the JAX package on the CPU, and the configs
gauss2d_rwm / lingauss_pcn against the JAX configs, the fixture
lingauss32.npz against a fresh JAX build."""

import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ip_mcmc_tpu import configs as jconfigs
from ip_mcmc_tpu import distributions as jdist
from ip_mcmc_tpu import potentials as jpotentials
from ip_mcmc_tpu.models import kl as jkl
from ip_mcmc_tpu.models import linear as jlinear
from ip_mcmc_tpu_torch import configs, distributions, potentials
from ip_mcmc_tpu_torch.convert import linear_gaussian_from_arrays
from ip_mcmc_tpu_torch.models import kl, linear

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "scripts"))
import freeze_torch_fixtures  # noqa: E402

RTOL = 1e-6  # every input f32; the sums of the two sides in other orders


def draws(d, B=256, seed=0, scale=1.5):
    return (scale * np.random.default_rng(seed).standard_normal((d, B))).astype(np.float32)


def assert_close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=0)


# --- LinearGaussianPotential against the JAX package's closures ----------------


def test_compare_paths_target():
    """benchmarks/compare_paths.py pot_batch: A = I, c = MEAN, σ = √VAR."""
    mean, var = np.array([1.0, -0.5], np.float32), np.array([2.0, 0.5], np.float32)
    want = lambda x: 0.5 * jnp.sum((x - mean[:, None]) ** 2 / var[:, None], axis=0)
    pot = linear_gaussian_from_arrays(np.eye(2), np.zeros(2), np.sqrt(var), center=mean)
    U = draws(2)
    assert_close(pot(torch.from_numpy(U)), want(jnp.asarray(U)))


def test_gauss2d_phi_batched():
    """gauss2d_rwm's phi_batched (ip_mcmc_tpu/configs/__init__.py l.140),
    ½ dᵀ P d with P = Σ⁻¹ in f32, as A = Lᵀ, P = L Lᵀ."""
    mean = jnp.array([1.0, -0.5])
    cov = np.array([[2.0, 0.8], [0.8, 1.0]])
    prec = jnp.asarray(np.linalg.inv(cov), jnp.float32)

    def phi_batched(U):  # the JAX config's closure, verbatim
        d = U - mean[:, None]
        return 0.5 * jnp.sum(d * (prec @ d), axis=0)

    U = draws(2, seed=1)
    assert_close(configs.gauss2d_batched_potential()(torch.from_numpy(U)),
                 phi_batched(jnp.asarray(U)))


def test_lingauss_misfit():
    """lingauss_pcn's potential_fn (single particle, vmapped) against the
    batched potential from the same arrays."""
    jp = jconfigs.build("lingauss_pcn")
    A, lam, y, sigma = configs.lingauss_arrays()
    U = draws(32, seed=2) * np.sqrt(lam)[:, None].astype(np.float32)
    want = jax.vmap(jp.potential_fn)(jnp.asarray(U.T))
    assert_close(linear_gaussian_from_arrays(A, y, sigma)(torch.from_numpy(U)), want)


@pytest.mark.parametrize("case", ["unit", "sharp", "zero"])
def test_pallas_ops_potentials(case):
    """tests/test_pallas_ops.py's: ½‖y − x‖², ½‖y − x‖²/0.01, and Φ ≡ 0
    (m = 0)."""
    d = 16
    y = np.linspace(-0.5, 0.5, d).astype(np.float32)
    U = draws(d, seed=3)
    if case == "zero":
        want = jnp.zeros((U.shape[1],), jnp.float32)
        pot = linear_gaussian_from_arrays(np.zeros((0, d)), np.zeros(0), 1.0)
    else:
        s = 0.01 if case == "sharp" else 1.0
        want = 0.5 * jnp.sum((y[:, None] - jnp.asarray(U)) ** 2, axis=0) / s
        pot = linear_gaussian_from_arrays(np.eye(d), y, np.sqrt(s))
    got = pot(torch.from_numpy(U))
    if case == "zero":
        assert torch.equal(got, torch.zeros(U.shape[1]))
    else:
        assert_close(got, want)


def test_potential_kernel_copy_is_dense_transposed():
    """The kernel reads Aᵀ as a dense row-major (d, m) array from its data
    pointer: a transposed input (gauss2d's A = Lᵀ, column-major strides)
    must come out as L there, not as Lᵀ."""
    L = np.linalg.cholesky(np.array([[2.0, 0.5], [0.5, 1.0]]))
    for pot in (linear_gaussian_from_arrays(L.T, np.zeros(2), 1.0),
                linear_gaussian_from_arrays(L.T.copy(), np.zeros(2), 1.0)):
        assert pot.At.is_contiguous()
        np.testing.assert_array_equal(pot.At.numpy(), L.astype(np.float32))
        np.testing.assert_array_equal(pot.A.numpy(), L.T.astype(np.float32))
        spec = pot.spec()
        assert (spec.m, spec.K) == (2, 2) and spec.At == pot.At.data_ptr()
    g2 = configs.gauss2d_batched_potential()
    assert g2.At.is_contiguous() and torch.equal(g2.At, g2.A.T)


def test_potential_checks_its_input():
    pot = linear_gaussian_from_arrays(np.eye(3), np.zeros(3), 1.0)
    with pytest.raises(ValueError, match="d=3"):
        pot(torch.zeros(2, 4))
    with pytest.raises(ValueError, match="f32"):
        pot(torch.zeros(3, 4, dtype=torch.float64))
    with pytest.raises(ValueError, match="d <= 256"):
        linear_gaussian_from_arrays(np.zeros((1, 257)), np.zeros(1), 1.0)
    with pytest.raises(ValueError, match="rows"):
        linear_gaussian_from_arrays(np.eye(3), np.zeros(2), 1.0)


# --- distributions, potentials, the linear model --------------------------------


def test_diag_gaussian_and_kl_prior():
    lam = kl.laplacian_eigenvalues(8, alpha=1.0, scale=4.0)
    np.testing.assert_allclose(lam, jkl.laplacian_eigenvalues(8, alpha=1.0, scale=4.0),
                               rtol=1e-15)
    pj, pt = jdist.gaussian_kl_prior(lam), distributions.gaussian_kl_prior(lam)
    np.testing.assert_array_equal(pt.scale.numpy(), np.asarray(pj.scale))
    x = draws(8, B=64, seed=4).T
    for name in ("log_prob", "potential", "whiten"):
        assert_close(getattr(pt, name)(torch.from_numpy(x)),
                     getattr(pj, name)(jnp.asarray(x)), rtol=2e-6)
    g = torch.Generator().manual_seed(0)
    s = pt.sample_centered(g, 20000)
    assert s.shape == (20000, 8)
    np.testing.assert_allclose(s.std(0).numpy(), pt.scale.numpy(), rtol=0.05)


def test_dense_gaussian_from_covariance():
    mean, cov = np.array([1.0, -0.5]), np.array([[2.0, 0.8], [0.8, 1.0]])
    gj = jdist.Gaussian.from_covariance(mean, cov)
    gt = distributions.Gaussian.from_covariance(mean, cov)
    np.testing.assert_allclose(gt.chol.numpy(), np.asarray(gj.chol), rtol=1e-6)
    np.testing.assert_allclose(gt.covariance.numpy(), cov, rtol=1e-6)
    x = draws(2, B=64, seed=5).T
    for name in ("log_prob", "potential", "whiten"):  # JAX: one point at a time
        np.testing.assert_allclose(getattr(gt, name)(torch.from_numpy(x)).numpy(),
                                   np.asarray(jax.vmap(getattr(gj, name))(jnp.asarray(x))),
                                   rtol=1e-5, atol=1e-6)
    s = gt.sample(torch.Generator().manual_seed(1), 40000).numpy()
    np.testing.assert_allclose(np.cov(s.T), cov, atol=0.05)


def test_potentials_match_jax():
    """misfit_potential on the linear forward map, analytic_potential and
    posterior_log_density: the JAX single-particle functions vmapped
    against the port's on the batch."""
    r = np.random.default_rng(6)
    A = r.standard_normal((5, 4)).astype(np.float32)
    y = r.standard_normal(5).astype(np.float32)
    nj = jdist.DiagGaussian(mean=jnp.zeros(5), scale=0.3 * jnp.ones(5))
    nt = distributions.DiagGaussian(mean=torch.zeros(5), scale=0.3 * torch.ones(5))
    prior_j = jdist.DiagGaussian(mean=jnp.zeros(4), scale=2.0 * jnp.ones(4))
    prior_t = distributions.DiagGaussian(mean=torch.zeros(4), scale=2.0 * torch.ones(4))
    phi_j = jpotentials.misfit_potential(jlinear.make_forward(A), y, nj)
    phi_t = potentials.misfit_potential(linear.make_forward(torch.from_numpy(A)),
                                        torch.from_numpy(y), nt)
    x = draws(4, B=32, seed=7).T
    assert_close(phi_t(torch.from_numpy(x)), jax.vmap(phi_j)(jnp.asarray(x)), rtol=2e-6)
    assert_close(phi_t(torch.from_numpy(x[0])), phi_j(jnp.asarray(x[0])), rtol=2e-6)
    lj = jpotentials.posterior_log_density(phi_j, prior_j)
    lt = potentials.posterior_log_density(phi_t, prior_t)
    assert_close(lt(torch.from_numpy(x)), jax.vmap(lj)(jnp.asarray(x)), rtol=2e-6)
    aj = jpotentials.analytic_potential(prior_j.log_prob)
    at = potentials.analytic_potential(prior_t.log_prob)
    assert_close(at(torch.from_numpy(x)), jax.vmap(aj)(jnp.asarray(x)), rtol=2e-6)
    with pytest.raises(ValueError, match="data shape"):
        potentials.misfit_potential(lambda u: u, torch.zeros(5), None)(torch.zeros(3, 4))


def test_conjugate_posterior_matches_jax():
    r = np.random.default_rng(8)
    A, y = r.standard_normal((3, 4)), r.standard_normal(3)
    for got, want in zip(linear.conjugate_posterior(A, np.zeros(4), np.ones(4), 0.1 * np.ones(3), y),
                         jlinear.conjugate_posterior(A, np.zeros(4), np.ones(4), 0.1 * np.ones(3), y)):
        np.testing.assert_allclose(got, want, rtol=1e-12)


# --- the configs and the fixture --------------------------------------------------


def test_lingauss_fixture_matches_fresh_jax_build():
    jp = jconfigs.build("lingauss_pcn")
    fresh = freeze_torch_fixtures.lingauss_fixture_arrays(jp)
    frozen = np.load(configs.LINGAUSS_FIXTURE)
    assert set(frozen.files) == set(fresh) == {"u_true", "y"}
    for k, v in fresh.items():
        np.testing.assert_allclose(frozen[k], v, rtol=1e-6, err_msg=k)
    # y = A u_true + the noise draw under key 101
    A, _, y, sigma = configs.lingauss_arrays()
    noise = np.asarray(jdist.DiagGaussian(mean=jnp.zeros(16), scale=sigma * jnp.ones(16))
                       .sample(jax.random.key(101)))
    np.testing.assert_allclose(y, A @ frozen["u_true"] + noise, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["gauss2d_rwm", "lingauss_pcn"])
def test_scan_configs_match_jax_problems(name):
    jp, p = jconfigs.build(name), configs.build(name, "cpu")
    assert (p.name, p.dim, p.kernel, p.thin) == (jp.name, jp.dim, jp.kernel, jp.thin)
    assert (p.n_chains, p.n_samples, p.burn_in) == (jp.n_chains, jp.n_samples, jp.burn_in)
    assert p.kernel_params == jp.kernel_params
    assert p.batched_potential_fn is None and jp.batched_potential_fn is None
    np.testing.assert_allclose(p.truth, np.asarray(jp.truth), rtol=1e-6)
    if jp.data is None:
        assert p.data is None
    else:
        np.testing.assert_array_equal(p.data, np.asarray(jp.data))
    np.testing.assert_allclose(p.prior.mean.numpy(), np.asarray(jp.prior.mean))
    np.testing.assert_allclose(p.prior.scale.numpy(), np.asarray(jp.prior.scale), rtol=1e-7)
    x = (draws(p.dim, B=64, seed=9) * p.prior.scale.numpy()[:, None]).T.copy()
    for attr in ("potential_fn", "log_density_fn"):
        got = getattr(p, attr)(torch.from_numpy(x)).numpy()
        want = np.asarray(jax.vmap(getattr(jp, attr))(jnp.asarray(x)))
        np.testing.assert_allclose(got, want, rtol=2e-6, err_msg=attr)
