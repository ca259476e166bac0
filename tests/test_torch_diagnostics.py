"""The port's diagnostics (ip_mcmc_tpu_torch/diagnostics.py) against the
JAX package's on the same autocorrelated numpy samples."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ip_mcmc_tpu import diagnostics as jdiag
from ip_mcmc_tpu_torch import diagnostics as tdiag

torch.set_num_threads(1)

RTOL = 1e-4  # f32 on both sides; FFT and reduction orders differ


@pytest.fixture(scope="module")
def samples():
    """(200, 16, 5) AR(1) chains with per-parameter correlation, offsets
    and scales (one parameter's chains disagree on purpose: R̂ > 1)."""
    r = np.random.default_rng(3)
    n, c, d = 200, 16, 5
    phi = np.array([0.0, 0.5, 0.9, 0.95, 0.7])
    x = np.zeros((n, c, d))
    x[0] = r.standard_normal((c, d))
    for t in range(1, n):
        x[t] = phi * x[t - 1] + np.sqrt(1 - phi**2) * r.standard_normal((c, d))
    x[:, : c // 2, 4] += 1.5  # half the chains offset in the last parameter
    x = x * np.array([1.0, 2.0, 0.5, 3.0, 1.0]) + np.array([0, 1, -2, 0.5, 0])
    return x.astype(np.float32)


@pytest.mark.parametrize("name", ["ess", "split_rhat", "rank_normalized_rhat"])
def test_per_parameter_estimators_match_jax(samples, name):
    for i in range(samples.shape[2]):
        x = samples[:, :, i]
        want = float(getattr(jdiag, name)(jnp.asarray(x)))
        got = float(getattr(tdiag, name)(torch.from_numpy(x)))
        np.testing.assert_allclose(got, want, rtol=RTOL)


def test_autocovariance_matches_jax(samples):
    x = samples[:, :, 2]
    np.testing.assert_allclose(
        tdiag.autocovariance(torch.from_numpy(x)).numpy(),
        np.asarray(jdiag.autocovariance(jnp.asarray(x))), rtol=RTOL, atol=1e-5,
    )


def test_summarize_matches_jax(samples):
    want = jdiag.summarize(jnp.asarray(samples))
    got = tdiag.summarize(torch.from_numpy(samples))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=RTOL, atol=1e-6, err_msg=k)
