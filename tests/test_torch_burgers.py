"""The port's Burgers build pieces and batched misfit
(ip_mcmc_tpu_torch/models/burgers.py, plain version on the CPU) against
ip_mcmc_tpu/models/burgers.py on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ip_mcmc_tpu.models import burgers as jburgers
from ip_mcmc_tpu.models import kl as jkl
from ip_mcmc_tpu_torch.convert import burgers_misfit_from_arrays
from ip_mcmc_tpu_torch.models import burgers, kl

torch.set_num_threads(1)


def sine_mean(n):
    return np.sin(2 * np.pi * (np.arange(n) + 0.5) / n)


# the four grids of the shipped configs: fine, middle, coarse, multi-time
GRIDS = {
    "fine": dict(n_cells=128, cfl_amax=3.0),
    "middle": dict(n_cells=128, cfl_amax=1.0),
    "coarse": dict(n_cells=64, cfl_amax=1.0,
                   obs_indices=np.arange(0, 64, 4)),
    "multitime": dict(n_cells=128, cfl_amax=3.0, obs_times=[0.07, 0.14, 0.2]),
}
STEPS = {"fine": [154], "middle": [52], "coarse": [26],
         "multitime": [54, 54, 46]}


def both_aux(grid):
    kw = dict(n_modes=16, alpha=1.5, field_scale=1.0, t_final=0.2,
              mean_profile=sine_mean(GRIDS[grid]["n_cells"]), **GRIDS[grid])
    return jburgers.make_burgers_forward(**kw)[1], burgers.burgers_aux(**kw)


def test_fourier_basis_matches_jax_package():
    grid = (np.arange(48) + 0.5) / 48
    for n_modes in (1, 2, 7, 16):
        np.testing.assert_array_equal(kl.fourier_basis(n_modes, grid),
                                      jkl.fourier_basis(n_modes, grid))


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_aux_matches_jax(grid):
    """dt, the step counts and the observation cells equal; the basis and
    the mean to f32 rounding (both are rounded from the same float64)."""
    aux_j, aux_t = both_aux(grid)
    assert set(aux_t) == set(aux_j)
    assert aux_t["n_cells"] == aux_j["n_cells"]
    assert aux_t["n_steps"] == aux_j["n_steps"] == sum(STEPS[grid])
    assert aux_t["dt"] == aux_j["dt"]
    assert list(aux_t["segment_steps"]) == list(aux_j["segment_steps"]) == STEPS[grid]
    np.testing.assert_array_equal(aux_t["obs_indices"],
                                  np.asarray(aux_j["obs_indices"]))
    np.testing.assert_allclose(aux_t["eigenvalues"],
                               np.asarray(aux_j["eigenvalues"]), rtol=1e-6)
    assert aux_t["scaled_basis"].dtype == aux_t["mean"].dtype == np.float32
    np.testing.assert_array_equal(aux_t["scaled_basis"],
                                  np.asarray(aux_j["scaled_basis"]))
    np.testing.assert_array_equal(aux_t["mean"], np.asarray(aux_j["mean"]))


def test_obs_times_errors():
    with pytest.raises(ValueError, match="increasing"):
        burgers.burgers_aux(n_cells=32, t_final=0.2, obs_times=[0.1, 0.05])
    with pytest.raises(ValueError, match="increasing"):
        burgers.burgers_aux(n_cells=32, t_final=0.2, obs_times=[0.1, 0.3])
    with pytest.raises(ValueError, match="collapse"):
        burgers.burgers_aux(n_cells=32, t_final=0.2, obs_times=[0.1, 0.1001])


def draws(n, seed=3, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal((16, n))).astype(
        np.float32)


def data_and_noise(grid, vector):
    m = 16 * len(STEPS[grid])
    r = np.random.default_rng(5)
    data = (0.5 * r.standard_normal(m)).astype(np.float32)
    noise = ((0.02 + 0.01 * r.random(m)).astype(np.float32) if vector else 0.02)
    return data, noise


@pytest.mark.parametrize("vector", [False, True])
@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_misfit_matches_jax(grid, vector):
    """Φ on 96 prior draws, scalar and per-observation noise, one and three
    segments. Both run the same f32 operations; only the KL product and the
    final sum differ in order, and the monotone scheme does not grow a
    rounding: measured at most 1.6e-6 relative, bound 1e-5."""
    aux_j, aux_t = both_aux(grid)
    data, noise = data_and_noise(grid, vector)
    U = draws(96)
    want = np.asarray(jburgers.make_batched_misfit(aux_j, data, noise)(
        jnp.asarray(U)))
    pot = burgers_misfit_from_arrays(aux_t, data, noise)
    assert pot.segments == tuple(STEPS[grid])
    got = pot(torch.from_numpy(U)).numpy()
    assert got.shape == (96,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5)
    # the JAX package's aux dict converts too, to the same module
    pot_j = burgers_misfit_from_arrays(aux_j, data, noise)
    assert torch.equal(pot_j(torch.from_numpy(U)), torch.from_numpy(got))
    assert pot_j.half_dt_over_h == pot.half_dt_over_h


def test_final_state_matches_jax_integrate_through_a_shock():
    """Draws three times the prior's width steepen into shocks well before
    t = 0.2 (the sine mean alone breaks at t = 1/2π): the state after 154
    steps within 1e-5 of ``integrate`` from the same initial state."""
    aux_j, aux_t = both_aux("fine")
    pot = burgers_misfit_from_arrays(aux_t, np.zeros(16), 0.02)
    U = draws(8, seed=9, scale=3.0)
    (state,) = pot.final_states(torch.from_numpy(U))
    u0 = np.asarray(aux_j["mean"])[None, :] + U.T @ np.asarray(aux_j["scaled_basis"])
    want = np.asarray(jburgers.integrate(jnp.asarray(u0), aux_j["dt"], 154))
    np.testing.assert_allclose(state.numpy().T, want, atol=1e-5)
    # shocks: in most draws the state jumps by more than 1 (about half its
    # range) across one cell
    jump = np.abs(np.diff(want, axis=1)).max(axis=1)
    assert (jump > 1.0).sum() >= 6


def test_step_is_conservative_and_matches_jax():
    r = np.random.default_rng(2)
    state = r.standard_normal((64, 5)).astype(np.float32)
    new = burgers.step_burgers(torch.from_numpy(state), 0.3)
    want = np.asarray(jburgers.step_burgers(jnp.asarray(state.T), 0.3)).T
    np.testing.assert_allclose(new.numpy(), want, rtol=1e-6, atol=1e-7)
    # the flux differences telescope over the periodic grid
    np.testing.assert_allclose(new.double().sum(0).numpy(),
                               state.astype(np.float64).sum(0), atol=2e-5)
    f = burgers.godunov_flux2(torch.tensor([1.0, -1.0, -2.0, 0.5]),
                              torch.tensor([2.0, 1.0, -1.0, -3.0]))
    assert f.tolist() == [1.0, 0.0, 1.0, 9.0]


def test_nan_input_gives_nan_phi():
    """A NaN coefficient reaches Φ as NaN (so that the MH test rejects),
    and leaves the other draws alone; as in JAX."""
    aux_j, aux_t = both_aux("coarse")
    data, noise = data_and_noise("coarse", False)
    U = draws(4)
    U[3, 1] = np.nan
    got = burgers_misfit_from_arrays(aux_t, data, noise)(torch.from_numpy(U)).numpy()
    want = np.asarray(jburgers.make_batched_misfit(aux_j, data, noise)(jnp.asarray(U)))
    assert np.isnan(got[1]) and np.isnan(want[1])
    keep = [0, 2, 3]
    np.testing.assert_allclose(got[keep], want[keep], rtol=1e-5)


def test_argument_checks():
    _, aux = both_aux("coarse")
    data, noise = data_and_noise("coarse", True)
    pot = burgers_misfit_from_arrays(aux, data, noise)
    with pytest.raises(ValueError, match="expected f32"):
        pot(torch.zeros(16, 4, dtype=torch.float64))
    with pytest.raises(ValueError, match="expected f32"):
        pot(torch.zeros(8, 4))
    with pytest.raises(ValueError, match="data has"):
        burgers_misfit_from_arrays(aux, data[:5], 0.02)
    with pytest.raises(ValueError, match="segment_steps"):
        burgers_misfit_from_arrays({**aux, "segment_steps": [1] * 9},
                                   np.zeros(16 * 9), 0.02)
    spec = pot.spec()
    assert (spec.n_cells, spec.K, spec.m, spec.n_segments) == (64, 16, 16, 1)
    assert list(spec.seg_steps)[:2] == [26, 0]
    assert spec.half_dt_over_h == np.float32(0.5 * aux["dt"] * 64)


def small_burgers_levels(noise=0.05):
    """A three-level Burgers problem small enough for the CPU chain tests:
    32 cells / 10 steps (fine), 32 / 4 (middle), 16 / 2 (coarse), 16 KL
    modes, 8 observations; y the fine model at numpy-drawn coefficients
    plus numpy noise. Returns ((JAX fine, middle, coarse), (port's))."""
    obs = np.arange(2, 32, 4)
    grids = [dict(n_cells=32, cfl_amax=3.0, obs_indices=obs),
             dict(n_cells=32, cfl_amax=1.0, obs_indices=obs),
             dict(n_cells=16, cfl_amax=1.0, obs_indices=obs // 2)]
    aux = []
    for g in grids:
        kw = dict(n_modes=16, alpha=1.5, field_scale=1.0, t_final=0.05,
                  mean_profile=sine_mean(g["n_cells"]), **g)
        aux.append((jburgers.make_burgers_forward(**kw)[1],
                    burgers.burgers_aux(**kw)))
    assert [a[1]["n_steps"] for a in aux] == [10, 4, 2]
    r = np.random.default_rng(400)
    truth = burgers_misfit_from_arrays(aux[0][1], np.zeros(8), noise)
    (state,) = truth.final_states(
        torch.from_numpy(r.standard_normal((16, 1)).astype(np.float32)))
    y = (state[obs, 0].numpy() + noise * r.standard_normal(8)).astype(np.float32)
    return (tuple(jburgers.make_batched_misfit(a[0], y, noise) for a in aux),
            tuple(burgers_misfit_from_arrays(a[1], y, noise) for a in aux))
