"""The single-particle Burgers forward of the scan path
(``ip_mcmc_tpu_torch/models/burgers.py``: ``integrate``,
``make_burgers_forward``) against the JAX package's
(``ip_mcmc_tpu/models/burgers.py``) on the CPU, on inputs drawn with numpy
from a seed; and the two configs it unlocks without ``--fused``,
``burgers_pcn`` and ``burgers_multitime_pcn``: their potentials against
JAX's ``phi``, and their scan runs through the CLI with the JAX runner's
keys.

Tolerance. The Godunov step is the same f32 arithmetic in the same order
on both sides (no product is contracted into an FMA on the CPU); only the
KL sum that forms the initial state is added in another order, so an
initial state may differ by an ulp, which the monotone scheme does not
grow. Measured at most 5e-7 of the largest entry; the bound is
``BURGERS_TOL``'s 2e-6 (``chip_smoke.py``). The potentials: 1e-5 relative,
as ``tests/test_torch_burgers.py`` holds the batched misfit."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ip_mcmc_tpu import configs as jconfigs
from ip_mcmc_tpu import runner as jrunner
from ip_mcmc_tpu.models import burgers as jburgers
from ip_mcmc_tpu_torch import configs, run, runner
from ip_mcmc_tpu_torch.models import burgers
from ip_mcmc_tpu_torch.ops import _build

torch.set_num_threads(1)

RTOL = 2e-6  # the forward: of each draw's largest entry
PHI_RTOL = 1e-5
SCAN = ("burgers_pcn", "burgers_multitime_pcn")
SINE = np.sin(2 * np.pi * (np.arange(128) + 0.5) / 128)


def _close(got, want, rtol):
    err = np.abs(got - want).max(axis=-1)
    scale = np.abs(want).max(axis=-1)
    assert np.all(err <= rtol * scale), (err / scale).max()


def _coeffs(K=16, batch=8, seed=0, amp=1.0):
    return (amp * np.random.default_rng(seed).standard_normal((batch, K))).astype(np.float32)


FORWARDS = [
    dict(n_cells=128, n_modes=16, alpha=1.5, field_scale=1.0, t_final=0.2,
         mean_profile=SINE),
    dict(n_cells=128, n_modes=16, alpha=1.5, field_scale=1.0, t_final=0.2,
         mean_profile=SINE, obs_times=[0.07, 0.14, 0.2]),
    dict(n_cells=64, n_modes=8, alpha=1.5, field_scale=2.0, t_final=0.3,
         obs_indices=[0, 5, 17, 40, 63]),
]


@pytest.mark.parametrize("kw", FORWARDS, ids=["final_time", "three_times", "coarse"])
def test_forward_matches_jax(kw):
    """The forward on 8 draws (half of them doubled: stronger shocks), and
    the aux constants."""
    fj, jaux = jburgers.make_burgers_forward(**kw)
    ft, taux = burgers.make_burgers_forward(**kw, device="cpu")
    u = _coeffs(kw["n_modes"], seed=1)
    u[4:] *= 2.0
    want = np.asarray(jax.vmap(fj)(jnp.asarray(u)))
    got = ft(torch.tensor(u)).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    _close(got, want, RTOL)
    # a single particle too (no chain dimension)
    _close(ft(torch.tensor(u[0])).numpy()[None], want[:1], RTOL)
    for k in ("scaled_basis", "mean", "obs_indices", "eigenvalues"):
        np.testing.assert_allclose(taux[k].numpy(), np.asarray(jaux[k]), rtol=1e-6, err_msg=k)
    for k in ("n_cells", "dt", "n_steps", "segment_steps"):
        assert taux[k] == jaux[k], k


@pytest.mark.parametrize("record_every", [0, 7])
def test_integrate_matches_jax(record_every):
    """``integrate`` on (chains, cells) states through a shock, final and
    recorded every 7 steps."""
    u0 = (1.5 * np.random.default_rng(2).standard_normal((4, 64))).astype(np.float32)
    want = jax.vmap(lambda s: jburgers.integrate(s, 0.002, 30, record_every))(jnp.asarray(u0))
    got = burgers.integrate(torch.tensor(u0), 0.002, 30, record_every)
    if record_every == 0:
        _close(got.numpy(), np.asarray(want), RTOL)
    else:
        (final, traj), (jfinal, jtraj) = got, want
        _close(final.numpy(), np.asarray(jfinal), RTOL)
        assert traj.shape == (4, 4, 64) and jtraj.shape == (4, 4, 64)
        # JAX's (chains, records, cells) under vmap; the port's (records, chains, cells)
        _close(traj.transpose(0, 1).numpy(), np.asarray(jtraj), RTOL)


def test_step_along_the_last_axis_equals_the_first():
    state = np.random.default_rng(3).standard_normal((5, 32)).astype(np.float32)
    a = burgers.step_burgers(torch.tensor(state), 0.3, dim=-1)
    b = burgers.step_burgers(torch.tensor(state.T), 0.3).T
    assert torch.equal(a, b)


@pytest.fixture(scope="module")
def problems():
    return {name: (jconfigs.build(name), configs.build(name, "cpu")) for name in SCAN}


@pytest.mark.parametrize("name", SCAN)
def test_scan_potential_matches_jax_phi(problems, name):
    """The config's scan Φ on 16 prior draws (half tripled) against JAX's
    single-particle phi; both read the frozen data of burgers128.npz."""
    jp, p = problems[name]
    u = _coeffs(16, batch=16, seed=5)
    u[8:] *= 3.0
    want = np.asarray(jax.vmap(jp.potential_fn)(jnp.asarray(u)))
    got = p.potential_fn(torch.tensor(u)).numpy()
    assert got.shape == (16,) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=PHI_RTOL)
    np.testing.assert_allclose(p.data, np.asarray(jp.data), rtol=1e-6)


@pytest.mark.parametrize("name", SCAN)
def test_scan_runs_print_jax_runner_keys(problems, name, capsys):
    """Without --fused, through the CLI at 64 chains and 4 samples (the
    500-step warm-up in full) and through run_problem with a 4-step one
    beside JAX's scan path: the one-dispatch keys, the steps counted on the
    CPU, and no kernel's plain version run."""
    jp, p = problems[name]
    _build.launch_counts.clear()
    assert run.main(["--config", name, "--device", "cpu", "--n-chains", "64",
                     "--n-samples", "4"]) == 0
    cli = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    counts = dict(_build.launch_counts)
    assert counts == {"scan_pcn_step[cpu]": 2 * (500 + 4)}, counts
    assert cli["kernel"] == "pcn" and cli["warm_steps"] == 500

    m = runner.run_problem(dataclasses.replace(p, burn_in=4), "cpu", n_chains=64, n_samples=4)
    jm = jrunner.run_problem(dataclasses.replace(jp, burn_in=4), key=jax.random.key(0),
                             n_chains=64, n_samples=4)
    assert set(m) - {"warning"} == set(jm) - {"warning"}
    assert set(cli) - {"warning", "setup_s", "cli_total_s"} == set(m) - {"warning"}
    assert m["kernel"] == jm["kernel"] == "pcn"
    assert 0.0 <= m["accept_rate"] <= 1.0 and np.isfinite(m["posterior_mean"]).all()
