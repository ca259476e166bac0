"""The port's paths end to end (configs, runner, CLI) against the JAX
package on the CPU: the frozen fixture, the configs' misfits, the CLI's
JSON keys; and the rule that the port never imports JAX."""

import dataclasses
import json
import pathlib
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ip_mcmc_tpu import configs as jconfigs
from ip_mcmc_tpu import runner as jrunner
from ip_mcmc_tpu.models import darcy as jdarcy
from ip_mcmc_tpu_torch import configs, resolve_device, run, runner

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "scripts"))
import freeze_torch_fixtures  # noqa: E402
from test_torch_darcy import assert_bf16_agreement  # noqa: E402


@pytest.fixture(scope="module")
def jax_problem():
    return jconfigs.build("darcy_da_fused")


def test_fixture_matches_fresh_jax_build(jax_problem):
    fresh = freeze_torch_fixtures.fixture_arrays(jax_problem)
    frozen = np.load(configs.FIXTURE)
    assert set(frozen.files) == set(fresh)
    for k, v in fresh.items():
        np.testing.assert_allclose(frozen[k], v, rtol=1e-6, err_msg=k)


def test_config_misfits_match_jax_problem(jax_problem):
    """The port's config (numpy constants + fixture) gives the JAX config's
    potentials. Exact: every prior draw within rtol 1e-5; surrogate: bf16
    preconditioner rounding flips allowed as in test_torch_darcy.py."""
    p = configs.build("darcy_da_fused", "cpu")
    assert p.dim == jax_problem.dim and p.thin == jax_problem.thin
    assert (p.n_chains, p.n_samples, p.burn_in) == (
        jax_problem.n_chains, jax_problem.n_samples, jax_problem.burn_in)
    assert p.kernel_params == jax_problem.kernel_params
    U = np.random.default_rng(11).standard_normal((64, 128)).astype(np.float32)
    want = np.asarray(jax_problem.batched_potential_fn(jnp.asarray(U)))
    got = p.batched_potential_fn(torch.from_numpy(U)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    want = np.asarray(jax_problem.batched_surrogate_fn(jnp.asarray(U)))
    got = p.batched_surrogate_fn(torch.from_numpy(U)).numpy()
    assert_bf16_agreement(got, want)


def test_cli_json_keys_match_jax_runner(jax_problem, capsys):
    assert run.main(["--config", "darcy_da_fused", "--device", "cpu",
                     "--n-chains", "64", "--n-samples", "4"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    m = json.loads(lines[0])

    jp = dataclasses.replace(
        jax_problem, n_chains=64, n_samples=4, burn_in=2,
        kernel_params={**jax_problem.kernel_params, "subchain_len": 4,
                       "block_chains": 32},
    )
    jm = jrunner.run_problem(jp, key=jax.random.key(0))
    jm["setup_s"] = jm["cli_total_s"] = 0.0  # added by ip_mcmc_tpu.run
    # "warning" appears exactly when R̂ > 1.1 (on either side)
    for metrics in (m, jm):
        assert ("warning" in metrics) == (not metrics["converged"])
    assert set(m) - {"warning"} == set(jm) - {"warning"}

    assert m["config"] == "darcy_da_fused" and m["kernel"] == "da_pcn(fused)"
    assert (m["n_chains"], m["n_samples"], m["dim"]) == (64, 4, 64)
    for k in ("outer_steps_per_s", "inner_steps_per_s", "ess_per_s",
              "min_ess", "max_rhat", "run_s", "warmup_s"):
        assert np.isfinite(m[k]) and m[k] > 0.0, k
    assert m["inner_steps_per_s"] == pytest.approx(48 * m["outer_steps_per_s"])
    for k in ("accept_rate", "inner_accept_rate"):
        assert 0.0 <= m[k] <= 1.0
    assert len(m["posterior_mean"]) == 64
    assert np.isfinite(m["posterior_mean"]).all()


SINGLE_LEVEL = ("darcy_pcn_4096", "darcy_pcn_warm", "darcy_ess_fused")


@pytest.mark.parametrize("name", SINGLE_LEVEL)
def test_single_level_configs_match_jax_problems(name):
    """The pCN and ESS configs, built from the same fixture: sizes, kernel
    parameters, data, and the cold Jacobi-48 misfit (every input f32: rtol
    1e-5 on every draw); for darcy_pcn_warm the warm misfit too (bf16
    factors: the bounds of test_torch_darcy_warm.py)."""
    jp, p = jconfigs.build(name), configs.build(name, "cpu")
    assert (p.name, p.dim, p.kernel, p.thin) == (jp.name, jp.dim, jp.kernel, jp.thin)
    assert (p.n_chains, p.n_samples, p.burn_in) == (
        jp.n_chains, jp.n_samples, jp.burn_in)
    assert p.kernel_params == jp.kernel_params
    np.testing.assert_allclose(p.data, np.asarray(jp.data), rtol=1e-6)
    np.testing.assert_allclose(p.truth, np.asarray(jp.truth), rtol=1e-6)
    U = np.random.default_rng(12).standard_normal((64, 64)).astype(np.float32)
    want = np.asarray(jp.batched_potential_fn(jnp.asarray(U)))
    got = p.batched_potential_fn(torch.from_numpy(U)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert (p.batched_warm_potential is None) == (jp.batched_warm_potential is None)
    if p.batched_warm_potential is not None:
        (warm_j, aux_j), (warm_t, aux_t) = (jp.batched_warm_potential,
                                            p.batched_warm_potential)
        assert aux_j == aux_t == 256
        x0 = np.zeros((256, 64), np.float32)
        pj, xj = warm_j(jnp.asarray(U), jnp.asarray(x0))
        U2 = (0.9968 * U + 0.08 * U[:, ::-1]).astype(np.float32)
        pj2, _ = warm_j(jnp.asarray(U2), xj)
        pt, _ = warm_t(torch.from_numpy(U), torch.from_numpy(x0))
        pt2, _ = warm_t(torch.from_numpy(U2), torch.tensor(np.asarray(xj)))
        rel = np.abs(pt.numpy() - np.asarray(pj)) / np.abs(np.asarray(pj))
        assert np.median(rel) <= 2e-5 and rel.max() <= 5e-3
        assert_bf16_agreement(pt2.numpy(), np.asarray(pj2))


@pytest.mark.parametrize("name,flags", [("darcy_pcn_warm", []),
                                        ("darcy_ess_fused", []),
                                        ("darcy_pcn_4096", ["--fused"])])
def test_single_level_cli_json_keys_match_jax_runner(name, flags, capsys):
    assert run.main(["--config", name, "--device", "cpu", "--n-chains", "64",
                     "--n-samples", "4", *flags]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    m = json.loads(lines[0])

    jp = jconfigs.build(name)
    # short solves and burn-in for the interpret-mode kernel: the keys do
    # not depend on them
    aux = jdarcy.make_darcy_forward(n_grid=16, n_modes_per_dim=8, alpha=2.0,
                                    field_scale=10.0)[1]
    jp = dataclasses.replace(
        jp, n_chains=64, n_samples=4, burn_in=2,
        kernel_params={**jp.kernel_params, "fused": True, "block_chains": 32},
        batched_potential_fn=jdarcy.make_batched_misfit(aux, jp.data, 0.002,
                                                        cg_iters=4),
    )
    jm = jrunner.run_problem(jp, key=jax.random.key(0))
    jm["setup_s"] = jm["cli_total_s"] = 0.0  # added by ip_mcmc_tpu.run
    for metrics in (m, jm):
        assert ("warning" in metrics) == (not metrics["converged"])
    assert set(m) - {"warning"} == set(jm) - {"warning"}

    assert m["config"] == name and m["kernel"] == jm["kernel"]
    assert (m["n_chains"], m["n_samples"], m["dim"]) == (64, 4, 64)
    assert "outer_steps_per_s" not in m and "inner_accept_rate" not in m
    for k in ("steps_per_s", "ess_per_s", "min_ess", "max_rhat", "run_s",
              "warmup_s"):
        assert np.isfinite(m[k]) and m[k] > 0.0, k
    assert m["steps_per_s"] == pytest.approx(64 * 4 / m["run_s"])
    assert 0.0 < m["accept_rate"] <= 1.0
    assert len(m["posterior_mean"]) == 64
    assert np.isfinite(m["posterior_mean"]).all()


GRADIENT_AND_ENSEMBLE = ("darcy_mala_fused", "darcy_mala_warm", "darcy_fes_fused")


def _same_params(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], np.ndarray) or isinstance(b[k], np.ndarray):
            np.testing.assert_allclose(np.asarray(a[k]), np.asarray(b[k]), rtol=1e-12)
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("name", GRADIENT_AND_ENSEMBLE)
def test_gradient_and_ensemble_configs_match_jax_problems(name):
    """The MALA and ensemble-sampler configs: sizes, kernel parameters (the
    KL spectrum included), data, the resolved stretch dimension, and for
    darcy_mala_warm the value-and-gradient misfit from zeros (bf16 factors:
    the statistical bounds of test_torch_darcy_grad.py)."""
    jp, p = jconfigs.build(name), configs.build(name, "cpu")
    assert (p.name, p.dim, p.kernel, p.thin) == (jp.name, jp.dim, jp.kernel, jp.thin)
    assert (p.n_chains, p.n_samples, p.burn_in) == (
        jp.n_chains, jp.n_samples, jp.burn_in)
    _same_params(p.kernel_params, jp.kernel_params)
    np.testing.assert_allclose(p.data, np.asarray(jp.data), rtol=1e-6)
    assert (p.batched_warm_potential is None) == (jp.batched_warm_potential is None)
    if name == "darcy_fes_fused":
        # 8 on this spectrum (the JAX config's docstring says 6)
        m = runner._resolve_n_low_modes(p.kernel_params, p)
        assert m == jrunner._resolve_n_low_modes(jp.kernel_params, jp) == 8
    if name == "darcy_mala_fused":
        U = np.random.default_rng(12).standard_normal((64, 16)).astype(np.float32)
        want = jax.grad(lambda u: jnp.sum(jp.batched_potential_fn(u)))(jnp.asarray(U))
        got = p.batched_potential_fn.value_and_grad(torch.from_numpy(U))[1].numpy()
        err = np.abs(got - np.asarray(want)).max(axis=0) / np.abs(np.asarray(want)).max(axis=0)
        assert np.median(err) <= 1e-5 and err.max() <= 1e-4
    if name == "darcy_mala_warm":
        (pag_j, aux_j), (pag_t, aux_t) = (jp.batched_warm_potential,
                                          p.batched_warm_potential)
        assert aux_j == aux_t == 512
        U = np.random.default_rng(12).standard_normal((64, 64)).astype(np.float32)
        zeros = np.zeros((512, 64), np.float32)
        want = [np.asarray(o) for o in pag_j(jnp.asarray(U), jnp.asarray(zeros))]
        got = [o.numpy() for o in pag_t(torch.from_numpy(U), torch.from_numpy(zeros))]
        rel = np.abs(got[0] - want[0]) / np.abs(want[0])
        assert np.median(rel) <= 2e-5 and rel.max() <= 5e-3
        for g, w in zip(got[1:], want[1:]):
            err = np.abs(g - w).max(axis=0) / np.abs(w).max(axis=0)
            assert np.median(err) <= 1e-4 and err.max() <= 2e-2


@pytest.mark.parametrize("name", GRADIENT_AND_ENSEMBLE)
def test_gradient_and_ensemble_runs_print_jax_runner_keys(name):
    """Through run_problem on the CPU at 64 chains, 4 samples and a short
    burn-in: the JAX runner's keys (stretch_accept_rate for the ensemble
    sampler) and sane values."""
    p = dataclasses.replace(configs.build(name, "cpu"), burn_in=4)
    m = runner.run_problem(p, "cpu", seed=0, n_chains=64, n_samples=4)

    jp = jconfigs.build(name)
    # short solves for the interpret-mode kernel: the keys do not depend
    # on them
    aux = jdarcy.make_darcy_forward(n_grid=16, n_modes_per_dim=8, alpha=2.0,
                                    field_scale=10.0)[1]
    short = dict(
        n_chains=64, n_samples=4, burn_in=2,
        kernel_params={**jp.kernel_params, "block_chains": 32},
        batched_potential_fn=jdarcy.make_batched_misfit(
            aux, jp.data, 0.002, cg_iters=4, differentiable=True))
    if jp.batched_warm_potential is not None:
        short["batched_warm_potential"] = jdarcy.make_batched_misfit_mala_warm(
            aux, jp.data, 0.002, cg_iters=2, precond="dst")
    jm = jrunner.run_problem(dataclasses.replace(jp, **short), key=jax.random.key(0))
    for metrics in (m, jm):
        assert ("warning" in metrics) == (not metrics["converged"])
    assert set(m) - {"warning"} == set(jm) - {"warning"}
    assert ("stretch_accept_rate" in m) == (name == "darcy_fes_fused")

    assert m["config"] == name and m["kernel"] == jm["kernel"]
    assert (m["n_chains"], m["n_samples"], m["dim"]) == (64, 4, 64)
    for k in ("steps_per_s", "ess_per_s", "min_ess", "max_rhat", "run_s",
              "warmup_s"):
        assert np.isfinite(m[k]) and m[k] > 0.0, k
    rates = ["accept_rate"] + (["stretch_accept_rate"] if "fes" in name else [])
    for k in rates:
        assert 0.0 < m[k] <= 1.0, k
    assert len(m["posterior_mean"]) == 64
    assert np.isfinite(m["posterior_mean"]).all()


BURGERS = ("burgers_pcn", "burgers_multitime_pcn", "burgers_da_pcn",
           "burgers_da3_pcn")


def test_cli_lists_seven_configs(capsys):
    """The seven Darcy configs and, since the Burgers path, its four; since
    the scan path, gauss2d_rwm and lingauss_pcn; since the large grids,
    darcy32_pcn_warm, darcy64_pcn_warm and darcy64_da_fused; since the
    single-particle Darcy forward, darcy64_pcn; since the rest of the
    derivative-free scan path and the ODE gradient samplers, darcy_da_pcn,
    lingauss_elliptical, lingauss_fes, ode_mala, ode_hmc, multimodal_pt and
    multimodal_pt_mala; since tempered SMC, ADVI and the POD surrogates,
    darcy_smc, darcy_smc_warm, lingauss_advi, darcy_advi,
    darcy_advi_warmstart, darcy_da_pod and darcy_da_pod_online; since NUTS
    and ChEES, ode_nuts and ode_chees; since the multi-device layer the
    three composed ones: every config of the JAX package."""
    assert run.main(["--list"]) == 0
    names = [ln.split()[0] for ln in capsys.readouterr().out.strip().splitlines()]
    assert names == sorted(SINGLE_LEVEL + GRADIENT_AND_ENSEMBLE
                           + ("darcy_da_fused",) + BURGERS
                           + ("gauss2d_rwm", "lingauss_pcn")
                           + ("darcy32_pcn_warm", "darcy64_pcn_warm", "darcy64_da_fused")
                           + ("darcy64_pcn",)
                           + ("darcy_da_pcn", "lingauss_elliptical", "lingauss_fes",
                              "ode_mala", "ode_hmc", "multimodal_pt", "multimodal_pt_mala")
                           + ("darcy_smc", "darcy_smc_warm", "lingauss_advi", "darcy_advi",
                              "darcy_advi_warmstart", "darcy_da_pod", "darcy_da_pod_online")
                           + ("ode_nuts", "ode_chees")
                           + ("darcy_composed_pcn", "darcy_composed_mala",
                              "darcy_composed_ess"))
    assert set(names) == set(jconfigs.REGISTRY) and len(names) == 36
    assert not hasattr(configs, "NOT_PORTED")


def test_rwm_is_not_ported():
    """RWM runs fused on a batched potential and on the scan path of a
    config with a potential_fn; on Darcy's scan path (the single-particle
    forward model) it is not ported."""
    p = dataclasses.replace(configs.build("darcy_mala_fused", "cpu"), kernel="rwm",
                            kernel_params={"step_size": 0.01})
    assert p.potential_fn is None
    with pytest.raises(NotImplementedError, match="ported"):
        runner.run_problem(p, "cpu", n_chains=64, n_samples=2)


def test_unfused_pcn_config_is_not_ported():
    """A pCN config with a batched potential and no scan potential (as
    darcy_pcn_4096 was before the single-particle Darcy forward, which
    tests/test_torch_darcy_forward.py runs) runs only with --fused;
    anything else raises."""
    p = dataclasses.replace(configs.build("darcy_pcn_4096", "cpu"), potential_fn=None)
    with pytest.raises(NotImplementedError, match="--fused"):
        runner.run_problem(p, "cpu", n_chains=64, n_samples=4)


def test_cuda_device_is_never_a_silent_fallback():
    if torch.cuda.is_available():
        assert resolve_device("cuda").type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


# the JAX package's modules that the port has no module for, with the reason
NO_PORT_MODULE = {
    "utils/struct.py": "JAX pytree registration; the port's state classes are dataclasses",
}
# the JAX modules whose port lies under other paths: the Pallas samplers of
# ops/fused_mcmc.py, one port module a sampler, beside the scaffold and the RNG
PORTED_AS = {
    "ops/fused_mcmc.py": ("ops/_scaffold.py", "ops/rng.py", "ops/fused_rwm.py",
                          "ops/fused_pcn.py", "ops/fused_pcn_dense.py", "ops/fused_pcn_adapt.py",
                          "ops/fused_da_pcn.py", "ops/fused_da3_pcn.py", "ops/fused_ess.py",
                          "ops/fused_fes.py", "ops/fused_mala.py"),
}


def test_every_jax_module_has_a_port_module():
    """Each ``ip_mcmc_tpu/**/*.py`` has a module of the same path under
    ``ip_mcmc_tpu_torch/`` (the port does all that the JAX package does),
    but for NO_PORT_MODULE's, each with its reason; the JAX package's
    examples have the port's counterparts."""
    jax_root, port_root = ROOT / "ip_mcmc_tpu", ROOT / "ip_mcmc_tpu_torch"
    modules = sorted(str(f.relative_to(jax_root)) for f in jax_root.rglob("*.py"))
    assert len(modules) > 40
    missing = [m for m in modules if not all(
        (port_root / f).is_file() for f in PORTED_AS.get(m, (m,))) and m not in NO_PORT_MODULE]
    assert missing == []
    assert all(not (port_root / m).exists() for m in NO_PORT_MODULE)
    for example in sorted((ROOT / "examples").iterdir()):
        assert (port_root / "examples" / example.name).is_file(), example.name


def test_port_never_imports_jax():
    """Neither JAX nor the JAX package (``ip_mcmc_tpu``, not the port's own
    ``ip_mcmc_tpu_torch``), in any module of the port or chip_smoke.py."""
    pattern = re.compile(r"^\s*(import|from)\s+(jax|ip_mcmc_tpu)\b", re.M)
    assert pattern.search("from ip_mcmc_tpu.models import kl")
    assert pattern.search("import jax.numpy as jnp")
    assert not pattern.search("from ip_mcmc_tpu_torch import ops")
    files = sorted((ROOT / "ip_mcmc_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    offenders = [str(f) for f in files if pattern.search(f.read_text())]
    assert offenders == []


# --- the Burgers configs -------------------------------------------------------


@pytest.fixture(scope="module")
def jax_burgers():
    return {name: jconfigs.build(name) for name in BURGERS}


def test_burgers_fixture_matches_fresh_jax_build(jax_burgers):
    fresh = freeze_torch_fixtures.burgers_fixture_arrays(
        jax_burgers["burgers_da3_pcn"], jax_burgers["burgers_multitime_pcn"])
    frozen = np.load(configs.BURGERS_FIXTURE)
    assert set(frozen.files) == set(fresh)
    for k, v in fresh.items():
        assert frozen[k].shape == v.shape, k
        np.testing.assert_allclose(frozen[k], v, rtol=1e-6, err_msg=k)
    assert frozen["y"].shape == (16,) and frozen["y_multitime"].shape == (48,)
    # one data vector and one 64-cell calibration serve three configs
    for name in ("burgers_pcn", "burgers_da_pcn"):
        np.testing.assert_array_equal(np.asarray(jax_burgers[name].data),
                                      np.asarray(jax_burgers["burgers_da3_pcn"].data))
    surr = freeze_torch_fixtures._closure(
        jax_burgers["burgers_da_pcn"].surrogate_potential_fn)
    np.testing.assert_array_equal(np.asarray(surr["data"], np.float32),
                                  fresh["y_surr_64"])
    np.testing.assert_array_equal(np.asarray(surr["noise"].scale, np.float32),
                                  fresh["scale_64"])


@pytest.mark.parametrize("name", BURGERS)
def test_burgers_configs_match_jax_problems(jax_burgers, name):
    """Sizes, kernel parameters, data, truth, and every batched potential
    the JAX config has (fine; the calibrated 64-cell surrogate; the 128-cell
    middle level) on 64 prior draws: all f32, rtol 1e-5 as in
    tests/test_torch_burgers.py."""
    jp, p = jax_burgers[name], configs.build(name, "cpu")
    assert (p.name, p.dim, p.kernel, p.thin) == (jp.name, jp.dim, jp.kernel, jp.thin)
    assert (p.n_chains, p.n_samples, p.burn_in) == (
        jp.n_chains, jp.n_samples, jp.burn_in)
    assert p.kernel_params == jp.kernel_params
    np.testing.assert_allclose(p.data, np.asarray(jp.data), rtol=1e-6)
    np.testing.assert_allclose(p.truth, np.asarray(jp.truth), rtol=1e-6)
    U = np.random.default_rng(13).standard_normal((16, 64)).astype(np.float32)
    steps = {"batched_potential_fn": (154,), "batched_surrogate_fn": (26,),
             "batched_mid_fn": (52,)}
    if name == "burgers_multitime_pcn":
        steps["batched_potential_fn"] = (54, 54, 46)
    for attr, segments in steps.items():
        fj, ft = getattr(jp, attr), getattr(p, attr)
        assert (fj is None) == (ft is None), attr
        if fj is None:
            continue
        assert ft.segments == segments
        np.testing.assert_allclose(ft(torch.from_numpy(U)).numpy(),
                                   np.asarray(fj(jnp.asarray(U))), rtol=1e-5,
                                   err_msg=attr)
    assert (p.batched_mid_fn is not None) == (name == "burgers_da3_pcn")


@pytest.mark.parametrize("name", BURGERS)
def test_burgers_runs_print_jax_runner_keys(jax_burgers, name):
    """Through run_problem on the CPU at 64 chains, 4 samples, a short
    burn-in and short subchains (the keys do not depend on them): the JAX
    runner's keys, mid_accept_rate for the three-level config only, and
    inner_steps_per_s = outer x the inner steps of an outer step."""
    jp, p = jax_burgers[name], configs.build(name, "cpu")
    short = {"k_inner": 2, "k_mid": 2} if name == "burgers_da3_pcn" else (
        {"subchain_len": 2} if name == "burgers_da_pcn" else {})
    # "fused": what --fused sets for the two pCN configs
    p = dataclasses.replace(
        p, burn_in=2, kernel_params={**p.kernel_params, **short, "fused": True})
    m = runner.run_problem(p, "cpu", seed=0, n_chains=64, n_samples=4)
    jp = dataclasses.replace(
        jp, n_chains=64, n_samples=4, burn_in=2,
        kernel_params={**jp.kernel_params, **short, "fused": True,
                       "block_chains": 32})
    jm = jrunner.run_problem(jp, key=jax.random.key(0))
    for metrics in (m, jm):
        assert ("warning" in metrics) == (not metrics["converged"])
    assert set(m) - {"warning"} == set(jm) - {"warning"}
    assert m["config"] == name and m["kernel"] == jm["kernel"]
    assert (m["n_chains"], m["n_samples"], m["dim"]) == (64, 4, 16)
    assert ("mid_accept_rate" in m) == (name == "burgers_da3_pcn")
    assert ("inner_accept_rate" in m) == (name == "burgers_da_pcn")
    rates = ["accept_rate"]
    if p.kernel == "da_pcn":
        rates.append("mid_accept_rate" if "k_mid" in short else "inner_accept_rate")
        assert m["inner_steps_per_s"] == pytest.approx(
            (4 if "k_mid" in short else 2) * m["outer_steps_per_s"])
    else:
        assert m["steps_per_s"] == pytest.approx(64 * 4 / m["run_s"])
    for k in rates:
        assert 0.0 <= m[k] <= 1.0, k
    assert len(m["posterior_mean"]) == 16
    assert np.isfinite(m["posterior_mean"]).all()


def test_three_level_da_needs_the_middle_potential():
    p = dataclasses.replace(configs.build("burgers_da3_pcn", "cpu"),
                            batched_mid_fn=None)
    with pytest.raises(ValueError, match="batched_mid_fn"):
        runner.run_problem(p, "cpu", n_chains=64, n_samples=2)


def test_unfused_burgers_pcn_is_not_ported():
    """burgers_pcn runs the scan path on the single-particle Burgers forward
    (tests/test_torch_burgers_forward.py); without that potential, as before
    the forward was ported, only --fused runs it and anything else raises."""
    p = dataclasses.replace(configs.build("burgers_pcn", "cpu"), potential_fn=None)
    with pytest.raises(NotImplementedError, match="--fused"):
        runner.run_problem(p, "cpu", n_chains=64, n_samples=4)
    assert configs.build("burgers_pcn", "cpu").potential_fn is not None
