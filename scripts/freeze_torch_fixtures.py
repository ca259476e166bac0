"""Freeze the JAX-drawn constants of the ported configs for the PyTorch port.

The port never imports JAX, but some arrays of the configs are drawn with
JAX threefry keys and cannot be recomputed without it.

``darcy_da_fused``: the true
coefficients ``u_true`` (key 300), the data ``y`` (forward solve plus the
noise draw under key 301), and the surrogate calibration — 64 prior draws
under key 402 give the bias-corrected surrogate data ``y_surr`` and the
inflated per-observation noise ``surr_scale``. They are written with the
coarse observation cells ``obs_coarse`` into
``ip_mcmc_tpu_torch/configs/darcy16_da.npz``. ``u_true`` and ``y`` are
those of ``_darcy_problem``, so the port's ``darcy_pcn_4096``,
``darcy_pcn_warm`` and ``darcy_ess_fused`` read the same file.

The Burgers configs (``burgers_pcn``, ``burgers_da_pcn``,
``burgers_da3_pcn``, ``burgers_multitime_pcn``): ``u_true`` (key 400), the
final-time data ``y`` (noise key 401) shared by the first three, the
three-time data ``y_multitime`` (noise key 402), and the two calibrated
surrogates of ``burgers_da3_pcn`` — 64 cells (``y_surr_64``, ``scale_64``;
also the surrogate of ``burgers_da_pcn``) and 128 cells at the coarse time
step (``y_surr_128``, ``scale_128``) — into
``ip_mcmc_tpu_torch/configs/burgers128.npz``.

``lingauss_pcn``: the true coefficients ``u_true`` (the prior draw under
key 100) and the data ``y`` (A u_true plus the noise draw under key 101)
into ``ip_mcmc_tpu_torch/configs/lingauss32.npz``.

``darcy32_pcn_warm`` / ``darcy64_pcn_warm``: ``u_true`` (keys 310 / 500)
and ``y`` (the single-particle forward plus the noise draw under keys 311 /
501) into ``darcy32.npz`` / ``darcy64.npz``.

``darcy64_da_fused``: as ``darcy_da_fused``'s, the arrays of the 64×64
problem (``u_true`` and ``y`` under keys 500 / 501, those of
``darcy64.npz``) and of its 32×32 surrogate, calibrated by 32 prior draws
under key 402 through the single-particle forwards (dense ``dst``, 24 CG
at 64², 3 at 32²): ``y_surr``, ``surr_scale`` and ``obs_coarse`` into
``darcy64_da.npz``.

``ode_mala`` / ``ode_hmc`` (``_lv_problem``): the true log-rates
``theta_true`` and the data ``y`` (the RK4 forward plus the noise draw
under key 200) into ``lv.npz``.

The Richardson DA runs of ``benchmarks/darcy_da_richardson.py``
(``configs.darcy_da_richardson``): the NumPy oracle's ``u_true`` and ``y``
(``default_rng(7)``, noise 0.002) and, for each 8×8 surrogate of
``RICHARDSON_VARIANTS``, its calibration (64 prior draws under key 402
through the single-particle forward with the surrogate's own solver):
``y_surr_<variant>`` and ``scale_<variant>`` into
``darcy16_richardson.npz``.

``darcy_da_pod`` / ``darcy_da_pod_online``: the prior draws of their POD
snapshots, drawn as ``models/darcy.py`` ``make_pod_surrogate`` and
``make_pod_surrogate_online`` draw them from ``jax.random.key(777)`` (64 × 64
from the second half of its split; 24 × 64 from the key itself):
``draws`` and ``draws_online`` into ``darcy16_pod.npz``.

The arrays are read from the JAX package's own built Problems (their data,
their truth, and the closures of their surrogate misfits), so nothing of
the calibrations is re-implemented here; ``lingauss_pcn``'s truth is the
exact posterior mean, so its ``u_true`` is drawn again by the config's own
call. With no argument every file is written; a kind writes its own.

    JAX_PLATFORMS=cpu python scripts/freeze_torch_fixtures.py \
        [darcy|burgers|lingauss|darcy32|darcy64|darcy64_da|richardson|lv|pod]
"""

from __future__ import annotations

import pathlib
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
FIXTURE = ROOT / "ip_mcmc_tpu_torch" / "configs" / "darcy16_da.npz"
BURGERS_FIXTURE = ROOT / "ip_mcmc_tpu_torch" / "configs" / "burgers128.npz"
LINGAUSS_FIXTURE = ROOT / "ip_mcmc_tpu_torch" / "configs" / "lingauss32.npz"
LARGE_GRID = {  # kind -> (JAX config, fixture)
    "darcy32": ("darcy32_pcn_warm", ROOT / "ip_mcmc_tpu_torch" / "configs" / "darcy32.npz"),
    "darcy64": ("darcy64_pcn_warm", ROOT / "ip_mcmc_tpu_torch" / "configs" / "darcy64.npz"),
}
RICHARDSON_FIXTURE = ROOT / "ip_mcmc_tpu_torch" / "configs" / "darcy16_richardson.npz"
LV_FIXTURE = ROOT / "ip_mcmc_tpu_torch" / "configs" / "lv.npz"
POD_FIXTURE = ROOT / "ip_mcmc_tpu_torch" / "configs" / "darcy16_pod.npz"
DA_FIXTURES = {  # kind -> (JAX config, fixture)
    "darcy": ("darcy_da_fused", FIXTURE),
    "darcy64_da": ("darcy64_da_fused",
                   ROOT / "ip_mcmc_tpu_torch" / "configs" / "darcy64_da.npz"),
}


def _closure(fn):
    return {
        name: cell.cell_contents
        for name, cell in zip(fn.__code__.co_freevars, fn.__closure__)
    }


def fixture_arrays(problem) -> dict:
    """The frozen arrays, from a built JAX ``darcy_da_fused`` or
    ``darcy64_da_fused`` Problem."""
    surr = _closure(problem.surrogate_potential_fn)  # potentials.misfit_potential
    fwd_c = _closure(surr["forward_fn"])  # darcy.make_darcy_forward (the coarse grid)
    return {
        "u_true": np.asarray(problem.truth, np.float32),
        "y": np.asarray(problem.data, np.float32),
        "y_surr": np.asarray(surr["data"], np.float32),
        "surr_scale": np.asarray(surr["noise"].scale, np.float32),
        "obs_coarse": np.asarray(fwd_c["obs_indices"], np.int64),
    }


def burgers_fixture_arrays(da3, multitime) -> dict:
    """The frozen arrays, from built JAX ``burgers_da3_pcn`` and
    ``burgers_multitime_pcn`` Problems."""
    coarse = _closure(da3.surrogate_potential_fn)  # potentials.misfit_potential
    mid = _closure(da3.batched_mid_fn)  # burgers.make_batched_misfit's phi
    return {
        "u_true": np.asarray(da3.truth, np.float32),
        "y": np.asarray(da3.data, np.float32),
        "y_multitime": np.asarray(multitime.data, np.float32),
        "y_surr_64": np.asarray(coarse["data"], np.float32),
        "scale_64": np.asarray(coarse["noise"].scale, np.float32),
        "y_surr_128": np.asarray(mid["data"], np.float32),
        "scale_128": np.asarray(mid["noise_scale"], np.float32).reshape(-1),
    }


def lingauss_fixture_arrays(problem) -> dict:
    """The frozen arrays, from a built JAX ``lingauss_pcn`` Problem: its
    data, and ``u_true`` drawn again as the config draws it."""
    import jax

    return {
        "u_true": np.asarray(problem.prior.sample(jax.random.key(100)), np.float32),
        "y": np.asarray(problem.data, np.float32),
    }


def truth_and_data(problem) -> dict:
    """``u_true`` and ``y`` of a built JAX Problem."""
    return {"u_true": np.asarray(problem.truth, np.float32),
            "y": np.asarray(problem.data, np.float32)}


def lv_fixture_arrays(problem) -> dict:
    """``theta_true`` and ``y`` of a built JAX ``ode_mala`` Problem."""
    return {"theta_true": np.asarray(problem.truth, np.float32),
            "y": np.asarray(problem.data, np.float32)}


def richardson_fixture_arrays() -> dict:
    """The oracle's truth and data and each surrogate's calibration, as
    ``benchmarks/darcy_da_richardson.py`` builds them."""
    import jax.numpy as jnp

    from benchmarks.oracle_darcy import OracleDarcyPCN
    from ip_mcmc_tpu import distributions
    from ip_mcmc_tpu.configs import _darcy_coarse_surrogate
    from ip_mcmc_tpu_torch.configs import RICHARDSON_VARIANTS, richardson_fixture_key

    oracle = OracleDarcyPCN()
    rng = np.random.default_rng(7)
    u_true = rng.standard_normal(oracle.K)
    y = oracle.forward(u_true) + 0.002 * rng.standard_normal(len(oracle.obs))
    yj = jnp.asarray(y, jnp.float32)
    prior = distributions.DiagGaussian(mean=jnp.zeros(64), scale=jnp.ones(64))
    out = {"u_true": np.asarray(u_true, np.float32), "y": np.asarray(yj)}
    for variant, (solver, iters, omega) in RICHARDSON_VARIANTS.items():
        _, phi_surr = _darcy_coarse_surrogate(
            prior, yj, cg_iters=iters, precond="dst_trunc", solver=solver,
            omega=omega, return_unfused=True)
        surr = _closure(phi_surr)  # potentials.misfit_potential
        key = richardson_fixture_key(variant)
        out[f"y_surr_{key}"] = np.asarray(surr["data"], np.float32)
        out[f"scale_{key}"] = np.asarray(surr["noise"].scale, np.float32)
    return out


def pod_fixture_arrays() -> dict:
    """The snapshot draws of the two POD configs (K = 64, unit prior
    scale), as their JAX builders draw them."""
    import jax

    key = jax.random.key(777)
    _, key0 = jax.random.split(key)
    return {"draws": np.asarray(jax.random.normal(key0, (64, 64)), np.float32),
            "draws_online": np.asarray(jax.random.normal(key, (24, 64)), np.float32)}


def main(argv=None):
    kinds = {*DA_FIXTURES, "burgers", "lingauss", *LARGE_GRID, "richardson", "lv", "pod"}
    which = set(argv or sys.argv[1:]) or kinds
    if not which <= kinds:
        raise SystemExit(f"usage: {sys.argv[0]} [{'|'.join(sorted(kinds))}]")
    sys.path.insert(0, str(ROOT))
    import jax

    jax.config.update("jax_platforms", "cpu")
    from ip_mcmc_tpu import configs

    written = []
    for kind, (config, path) in DA_FIXTURES.items():
        if kind in which:
            np.savez(path, **fixture_arrays(configs.build(config)))
            written.append(path)
    if "burgers" in which:
        np.savez(BURGERS_FIXTURE, **burgers_fixture_arrays(
            configs.build("burgers_da3_pcn"),
            configs.build("burgers_multitime_pcn")))
        written.append(BURGERS_FIXTURE)
    if "lingauss" in which:
        np.savez(LINGAUSS_FIXTURE,
                 **lingauss_fixture_arrays(configs.build("lingauss_pcn")))
        written.append(LINGAUSS_FIXTURE)
    for kind, (config, path) in LARGE_GRID.items():
        if kind in which:
            np.savez(path, **truth_and_data(configs.build(config)))
            written.append(path)
    if "richardson" in which:
        np.savez(RICHARDSON_FIXTURE, **richardson_fixture_arrays())
        written.append(RICHARDSON_FIXTURE)
    if "lv" in which:
        np.savez(LV_FIXTURE, **lv_fixture_arrays(configs.build("ode_mala")))
        written.append(LV_FIXTURE)
    if "pod" in which:
        np.savez(POD_FIXTURE, **pod_fixture_arrays())
        written.append(POD_FIXTURE)
    for path in written:
        print(f"wrote {path} ({path.stat().st_size} bytes)")


if __name__ == "__main__":
    main()
