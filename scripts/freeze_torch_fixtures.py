"""Freeze the JAX-drawn constants of ``darcy_da_fused`` for the PyTorch port.

The port never imports JAX, but four arrays of the config are drawn with
JAX threefry keys and cannot be recomputed without it: the true
coefficients ``u_true`` (key 300), the data ``y`` (forward solve plus the
noise draw under key 301), and the surrogate calibration — 64 prior draws
under key 402 give the bias-corrected surrogate data ``y_surr`` and the
inflated per-observation noise ``surr_scale``. They are written with the
coarse observation cells ``obs_coarse`` into
``ip_mcmc_tpu_torch/configs/darcy16_da.npz``. ``u_true`` and ``y`` are
those of ``_darcy_problem``, so the port's ``darcy_pcn_4096``,
``darcy_pcn_warm`` and ``darcy_ess_fused`` read the same file.

The arrays are read from the JAX package's own built Problem (its data,
its truth, and the closure of its single-particle surrogate misfit), so
nothing of the calibration is re-implemented here.

    JAX_PLATFORMS=cpu python scripts/freeze_torch_fixtures.py
"""

from __future__ import annotations

import pathlib
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
FIXTURE = ROOT / "ip_mcmc_tpu_torch" / "configs" / "darcy16_da.npz"


def _closure(fn):
    return {
        name: cell.cell_contents
        for name, cell in zip(fn.__code__.co_freevars, fn.__closure__)
    }


def fixture_arrays(problem) -> dict:
    """The frozen arrays, from a built JAX ``darcy_da_fused`` Problem."""
    surr = _closure(problem.surrogate_potential_fn)  # potentials.misfit_potential
    fwd_c = _closure(surr["forward_fn"])  # darcy.make_darcy_forward(n_grid=8)
    return {
        "u_true": np.asarray(problem.truth, np.float32),
        "y": np.asarray(problem.data, np.float32),
        "y_surr": np.asarray(surr["data"], np.float32),
        "surr_scale": np.asarray(surr["noise"].scale, np.float32),
        "obs_coarse": np.asarray(fwd_c["obs_indices"], np.int64),
    }


def main():
    sys.path.insert(0, str(ROOT))
    import jax

    jax.config.update("jax_platforms", "cpu")
    from ip_mcmc_tpu import configs

    arrays = fixture_arrays(configs.build("darcy_da_fused"))
    np.savez(FIXTURE, **arrays)
    print(f"wrote {FIXTURE} ({FIXTURE.stat().st_size} bytes)")


if __name__ == "__main__":
    main()
