"""Constants carried across from the JAX package.

``darcy_misfit_from_arrays`` takes the arguments of
``ip_mcmc_tpu.models.darcy.make_batched_misfit`` as numpy arrays — an aux
dict (``scaled_basis``, ``obs_indices``, ``source``, ``n_grid``), the data
and the noise scale(s) — and returns the port's ``DarcyMisfit`` with the
same constants (``solver`` and ``omega`` too: K17's Richardson solve).
``darcy_warm_misfit_from_arrays`` does the same for
``make_batched_misfit_warm`` and returns, as that does, the pair
(``DarcyMisfitWarm``, ``aux_dim``); ``darcy_mala_warm_misfit_from_arrays``
for ``make_batched_misfit_mala_warm`` (``DarcyMisfitMalaWarm``,
``aux_dim`` = 2n²). All accept the JAX package's aux dict (array leaves
convert with ``np.asarray``) or ``models.darcy.darcy_aux``'s. The adjoint
gradient of ``differentiable=True`` is always there
(``DarcyMisfit.value_and_grad``), so there is no flag for it.

``burgers_misfit_from_arrays`` takes the arguments of
``ip_mcmc_tpu.models.burgers.make_batched_misfit`` — that package's aux dict
or ``models.burgers.burgers_aux``'s, the data and a scalar or
per-observation noise scale — and returns the port's ``BurgersMisfit``.

``linear_gaussian_from_arrays`` takes A (m, d), y (m,), a scalar or
per-row σ and an optional center c (d,) and returns the
``LinearGaussianPotential`` ½‖(y − A(U − c))/σ‖².

``vi_params_from_arrays`` takes fitted variational parameters of
``ip_mcmc_tpu.vi`` (an object with ``mu`` and ``log_sigma`` — mean-field —
or ``mu`` and ``chol_flat`` — full-rank — as arrays) and returns the port's
``vi.MeanFieldParams`` or ``vi.FullRankParams``.
"""

from __future__ import annotations

import numpy as np

import torch

from ip_mcmc_tpu_torch import vi
from ip_mcmc_tpu_torch.models.burgers import BurgersMisfit
from ip_mcmc_tpu_torch.models.linear import LinearGaussianPotential
from ip_mcmc_tpu_torch.models.darcy import (
    DarcyMisfit,
    DarcyMisfitMalaWarm,
    DarcyMisfitWarm,
)


def _from_arrays(cls, aux, data, noise_scale, cg_iters, precond,
                 precond_modes, log_a_mean, **solve):
    return cls(
        scaled_basis=np.asarray(aux["scaled_basis"], np.float32),
        obs_indices=np.asarray(aux["obs_indices"]),
        source=np.asarray(aux["source"], np.float32),
        data=np.asarray(data, np.float32),
        noise_scale=np.asarray(noise_scale, np.float32),
        n_grid=int(aux["n_grid"]),
        cg_iters=cg_iters,
        precond=precond,
        precond_modes=precond_modes,
        log_a_mean=log_a_mean,
        **solve,
    )


def darcy_misfit_from_arrays(aux, data, noise_scale, cg_iters: int = 48,
                             precond: str = "jacobi",
                             precond_modes: int = 128,
                             log_a_mean: float = 0.0, solver: str = "cg",
                             omega: float = 1.0) -> DarcyMisfit:
    return _from_arrays(DarcyMisfit, aux, data, noise_scale, cg_iters,
                        precond, precond_modes, log_a_mean, solver=solver,
                        omega=omega)


def darcy_warm_misfit_from_arrays(aux, data, noise_scale, cg_iters: int = 16,
                                  precond: str = "jacobi",
                                  precond_modes: int = 128,
                                  log_a_mean: float = 0.0):
    warm = _from_arrays(DarcyMisfitWarm, aux, data, noise_scale, cg_iters,
                        precond, precond_modes, log_a_mean)
    return warm, warm.aux_dim


def darcy_mala_warm_misfit_from_arrays(aux, data, noise_scale,
                                       cg_iters: int = 8,
                                       precond: str = "dst",
                                       precond_modes: int = 128,
                                       log_a_mean: float = 0.0):
    pag = _from_arrays(DarcyMisfitMalaWarm, aux, data, noise_scale, cg_iters,
                       precond, precond_modes, log_a_mean)
    return pag, pag.aux_dim


def burgers_misfit_from_arrays(aux, data, noise_scale) -> BurgersMisfit:
    return BurgersMisfit(
        scaled_basis=np.asarray(aux["scaled_basis"], np.float32),
        mean=np.asarray(aux["mean"], np.float32),
        obs_indices=np.asarray(aux["obs_indices"]),
        data=np.asarray(data, np.float32),
        noise_scale=np.asarray(noise_scale, np.float32),
        n_cells=int(aux["n_cells"]),
        dt=float(aux["dt"]),
        segment_steps=[int(s) for s in
                       aux.get("segment_steps", [aux["n_steps"]])],
    )


def linear_gaussian_from_arrays(A, data, noise_scale,
                                center=None) -> LinearGaussianPotential:
    return LinearGaussianPotential(
        np.asarray(A, np.float32), np.asarray(data, np.float32),
        np.asarray(noise_scale, np.float32),
        None if center is None else np.asarray(center, np.float32),
    )


def vi_params_from_arrays(params, device="cpu"):
    def t(x):
        return torch.tensor(np.asarray(x, np.float32), device=device)

    if hasattr(params, "log_sigma"):
        return vi.MeanFieldParams(mu=t(params.mu), log_sigma=t(params.log_sigma))
    return vi.FullRankParams(mu=t(params.mu), chol_flat=t(params.chol_flat))
