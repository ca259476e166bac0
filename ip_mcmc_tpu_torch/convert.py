"""Constants carried across from the JAX package.

``darcy_misfit_from_arrays`` takes the arguments of
``ip_mcmc_tpu.models.darcy.make_batched_misfit`` as numpy arrays — an aux
dict (``scaled_basis``, ``obs_indices``, ``source``, ``n_grid``), the data
and the noise scale(s) — and returns the port's ``DarcyMisfit`` with the
same constants. It accepts the JAX package's aux dict (array leaves
convert with ``np.asarray``) or ``models.darcy.darcy_aux``'s.
"""

from __future__ import annotations

import numpy as np

from ip_mcmc_tpu_torch.models.darcy import DarcyMisfit


def darcy_misfit_from_arrays(aux, data, noise_scale, cg_iters: int = 48,
                             precond: str = "jacobi",
                             precond_modes: int = 128,
                             log_a_mean: float = 0.0) -> DarcyMisfit:
    return DarcyMisfit(
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
    )
