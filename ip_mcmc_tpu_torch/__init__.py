"""PyTorch + CUDA port of ``ip_mcmc_tpu`` for NVIDIA Hopper (H100).

The JAX package ``ip_mcmc_tpu`` stays the reference; this package mirrors
its layout (``models/darcy.py``, ``ops/``, ``configs/``, ``runner.py``,
``run.py``, ``diagnostics.py``) and runs the fused Darcy samplers on the
16×16 grid (delayed-acceptance pCN, the main path ``darcy_da_fused``;
cold and warm-started pCN; elliptical slice sampling) through
hand-written CUDA kernels (``csrc/``). Every kernel has a plain PyTorch version beside it; the
wrappers take the plain version only for tensors on the CPU. The scan path
(``kernels/``, ``driver.py``, ``adapt/``: RWM, pCN, delayed acceptance,
elliptical slice sampling, the ensemble sampler, MALA, HMC, parallel
tempering), tempered SMC (``smc.py``) and ADVI (``vi.py``) are plain
PyTorch over the chains.

Importing the package builds nothing: the CUDA sources are compiled at
the first kernel launch (``ops/_build.py``).
"""

from __future__ import annotations

import torch

# The plain versions are the references the kernels are held against on
# the card, so they run in true f32 (TF32 keeps ~3 decimal digits).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from ip_mcmc_tpu_torch._device import resolve_device  # noqa: E402
from ip_mcmc_tpu_torch.distributions import DiagGaussian  # noqa: E402

__all__ = ["DiagGaussian", "resolve_device"]
