"""Debug mode and checked potentials (mirrors ``ip_mcmc_tpu/utils/debug.py``).

- ``debug_mode()``: a context that turns on autograd's anomaly detection
  (``torch.autograd.set_detect_anomaly``: a backward pass that makes a NaN
  fails at the operation that made it, with the forward's traceback) and
  restores the previous setting on exit. ``disable_jit`` is accepted for
  the JAX package's signature and has no effect: PyTorch runs eagerly.
- ``checked_potential``: wraps a potential so that a non-finite Φ is
  reported where it happened instead of the chain rejecting forever.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def debug_mode(disable_jit=False):
    del disable_jit  # PyTorch runs eagerly: nothing to disable
    before = torch.is_anomaly_enabled()
    torch.autograd.set_detect_anomaly(True)
    try:
        yield
    finally:
        torch.autograd.set_detect_anomaly(before)


class CheckError:
    """The outcome of a checked call: ``throw()`` raises ``FloatingPointError``
    if Φ was not finite (JAX's ``checkify`` error), else does nothing."""

    def __init__(self, message=None):
        self.message = message

    def get(self):
        return self.message

    def throw(self):
        if self.message is not None:
            raise FloatingPointError(self.message)


def checked_potential(potential_fn):
    """Return (checked_fn, run):

    - ``run(u) -> (err, phi)``: the potential and a ``CheckError`` that
      holds the non-finite values if any (``err.throw()`` when convenient);
    - ``checked_fn(u) -> phi``: calls ``run`` and raises at once on a
      non-finite Φ."""

    def run(u):
        phi = potential_fn(u)
        bad = ~torch.isfinite(phi)
        if bool(bad.any()):
            return CheckError(f"potential returned non-finite value {phi[bad].tolist()}"), phi
        return CheckError(), phi

    def checked_fn(u):
        err, phi = run(u)
        err.throw()
        return phi

    return checked_fn, run
