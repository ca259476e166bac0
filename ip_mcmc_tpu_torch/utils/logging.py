"""Structured observability (mirrors ``ip_mcmc_tpu/utils/logging.py``):
JSON-lines metric records and named profiler regions.

``MetricsLogger`` writes one JSON object a record (the runner's
``run_complete`` summary and its ``accept_trace`` records), each stamped
with ``t`` (seconds since the logger was made) and ``t_epoch`` (the wall
clock, which ``utils/tensorboard.py`` uses as the event's wall time).
``profile_region`` names a region in ``torch.profiler`` traces
(``record_function``), optionally tracing it into a directory."""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time


class MetricsLogger:
    """JSON-lines logger: one dict per record, flushed immediately. With
    ``path`` it appends to that file, else it writes to ``stream``
    (default stderr)."""

    def __init__(self, stream=None, path=None):
        if path is not None:
            self._fh = open(path, "a", buffering=1)
            self._own = True
        else:
            self._fh = stream or sys.stderr
            self._own = False
        self._t0 = time.time()

    def log(self, record: dict, **kw):
        now = time.time()
        rec = {
            "t": round(now - self._t0, 3),
            "t_epoch": round(now, 3),
            **record,
            **kw,
        }
        self._fh.write(json.dumps(rec, default=float) + "\n")

    def close(self):
        if self._own:
            self._fh.close()


@contextlib.contextmanager
def profile_region(name: str, profile: bool = False, profile_dir: str = "ipx_trace"):
    """``torch.profiler.record_function(name)`` around a region; with
    ``profile`` the region is also traced (host and, where there is one,
    the card) and exported as the Chrome trace
    ``{profile_dir}/{name}.trace.json``."""
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile, record_function

    if not profile:
        with record_function(name):
            yield
        return
    os.makedirs(profile_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with torch_profile(activities=activities) as prof:
        with record_function(name):
            yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(profile_dir, f"{name}.trace.json"))
