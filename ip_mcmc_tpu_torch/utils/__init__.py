"""Observability and debugging helpers of the port (mirrors
``ip_mcmc_tpu/utils/``): ``logging`` (JSON-lines metric records and named
profiler regions), ``tensorboard`` (a scalar event-file writer and reader
that need no package) and ``debug`` (anomaly detection and a checked
potential). The JAX package's ``utils/struct.py`` makes pytrees of
dataclasses; the port's states are plain dataclasses and need none."""
