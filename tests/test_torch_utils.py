"""The port's observability and debug helpers (``ip_mcmc_tpu_torch/utils``)
and the CLI flags that use them.

The seven cases of ``tests/test_tensorboard.py`` on the port's own copy of
the event writer and reader; the two debug cases of
``tests/test_observations_debug.py`` (a checked potential reports a
non-finite Φ; ``debug_mode`` restores the setting it changed); one
cross-check: the same records at the same wall times through JAX's
``TensorBoardWriter`` and the port's give identical bytes. Then the CLI on
the CPU (``gauss2d_rwm``, a few samples) with ``--metrics-log``,
``--tensorboard`` and ``--profile-dir``, and the records of the runner's
``_finalize`` against JAX's on the same metrics and acceptance trace (the
function alone: no JAX chain runs)."""

import contextlib
import glob
import io
import json
import os
import struct

import numpy as np
import pytest
import torch

from ip_mcmc_tpu_torch.utils import debug
from ip_mcmc_tpu_torch.utils import tensorboard as tb
from ip_mcmc_tpu_torch.utils.logging import MetricsLogger

torch.set_num_threads(1)


def test_crc32c_known_vectors():
    # canonical CRC32C test vectors (RFC 3720 appendix B.4)
    assert tb._crc32c(b"123456789") == 0xE3069283
    assert tb._crc32c(b"") == 0
    assert tb._crc32c(b"\x00" * 32) == 0x8A9136AA


def test_varint_roundtrip():
    for n in [0, 1, 127, 128, 300, 2**32, 2**63]:
        got, pos = tb._read_varint(tb._varint(n), 0)
        assert got == n and pos == len(tb._varint(n))


def test_writer_reader_roundtrip(tmp_path):
    with tb.TensorBoardWriter(str(tmp_path)) as w:
        w.scalar("accept_rate", 0.234, step=0)
        w.scalar("accept_rate", 0.240, step=1)
        w.scalars({"ess": 512.0, "rhat": 1.01}, step=1, wall_time=123.5)
        path = w.path
    events = tb.read_events(path)
    assert events[0][2] == {}  # the brain.Event:2 version stamp
    assert events[1][1] == 0
    assert abs(events[1][2]["accept_rate"] - 0.234) < 1e-6
    assert events[2][1] == 1
    assert abs(events[2][2]["accept_rate"] - 0.240) < 1e-6
    wall, step, scalars = events[3]
    assert (wall, step) == (123.5, 1)
    assert scalars["ess"] == 512.0
    assert abs(scalars["rhat"] - 1.01) < 1e-6


def test_reader_rejects_corruption(tmp_path):
    with tb.TensorBoardWriter(str(tmp_path)) as w:
        w.scalar("x", 1.0, step=0)
        path = w.path
    raw = bytearray(open(path, "rb").read())
    raw[-6] ^= 0xFF  # a payload byte of the last record
    open(path, "wb").write(bytes(raw))
    with pytest.raises(ValueError, match="crc"):
        tb.read_events(path)


def test_event_proto_shape():
    """Field 1 fixed64 (wall_time), field 2 varint (step), field 5
    length-delimited (summary): the subset TensorBoard's reader reads."""
    payload = tb._event(7.5, step=3, scalars={"a": 2.0})
    assert [(f, w) for f, w, _ in tb._fields(payload)] == [(1, 1), (2, 0), (5, 2)]
    wall, step, scalars = tb._parse_event(payload)
    assert (wall, step) == (7.5, 3)
    assert scalars == {"a": 2.0}
    _, _, s2 = tb._parse_event(tb._event(0.0, step=0, scalars={"b": -1.5}))
    assert s2 == {"b": -1.5}


def test_export_jsonl_from_metrics_logger(tmp_path):
    jsonl = tmp_path / "run.jsonl"
    logger = MetricsLogger(path=str(jsonl))
    logger.log({"event": "chunk", "step": 100, "accept_rate": 0.3,
                "min_ess": 40.5, "converged": True})
    logger.log({"event": "chunk", "step": 200, "accept_rate": 0.31, "min_ess": 81.0})
    logger.log({"event": "run_complete", "note": "no numerics here"})
    logger.close()
    events = tb.read_events(tb.export_jsonl(str(jsonl), str(tmp_path / "tb")))
    scalar_events = [e for e in events if e[2]]
    assert len(scalar_events) == 2  # the record without numbers gives none
    assert scalar_events[0][1] == 100
    assert abs(scalar_events[0][2]["accept_rate"] - 0.3) < 1e-6
    assert scalar_events[0][2]["min_ess"] == 40.5
    assert "converged" not in scalar_events[0][2]  # bools left out
    assert scalar_events[1][1] == 200
    assert scalar_events[0][0] >= 0.0


def test_record_framing_is_tfrecord(tmp_path):
    """len (uint64 LE) + masked_crc(len) + payload + masked_crc(payload)."""
    with tb.TensorBoardWriter(str(tmp_path)) as w:
        path = w.path
    raw = open(path, "rb").read()
    (length,) = struct.unpack("<Q", raw[:8])
    (hcrc,) = struct.unpack("<I", raw[8:12])
    assert hcrc == tb._masked_crc(raw[:8])
    payload = raw[12:12 + length]
    (pcrc,) = struct.unpack("<I", raw[12 + length:16 + length])
    assert pcrc == tb._masked_crc(payload)
    assert b"brain.Event:2" in payload


def test_writer_bytes_equal_the_jax_packages(tmp_path, monkeypatch):
    """The same records at the same wall times (the clock fixed) through
    the JAX package's writer and the port's: identical files."""
    from ip_mcmc_tpu.utils import tensorboard as jtb

    paths = []
    for mod, where in ((jtb, "jax"), (tb, "port")):
        monkeypatch.setattr(mod.time, "time", lambda: 1_700_000_000.25)
        with mod.TensorBoardWriter(str(tmp_path / where)) as w:
            w.scalar("accept_rate", 0.234, step=0)
            w.scalars({"ess": 512.0, "rhat": 1.01, "neg": -3.5}, step=7, wall_time=123.5)
            w.scalar("big", 1e30, step=2**40)
            paths.append(w.path)
    assert open(paths[0], "rb").read() == open(paths[1], "rb").read()


def test_checked_potential_reports_nonfinite():
    _, run = debug.checked_potential(lambda u: torch.log(u[0]))
    err, _ = run(torch.tensor([-1.0]))
    with pytest.raises(FloatingPointError, match="non-finite"):
        err.throw()
    err, val = run(torch.tensor([2.0]))
    err.throw()  # no error
    np.testing.assert_allclose(float(val), np.log(2.0), rtol=1e-6)
    checked, _ = debug.checked_potential(lambda u: torch.log(u[0]))
    with pytest.raises(FloatingPointError):
        checked(torch.tensor([-1.0]))


def test_debug_mode_restores_config():
    before = torch.is_anomaly_enabled()
    with debug.debug_mode(disable_jit=True):
        assert torch.is_anomaly_enabled() is True
    assert torch.is_anomaly_enabled() == before


# --- the CLI flags and the runner's records ---------------------------------------


def _cli(argv):
    from ip_mcmc_tpu_torch import run

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert run.main(argv) == 0
    lines = [ln for ln in buf.getvalue().splitlines() if ln.strip()]
    assert len(lines) == 1
    return json.loads(lines[0])


def test_cli_writes_the_log_the_events_and_the_trace(tmp_path):
    """gauss2d_rwm on the CPU with --tensorboard (its log synthesized as
    LOGDIR/metrics.jsonl) and --profile-dir: the log holds run_complete with
    the metrics' keys and the acceptance trace, the events read back as
    the records' numbers, the trace is a Chrome trace of the timed run. A
    second run on the same log exports only its own records."""
    logdir, prof = tmp_path / "tb", tmp_path / "prof"
    argv = ["--config", "gauss2d_rwm", "--device", "cpu", "--n-chains", "64",
            "--n-samples", "20", "--tensorboard", str(logdir)]
    metrics = _cli(argv + ["--profile-dir", str(prof)])
    records = [json.loads(ln) for ln in open(logdir / "metrics.jsonl")]
    assert records[0]["event"] == "run_complete"
    assert set(metrics) - {"setup_s", "cli_total_s", "tensorboard_events"} <= set(records[0])
    assert [r["step"] for r in records[1:]] == list(range(20))
    assert all(r["event"] == "accept_trace" for r in records[1:])
    events = tb.read_events(metrics["tensorboard_events"])
    assert events[1][2]["min_ess"] == pytest.approx(metrics["min_ess"], rel=1e-6)
    assert [e[2]["accept"] for e in events[2:]] == pytest.approx(
        [r["accept"] for r in records[1:]], rel=1e-6)
    (trace,) = glob.glob(str(prof / "*.json"))
    assert os.path.basename(trace) == "gauss2d_rwm_run.trace.json"
    names = {e.get("name") for e in json.load(open(trace))["traceEvents"]}
    assert "aten::randn" in names
    second = _cli(argv)
    assert second["tensorboard_events"] != metrics["tensorboard_events"]
    assert len(tb.read_events(second["tensorboard_events"])) == len(events)
    assert len(open(logdir / "metrics.jsonl").readlines()) == 2 * len(records)


def test_finalize_records_match_the_jax_runners(tmp_path):
    """The same metrics dict and acceptance trace (200 retained steps)
    through the JAX runner's _finalize and the port's: the same events, the
    same keys in each record, the same accept_trace steps and values."""
    from ip_mcmc_tpu import runner as jrunner

    from ip_mcmc_tpu_torch import runner

    rng = np.random.default_rng(3)
    metrics = {"config": "x", "kernel": "mala", "n_chains": 8, "run_s": 1.5, "warmup_s": 0.5,
               "min_ess": 40.0, "max_rhat": 1.3, "posterior_mean": [0.1, 0.2],
               "accept_rate": 0.6}
    acc = rng.uniform(size=200).astype(np.float32)
    jrunner._finalize(dict(metrics), str(tmp_path / "jax.jsonl"), 0.0, accept_trace=acc)
    runner._finalize(dict(metrics), 0.0, str(tmp_path / "port.jsonl"), torch.tensor(acc))
    jax_recs, port_recs = ([json.loads(ln) for ln in open(tmp_path / f)]
                           for f in ("jax.jsonl", "port.jsonl"))
    assert [r["event"] for r in jax_recs] == [r["event"] for r in port_recs]
    assert [sorted(r) for r in jax_recs] == [sorted(r) for r in port_recs]
    assert [r.get("step") for r in jax_recs] == [r.get("step") for r in port_recs]
    assert [r.get("accept") for r in jax_recs] == [r.get("accept") for r in port_recs]
    assert port_recs[0]["warning"] == jax_recs[0]["warning"]
