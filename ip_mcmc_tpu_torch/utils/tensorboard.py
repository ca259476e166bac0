"""TensorBoard exporter (the port's own copy of ``ip_mcmc_tpu/utils/tensorboard.py``,
which imports no JAX; the port imports nothing of the JAX package).

Writes standard ``events.out.tfevents.*`` files that TensorBoard's scalar
dashboard reads — with no dependency: the TFRecord framing (CRC32C-
masked length + payload) and the tiny ``Event``/``Summary`` protobuf subset
are encoded by hand, because neither ``tensorboard`` nor ``tensorboardX``
is in the deployment image.

Wire format (stable since TF 1.x, what every TB reader parses):

- record  = uint64 length (LE) · masked_crc32c(length) · payload
            · masked_crc32c(payload)
- payload = Event proto: wall_time (1, double), step (2, int64), and ONE of
  file_version (3, string — first record, "brain.Event:2") or summary
  (5, message). Summary = repeated Value (1); Value = tag (1, string),
  simple_value (2, float).

Use ``TensorBoardWriter`` directly, or ``export_jsonl`` to convert a
``MetricsLogger`` JSONL file (``--metrics-log``) after a run:

    python -m ip_mcmc_tpu_torch.utils.tensorboard run.jsonl tb/run1
"""

from __future__ import annotations

import json
import os
import socket
import struct
import time

# CRC32C (Castagnoli, reflected poly 0x82F63B78) — table-driven, pure Python.
_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ (0x82F63B78 if _c & 1 else 0)
    _TABLE.append(_c)


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    out = b""
    while True:
        b7 = n & 0x7F
        n >>= 7
        if n:
            out += bytes([b7 | 0x80])
        else:
            return out + bytes([b7])


def _key(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _pb_double(field: int, v: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", v)


def _pb_float(field: int, v: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", v)


def _pb_varint(field: int, v: int) -> bytes:
    return _key(field, 0) + _varint(v & 0xFFFFFFFFFFFFFFFF)


def _pb_bytes(field: int, v: bytes) -> bytes:
    return _key(field, 2) + _varint(len(v)) + v


def _event(wall_time: float, step: int | None = None,
           file_version: str | None = None,
           scalars: dict | None = None) -> bytes:
    msg = _pb_double(1, wall_time)
    if step is not None:
        msg += _pb_varint(2, step)
    if file_version is not None:
        msg += _pb_bytes(3, file_version.encode())
    if scalars:
        summary = b"".join(
            _pb_bytes(
                1,
                _pb_bytes(1, tag.encode()) + _pb_float(2, float(val)),
            )
            for tag, val in scalars.items()
        )
        msg += _pb_bytes(5, summary)
    return msg


class TensorBoardWriter:
    """Minimal scalar-only event-file writer, TB-dashboard compatible."""

    _uid = 0  # per-process monotonic suffix (see below)

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        # pid + per-process counter in the name (as TF's writers do): two
        # writers in the same second for the same logdir must not collide
        TensorBoardWriter._uid += 1
        fname = "events.out.tfevents.%010d.%s.%d.%d" % (
            int(time.time()), socket.gethostname(), os.getpid(),
            TensorBoardWriter._uid,
        )
        self.path = os.path.join(logdir, fname)
        self._fh = open(self.path, "xb")  # fail loudly on collision
        self._write(_event(time.time(), file_version="brain.Event:2"))

    def _write(self, payload: bytes):
        header = struct.pack("<Q", len(payload))
        self._fh.write(header)
        self._fh.write(struct.pack("<I", _masked_crc(header)))
        self._fh.write(payload)
        self._fh.write(struct.pack("<I", _masked_crc(payload)))
        self._fh.flush()

    def scalar(self, tag: str, value: float, step: int,
               wall_time: float | None = None):
        self.scalars({tag: value}, step, wall_time)

    def scalars(self, tag_to_value: dict, step: int,
                wall_time: float | None = None):
        """One event carrying several scalar summaries (one TB point each)."""
        self._write(_event(
            time.time() if wall_time is None else wall_time,
            step=int(step), scalars=tag_to_value,
        ))

    def close(self):
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_events(path: str):
    """Parse an event file back into [(wall_time, step, {tag: value})] —
    the verification half (used by tests; also handy for quick greps of a
    run without TensorBoard). Validates both CRCs of every record."""
    out = []
    with open(path, "rb") as fh:
        data = fh.read()
    pos = 0
    while pos < len(data):
        header = data[pos:pos + 8]
        (length,) = struct.unpack("<Q", header)
        (hcrc,) = struct.unpack("<I", data[pos + 8:pos + 12])
        if hcrc != _masked_crc(header):
            raise ValueError(f"bad header crc at byte {pos}")
        payload = data[pos + 12:pos + 12 + length]
        (pcrc,) = struct.unpack(
            "<I", data[pos + 12 + length:pos + 16 + length]
        )
        if pcrc != _masked_crc(payload):
            raise ValueError(f"bad payload crc at byte {pos}")
        pos += 16 + length
        out.append(_parse_event(payload))
    return out


def _read_varint(buf: bytes, pos: int):
    n = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n, pos
        shift += 7


def _fields(buf: bytes):
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            val, pos = _read_varint(buf, pos)
        elif wire == 1:
            val, pos = buf[pos:pos + 8], pos + 8
        elif wire == 5:
            val, pos = buf[pos:pos + 4], pos + 4
        elif wire == 2:
            ln, pos = _read_varint(buf, pos)
            val, pos = buf[pos:pos + ln], pos + ln
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def _parse_event(payload: bytes):
    wall_time, step, scalars = 0.0, 0, {}
    for field, wire, val in _fields(payload):
        if field == 1 and wire == 1:
            (wall_time,) = struct.unpack("<d", val)
        elif field == 2 and wire == 0:
            step = val
        elif field == 5 and wire == 2:
            for f2, w2, v2 in _fields(val):
                if f2 == 1 and w2 == 2:  # Summary.Value
                    tag = sv = None
                    for f3, w3, v3 in _fields(v2):
                        if f3 == 1 and w3 == 2:
                            tag = v3.decode()
                        elif f3 == 2 and w3 == 5:
                            (sv,) = struct.unpack("<f", v3)
                    if tag is not None and sv is not None:
                        scalars[tag] = sv
    return wall_time, step, scalars


def export_jsonl(jsonl_path: str, logdir: str, step_key: str = "step",
                 start_offset: int = 0):
    """Convert a MetricsLogger JSONL file to a TB event file: every numeric
    field of every record becomes a scalar; the step is the record's
    ``step_key`` if present, else its index. Returns the event-file path.

    ``start_offset``: skip bytes already in the file before this run
    started — MetricsLogger appends, so re-exporting an existing log would
    otherwise duplicate stale records from prior runs. Event wall_time is
    the record's absolute ``t_epoch`` when present, else the export
    time."""
    with TensorBoardWriter(logdir) as w:
        with open(jsonl_path) as fh:
            fh.seek(start_offset)
            for i, line in enumerate(fh):
                line = line.strip()
                if not line:
                    continue
                rec = json.loads(line)
                step = int(rec.get(step_key, i))
                wall = rec.get("t_epoch")  # None → writer uses time.time()
                scalars = {
                    k: v for k, v in rec.items()
                    if isinstance(v, (int, float))
                    and not isinstance(v, bool)
                    and k not in (step_key, "t", "t_epoch")
                }
                if scalars:
                    w.scalars(scalars, step, wall_time=wall)
        return w.path


if __name__ == "__main__":
    import sys

    if len(sys.argv) != 3:
        sys.exit("usage: python -m ip_mcmc_tpu_torch.utils.tensorboard "
                 "<metrics.jsonl> <logdir>")
    print(export_jsonl(sys.argv[1], sys.argv[2]))
