"""Metric logging: JSON lines to stdout and `<workdir>/metrics.jsonl`, and
TensorBoard scalars under `<workdir>/tb`.

Port of `cpc_tpu/train/metrics.py::MetricWriter`. One record per call:
step, wall time, prefix ("train" | "val") and the metrics, arrays as lists.
TensorBoard gets the JAX package's tags: `{prefix}/{key}` for a scalar and
`{prefix}/{key}_{i+1}` for entry i of a vector (the per-k accuracy `acc`).
Under data parallelism only rank 0 has a writer with a workdir and an
echo.

The event file is written here, so that training needs no `tensorboard`
package: TFRecord framing (length, masked CRC-32C
of the length, payload, masked CRC-32C of the payload) around `Event`
protobufs encoded by hand (`wall_time`, `step`, `file_version`, `summary`
of `Value{tag, simple_value}`). Every record is flushed; a failed write
raises.
"""

from __future__ import annotations

import json
import os
import socket
import struct
import time
from typing import Dict, Optional

import numpy as np
import torch


def _scalarize(v):
    if isinstance(v, torch.Tensor):
        v = v.detach().float().cpu().numpy()
    a = np.asarray(v)
    if a.ndim == 0:
        return float(a)
    return [float(x) for x in a.ravel()]


def _crc32c_table():
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC32C = _crc32c_table()


def crc32c(data: bytes) -> int:
    c = 0xFFFFFFFF
    for b in data:
        c = _CRC32C[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field_bytes(number: int, payload: bytes) -> bytes:
    """A length-delimited protobuf field (wire type 2)."""
    return _varint(number << 3 | 2) + _varint(len(payload)) + payload


def _event(wall_time: float, step: int = 0, *, file_version: str = "",
           scalars: Optional[Dict[str, float]] = None) -> bytes:
    """An `Event` protobuf: wall_time (1, double), step (2, int64),
    file_version (3, string), summary (5, `Summary`: value (1) repeated
    `Value{tag (1), simple_value (2, float)}`)."""
    out = _varint(1 << 3 | 1) + struct.pack("<d", wall_time)
    if step:
        out += _varint(2 << 3) + _varint(step)
    if file_version:
        out += _field_bytes(3, file_version.encode())
    if scalars:
        values = b"".join(
            _field_bytes(1, _field_bytes(1, tag.encode())
                         + _varint(2 << 3 | 5) + struct.pack("<f", value))
            for tag, value in scalars.items())
        out += _field_bytes(5, values)
    return out


class EventFileWriter:
    """Scalars into one TensorBoard event file under `log_dir`."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        name = (f"events.out.tfevents.{int(time.time())}."
                f"{socket.gethostname()}.{os.getpid()}")
        self.path = os.path.join(log_dir, name)
        self._f = open(self.path, "wb")
        self._record(_event(time.time(), file_version="brain.Event:2"))

    def _record(self, payload: bytes) -> None:
        head = struct.pack("<Q", len(payload))
        self._f.write(head + struct.pack("<I", masked_crc32c(head)) + payload
                      + struct.pack("<I", masked_crc32c(payload)))
        self._f.flush()

    def write_scalars(self, step: int, scalars: Dict[str, float]) -> None:
        self._record(_event(time.time(), step, scalars=scalars))

    def close(self) -> None:
        self._f.close()


class MetricWriter:
    def __init__(self, workdir: Optional[str] = None, echo: bool = True):
        self.echo = echo
        self._jsonl = None
        self._tb = None
        if workdir:
            os.makedirs(workdir, exist_ok=True)
            self._jsonl = open(os.path.join(workdir, "metrics.jsonl"), "a",
                               buffering=1)
            self._tb = EventFileWriter(os.path.join(workdir, "tb"))

    def write(self, step: int, metrics: Dict, prefix: str = "train") -> None:
        values = {k: _scalarize(v) for k, v in metrics.items()}
        rec = {"step": step, "time": time.time(), "prefix": prefix, **values}
        line = json.dumps(rec)
        if self.echo:
            print(line, flush=True)
        if self._jsonl:
            self._jsonl.write(line + "\n")
        if self._tb:
            flat = {}
            for k, v in values.items():
                if isinstance(v, list):
                    flat.update({f"{prefix}/{k}_{i + 1}": x
                                 for i, x in enumerate(v)})
                else:
                    flat[f"{prefix}/{k}"] = v
            self._tb.write_scalars(step, flat)

    def close(self) -> None:
        if self._jsonl:
            self._jsonl.close()
            self._jsonl = None
        if self._tb:
            self._tb.close()
            self._tb = None
