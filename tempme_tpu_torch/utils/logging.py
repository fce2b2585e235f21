"""Structured metrics logging: JSONL + TensorBoard-compatible event files.

The port's copy of ``tempme_tpu/utils/logging.py`` (framework-free). The
reference logs via torch.utils.tensorboard SummaryWriter with timestamped
run dirs ``{base}_{data}_{ts}[_explainer]`` (temp_exp_main.py:64-92). We write
the same scalar-tag layout with a dependency-free TFRecord/Event encoder, plus
a JSONL mirror for programmatic consumption.
"""
from __future__ import annotations

import json
import os
import os.path as osp
import struct
import time
from typing import Optional

# ---------------------------------------------------------------------------
# minimal TF event-file encoding (TFRecord framing + Event/Summary protos)
# ---------------------------------------------------------------------------

_CRC_TABLE = []


def _crc32c_table():
    global _CRC_TABLE
    if _CRC_TABLE:
        return _CRC_TABLE
    poly = 0x82F63B78
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        table.append(c)
    _CRC_TABLE = table
    return table


def _crc32c(data: bytes) -> int:
    table = _crc32c_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    out = b""
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out += bytes([b | 0x80])
        else:
            out += bytes([b])
            return out


def _field(tag: int, wire: int) -> bytes:
    return _varint((tag << 3) | wire)


def _encode_scalar_event(tag: str, value: float, step: int,
                         wall_time: float) -> bytes:
    # Summary.Value { tag=1 (string), simple_value=2 (float) }
    tag_b = tag.encode()
    val = (_field(1, 2) + _varint(len(tag_b)) + tag_b
           + _field(2, 5) + struct.pack("<f", float(value)))
    # Summary { value=1 (repeated message) }
    summary = _field(1, 2) + _varint(len(val)) + val
    # Event { wall_time=1 (double), step=2 (int64), summary=5 (message) }
    ev = (_field(1, 1) + struct.pack("<d", wall_time)
          + _field(2, 0) + _varint(step & 0xFFFFFFFFFFFFFFFF)
          + _field(5, 2) + _varint(len(summary)) + summary)
    return ev


def _tfrecord(payload: bytes) -> bytes:
    header = struct.pack("<Q", len(payload))
    return (header + struct.pack("<I", _masked_crc(header))
            + payload + struct.pack("<I", _masked_crc(payload)))


class MetricsLogger:
    """Scalar logger: ``add_scalar(tag, value, step)`` like SummaryWriter."""

    def __init__(self, log_dir: str, run_name: Optional[str] = None,
                 tensorboard: bool = True, jsonl: bool = True):
        if run_name is None:
            run_name = time.strftime("run_%Y%m%d_%H%M%S")
        self.dir = osp.join(log_dir, run_name)
        os.makedirs(self.dir, exist_ok=True)
        self._tb = None
        self._jsonl = None
        if tensorboard:
            fname = f"events.out.tfevents.{int(time.time())}.tempme"
            self._tb = open(osp.join(self.dir, fname), "ab")
            self._write_event(_encode_scalar_event("_start", 0.0, 0,
                                                   time.time()))
        if jsonl:
            self._jsonl = open(osp.join(self.dir, "metrics.jsonl"), "a")

    def _write_event(self, ev: bytes):
        if self._tb:
            self._tb.write(_tfrecord(ev))

    def add_scalar(self, tag: str, value: float, step: int):
        now = time.time()
        self._write_event(_encode_scalar_event(tag, value, step, now))
        if self._jsonl:
            self._jsonl.write(json.dumps(
                {"tag": tag, "value": float(value), "step": int(step),
                 "time": now}) + "\n")

    def add_scalars(self, prefix: str, values: dict, step: int):
        for k, v in values.items():
            self.add_scalar(f"{prefix}/{k}", v, step)

    def flush(self):
        if self._tb:
            self._tb.flush()
        if self._jsonl:
            self._jsonl.flush()

    def close(self):
        self.flush()
        if self._tb:
            self._tb.close()
        if self._jsonl:
            self._jsonl.close()
