"""Minimal, dependency-free TensorBoard scalar event writer and reader.

Counterpart of svbrdf_tpu/training/tensorboard.py (pure Python, copied: the
port imports nothing of the JAX package). TFRecord framing (length + masked
CRC-32C) and the Event/Summary protos are hand-encoded, scalars only, which
is all the trainer logs (`loss`, `val_loss`). Files are readable by
standard TensorBoard.
"""

from __future__ import annotations

import os
import socket
import struct
import time


def _crc32c_table():
    poly = 0x82F63B78
    table = []
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ (poly & -(crc & 1))
        table.append(crc)
    return table


_TABLE = _crc32c_table()


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return ((crc >> 15 | crc << 17) + 0xA282EAD8) & 0xFFFFFFFF


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


def _field_double(num: int, value: float) -> bytes:
    return _varint(num << 3 | 1) + struct.pack("<d", value)


def _field_float(num: int, value: float) -> bytes:
    return _varint(num << 3 | 5) + struct.pack("<f", value)


def _field_varint(num: int, value: int) -> bytes:
    return _varint(num << 3 | 0) + _varint(value)


def _field_bytes(num: int, payload: bytes) -> bytes:
    return _varint(num << 3 | 2) + _varint(len(payload)) + payload


def _scalar_event(tag: str, value: float, step: int,
                  wall_time: float) -> bytes:
    # Summary.Value{ tag=1, simple_value=2 }
    value_msg = _field_bytes(1, tag.encode()) + _field_float(2, value)
    # Summary{ value=1 }
    summary = _field_bytes(1, value_msg)
    # Event{ wall_time=1, step=2, summary=5 }
    return (_field_double(1, wall_time) + _field_varint(2, step)
            + _field_bytes(5, summary))


def _version_event(wall_time: float) -> bytes:
    # Event{ wall_time=1, file_version=3 }
    return _field_double(1, wall_time) + _field_bytes(3, b"brain.Event:2")


def _read_varint(buf: bytes, i: int):
    shift, out = 0, 0
    while True:
        b = buf[i]
        i += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, i
        shift += 7


def _walk_fields(buf: bytes):
    """Yield (field_number, wire_type, value) over one protobuf message."""
    i = 0
    while i < len(buf):
        key, i = _read_varint(buf, i)
        num, wt = key >> 3, key & 7
        if wt == 0:
            val, i = _read_varint(buf, i)
        elif wt == 1:
            val = buf[i:i + 8]
            i += 8
        elif wt == 5:
            val = buf[i:i + 4]
            i += 4
        elif wt == 2:
            ln, i = _read_varint(buf, i)
            val = buf[i:i + ln]
            i += ln
        else:  # groups unused in Event protos
            raise ValueError(f"unsupported wire type {wt}")
        yield num, wt, val


def read_scalars(path: str):
    """Read scalar series back from an events file or log dir.

    Returns {tag: [(step, value), ...]} — the counterpart of SummaryWriter
    (the reference analyzed its training speed from TensorBoard scalar
    exports the same way, website.ipynb cell 21).
    """
    if os.path.isdir(path):
        files = sorted(
            os.path.join(path, f) for f in os.listdir(path)
            if f.startswith("events.out.tfevents."))
    else:
        files = [path]
    series: dict = {}
    for fname in files:
        with open(fname, "rb") as f:
            data = f.read()
        i = 0
        while i + 12 <= len(data):
            (length,) = struct.unpack_from("<Q", data, i)
            if i + 12 + length + 4 > len(data):
                break  # truncated tail (live writer mid-flush): keep prefix
            payload = data[i + 12:i + 12 + length]
            i += 12 + length + 4
            step = 0
            summary = None
            for num, wt, val in _walk_fields(payload):
                if num == 2 and wt == 0:
                    step = val
                elif num == 5 and wt == 2:
                    summary = val
            if summary is None:
                continue
            for num, wt, val in _walk_fields(summary):
                if num != 1 or wt != 2:
                    continue
                tag, simple = None, None
                for n2, w2, v2 in _walk_fields(val):
                    if n2 == 1 and w2 == 2:
                        tag = v2.decode()
                    elif n2 == 2 and w2 == 5:
                        (simple,) = struct.unpack("<f", v2)
                if tag is not None and simple is not None:
                    series.setdefault(tag, []).append((step, simple))
    return series


class SummaryWriter:
    """Append-only scalar writer, TensorBoard-compatible."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        ts = time.time()
        fname = f"events.out.tfevents.{int(ts)}.{socket.gethostname()}"
        self._path = os.path.join(log_dir, fname)
        self._f = open(self._path, "ab")
        self._write_record(_version_event(ts))

    def _write_record(self, payload: bytes) -> None:
        header = struct.pack("<Q", len(payload))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", _masked_crc(payload)))
        self._f.flush()

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._write_record(
            _scalar_event(tag, float(value), int(step), time.time()))

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
