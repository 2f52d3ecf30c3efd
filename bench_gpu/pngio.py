"""The benchmark's own PNG writer and reader (8-bit RGB, not interlaced).

The writer stores every row with filter type 0 (None); the reader takes
only such rows, which is what the program's writer and this one produce,
and refuses the rest rather than guess.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + kind + payload
            + struct.pack(">I", zlib.crc32(kind + payload)))


def encode(image: np.ndarray, level: int = 1) -> bytes:
    """uint8 (H, W, 3) -> PNG bytes."""
    image = np.ascontiguousarray(image, np.uint8)
    if image.ndim != 3 or image.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3) uint8, got {image.shape}")
    h, w, _ = image.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), image.reshape(h, -1)],
                          axis=1)
    return (SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
            + _chunk(b"IEND", b""))


def write(path, image: np.ndarray, level: int = 1) -> None:
    with open(path, "wb") as f:
        f.write(encode(image, level))


def decode(data: bytes) -> np.ndarray:
    """PNG bytes -> uint8 (H, W, 3) (an alpha channel is dropped)."""
    if not data.startswith(SIGNATURE):
        raise ValueError("not a PNG")
    pos, header, idat = len(SIGNATURE), None, []
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, payload = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif kind == b"IDAT":
            idat.append(payload)
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, colour, _, _, interlace = header
    channels = {2: 3, 6: 4}.get(colour)
    if depth != 8 or channels is None or interlace:
        raise ValueError(f"unsupported PNG {header}")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw.reshape(h, 1 + w * channels)
    if np.any(raw[:, 0] != 0):
        raise ValueError("PNG rows with a filter other than 0 not read here")
    return np.ascontiguousarray(
        raw[:, 1:].reshape(h, w, channels)[..., :3])
