"""PNG reading and writing on stdlib zlib and numpy.

The port reads its sample strips without Pillow or libpng. The reader takes
8-bit RGB and RGBA (truncated to RGB), not interlaced, with any of the five
scanline filters; anything else raises a ValueError that names the file.
The writer writes 8-bit RGB with filter type 0 on every row.

Unfiltering: None, Sub and Up rows are vectorized along the row (Sub as a
cumulative sum per byte lane, mod 256). Average and Paeth need the decoded
left neighbour, so a run of such rows is decoded by anti-diagonals: byte
(r, x) depends only on (r, x-1), (r-1, x) and (r-1, x-1), so every pixel on
one diagonal r + x = t is decoded in one numpy step, with each row's filter
picked by a mask.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {2: 3, 6: 4}  # colour type -> samples per pixel (RGB, RGBA)


def _chunks(data: bytes, path: str):
    """Yield (type, payload) of each chunk, checking lengths and CRCs."""
    i = len(SIGNATURE)
    while i + 8 <= len(data):
        length, kind = struct.unpack_from(">I4s", data, i)
        end = i + 8 + length
        if end + 4 > len(data):
            raise ValueError(f"'{path}': truncated PNG chunk {kind!r}")
        payload = data[i + 8:end]
        (crc,) = struct.unpack_from(">I", data, end)
        if zlib.crc32(kind + payload) != crc:
            raise ValueError(f"'{path}': bad CRC in PNG chunk {kind!r}")
        yield kind, payload
        if kind == b"IEND":
            return
        i = end + 4
    raise ValueError(f"'{path}': PNG ends without an IEND chunk")


def _paeth(a, b, c):
    """The Paeth predictor of int16 arrays: a left, b up, c up-left."""
    pa = np.abs(b - c)
    pb = np.abs(a - c)
    pc = np.abs(a + b - 2 * c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter_diagonal(raw: np.ndarray, prev: np.ndarray,
                       average: np.ndarray) -> np.ndarray:
    """Decode R consecutive Average/Paeth rows (raw (R, W, bpp) uint8)
    below the decoded row `prev` (W, bpp); average (R,) marks the Average
    rows. Works in a skewed layout s[c, k] = pixel (k - 1, c - k - 1) of
    the run (k = 0 is `prev`, x = -1 is the zero left border), where
    diagonal c is one contiguous slice and its left, up and up-left
    neighbours lie on diagonals c - 1, c - 1 and c - 2."""
    rows, width, bpp = raw.shape
    ncols = width + rows + 1
    s = np.zeros((ncols, rows + 1, bpp), np.int16)
    r = np.zeros((ncols, rows + 1, bpp), np.int16)
    s[1:width + 1, 0] = prev
    for k in range(1, rows + 1):
        r[k + 1:k + 1 + width, k] = raw[k - 1]
    avg = average[:, None] if average.any() else None
    for c in range(2, ncols):
        lo, hi = max(1, c - width), min(rows, c - 1)
        left = s[c - 1, lo:hi + 1]
        up = s[c - 1, lo - 1:hi]
        up_left = s[c - 2, lo - 1:hi]
        pred = _paeth(left, up, up_left)
        if avg is not None:
            pred = np.where(avg[lo - 1:hi], (left + up) >> 1, pred)
        s[c, lo:hi + 1] = (r[c, lo:hi + 1] + pred) & 0xFF
    out = np.empty((rows, width, bpp), np.uint8)
    for k in range(1, rows + 1):
        out[k - 1] = s[k + 1:k + 1 + width, k]
    return out


def _unfilter(filters: np.ndarray, raw: np.ndarray, path: str) -> np.ndarray:
    """Undo the scanline filters: filters (H,) uint8, raw (H, W, bpp)."""
    if filters.size and filters.max() > 4:
        raise ValueError(f"'{path}': unknown PNG filter type "
                         f"{int(filters.max())}")
    height, width, bpp = raw.shape
    out = np.empty_like(raw)
    prev = np.zeros((width, bpp), np.uint8)
    r = 0
    while r < height:
        f = filters[r]
        if f >= 3:  # a run of Average / Paeth rows, decoded by diagonals
            end = r
            while end < height and filters[end] >= 3:
                end += 1
            out[r:end] = _unfilter_diagonal(raw[r:end], prev,
                                            filters[r:end] == 3)
            r = end
        else:
            if f == 0:
                out[r] = raw[r]
            elif f == 1:
                out[r] = np.cumsum(raw[r], axis=0, dtype=np.uint8)
            else:
                out[r] = raw[r] + prev
            r += 1
        prev = out[r - 1]
    return out


def read_png_rgb8(path: str) -> np.ndarray:
    """8-bit RGB or RGBA PNG -> uint8 (H, W, 3); alpha is dropped."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(SIGNATURE):
        raise ValueError(f"'{path}' is not a PNG file")
    header, idat = None, []
    for kind, payload in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif kind == b"IDAT":
            idat.append(payload)
    if header is None:
        raise ValueError(f"'{path}': PNG has no IHDR chunk")
    width, height, depth, colour, _comp, _filt, interlace = header
    if depth != 8 or colour not in _CHANNELS or interlace != 0:
        raise ValueError(
            f"'{path}': unsupported PNG (bit depth {depth}, colour type "
            f"{colour}, interlace {interlace}); only 8-bit RGB or RGBA, "
            f"not interlaced, is read")
    bpp = _CHANNELS[colour]
    stream = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if stream.size != height * (1 + width * bpp):
        raise ValueError(f"'{path}': PNG image data has {stream.size} "
                         f"bytes, expected {height * (1 + width * bpp)}")
    rows = stream.reshape(height, 1 + width * bpp)
    pixels = _unfilter(rows[:, 0], rows[:, 1:].reshape(height, width, bpp),
                       path)
    return np.ascontiguousarray(pixels[..., :3])


def write_png_rgb8(path: str, image: np.ndarray) -> None:
    """uint8 (H, W, 3) -> 8-bit RGB PNG, filter type 0 on every row."""
    image = np.ascontiguousarray(image, np.uint8)
    if image.ndim != 3 or image.shape[2] != 3:
        raise ValueError(f"write_png_rgb8 takes (H, W, 3) uint8, got "
                         f"{image.shape}")
    height, width, _ = image.shape
    rows = np.concatenate(
        [np.zeros((height, 1), np.uint8), image.reshape(height, -1)], axis=1)

    def chunk(kind: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload)))

    with open(path, "wb") as f:
        f.write(SIGNATURE
                + chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, 8, 2,
                                             0, 0, 0))
                + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                + chunk(b"IEND", b""))
