"""An animated GIF writer (GIF89a) of the port's own: no Pillow.

Frames are quantized to one fixed 256-entry palette of 3-3-2 bits (red and
green in 8 levels, blue in 4), each channel to its nearest level, and
LZW-compressed as the format asks (variable code width from 9 to 12 bits,
a clear code when the table is full). The file loops forever (a
NETSCAPE2.0 application block) and shows each frame for `delay_cs`
hundredths of a second.
"""

from __future__ import annotations

import struct

import numpy as np

# The palette's levels per channel: red and green 3 bits, blue 2 bits.
LEVELS = (8, 8, 4)
_MIN_CODE_SIZE = 8  # 256 palette indices


def palette() -> np.ndarray:
    """(256, 3) uint8: entry (r << 5) | (g << 2) | b holds the levels r, g
    (of 7) and b (of 3) scaled to 0..255."""
    i = np.arange(256)
    parts = ((i >> 5) & 7, (i >> 2) & 7, i & 3)
    return np.stack([np.round(p * 255.0 / (n - 1)) for p, n in
                     zip(parts, LEVELS)], axis=1).astype(np.uint8)


def quantize(frame: np.ndarray) -> np.ndarray:
    """uint8 (H, W, 3) -> (H, W) palette indices, each channel to its
    nearest level."""
    f = frame.astype(np.float32)
    r, g, b = (np.round(f[..., k] * (n - 1) / 255.0).astype(np.uint8)
               for k, n in enumerate(LEVELS))
    return (r << 5) | (g << 2) | b


def lzw_encode(indices: bytes, min_code_size: int = _MIN_CODE_SIZE
               ) -> bytes:
    """GIF's LZW of a frame's palette indices: codes packed least
    significant bit first, starting with a clear code and ending with the
    end-of-information code."""
    clear = 1 << min_code_size
    end = clear + 1
    out = bytearray()
    acc = nbits = 0
    width = min_code_size + 1

    def emit(code: int) -> None:
        nonlocal acc, nbits
        acc |= code << nbits
        nbits += width
        while nbits >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nbits -= 8

    emit(clear)
    table = {}
    next_code = end + 1
    prefix = indices[0]
    for byte in indices[1:]:
        key = (prefix << 8) | byte
        code = table.get(key)
        if code is not None:
            prefix = code
            continue
        emit(prefix)
        if next_code < 4096:
            table[key] = next_code
            next_code += 1
            # The decoder adds this entry one code later, and widens once
            # its table reaches the next power of two.
            if next_code > (1 << width) and width < 12:
                width += 1
        else:
            emit(clear)
            table.clear()
            next_code = end + 1
            width = min_code_size + 1
        prefix = byte
    emit(prefix)
    emit(end)
    if nbits:
        out.append(acc & 0xFF)
    return bytes(out)


def _sub_blocks(data: bytes) -> bytes:
    """Data as the format's sub-blocks of at most 255 bytes, terminated."""
    blocks = [bytes([len(data[i:i + 255])]) + data[i:i + 255]
              for i in range(0, len(data), 255)]
    return b"".join(blocks) + b"\x00"


def write_gif(path: str, frames, delay_cs: int) -> None:
    """Write uint8 (H, W, 3) frames, all of one size, as a looping GIF89a
    with `delay_cs` hundredths of a second per frame."""
    frames = [np.ascontiguousarray(f, np.uint8) for f in frames]
    if not frames:
        raise ValueError("write_gif needs at least one frame")
    height, width = frames[0].shape[:2]
    for f in frames:
        if f.shape != (height, width, 3):
            raise ValueError(f"frames must all be ({height}, {width}, 3) "
                             f"uint8, got {f.shape}")
    delay = int(delay_cs)
    if not 0 <= delay <= 0xFFFF:
        raise ValueError(f"delay {delay} cs out of range")
    parts = [b"GIF89a",
             # Logical screen: a global table of 2^(7 + 1) colours of 8 bits.
             struct.pack("<HHBBB", width, height, 0xF7, 0, 0),
             palette().tobytes(),
             # Loop forever.
             b"\x21\xFF\x0BNETSCAPE2.0\x03\x01" + struct.pack("<H", 0)
             + b"\x00"]
    for f in frames:
        parts += [
            # Graphic control: disposal 1 (leave in place), the delay.
            b"\x21\xF9\x04\x04" + struct.pack("<H", delay) + b"\x00\x00",
            # The image: the whole screen, the global table.
            b"\x2C" + struct.pack("<HHHHB", 0, 0, width, height, 0),
            bytes([_MIN_CODE_SIZE]),
            _sub_blocks(lzw_encode(quantize(f).tobytes()))]
    parts.append(b"\x3B")
    with open(path, "wb") as out:
        out.write(b"".join(parts))


def gif_info(path: str) -> dict:
    """The structure of a file write_gif wrote, without decoding the
    pixels: {"size": (w, h), "frames": n, "delays_cs": [...], "loop":
    count or None}. Walks the blocks; raises on anything else."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:6] != b"GIF89a":
        raise ValueError(f"'{path}' is not a GIF89a file")
    w, h, flags = struct.unpack("<HHB", data[6:11])
    pos = 13 + (3 << ((flags & 7) + 1) if flags & 0x80 else 0)
    out = {"size": (w, h), "frames": 0, "delays_cs": [], "loop": None}

    def skip_blocks(p):
        while data[p]:
            p += data[p] + 1
        return p + 1

    while True:
        kind = data[pos]
        if kind == 0x3B:
            return out
        if kind == 0x21:
            label, size = data[pos + 1], data[pos + 2]
            body = data[pos + 3:pos + 3 + size]
            if label == 0xF9:
                out["delays_cs"].append(struct.unpack("<H", body[1:3])[0])
            if label == 0xFF and body == b"NETSCAPE2.0":
                sub = pos + 3 + size
                out["loop"] = struct.unpack("<H", data[sub + 2:sub + 4])[0]
            pos = skip_blocks(pos + 3 + size)
        elif kind == 0x2C:
            local = data[pos + 9]
            pos += 10 + (3 << ((local & 7) + 1) if local & 0x80 else 0)
            out["frames"] += 1
            pos = skip_blocks(pos + 1)  # past the LZW minimum code size
        else:
            raise ValueError(f"'{path}': unexpected block 0x{kind:02x} at "
                             f"{pos}")
