"""Host-side decoding of packed SVBRDF sample strips.

Counterpart of svbrdf_tpu/data/strips.py. Each PNG is a horizontal strip of
`input_image_count` photographs followed by 4 maps [normals | diffuse |
roughness | specular], each W = H tiles (a 3584 x 256 file = 10 photos + 4
maps). This module does host I/O and layout only; the math (gamma, mixing,
synthesis) runs on the device in data/pipeline.py. PNG goes through the
port's own reader and writer (data/png.py): no Pillow.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np

from svbrdf_tpu_torch.data import png


def list_sample_files(data_directory: str) -> List[str]:
    """All regular files in the directory (symlinks to files included),
    sorted for determinism."""
    return sorted(
        os.path.join(data_directory, f)
        for f in os.listdir(data_directory)
        if os.path.isfile(os.path.join(data_directory, f))
    )


def read_image_u8(path: str) -> np.ndarray:
    """PNG -> uint8 HWC RGB; RGBA is truncated to RGB. Any other file or
    PNG kind raises a ValueError naming the file."""
    return png.read_png_rgb8(path)


def read_image(path: str) -> np.ndarray:
    """PNG -> float32 HWC in [0, 1]; RGBA is truncated to RGB."""
    return read_image_u8(path).astype(np.float32) / 255.0


def write_image(path: str, image: np.ndarray) -> None:
    """float HWC [0, 1] -> 8-bit RGB PNG (values truncated to bytes)."""
    png.write_png_rgb8(path, np.uint8(np.clip(image, 0.0, 1.0) * 255.0))


def decode_strip(strip: np.ndarray, input_image_count: int,
                 no_svbrdf: bool = False
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Split a strip into (inputs (N, H, w, 3), svbrdf (H, w, 12)).

    Normals are remapped [0,1] -> [-1,1]; other maps stay in [0,1]; input
    photos stay as stored (gamma decode happens on the device). With
    no_svbrdf=True the strip holds only photographs and a dummy flat SVBRDF
    (normal (0, 0, 1), zero maps) is returned.
    """
    n_parts = input_image_count + (0 if no_svbrdf else 4)
    h, total_w = strip.shape[:2]
    w = total_w // n_parts
    parts = [strip[:, i * w:(i + 1) * w, :] for i in range(n_parts)]

    inputs = (np.stack(parts[:input_image_count], axis=0)
              if input_image_count > 0
              else np.zeros((0, h, w, 3), np.float32))

    if no_svbrdf:
        normals = np.concatenate(
            [np.zeros((h, w, 2), np.float32), np.ones((h, w, 1), np.float32)],
            axis=-1)
        zeros = np.zeros((h, w, 3), np.float32)
        svbrdf = np.concatenate([normals, zeros, zeros, zeros], axis=-1)
    else:
        normals = parts[input_image_count + 0] * 2.0 - 1.0
        svbrdf = np.concatenate(
            [normals] + parts[input_image_count + 1: input_image_count + 4],
            axis=-1)

    return inputs.astype(np.float32), svbrdf.astype(np.float32)


def decode_strip_u8(strip_u8: np.ndarray, input_image_count: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Split a uint8 strip without numeric decoding.

    Returns (inputs (N, H, w, 3) uint8, svbrdf (H, w, 12) uint8) where the
    svbrdf channels are the stored bytes: /255 and the normals' [0,1] ->
    [-1,1] remap happen on the device (data/pipeline.prepare_batch), so a
    quarter of the bytes cross to the card.
    """
    n_parts = input_image_count + 4
    h, total_w = strip_u8.shape[:2]
    w = total_w // n_parts
    parts = [strip_u8[:, i * w:(i + 1) * w, :] for i in range(n_parts)]
    inputs = (np.stack(parts[:input_image_count], axis=0)
              if input_image_count > 0
              else np.zeros((0, h, w, 3), np.uint8))
    svbrdf = np.concatenate(parts[input_image_count:], axis=-1)
    return inputs, svbrdf


def decode_sample(strip: np.ndarray, input_image_count: int,
                  used_input_image_count: int, no_svbrdf: bool = False
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Decode a loaded strip; keep only the LAST min(input, used) photos
    (last, not first, as the PyTorch reference's dataset does)."""
    inputs, svbrdf = decode_strip(strip, input_image_count, no_svbrdf)
    n_read = min(input_image_count, used_input_image_count)
    lo = input_image_count - n_read
    return inputs[lo:input_image_count], svbrdf


def load_sample(path: str, input_image_count: int,
                used_input_image_count: int, no_svbrdf: bool = False
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Read + decode a strip file (see decode_sample)."""
    return decode_sample(read_image(path), input_image_count,
                         used_input_image_count, no_svbrdf)
