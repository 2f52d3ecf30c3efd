"""Gamma / SVBRDF / unit-interval codecs on channels-last tensors.

Counterpart of svbrdf_tpu/ops/codecs.py: an SVBRDF is (..., H, W, 12) with
channels [normals(3) | diffuse(3) | roughness(3) | specular(3)] on the last
axis.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

GAMMA = 2.2

NORMALS = slice(0, 3)
DIFFUSE = slice(3, 6)
ROUGHNESS = slice(6, 9)
SPECULAR = slice(9, 12)


class SvbrdfMaps(NamedTuple):
    """Unpacked SVBRDF maps; each (..., H, W, 3)."""

    normals: torch.Tensor
    diffuse: torch.Tensor
    roughness: torch.Tensor
    specular: torch.Tensor


def gamma_decode(images: torch.Tensor) -> torch.Tensor:
    """sRGB-ish -> linear."""
    return torch.pow(images, GAMMA)


def gamma_encode(images: torch.Tensor) -> torch.Tensor:
    """Linear -> sRGB-ish."""
    return torch.pow(images, 1.0 / GAMMA)


def pack_svbrdf(normals, diffuse, roughness, specular) -> torch.Tensor:
    """Concatenate maps on the channel (last) axis."""
    return torch.cat([normals, diffuse, roughness, specular], dim=-1)


def unpack_svbrdf(svbrdf: torch.Tensor, is_encoded: bool = False) -> SvbrdfMaps:
    """Split a packed SVBRDF into maps.

    is_encoded=False: 12 channels -> (3, 3, 3, 3).
    is_encoded=True : 9 channels [nx ny | d(3) | r(1) | s(3)].
    """
    if not is_encoded:
        return SvbrdfMaps(svbrdf[..., NORMALS], svbrdf[..., DIFFUSE],
                          svbrdf[..., ROUGHNESS], svbrdf[..., SPECULAR])
    return SvbrdfMaps(svbrdf[..., 0:2], svbrdf[..., 2:5], svbrdf[..., 5:6],
                      svbrdf[..., 6:9])


def decode_svbrdf(svbrdf9: torch.Tensor) -> torch.Tensor:
    """9-channel network output -> 12-channel SVBRDF.

    normals: (nx, ny) scaled by 3, z = 1, renormalized; roughness replicated
    to 3 channels. Channels assumed in [-1, 1].
    """
    nxy, diffuse, roughness, specular = unpack_svbrdf(svbrdf9, is_encoded=True)
    roughness = roughness.repeat_interleave(3, dim=-1)
    normals = torch.cat([nxy * 3.0, torch.ones_like(nxy[..., :1])], dim=-1)
    norm = torch.sqrt(torch.sum(torch.square(normals), dim=-1, keepdim=True))
    return pack_svbrdf(normals / norm, diffuse, roughness, specular)


def encode_svbrdf(svbrdf: torch.Tensor) -> torch.Tensor:
    """Packed (..., 12) SVBRDF in output ranges -> the 9 channels in
    [-1, 1] that models/single_view.decode_head maps back: normal (x, y)
    over 3 z (z clamped at 1e-3), the roughness channels' mean, and
    diffuse, roughness and specular remapped [0, 1] -> [-1, 1]; every
    channel clamped to [-1, 1] (the normal to tilts within atan 3)."""
    maps = unpack_svbrdf(svbrdf)
    n = maps.normals
    nxy = n[..., :2] / torch.clamp(3.0 * n[..., 2:3], min=1e-3)
    rough = maps.roughness.mean(dim=-1, keepdim=True)
    x9 = torch.cat([nxy, decode_from_unit_interval(maps.diffuse),
                    decode_from_unit_interval(rough),
                    decode_from_unit_interval(maps.specular)], dim=-1)
    return torch.clamp(x9, -1.0, 1.0)


def encode_as_unit_interval(x: torch.Tensor) -> torch.Tensor:
    """[-1, 1] -> [0, 1]."""
    return (x + 1.0) / 2.0


def decode_from_unit_interval(x: torch.Tensor) -> torch.Tensor:
    """[0, 1] -> [-1, 1]."""
    return x * 2.0 - 1.0


def crop_square(images: torch.Tensor, anchor, size: int) -> torch.Tensor:
    """Crop a size x size window at (row, col) anchor from (..., H, W, C)."""
    row, col = int(anchor[0]), int(anchor[1])
    height, width = images.shape[-3], images.shape[-2]
    # lax.dynamic_slice clamps the start so the window stays inside.
    row = min(max(row, 0), height - size)
    col = min(max(col, 0), width - size)
    return images[..., row:row + size, col:col + size, :]
