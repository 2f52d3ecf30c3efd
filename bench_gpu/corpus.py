"""Seeded inputs: maps-only training strips and flash photos, as PNG files.

A material is a set of smooth random fields: a height field whose
gradient gives the normal map, a diffuse albedo around a random colour, a
grey GGX roughness in [0.1, 0.9] and a grey specular albedo in [0.02,
0.35]. A strip is [normals | diffuse | roughness | specular], each map
size x size, stored as bytes (normals as (n + 1) / 2). Every seed gives
the same sizes; only the content differs.
"""

from __future__ import annotations

import pathlib

import numpy as np
import torch

from bench_gpu import pngio


def _field(rng, size: int, cells: int) -> np.ndarray:
    """A smooth field in [0, 1]: a random (cells + 1)^2 grid, bilinear
    over size x size."""
    grid = rng.random((cells + 1, cells + 1))
    t = np.linspace(0.0, cells, size, endpoint=False)
    i = np.minimum(t.astype(int), cells - 1)
    f = t - i
    rows = grid[i] * (1 - f)[:, None] + grid[i + 1] * f[:, None]
    return rows[:, i] * (1 - f)[None, :] + rows[:, i + 1] * f[None, :]


def material(rng, size: int) -> np.ndarray:
    """(size, 4 * size, 3) uint8 strip of one material."""
    height = 0.6 * _field(rng, size, 8) + 0.4 * _field(rng, size, 32)
    gy, gx = np.gradient(height * rng.uniform(0.5, 3.0))
    n = np.stack([-gx * size / 32, gy * size / 32, np.ones_like(gx)], -1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    base = rng.uniform(0.05, 0.9, 3)
    diffuse = np.clip(base * (0.6 + 0.8 * _field(rng, size, 16))[..., None],
                      0.0, 1.0)
    rough = 0.1 + 0.8 * _field(rng, size, 4)
    spec = 0.02 + 0.33 * _field(rng, size, 4)
    maps = [(n + 1.0) / 2.0, diffuse, np.repeat(rough[..., None], 3, -1),
            np.repeat(spec[..., None], 3, -1)]
    strip = np.concatenate(maps, axis=1)
    return np.clip(np.round(strip * 255.0), 0, 255).astype(np.uint8)


def strips_to_maps(strips: np.ndarray) -> np.ndarray:
    """(N, size, 4 size, 3) strips -> (N, size, size, 12) map bytes."""
    n, size = strips.shape[:2]
    return np.ascontiguousarray(
        strips.reshape(n, size, 4, size, 3).transpose(0, 1, 3, 2, 4)
        .reshape(n, size, size, 12))


def write_strips(directory, count: int, size: int, seed: int) -> np.ndarray:
    """`count` strips as <directory>/strip_NNNN.png; returns the strips'
    bytes (count, size, 4 size, 3), in file order."""
    rng = np.random.default_rng(seed)
    directory = pathlib.Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    strips = np.stack([material(rng, size) for _ in range(count)])
    for k, strip in enumerate(strips):
        pngio.write(directory / f"strip_{k:04d}.png", strip)
    return strips


def write_photos(directory, count: int, size: int, seed: int,
                 device) -> list:
    """`count` flash photos of seeded materials, sRGB bytes (gamma 2.2),
    as <directory>/photo_NNNN.png; returns [(path, uint8 (size, size,
    3))]."""
    from bench_gpu.reference import maps as ref

    rng = np.random.default_rng(seed)
    mats = strips_to_maps(np.stack([material(rng, size)
                                    for _ in range(count)]))
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        sv = ref.decode_u8_svbrdf(torch.from_numpy(mats).to(device))
        scenes = ref.input_scenes(count, 1, gen, device)
        linear = ref.render(scenes, sv[:, None])[:, 0]
        srgb = torch.clamp(linear, 0.0, 1.0) ** (1.0 / ref.GAMMA)
        photos = torch.round(srgb * 255.0).to(torch.uint8).cpu().numpy()
    directory = pathlib.Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    out = []
    for k, photo in enumerate(photos):
        path = directory / f"photo_{k:04d}.png"
        pngio.write(path, photo)
        out.append((str(path), photo))
    return out
