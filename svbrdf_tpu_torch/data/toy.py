"""Procedural toy dataset: self-contained sample strips for smoke runs.

Counterpart of svbrdf_tpu/data/toy.py. Random smooth height fields give
the normals, layered colour / checker patterns give diffuse, roughness and
specular, and the input "photographs" are rendered from those maps with
the renderer the training loss uses (ops/render), so the toy photos are
physically consistent with their ground-truth maps.

Strip layout as the reference format:
[input_0 .. input_{n-1} | normals | diffuse | roughness | specular],
normals stored remapped to [0, 1], photos stored gamma-encoded, written
with the port's PNG writer (data/png.py).

The maps are numpy, call for call the JAX package's, so the same seed gives
the same maps to the bit. The photo scenes are drawn from a torch.Generator
seeded with the strip's seed (torch cannot reproduce jax.random's stream),
and rendered on `device` (render_photos takes any scenes, so the same
scenes give the same photos in both packages).

Run: ``python -m svbrdf_tpu_torch.data.toy ./data [--device cpu]`` (writes
data/train and data/test).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from svbrdf_tpu_torch.data import pipeline, strips
from svbrdf_tpu_torch.device import resolve_device
from svbrdf_tpu_torch.ops import codecs, render
from svbrdf_tpu_torch.scene import Scene


def _smooth_noise(rng: np.random.Generator, size: int, octaves: int = 4
                  ) -> np.ndarray:
    """Multi-octave value noise in [0, 1] via bilinear-upsampled grids."""
    out = np.zeros((size, size), np.float32)
    amp_total = 0.0
    for o in range(octaves):
        cells = max(2, 2 ** (o + 1))
        if cells > size:
            break
        grid = rng.uniform(0.0, 1.0, (cells + 1, cells + 1))
        # Bilinear upsample the coarse grid to size x size.
        t = np.linspace(0.0, cells, size, endpoint=False)
        i0 = np.floor(t).astype(int)
        f = (t - i0).astype(np.float32)
        g = (grid[i0][:, i0] * (1 - f)[:, None] * (1 - f)[None, :]
             + grid[i0 + 1][:, i0] * f[:, None] * (1 - f)[None, :]
             + grid[i0][:, i0 + 1] * (1 - f)[:, None] * f[None, :]
             + grid[i0 + 1][:, i0 + 1] * f[:, None] * f[None, :])
        amp = 0.5 ** o
        out += amp * g.astype(np.float32)
        amp_total += amp
    return out / amp_total


def _checker(size: int, tiles: int) -> np.ndarray:
    idx = (np.arange(size) * tiles // size)
    return ((idx[:, None] + idx[None, :]) % 2).astype(np.float32)


def make_toy_svbrdf(rng: np.random.Generator, size: int) -> np.ndarray:
    """One procedural SVBRDF (H, W, 12): packed [normals(-1..1), diffuse,
    roughness, specular], all maps in the renderer's conventions."""
    # Normals from the gradient of a smooth height field plus sine bumps.
    height = _smooth_noise(rng, size) * rng.uniform(0.5, 2.0)
    fx, fy = rng.uniform(2, 6, 2)
    xs = np.linspace(0, 2 * np.pi, size, dtype=np.float32)
    height = height + 0.15 * np.outer(np.sin(fy * xs), np.cos(fx * xs))
    gy, gx = np.gradient(height.astype(np.float32))
    scale = size / 16.0  # slope scale: gradients are per-pixel
    n = np.stack([-gx * scale, -gy * scale, np.ones_like(gx)], axis=-1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)

    base = rng.uniform(0.1, 0.9, 3).astype(np.float32)
    accent = rng.uniform(0.1, 0.9, 3).astype(np.float32)
    mask = (_checker(size, int(rng.integers(2, 9)))
            if rng.uniform() < 0.5 else _smooth_noise(rng, size))
    diffuse = (base[None, None] * mask[..., None]
               + accent[None, None] * (1.0 - mask[..., None]))

    rough = (0.15 + 0.7 * _smooth_noise(rng, size))[..., None]
    roughness = np.repeat(rough, 3, axis=-1)

    spec_level = rng.uniform(0.04, 0.6)
    specular = np.full((size, size, 3), spec_level, np.float32)
    specular *= (0.5 + 0.5 * mask[..., None])

    return np.concatenate(
        [n, diffuse, roughness, specular], axis=-1).astype(np.float32)


def render_photos(svbrdf: np.ndarray, scenes, device="cuda") -> np.ndarray:
    """The input photographs of `svbrdf` (H, W, 12) under `scenes` (a
    scene.Scene with (n, 3) fields): rendered on `device` with the local
    renderer, gamma-encoded and clipped to [0, 1]; (n, H, W, 3) f32."""
    dev = resolve_device(device)
    sv = torch.from_numpy(np.ascontiguousarray(svbrdf, np.float32)).to(dev)
    renders = render.render(scenes.to(dev), sv[None])  # (n, H, W, 3)
    photos = torch.clamp(codecs.gamma_encode(renders), 0.0, 1.0)
    return photos.cpu().numpy()


def render_strip(svbrdf: np.ndarray, n_inputs: int, seed: int,
                 device="cuda") -> np.ndarray:
    """Pack one sample strip (H, (n_inputs+4)*W, 3) float in [0, 1].

    The input photos' scenes are the dataset's own distribution without
    augmentation (pipeline.generate_input_scenes), drawn from a
    torch.Generator seeded with `seed` on `device`; render_photos renders
    them. n_inputs=0 gives a maps-only strip (the material-mixing corpora
    store no photographs: their inputs are synthesized on the device).
    """
    if n_inputs == 0:
        photos = np.zeros((0,) + svbrdf.shape[:2] + (3,), np.float32)
    else:
        dev = resolve_device(device)
        g = torch.Generator(device=dev).manual_seed(int(seed))
        batch = pipeline.generate_input_scenes(
            1, n_inputs, use_augmentation=False, generator=g, device=dev)
        scenes = Scene(batch.camera_pos[0], batch.light_pos[0],
                       batch.light_color[0])
        photos = render_photos(svbrdf, scenes, dev)

    normals01 = svbrdf[..., :3] * 0.5 + 0.5
    maps = [normals01, svbrdf[..., 3:6], svbrdf[..., 6:9],
            svbrdf[..., 9:12]]
    return np.concatenate(list(photos) + maps, axis=1)


def generate_toy_dataset(out_dir: str, n_train: int = 2, n_test: int = 1,
                         size: int = 256, n_inputs: int = 10,
                         seed: int = 313, device="cuda") -> list:
    """Write the toy strips (out_dir/{train,test}/toy_<split>_<i>.png);
    returns the written paths. The numpy draws follow the JAX package's
    sequence: one material, then one strip seed, per strip."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    written = []
    for split, count in (("train", n_train), ("test", n_test)):
        d = os.path.join(out_dir, split)
        os.makedirs(d, exist_ok=True)
        for i in range(count):
            sv = make_toy_svbrdf(rng, size)
            strip = render_strip(sv, n_inputs,
                                 seed=int(rng.integers(0, 2 ** 31)),
                                 device=dev)
            path = os.path.join(d, f"toy_{split}_{i:02d}.png")
            strips.write_image(path, strip)
            written.append(path)
            print(f"wrote {path}")
    return written


def main(argv=None) -> None:
    import argparse

    p = argparse.ArgumentParser(description="Generate the procedural toy "
                                            "dataset")
    p.add_argument("out_dir", nargs="?", default="./data")
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--train", type=int, default=2)
    p.add_argument("--test", type=int, default=1)
    p.add_argument("--inputs", type=int, default=10)
    p.add_argument("--seed", type=int, default=313)
    p.add_argument("--device", default="cuda",
                   help="where the photos are rendered (cuda or cpu)")
    args = p.parse_args(argv)
    generate_toy_dataset(args.out_dir, args.train, args.test, args.size,
                         args.inputs, args.seed, args.device)


if __name__ == "__main__":
    main()
