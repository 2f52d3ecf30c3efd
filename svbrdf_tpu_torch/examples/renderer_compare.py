"""Side-by-side local-renderer vs path-tracer comparison grid.

    python -m svbrdf_tpu_torch.examples.renderer_compare <strip.png> \
        out.png [n_scenes] [--device cpu]

Writes a PNG grid of [ the maps | local renders | path-traced renders ]
under n_scenes random scenes shared by both renderers. Counterpart of
examples/renderer_compare.py.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from svbrdf_tpu_torch.data import strips
from svbrdf_tpu_torch.device import resolve_device
from svbrdf_tpu_torch.ops import codecs, pathtrace, render, sampling


def main(argv=None) -> str:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("strip")
    p.add_argument("out")
    p.add_argument("n_scenes", nargs="?", type=int, default=4)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    n = args.n_scenes

    _, svbrdf = strips.load_sample(args.strip, 10, 0)
    svbrdf = torch.from_numpy(svbrdf).to(dev)
    scenes = sampling.generate_random_scenes(
        n, generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    with torch.no_grad():
        local = render.render(scenes, svbrdf[None])  # (S, H, W, 3)
        traced = pathtrace.render(
            scenes, svbrdf[None],
            generator=torch.Generator(device=dev).manual_seed(1))

    maps = codecs.unpack_svbrdf(svbrdf)
    row_maps = [codecs.encode_as_unit_interval(maps.normals), maps.diffuse,
                maps.roughness, maps.specular]

    def tone(r):
        return codecs.gamma_encode(torch.clamp(r, 0.0, 1.0))

    rows = [row_maps, [tone(local[s]) for s in range(n)],
            [tone(traced[s]) for s in range(n)]]
    n_cols = max(len(row_maps), n)
    grid = np.concatenate([np.concatenate(
        [t.float().cpu().numpy() for t in row]
        + [np.zeros_like(row[0].cpu().numpy())] * (n_cols - len(row)),
        axis=1) for row in rows], axis=0)
    strips.write_image(args.out, grid)
    print(f"wrote {args.out} (rows: maps / local renderer / path tracer, "
          f"{n} shared scenes)")
    return args.out


if __name__ == "__main__":
    main()
