"""Recover SVBRDF maps by optimizing through the rendering loss.

    python -m svbrdf_tpu_torch.examples.recover_maps <strip.png> diffuse \
        out.png [steps] [--device cpu]

Optimizes one map of a flat SVBRDF (the others are the strip's) until its
renders under fresh random scenes match the strip's material's, then
writes a comparison grid [blank | the strip's maps] / [blank | the
recovered maps]. Counterpart of examples/recover_maps.py.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from svbrdf_tpu_torch import viz
from svbrdf_tpu_torch.data import strips
from svbrdf_tpu_torch.device import resolve_device
from svbrdf_tpu_torch.experiments import recover_maps


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("strip")
    p.add_argument("which", choices=("normals", "diffuse", "roughness",
                                     "specular"))
    p.add_argument("out")
    p.add_argument("steps", nargs="?", type=int, default=200)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    _, svbrdf = strips.load_sample(args.strip, 10, 0)
    result = recover_maps(torch.Generator(device=dev).manual_seed(0), svbrdf,
                          optimize=(args.which,), steps=args.steps,
                          device=dev)
    losses = result.losses.cpu()
    print(f"loss {float(losses[0]):.4f} -> {float(losses[-1]):.4f} over "
          f"{args.steps} steps")
    viz.save_comparison_grid(args.out, np.zeros_like(svbrdf[..., :3]),
                             svbrdf, result.svbrdf.cpu().numpy())
    print(f"wrote {args.out}")
    return result


if __name__ == "__main__":
    main()
