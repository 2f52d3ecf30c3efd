"""Recover SVBRDF maps by optimizing through the rendering loss.

    python -m svbrdf_tpu_torch.examples.recover_maps <strip.png> diffuse \
        out.png [steps] [--device cpu]
    python -m svbrdf_tpu_torch.examples.recover_maps <strip.png> all \
        out.png [steps] --generator materialgan [--device cpu]

Without a generator: optimizes one map (or `all` four) of a flat SVBRDF,
the others the strip's, until its renders under fresh random scenes match
the strip's material's. With `--generator materialgan`: captures the
strip's material by MaterialGAN's latent optimization
(experiments.recover_latent): 7 flash photos of it are synthesized
(data/pipeline), and the W+ and noise of a seeded generator at the strip's
size (models.build_model("materialgan"); no trained weights) are
optimized until its maps' renders match them; it recovers all four maps.
Writes a comparison grid [input | the strip's maps] / [blank | the
recovered maps], the input the first photo or blank. Counterpart of
examples/recover_maps.py.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from svbrdf_tpu_torch import viz
from svbrdf_tpu_torch.data import pipeline, strips
from svbrdf_tpu_torch.device import resolve_device
from svbrdf_tpu_torch.experiments import recover_latent, recover_maps
from svbrdf_tpu_torch.models import build_model

MAPS = ("normals", "diffuse", "roughness", "specular")
PHOTOS = 7


def _capture(svbrdf: np.ndarray, steps: int, dev):
    """MaterialGAN capture of `svbrdf` (H, W, 12) from synthesized flash
    photos: (result, the first photo)."""
    gen = torch.Generator(device=dev).manual_seed(0)
    model = build_model("materialgan", device=dev,
                        resolution=svbrdf.shape[0])
    target = torch.as_tensor(svbrdf)[None].to(dev, torch.float32)
    with torch.no_grad():
        scenes = pipeline.generate_input_scenes(1, PHOTOS, True,
                                                generator=gen, device=dev)
        photos = pipeline.synthesize_inputs(target, PHOTOS, True,
                                            generator=gen, scenes=scenes)
    result = recover_latent(model, photos, scenes, steps=steps,
                            generator=gen)
    return result, photos[0, 0].cpu().numpy()


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("strip")
    p.add_argument("which", choices=MAPS + ("all",))
    p.add_argument("out")
    p.add_argument("steps", nargs="?", type=int, default=200)
    p.add_argument("--generator", choices=("materialgan",))
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.generator and args.which != "all":
        p.error("a generator recovers all four maps: pass 'all'")
    dev = resolve_device(args.device)

    _, svbrdf = strips.load_sample(args.strip, 10, 0)
    if args.generator:
        result, shown = _capture(svbrdf, args.steps, dev)
        recovered = result.svbrdf[0]
    else:
        result = recover_maps(
            torch.Generator(device=dev).manual_seed(0), svbrdf,
            optimize=MAPS if args.which == "all" else (args.which,),
            steps=args.steps, device=dev)
        recovered, shown = result.svbrdf, np.zeros_like(svbrdf[..., :3])
    losses = result.losses.cpu()
    print(f"loss {float(losses[0]):.4f} -> {float(losses[-1]):.4f} over "
          f"{args.steps} steps")
    viz.save_comparison_grid(args.out, shown, svbrdf,
                             recovered.cpu().numpy())
    print(f"wrote {args.out}")
    return result


if __name__ == "__main__":
    main()
