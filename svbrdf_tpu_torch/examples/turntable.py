"""Render a turntable animation of an SVBRDF sample strip.

    python -m svbrdf_tpu_torch.examples.turntable <strip.png> out.gif \
        [n_frames] [--device cpu]

The maps of the strip (after its 10 photos) are rendered on
the device under a camera and light orbiting the patch, warped into the
camera's perspective and written as a looping GIF. Counterpart of
examples/turntable.py.
"""

from __future__ import annotations

import argparse

from svbrdf_tpu_torch import viz
from svbrdf_tpu_torch.data import strips


def main(argv=None) -> str:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("strip")
    p.add_argument("out")
    p.add_argument("n_frames", nargs="?", type=int, default=36)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    _, svbrdf = strips.load_sample(args.strip, 10, 0)
    frames = viz.turntable_frames(svbrdf, n_frames=args.n_frames,
                                  device=args.device)
    viz.save_animation(args.out, frames)
    print(f"wrote {args.out} ({args.n_frames} frames)")
    return args.out


if __name__ == "__main__":
    main()
