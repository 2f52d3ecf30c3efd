"""Estimate SVBRDF maps from photographs with a trained checkpoint.

    python -m svbrdf_tpu_torch.examples.predict <model_dir> out_dir \
        photo1.png [photo2.png ...] [--device cpu]

Writes <out_dir>/<photo>_svbrdf.png: [normals | diffuse | roughness |
specular] strips. Counterpart of examples/predict.py.
"""

from __future__ import annotations

import argparse

from svbrdf_tpu_torch.estimator import SvbrdfEstimator


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("model_dir")
    p.add_argument("out_dir")
    p.add_argument("photos", nargs="+")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    est = SvbrdfEstimator.from_checkpoint(args.model_dir, device=args.device)
    written = est.predict_to_files(args.photos, args.out_dir)
    for path in written:
        print(f"wrote {path}")
    return written


if __name__ == "__main__":
    main()
