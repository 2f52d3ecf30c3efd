"""High-level inference API: checkpoint -> SVBRDF maps.

Counterpart of svbrdf_tpu/estimator.py:

    est = SvbrdfEstimator.from_checkpoint("./model")   # on the card
    maps = est.predict(images)            # (B, H, W, 12) NHWC, numpy
    est.predict_to_files(["photo.png"], "./out")

The model runs on the device it was made on: the card unless the caller
passes device="cpu" (device.resolve_device; without a card that raises).
A diffusion checkpoint (--model-type diffusion) predicts from its EMA
weights by deterministic DDIM, 50 steps (parallel/step.make_predict_fn),
from x_T drawn by a generator seeded with predict's `seed` (default 0).
"""

from __future__ import annotations

import argparse
import pathlib
from typing import Sequence

import numpy as np
import torch

from svbrdf_tpu_torch.data import strips
from svbrdf_tpu_torch.device import resolve_device
from svbrdf_tpu_torch.models import DDPMUNet, build_model
from svbrdf_tpu_torch.ops import codecs
from svbrdf_tpu_torch.parallel.step import make_predict_fn
from svbrdf_tpu_torch.training.checkpoint import Checkpoint
from svbrdf_tpu_torch.utils import profiling


class SvbrdfEstimator:
    def __init__(self, model):
        self.model = model
        self.device = next(model.parameters()).device
        self._predict = make_predict_fn(model)
        self.iterative = isinstance(model, DDPMUNet)

    @classmethod
    def from_checkpoint(cls, model_dir, dtype=torch.float32,
                        image_size: int = 256,
                        device="cuda") -> "SvbrdfEstimator":
        """Accepts every model-dir layout the port's `Checkpoint.load`
        accepts: a `checkpoint.tar` or a legacy `model.data` (+ `state.json`);
        a directory that holds only the JAX package's Orbax state raises
        with the command that exports it. The architecture comes from the
        checkpoint itself (restore_args), as the CLI resolves it. The model
        computes in `dtype` on `device`; `image_size` is accepted as the
        JAX package's is (the port's models need no sample to be made)."""
        dev = resolve_device(device)
        ck = Checkpoint.load(pathlib.Path(model_dir))
        if not ck.is_valid():
            raise FileNotFoundError(f"no checkpoint in '{model_dir}'")
        spec = argparse.Namespace(model_type="single", use_coords=False,
                                  model_depth=8, num_filters=64)
        spec = ck.restore_args(spec)
        model = build_model(spec.model_type, use_coords=spec.use_coords,
                            depth=spec.model_depth,
                            num_filters=spec.num_filters, device=dev,
                            dtype=dtype,
                            **getattr(spec, "diffusion_sizes", {}))
        ck.restore_params(model)
        ck.restore_ema_params(model)
        return cls(model)

    def predict(self, images, seed: int = 0) -> np.ndarray:
        """images: (B, H, W, 3) or (B, N, H, W, 3) linear RGB in [0, 1],
        numpy or a tensor -> (B, H, W, 12) packed SVBRDF, f32 numpy. A
        diffusion model draws x_T from `seed`."""
        x = (images if isinstance(images, torch.Tensor)
             else torch.from_numpy(np.asarray(images, np.float32)))
        x = x.to(self.device, torch.float32)
        out = self._predict(x, seed) if self.iterative else self._predict(x)
        return out.float().cpu().numpy()

    @staticmethod
    def _read_photos(paths: Sequence[str],
                     is_linear: bool = False) -> np.ndarray:
        """Photograph files -> one (B, H, W, 3) batch, linear RGB."""
        imgs = np.stack([strips.read_image(p) for p in paths])
        if not is_linear:
            imgs = np.clip(imgs, 0.0, 1.0) ** 2.2
        return imgs

    def predict_from_photos(self, paths: Sequence[str],
                            is_linear: bool = False) -> np.ndarray:
        """Photograph files -> SVBRDF maps (single batch)."""
        return self.predict(self._read_photos(paths, is_linear))

    def predict_to_files(self, paths: Sequence[str], out_dir: str,
                         is_linear: bool = False) -> list:
        """Write per-input [normals|diffuse|roughness|specular] map strips,
        <out_dir>/<photo stem>_svbrdf.png; returns their paths. The call's
        three parts are host spans (utils/profiling.span): predict.decode
        (reading and linearising the photos), predict.forward (to the
        device, the model, back to numpy) and predict.encode (the strips
        assembled and written)."""
        out = pathlib.Path(out_dir)
        out.mkdir(parents=True, exist_ok=True)
        with profiling.span("predict.decode"):
            imgs = self._read_photos(paths, is_linear)
        with profiling.span("predict.forward"):
            svbrdfs = self.predict(imgs)
        written = []
        with profiling.span("predict.encode"):
            for path, sv in zip(paths, svbrdfs):
                maps = codecs.unpack_svbrdf(torch.from_numpy(sv))
                strip = torch.cat(
                    [codecs.encode_as_unit_interval(maps.normals),
                     maps.diffuse, maps.roughness, maps.specular], dim=1)
                target = out / (pathlib.Path(path).stem + "_svbrdf.png")
                strips.write_image(str(target), strip.numpy())
                written.append(str(target))
        return written
