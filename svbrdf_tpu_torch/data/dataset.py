"""SvbrdfDataset: host I/O over the strip format.

Counterpart of svbrdf_tpu/data/dataset.py, covering its three input modes:
  (a) multi-view strips  [N photos + 4 maps]          (input_image_count=N)
  (b) SVBRDF-only strips with on-the-fly input render (input_image_count=0)
  (c) photograph folders without maps                 (no_svbrdf=True)

The host decodes PNGs and picks random indices (shuffle, mixing partners,
crop anchors) from np.random.default_rng(seed), consumed in the same order
as the JAX package's: for the same seed and calls, shuffles, partners and
anchors are identical. The math (mixing, gamma, synthesis) runs on the
device in data/pipeline.prepare_batch; only test mode's __getitem__
prepares one item on the host, drawing from a torch.Generator seeded from
`seed`.

Not ported: the per-host file shard of multi-host training and the native
libpng prefetch pool (`prefetch` is kept as a hook that does nothing).
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from svbrdf_tpu_torch.data import pipeline, strips


class SvbrdfDataset:
    def __init__(self, data_directory: str, image_size: int = 256,
                 scale_mode: str = "crop", input_image_count: int = 0,
                 used_input_image_count: int = 1,
                 use_augmentation: bool = True,
                 mix_materials: bool = False, no_svbrdf: bool = False,
                 is_linear: bool = False, random_crop: bool = False,
                 seed: int = 313, cache_bytes: int = 1 << 30):
        self.data_directory = data_directory
        self.file_paths: List[str] = strips.list_sample_files(data_directory)
        self.image_size = image_size
        self.scale_mode = scale_mode
        self.input_image_count = input_image_count
        self.used_input_image_count = used_input_image_count
        self.use_augmentation = use_augmentation
        # Mixing is only defined for map-only datasets.
        self.mix_materials = mix_materials and input_image_count == 0
        if mix_materials and input_image_count > 0:
            print("Warning: material mixing requires a dataset without "
                  "input images; disabled.")
        self.no_svbrdf = no_svbrdf
        self.is_linear = is_linear
        self.random_crop = random_crop

        self._host_rng = np.random.default_rng(seed)
        self._generator = torch.Generator().manual_seed(seed)

        # Byte fast path: in crop mode (pure slicing) strips stay uint8 end
        # to end; /255 and the normals' remap happen on the device.
        self._transfer_u8 = (scale_mode == "crop" and not no_svbrdf)

        # Decoded-sample caches (uint8, bounded by cache_bytes in all):
        # repeat epochs over a dataset that fits in host RAM skip PNG
        # decode. With a fixed crop anchor the cache holds the cropped
        # (inputs, svbrdf) tiles as contiguous arrays; random_crop caches
        # the whole strip so that fresh anchors see every pixel.
        self._cache_limit = max(0, cache_bytes)
        self._cache: "dict[int, np.ndarray]" = {}
        self._scaled_cache: "dict[int, tuple]" = {}
        self._cache_used = 0

    def __len__(self) -> int:
        return len(self.file_paths)

    def _crop_anchor(self, h: int, w: int):
        if self.scale_mode == "crop" and self.random_crop:
            return (int(self._host_rng.integers(0, h - self.image_size + 1)),
                    int(self._host_rng.integers(0, w - self.image_size + 1)))
        return (0, 0)

    def prefetch(self, indices) -> None:
        """Hint about upcoming samples; the port has no decode pool, so
        this does nothing."""

    def _read_strip_u8(self, idx: int, cache_strip: bool = True
                       ) -> np.ndarray:
        cached = self._cache.get(idx)
        if cached is not None:
            return cached
        strip = strips.read_image_u8(self.file_paths[idx])
        if (cache_strip
                and self._cache_used + strip.nbytes <= self._cache_limit):
            self._cache[idx] = strip
            self._cache_used += strip.nbytes
        return strip

    def _read_strip(self, idx: int) -> np.ndarray:
        return self._read_strip_u8(idx).astype(np.float32) / 255.0

    def load_scaled_u8(self, idx: int):
        """Byte fast path (crop mode): raw uint8 (inputs, svbrdf) tiles."""
        fixed_anchor = not self.random_crop
        if fixed_anchor:
            hit = self._scaled_cache.get(idx)
            if hit is not None:
                return hit
        inputs, svbrdf = strips.decode_strip_u8(
            self._read_strip_u8(idx, cache_strip=not fixed_anchor),
            self.input_image_count)
        n_read = min(self.input_image_count, self.used_input_image_count)
        inputs = inputs[self.input_image_count - n_read:]
        r, c = self._crop_anchor(svbrdf.shape[0], svbrdf.shape[1])
        s = self.image_size
        out = (inputs[:, r:r + s, c:c + s, :],
               svbrdf[r:r + s, c:c + s, :])
        if fixed_anchor:
            out = (np.ascontiguousarray(out[0]),
                   np.ascontiguousarray(out[1]))
            nbytes = out[0].nbytes + out[1].nbytes
            if self._cache_used + nbytes <= self._cache_limit:
                self._scaled_cache[idx] = out
                self._cache_used += nbytes
        return out

    def load_scaled(self, idx: int):
        """Strip -> scaled (inputs (N_read, s, s, 3), svbrdf (s, s, 12)):
        uint8 bytes in crop mode with maps, else float32."""
        if self._transfer_u8:
            return self.load_scaled_u8(idx)
        inputs, svbrdf = strips.decode_sample(
            self._read_strip(idx), self.input_image_count,
            self.used_input_image_count, self.no_svbrdf)
        anchor = self._crop_anchor(svbrdf.shape[0], svbrdf.shape[1])
        sv = torch.from_numpy(svbrdf)
        if inputs.shape[0] == 0:
            _, sv = pipeline.scale_sample(sv[None], sv, self.image_size,
                                          self.scale_mode, anchor)
            x = torch.zeros((0,) + tuple(sv.shape[:2]) + (3,))
        else:
            x, sv = pipeline.scale_sample(torch.from_numpy(inputs), sv,
                                          self.image_size, self.scale_mode,
                                          anchor)
        return x.numpy(), sv.numpy()

    @staticmethod
    def _to_float(inputs: np.ndarray, svbrdf: np.ndarray):
        """Undo the uint8 fast path for per-item use."""
        if svbrdf.dtype == np.uint8:
            svf = svbrdf.astype(np.float32) / 255.0
            svbrdf = np.concatenate([svf[..., :3] * 2.0 - 1.0, svf[..., 3:]],
                                    axis=-1)
            inputs = inputs.astype(np.float32) / 255.0
        return inputs, svbrdf

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        """One fully prepared item on the host CPU (test mode; training
        uses raw_batch): {'inputs': (used_count, s, s, 3) linear RGB,
        'svbrdf': (s, s, 12)}."""
        inputs, svbrdf = self._to_float(*self.load_scaled(idx))
        sv = torch.from_numpy(np.ascontiguousarray(svbrdf))
        if self.mix_materials:
            other = int(self._host_rng.integers(0, len(self)))
            _, other_svbrdf = self._to_float(*self.load_scaled(other))
            alpha = 0.1 + 0.8 * torch.rand((), generator=self._generator)
            sv = pipeline.mix_materials(
                sv, torch.from_numpy(np.ascontiguousarray(other_svbrdf)),
                alpha)
        x, sv = pipeline.prepare_sample(
            torch.from_numpy(np.ascontiguousarray(inputs))[None], sv[None],
            used_input_image_count=self.used_input_image_count,
            use_augmentation=self.use_augmentation, is_linear=self.is_linear,
            generator=self._generator)
        return {"inputs": x[0].numpy(), "svbrdf": sv[0].numpy()}

    def raw_batch(self, indices) -> Dict[str, np.ndarray]:
        """Stack scaled raw samples (+ a mixing partner per sample, drawn
        from the host RNG) for preparation on the device."""
        inputs, svbrdfs, partners = [], [], []
        for i in indices:
            x, s = self.load_scaled(int(i))
            inputs.append(x)
            svbrdfs.append(s)
            if self.mix_materials:
                j = int(self._host_rng.integers(0, len(self)))
                partners.append(self.load_scaled(j)[1])
        batch = {
            "inputs": np.stack(inputs),
            "svbrdf": np.stack(svbrdfs),
        }
        if self.mix_materials:
            batch["partner_svbrdf"] = np.stack(partners)
        return batch


def split_train_validation(dataset_len: int, validation_split: float = 0.01,
                           seed: int = 313):
    """Random 99/1 index split: (train indices, validation indices)."""
    n_train = int(math.ceil(dataset_len * (1.0 - validation_split)))
    order = np.random.default_rng(seed).permutation(dataset_len)
    return order[:n_train], order[n_train:]
