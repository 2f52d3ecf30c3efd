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

Strips not in the caches are decoded ahead of use by a pool of worker
processes (data/prefetch.py) running the port's own PNG decoder, where the
JAX package's pool runs libpng in threads.

Data-parallel training: a rank of one --num-devices launch reads the whole
corpus and asks raw_batch for its rows of each global batch (the host RNG
draws for the whole batch, so it advances on every rank as on one device);
a process of the launcher (parallel/multihost) reads its own file shard
(shard_files_for_host) with its own seed, as the JAX package's processes do.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Dict, List, Optional

import numpy as np
import torch

from svbrdf_tpu_torch.data import pipeline, strips
from svbrdf_tpu_torch.data.prefetch import PrefetchPool
from svbrdf_tpu_torch.utils import profiling


def strip_tiles(path: str, input_image_count: int, n_read: int,
                size: int):
    """The byte fast path's work for one sample at the fixed crop anchor
    (0, 0): the strip decoded and split, its last `n_read` photos and its
    maps cropped to size x size, as contiguous uint8 (inputs, svbrdf)
    tiles. The decode pool's workers run it."""
    inputs, svbrdf = strips.decode_strip_u8(strips.read_image_u8(path),
                                            input_image_count)
    inputs = inputs[input_image_count - n_read:]
    return (np.ascontiguousarray(inputs[:, :size, :size, :]),
            np.ascontiguousarray(svbrdf[:size, :size, :]))


class SvbrdfDataset:
    def __init__(self, data_directory: str, image_size: int = 256,
                 scale_mode: str = "crop", input_image_count: int = 0,
                 used_input_image_count: int = 1,
                 use_augmentation: bool = True,
                 mix_materials: bool = False, no_svbrdf: bool = False,
                 is_linear: bool = False, random_crop: bool = False,
                 seed: int = 313, use_native_prefetch: bool = True,
                 prefetch_threads: int = 2, cache_bytes: int = 1 << 30,
                 process_index: int = 0, process_count: int = 1):
        """use_native_prefetch / prefetch_threads keep the JAX package's
        names: with it on, `prefetch` hands the strips not yet cached to a
        pool of `prefetch_threads` worker processes running the port's own
        decoder (started at the first prefetch; `close` stops them).

        With process_count > 1 (the launcher's processes, JAX's
        shard_across_hosts) the dataset is process `process_index`'s file
        shard, and its host RNG is seeded with seed * 1000 +
        process_index, so processes draw independent partners."""
        self.data_directory = data_directory
        self.file_paths: List[str] = strips.list_sample_files(data_directory)
        self.global_file_count = len(self.file_paths)
        if process_count > 1:
            self.file_paths = shard_files_for_host(
                self.file_paths, process_index, process_count)
            seed = seed * 1000 + process_index
            print(f"Host {process_index}/{process_count}: "
                  f"{len(self.file_paths)} of {self.global_file_count} "
                  f"files")
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

        self._use_pool = use_native_prefetch and bool(self.file_paths)
        self._prefetch_workers = prefetch_threads
        self._pool = None
        # What a sample's decode is, in the pool's workers or here: with a
        # fixed crop anchor the byte path's tiles (strip_tiles), else the
        # strip.
        if self._transfer_u8 and not random_crop:
            self._decode = partial(
                strip_tiles, input_image_count=input_image_count,
                n_read=min(input_image_count, used_input_image_count),
                size=image_size)
        else:
            self._decode = strips.read_image_u8

    def close(self) -> None:
        """Stop the decode pool's workers (a later prefetch starts new
        ones)."""
        if self._pool is not None:
            self._pool.close()
            self._pool = None

    def __enter__(self) -> "SvbrdfDataset":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __len__(self) -> int:
        return len(self.file_paths)

    def _crop_anchor(self, h: int, w: int):
        if self.scale_mode == "crop" and self.random_crop:
            return (int(self._host_rng.integers(0, h - self.image_size + 1)),
                    int(self._host_rng.integers(0, w - self.image_size + 1)))
        return (0, 0)

    def prefetch(self, indices) -> None:
        """Hint the decode pool about upcoming samples: those in neither
        cache are queued (no-op without the pool)."""
        if not self._use_pool:
            return
        wanted = [int(i) for i in indices
                  if int(i) not in self._cache
                  and int(i) not in self._scaled_cache]
        if wanted and self._pool is None:
            self._pool = PrefetchPool(self.file_paths,
                                      self._prefetch_workers,
                                      decode=self._decode)
        for i in wanted:
            self._pool.request(i)

    def _decoded(self, idx: int):
        """self._decode of sample `idx`: from the pool if there is one
        (its worker's if requested), else here. Called on a cache miss
        only, each inside a data.decode span: their count is the misses'."""
        with profiling.span("data.decode"):
            if self._pool is not None:
                return self._pool.take(idx)
            return self._decode(self.file_paths[idx])

    def _read_strip_u8(self, idx: int) -> np.ndarray:
        cached = self._cache.get(idx)
        if cached is not None:
            return cached
        strip = self._decoded(idx)
        if self._cache_used + strip.nbytes <= self._cache_limit:
            self._cache[idx] = strip
            self._cache_used += strip.nbytes
        return strip

    def _read_strip(self, idx: int) -> np.ndarray:
        return self._read_strip_u8(idx).astype(np.float32) / 255.0

    def load_scaled_u8(self, idx: int):
        """Byte fast path (crop mode): raw uint8 (inputs, svbrdf) tiles."""
        if not self.random_crop:
            out = self._scaled_cache.get(idx)
            if out is None:
                out = self._decoded(idx)
                nbytes = out[0].nbytes + out[1].nbytes
                if self._cache_used + nbytes <= self._cache_limit:
                    self._scaled_cache[idx] = out
                    self._cache_used += nbytes
            return out
        inputs, svbrdf = strips.decode_strip_u8(self._read_strip_u8(idx),
                                                self.input_image_count)
        n_read = min(self.input_image_count, self.used_input_image_count)
        inputs = inputs[self.input_image_count - n_read:]
        r, c = self._crop_anchor(svbrdf.shape[0], svbrdf.shape[1])
        s = self.image_size
        return (inputs[:, r:r + s, c:c + s, :], svbrdf[r:r + s, c:c + s, :])

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

    def draw_partners(self, n: int) -> List[int]:
        """The mixing partners of n samples, drawn from the host RNG."""
        return [int(self._host_rng.integers(0, len(self))) for _ in range(n)]

    def skip_batch(self, indices) -> None:
        """Advance the host RNG as raw_batch(indices) would, decoding
        nothing (a data-parallel rank that leaves a batch to another)."""
        if self.scale_mode == "crop" and self.random_crop:
            raise ValueError("skipping a random-crop batch: its host RNG "
                             "draws depend on every strip's decode")
        if self.mix_materials:
            self.draw_partners(len(indices))

    def raw_batch(self, indices,
                  rows: Optional[slice] = None) -> Dict[str, np.ndarray]:
        """Stack scaled raw samples (+ a mixing partner per sample, drawn
        from the host RNG) for preparation on the device.

        With `rows`, only those rows of the batch (a data-parallel rank's):
        the partners are drawn for every index, so the host RNG advances as
        for the whole batch, and only the rows and their partners are
        decoded. The whole call is a data.raw_batch span."""
        with profiling.span("data.raw_batch"):
            return self._raw_batch(indices, rows)

    def _raw_batch(self, indices, rows: Optional[slice]):
        indices = [int(i) for i in indices]
        drawn = None
        if self.mix_materials and not (self.scale_mode == "crop"
                                       and self.random_crop):
            # No crop anchor draws from the host RNG, so the partners are
            # drawn first (the same draws in the same order) and the pool
            # decodes them beside the batch's own samples.
            drawn = self.draw_partners(len(indices))
        if rows is not None:
            if self.scale_mode == "crop" and self.random_crop:
                raise ValueError("rows of a random-crop batch: its host RNG "
                                 "draws depend on every strip's decode")
            indices = indices[rows]
            drawn = drawn[rows] if drawn is not None else None
        if drawn is not None:
            self.prefetch(drawn)
        inputs, svbrdfs, partners = [], [], []
        for n, i in enumerate(indices):
            x, s = self.load_scaled(i)
            inputs.append(x)
            svbrdfs.append(s)
            if self.mix_materials:
                j = (drawn[n] if drawn is not None
                     else int(self._host_rng.integers(0, len(self))))
                partners.append(self.load_scaled(j)[1])
        batch = {
            "inputs": np.stack(inputs),
            "svbrdf": np.stack(svbrdfs),
        }
        if self.mix_materials:
            batch["partner_svbrdf"] = np.stack(partners)
        return batch


def shard_files_for_host(paths, process_index: int,
                         process_count: int) -> List[str]:
    """Process `process_index`'s shard of a file list for the launcher's
    data-parallel training: the sorted files, round-robin by index."""
    return [p for i, p in enumerate(sorted(paths))
            if i % process_count == process_index]


def split_train_validation(dataset_len: int, validation_split: float = 0.01,
                           seed: int = 313):
    """Random 99/1 index split: (train indices, validation indices)."""
    n_train = int(math.ceil(dataset_len * (1.0 - validation_split)))
    order = np.random.default_rng(seed).permutation(dataset_len)
    return order[:n_train], order[n_train:]
