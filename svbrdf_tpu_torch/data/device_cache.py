"""Device-resident dataset cache: decode once, then every batch is a gather
on the card.

Counterpart of svbrdf_tpu/data/device_cache.py. When the corpus fits device
memory (the multi-view corpus is ~1 GB), the whole decoded dataset lives on
the device as uint8 and a training batch is an index_select instead of a
host assembly and a host-to-device copy. The host only draws indices
(shuffle, mixing partners). Samples are decoded through the dataset's uint8
fast path once, when the cache is built.

The JAX package's second, phase-planes copy of the SVBRDF is a TPU layout
and its K-step gather serves the lax.scan program; neither is ported.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from svbrdf_tpu_torch.device import resolve_device

_CHUNK = 32  # samples per upload (bounds host staging memory)


class DeviceDataCache:
    """Upload a dataset's decoded uint8 samples to `device` once; serve
    batches as gathers there.

    Requires the dataset's uint8 fast path (scale_mode='crop', SVBRDF maps
    present) and fixed per-sample content (random crops would be frozen at
    build time, so they are rejected). Mixing partners are still drawn per
    batch by the dataset's host RNG.
    """

    def __init__(self, dataset, device="cuda", max_bytes: int = 12 << 30):
        if not dataset._transfer_u8:
            raise ValueError(
                "DeviceDataCache needs the uint8 fast path "
                "(scale_mode='crop' with SVBRDF maps present)")
        if dataset.random_crop:
            raise ValueError(
                "DeviceDataCache would freeze random crops at build time; "
                "use the host pipeline for random_crop datasets")
        self.device = resolve_device(device)
        self._dataset = dataset
        n = len(dataset)
        x0, s0 = dataset.load_scaled_u8(0)
        shapes = {"inputs": (n,) + x0.shape, "svbrdf": (n,) + s0.shape}
        self.nbytes = sum(int(np.prod(s)) for s in shapes.values())
        if self.nbytes > max_bytes:
            raise ValueError(
                f"dataset needs {self.nbytes / 1e9:.1f} GB on device, over "
                f"the {max_bytes / 1e9:.1f} GB budget — stream from host "
                f"instead")
        self._store = {k: torch.empty(s, dtype=torch.uint8,
                                      device=self.device)
                       for k, s in shapes.items()}
        for lo in range(0, n, _CHUNK):
            hi = min(n, lo + _CHUNK)
            xs, ss = zip(*(dataset.load_scaled_u8(i) for i in range(lo, hi)))
            self._store["inputs"][lo:hi].copy_(torch.from_numpy(np.stack(xs)))
            self._store["svbrdf"][lo:hi].copy_(torch.from_numpy(np.stack(ss)))

    def __len__(self) -> int:
        return len(self._dataset)

    def _gather(self, key: str, indices) -> torch.Tensor:
        idx = torch.from_numpy(np.asarray(indices, np.int64)).to(self.device)
        return torch.index_select(self._store[key], 0, idx)

    def raw_batch(self, indices,
                  rows: Optional[slice] = None) -> Dict[str, torch.Tensor]:
        """On-device uint8 batch (+ mixing partners when the dataset
        mixes), shaped as SvbrdfDataset.raw_batch's host arrays; with
        `rows`, those rows of it (the partners drawn for every index, as
        SvbrdfDataset.raw_batch draws them)."""
        indices = list(indices)
        partners = None
        if self._dataset.mix_materials:
            # One host-RNG draw per sample, as SvbrdfDataset.raw_batch
            # makes them: the cached and host pipelines give the same
            # partners for the same seed.
            partners = self._dataset.draw_partners(len(indices))
        if rows is not None:
            indices = indices[rows]
            partners = partners[rows] if partners is not None else None
        batch = {k: self._gather(k, indices) for k in self._store}
        if partners is not None:
            batch["partner_svbrdf"] = self._gather("svbrdf", partners)
        return batch
