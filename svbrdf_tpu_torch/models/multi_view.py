"""Multi-view SVBRDF estimation model.

Counterpart of svbrdf_tpu/models/multi_view.py: a shared Generator runs over
every view, its spatial maps and global vectors are max-pooled over the
views, and a fusion head (merge, then three 3x3 ConvFeatureBlocks 64 -> 32
-> 9 interleaved with three GlobalTrack stages) gives the 9-channel head,
decoded as in the single-view model.

The JAX package vmaps the Generator over the view axis with shared
parameters and per-view dropout keys; here the views are folded into the
batch, which is the same computation: InstanceNorm and the global track
are per sample, and dropout draws an independent mask per element. The
JAX head runs in a space-to-depth phase layout for the TPU; this is its
plain form at full resolution, with the same parameter tree.
"""

from __future__ import annotations

import torch
from torch import nn

from svbrdf_tpu_torch.device import resolve_device
from svbrdf_tpu_torch.models import layers as L
from svbrdf_tpu_torch.models.generator import Generator
from svbrdf_tpu_torch.models.single_view import head_to_svbrdf

HEAD_FEATURES = (64, 32, 9)


class MultiViewModel(nn.Module):
    """images (B, N, H, W, 3) or (B, H, W, 3) -> SVBRDF (B, H, W, 12).

    The parameters are made on `device` ("cuda" unless the caller asks for
    the CPU) and drawn from a generator seeded with `seed`.
    """

    def __init__(self, num_filters: int = 64, depth: int = 8,
                 generator_output_channels: int = 64,
                 use_coords: bool = False, *, device="cuda", seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        c0 = generator_output_channels
        f1, f2, f3 = HEAD_FEATURES
        with dev:
            self.generator = Generator(c0, num_filters=num_filters,
                                       depth=depth, use_coords=use_coords)
            self.merge = L.Merge(c0)
            self.gt1 = L.GlobalTrack(c0 + c0, f1)
            self.conv1 = L.ConvFeatureBlock(c0, f1, use_norm=True,
                                            use_activation=False)
            self.gt2 = L.GlobalTrack(f1 + f1, f2)
            self.conv2 = L.ConvFeatureBlock(f1, f2, use_norm=True,
                                            use_activation=True)
            self.gt3 = L.GlobalTrack(f2 + f2, f3)
            self.conv3 = L.ConvFeatureBlock(f2, f3, use_norm=False,
                                            use_activation=True)
        L.init_params(self, torch.Generator(device=dev).manual_seed(seed))

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        if images.dim() == 4:
            images = images[:, None]
        b, n, h, w, _ = images.shape
        # The shared Generator once over all views, folded into the batch.
        spatial, global_vec = self.generator(
            images.reshape(b * n, h, w, 3).permute(0, 3, 1, 2))
        # Max-pool over the views; amax splits the gradient among ties as
        # jnp.max does.
        spatial = torch.amax(spatial.reshape(b, n, *spatial.shape[1:]), dim=1)
        g_pooled = torch.amax(global_vec.reshape(b, n, -1), dim=1)

        x = self.merge(spatial, g_pooled)
        g = self.gt1(torch.mean(spatial, dim=(2, 3)), g_pooled)
        x, mean = self.conv1(x, g)
        g = self.gt2(mean, g)
        x, mean = self.conv2(x, g)
        g = self.gt3(mean, g)
        x, _ = self.conv3(x, g)
        return head_to_svbrdf(x.permute(0, 2, 3, 1))
