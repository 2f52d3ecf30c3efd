"""The SVBRDF U-Net generator with its parallel global track, NCHW.

Counterpart of svbrdf_tpu/models/generator.py: `depth` stride-2 encoder
blocks (ngf * min(2^i, 8) features), `depth` decoder blocks with skip
concats, InstanceNorm everywhere except the first and last encoder block and
the last decoder block, dropout 0.5 on the first three decoder blocks, and
an FC + SELU global track fed by pre-norm channel means and merged back by
broadcast-add. With `use_coords` two coordinate channels (layers.append_coords)
join the input before the first block and its global-track means.
depth=8 is the reference layer for layer.
"""

from __future__ import annotations

import torch
from torch import nn

from svbrdf_tpu_torch.models import layers as L


def encoder_features(ngf: int, depth: int):
    """ngf * min(2^i, 8): 64, 128, 256, 512, 512, ... for ngf=64."""
    return [ngf * min(2 ** i, 8) for i in range(depth)]


class Generator(nn.Module):
    """(B, 3, H, W) -> (spatial map (B, out, H, W), global (B, out))."""

    def __init__(self, output_channels: int, num_filters: int = 64,
                 depth: int = 8, use_coords: bool = False):
        super().__init__()
        d = depth
        self.depth = d
        self.use_coords = use_coords
        in_channels = 5 if use_coords else 3
        enc = encoder_features(num_filters, d)
        dec = [output_channels if i == d - 1 else enc[d - 2 - i]
               for i in range(d)]
        gte_out = [enc[i + 1] for i in range(d - 1)] + [dec[0]]
        gtd_out = dec[1:] + [output_channels]

        for i in range(d):
            self.add_module(f"enc{i + 1}", L.EncodingBlock(
                in_channels if i == 0 else enc[i - 1], enc[i],
                use_norm=0 < i < d - 1, use_activation=i > 0))
        # gte1 reads the input means; gte{i+1} concat(global, enc{i+1} means).
        self.gte1 = L.GlobalTrack(in_channels, gte_out[0])
        for i in range(1, d):
            self.add_module(f"gte{i + 1}", L.GlobalTrack(
                gte_out[i - 1] + enc[i], gte_out[i]))
        g_dim = gte_out[-1]
        for i in range(d):
            in_f = enc[d - 1] if i == 0 else dec[i - 1] + enc[d - 1 - i]
            self.add_module(f"dec{d - i}", L.DecodingBlock(
                in_f, dec[i], use_norm=i != d - 1, use_dropout=i < 3))
            self.add_module(f"gtd{d - i}", L.GlobalTrack(g_dim + dec[i],
                                                         gtd_out[i]))
            g_dim = gtd_out[i]

    def forward(self, x):
        d = self.depth
        if self.use_coords:
            x = L.append_coords(x)
        g = self.gte1(torch.mean(x, dim=(2, 3)), None)
        h, _ = self.enc1(x, None)
        skips = [h]
        for i in range(1, d):
            h, mean = getattr(self, f"enc{i + 1}")(h, g)
            skips.append(h)
            g = getattr(self, f"gte{i + 1}")(mean, g)
        for i in range(d):
            skip = None if i == 0 else skips[d - 1 - i]
            h, mean = getattr(self, f"dec{d - i}")(h, skip, g)
            g = getattr(self, f"gtd{d - i}")(mean, g)
        return h, g
