"""Building blocks of the SVBRDF U-Net, NCHW inside.

Counterpart of svbrdf_tpu/models/layers.py in its plain reference form: the
decoder's upsample + conv is a materialized nearest-2x upsample,
ZeroPad(1, 2, 1, 2) and a 4x4 conv (the JAX package's dilated, folded and
phase-space forms are exact rewrites of this math for the TPU's layouts).

Submodules are named after the PyTorch reference's state_dict keys (e.g.
enc2.conv.conv.weight, dec8.deconv.conv.2.weight), so a reference
checkpoint and interop.jax_params.params_from_jax both load strictly.

Init contract (init_params):
  conv kernels  ~ N(0, 0.02); no conv bias anywhere;
  merge Linear  ~ N(0, 0.01 * sqrt(1/fan_in)), no bias;
  global track  ~ N(0, 1.00 * sqrt(1/fan_in)), zero bias;
  InstanceNorm weight 1, bias 0.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F


class InstanceNorm(nn.Module):
    """Per-sample, per-channel normalization over H, W with affine params:
    eps 1e-5, biased variance, no running statistics. One-pass statistics,
    E[x^2] - E[x]^2 clamped at 0, as the JAX package computes them."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        mean = torch.mean(x, dim=(2, 3), keepdim=True)
        mean_sq = torch.mean(torch.square(x), dim=(2, 3), keepdim=True)
        var = torch.clamp(mean_sq - torch.square(mean), min=0.0)
        y = (x - mean) * torch.rsqrt(var + self.eps)
        return y * self.weight[:, None, None] + self.bias[:, None, None]


class Merge(nn.Module):
    """Project the global-track vector and broadcast-add it onto the map.
    With no global track (the first encoder block) the input passes as is;
    the weight still exists, as in the reference."""

    def __init__(self, features: int):
        super().__init__()
        self.fully_connected = nn.Linear(features, features, bias=False)

    def forward(self, x, global_track):
        if global_track is None:
            return x
        return x + self.fully_connected(global_track)[:, :, None, None]


class GlobalTrack(nn.Module):
    """FC + SELU over concat(global track, channel means)."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.fully_connected = nn.Linear(in_features, features, bias=True)

    def forward(self, local_mean, global_track):
        h = (local_mean if global_track is None
             else torch.cat([global_track, local_mean], dim=-1))
        return F.selu(self.fully_connected(h))


def _spatial_mean(x):
    """Channel means over H, W (the pre-norm tap into the global track)."""
    return torch.mean(x, dim=(2, 3))


class _ConvUnit(nn.Module):
    """The reference's InterconnectedConvLayer: a conv without bias,
    optional InstanceNorm, merge."""

    def __init__(self, in_features, features, use_norm, kernel_size, stride,
                 padding):
        super().__init__()
        self.conv = nn.Conv2d(in_features, features, kernel_size,
                              stride=stride, padding=padding, bias=False)
        self.norm = InstanceNorm(features) if use_norm else None
        self.merge = Merge(features)


class EncodingBlock(nn.Module):
    """Pre-LeakyReLU(0.2) + stride-2 4x4 pad-1 conv + pre-norm mean tap + IN
    + merge. Returns (features, channel_mean)."""

    conv_geometry = (4, 2, 1)  # kernel size, stride, padding

    def __init__(self, in_features, features, use_norm=True,
                 use_activation=True):
        super().__init__()
        self.use_activation = use_activation
        self.conv = _ConvUnit(in_features, features, use_norm,
                              *self.conv_geometry)

    def forward(self, x, global_track):
        if self.use_activation:
            x = F.leaky_relu(x, 0.2)
        u = self.conv
        x = u.conv(x)
        mean = _spatial_mean(x)
        if u.norm is not None:
            x = u.norm(x)
        return u.merge(x, global_track), mean


class ConvFeatureBlock(EncodingBlock):
    """EncodingBlock with a 3x3 stride-1 pad-1 conv (the multi-view fusion
    head's layer; the reference's ConvFeatureLayer). Returns (features,
    channel_mean)."""

    conv_geometry = (3, 1, 1)


def append_coords(x):
    """Append x / y coordinate channels in [-1, 1] to NCHW `x`: x runs over
    the width, y from +1 at row 0 down to -1 (the renderer's patch grid)."""
    b, _, h, w = x.shape
    xs = torch.linspace(-1.0, 1.0, w, dtype=x.dtype, device=x.device)
    ys = -torch.linspace(-1.0, 1.0, h, dtype=x.dtype, device=x.device)
    coords = torch.stack([xs[None, :].expand(h, w), ys[:, None].expand(h, w)])
    return torch.cat([x, coords[None].expand(b, 2, h, w)], dim=1)


def upsample_nearest_2x(x):
    """Nearest-neighbour 2x upsampling of NCHW (pixel replication)."""
    b, c, h, w = x.shape
    return x[:, :, :, None, :, None].expand(b, c, h, 2, w, 2).reshape(
        b, c, 2 * h, 2 * w)


def _pad_1212(x):
    """Zero pad (top 1, bottom 2, left 1, right 2), the reference's
    ZeroPad2d((1, 2, 1, 2))."""
    return F.pad(x, (1, 2, 1, 2))


class _Fn(nn.Module):
    """A parameter-free function as a Sequential stage."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, x):
        return self.fn(x)


class _DecodingUnit(nn.Module):
    """The reference's DecodingLayer body: conv = [upsample, pad, conv,
    pad, conv] (keys conv.2 / conv.4), optional InstanceNorm, merge."""

    def __init__(self, in_features, features, use_norm):
        super().__init__()
        self.conv = nn.Sequential(
            _Fn(upsample_nearest_2x), _Fn(_pad_1212),
            nn.Conv2d(in_features, features, 4, bias=False),
            _Fn(_pad_1212),
            nn.Conv2d(features, features, 4, bias=False))
        self.norm = InstanceNorm(features) if use_norm else None
        self.merge = Merge(features)


class DecodingBlock(nn.Module):
    """Skip concat + pre-LeakyReLU(0.2) + (upsample, pad, 4x4 conv, pad,
    4x4 conv) + pre-norm mean tap + IN + merge + optional dropout(0.5).
    Returns (features, channel_mean)."""

    def __init__(self, in_features, features, use_norm=True,
                 use_dropout=False):
        super().__init__()
        self.deconv = _DecodingUnit(in_features, features, use_norm)
        self.dropout = nn.Dropout(0.5) if use_dropout else None

    def forward(self, x, skip, global_track):
        if skip is not None:
            x = torch.cat([x, skip], dim=1)
        x = F.leaky_relu(x, 0.2)
        u = self.deconv
        x = u.conv(x)
        mean = _spatial_mean(x)
        if u.norm is not None:
            x = u.norm(x)
        x = u.merge(x, global_track)
        if self.dropout is not None:
            x = self.dropout(x)
        return x, mean


@torch.no_grad()
def init_params(module: nn.Module, generator: torch.Generator) -> None:
    """Apply the init contract to every layer under `module`, drawing from
    `generator` (which must live on the parameters' device)."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            nn.init.normal_(m.weight, 0.0, 0.02, generator=generator)
        elif isinstance(m, Merge):
            w = m.fully_connected.weight
            nn.init.normal_(w, 0.0, 0.01 * (1.0 / w.shape[1]) ** 0.5,
                            generator=generator)
        elif isinstance(m, GlobalTrack):
            w = m.fully_connected.weight
            nn.init.normal_(w, 0.0, (1.0 / w.shape[1]) ** 0.5,
                            generator=generator)
            nn.init.zeros_(m.fully_connected.bias)
        elif isinstance(m, InstanceNorm):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
