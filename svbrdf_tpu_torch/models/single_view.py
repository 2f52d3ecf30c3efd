"""Single-view SVBRDF estimation model.

Counterpart of svbrdf_tpu/models/single_view.py: Generator(9 channels) ->
tanh -> decode to a 12-channel SVBRDF (normal z reconstruction, roughness
replication) -> diffuse/roughness/specular remapped [-1, 1] -> [0, 1],
normals kept in [-1, 1]. Given (B, N, H, W, 3) inputs, only view 0 is used.
`use_coords` appends coordinate channels to the input (Generator).
"""

from __future__ import annotations

import torch
from torch import nn

from svbrdf_tpu_torch.device import resolve_device
from svbrdf_tpu_torch.models import layers as L
from svbrdf_tpu_torch.models.generator import Generator
from svbrdf_tpu_torch.ops import codecs


def head_to_svbrdf(sv9: torch.Tensor) -> torch.Tensor:
    """(..., 9) head output -> tanh -> packed (..., 12) SVBRDF in output
    ranges."""
    maps = codecs.unpack_svbrdf(codecs.decode_svbrdf(torch.tanh(sv9)))
    unit = codecs.encode_as_unit_interval
    return codecs.pack_svbrdf(maps.normals, unit(maps.diffuse),
                              unit(maps.roughness), unit(maps.specular))


class SingleViewModel(nn.Module):
    """images (B, H, W, 3) or (B, N, H, W, 3) -> SVBRDF (B, H, W, 12).

    The parameters are made on `device` ("cuda" unless the caller asks for
    the CPU) and drawn from a generator seeded with `seed`.
    """

    def __init__(self, num_filters: int = 64, depth: int = 8,
                 use_coords: bool = False, *, device="cuda", seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        with dev:
            self.generator = Generator(9, num_filters=num_filters,
                                       depth=depth, use_coords=use_coords)
        L.init_params(self, torch.Generator(device=dev).manual_seed(seed))

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        if images.dim() == 5:
            images = images[:, 0]
        sv9, _ = self.generator(images.permute(0, 3, 1, 2))
        return head_to_svbrdf(sv9.permute(0, 2, 3, 1))
