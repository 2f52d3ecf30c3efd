"""Point-light scene batches as struct-of-arrays tensors.

Counterpart of svbrdf_tpu/scene.py: every field has a trailing axis of 3
(xyz or rgb) and arbitrary leading batch axes, e.g. (B, S, 3) for per-item
scene sets.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class Scene:
    camera_pos: torch.Tensor   # (..., 3) camera position in patch space
    light_pos: torch.Tensor    # (..., 3) point light position
    light_color: torch.Tensor  # (..., 3) RGB light intensity

    @classmethod
    def make(cls, camera_pos, light_pos, light_color) -> "Scene":
        """A Scene of f32 tensors from arrays (copied: numpy inputs may be
        read-only)."""
        def f32(x):
            if not isinstance(x, torch.Tensor):
                x = torch.tensor(x)
            return x.to(torch.float32)

        return cls(f32(camera_pos), f32(light_pos), f32(light_color))

    def to(self, device) -> "Scene":
        return Scene(self.camera_pos.to(device), self.light_pos.to(device),
                     self.light_color.to(device))

    @staticmethod
    def cat(scenes, dim: int) -> "Scene":
        """Concatenate scene batches along a leading axis."""
        return Scene(torch.cat([s.camera_pos for s in scenes], dim),
                     torch.cat([s.light_pos for s in scenes], dim),
                     torch.cat([s.light_color for s in scenes], dim))
