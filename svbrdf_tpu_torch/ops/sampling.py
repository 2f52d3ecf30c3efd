"""Scene and direction samplers driven by an explicit torch.Generator.

Counterpart of svbrdf_tpu/ops/sampling.py. The streams differ from
jax.random's; the distributions and constants are the same.
"""

from __future__ import annotations

import math

import torch

from svbrdf_tpu_torch.scene import Scene


def _uniform(shape, low, high, generator, device):
    u = torch.rand(shape, generator=generator, device=device)
    return low + (high - low) * u


def _normal(shape, generator, device):
    return torch.randn(shape, generator=generator, device=device)


def cosine_hemisphere_direction(shape, min_eps: float = 0.001,
                                max_eps: float = 0.05, *,
                                generator: torch.Generator,
                                device=None) -> torch.Tensor:
    """Cosine-weighted unit directions on the upper hemisphere, shape+(3,).

    r1 ~ U(min_eps, 1 - max_eps); r = sqrt(r1); phi = 2 pi U(0, 1);
    z = sqrt(1 - r1).
    """
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    r1 = _uniform(shape + (1,), min_eps, 1.0 - max_eps, generator, device)
    r2 = _uniform(shape + (1,), 0.0, 1.0, generator, device)
    r = torch.sqrt(r1)
    phi = 2.0 * math.pi * r2
    return torch.cat([r * torch.cos(phi), r * torch.sin(phi),
                      torch.sqrt(1.0 - r1)], dim=-1)


def generate_random_scenes(shape, *, generator: torch.Generator,
                           device=None) -> Scene:
    """Random view and light on the hemisphere, light color (20, 20, 20)."""
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    view = cosine_hemisphere_direction(shape, 0.001, 0.1,
                                       generator=generator, device=device)
    light = cosine_hemisphere_direction(shape, 0.001, 0.1,
                                        generator=generator, device=device)
    color = torch.full(shape + (3,), 20.0, device=device)
    return Scene(view, light, color)


def generate_specular_scenes(shape, *, generator: torch.Generator,
                             device=None) -> Scene:
    """Mirror-configuration scenes that guarantee specular highlights.

    light = view * (-1, -1, 1); independent log-normal distances
    exp(N(0.5, 0.75)); a shared xy shift ~ U(-1, 1) (z shift 1e-4) moves
    the highlight; light color (50, 50, 50).
    """
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    view = cosine_hemisphere_direction(shape, 0.001, 0.1,
                                       generator=generator, device=device)
    mirror = torch.tensor([-1.0, -1.0, 1.0], device=device)
    light = view * mirror
    distance_view = torch.exp(0.5 + 0.75 * _normal(shape + (1,), generator,
                                                   device))
    distance_light = torch.exp(0.5 + 0.75 * _normal(shape + (1,), generator,
                                                    device))
    shift_xy = _uniform(shape + (2,), -1.0, 1.0, generator, device)
    shift = torch.cat([shift_xy, torch.full(shape + (1,), 1e-4,
                                            device=device)], dim=-1)
    view = view * distance_view + shift
    light = light * distance_light + shift
    color = torch.full(shape + (3,), 50.0, device=device)
    return Scene(view, light, color)


def generate_loss_scenes(batch_size: int, n_random: int = 3,
                         n_specular: int = 6, *, generator: torch.Generator,
                         device=None) -> Scene:
    """Per-item scene sets for the rendering loss, (B, n_random + n_specular, 3):
    the random scenes first, then the specular ones."""
    rand = generate_random_scenes((batch_size, n_random), generator=generator,
                                  device=device)
    spec = generate_specular_scenes((batch_size, n_specular),
                                    generator=generator, device=device)
    return Scene.cat([rand, spec], dim=1)
