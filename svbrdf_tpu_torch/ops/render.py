"""Differentiable Cook-Torrance patch renderer (plain torch ops).

Counterpart of svbrdf_tpu/ops/render.py: orthographic patch of a 2x2 quad at
z=0, per-pixel view/light vectors from a point camera and light, GGX D with
chi+ and clamped denominator, Schlick Fresnel, Smith-style G1 product,
kd = (1 - F) Lambert diffuse, radiance = f * color / d^2 * max(L.N, 0).
Every clamp is at 1e-3. Channels-last and broadcast over leading
scene/batch axes; torch autograd gives the gradients.
"""

from __future__ import annotations

import math

import torch

from svbrdf_tpu_torch.ops import codecs
from svbrdf_tpu_torch.scene import Scene

_PI = math.pi
_EPS = 0.001  # dot-product, roughness and GGX-denominator clamp


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Channel-axis dot product, keepdim."""
    return torch.sum(a * b, dim=-1, keepdim=True)


def normalize(a: torch.Tensor) -> torch.Tensor:
    return a / torch.sqrt(dot(a, a))


def xi(x: torch.Tensor) -> torch.Tensor:
    """Heaviside chi+ (a constant under differentiation)."""
    return (x > 0.0).to(x.dtype)


def patch_coords(height: int, width: int, dtype=torch.float32,
                 device=None) -> torch.Tensor:
    """World coordinates of the patch pixels, (H, W, 3).

    x grows with the width axis, y decreases with the height axis (image
    row 0 is y=+1).
    """
    xs = torch.linspace(-1.0, 1.0, width, dtype=dtype, device=device)
    ys = -torch.linspace(-1.0, 1.0, height, dtype=dtype, device=device)
    xg = xs[None, :].expand(height, width)
    yg = ys[:, None].expand(height, width)
    return torch.stack([xg, yg, torch.zeros_like(xg)], dim=-1)


def _microfacet_distribution(roughness, NH):
    alpha = roughness ** 2
    alpha_sq = alpha ** 2
    NH_sq = NH ** 2
    denom = torch.clamp(NH_sq * (alpha_sq + (1.0 - NH_sq) / NH_sq), min=_EPS)
    return (alpha_sq * xi(NH)) / (_PI * denom ** 2)


def _fresnel(specular, VH):
    return specular + (1.0 - specular) * (1.0 - VH) ** 5


def _g1(roughness, XH, XN):
    alpha = roughness ** 2
    alpha_sq = alpha ** 2
    XN_sq = XN ** 2
    return 2.0 * xi(XH / XN) / (
        1.0 + torch.sqrt(1.0 + alpha_sq * (1.0 - XN_sq) / XN_sq))


def evaluate_brdf(wi, wo, normals, diffuse, roughness, specular):
    """Full Cook-Torrance BRDF: Lambert (1 - F) diffuse + GGX specular."""
    H = normalize((wi + wo) / 2.0)
    NH = torch.clamp(dot(normals, H), min=_EPS)
    VH = torch.clamp(dot(wo, H), min=_EPS)
    LH = torch.clamp(dot(wi, H), min=_EPS)
    VN = torch.clamp(dot(wo, normals), min=_EPS)
    LN = torch.clamp(dot(wi, normals), min=_EPS)
    F = _fresnel(specular, VH)
    G = _g1(roughness, VH, VN) * _g1(roughness, LH, LN)
    D = _microfacet_distribution(roughness, NH)
    return (1.0 - F) * diffuse / _PI + F * G * D / (4.0 * VN * LN)


def render(scene: Scene, svbrdf: torch.Tensor) -> torch.Tensor:
    """Render the patch under a (batch of) point-light scene(s).

    scene fields (..., 3) broadcast against svbrdf's leading axes (e.g.
    scene (B, S, 3) with svbrdf (B, 1, H, W, 12)); svbrdf is (..., H, W, 12).
    Returns linear radiance (..., H, W, 3).
    """
    height, width = svbrdf.shape[-3], svbrdf.shape[-2]
    coords = patch_coords(height, width, svbrdf.dtype, svbrdf.device)
    cam = scene.camera_pos[..., None, None, :]
    light = scene.light_pos[..., None, None, :]
    color = scene.light_color[..., None, None, :]

    wo = normalize(cam - coords)
    maps = codecs.unpack_svbrdf(svbrdf)
    roughness = torch.clamp(maps.roughness, min=_EPS)
    rel_light = light - coords
    wi = normalize(rel_light)

    f = evaluate_brdf(wi, wo, maps.normals, maps.diffuse, roughness,
                      maps.specular)
    LN = torch.clamp(dot(wi, maps.normals), min=0.0)
    falloff = 1.0 / dot(rel_light, rel_light)
    return f * (color * falloff) * LN


def render_scene_set(scenes: Scene, svbrdf: torch.Tensor) -> torch.Tensor:
    """scenes fields (B, S, 3); svbrdf (B, H, W, 12) -> (B, S, H, W, 3)."""
    return render(scenes, svbrdf[:, None])
