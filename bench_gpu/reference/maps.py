"""Plain reference of the SVBRDF data path and the local rendering loss.

What the benchmark holds the program's batch preparation and loss to:
the packed SVBRDF layout, the Cook-Torrance point-light renderer, the
scene samplers, material mixing, photo synthesis, and the mixed and
rendering-only losses. Written from the method's description (Deschaintre
et al. 2018, 2019) in plain torch, f32, with no kernel of the program.

Every random draw takes an explicit generator and is made in a fixed order,
the order the training step draws in (mixing alphas, the synthesized
photos' scenes, noise std and noise, then the loss scenes), so that the
reference works out the same draws again from the step's seed.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

GAMMA = 2.2
EPSILON_RENDER = 0.1  # log-space epsilon of the renders
EPSILON_L1 = 0.01  # log-space epsilon of diffuse and specular in the L1
_EPS = 0.001  # dot-product, roughness and GGX-denominator clamp
MIN_EPS, MAX_EPS = 0.001, 0.02  # the synthesized photos' direction bounds
FIXED_LIGHT_DISTANCE = 2.197
N_RANDOM_SCENES, N_SPECULAR_SCENES = 3, 6


class Scene(NamedTuple):
    camera_pos: torch.Tensor  # (..., 3)
    light_pos: torch.Tensor  # (..., 3)
    light_color: torch.Tensor  # (..., 3)


def cat_scenes(scenes, dim: int) -> Scene:
    return Scene(*(torch.cat([getattr(s, f) for s in scenes], dim)
                   for f in Scene._fields))


# --- Codecs: (..., H, W, 12) = [normals | diffuse | roughness | specular] --

def unpack(svbrdf: torch.Tensor):
    return (svbrdf[..., 0:3], svbrdf[..., 3:6], svbrdf[..., 6:9],
            svbrdf[..., 9:12])


def pack(normals, diffuse, roughness, specular) -> torch.Tensor:
    return torch.cat([normals, diffuse, roughness, specular], dim=-1)


def decode_u8_svbrdf(sv: torch.Tensor) -> torch.Tensor:
    """Strip bytes (..., 12) -> f32 maps, normals in [-1, 1]."""
    f = sv.float() / 255.0
    return torch.cat([f[..., :3] * 2.0 - 1.0, f[..., 3:]], dim=-1)


def head_to_svbrdf(sv9: torch.Tensor) -> torch.Tensor:
    """(..., 9) network head -> tanh -> (..., 12) maps: normal (3 nx, 3 ny,
    1) normalized, roughness replicated, colour maps to [0, 1]."""
    x = torch.tanh(sv9.float())
    nxy, diffuse, rough, spec = (x[..., 0:2], x[..., 2:5], x[..., 5:6],
                                 x[..., 6:9])
    n = torch.cat([nxy * 3.0, torch.ones_like(nxy[..., :1])], dim=-1)
    n = n / torch.sqrt(torch.sum(n * n, dim=-1, keepdim=True))
    unit = lambda v: (v + 1.0) / 2.0  # noqa: E731
    return pack(n, unit(diffuse), unit(rough.repeat_interleave(3, dim=-1)),
                unit(spec))


# --- The local renderer -----------------------------------------------------

def _dot(a, b):
    return torch.sum(a * b, dim=-1, keepdim=True)


def _normalize(a):
    return a / torch.sqrt(_dot(a, a))


def patch_coords(height: int, width: int, device) -> torch.Tensor:
    """(H, W, 3) points of the 2x2 patch at z = 0; row 0 is y = +1."""
    xs = torch.linspace(-1.0, 1.0, width, device=device)
    ys = -torch.linspace(-1.0, 1.0, height, device=device)
    return torch.stack([xs[None, :].expand(height, width),
                        ys[:, None].expand(height, width),
                        torch.zeros(height, width, device=device)], dim=-1)


def brdf(wi, wo, normals, diffuse, roughness, specular):
    """Cook-Torrance: GGX D (chi+, clamped denominator), Schlick F, the
    Smith G1 product, and (1 - F) Lambert diffuse."""
    h = _normalize((wi + wo) / 2.0)
    nh = torch.clamp(_dot(normals, h), min=_EPS)
    vh = torch.clamp(_dot(wo, h), min=_EPS)
    lh = torch.clamp(_dot(wi, h), min=_EPS)
    vn = torch.clamp(_dot(wo, normals), min=_EPS)
    ln = torch.clamp(_dot(wi, normals), min=_EPS)
    a2 = (roughness ** 2) ** 2
    f = specular + (1.0 - specular) * (1.0 - vh) ** 5

    def g1(xh, xn):
        xn2 = xn ** 2
        return 2.0 * (xh / xn > 0).float() / (
            1.0 + torch.sqrt(1.0 + a2 * (1.0 - xn2) / xn2))

    nh2 = nh ** 2
    denom = torch.clamp(nh2 * (a2 + (1.0 - nh2) / nh2), min=_EPS)
    d = a2 * (nh > 0).float() / (math.pi * denom ** 2)
    return (1.0 - f) * diffuse / math.pi + f * g1(vh, vn) * g1(lh, ln) * d / (
        4.0 * vn * ln)


def render(scene: Scene, svbrdf: torch.Tensor) -> torch.Tensor:
    """Radiance (..., H, W, 3) of svbrdf (..., H, W, 12) under point-light
    scenes whose fields broadcast against its leading axes."""
    coords = patch_coords(svbrdf.shape[-3], svbrdf.shape[-2], svbrdf.device)
    cam = scene.camera_pos[..., None, None, :]
    light = scene.light_pos[..., None, None, :]
    color = scene.light_color[..., None, None, :]
    normals, diffuse, roughness, specular = unpack(svbrdf)
    wo = _normalize(cam - coords)
    rel = light - coords
    wi = _normalize(rel)
    f = brdf(wi, wo, normals, diffuse, torch.clamp(roughness, min=_EPS),
             specular)
    return f * color / _dot(rel, rel) * torch.clamp(_dot(wi, normals), min=0)


# --- Samplers -----------------------------------------------------------------

def _uniform(shape, lo, hi, gen, device):
    return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device)


def _normal(shape, gen, device):
    return torch.randn(shape, generator=gen, device=device)


def hemisphere(shape, min_eps, max_eps, gen, device) -> torch.Tensor:
    """Cosine-weighted unit directions: r1 ~ U(min_eps, 1 - max_eps),
    phi = 2 pi U(0, 1), (sqrt(r1) cos phi, sqrt(r1) sin phi, sqrt(1 - r1))."""
    shape = tuple(shape)
    r1 = _uniform(shape + (1,), min_eps, 1.0 - max_eps, gen, device)
    r2 = _uniform(shape + (1,), 0.0, 1.0, gen, device)
    r, phi = torch.sqrt(r1), 2.0 * math.pi * r2
    return torch.cat([r * torch.cos(phi), r * torch.sin(phi),
                      torch.sqrt(1.0 - r1)], dim=-1)


def loss_scenes(batch: int, gen, device) -> Scene:
    """(B, 3 + 6, 3): 3 random view/light pairs (colour 20), then 6 mirror
    configurations with log-normal distances and a shared xy shift (colour
    50)."""
    shape = (batch, N_RANDOM_SCENES)
    view = hemisphere(shape, 0.001, 0.1, gen, device)
    light = hemisphere(shape, 0.001, 0.1, gen, device)
    rand = Scene(view, light, torch.full(shape + (3,), 20.0, device=device))
    shape = (batch, N_SPECULAR_SCENES)
    view = hemisphere(shape, 0.001, 0.1, gen, device)
    light = view * torch.tensor([-1.0, -1.0, 1.0], device=device)
    dv = torch.exp(0.5 + 0.75 * _normal(shape + (1,), gen, device))
    dl = torch.exp(0.5 + 0.75 * _normal(shape + (1,), gen, device))
    shift = torch.cat([_uniform(shape + (2,), -1.0, 1.0, gen, device),
                       torch.full(shape + (1,), 1e-4, device=device)], -1)
    spec = Scene(view * dv + shift, light * dl + shift,
                 torch.full(shape + (3,), 50.0, device=device))
    return cat_scenes([rand, spec], 1)


def input_scenes(batch: int, count: int, gen, device) -> Scene:
    """The synthesized photos' scenes with augmentation: a flash near the
    view for photo 0, hemisphere directions for the others; flash
    intensity |N(20, exp(N(-2, 0.5)))|, white balance |N(1, 0.03)|, view
    distance U(0.25, 2.75)."""
    first_light = torch.cat(
        [_uniform((batch, 1, 2), -0.75, 0.75, gen, device),
         torch.full((batch, 1, 1), FIXED_LIGHT_DISTANCE, device=device)], -1)
    light = torch.cat([first_light, hemisphere(
        (batch, count - 1), MIN_EPS, MAX_EPS, gen, device)
        * FIXED_LIGHT_DISTANCE], dim=1)
    std = torch.exp(-2.0 + 0.5 * _normal((batch, 1, 1), gen, device))
    intensity = torch.abs(20.0 + std * _normal((batch, count, 1), gen,
                                               device))
    white = torch.abs(1.0 + 0.03 * _normal((batch, count, 3), gen, device))
    distance = _uniform((batch, count, 1), 0.25, 2.75, gen, device)
    first_view = torch.cat([_uniform((batch, 1, 2), -0.25, 0.25, gen,
                                     device), distance[:, :1]], dim=-1)
    view = torch.cat([first_view, hemisphere(
        (batch, count - 1), MIN_EPS, MAX_EPS, gen, device)
        * distance[:, 1:]], dim=1)
    return Scene(view, light, intensity * white)


# --- Batch preparation ----------------------------------------------------------

def mix(a: torch.Tensor, b: torch.Tensor, alpha: torch.Tensor):
    """alpha a + (1 - alpha) b; normals blended as slopes (over their
    z clamped at 0.01) and renormalized."""
    na, da, ra, sa = unpack(a)
    nb, db, rb, sb = unpack(b)
    n = (alpha * (na / torch.clamp(na[..., 2:3], min=0.01))
         + (1.0 - alpha) * (nb / torch.clamp(nb[..., 2:3], min=0.01)))
    n = n / torch.sqrt(torch.sum(n * n, dim=-1, keepdim=True))
    lerp = lambda x, y: alpha * x + (1.0 - alpha) * y  # noqa: E731
    return pack(n, lerp(da, db), lerp(ra, rb), lerp(sa, sb))


def prepare(svbrdf_u8: torch.Tensor, partner_u8: torch.Tensor, views: int,
            gen) -> tuple:
    """A maps-only batch (B, H, W, 12) bytes and its mixing partners ->
    (photos (B, views, H, W, 3) linear, target maps (B, H, W, 12)): mix
    with alpha ~ U(0.1, 0.9), then synthesize `views` flash photos with
    log-normal noise, clamped to [0, 1]."""
    device = svbrdf_u8.device
    batch, height, width, _ = svbrdf_u8.shape
    alpha = _uniform(batch, 0.1, 0.9, gen, device)
    scenes = input_scenes(batch, views, gen, device)
    noise_std = torch.exp(math.log(0.005) + 0.3 * _normal(
        (batch, views, 1, 1, 1), gen, device))
    noise = _normal((batch, views, height, width, 3), gen, device)
    maps = mix(decode_u8_svbrdf(svbrdf_u8), decode_u8_svbrdf(partner_u8),
               alpha.reshape(-1, 1, 1, 1))
    photos = render(scenes, maps[:, None])
    return torch.clamp(photos + noise_std * noise, 0.0, 1.0), maps


# --- Losses -------------------------------------------------------------------

def l1(a, b):
    return torch.mean(torch.abs(a - b))


def svbrdf_l1(pred, target):
    """L1 of normals and roughness, and of log(x + 0.01) of diffuse and
    specular: the sum of the four means."""
    p, t = unpack(pred), unpack(target)
    log = lambda x: torch.log(x + EPSILON_L1)  # noqa: E731
    return (l1(p[0], t[0]) + l1(log(p[1]), log(t[1])) + l1(p[2], t[2])
            + l1(log(p[3]), log(t[3])))


def rendering_loss(pred, target, scenes: Scene, render_fn=None):
    """L1 of log(render + 0.1) of pred and target under (B, S) scenes."""
    render_fn = render_fn or render
    return l1(torch.log(render_fn(scenes, pred[:, None]) + EPSILON_RENDER),
              torch.log(render_fn(scenes, target[:, None]) + EPSILON_RENDER))


def loss(kind: str, pred, target, scenes, l1_weight: float = 0.1,
         render_fn=None):
    """'mixed' (l1_weight * svbrdf_l1 + rendering) or 'rendering'."""
    value = rendering_loss(pred, target, scenes, render_fn)
    if kind == "mixed":
        value = value + l1_weight * svbrdf_l1(pred, target)
    return value
