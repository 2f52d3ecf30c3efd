"""Plain reference of the path-traced rendering loss's renderer.

A flat 2x2 SVBRDF patch lit by a 0.6 x 0.6 quad area light aimed at the
origin, one pixel to one patch point, shaded by direct-lighting Monte
Carlo: a normalized Blinn lobe (exponent 2 / r - 2, r the mean GGX
roughness to the fourth), Schlick Fresnel, the Smith-Blinn G1 product
(Walter et al. 2007's rational fit) and (1 - F) Lambert. The forward value
is the estimate on the forward samples; the gradient is that of an
independent estimate on the backward samples (16 and 8 samples a pixel in
training), as the method defines its loss's gradient. Camera rays that the
quad blocks see its emitting front face or nothing.

The samples are drawn from the step's generator in the training step's
order (forward offsets, forward shift, backward offsets, backward shift):
per (item, scene) jittered-stratified offsets in [-0.5, 0.5]^2 plus pure
uniform ones beyond the square, and a per-pixel Cranley-Patterson shift.
Plain torch in float64 (in f32 the light's cosines at grazing samples
and 1 - n.h near the lobe's peak lose most of their digits), one sample
at a time, so a full-width render fits; the render and the gradient come
back in the SVBRDF's dtype.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from bench_gpu.reference.maps import Scene, unpack

LIGHT_SIZE = 0.6
_EPS = 1e-4


class Samples(NamedTuple):
    offsets: torch.Tensor  # (spp, B, S, 2)
    shift: torch.Tensor  # (B, S, H, W, 2)


def _offsets(gen, spp: int, batch_shape, device) -> torch.Tensor:
    side = max(1, math.isqrt(spp))
    cell = 1.0 / side
    grid = (torch.arange(side, dtype=torch.float32, device=device)
            + 0.5) * cell - 0.5
    base = torch.stack(torch.meshgrid(grid, grid, indexing="ij"), -1)
    base = base.reshape((side * side,) + (1,) * len(batch_shape) + (2,))
    jitter = (torch.rand((side * side,) + tuple(batch_shape) + (2,),
                         generator=gen, device=device) - 0.5) * cell
    out = base + jitter
    if spp > side * side:
        extra = torch.rand((spp - side * side,) + tuple(batch_shape) + (2,),
                           generator=gen, device=device) - 0.5
        out = torch.cat([out, extra], dim=0)
    return out


def draw_samples(gen, spp, batch_shape, height, width, device) -> tuple:
    """(forward Samples, backward Samples) for spp = (forward, backward)."""
    out = []
    for n in spp:
        offsets = _offsets(gen, n, batch_shape, device)
        shift = torch.rand(tuple(batch_shape) + (height, width, 2),
                           generator=gen, device=device)
        out.append(Samples(offsets, shift))
    return tuple(out)


def _dot(a, b):
    return torch.sum(a * b, dim=-1, keepdim=True)


def _normalize(a):
    return a / torch.sqrt(_dot(a, a))


def _clip(x, lo=None, hi=None):
    """Maximum, then minimum (at a tie the gradient splits evenly)."""
    if lo is not None:
        x = torch.maximum(x, x.new_tensor(lo))
    if hi is not None:
        x = torch.minimum(x, x.new_tensor(hi))
    return x


def _coords(height, width, like):
    """Patch points: x = -1 + 2 col / (W - 1), y = 1 - 2 row / (H - 1)."""
    arange = lambda n: torch.arange(n, dtype=like.dtype,  # noqa: E731
                                    device=like.device)
    xs = -1.0 + 2.0 * arange(width) / (width - 1)
    ys = 1.0 - 2.0 * arange(height) / (height - 1)
    return torch.stack([xs[None, :].expand(height, width),
                        ys[:, None].expand(height, width),
                        like.new_zeros(height, width)], -1)


def _light_frame(light):
    n = _normalize(-light)
    up = light.new_tensor([0.0, 0.0, 1.0]).expand(light.shape)
    t = torch.linalg.cross(n, up)
    tn = torch.sqrt(_dot(t, t))
    t = torch.where(tn > 1e-6, t / _clip(tn, 1e-6),
                    light.new_tensor([1.0, 0.0, 0.0]).expand(t.shape))
    return n, t, torch.linalg.cross(n, t)


def _g1(xn, exponent):
    cos = _clip(xn, _EPS, 1.0)
    sin = torch.sqrt(_clip(1.0 - cos * cos, 1e-12, 1.0))
    a = torch.sqrt(0.5 * exponent + 1.0) * cos / sin
    fit = (3.535 * a + 2.181 * a * a) / (1.0 + 2.276 * a + 2.577 * a * a)
    return torch.where(a < 1.6, fit, torch.ones_like(fit))


def _blinn(wi, wo, normals, diffuse, rough, specular):
    h = _normalize(wi + wo)
    nh = _clip(_dot(normals, h), _EPS, 1.0)
    vh = _clip(_dot(wo, h), _EPS, 1.0)
    nv = _clip(_dot(normals, wo), _EPS, 1.0)
    nl = _clip(_dot(normals, wi), _EPS, 1.0)
    e = 2.0 / _clip(rough, 1e-4, 1.0) - 2.0
    d = (e + 2.0) / (2.0 * math.pi) * torch.pow(nh, e)
    f = specular + (1.0 - specular) * (1.0 - vh) ** 5
    spec = f * _g1(nv, e) * _g1(nl, e) * d / (4.0 * nv * nl)
    return (1.0 - f) * diffuse / math.pi + spec


class _Setup(NamedTuple):
    coords: torch.Tensor
    normals: torch.Tensor
    diffuse: torch.Tensor
    rough: torch.Tensor
    specular: torch.Tensor
    cam: torch.Tensor
    light: torch.Tensor
    n_l: torch.Tensor
    t_l: torch.Tensor
    b_l: torch.Tensor
    emission: torch.Tensor


def _setup(scene: Scene, svbrdf) -> _Setup:
    normals, diffuse, roughness, specular = unpack(svbrdf)
    rough = torch.mean(_clip(roughness, 0.001), dim=-1, keepdim=True) ** 4
    light = scene.light_pos[..., None, None, :]
    n_l, t_l, b_l = _light_frame(light)
    return _Setup(_coords(svbrdf.shape[-3], svbrdf.shape[-2], svbrdf),
                  normals, diffuse, rough, specular,
                  scene.camera_pos[..., None, None, :], light, n_l, t_l, b_l,
                  scene.light_color[..., None, None, :] / LIGHT_SIZE ** 2)


def _sample(s: _Setup, offset, shift):
    u = offset[..., None, None, :] + 0.5 + shift
    u = u - torch.floor(u) - 0.5
    q = (s.light + u[..., 0:1] * LIGHT_SIZE * s.t_l
         + u[..., 1:2] * LIGHT_SIZE * s.b_l)
    rel = q - s.coords
    dist_sq = _dot(rel, rel)
    wi = rel / torch.sqrt(dist_sq)
    wo = _normalize(s.cam - s.coords)
    f = _blinn(wi, wo, s.normals, s.diffuse, s.rough, s.specular)
    return (f * s.emission * _clip(_dot(wi, s.normals), 0.0)
            * _clip(_dot(-wi, s.n_l), 0.0) / dist_sq * LIGHT_SIZE ** 2)


def _occlude(s: _Setup, radiance):
    to_cam = s.cam - s.coords
    denom = _dot(to_cam, s.n_l)
    facing = torch.abs(denom) > 1e-6
    t = torch.where(facing, _dot(s.light - s.coords, s.n_l)
                    / torch.where(facing, denom, torch.ones_like(denom)),
                    -torch.ones_like(denom))
    hit = s.coords + t * to_cam
    lt, lb = _dot(hit - s.light, s.t_l), _dot(hit - s.light, s.b_l)
    blocked = ((t > 0) & (t < 1) & (torch.abs(lt) <= LIGHT_SIZE / 2)
               & (torch.abs(lb) <= LIGHT_SIZE / 2))
    front = _dot(-_normalize(to_cam), s.n_l) < 0
    return torch.where(blocked, torch.where(front, s.emission,
                                            torch.zeros_like(s.emission)),
                       radiance)


def _estimate(scene, svbrdf, samples: Samples):
    s = _setup(scene, svbrdf)
    total = sum(_sample(s, o, samples.shift) for o in samples.offsets)
    return _occlude(s, total / samples.offsets.shape[0])


def _f64(*tensors):
    return [t.detach().double() for t in tensors]


class _Render(torch.autograd.Function):
    """Value on the forward samples, gradient (to the SVBRDF) of the
    estimate on the backward samples, one sample's graph at a time, in
    float64."""

    @staticmethod
    def forward(ctx, svbrdf, cam, light, color, fwd_o, fwd_s, bwd_o, bwd_s):
        ctx.save_for_backward(svbrdf, cam, light, color, bwd_o, bwd_s)
        sv, cam, light, color, fwd_o, fwd_s = _f64(svbrdf, cam, light, color,
                                                  fwd_o, fwd_s)
        with torch.no_grad():
            out = _estimate(Scene(cam, light, color), sv,
                            Samples(fwd_o, fwd_s))
        return out.to(svbrdf.dtype)

    @staticmethod
    def backward(ctx, g):
        svbrdf, *rest = ctx.saved_tensors
        sv, cam, light, color, offsets, shift, g = _f64(svbrdf, *rest, g)
        scene = Scene(cam, light, color)
        grad = torch.zeros_like(sv)
        spp = offsets.shape[0]
        with torch.enable_grad():
            for o in offsets:
                x = sv.requires_grad_(True)
                s = _setup(scene, x)
                r = torch.zeros_like(g, requires_grad=True)
                # The occluded pixels' emission does not depend on the maps.
                (g_r,) = torch.autograd.grad(_occlude(s, r), r, g)
                (d,) = torch.autograd.grad(_sample(s, o, shift), x, g_r / spp)
                grad += d
        return (grad.to(svbrdf.dtype), None, None, None, None, None, None,
                None)


def make_render_fn(samples: tuple):
    """render(scene, svbrdf) on the given (forward, backward) samples."""
    fwd, bwd = samples

    def render_fn(scene: Scene, svbrdf):
        return _Render.apply(svbrdf, scene.camera_pos, scene.light_pos,
                             scene.light_color, fwd.offsets, fwd.shift,
                             bwd.offsets, bwd.shift)

    return render_fn
