"""Differentiable patch-sample path tracer (area-light Monte Carlo), plain
torch ops.

Counterpart of svbrdf_tpu/ops/pathtrace.py. The scene class is a flat 2x2
SVBRDF patch at z=0, one pixel to one patch point (the local renderer's
coordinates), lit by a 0.6 x 0.6 quad area light aimed at the origin. The
BRDF is a normalized Blinn microfacet lobe with Schlick Fresnel, a
Smith-Blinn G1 product and (1 - F) Lambert diffuse; GGX roughness maps
enter as mean-channel ** 4. The patch-sample camera has no visibility
discontinuities, so the Monte-Carlo shading estimator is differentiated
directly; the backward pass runs an independent lower-spp estimator
(16 forward, 8 backward samples by default), which keeps it unbiased.

Sampling is split from the shading: torch cannot reproduce jax.random, so
`_shade` takes the samples it is given (`Samples`: per-item stratified
offsets and a per-pixel Cranley-Patterson shift), and a test can hand it
exactly the samples the JAX package draws. `draw_render_samples` draws both
estimators' samples from a torch.Generator in one fixed order: forward
offsets, forward shift, backward offsets, backward shift.

Every clamp is a maximum then a minimum (`_clip`), as jnp.clip is: at a
tie with a bound the gradient splits evenly, where torch.clamp would pass
it whole. Each op runs in the dtype the JAX package's runs in: a bf16
SVBRDF gives bf16 coordinates, maps and Blinn exponents, promoted to f32
where they meet the f32 scenes and samples.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from svbrdf_tpu_torch.ops import codecs
from svbrdf_tpu_torch.ops.render import dot, normalize
from svbrdf_tpu_torch.scene import Scene

_PI = math.pi
LIGHT_SIZE = (0.6, 0.6)   # quad light extent (read at call time)
_EPS = 1e-4


class Samples(NamedTuple):
    """One estimator's samples: offsets (spp,) + batch_shape + (2,) in
    [-0.5, 0.5]^2, shift batch_shape + (H, W, 2) in [0, 1)."""

    offsets: torch.Tensor
    shift: torch.Tensor


class RenderSamples(NamedTuple):
    """The forward estimator's samples and the backward one's."""

    forward: Samples
    backward: Samples


def _clip(x: torch.Tensor, lo=None, hi=None) -> torch.Tensor:
    """jnp.clip: max with lo, then min with hi (ties split the gradient)."""
    if lo is not None:
        x = torch.maximum(x, x.new_tensor(lo))
    if hi is not None:
        x = torch.minimum(x, x.new_tensor(hi))
    return x


def _integer_pow(x: torch.Tensor, n: int) -> torch.Tensor:
    """x ** n by repeated squaring, as lax.integer_pow multiplies."""
    acc = None
    while n:
        if n & 1:
            acc = x if acc is None else acc * x
        n >>= 1
        if n:
            x = x * x
    return acc


def _linspace(num: int, dtype, device) -> torch.Tensor:
    """jnp.linspace(-1, 1, num, dtype): start * (1 - step) + stop * step
    in `dtype` with step = iota / div rounded from f32. In bf16 it gives
    JAX's values exactly (torch.linspace differs by up to two bf16 ulps);
    in f32 within one ulp."""
    div = num - 1
    step = (torch.arange(div, dtype=torch.float32, device=device)
            / div).to(dtype)
    head = -1.0 * (1 - step) + 1.0 * step
    return torch.cat([head, torch.ones(1, dtype=dtype, device=device)])


def _patch_coords(height: int, width: int, dtype, device) -> torch.Tensor:
    """render.patch_coords with JAX's linspace values: (H, W, 3)."""
    xs = _linspace(width, dtype, device)
    ys = -_linspace(height, dtype, device)
    xg = xs[None, :].expand(height, width)
    yg = ys[:, None].expand(height, width)
    return torch.stack([xg, yg, torch.zeros_like(xg)], dim=-1)


def _light_frame(light_pos: torch.Tensor):
    """Orthonormal frame (n, t, b) of the quad light; n aims at the
    origin."""
    n = normalize(-light_pos)
    up = light_pos.new_tensor([0.0, 0.0, 1.0]).expand(light_pos.shape)
    t = torch.linalg.cross(n, up)
    t_norm = torch.sqrt(dot(t, t))
    # Fallback tangent when the normal is parallel to z.
    t = torch.where(t_norm > 1e-6, t / _clip(t_norm, 1e-6),
                    light_pos.new_tensor([1.0, 0.0, 0.0]).expand(t.shape))
    b = torch.linalg.cross(n, t)
    return n, t, b


def _stratified_offsets(generator, spp: int,
                        batch_shape: Tuple[int, ...] = (),
                        device=None) -> torch.Tensor:
    """(spp,) + batch_shape + (2,) jittered-stratified samples in
    [-0.5, 0.5]^2: a side x side grid (side = isqrt(spp)) with a jitter per
    cell and batch element, then spp - side^2 pure-uniform samples.
    Draws the jitter, then the extra samples, from `generator`."""
    side = max(1, math.isqrt(spp))
    n_strat = side * side
    cell = 1.0 / side
    grid = (torch.arange(side, dtype=torch.float32, device=device) + 0.5) \
        * cell - 0.5
    base = torch.stack(torch.meshgrid(grid, grid, indexing="ij"),
                       dim=-1).reshape((n_strat,) + (1,) * len(batch_shape)
                                       + (2,))
    jitter = (torch.rand((n_strat,) + tuple(batch_shape) + (2,),
                         generator=generator, device=device) - 0.5) * cell
    samples = base + jitter
    if spp > n_strat:
        extra = torch.rand((spp - n_strat,) + tuple(batch_shape) + (2,),
                           generator=generator, device=device) - 0.5
        samples = torch.cat([samples, extra], dim=0)
    return samples


def _draw_samples(generator, spp: int, batch_shape, height: int, width: int,
                 device=None) -> Samples:
    """One estimator's samples: the offsets, then the per-pixel shift."""
    offsets = _stratified_offsets(generator, spp, tuple(batch_shape), device)
    shift = torch.rand(tuple(batch_shape) + (height, width, 2),
                       generator=generator, device=device)
    return Samples(offsets, shift)


def draw_render_samples(generator, spp: Tuple[int, int], batch_shape,
                        height: int, width: int,
                        device=None) -> RenderSamples:
    """Both estimators' samples, drawn in the order forward offsets,
    forward shift, backward offsets, backward shift."""
    return RenderSamples(
        _draw_samples(generator, spp[0], batch_shape, height, width, device),
        _draw_samples(generator, spp[1], batch_shape, height, width, device))


def _batch_shape(scene: Scene, svbrdf: torch.Tensor) -> Tuple[int, ...]:
    """The leading shape the scene fields and the SVBRDF broadcast to."""
    return tuple(torch.broadcast_shapes(scene.camera_pos.shape[:-1],
                                        scene.light_pos.shape[:-1],
                                        scene.light_color.shape[:-1],
                                        svbrdf.shape[:-3]))


def _blinn_smith_g1(xn, exponent):
    """Smith masking for the Blinn-Phong NDF (Walter et al. 2007 §5.3):
    Beckmann-equivalent width a = sqrt(0.5 e + 1) cos / sin, the rational
    fit below a = 1.6 and 1 above."""
    cos_t = _clip(xn, _EPS, 1.0)
    sin_t = torch.sqrt(_clip(1.0 - cos_t * cos_t, 1e-12, 1.0))
    a = torch.sqrt(0.5 * exponent + 1.0) * cos_t / sin_t
    rational = ((3.535 * a + 2.181 * a * a)
                / (1.0 + 2.276 * a + 2.577 * a * a))
    return torch.where(a < 1.6, rational, torch.ones_like(rational))


def _blinn_brdf(wi, wo, normals, diffuse, roughness_blinn, specular):
    """Normalized Blinn microfacet (exponent e = 2/r - 2) + Schlick Fresnel
    + (1 - F) Lambert."""
    h = normalize(wi + wo)
    nh = _clip(dot(normals, h), _EPS, 1.0)
    vh = _clip(dot(wo, h), _EPS, 1.0)
    nv = _clip(dot(normals, wo), _EPS, 1.0)
    nl = _clip(dot(normals, wi), _EPS, 1.0)

    r = _clip(roughness_blinn, 1e-4, 1.0)
    exponent = 2.0 / r - 2.0
    d = (exponent + 2.0) / (2.0 * _PI) * torch.pow(nh, exponent)

    f = specular + (1.0 - specular) * _integer_pow(1.0 - vh, 5)

    g = _blinn_smith_g1(nv, exponent) * _blinn_smith_g1(nl, exponent)

    spec = f * g * d / (4.0 * nv * nl)
    diff = (1.0 - f) * diffuse / _PI
    return diff + spec


def ggx_to_blinn_roughness(roughness: torch.Tensor) -> torch.Tensor:
    """GGX roughness map (3 channels) -> Blinn roughness (1): mean ** 4."""
    return _integer_pow(
        torch.mean(_clip(roughness, 0.001), dim=-1, keepdim=True), 4)


class _Geometry(NamedTuple):
    """What every sample of one render shares."""

    coords: torch.Tensor
    normals: torch.Tensor
    diffuse: torch.Tensor
    rough_blinn: torch.Tensor
    specular: torch.Tensor
    cam: torch.Tensor
    light: torch.Tensor
    wo: torch.Tensor
    n_l: torch.Tensor
    t_l: torch.Tensor
    b_l: torch.Tensor
    emission: torch.Tensor


# The _Geometry fields a sample's contribution reads and differentiates.
_SAMPLED = ("normals", "diffuse", "rough_blinn", "specular", "light", "wo",
            "n_l", "t_l", "b_l", "emission")


def _geometry(scene: Scene, svbrdf: torch.Tensor) -> _Geometry:
    height, width = svbrdf.shape[-3], svbrdf.shape[-2]
    coords = _patch_coords(height, width, svbrdf.dtype, svbrdf.device)
    maps = codecs.unpack_svbrdf(svbrdf)
    cam = scene.camera_pos[..., None, None, :]
    light = scene.light_pos[..., None, None, :]
    color = scene.light_color[..., None, None, :]
    n_l, t_l, b_l = _light_frame(light)
    # L_e chosen so that the area -> 0 limit matches a point light of the
    # same intensity.
    emission = color / (LIGHT_SIZE[0] * LIGHT_SIZE[1])
    return _Geometry(coords, maps.normals, maps.diffuse,
                     ggx_to_blinn_roughness(maps.roughness), maps.specular,
                     cam, light, normalize(cam - coords), n_l, t_l, b_l,
                     emission)


def _sample_contrib(geo: _Geometry, offset: torch.Tensor,
                    shift: torch.Tensor) -> torch.Tensor:
    """One sample's radiance, (..., H, W, 3): offset batch_shape + (2,)
    rotated toroidally by the pixel's shift."""
    u = offset[..., None, None, :] + 0.5 + shift
    u = u - torch.floor(u) - 0.5
    q = (geo.light + u[..., 0:1] * LIGHT_SIZE[0] * geo.t_l
         + u[..., 1:2] * LIGHT_SIZE[1] * geo.b_l)
    rel = q - geo.coords
    dist_sq = dot(rel, rel)
    wi = rel / torch.sqrt(dist_sq)
    cos_surf = _clip(dot(wi, geo.normals), 0.0)
    cos_light = _clip(dot(-wi, geo.n_l), 0.0)
    f = _blinn_brdf(wi, geo.wo, geo.normals, geo.diffuse, geo.rough_blinn,
                    geo.specular)
    area = LIGHT_SIZE[0] * LIGHT_SIZE[1]
    return f * geo.emission * cos_surf * cos_light / dist_sq * area


def _occlude(geo: _Geometry, radiance: torch.Tensor) -> torch.Tensor:
    """Camera rays that the light quad blocks see its emitting front face,
    or nothing (its back face); the others see `radiance`."""
    coords, cam, light, n_l = geo.coords, geo.cam, geo.light, geo.n_l
    to_cam = cam - coords
    denom = dot(to_cam, n_l)
    facing = torch.abs(denom) > 1e-6
    t_hit = torch.where(
        facing, dot(light - coords, n_l) / torch.where(
            facing, denom, torch.ones_like(denom)),
        -torch.ones_like(denom))
    hit_p = coords + t_hit * to_cam
    local_t = dot(hit_p - light, geo.t_l)
    local_b = dot(hit_p - light, geo.b_l)
    blocked = ((t_hit > 0.0) & (t_hit < 1.0)
               & (torch.abs(local_t) <= LIGHT_SIZE[0] / 2)
               & (torch.abs(local_b) <= LIGHT_SIZE[1] / 2))
    sees_front = dot(-normalize(to_cam), n_l) < 0.0
    emission = geo.emission
    return torch.where(blocked,
                       torch.where(sees_front, emission,
                                   torch.zeros_like(emission)),
                       radiance)


def _shade(scene: Scene, svbrdf: torch.Tensor, offsets: torch.Tensor,
           shift: torch.Tensor) -> torch.Tensor:
    """Direct-lighting MC estimate from the given samples, (..., H, W, 3):
    the mean of the samples' contributions, one sample at a time into one
    buffer."""
    geo = _geometry(scene, svbrdf)
    total = None
    for k in range(offsets.shape[0]):
        c = _sample_contrib(geo, offsets[k], shift)
        total = c if total is None else total + c
    return _occlude(geo, total / offsets.shape[0])


class _RenderMC(torch.autograd.Function):
    """Forward: _shade on the forward samples. Backward: the VJP of _shade
    on the backward samples (an independent estimator), one sample's
    autograd graph at a time, for the SVBRDF and each scene tensor that
    needs a gradient. The samples get none."""

    @staticmethod
    def forward(ctx, svbrdf, camera_pos, light_pos, light_color,
                fwd_offsets, fwd_shift, bwd_offsets, bwd_shift):
        ctx.save_for_backward(svbrdf, camera_pos, light_pos, light_color,
                              bwd_offsets, bwd_shift)
        return _shade(Scene(camera_pos, light_pos, light_color), svbrdf,
                      fwd_offsets, fwd_shift)

    @staticmethod
    def backward(ctx, g):
        *inputs, offsets, shift = ctx.saved_tensors
        needs = ctx.needs_input_grad[:4]
        with torch.enable_grad():
            leaves = [x.detach().requires_grad_(need)
                      for x, need in zip(inputs, needs)]
            geo = _geometry(Scene(*leaves[1:]), leaves[0])
            # The sampled radiance's cotangent: none where the light quad
            # blocks the camera ray.
            radiance = torch.zeros_like(g, requires_grad=True)
            out = _occlude(geo, radiance)
            (d_radiance,) = torch.autograd.grad(out, radiance, g,
                                                retain_graph=True)
            d_sample = d_radiance / offsets.shape[0]
            # Per sample, the gradient with respect to the shared geometry
            # (detached), summed in f32; then one pass through the geometry.
            fields = [f for f in _SAMPLED if getattr(geo, f).requires_grad]
            detached = geo._replace(**{
                f: getattr(geo, f).detach().requires_grad_()
                for f in fields})
            sums = [None] * len(fields)
            for k in range(offsets.shape[0]):
                c = _sample_contrib(detached, offsets[k], shift)
                grads = torch.autograd.grad(
                    c, [getattr(detached, f) for f in fields], d_sample)
                sums = [gk.float() if s is None else s + gk
                        for s, gk in zip(sums, grads)]
            wanted = [x for x in leaves if x.requires_grad]
            grads = iter(torch.autograd.grad(
                [out] + [getattr(geo, f) for f in fields], wanted,
                [g] + [s.to(getattr(geo, f).dtype)
                       for s, f in zip(sums, fields)],
                allow_unused=True))
        result = [next(grads) if need else None for need in needs]
        result = [torch.zeros_like(x) if need and r is None else r
                  for x, need, r in zip(inputs, needs, result)]
        return (*result, None, None, None, None)


def render_mc(scene: Scene, svbrdf: torch.Tensor,
              samples: RenderSamples) -> torch.Tensor:
    """The path-traced render on the given samples, differentiable in the
    SVBRDF and the scene."""
    fwd, bwd = samples
    return _RenderMC.apply(svbrdf, scene.camera_pos, scene.light_pos,
                           scene.light_color, fwd.offsets, fwd.shift,
                           bwd.offsets, bwd.shift)


def render(scene: Scene, svbrdf: torch.Tensor, generator=None,
           spp: Tuple[int, int] = (16, 8)) -> torch.Tensor:
    """Render under the quad-light path-traced model: the same (Scene,
    svbrdf (..., H, W, 12)) -> (..., H, W, 3) protocol as render.render.
    Samples come from `generator`, or without one from a generator seeded
    with 0 (the same samples every call)."""
    return make_render_fn(spp)(scene, svbrdf, generator=generator)


def make_render_fn(spp: Tuple[int, int] = (16, 8), seed: int = 0):
    """Renderer-protocol closure render_fn(scene, svbrdf, generator=None,
    samples=None). Given samples it renders on them; else it draws them
    (draw_render_samples) from `generator`, so that a caller who threads
    its generator gets fresh samples every call, or, without one, from a
    generator seeded with `seed`, the same samples every call."""

    def render_fn(scene: Scene, svbrdf: torch.Tensor, generator=None,
                  samples=None) -> torch.Tensor:
        if samples is None:
            if generator is None:
                generator = torch.Generator(
                    device=svbrdf.device).manual_seed(seed)
            samples = draw_render_samples(
                generator, spp, _batch_shape(scene, svbrdf),
                svbrdf.shape[-3], svbrdf.shape[-2], svbrdf.device)
        return render_mc(scene, svbrdf, samples)

    # The rendering loss passes its generator to renderers that declare it
    # (losses._render_fn_accepts_generator).
    render_fn.accepts_generator = True
    return render_fn


class PathTracingRenderer:
    """Protocol-compatible wrapper: render(scene, svbrdf[, generator])."""

    def __init__(self, spp: Tuple[int, int] = (16, 8), seed: int = 0):
        self._fn = make_render_fn(spp, seed)

    def render(self, scene: Scene, svbrdf: torch.Tensor, generator=None,
               samples=None) -> torch.Tensor:
        return self._fn(scene, svbrdf, generator=generator, samples=samples)
