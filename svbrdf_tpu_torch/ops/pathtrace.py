"""Differentiable patch-sample path tracer (area-light Monte Carlo), with
CUDA kernels of its own for the card and their plain torch versions.

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

The kernels (csrc/pathtrace.cu; the JAX package's `_shade` and
`_render_mc_bwd` are plain JAX, which XLA fuses): `pathtrace_shade`, the
forward estimator, and `pathtrace_shade_vjp`, the backward estimator's
hand-derived VJP, which sums the gradients of the SVBRDF's maps (and, when
a scene tensor needs one, of wo and the scene fields) over the scenes and
samples. Both take a render's batch as P items of S scenes (`_layout`).
`_RenderMC` launches them for CUDA tensors (`shade_cuda`,
`shade_vjp_cuda`) and runs their plain versions (`shade_plain`,
`shade_vjp_plain`: the per-sample loop and one sample's autograd graph at
a time) for CPU tensors; the geometry, the light quad's occlusion and the
last pass of autograd through them stay torch ops. The kernels are held
to the plain versions at a tolerance (chip_smoke.py); the VJP's line-for-
line transcription `_sample_contrib_vjp_plain` is held to autograd on the
CPU.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Tuple

import torch

from svbrdf_tpu_torch.ops import _build, codecs
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


# The _Geometry fields a sample's contribution reads and differentiates:
# the SVBRDF's four, then the scene's.
_SAMPLED = ("normals", "diffuse", "rough_blinn", "specular", "light", "wo",
            "n_l", "t_l", "b_l", "emission")
_MAP_FIELDS = _SAMPLED[:4]
# The scene fields whose cotangents the VJP kernel sums per (item, scene).
_SCENE_FIELDS = ("light", "n_l", "t_l", "b_l", "emission")


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


# --- The kernels' layout -----------------------------------------------------
#
# The kernels take a render's batch as P items of S scenes each: the SVBRDF
# varies along the items only (the losses render (B, 1) maps under (B, S)
# scenes), each scene field along both. Their inputs, which the plain
# versions take too: coords (H, W, 3) and the maps normals, diffuse,
# rough_blinn, specular (P, H, W, 3 | 1) in the SVBRDF's dtype; light, n_l,
# t_l, b_l, emission and cam (P, S, 3); offsets (spp, P, S, 2) and shift
# (P, S, H, W, 2); the VJP's d_sample (P, S, H, W, 3).


class _Layout(NamedTuple):
    """A render's batch shape, split where the SVBRDF stops varying: the
    leading dims are the kernels' items, the trailing ones their scenes.
    `map_shape` is the SVBRDF's batch shape padded to the batch's rank."""

    batch_shape: Tuple[int, ...]
    split: int
    map_shape: Tuple[int, ...]

    @property
    def items(self) -> int:
        return math.prod(self.batch_shape[:self.split])

    @property
    def scenes(self) -> int:
        return math.prod(self.batch_shape[self.split:])

    def item_shape(self) -> Tuple[int, ...]:
        """The batch shape of a per-item tensor: the items, then 1s."""
        rank = len(self.batch_shape)
        return self.batch_shape[:self.split] + (1,) * (rank - self.split)


def _layout(geo: _Geometry, batch_shape) -> _Layout:
    map_shape = tuple(geo.normals.shape[:-3])
    map_shape = (1,) * (len(batch_shape) - len(map_shape)) + map_shape
    split = len(map_shape)
    while split and map_shape[split - 1] == 1:
        split -= 1
    return _Layout(tuple(batch_shape), split, map_shape)


def _flat_image(x: torch.Tensor, layout: _Layout) -> torch.Tensor:
    """batch_shape + (H, W, c) -> (P, S, H, W, c), contiguous."""
    x = x.expand(layout.batch_shape + tuple(x.shape[-3:]))
    return x.reshape(layout.items, layout.scenes,
                     *x.shape[-3:]).contiguous()


def _flatten(geo: _Geometry, layout: _Layout, offsets: torch.Tensor,
             shift: torch.Tensor) -> tuple:
    """The kernels' inputs (without d_sample) for a render's geometry and
    one estimator's samples."""
    items, scenes = layout.items, layout.scenes

    def per_item(x):
        x = x.reshape(layout.map_shape + tuple(x.shape[-3:]))
        x = x.expand(layout.item_shape() + tuple(x.shape[-3:]))
        return x.reshape(items, *x.shape[-3:]).contiguous()

    def per_scene(x):
        x = x.expand(layout.batch_shape + (1, 1, 3))
        return x.reshape(items, scenes, 3).contiguous()

    spp = offsets.shape[0]
    offsets = offsets.expand((spp,) + layout.batch_shape + (2,))
    return (geo.coords.contiguous(),
            *map(per_item, (geo.normals, geo.diffuse, geo.rough_blinn,
                            geo.specular)),
            *map(per_scene, (geo.light, geo.n_l, geo.t_l, geo.b_l,
                             geo.emission, geo.cam)),
            offsets.reshape(spp, items, scenes, 2).contiguous(),
            _flat_image(shift, layout))


def _unflatten_grad(layout: _Layout, field: str, grad: torch.Tensor,
                    like: torch.Tensor) -> torch.Tensor:
    """A kernel-layout sum for `field` ((P, 1, H, W, c) for a map, (P, S,
    H, W, 3) for wo, (P, S, 3) for the others) as the gradient of the
    geometry's tensor `like`."""
    if field in _MAP_FIELDS:
        grad = grad.reshape(layout.item_shape() + tuple(grad.shape[-3:]))
    elif field == "wo":
        grad = grad.reshape(layout.batch_shape + tuple(grad.shape[-3:]))
    else:
        grad = grad.reshape(layout.batch_shape + (1, 1, 3))
    return grad.sum_to_size(like.shape)


def _flat_geometry(coords, normals, diffuse, rough_blinn, specular, light,
                   n_l, t_l, b_l, emission, cam) -> _Geometry:
    """The _Geometry of the kernels' inputs: the maps (P, 1, H, W, c), the
    scene fields (P, S, 1, 1, 3), wo (P, S, H, W, 3)."""
    def per_scene(x):
        return x[:, :, None, None, :]

    cam = per_scene(cam)
    return _Geometry(coords, normals[:, None], diffuse[:, None],
                     rough_blinn[:, None], specular[:, None], cam,
                     per_scene(light), normalize(cam - coords),
                     per_scene(n_l), per_scene(t_l), per_scene(b_l),
                     per_scene(emission))


# --- Plain versions ----------------------------------------------------------


def shade_plain(coords, normals, diffuse, rough_blinn, specular, light, n_l,
                t_l, b_l, emission, cam, offsets, shift) -> torch.Tensor:
    """The forward estimator on the kernels' inputs: the mean of the
    samples' contributions, one sample at a time into one buffer, (P, S,
    H, W, 3)."""
    geo = _flat_geometry(coords, normals, diffuse, rough_blinn, specular,
                         light, n_l, t_l, b_l, emission, cam)
    total = None
    for k in range(offsets.shape[0]):
        c = _sample_contrib(geo, offsets[k], shift)
        total = c if total is None else total + c
    return total / offsets.shape[0]


def shade_vjp_plain(coords, normals, diffuse, rough_blinn, specular, light,
                    n_l, t_l, b_l, emission, cam, offsets, shift, d_sample,
                    scene_grads: bool = False) -> tuple:
    """The VJP of the sum of the samples' contributions with cotangent
    d_sample, on the kernels' inputs, one sample's autograd graph at a
    time: the sums for normals, diffuse, rough_blinn and specular (P, 1,
    H, W, c), and with `scene_grads` also, in _SAMPLED's order, for light,
    n_l, t_l, b_l, emission (P, S, 3) and wo (P, S, H, W, 3). Sums are f32
    (float64 for float64 inputs)."""
    geo = _flat_geometry(coords, normals, diffuse, rough_blinn, specular,
                         light, n_l, t_l, b_l, emission, cam)
    fields = _SAMPLED if scene_grads else _MAP_FIELDS
    with torch.enable_grad():
        geo = geo._replace(**{f: getattr(geo, f).detach().requires_grad_()
                              for f in fields})
        sums = [None] * len(fields)
        for k in range(offsets.shape[0]):
            c = _sample_contrib(geo, offsets[k], shift)
            grads = torch.autograd.grad(
                c, [getattr(geo, f) for f in fields], d_sample)
            sums = [gk.to(torch.promote_types(gk.dtype, torch.float32))
                    if s is None else s + gk for s, gk in zip(sums, grads)]
    return tuple(s if f in _MAP_FIELDS or f == "wo" else s[:, :, 0, 0]
                 for s, f in zip(sums, fields))


def _pixel_terms(rough_blinn: torch.Tensor, specular: torch.Tensor):
    """The kernels' per-pixel terms (pixel_terms in csrc/pathtrace.cu):
    (r_lo, 1/r, e = 2/r - 2, (e + 2)/(2 pi), sqrt(0.5 e + 1), 1 -
    specular), in f32 (float64 for float64 maps) with each bf16 rounding
    of a bf16 SVBRDF made explicit, where the plain code's bf16 ops
    round."""
    dtype = rough_blinn.dtype
    work = torch.float64 if dtype == torch.float64 else torch.float32

    def rnd(x):
        return x.to(dtype).to(work)

    rough = rough_blinn.to(work)
    r_lo = rnd(torch.tensor(1e-4, dtype=work, device=rough.device))
    r = torch.minimum(torch.maximum(rough, r_lo), rough.new_tensor(1.0))
    inv_r = rnd(torch.reciprocal(r))
    e = rnd(rnd(inv_r * 2.0) - 2.0)
    dn = rnd(rnd(e + 2.0) / (2.0 * _PI))
    sq = rnd(torch.sqrt(rnd(rnd(0.5 * e) + 1.0)))
    oms = rnd(1.0 - specular.to(work))
    return r_lo, inv_r, e, dn, sq, oms


def _max_grad(x, lo):
    """d max(x, lo)/dx as torch.maximum's backward takes it: 1 above (and
    for NaN), 1/2 at a tie, 0 below."""
    return torch.where(x < lo, 0.0, torch.where(x == lo, 0.5, 1.0)).to(
        x.dtype)


def _min_grad(x, hi):
    return torch.where(x > hi, 0.0, torch.where(x == hi, 0.5, 1.0)).to(
        x.dtype)


def _clip_grad(x, lo, hi):
    """d clip(x, lo, hi)/dx: a maximum, then a minimum (_clip)."""
    return _max_grad(x, lo) * _min_grad(torch.maximum(
        x, torch.as_tensor(lo, dtype=x.dtype, device=x.device)), hi)


def _smith_g1_quotient(xn, sq):
    """_blinn_smith_g1 with sqrt(0.5 e + 1) given, as (num, den): the
    rational fit's numerator and denominator below a = 1.6, 1 and 1 above
    (the kernels' smith_g1_quotient)."""
    ct = _clip(xn, _EPS, 1.0)
    st = torch.sqrt(_clip(1.0 - ct * ct, 1e-12, 1.0))
    a = sq * ct / st
    fit = a < 1.6
    one = torch.ones_like(a)
    return (torch.where(fit, 3.535 * a + 2.181 * a * a, one),
            torch.where(fit, 1.0 + 2.276 * a + 2.577 * a * a, one))


def _smith_g1(xn, sq):
    """_blinn_smith_g1 with sqrt(0.5 e + 1) given (the kernels' smith_g1)."""
    num, den = _smith_g1_quotient(xn, sq)
    return num / den


def _smith_g1_vjp(xn, sq, g):
    """The kernels' smith_g1_vjp: (d/d xn, d/d sq) for cotangent g."""
    ct = _clip(xn, _EPS, 1.0)
    s2_raw = 1.0 - ct * ct
    st = torch.sqrt(_clip(s2_raw, 1e-12, 1.0))
    a = sq * ct / st
    num = 3.535 * a + 2.181 * a * a
    den = 1.0 + 2.276 * a + 2.577 * a * a
    g_num = torch.where(a < 1.6, g / den, torch.zeros_like(g))
    g_den = -g_num * (num / den)
    g_a = g_num * (3.535 + 2.0 * (2.181 * a)) + g_den * (
        2.276 + 2.0 * (2.577 * a))
    g_sq = g_a * ct / st
    g_st = -g_a * a / st
    g_s2 = g_st / (2.0 * st)
    g_ct = g_a * sq / st + g_s2 * _clip_grad(s2_raw, 1e-12, 1.0) * (-2.0 * ct)
    return g_ct * _clip_grad(xn, _EPS, 1.0), g_sq


def _fma(a, b, c):
    """a b + c rounded once, as fmaf: through float64 for f32 operands (the
    product is exact there; the sum rounds twice, rarely an ulp off)."""
    if a.dtype == torch.float64:
        return a * b + c
    f64 = torch.float64
    return (a.to(f64) * b.to(f64) + c.to(f64)).to(a.dtype)


def _diff_of_products(a, b, c, d):
    """a b - c d to ~1 ulp (csrc/pathtrace.cu diff_of_products: Kahan's
    difference of products)."""
    w = c * d
    return _fma(a, b, -w) + _fma(-c, d, w)


def _one_minus_nh(n, nlen, x0, hr, rh):
    """1 - n.h for h = hr rh (rh = 1 / |hr|) without the cancellation of 1
    minus a rounded cosine (csrc/pathtrace.cu one_minus_nh): x0 = (1 -
    |n|^2) / (1 + |n|) plus |n x h|^2 / (|n| + n.h), the direct form where
    n.h < |n| / 2. Shapes broadcast over the last axis of 3."""
    nh = dot(n, hr) * rh
    c = torch.stack([_diff_of_products(n[..., 1], hr[..., 2], n[..., 2],
                                       hr[..., 1]),
                     _diff_of_products(n[..., 2], hr[..., 0], n[..., 0],
                                       hr[..., 2]),
                     _diff_of_products(n[..., 0], hr[..., 1], n[..., 1],
                                       hr[..., 0])], dim=-1)
    cc = dot(c, c) * (rh * rh)
    return torch.where(nh < 0.5 * nlen, 1.0 - nh, cc / (nlen + nh) + x0)


def _norm_terms(normals: torch.Tensor, work) -> tuple:
    """(|n|, (1 - |n|^2) / (1 + |n|)) in `work`, 1 - |n|^2 in float64 (the
    kernels' pixel_terms)."""
    n64 = normals.to(torch.float64)
    n2 = dot(n64, n64)
    nlen = torch.sqrt(n2).to(work)
    return nlen, (1.0 - n2).to(work) / (1.0 + nlen)


def _delta(specular: torch.Tensor, oms: torch.Tensor) -> torch.Tensor:
    """(1 - specular) - oms, oms = 1 - specular rounded in the SVBRDF's
    dtype: for a bf16 SVBRDF its rounding, which the diffuse term keeps; 0
    otherwise (the kernels drop f32's, below an ulp)."""
    if specular.dtype != torch.bfloat16:
        return torch.zeros_like(oms)
    return (1.0 - specular.to(oms.dtype)) - oms


def _sample_contrib_vjp_plain(geo: _Geometry, offset: torch.Tensor,
                              shift: torch.Tensor, g: torch.Tensor,
                              work=None) -> tuple:
    """The kernels' forward and hand-derived VJP of _sample_contrib for
    cotangent g, transcribed line for line into torch (csrc/pathtrace.cu:
    view_terms, sample_terms, Sums, channel_sum and sample_vjp, then the
    view's and the pixel's terms, for one sample): (the contribution,
    {field: gradient} for every _SAMPLED field in its shape). The algebra
    has no colour channel per sample: the sample's w, x5 and r and the sums
    W0 = w, W1 = w (1 - x5), R2 = w r (1 - x5), RX = w r x5, with the
    channels applied to the sums. In `work` precision, by default f32
    (float64 for a float64 geometry), after the per-pixel terms, which
    round as the SVBRDF's dtype rounds them (_pixel_terms, _delta); 1 -
    |n|^2 and the cosines' dot products in float64 as the kernels take
    them. The tests hold it against autograd; shade_transcribed evaluates
    the kernels' arithmetic with it."""
    if work is None:
        work = torch.float64 if geo.normals.dtype == torch.float64 \
            else torch.float32
    f64 = torch.float64
    n, coords, light, n_l, t_l, b_l, em, cam = (
        getattr(geo, f).to(work) for f in (
            "normals", "coords", "light", "n_l", "t_l", "b_l", "emission",
            "cam"))
    r_lo, inv_r, e, dn, sq, oms = (x.to(work) for x in _pixel_terms(
        geo.rough_blinn, geo.specular))
    sp = geo.specular.to(work)
    dlt = _delta(geo.specular, oms)
    difp = geo.diffuse.to(work) * (1.0 / _PI)
    nlen, x0 = _norm_terms(geo.normals, work)
    lw, lh = LIGHT_SIZE
    # view_terms: wo, light - coords, n.wo, G1(nv), A; and in float64 the
    # cosines' sample-independent terms.
    rel = cam - coords
    wo = rel * torch.rsqrt(dot(rel, rel))
    lc = light - coords
    nv_raw = dot(n, wo)
    nv = _clip(nv_raw, _EPS, 1.0)
    inv_nv = 1.0 / nv
    g1v = _smith_g1(nv, sq)
    A = (g1v * dn) * (0.25 * inv_nv)
    n64, nl64, lc64 = (x.to(f64) for x in (geo.normals, geo.n_l, geo.light))
    lc64 = lc64 - geo.coords.to(f64)
    t64, b64 = geo.t_l.to(f64), geo.b_l.to(f64)
    sh64 = shift.to(f64)
    nt, nb = lw * dot(n64, t64), lh * dot(n64, b64)
    lt, lb = lw * dot(nl64, t64), lh * dot(nl64, b64)
    cn = dot(n64, lc64) + sh64[..., 0:1] * nt + sh64[..., 1:2] * nb
    cl0 = dot(nl64, lc64) + sh64[..., 0:1] * lt + sh64[..., 1:2] * lb
    # sample_terms: u = offset + 0.5 + shift less its floor in `work`
    off = offset[..., None, None, :]
    u = (off.to(work) + 0.5) + shift.to(work)
    fl = torch.floor(u)
    a0 = ((u[..., 0:1] - fl[..., 0:1]) - 0.5) * lw
    a1 = ((u[..., 1:2] - fl[..., 1:2]) - 0.5) * lh
    rel = lc + a0 * t_l + a1 * b_l
    rsq = torch.rsqrt(dot(rel, rel))
    inv_ds = rsq * rsq
    wi = rel * rsq
    d = off.to(f64) - fl.to(f64)
    cs_raw = (cn + d[..., 0:1] * nt + d[..., 1:2] * nb).to(work) * rsq
    cl_raw = -((cl0 + d[..., 0:1] * lt + d[..., 1:2] * lb).to(work) * rsq)
    cs = _clip(cs_raw, 0.0)
    cl = _clip(cl_raw, 0.0)
    w = (cs * cl) * inv_ds
    hr = wi + wo
    rh = torch.rsqrt(dot(hr, hr))
    vh_raw = dot(wo, hr) * rh
    x = _one_minus_nh(n, nlen, x0, hr, rh)
    # log(clip(1 - x, eps, 1)) without the rounding of 1 - x (log_nh)
    xc = _clip(x, 0.0)
    y = _clip(1.0 - xc, _EPS)
    lg = torch.where(y >= 2.0 / 3.0, torch.log1p(-xc), torch.log(y))
    pw = torch.exp(e * lg)
    xv = 1.0 - _clip(vh_raw, _EPS, 1.0)
    x4 = (xv * xv) * (xv * xv)
    x5 = xv * x4
    nl = _clip(cs_raw, _EPS, 1.0)
    num, den = _smith_g1_quotient(nl, sq)
    q = 1.0 / (den * nl)
    inv_nl = den * q
    g1r = num * q
    r = g1r * pw
    # One sample's sums (Sums) and its radiance (channel_sum).
    W0, W1 = w, w * (1.0 - x5)
    R2, RX = (w * r) * (1.0 - x5), (w * r) * x5
    diffuse_sum = dlt * W0 + oms * W1
    radiance = difp * diffuse_sum + A * (sp * (R2 + RX) + oms * RX)
    area = LIGHT_SIZE[0] * LIGHT_SIZE[1]
    # The cotangent folded with the channels (Coef): ge = g em area.
    g = g.to(work)
    ge = (g * em) * area
    alpha = dot(ge * difp, dlt)
    beta = dot(ge * difp, oms)
    gamma = dot(ge, sp)
    eta = dot(ge, oms)
    gA, eA = gamma * A, eta * A
    # sample_vjp
    gq = eA * x5 + gA
    B = r * gq + (beta * (1.0 - x5) + alpha)
    g_cs = (B * cl) * inv_ds
    wq = w * gq
    t = wq * inv_nl
    g_pw = wq * g1r
    g_nl_g1, g_sq = _smith_g1_vjp(nl, sq, t * pw)
    g_nl = -t * r + g_nl_g1
    g_e = g_pw * pw * lg
    nh = _clip(1.0 - xc, _EPS)
    clip_nh = torch.where(x < 0.0, 0.0, torch.where(x == 0.0, 0.5, 1.0)).to(
        work) * _max_grad(1.0 - x, _EPS)
    g_nh_raw = ((g_pw * e) * pw) / nh * clip_nh
    g_nwi = (g_nl * _clip_grad(cs_raw, _EPS, 1.0)
             + g_cs * _max_grad(cs_raw, 0.0))
    h = hr * rh
    g_n = g_nh_raw * h + g_nwi * wi
    # The rest flows to wo and the scene.
    g_cl = (B * cs) * inv_ds
    g_ds = -(B * w) * inv_ds
    g_x5 = w * (r * eA - beta)
    g_vh_raw = -(g_x5 * 5.0 * x4) * _clip_grad(vh_raw, _EPS, 1.0)
    g_cl_raw = g_cl * _max_grad(cl_raw, 0.0)
    g_h = g_nh_raw * n + g_vh_raw * wo
    g_wo = g_vh_raw * h
    g_hr = (g_h - dot(g_h, h) * h) * rh
    g_wo = g_wo + g_hr
    g_wi = g_hr + g_nwi * n - g_cl_raw * n_l
    g_nl_light = -g_cl_raw * wi
    g_ds_all = g_ds - dot(g_wi, wi) * (0.5 * inv_ds)
    g_rel = g_wi * rsq + 2.0 * g_ds_all * rel
    # Once a scene: A = g1(nv) dn / (4 nv), then nv = clip(n.wo).
    g_A = gamma * (R2 + RX) + eta * RX
    gq_v = g_A * (0.25 * inv_nv)
    g_dn = gq_v * g1v
    g_nv_g1, g_sq_v = _smith_g1_vjp(nv, sq, gq_v * dn)
    g_nv_raw = (-(g_A * A) * inv_nv + g_nv_g1) * _clip_grad(nv_raw, _EPS,
                                                            1.0)
    g_n = g_n + g_nv_raw * wo
    g_wo = g_wo + g_nv_raw * n
    # The colour maps' and the emission's cotangents from the sums.
    g_dif = ge * (1.0 / _PI) * diffuse_sum
    g_sp = ge * (A * R2 - difp * W1)
    g_em = (g * area) * radiance
    # Once a pixel: dn, sq and e back to rough_blinn.
    g_sq = g_sq + g_sq_v
    g_e = g_e + g_dn / (2.0 * _PI) + (g_sq / (2.0 * sq)) * 0.5
    g_rough = (-(g_e * 2.0) * inv_r * inv_r
               * _clip_grad(geo.rough_blinn.to(work), r_lo, 1.0))
    grads = {"normals": g_n, "diffuse": g_dif, "rough_blinn": g_rough,
             "specular": g_sp, "light": g_rel, "wo": g_wo,
             "n_l": g_nl_light, "t_l": a0 * g_rel, "b_l": a1 * g_rel,
             "emission": g_em}
    return (em * area) * radiance, {
        f: grads[f].sum_to_size(getattr(geo, f).shape) for f in _SAMPLED}


def shade_transcribed(coords, normals, diffuse, rough_blinn, specular, light,
                      n_l, t_l, b_l, emission, cam, offsets, shift,
                      d_sample=None, scene_grads: bool = False,
                      work=torch.float64):
    """The kernels' arithmetic on the kernels' inputs in `work` precision:
    the per-pixel terms rounded where the SVBRDF's dtype rounds them, the
    rest as _sample_contrib_vjp_plain takes it, one sample at a time.
    Without d_sample the forward estimate (P, S, H, W, 3); with it the
    VJP's sums in shade_vjp_plain's layout."""
    geo = _flat_geometry(coords, normals, diffuse, rough_blinn, specular,
                         light, n_l, t_l, b_l, emission, cam)
    fields = _SAMPLED if scene_grads else _MAP_FIELDS
    g = (torch.zeros(()) if d_sample is None else d_sample).to(
        device=coords.device, dtype=work)
    total, sums = None, None
    for k in range(offsets.shape[0]):
        c, grads = _sample_contrib_vjp_plain(geo, offsets[k], shift, g,
                                             work=work)
        total = c if total is None else total + c
        sums = (grads if sums is None else
                {f: sums[f] + grads[f] for f in fields})
    if d_sample is None:
        return total / offsets.shape[0]
    return tuple(sums[f] if f in _MAP_FIELDS or f == "wo"
                 else sums[f][:, :, 0, 0] for f in fields)


def shade_float64(*inputs, d_sample=None, scene_grads: bool = False):
    """shade_transcribed in float64: the float64 reference for a bf16
    SVBRDF, whose per-pixel terms the plain version evaluated in float64
    would not round."""
    return shade_transcribed(*inputs, d_sample=d_sample,
                             scene_grads=scene_grads, work=torch.float64)


# --- The kernels' wrappers ---------------------------------------------------

# Each kernel's C entry in csrc/pathtrace.cu; the SVBRDF dtypes the kernels
# take, and the suffix of each one's entries.
_ENTRIES = {"pathtrace_shade": "svbrdf_pathtrace_shade",
            "pathtrace_shade_vjp": "svbrdf_pathtrace_shade_vjp"}
FIELD_DTYPES = {torch.float32: "", torch.bfloat16: "_bf16"}
_FUNCS = {}


def symbol(name: str, dtype: torch.dtype = torch.float32) -> str:
    """The C entry of kernel `name` for an SVBRDF of `dtype`."""
    return _ENTRIES[name] + FIELD_DTYPES[dtype]


def _bind(lib, name: str, dtype: torch.dtype):
    """The C entry of kernel `name` for an SVBRDF of `dtype` in the loaded
    library `lib`, its signature declared."""
    fn = getattr(lib, symbol(name, dtype))
    # pointers: the 13 inputs and the output (forward); the 14 inputs, 6
    # outputs (VJP). ints: P, S, H, W, spp (and scene_grads). The light's
    # extent (double) and area (float). Then the stream.
    vjp = name == "pathtrace_shade_vjp"
    fn.argtypes = ([ctypes.c_void_p] * (20 if vjp else 14)
                   + [ctypes.c_int] * (6 if vjp else 5)
                   + [ctypes.c_double] * 2 + [ctypes.c_float]
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _kernel(name: str, dtype: torch.dtype):
    """The C entry of kernel `name` for an SVBRDF of `dtype`, its library
    built and loaded at first use and its signature declared."""
    if (name, dtype) not in _FUNCS:
        _FUNCS[name, dtype] = _bind(_build.load("pathtrace"), name, dtype)
    return _FUNCS[name, dtype]


def threads_per_block() -> int:
    """Threads per block of both kernels (one thread a pixel)."""
    fn = _build.load("pathtrace").svbrdf_pathtrace_threads
    fn.restype = ctypes.c_int
    return fn()


def blocks_per_sm(name: str, dtype: torch.dtype, n_scenes: int, spp: int,
                  scene_grads: bool = False) -> int:
    """Blocks of kernel `name` for an SVBRDF of `dtype` that fit one SM of
    the current CUDA device (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    lib = _build.load("pathtrace")
    fn = getattr(lib, f"{symbol(name, dtype)}_blocks_per_sm")
    if name == "pathtrace_shade":
        fn.argtypes, args = [ctypes.c_int], (spp,)
    else:
        fn.argtypes = [ctypes.c_int] * 3
        args = (n_scenes, spp, int(scene_grads))
    fn.restype = ctypes.c_int
    n = fn(*args)
    if n <= 0:
        raise RuntimeError(f"occupancy query of the {name} kernel failed: "
                           f"CUDA error {-n}")
    return n


def _check(coords, normals, diffuse, rough_blinn, specular, light, n_l, t_l,
           b_l, emission, cam, offsets, shift, d_sample=None) -> None:
    """Raise unless the inputs have the kernels' layout, dtypes, one device
    and contiguity."""
    if coords.dtype not in FIELD_DTYPES:
        raise TypeError(f"the SVBRDF must be float32 or bfloat16, got "
                        f"{coords.dtype}")
    if coords.dim() != 3 or coords.shape[2] != 3:
        raise ValueError(f"coords must be (H, W, 3), got "
                         f"{tuple(coords.shape)}")
    height, width = coords.shape[:2]
    items, scenes = light.shape[:2] if light.dim() == 3 else (-1, -1)
    spp = offsets.shape[0]
    named = [("coords", coords, tuple(coords.shape), coords.dtype)]
    named += [(n, t, (items, height, width, c), coords.dtype)
              for n, t, c in (("normals", normals, 3),
                              ("diffuse", diffuse, 3),
                              ("rough_blinn", rough_blinn, 1),
                              ("specular", specular, 3))]
    named += [(n, t, (items, scenes, 3), torch.float32)
              for n, t in (("light", light), ("n_l", n_l), ("t_l", t_l),
                           ("b_l", b_l), ("emission", emission),
                           ("cam", cam))]
    named += [("offsets", offsets, (spp, items, scenes, 2), torch.float32),
              ("shift", shift, (items, scenes, height, width, 2),
               torch.float32)]
    if d_sample is not None:
        named.append(("d_sample", d_sample,
                      (items, scenes, height, width, 3), torch.float32))
    for name, t, shape, dtype in named:
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got "
                             f"{tuple(t.shape)}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != coords.device:
            raise ValueError(f"{name} is on {t.device}, coords on "
                             f"{coords.device}")
    if coords.device.type != "cuda":
        raise RuntimeError(f"the path tracer's kernels need CUDA tensors, "
                           f"got {coords.device}")


def _light_args() -> tuple:
    """The light's extent and area as the kernels take them (read at call
    time, as the plain code reads LIGHT_SIZE)."""
    return LIGHT_SIZE[0], LIGHT_SIZE[1], LIGHT_SIZE[0] * LIGHT_SIZE[1]


def _launch(name: str, fn, device, args) -> None:
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def _counted(wrapper, dtype) -> None:
    """One launch of `wrapper`'s kernel, counted in total and by the
    SVBRDF's dtype."""
    wrapper.launches += 1
    wrapper.launches_by_dtype[dtype] += 1


def shade_cuda(coords, normals, diffuse, rough_blinn, specular, light, n_l,
               t_l, b_l, emission, cam, offsets, shift) -> torch.Tensor:
    """Launch the forward estimator's kernel: (P, S, H, W, 3) f32."""
    inputs = (coords, normals, diffuse, rough_blinn, specular, light, n_l,
              t_l, b_l, emission, cam, offsets, shift)
    _check(*inputs)
    items, scenes = light.shape[:2]
    height, width = coords.shape[:2]
    out = torch.empty((items, scenes, height, width, 3), dtype=torch.float32,
                      device=coords.device)
    fn = _kernel("pathtrace_shade", coords.dtype)
    _launch("pathtrace_shade", fn, coords.device,
            [t.data_ptr() for t in inputs] + [
                out.data_ptr(), items, scenes, height, width,
                offsets.shape[0], *_light_args()])
    _counted(shade_cuda, coords.dtype)
    return out


def shade_vjp_cuda(coords, normals, diffuse, rough_blinn, specular, light,
                   n_l, t_l, b_l, emission, cam, offsets, shift, d_sample,
                   scene_grads: bool = False) -> tuple:
    """Launch the backward estimator's VJP kernel: the sums of
    shade_vjp_plain in its order (_SAMPLED's), f32. The sums for light,
    n_l, t_l, b_l and emission are the kernel's per-block partials summed
    with torch.sum."""
    inputs = (coords, normals, diffuse, rough_blinn, specular, light, n_l,
              t_l, b_l, emission, cam, offsets, shift, d_sample)
    _check(*inputs)
    items, scenes = light.shape[:2]
    height, width = coords.shape[:2]
    dev = coords.device

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    maps = [empty(items, 1, height, width, c) for c in (3, 3, 1, 3)]
    d_wo = partials = None
    if scene_grads:
        blocks = -(-(height * width) // threads_per_block())
        d_wo = empty(items, scenes, height, width, 3)
        partials = empty(items, blocks, scenes, 15)
    fn = _kernel("pathtrace_shade_vjp", coords.dtype)
    _launch("pathtrace_shade_vjp", fn, dev,
            [t.data_ptr() for t in inputs]
            + [t.data_ptr() for t in maps]
            + [0 if t is None else t.data_ptr() for t in (d_wo, partials)]
            + [items, scenes, height, width, offsets.shape[0],
               int(scene_grads), *_light_args()])
    _counted(shade_vjp_cuda, coords.dtype)
    if not scene_grads:
        return tuple(maps)
    light_s, n_l_s, t_l_s, b_l_s, emission_s = torch.split(
        torch.sum(partials, dim=1), 3, dim=-1)
    return (*maps, light_s, d_wo, n_l_s, t_l_s, b_l_s, emission_s)


CUDA_WRAPPERS = {"pathtrace_shade": shade_cuda,
                 "pathtrace_shade_vjp": shade_vjp_cuda}
for _wrapper in CUDA_WRAPPERS.values():
    _wrapper.launches = 0
    _wrapper.launches_by_dtype = dict.fromkeys(FIELD_DTYPES, 0)

PLAIN_VERSIONS = {"pathtrace_shade": shade_plain,
                  "pathtrace_shade_vjp": shade_vjp_plain}


def shade(*inputs) -> torch.Tensor:
    """shade_cuda for CUDA tensors, shade_plain for CPU tensors."""
    if inputs[0].device.type == "cpu":
        return shade_plain(*inputs)
    return shade_cuda(*inputs)


def shade_vjp(*inputs, scene_grads: bool = False) -> tuple:
    """shade_vjp_cuda for CUDA tensors, shade_vjp_plain for CPU tensors."""
    if inputs[0].device.type == "cpu":
        return shade_vjp_plain(*inputs, scene_grads=scene_grads)
    return shade_vjp_cuda(*inputs, scene_grads=scene_grads)


def _shade(scene: Scene, svbrdf: torch.Tensor, offsets: torch.Tensor,
           shift: torch.Tensor, estimator=None) -> torch.Tensor:
    """Direct-lighting MC estimate from the given samples, (..., H, W, 3):
    the forward estimator (by default `shade`: the kernel, or on the CPU
    its plain version; `estimator` names another, e.g. shade_plain for a
    float64 render on the card), then the light quad's occlusion."""
    geo = _geometry(scene, svbrdf)
    layout = _layout(geo, _batch_shape(scene, svbrdf))
    total = (estimator or shade)(*_flatten(geo, layout, offsets, shift))
    return _occlude(geo, total.reshape(layout.batch_shape
                                       + tuple(total.shape[-3:])))


class _RenderMC(torch.autograd.Function):
    """Forward: _shade on the forward samples. Backward: the VJP of _shade
    on the backward samples (an independent estimator): the VJP kernel (on
    the CPU its plain version) for the geometry's sampled fields, then one
    autograd pass through the geometry and the occlusion, for the SVBRDF and
    each scene tensor that needs a gradient. The samples get none."""

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
            fields = [f for f in _SAMPLED if getattr(geo, f).requires_grad]
            layout = _layout(geo, tuple(g.shape[:-3]))
            scene_grads = any(f not in _MAP_FIELDS for f in fields)
            flat = _flatten(_Geometry(*(x.detach() for x in geo)), layout,
                            offsets, shift)
            sums = dict(zip(_SAMPLED, shade_vjp(
                *flat, _flat_image(d_sample, layout),
                scene_grads=scene_grads)))
            wanted = [x for x in leaves if x.requires_grad]
            grads = iter(torch.autograd.grad(
                [out] + [getattr(geo, f) for f in fields], wanted,
                [g] + [_unflatten_grad(layout, f, sums[f],
                                       getattr(geo, f)).to(
                           getattr(geo, f).dtype) for f in fields],
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
