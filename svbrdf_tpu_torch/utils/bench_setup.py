"""The port's training programs and their inputs: local renderer (or the
path tracer), material mixing, augmentation on, Adam at lr 1e-5, f32 or
bf16 compute (with f32 or bf16-SR masters), and either the single-view model with the mixed loss
(the main path) or the multi-view model (3 views, all synthesized) with
the rendering-only loss. The same code as the CLI's builds the models,
masters and optimizers (models.build_model, parallel/step).

Counterpart of svbrdf_tpu/utils/bench_setup.py (synthetic_raw_batch and
build_headline_program) for the port: one place that builds what the card
tests (tests/test_torch_card.py), the smoke run (chip_smoke.py) and the CPU
tests drive, with the rules that hold the kernels to their plain versions
and the launches each path makes.
"""

from __future__ import annotations

import os
import tempfile
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from svbrdf_tpu_torch import losses
from svbrdf_tpu_torch.device import precision_scope, resolve_device
from svbrdf_tpu_torch.models import build_model
from svbrdf_tpu_torch.parallel import mesh, spatial
from svbrdf_tpu_torch.parallel import step as step_lib
from svbrdf_tpu_torch.parallel.mesh import shard_batch
from svbrdf_tpu_torch.parallel.step import (PrepConfig, TrainStep,
                                            make_eval_step, make_optimizer,
                                            make_predict_fn, make_train_step)


def synthetic_raw_batch(batch: int, size: int, n_views: int = 0,
                        seed: int = 0) -> dict:
    """A raw uint8 batch as strips decode to it, made with numpy from
    `seed`: the same bytes as the JAX package's synthetic_raw_batch
    (spatial arrays only). Mixing partners are the batch reversed."""
    rng = np.random.default_rng(seed)
    n = rng.uniform(-1, 1, (batch, size, size, 3)).astype(np.float32)
    n[..., 2] = np.abs(n[..., 2]) + 0.5
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    maps = rng.uniform(0.05, 0.95, (batch, size, size, 9)).astype(np.float32)
    svbrdf = np.concatenate(
        [np.round((n * 0.5 + 0.5) * 255.0), np.round(maps * 255.0)],
        axis=-1).astype(np.uint8)
    return {
        "inputs": np.zeros((batch, n_views, size, size, 3), np.uint8),
        "svbrdf": svbrdf,
        "partner_svbrdf": svbrdf[::-1].copy(),
    }


def loss_inputs(batch: int, size: int, n_scenes: int, seed: int = 0,
                device="cuda", dtype=torch.float32) -> tuple:
    """(pred planes, gt planes, packed scenes) at the loss kernels' shapes
    on `device`: gt and pred decoded from two synthetic raw batches (pred
    plays an untrained model's output) and cast to `dtype`, scenes (f32)
    from the loss sampler (3 random, n_scenes - 3 specular per item)."""
    from svbrdf_tpu_torch.data import pipeline
    from svbrdf_tpu_torch.ops import render_fused, sampling

    dev = resolve_device(device)

    def planes(s):
        raw = synthetic_raw_batch(batch, size, 0, s)["svbrdf"]
        return losses.to_planes(pipeline._decode_u8_svbrdf(
            torch.from_numpy(raw).to(dev))).to(dtype)

    g = torch.Generator(device=dev).manual_seed(seed)
    scenes = sampling.generate_loss_scenes(batch, 3, n_scenes - 3,
                                           generator=g, device=dev)
    return planes(seed + 1), planes(seed), render_fused.pack_scenes(scenes)


def loss_inputs_near(batch: int, size: int, n_scenes: int,
                     sigma: float = 1e-3, seed: int = 0,
                     device="cuda", dtype=torch.float32) -> tuple:
    """loss_inputs with pred near gt, as a model near convergence gives it
    in validation: gt and the scenes as in loss_inputs, pred = gt + sigma *
    N(0, 1) from a generator seeded with `seed`, its normal re-normalized
    (the model's head outputs unit normals; the decoded gt's are within
    u8 rounding of unit) and its other maps clamped to [0, 1], the range of
    the decoded maps. Made in f32, then both planes cast to `dtype`."""
    _, gt, scenes9 = loss_inputs(batch, size, n_scenes, seed, device)
    g = torch.Generator(device=gt.device).manual_seed(seed)
    pred = gt + sigma * torch.randn(gt.shape, generator=g, device=gt.device)
    normal = pred[:, :3] * torch.rsqrt(torch.sum(pred[:, :3] ** 2, dim=1,
                                                 keepdim=True))
    pred = torch.cat([normal, pred[:, 3:].clamp(0.0, 1.0)], dim=1)
    return pred.to(dtype), gt.to(dtype), scenes9


def pathtrace_inputs(batch: int, size: int, spp=(4, 2), seed: int = 0,
                     device="cuda") -> tuple:
    """(pred, target NHWC (B, H, W, 12) maps, the 3 random + 6 specular
    loss scenes per item, pathtrace.RenderSamples) for the path tracer,
    made on the CPU from `seed` and moved to `device`: the same values on
    every device. pred and target are two synthetic raw batches decoded."""
    from svbrdf_tpu_torch.data import pipeline
    from svbrdf_tpu_torch.ops import pathtrace, sampling
    from svbrdf_tpu_torch.scene import Scene

    dev = resolve_device(device)

    def maps(s):
        raw = synthetic_raw_batch(batch, size, 0, s)["svbrdf"]
        return pipeline._decode_u8_svbrdf(torch.from_numpy(raw)).to(dev)

    g = torch.Generator().manual_seed(seed)
    scenes = sampling.generate_loss_scenes(batch, 3, 6, generator=g)
    samples = pathtrace.draw_render_samples(g, spp, (batch, 9), size, size)
    return (maps(seed + 1), maps(seed), scenes.to(dev),
            pathtrace.RenderSamples(*(pathtrace.Samples(
                *(x.to(dev) for x in s)) for s in samples)))


def render_conditioning(scene, svbrdf: torch.Tensor, samples,
                        trials: int = 4, seed: int = 0,
                        device="cpu") -> torch.Tensor:
    """The scale of f32 rounding's effect on each path-traced render value:
    the most that flipping every map value by one f32 ulp (relative 2^-24,
    random signs from `seed`) moves the float64 render (the forward
    estimator's plain version on the float64 inputs, on `device`), over
    `trials` draws. One ulp of n.h moves the Blinn lobe pow(n.h, e) by up
    to e ulps (e reaches 2e4), so where f32 is ill-conditioned this is
    large."""
    from svbrdf_tpu_torch.ops import pathtrace

    def f64(x):
        return x.detach().double().to(device)

    def render(svbrdf):
        return pathtrace._shade(scene, svbrdf, *samples.forward,
                                estimator=pathtrace.shade_plain)

    scene = type(scene)(*map(f64, (scene.camera_pos, scene.light_pos,
                                   scene.light_color)))
    samples = pathtrace.RenderSamples(*(pathtrace.Samples(*map(f64, s))
                                        for s in samples))
    svbrdf = f64(svbrdf)
    base = render(svbrdf)
    g = torch.Generator().manual_seed(seed)
    worst = torch.zeros_like(base)
    for _ in range(trials):
        sign = torch.randint(0, 2, svbrdf.shape, generator=g) * 2 - 1
        moved = render(svbrdf * (1 + sign.to(device) * 2.0 ** -24))
        worst = torch.maximum(worst, (moved - base).abs())
    return worst


def render_distances(actual, ref, ref64, cond, rtol: float = 1e-5) -> dict:
    """hold_render's numbers for render values `actual` (each a tensor of
    render values, `cond` from render_conditioning): the largest deviation
    from `ref`, the share of values beyond rel `rtol` of it, the largest
    deviation from the float64 `ref64` over its allowance (4x the largest
    of `ref`'s own distance from it, rel `rtol` and `cond`) among those,
    and `outside`, the count of values beyond both tolerances."""
    actual, ref, ref64, cond = (x.double().cpu()
                                for x in (actual, ref, ref64, cond))
    near = (actual - ref).abs() <= rtol * ref.abs()
    allowed = 4 * torch.maximum(torch.maximum((ref - ref64).abs(),
                                              rtol * ref64.abs()), cond)
    dist = (actual - ref64).abs()
    out = {"max_abs_err": float((actual - ref).abs().max()),
           "beyond_rtol": float((~near).double().mean()),
           "max_dist_over_allowed": float(
               (dist / allowed.clamp_min(1e-300))[~near].max())
           if bool((~near).any()) else 0.0}
    out["outside"] = int((~(near | (dist <= allowed))).sum())
    return out


def hold_render(actual, ref, ref64, cond, rtol: float = 1e-5) -> dict:
    """The path tracer's render tolerance (each a tensor of render values,
    `cond` from render_conditioning): every value within rel `rtol` of
    `ref`, or no further from the float64 `ref64` than 4x the largest of
    `ref`'s own distance from it, rel `rtol` and `cond`; at most 1 % of
    the values beyond rel `rtol`. Raises RuntimeError otherwise; returns
    render_distances: the share beyond rtol and the largest deviation from
    float64 over its allowance among others."""
    out = render_distances(actual, ref, ref64, cond, rtol)
    if out["outside"] or out["beyond_rtol"] > 0.01:
        raise RuntimeError(f"path-traced renders: {out['outside']} "
                             f"values beyond both tolerances; {out}")
    return out


# The cases each path tracer kernel is held on against its plain version
# (tests/test_torch_card.py, utils/compare_builds.py): (batch, height,
# width, spp, SVBRDF dtype, scene gradients).
PATHTRACE_CASES = {
    "full_f32": (8, 256, 256, (16, 8), torch.float32, False),
    "full_bf16": (8, 256, 256, (16, 8), torch.bfloat16, False),
    "ragged": (3, 250, 243, (16, 8), torch.float32, False),
    "scene_grads": (2, 32, 32, (16, 8), torch.float32, True),
}


def pathtrace_case(batch: int, height: int, width: int, spp=(16, 8),
                   dtype=torch.float32, seed: int = 0,
                   device="cuda") -> dict:
    """The path tracer's kernels' inputs at a loss's shapes, made on the
    CPU from `seed` and moved to `device`: the prediction of
    pathtrace_inputs (cut to height x width) as a (B, 1, H, W, 12) SVBRDF
    in `dtype`, its 3 random + 6 specular loss scenes per item, both
    estimators' samples and a render cotangent `d_render` (B, S, H, W, 3)
    uniform in [-1, 1]; `flat` and `flat_bwd`, the forward's and the VJP's
    inputs in the kernels' layout, and `d_sample` (the cotangent over the
    backward spp, in that layout)."""
    from svbrdf_tpu_torch.ops import pathtrace as pt

    dev = resolve_device(device)
    size = max(height, width)
    pred, _, scenes, samples = pathtrace_inputs(batch, size, spp, seed,
                                                device="cpu")
    g = torch.Generator().manual_seed(seed + 1)
    samples = pt.draw_render_samples(g, spp, (batch, 9), height, width)
    d_render = torch.rand((batch, 9, height, width, 3), generator=g) * 2 - 1
    svbrdf = pred[:, None, :height, :width].to(dtype).to(dev)
    scenes = scenes.to(dev)
    samples = pt.RenderSamples(*(pt.Samples(*(x.to(dev) for x in s))
                                 for s in samples))
    geo = pt._geometry(scenes, svbrdf)
    layout = pt._layout(geo, pt._batch_shape(scenes, svbrdf))
    return {"scenes": scenes, "svbrdf": svbrdf, "samples": samples,
            "d_render": d_render.to(dev),
            "flat": pt._flatten(geo, layout, *samples.forward),
            "flat_bwd": pt._flatten(geo, layout, *samples.backward),
            "d_sample": pt._flat_image(d_render.to(dev) / spp[1], layout)}


def _normwise(actual, expected) -> float:
    actual, expected = actual.double(), expected.double()
    return float((actual - expected).norm() / expected.norm())


def pathtrace_references(case: dict, scene_grads: bool = False) -> dict:
    """What the path tracer's kernels are held against on a pathtrace_case
    (pathtrace_agreement): the plain version's render (the forward
    estimator, then the occlusion) and its float64 render, which evaluates
    the kernel's own inputs (the f32 geometry) in float64 (the plain
    version's on them for an f32 SVBRDF, shade_float64's for a bf16 one:
    the plain version in float64 would not round the bf16 per-pixel
    terms), render_conditioning, and the VJP's sums by the plain version
    and in float64 (the maps', with `scene_grads` also wo's and the scene
    fields')."""
    from svbrdf_tpu_torch.ops import pathtrace as pt

    scenes, svbrdf, samples = case["scenes"], case["svbrdf"], case["samples"]
    bf16 = svbrdf.dtype == torch.bfloat16

    def reference(flat, **kw):
        if bf16:
            return pt.shade_float64(*flat, **kw)
        flat = [x.double() for x in flat]
        if "d_sample" in kw:
            return pt.shade_vjp_plain(*flat, kw["d_sample"].double(),
                                      scene_grads=kw["scene_grads"])
        return pt.shade_plain(*flat)

    flat, d = case["flat_bwd"], case["d_sample"]
    return {
        "plain": pt._shade(scenes, svbrdf, *samples.forward,
                           estimator=pt.shade_plain),
        "float64": pt._shade(scenes, svbrdf, *samples.forward,
                             estimator=lambda *flat: reference(flat)),
        "cond": render_conditioning(scenes, svbrdf.float(), samples,
                                    device=svbrdf.device),
        "vjp_plain": pt.shade_vjp_plain(*flat, d, scene_grads=scene_grads),
        "vjp_float64": reference(flat, d_sample=d, scene_grads=scene_grads)}


def pathtrace_agreement(case: dict, refs: dict,
                        scene_grads: bool = False) -> dict:
    """The path tracer's kernels (the wrappers' CUDA launches) on a
    pathtrace_case against its pathtrace_references, by the rules of
    hold_pathtrace_kernels, without raising: the renders'
    render_distances, each VJP sum's distances, and "passes", whether
    every rule holds."""
    from svbrdf_tpu_torch.ops import pathtrace as pt

    scenes, svbrdf, samples = case["scenes"], case["svbrdf"], case["samples"]
    bf16 = svbrdf.dtype == torch.bfloat16
    rendered = pt._shade(scenes, svbrdf, *samples.forward)
    out = {"render": render_distances(rendered, refs["plain"],
                                      refs["float64"], refs["cond"])}
    passes = (not out["render"]["outside"]
              and out["render"]["beyond_rtol"] <= 0.01)
    del rendered

    kernel = pt.shade_vjp_cuda(*case["flat_bwd"], case["d_sample"],
                               scene_grads=scene_grads)
    fields = pt._SAMPLED if scene_grads else pt._MAP_FIELDS
    bad = []
    for name, k, p, r in zip(fields, kernel, refs["vjp_plain"],
                             refs["vjp_float64"]):
        dist = {"to_plain": _normwise(k, p), "to_float64": _normwise(k, r),
                "plain_to_float64": _normwise(p, r),
                "max_abs_err": float((k.double() - p.double()).abs().max())}
        out[name] = dist
        if dist["to_float64"] > 2 * dist["plain_to_float64"] + 1e-5 or (
                not bf16 and dist["plain_to_float64"] <= 1e-4
                and dist["to_plain"] > 1e-4):
            bad.append(name)
    out["vjp_beyond_tolerance"] = bad
    out["passes"] = passes and not bad
    return out


def hold_pathtrace_kernels(case: dict, scene_grads: bool = False) -> dict:
    """Each path tracer kernel against its plain version on a
    pathtrace_case on the card (pathtrace_references,
    pathtrace_agreement). Raises RuntimeError unless:
    - renders (the forward kernel, then the occlusion) pass hold_render
      against the plain version's, with render_conditioning and the
      float64 render of the kernel's own inputs;
    - every sum of the VJP (the maps', with `scene_grads` also wo's and
      the scene fields') lies no further from its float64 evaluation (as
      for the renders) than 2x the plain version's own distance + 1e-5,
      and for an f32 SVBRDF within 1e-4 of the plain version's (normwise)
      wherever the plain version itself lies within 1e-4 of float64 (where
      it does not, two f32 evaluations cannot agree to 1e-4: the Blinn
      lobe's exponent reaches 2e4, and one ulp of n.h moves its gradient by
      ~1e-3; the float64 rule holds alone there).
    Returns the render check's numbers and each sum's three distances."""
    out = pathtrace_agreement(case, pathtrace_references(case, scene_grads),
                              scene_grads)
    render = out["render"]
    if render["outside"] or render["beyond_rtol"] > 0.01:
        raise RuntimeError(f"path-traced renders: {render['outside']} "
                           f"values beyond both tolerances; {render}")
    if out["vjp_beyond_tolerance"]:
        raise RuntimeError(f"path tracer VJP: {out['vjp_beyond_tolerance']}"
                           f" beyond tolerance; {out}")
    return out


def tail_cases(kind: str, batch: int, size: int, depth: int = 8,
               num_filters: int = 64, views: int = 3) -> list:
    """The block tails (ops.norm_merge calls) of one forward of the
    single-view (`kind` "single") or multi-view ("multi", `views` views an
    item) model on `batch` items of size^2, in their order: (B, C, H, W,
    norm, merge, tap, last), norm and merge whether the tail has them, tap
    whether its channel means feed the loss (a backward then takes their
    cotangent), last whether its input is channels last on the card (the
    encoder's: the images come NHWC and cuDNN keeps the layout; the
    decoder's upsampling and the head's inputs are NCHW)."""
    from svbrdf_tpu_torch.models.generator import encoder_features
    from svbrdf_tpu_torch.models.multi_view import HEAD_FEATURES

    multi = kind == "multi"
    rows = batch * views if multi else batch
    out_channels = 64 if multi else 9
    enc = encoder_features(num_filters, depth)
    # The first encoder block has no tail: no norm and no global track.
    cases = [(rows, enc[i], size >> (i + 1), size >> (i + 1),
              i < depth - 1, True, True, True) for i in range(1, depth)]
    for i in range(depth):
        last = i == depth - 1
        side = size >> (depth - 1 - i)
        cases.append((rows, out_channels if last else enc[depth - 2 - i],
                      side, side, not last, True, multi or not last, False))
    if multi:
        cases.append((batch, out_channels, size, size, False, True, True,
                      False))
        for k, c in enumerate(HEAD_FEATURES):
            cases.append((batch, c, size, size, k < 2, True, k < 2, False))
    return cases


TAIL_RTOL = 1e-5  # the forward's out and tap against the plain version
# A gradient within this (normwise) of float64 passes whatever the plain
# version's distance: with a few planes (a batch-1 row of 3 channels) both
# f32 summation orders sit a few 1e-7 from float64 and their ratio is
# noise; 1e-6 is 17 f32 epsilons.
TAIL_GRAD_FLOOR = 1e-6


def tail_inputs(case: tuple, seed: int = 0, device="cuda") -> dict:
    """f32 inputs of a tail of tail_cases' form, drawn on `device` from
    `seed`: x with per-plane offsets (conv outputs' means are not zero) and
    dout, both channels last where the case says so, and weight and bias,
    m, g where the tail has a norm, a merge, a used tap."""
    b, c, h, w, norm, merge, tap, last = case
    gen = torch.Generator(device=device).manual_seed(seed)

    def draw(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=device) * scale

    layout = torch.channels_last if last else torch.contiguous_format
    t = {"x": (draw(b, c, h, w) + draw(b, c, 1, 1, scale=2.0)).contiguous(
             memory_format=layout),
         "dout": draw(b, c, h, w).contiguous(memory_format=layout)}
    if norm:
        t["weight"] = 1.0 + draw(c, scale=0.3)
        t["bias"] = draw(c, scale=0.5)
    if merge:
        t["m"] = draw(b, c)
    if tap:
        t["g"] = draw(b, c)
    return t


def tail_kernels(t: dict, dtype, param_dtype=None) -> dict:
    """One forward and one backward launch of the tail's kernels on the
    inputs `t` cast to `dtype` (weight and bias to `param_dtype`, `dtype`
    by default): out, mean, rstd, dx, and dw, db (the planes' partials
    summed over the batch), dm where the tail has them."""
    from svbrdf_tpu_torch.ops import norm_merge as nm

    param_dtype = param_dtype or dtype
    x = t["x"].to(dtype)
    w, b = (t[k].to(param_dtype) if k in t else None
            for k in ("weight", "bias"))
    m = t["m"].to(dtype) if "m" in t else None
    out, stats = nm.norm_merge_fwd_cuda(x, w, b, m)
    dx, dm, parts = nm.norm_merge_bwd_cuda(
        t["dout"].to(dtype), t.get("g"), x if w is not None else None,
        stats if w is not None else None, w, m is not None)
    r = {"out": out, "mean": stats[0], "rstd": stats[1], "dx": dx, "dm": dm}
    if parts is not None:
        r["dw"], r["db"] = parts.sum(1)
    return r


def tail_plain(t: dict, dtype=torch.float32) -> dict:
    """The plain version (norm_merge_plain and its autograd) on `t` cast
    to `dtype`: out, mean, dx, dw, db, dm."""
    from svbrdf_tpu_torch.ops import norm_merge as nm

    leaves = {k: t[k].detach().to(dtype).requires_grad_()
              for k in ("x", "weight", "bias", "m") if k in t}
    out, mean = nm.norm_merge_plain(leaves["x"], leaves.get("weight"),
                                    leaves.get("bias"), leaves.get("m"))
    outputs, cots = [out], [t["dout"].to(dtype)]
    if "g" in t:
        outputs.append(mean)
        cots.append(t["g"])
    grads = torch.autograd.grad(outputs, list(leaves.values()), cots,
                                allow_unused=True)
    names = {"x": "dx", "weight": "dw", "bias": "db", "m": "dm"}
    r = {names[k]: g for k, g in zip(leaves, grads)}
    r.update(out=out.detach(), mean=mean.detach())
    return r


def tail_float64(t: dict, eps: float = 1e-5) -> dict:
    """The tail in float64 with a two-pass variance, and autograd: the
    reference the kernels' and the plain version's gradients are held to."""
    leaves = {k: t[k].double().requires_grad_()
              for k in ("x", "weight", "bias", "m") if k in t}
    x = leaves["x"]
    mean = x.mean(dim=(2, 3))
    out = x
    if "weight" in leaves:
        mu = x.mean(dim=(2, 3), keepdim=True)
        var = torch.square(x - mu).mean(dim=(2, 3), keepdim=True)
        w, b = (leaves[k][:, None, None] for k in ("weight", "bias"))
        out = (x - mu) / torch.sqrt(var + eps) * w + b
    if "m" in leaves:
        out = out + leaves["m"][:, :, None, None]
    outputs, cots = [out], [t["dout"].double()]
    if "g" in t:
        outputs.append(mean)
        cots.append(t["g"].double())
    grads = torch.autograd.grad(outputs, list(leaves.values()), cots,
                                allow_unused=True)
    names = {"x": "dx", "weight": "dw", "bias": "db", "m": "dm"}
    r = {names[k]: g for k, g in zip(leaves, grads)}
    r.update(out=out.detach(), mean=mean.detach())
    return r


TAIL_VALUES = 1 << 22  # values a case's distances are taken over, at least


def _stacked(runs, name):
    return torch.cat([r[name].reshape(-1) for r in runs])


def hold_tail_kernels(case: tuple, seed: int = 0) -> dict:
    """The tail's kernels against the plain version on one case on the
    card: f32 out and tap within TAIL_RTOL (normwise) of the plain f32
    version's; each gradient no further (normwise) from the float64
    reference than twice the plain f32 version's own distance (or than
    TAIL_GRAD_FLOOR); the bf16 kernels equal to the f32 ones on the upcast
    inputs up to the bf16 roundings (the tap, rstd and the dw, db partials
    to the bit, dx and dm the f32 results rounded once, out the f32 y
    rounded, plus m, rounded). A small case is drawn from several seeds
    (seed, seed + 1, ...), up to 16, until TAIL_VALUES values, and the f32
    distances are taken over all the draws: a tiny plane's one-pass
    variance can cancel (a 2x2 plane far off zero), and one draw's ratio of
    two f32 roundings' distances is then noise. Returns the distances and
    `failed`, what broke the rules."""
    b, c, h, w = case[:4]
    draws = max(1, min(16, TAIL_VALUES // (b * c * h * w)))
    k32, p32, r64 = [], [], []
    for s in range(seed, seed + draws):
        t = tail_inputs(case, s)
        k32.append(tail_kernels(t, torch.float32))
        p32.append(tail_plain(t))
        r64.append(tail_float64(t))
    t = tail_inputs(case, seed)
    out = {"case": list(case), "draws": draws, "failed": []}
    for name in ("out", "mean"):
        out[name] = _normwise(_stacked(k32, name), _stacked(p32, name))
        if not out[name] <= TAIL_RTOL:
            out["failed"].append(name)
    for name in ("dx", "dw", "db", "dm"):
        if name not in p32[0]:
            continue
        ref = _stacked(r64, name)
        dist = (_normwise(_stacked(k32, name), ref),
                _normwise(_stacked(p32, name), ref))
        out[name] = dist
        if not dist[0] <= max(2 * dist[1], TAIL_GRAD_FLOOR):
            out["failed"].append(name)
    # bf16: the f32 kernels on the bf16 inputs upcast.
    t16 = {k: v.to(torch.bfloat16).float() if k != "g" else v
           for k, v in t.items()}
    k16 = tail_kernels(t16, torch.bfloat16)
    f32 = tail_kernels(t16, torch.float32)
    expect = {"mean": f32["mean"], "dx": f32["dx"].bfloat16()}
    if "weight" in t:
        expect.update(rstd=f32["rstd"], dw=f32["dw"], db=f32["db"])
    if "m" in t:
        expect["dm"] = f32["dm"].bfloat16()
        # y alone (no merge vector), rounded, plus m, rounded.
        y = tail_kernels({k: v for k, v in t16.items() if k != "m"},
                         torch.float32)["out"]
        expect["out"] = (y.bfloat16().float() + t16["m"][:, :, None, None]
                         ).bfloat16()
    else:
        expect["out"] = f32["out"].bfloat16()
    out["bf16_unequal"] = [k for k, v in expect.items()
                           if not torch.equal(k16[k], v)]
    out["failed"] += [f"bf16 {k}" for k in out["bf16_unequal"]]
    return out


def styled_tail_cases(batch: int = 8, resolution: int = 256,
                      max_channels: int = 512,
                      channel_base: int = 32768) -> list:
    """The styled convs' tails (ops.styled_tail calls) of one forward of
    MaterialGAN's generator (config-f widths by default) on `batch`
    materials, in order: (B, C, H, W, up), H x W the output, up whether the
    conv up-samples (its t is (H + 1) x (W + 1))."""
    from svbrdf_tpu_torch.models.stylegan2 import channels

    res = [1 << i for i in range(2, resolution.bit_length())]
    ch = [channels(r, max_channels, channel_base) for r in res]
    cases = [(batch, ch[0], 4, 4, False)]
    for r, c in zip(res[1:], ch[1:]):
        cases += [(batch, c, r, r, True), (batch, c, r, r, False)]
    return cases


# Where the float64 pre-activation lies within this of leaky ReLU's kink,
# styled_tail_inputs' cotangent is 0: f32 rounding (about 1e-6 there) may
# put such a point on either side, and one point on the other side moves
# grad_noise by its channel's 0.8 sqrt 2 g, beyond any summation-order
# rule (a 8 x 512 x 64^2 tail holds about one such point a seed).
STYLED_TAIL_KINK = 1e-4


def styled_tail_inputs(case: tuple, seed: int = 0, device="cuda") -> dict:
    """f32 inputs of a tail of styled_tail_cases' form, drawn on `device`
    from `seed`: t, d (positive, as a demodulation), bias, the noise map,
    the strength and the output's cotangent g, 0 within STYLED_TAIL_KINK of
    the kink."""
    from svbrdf_tpu_torch.ops import styled_tail as st

    b, c, h, w, up = case
    gen = torch.Generator(device=device).manual_seed(seed)

    def draw(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=device) * scale

    x = {"t": draw(b, c, h + up, w + up),
         "d": 0.5 + torch.rand(b, c, generator=gen, device=device),
         "bias": draw(c, scale=0.3), "noise": draw(b, 1, h, w),
         "strength": draw(scale=0.1), "g": draw(b, c, h, w)}
    x64 = {k: v.double() for k, v in x.items()}
    y = (st.blur(x64["t"], st.fir_kernel(device, torch.float64)) if up
         else x64["t"])
    pre = (x64["bias"][:, None, None] + y * x64["d"][:, :, None, None]
           + x64["noise"] * x64["strength"])
    x["g"] = x["g"].masked_fill(pre.abs() < STYLED_TAIL_KINK, 0.0)
    return x


_STYLED_INPUTS = ("t", "d", "bias", "noise", "strength")
_STYLED_RESULTS = ("out", "grad_t", "grad_d", "grad_bias", "grad_noise",
                   "grad_strength")


def styled_tail_kernels(x: dict, up: bool, forward=None,
                        backward=None) -> dict:
    """One forward launch (keeping y) and one backward launch of the
    tail's kernels on the inputs `x` (the card's wrappers by default; the
    host build's where given): out and each input's gradient."""
    from svbrdf_tpu_torch.ops import styled_tail as st

    forward = forward or st.styled_tail_fwd_cuda
    backward = backward or st.styled_tail_bwd_cuda
    args = [x[k] for k in _STYLED_INPUTS]
    out, y = forward(*args, up, True)
    grads = backward(x["g"], y, *args[1:], up)
    return dict(zip(_STYLED_RESULTS, (out, *grads)))


def styled_tail_reference(x: dict, up: bool, dtype=torch.float32) -> dict:
    """The plain version (styled_tail_plain and its autograd) on `x` cast
    to `dtype`: out and each input's gradient."""
    from svbrdf_tpu_torch.ops import styled_tail as st

    args = [x[k].detach().to(dtype).requires_grad_() for k in _STYLED_INPUTS]
    out = st.styled_tail_plain(*args, up)
    grads = torch.autograd.grad(out, args, x["g"].to(dtype))
    return dict(zip(_STYLED_RESULTS, (out.detach(), *grads)))


# A kernel's result within this (normwise) of float64 passes whatever the
# plain version's distance: 17 f32 epsilons.
STYLED_TAIL_FLOOR = 1e-6


def hold_styled_tail_kernels(case: tuple, seed: int = 0, device="cuda",
                             forward=None, backward=None) -> dict:
    """The tail's kernels against the plain version on one case: out and
    the gradients of t, d, the bias, the noise and the strength, each no
    further (normwise) from the float64 plain version than twice the f32
    plain version's own distance, or than STYLED_TAIL_FLOOR. The kernels
    sum in another order than torch: the FIR's 16 taps as a row then a
    column pass, grad_noise's channel sum (up to 512 terms), grad_d's
    H x W sum (up to 65,536), grad_bias's B x H x W sum (up to 524,288)
    and grad_strength's sum over every pixel of the noise times its
    channel sum, in blocks, and they round the two addcmul's products
    apart (no FMA). The inputs keep the cotangent off leaky ReLU's kink
    (STYLED_TAIL_KINK), where the branch is a matter of rounding. Returns
    each result's (kernel, plain) distances and `failed`, the results
    that broke the rule."""
    x = styled_tail_inputs(case, seed, device)
    up = case[4]
    got = styled_tail_kernels(x, up, forward, backward)
    plain = styled_tail_reference(x, up)
    ref = styled_tail_reference(x, up, torch.float64)
    out = {"case": list(case), "failed": []}
    for name, r in ref.items():
        out[name] = (_normwise(got[name], r), _normwise(plain[name], r))
        if not out[name][0] <= max(2 * out[name][1], STYLED_TAIL_FLOOR):
            out["failed"].append(name)
    return out


@dataclass
class MainProgram:
    """A training program, ready to drive: train_step(raw), eval_step(raw),
    predict(images)."""

    model: torch.nn.Module
    train_step: TrainStep
    eval_step: Callable
    predict: Callable
    raw: dict
    prep: PrepConfig
    generator: torch.Generator


def build_program(model_kind: str = "single", loss_kind: str = "mixed",
                  batch: int = 8, size: int = 256, depth: int = 8,
                  num_filters: int = 64, seed: int = 0,
                  device="cuda", dtype=torch.float32,
                  master_dtype=None, renderer: str = "local",
                  group=None, spp=(16, 8), space=None,
                  learning_rate: float = 1e-5) -> MainProgram:
    """Build a training program at the given widths, with weights and data
    made from `seed`, on `device`: model_kind "single" (one input view) or
    "multi" (3 views), loss_kind "mixed" or "rendering" with `renderer`
    "local" (the fused loss kernels) or "pathtracing" (at `spp`); the
    model computing in `dtype`, its masters cast by the policy
    `master_dtype` ('f32' | 'bf16sr'; None: the policy in force).

    With a data group (parallel/mesh.DataGroup) it is that rank's part of
    the data-parallel program on the group's device: `batch` is the global
    batch, `raw` the rank's rows of it, and the train and eval steps draw
    for the global batch (parallel/step.DataParallelTrainStep). `device`
    must then name the group's device (its type; its index where given):
    a program asked for on the card never runs on a CPU rank."""
    if model_kind not in ("single", "multi"):
        raise ValueError(f"unknown model kind {model_kind!r}")
    dev = resolve_device(device)
    if group is not None:
        if dev.type != group.device.type or dev.index not in (
                None, group.device.index):
            raise ValueError(f"program device {str(dev)!r} is not the "
                             f"data group's {str(group.device)!r}")
        dev = group.device
    n_views = 3 if model_kind == "multi" else 1
    model = build_model(model_kind, False, depth, num_filters, device=dev,
                        seed=seed, dtype=dtype)
    with step_lib.master_dtype_scope():
        if master_dtype is not None:
            step_lib.set_master_dtype_policy(master_dtype)
        step_lib.master_cast(model)
    optimizer = make_optimizer(model.parameters(), learning_rate, dtype)
    prep = PrepConfig(used_input_image_count=n_views, use_augmentation=True,
                      is_linear=False, mix_materials=True)
    generator = torch.Generator(device=dev).manual_seed(seed + 1)
    raw = synthetic_raw_batch(batch, size, 0, seed)
    if space is not None:
        raw = {k: torch.from_numpy(v).to(dev) for k, v in raw.items()}
        loss_fn = spatial.make_spatial_loss_fn(loss_kind, space)
        return MainProgram(
            model=model,
            train_step=spatial.SpatialTrainStep(model, optimizer, loss_fn,
                                                prep, generator, space,
                                                seed=seed),
            eval_step=spatial.make_spatial_eval_step(model, loss_fn, prep,
                                                     generator, space),
            predict=spatial.make_spatial_predict_fn(model, space), raw=raw,
            prep=prep, generator=generator)
    loss_fn = losses.make_loss_fn(loss_kind, renderer, spp=spp)
    if group is not None:
        raw = shard_batch(raw, group)
    raw = {k: torch.from_numpy(v).to(dev) for k, v in raw.items()}
    return MainProgram(
        model=model,
        train_step=make_train_step(model, optimizer, loss_fn, prep,
                                   generator, seed=seed, group=group),
        eval_step=make_eval_step(model, loss_fn, prep, generator, group),
        predict=make_predict_fn(model), raw=raw, prep=prep,
        generator=generator)


def build_main_program(batch: int = 8, size: int = 256, depth: int = 8,
                       num_filters: int = 64, seed: int = 0,
                       device="cuda") -> MainProgram:
    """Build the single-view mixed-loss training program (the main path)."""
    return build_program("single", "mixed", batch, size, depth, num_filters,
                         seed, device)


def zero_launch_counts() -> None:
    """Set every kernel launch counter to 0."""
    from svbrdf_tpu_torch.ops import norm_merge as nm
    from svbrdf_tpu_torch.ops import pathtrace
    from svbrdf_tpu_torch.ops import render_fused as rf
    from svbrdf_tpu_torch.ops import sr_adam
    from svbrdf_tpu_torch.ops import styled_tail as st

    for wrapper in (*rf.CUDA_WRAPPERS.values(),
                    *pathtrace.CUDA_WRAPPERS.values()):
        wrapper.launches = 0
        for dtype in wrapper.launches_by_dtype:
            wrapper.launches_by_dtype[dtype] = 0
    for wrapper in (sr_adam.sr_adam_multi_cuda, nm.norm_merge_fwd_cuda,
                    nm.norm_merge_bwd_cuda, st.styled_tail_fwd_cuda,
                    st.styled_tail_bwd_cuda):
        wrapper.launches = 0


def launch_counts() -> dict:
    """Every launch counter: each loss kernel's by planes dtype and each
    path tracer kernel's by SVBRDF dtype (the bf16 instantiation as
    <kernel>_bf16), sr_adam's, the block tail's pair (norm_merge_fwd,
    norm_merge_bwd; both dtypes) and the styled conv tail's
    (styled_tail_fwd, styled_tail_bwd)."""
    from svbrdf_tpu_torch.ops import norm_merge as nm
    from svbrdf_tpu_torch.ops import pathtrace
    from svbrdf_tpu_torch.ops import render_fused as rf
    from svbrdf_tpu_torch.ops import sr_adam
    from svbrdf_tpu_torch.ops import styled_tail as st

    counts = {k + rf.PLANE_DTYPES[dtype]: n
              for k, w in rf.CUDA_WRAPPERS.items()
              for dtype, n in w.launches_by_dtype.items()}
    counts.update({k + pathtrace.FIELD_DTYPES[dtype]: n
                   for k, w in pathtrace.CUDA_WRAPPERS.items()
                   for dtype, n in w.launches_by_dtype.items()})
    counts["sr_adam"] = sr_adam.sr_adam_multi_cuda.launches
    counts["norm_merge_fwd"] = nm.norm_merge_fwd_cuda.launches
    counts["norm_merge_bwd"] = nm.norm_merge_bwd_cuda.launches
    counts["styled_tail_fwd"] = st.styled_tail_fwd_cuda.launches
    counts["styled_tail_bwd"] = st.styled_tail_bwd_cuda.launches
    return counts


# The paths at full width (depth 8, 64 filters, 256^2, batch 8, seeded
# weights): (model kind, loss kind), compute dtype, master policy,
# renderer, and the loss kernels' launches (train step, eval step); sr_adam
# (one table a bf16-SR step) and the block tails come on top. The path
# tracer's kernels render the prediction in the compute dtype and the
# target in f32 (the path-traced loss does not cast it), and take the
# prediction's VJP.
PATHS = {
    "single_mixed": (("single", "mixed"), torch.float32, None, "local",
                     ({"mixed_fwdgrad": 1}, {"mixed_fwd": 1})),
    "multi_rendering": (("multi", "rendering"), torch.float32, None, "local",
                        ({"render_fwdgrad": 1}, {"render_fwd": 1})),
    "single_mixed_bf16": (("single", "mixed"), torch.bfloat16, "bf16sr",
                          "local", ({"mixed_fwdgrad_bf16": 1},
                                    {"mixed_fwd_bf16": 1})),
    "multi_rendering_bf16": (("multi", "rendering"), torch.bfloat16,
                             "bf16sr", "local",
                             ({"render_fwdgrad_bf16": 1},
                              {"render_fwd_bf16": 1})),
    "single_mixed_pathtracing": (
        ("single", "mixed"), torch.bfloat16, "bf16sr", "pathtracing",
        ({"pathtrace_shade_bf16": 1, "pathtrace_shade": 1,
          "pathtrace_shade_vjp_bf16": 1},
         {"pathtrace_shade_bf16": 1, "pathtrace_shade": 1})),
    "single_mixed_pathtracing_f32": (
        ("single", "mixed"), torch.float32, None, "pathtracing",
        ({"pathtrace_shade": 2, "pathtrace_shade_vjp": 1},
         {"pathtrace_shade": 2})),
}


def tail_launches(kind: str, train: int, forwards: int = 0,
                  depth: int = 8) -> dict:
    """The block tails' launches (ops.norm_merge) in `train` train steps
    and `forwards` more forwards of the `kind` model of `depth` blocks run
    whole on the card: a forward launches the forward kernel once a tail
    (tail_cases), a train step also the backward kernel."""
    tails = len(tail_cases(kind, 1, 2 ** depth, depth))
    return {"norm_merge_fwd": tails * (train + forwards),
            "norm_merge_bwd": tails * train}


def sr_adam_launches(model: torch.nn.Module) -> int:
    """sr_adam launches of one AdamBf16SR step of `model`: one per table
    of the leaves the last backward gave a gradient (one bucket: every leaf
    shares its param group and count)."""
    from svbrdf_tpu_torch.ops import sr_adam

    stepped = sum(p.grad is not None for p in model.parameters())
    return -(-stepped // sr_adam.max_leaves())


GRAD_EXACT = 1e-6  # a training kernel's gradient off its plain version's,
# over max |plain value|, at the paths' shapes


def grad_distance(actual: torch.Tensor, expected: torch.Tensor) -> float:
    """max |actual - expected| / max |expected| in float64: a training
    kernel's gradient against its plain version's, held to GRAD_EXACT at
    the paths' shapes. The two round every op alike (no FMA contraction,
    x / c as x * (1/c), as torch takes a tensor divided by a Python number)
    and agree to the last bit on an H100 with torch 2.11; a kernel that
    rounds one op otherwise is ~1e-4 away (a normal's gradient scales one
    ulp by up to 1/denom^3 ~ 1e9), so a torch that rounds these ops
    otherwise fails the rule with no fault in the kernel."""
    err = (actual.double() - expected.double()).abs().max()
    return float(err / expected.double().abs().max())


def sr_adam_model_leaves(kind: str, state: str, seed: int = 11,
                         device="cuda") -> list:
    """ops/sr_adam.SrLeaf of every leaf of the full-width `kind` model,
    random parameters, gradients and moments from `seed`. State 'bf16sr':
    the bf16-SR main path's dtypes (>=2-D leaves bf16 master, gradient and
    moments; 1-D f32); 'bf16': the 'bf16' state mode's (f32 parameters and
    gradients, bf16 mu, f32 nu)."""
    from svbrdf_tpu_torch.ops import sr_adam

    dev = resolve_device(device)
    shapes = [tuple(p.shape) for p in build_model(
        kind, False, 8, 64, device=dev).parameters()]
    g = torch.Generator(device=dev).manual_seed(seed)
    leaves = []
    for i, shape in enumerate(shapes):
        dt = torch.bfloat16 if len(shape) >= 2 else torch.float32
        dts = ((dt,) * 4 if state == "bf16sr" else
               (torch.float32, torch.float32, torch.bfloat16, torch.float32))
        ts = [(torch.randn(shape, generator=g, device=dev) * sc).to(d)
              for sc, d in zip((0.02, 1e-3, 1e-4), dts)]
        ts.append((torch.rand(shape, generator=g, device=dev)
                   * 1e-6).to(dts[3]))
        leaves.append(sr_adam.SrLeaf(i, *ts))
    return leaves


def hold_sr_adam_multi(leaves: list, s, launches: int) -> None:
    """The multi-tensor SR-Adam kernel on copies of `leaves` against
    parallel/optimizer.sr_adam_multi_plain on other copies, with the
    scalars `s`: raises AssertionError unless it launched `launches` times
    and p, mu and nu are equal to the bit, in their dtypes."""
    from svbrdf_tpu_torch.ops import sr_adam
    from svbrdf_tpu_torch.parallel import optimizer as opt

    def copy(lf):
        return sr_adam.SrLeaf(lf.index, *(t.clone() for t in lf[1:]))

    kern = [copy(lf) for lf in leaves]
    plain = [copy(lf) for lf in leaves]
    before = sr_adam.sr_adam_multi_cuda.launches
    sr_adam.sr_adam_multi_cuda(kern, s, {})
    assert sr_adam.sr_adam_multi_cuda.launches == before + launches
    opt.sr_adam_multi_plain(plain, s)
    torch.cuda.synchronize()
    for a, b in zip(kern, plain):
        for x, y in zip(a[1:], b[1:]):
            assert x.dtype == y.dtype and torch.equal(x, y)


def train_steps(program: dict, steps: int, group=None,
                state: Optional[dict] = None,
                batch: Optional[dict] = None, scenes=None,
                cudnn: bool = True, space=None,
                dropout_seed: Optional[int] = None,
                grads: bool = False) -> dict:
    """`steps` train steps of build_program(**program, group=group): world
    size 1 without a group, else this rank's part of the data-parallel
    run. Dropout off (ranks > 0 draw masks of their own, so runs of two
    world sizes compare only without it); `state`, a state dict, replaces the
    seeded weights; with `batch` (a prepared global batch on the CPU) and
    `scenes` (one global scene set a step) each step is update() on the
    rank's rows of them, else a step on the program's raw batch. The card's
    TF32 settings are the CLI's for the program's dtype
    (device.precision_scope: off for f32); `cudnn` False runs the steps
    with cuDNN off (torch's own convolutions, whose results do not depend
    on the algorithm cuDNN picks for a batch size).

    With a spatial group (`space`) this is the rank's part of the spatially
    sharded run (build_program's `space`): `batch` is given whole to every
    rank, and the weights come back from rank 0 alone. `dropout_seed` leaves
    dropout on, torch's default generators seeded with it first (a
    spatial run draws the masks one device draws); `grads` adds the last
    step's gradients ("grads", f32 on the CPU, None where a parameter has
    none).

    Returns {"losses": the group's mean loss a step, "params0" /
    "params": the weights before and after (f32, on the CPU), "launches":
    the kernel launches of the steps on each rank}, with a group or a
    spatial group also "checksums": each rank's replica checksum
    (mesh.replica_checksums)."""
    # Only cuDNN's on/off switch: torch.backends.cudnn.flags would also
    # reset its TF32 setting, which precision_scope owns.
    saved = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = cudnn
    try:
        with precision_scope(program.get("dtype", torch.float32)):
            return _train_steps(program, steps, group, state, batch, scenes,
                                space, dropout_seed, grads)
    finally:
        torch.backends.cudnn.enabled = saved


def _train_steps(program, steps, group, state, batch, scenes, space,
                 dropout_seed, grads) -> dict:
    if dropout_seed is not None:
        torch.manual_seed(dropout_seed)
    prog = build_program(**program, group=group, space=space)
    model = prog.model
    if state is not None:
        model.load_state_dict(state, strict=True)
    if dropout_seed is None:
        for m in model.modules():
            if isinstance(m, torch.nn.Dropout):
                m.eval()
    main = (space or group) is None or (space or group).is_main
    params0 = ([p.detach().float().cpu().clone() for p in model.parameters()]
               if main else None)
    dev = next(model.parameters()).device
    if batch is not None:
        rows = (slice(None) if group is None
                else group.rows(len(batch["svbrdf"])))
        batch = {k: v[rows].to(dev) for k, v in batch.items()}
    zero_launch_counts()
    losses = []
    for k in range(steps):
        if batch is None:
            loss = prog.train_step(prog.raw)
        else:
            loss = prog.train_step.update(
                batch, scenes=scenes[k].to(dev) if scenes else None)
        losses.append(float(loss))
    out = {"losses": losses, "params0": params0,
           "params": ([p.detach().float().cpu() for p in model.parameters()]
                      if main else None),
           "launches": [launch_counts()]}
    if grads and main:
        out["grads"] = [None if p.grad is None else p.grad.float().cpu()
                        for p in model.parameters()]
    if space is not None:
        group = space
    if group is not None:
        launches = [None] * group.world
        torch.distributed.all_gather_object(launches, out["launches"][0],
                                            group=group.host_group)
        out["launches"] = launches
        out["checksums"] = mesh.replica_checksums(model.parameters(), group)
    return out


def spatial_train_steps(program: dict, steps: int, group,
                        **kwargs) -> dict:
    """train_steps(program, steps, space=group, **kwargs): the rank's part
    of the spatially sharded run (a rank_runs job)."""
    return train_steps(program, steps, space=group, **kwargs)


def _steps_with_backend(args, kwargs, group) -> dict:
    """train_steps(*args, group=group, **kwargs), with the group's
    backend (a rank_runs job)."""
    return dict(train_steps(*args, group=group, **kwargs),
                backend=group.backend)


def data_parallel_runs(world: int, jobs: list,
                       backend: Optional[str] = None,
                       timeout: Optional[float] = None) -> list:
    """train_steps(*args, group=..., **kwargs) for each (args, kwargs) of
    `jobs`, in turn, over `world` ranks started for them (rank_runs), on
    the device type that every job's program asks for (build_program's
    default is the card; jobs that ask for two types raise before a rank
    starts): rank r on the CPU (gloo) or on cuda:r (NCCL); with backend
    'gloo' and a card every rank on cuda:0. Returns rank 0's results, each
    with the backend."""
    types = {torch.device(args[0].get("device", "cuda")).type
             for args, _ in jobs}
    if len(types) != 1:
        raise ValueError(f"the jobs ask for programs on {sorted(types)}; "
                         f"the ranks run on one device type")
    (device_type,) = types
    runs = rank_runs(world, [(_steps_with_backend, job, {}) for job in jobs],
                     device_type, backend, timeout)
    return [ranks[0] for ranks in runs]


def _jobs_rank(rank: int, world: int, address: str, device_type: str,
               backend: Optional[str], jobs: list, out_dir: str) -> None:
    device = ("cpu" if device_type == "cpu"
              else f"cuda:{rank if backend in (None, 'nccl') else 0}")
    group = mesh.init_group(world, rank, device, address, backend=backend)
    results = [fn(*args, group=group, **kwargs) for fn, args, kwargs in jobs]
    torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
    mesh.destroy_group()


def rank_runs(world: int, jobs: list, device_type: str = "cuda",
              backend: Optional[str] = None,
              timeout: Optional[float] = None) -> list:
    """fn(*args, group=group, **kwargs) for each (fn, args, kwargs) of
    `jobs`, in turn, in `world` ranks started for them (mesh.spawn,
    `timeout` seconds at most; `fn` a module-level function): rank r on the
    CPU (gloo) or on cuda:r (NCCL; fewer cards than ranks raises); with
    backend 'gloo' and a card every rank on cuda:0. Returns every rank's
    result of each job: results[job][rank]."""
    if backend != "gloo":
        mesh.make_mesh(world, device_type)
    with tempfile.TemporaryDirectory() as tmp:
        mesh.spawn(_jobs_rank, world,
                   (world, f"tcp://localhost:{mesh.free_port()}",
                    device_type, backend, jobs, tmp), timeout)
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                            weights_only=False) for r in range(world)]
    return [list(job) for job in zip(*ranks)]
