"""SVBRDF losses: map-space L1, rendering loss, mixed loss.

Counterpart of svbrdf_tpu/losses.py. `svbrdf_l1_loss`, `rendering_loss` and
`mixed_loss` are plain autograd compositions over NHWC (B, H, W, 12)
tensors: the oracle the fused kernels are held against, and with the path
tracer (ops/pathtrace) the losses of --renderer pathtracing. The scenes
of the rendering loss are passed in (the caller draws them with
ops.sampling.generate_loss_scenes), so tests can hand both frameworks the
same scenes.
"""

from __future__ import annotations

import inspect

import torch

from svbrdf_tpu_torch.ops import (codecs, pathtrace, render, render_fused,
                                  sampling)
from svbrdf_tpu_torch.ops.render_fused import EPSILON_L1, EPSILON_RENDER
from svbrdf_tpu_torch.scene import Scene

N_RANDOM_SCENES = 3
N_SPECULAR_SCENES = 6


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred - target))


def svbrdf_l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """L1 on normals/roughness + L1 in log(x + 0.01) space on diffuse and
    specular: the sum of the four per-map means."""
    p = codecs.unpack_svbrdf(pred)
    t = codecs.unpack_svbrdf(target)
    return (l1_loss(p.normals, t.normals)
            + l1_loss(torch.log(p.diffuse + EPSILON_L1),
                      torch.log(t.diffuse + EPSILON_L1))
            + l1_loss(p.roughness, t.roughness)
            + l1_loss(torch.log(p.specular + EPSILON_L1),
                      torch.log(t.specular + EPSILON_L1)))


def _render_fn_accepts_generator(render_fn) -> bool:
    """True if a renderer-protocol fn takes the optional per-call sampling
    `generator` kwarg: declared by an `accepts_generator` attribute (the
    path tracer's render fns have one), else read from its signature. A
    callable whose signature cannot be read raises rather than silently
    rendering every step on the same samples."""
    declared = getattr(render_fn, "accepts_generator", None)
    if declared is not None:
        return bool(declared)
    try:
        params = inspect.signature(render_fn).parameters
    except (TypeError, ValueError):  # builtins / odd callables
        raise TypeError(
            f"renderer {render_fn!r} has no inspectable signature; set "
            f"render_fn.accepts_generator = True/False explicitly so the "
            f"rendering loss knows whether to thread its generator") \
            from None
    return ("generator" in params
            or any(p.kind is inspect.Parameter.VAR_KEYWORD
                   for p in params.values()))


def rendering_loss(pred: torch.Tensor, target: torch.Tensor, scenes: Scene,
                   render_fn=None, generator=None,
                   samples=None) -> torch.Tensor:
    """L1 between log(render + 0.1) of pred and target under per-item
    scene sets (fields (B, S, 3)), rendered by `render_fn` (default: the
    local renderer, render.render).

    A renderer that takes a generator draws its samples from `generator`,
    and pred and target share them (common random numbers: the generator
    is rewound to its state before pred's render for the target's, so it
    advances as for one render and the loss is exactly 0 at pred ==
    target). `samples` hands the renderer given samples instead (both
    renders share them too)."""
    if render_fn is None:
        pred_r = render.render_scene_set(scenes, pred)
        target_r = render.render_scene_set(scenes, target)
    elif samples is not None:
        pred_r = render_fn(scenes, pred[:, None], samples=samples)
        target_r = render_fn(scenes, target[:, None], samples=samples)
    elif _render_fn_accepts_generator(render_fn) and generator is not None:
        state = generator.get_state()
        pred_r = render_fn(scenes, pred[:, None], generator=generator)
        generator.set_state(state)
        target_r = render_fn(scenes, target[:, None], generator=generator)
    else:
        pred_r = render_fn(scenes, pred[:, None])
        target_r = render_fn(scenes, target[:, None])
    return l1_loss(torch.log(pred_r + EPSILON_RENDER),
                   torch.log(target_r + EPSILON_RENDER))


def mixed_loss(pred: torch.Tensor, target: torch.Tensor, scenes: Scene,
               l1_weight: float = 0.1, render_fn=None, generator=None,
               samples=None) -> torch.Tensor:
    """l1_weight * svbrdf_l1_loss + rendering_loss."""
    return (l1_weight * svbrdf_l1_loss(pred, target)
            + rendering_loss(pred, target, scenes, render_fn, generator,
                             samples))


def to_planes(svbrdf: torch.Tensor) -> torch.Tensor:
    """NHWC (B, H, W, 12) -> contiguous (B, 12, H, W) channel planes."""
    return svbrdf.permute(0, 3, 1, 2).contiguous()


def make_loss_fn(kind: str = "mixed", renderer: str = "local",
                 l1_weight: float = 0.1, spp=(16, 8)):
    """Build loss_fn(pred, target, generator=None, scenes=None) -> scalar.

    pred/target are NHWC (B, H, W, 12). The rendering terms draw 3 random
    and 6 specular scenes per item from `generator` unless `scenes` is
    given. With the local renderer, kinds "mixed" and "rendering" go
    through the fused kernels (ops/render_fused): the CUDA kernels for
    CUDA tensors, their plain versions for CPU tensors; the target is cast
    to pred's dtype (f32 or bf16 planes) and gets no gradient. With the
    path tracer (renderer "pathtracing") they are the unfused
    rendering_loss / mixed_loss over ops/pathtrace.make_render_fn(spp)
    (16 forward, 8 backward samples), as in the JAX package: the generator
    draws the scenes, then the render samples, unless the loss fn is given
    `samples=` (pathtrace.RenderSamples); the target keeps its dtype.
    kind "l1" is plain. The fn's `draws` names what it draws, in order
    (draw_loss_inputs), and a path-traced fn's `spp` its samples.
    """
    if renderer not in ("local", "pathtracing"):
        raise ValueError(f"unknown renderer {renderer!r}")
    if kind == "l1":
        def l1_fn(pred, target, generator=None, scenes=None):
            return svbrdf_l1_loss(pred, target)

        l1_fn.draws = ()
        return l1_fn

    def draw(pred, generator, scenes):
        if scenes is not None:
            return scenes
        return sampling.generate_loss_scenes(
            pred.shape[0], N_RANDOM_SCENES, N_SPECULAR_SCENES,
            generator=generator, device=pred.device)

    if kind not in ("rendering", "mixed"):
        raise ValueError(f"unknown loss kind {kind!r}")
    if renderer == "pathtracing":
        render_fn = pathtrace.make_render_fn(spp)
        weight = None if kind == "rendering" else l1_weight

        def traced_fn(pred, target, generator=None, scenes=None,
                      samples=None):
            scenes = draw(pred, generator, scenes)
            if weight is None:
                return rendering_loss(pred, target, scenes, render_fn,
                                      generator, samples)
            return mixed_loss(pred, target, scenes, weight, render_fn,
                              generator, samples)

        traced_fn.draws = ("scenes", "samples")
        traced_fn.spp = tuple(spp)
        return traced_fn
    if kind == "rendering":
        def rendering_fn(pred, target, generator=None, scenes=None):
            return render_fused.rendering_loss_fused_planes(
                to_planes(pred), to_planes(target.to(pred.dtype)),
                draw(pred, generator, scenes))

        rendering_fn.draws = ("scenes",)
        return rendering_fn

    def mixed_fn(pred, target, generator=None, scenes=None):
        return render_fused.mixed_loss_fused_planes(
            to_planes(pred), to_planes(target.to(pred.dtype)),
            draw(pred, generator, scenes), l1_weight)

    mixed_fn.draws = ("scenes",)
    return mixed_fn


def draw_loss_inputs(loss_fn, batch: int, height: int, width: int,
                     generator: torch.Generator, device=None, scenes=None,
                     samples=None) -> dict:
    """What a make_loss_fn loss draws from `generator` for `batch` items of
    height x width (loss_fn.draws: the scenes, then a path-traced loss's
    render samples), in its order, as the keyword arguments that hand the
    loss those draws; `scenes` or `samples` given are kept, not drawn."""
    draws = {}
    if "scenes" in loss_fn.draws:
        draws["scenes"] = scenes if scenes is not None else (
            sampling.generate_loss_scenes(batch, N_RANDOM_SCENES,
                                          N_SPECULAR_SCENES,
                                          generator=generator,
                                          device=device))
    if "samples" in loss_fn.draws:
        draws["samples"] = samples if samples is not None else (
            pathtrace.draw_render_samples(
                generator, loss_fn.spp,
                (batch, N_RANDOM_SCENES + N_SPECULAR_SCENES), height, width,
                device))
    return draws
