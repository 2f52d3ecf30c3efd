"""SVBRDF losses: map-space L1, rendering loss, mixed loss.

Counterpart of svbrdf_tpu/losses.py. `svbrdf_l1_loss`, `rendering_loss` and
`mixed_loss` are plain autograd compositions over NHWC (B, H, W, 12)
tensors; they are the oracle the fused kernels are held against. The scenes
of the rendering loss are passed in (the caller draws them with
ops.sampling.generate_loss_scenes), so tests can hand both frameworks the
same scenes.
"""

from __future__ import annotations

import torch

from svbrdf_tpu_torch.ops import codecs, render, render_fused, sampling
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


def rendering_loss(pred: torch.Tensor, target: torch.Tensor,
                   scenes: Scene) -> torch.Tensor:
    """L1 between log(render + 0.1) of pred and target under per-item
    scene sets (fields (B, S, 3))."""
    pred_r = render.render_scene_set(scenes, pred)
    target_r = render.render_scene_set(scenes, target)
    return l1_loss(torch.log(pred_r + EPSILON_RENDER),
                   torch.log(target_r + EPSILON_RENDER))


def mixed_loss(pred: torch.Tensor, target: torch.Tensor, scenes: Scene,
               l1_weight: float = 0.1) -> torch.Tensor:
    """l1_weight * svbrdf_l1_loss + rendering_loss."""
    return (l1_weight * svbrdf_l1_loss(pred, target)
            + rendering_loss(pred, target, scenes))


def to_planes(svbrdf: torch.Tensor) -> torch.Tensor:
    """NHWC (B, H, W, 12) -> contiguous (B, 12, H, W) channel planes."""
    return svbrdf.permute(0, 3, 1, 2).contiguous()


def make_loss_fn(kind: str = "mixed", renderer: str = "local",
                 l1_weight: float = 0.1):
    """Build loss_fn(pred, target, generator=None, scenes=None) -> scalar.

    pred/target are NHWC (B, H, W, 12). The rendering terms draw 3 random
    and 6 specular scenes per item from `generator` unless `scenes` is
    given. kinds "mixed" and "rendering" go through the fused kernels
    (ops/render_fused): the CUDA kernels for CUDA tensors, their plain
    versions for CPU tensors; the target is cast to pred's dtype (f32 or
    bf16 planes) and gets no gradient. kind "l1" is plain.
    """
    if renderer != "local":
        raise NotImplementedError(
            f"renderer {renderer!r} is not ported; only 'local' is")
    if kind == "l1":
        def l1_fn(pred, target, generator=None, scenes=None):
            return svbrdf_l1_loss(pred, target)

        return l1_fn

    def draw(pred, generator, scenes):
        if scenes is not None:
            return scenes
        return sampling.generate_loss_scenes(
            pred.shape[0], N_RANDOM_SCENES, N_SPECULAR_SCENES,
            generator=generator, device=pred.device)

    if kind == "rendering":
        def rendering_fn(pred, target, generator=None, scenes=None):
            return render_fused.rendering_loss_fused_planes(
                to_planes(pred), to_planes(target.to(pred.dtype)),
                draw(pred, generator, scenes))

        return rendering_fn
    if kind == "mixed":
        def mixed_fn(pred, target, generator=None, scenes=None):
            return render_fused.mixed_loss_fused_planes(
                to_planes(pred), to_planes(target.to(pred.dtype)),
                draw(pred, generator, scenes), l1_weight)

        return mixed_fn
    raise ValueError(f"unknown loss kind {kind!r}")
