"""Map recovery by the rendering loss (a check that the renderer is
differentiable).

Counterpart of svbrdf_tpu/experiments/map_recovery.py: optimize chosen
maps of an SVBRDF directly (no network) until their renders match those of
a target material, under fixed scenes or fresh random scenes every step.
The loss renders with ops/render.render (or a given renderer) and takes
its gradient by autograd, as the JAX package's uses render.render and
value_and_grad; no fused kernel. Adam is torch.optim.Adam with optax's
defaults.

Clamping the maps to [0, 1] is a maximum then a minimum, as jnp.clip is:
at a value exactly on a bound the gradient splits evenly between the two,
where torch.clamp would pass it whole.

Latent capture (MaterialGAN; the port's own, no JAX counterpart):
`CaptureStep` optimizes a frozen generator's W+ and noise maps (models/
stylegan2) until renders of its maps under each material's flash scenes
match the photos, by the log-L1 rendering loss of
fixed_scene_rendering_loss with the photos as the target; `recover_latent`
iterates it. Departures from MaterialGAN: no VGG perceptual term, and W+
and noise are optimized together every iteration (MaterialGAN alternates).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence

import torch

from svbrdf_tpu_torch import losses
from svbrdf_tpu_torch.device import resolve_device
from svbrdf_tpu_torch.ops import codecs, render, sampling
from svbrdf_tpu_torch.parallel.step import stream_seed
from svbrdf_tpu_torch.scene import Scene
from svbrdf_tpu_torch.utils.profiling import span

# The stream of the per-step render generators (the JAX package's
# losses._RENDER_KEY_TAG): distinct from the scene draws' generator.
_RENDER_STREAM = 0x52454E44


def fixed_scene_rendering_loss(pred: torch.Tensor, target: torch.Tensor,
                               scenes: Scene, render_fn=None,
                               generator: Optional[torch.Generator] = None
                               ) -> torch.Tensor:
    """log-L1 rendering loss under a FIXED scene batch (no sampling).

    scenes have (S, 3) fields, svbrdfs are single samples (H, W, 12). A
    `generator` gives a renderer that takes one fresh samples (shared
    between pred and target: the generator is rewound for the target's
    render, common random numbers); without one the renderer keeps its
    fixed default samples.
    """
    render_fn = render_fn or render.render
    if generator is not None and losses._render_fn_accepts_generator(
            render_fn):
        state = generator.get_state()
        pred_r = render_fn(scenes, pred[None], generator=generator)
        generator.set_state(state)
        target_r = render_fn(scenes, target[None], generator=generator)
    else:
        pred_r = render_fn(scenes, pred[None])
        target_r = render_fn(scenes, target[None])
    return losses.l1_loss(torch.log(pred_r + losses.EPSILON_RENDER),
                          torch.log(target_r + losses.EPSILON_RENDER))


class RecoveryResult(NamedTuple):
    svbrdf: torch.Tensor  # (H, W, 12), on the device
    losses: torch.Tensor  # (steps,) per-step loss trace, f32


def _clip01(x: torch.Tensor) -> torch.Tensor:
    return torch.minimum(torch.maximum(x, x.new_tensor(0.0)),
                         x.new_tensor(1.0))


def recover_maps(generator: torch.Generator, target_svbrdf,
                 optimize: Sequence[str] = ("diffuse",),
                 steps: int = 200, learning_rate: float = 2e-2,
                 scenes: Optional[Scene] = None, n_scenes: int = 6,
                 render_fn: Optional[Callable] = None,
                 device="cuda") -> RecoveryResult:
    """Optimize chosen maps of an initially flat SVBRDF to match renders of
    `target_svbrdf` (H, W, 12; numpy or a tensor), on `device`.

    optimize: a subset of {"normals", "diffuse", "roughness", "specular"};
    the other maps are the target's. scenes=None draws n_scenes // 2
    random and the rest specular scenes from `generator` (on `device`)
    every step (the flexible-scene variant); a Scene batch of (S, 3) fields
    gives the fixed-scene variant. A renderer that takes a generator gets a
    fresh one each step, seeded from the generator's seed and the step (so
    the scene draws are not perturbed).
    """
    dev = resolve_device(device)
    target_svbrdf = torch.as_tensor(target_svbrdf).to(dev, torch.float32)
    target = codecs.unpack_svbrdf(target_svbrdf)
    if scenes is not None:
        scenes = scenes.to(dev)

    init = {}
    if "normals" in optimize:
        flat = torch.zeros_like(target.normals)
        flat[..., 2] = 1.0
        init["normals"] = flat
    for name in ("diffuse", "roughness", "specular"):
        if name in optimize:
            init[name] = torch.full_like(getattr(target, name), 0.5)
    free = {k: v.requires_grad_() for k, v in init.items()}

    def assemble(free):
        maps = {k: free.get(k, getattr(target, k))
                for k in ("normals", "diffuse", "roughness", "specular")}
        n = maps["normals"]
        n = n / torch.sqrt(torch.sum(n * n, dim=-1, keepdim=True) + 1e-8)
        return codecs.pack_svbrdf(n, _clip01(maps["diffuse"]),
                                  _clip01(maps["roughness"]),
                                  _clip01(maps["specular"]))

    optimizer = torch.optim.Adam(list(free.values()), lr=learning_rate,
                                 eps=1e-8)
    threads_generator = (render_fn is not None
                         and losses._render_fn_accepts_generator(render_fn))

    def loss_of(step: int) -> torch.Tensor:
        pred = assemble(free)
        render_gen = None
        if threads_generator:
            render_gen = torch.Generator(device=dev).manual_seed(stream_seed(
                generator.initial_seed(), step, _RENDER_STREAM))
        step_scenes = scenes
        if step_scenes is None:
            drawn = sampling.generate_loss_scenes(
                1, n_random=n_scenes // 2,
                n_specular=n_scenes - n_scenes // 2, generator=generator,
                device=dev)
            step_scenes = Scene(drawn.camera_pos[0], drawn.light_pos[0],
                                drawn.light_color[0])
        return fixed_scene_rendering_loss(pred, target_svbrdf, step_scenes,
                                          render_fn, generator=render_gen)

    trace = []
    for i in range(steps):
        optimizer.zero_grad(set_to_none=True)
        loss = loss_of(i)
        loss.backward()
        optimizer.step()
        trace.append(loss.detach())

    with torch.no_grad():
        svbrdf = assemble(free)
    return RecoveryResult(svbrdf=svbrdf, losses=torch.stack(trace))


class CaptureStep:
    """One iteration of latent capture over B materials at once.

    model: a StyleGAN2Generator (models.build_model("materialgan")), frozen
    here (requires_grad_(False): no weight gradient is taken). photos (B,
    N, H, W, 3) linear flash photos and scenes, a Scene of (B, N, 3)
    fields: photo n of material b is lit and seen as scene (b, n). wplus
    (B, num_ws, w_dim) defaults to model.w_avg in every row; noises to
    model.make_noises(B, generator). Both are copied, and optimized by
    torch.optim.Adam (eps 1e-8).

    A call: synthesis and decode to the maps (B, H, W, 12), render.render
    under each material's scenes, losses.l1_loss of log(render +
    EPSILON_RENDER) against log(photo + EPSILON_RENDER), backward, Adam;
    it returns the loss (a device scalar) and counts itself in `steps`.
    The four phases are the spans capture.synthesis, capture.loss,
    capture.backward and capture.optimizer.
    """

    def __init__(self, model, photos: torch.Tensor, scenes: Scene,
                 wplus: Optional[torch.Tensor] = None, noises=None,
                 learning_rate: float = 2e-2,
                 generator: Optional[torch.Generator] = None):
        self.model = model.requires_grad_(False)
        batch = photos.shape[0]
        if wplus is None:
            wplus = model.w_avg.expand(batch, model.num_ws, -1)
        if noises is None:
            noises = model.make_noises(batch, generator)
        self.wplus = wplus.detach().clone().requires_grad_()
        self.noises = [n.detach().clone().requires_grad_() for n in noises]
        self.scenes = scenes
        self.target = torch.log(photos + losses.EPSILON_RENDER)
        self.optimizer = torch.optim.Adam([self.wplus, *self.noises],
                                          lr=learning_rate, eps=1e-8)
        self.steps = 0

    def maps(self) -> torch.Tensor:
        """The generator's maps (B, H, W, 12) at the current latents."""
        return self.model(self.wplus, self.noises)

    def __call__(self) -> torch.Tensor:
        with span("capture.synthesis"):
            maps = self.maps()
        with span("capture.loss"):
            renders = render.render(self.scenes, maps[:, None])
            loss = losses.l1_loss(
                torch.log(renders + losses.EPSILON_RENDER), self.target)
        with span("capture.backward"):
            self.optimizer.zero_grad(set_to_none=True)
            loss.backward()
        with span("capture.optimizer"):
            self.optimizer.step()
        self.steps += 1
        return loss.detach()


class CaptureResult(NamedTuple):
    svbrdf: torch.Tensor  # (B, H, W, 12), on the device
    losses: torch.Tensor  # (steps,) per-step loss trace, f32
    wplus: torch.Tensor  # (B, num_ws, w_dim)
    noises: list  # the noise maps, (B, 1, r, r) each


def recover_latent(model, photos, scenes: Scene, steps: int = 200,
                   learning_rate: float = 2e-2,
                   generator: Optional[torch.Generator] = None
                   ) -> CaptureResult:
    """`steps` iterations of CaptureStep(model, photos, scenes) from w_avg
    and noise drawn from `generator`, on the model's device."""
    step = CaptureStep(model, photos, scenes, learning_rate=learning_rate,
                       generator=generator)
    trace = torch.stack([step() for _ in range(steps)])
    with torch.no_grad():
        svbrdf = step.maps()
    return CaptureResult(svbrdf, trace, step.wplus.detach(),
                         [n.detach() for n in step.noises])
