"""The port's training programs and their inputs: local renderer (or the
path tracer), material mixing, augmentation on, Adam at lr 1e-5, f32 or
bf16 compute (with f32 or bf16-SR masters), and either the single-view model with the mixed loss
(the main path) or the multi-view model (3 views, all synthesized) with
the rendering-only loss. The same code as the CLI's builds the models,
masters and optimizers (models.build_model, parallel/step).

Counterpart of svbrdf_tpu/utils/bench_setup.py (synthetic_raw_batch and
build_headline_program) for the port: one place that builds what
chip_smoke.py drives, so the two cannot drift apart.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from svbrdf_tpu_torch import losses
from svbrdf_tpu_torch.device import resolve_device
from svbrdf_tpu_torch.models import build_model
from svbrdf_tpu_torch.parallel import step as step_lib
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
                        trials: int = 4, seed: int = 0) -> torch.Tensor:
    """The scale of f32 rounding's effect on each path-traced render value:
    the most that flipping every map value by one f32 ulp (relative 2^-24,
    random signs from `seed`) moves the float64 render (render_mc on the
    float64 inputs), over `trials` draws. One ulp of n.h moves the Blinn
    lobe pow(n.h, e) by up to e ulps (e reaches 2e4), so where f32 is
    ill-conditioned this is large."""
    from svbrdf_tpu_torch.ops import pathtrace

    def f64(x):
        return x.detach().double().cpu()

    scene = type(scene)(*map(f64, (scene.camera_pos, scene.light_pos,
                                   scene.light_color)))
    samples = pathtrace.RenderSamples(*(pathtrace.Samples(*map(f64, s))
                                        for s in samples))
    svbrdf = f64(svbrdf)
    base = pathtrace.render_mc(scene, svbrdf, samples)
    g = torch.Generator().manual_seed(seed)
    worst = torch.zeros_like(base)
    for _ in range(trials):
        sign = torch.randint(0, 2, svbrdf.shape, generator=g) * 2 - 1
        moved = pathtrace.render_mc(scene, svbrdf * (1 + sign * 2.0 ** -24),
                                    samples)
        worst = torch.maximum(worst, (moved - base).abs())
    return worst


def hold_render(actual, ref, ref64, cond, rtol: float = 1e-5) -> dict:
    """The path tracer's render tolerance (each a tensor of render values,
    `cond` from render_conditioning): every value within rel `rtol` of
    `ref`, or no further from the float64 `ref64` than 4x the largest of
    `ref`'s own distance from it, rel `rtol` and `cond`; at most 1 % of
    the values beyond rel `rtol`. Raises RuntimeError otherwise; returns
    the share beyond rtol and the largest deviation from float64 over its
    allowance."""
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
    bad = ~(near | (dist <= allowed))
    if bool(bad.any()) or out["beyond_rtol"] > 0.01:
        raise RuntimeError(f"path-traced renders: {int(bad.sum())} "
                             f"values beyond both tolerances; {out}")
    return out


def kernel_ms(name: str, inputs, kernel=None, reps: int = 10,
              runs: int = 20) -> float:
    """Device time of one raw launch of loss kernel `name` on `inputs`
    (loss_inputs on the card): the median over `runs` of `reps`
    back-to-back launches between two CUDA events, divided by reps. A launch
    queued before the start event keeps the card busy while the host queues
    the rest, so the events time the kernels alone (no wrapper sum of the
    partials, no host gaps). `kernel` is as for render_fused._launch."""
    from svbrdf_tpu_torch.ops import render_fused as rf

    pred_t, _, scenes9 = inputs
    floats = rf.kernel_floats(name, pred_t, scenes9)

    def launch():
        rf._launch(name, *inputs, 0, 0, floats, kernel)

    for _ in range(3):
        launch()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        launch()
        start.record()
        for _ in range(reps):
            launch()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / reps)
    return float(np.median(times))


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
                  master_dtype=None, renderer: str = "local") -> MainProgram:
    """Build a training program at the given widths, with weights and data
    made from `seed`, on `device`: model_kind "single" (one input view) or
    "multi" (3 views), loss_kind "mixed" or "rendering" with `renderer`
    "local" (the fused loss kernels) or "pathtracing"; the model
    computing in `dtype`, its masters cast by the policy `master_dtype`
    ('f32' | 'bf16sr'; None: the policy in force)."""
    if model_kind not in ("single", "multi"):
        raise ValueError(f"unknown model kind {model_kind!r}")
    dev = resolve_device(device)
    n_views = 3 if model_kind == "multi" else 1
    model = build_model(model_kind, False, depth, num_filters, device=dev,
                        seed=seed, dtype=dtype)
    with step_lib.master_dtype_scope():
        if master_dtype is not None:
            step_lib.set_master_dtype_policy(master_dtype)
        step_lib.master_cast(model)
    optimizer = make_optimizer(model.parameters(), 1e-5, dtype)
    loss_fn = losses.make_loss_fn(loss_kind, renderer)
    prep = PrepConfig(used_input_image_count=n_views, use_augmentation=True,
                      is_linear=False, mix_materials=True)
    generator = torch.Generator(device=dev).manual_seed(seed + 1)
    raw = {k: torch.from_numpy(v).to(dev)
           for k, v in synthetic_raw_batch(batch, size, 0, seed).items()}
    return MainProgram(
        model=model,
        train_step=make_train_step(model, optimizer, loss_fn, prep,
                                   generator, seed=seed),
        eval_step=make_eval_step(model, loss_fn, prep, generator),
        predict=make_predict_fn(model), raw=raw, prep=prep,
        generator=generator)


def build_main_program(batch: int = 8, size: int = 256, depth: int = 8,
                       num_filters: int = 64, seed: int = 0,
                       device="cuda") -> MainProgram:
    """Build the single-view mixed-loss training program (the main path)."""
    return build_program("single", "mixed", batch, size, depth, num_filters,
                         seed, device)
