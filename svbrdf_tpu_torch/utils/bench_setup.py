"""The port's training programs and their inputs: local renderer, material
mixing, augmentation on, f32, Adam at lr 1e-5, and either the single-view
model with the mixed loss (the main path) or the multi-view model (3
views, all synthesized) with the rendering-only loss.

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
from svbrdf_tpu_torch.models import MultiViewModel, SingleViewModel
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
                device="cuda") -> tuple:
    """(pred planes, gt planes, packed scenes) at the loss kernels' shapes
    on `device`: gt and pred decoded from two synthetic raw batches (pred
    plays an untrained model's output), scenes from the loss sampler
    (3 random, n_scenes - 3 specular per item)."""
    from svbrdf_tpu_torch.data import pipeline
    from svbrdf_tpu_torch.ops import render_fused, sampling

    dev = resolve_device(device)

    def planes(s):
        raw = synthetic_raw_batch(batch, size, 0, s)["svbrdf"]
        return losses.to_planes(pipeline._decode_u8_svbrdf(
            torch.from_numpy(raw).to(dev)))

    g = torch.Generator(device=dev).manual_seed(seed)
    scenes = sampling.generate_loss_scenes(batch, 3, n_scenes - 3,
                                           generator=g, device=dev)
    return planes(seed + 1), planes(seed), render_fused.pack_scenes(scenes)


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
                  device="cuda") -> MainProgram:
    """Build a training program at the given widths, with weights and data
    made from `seed`, on `device`: model_kind "single" (one input view) or
    "multi" (3 views), loss_kind "mixed" or "rendering"."""
    if model_kind not in ("single", "multi"):
        raise ValueError(f"unknown model kind {model_kind!r}")
    dev = resolve_device(device)
    n_views = 3 if model_kind == "multi" else 1
    model_cls = MultiViewModel if model_kind == "multi" else SingleViewModel
    model = model_cls(num_filters, depth, device=dev, seed=seed)
    optimizer = make_optimizer(model.parameters(), 1e-5)
    loss_fn = losses.make_loss_fn(loss_kind, "local")
    prep = PrepConfig(used_input_image_count=n_views, use_augmentation=True,
                      is_linear=False, mix_materials=True)
    generator = torch.Generator(device=dev).manual_seed(seed + 1)
    raw = {k: torch.from_numpy(v).to(dev)
           for k, v in synthetic_raw_batch(batch, size, 0, seed).items()}
    return MainProgram(
        model=model,
        train_step=make_train_step(model, optimizer, loss_fn, prep,
                                   generator),
        eval_step=make_eval_step(model, loss_fn, prep, generator),
        predict=make_predict_fn(model), raw=raw, prep=prep,
        generator=generator)


def build_main_program(batch: int = 8, size: int = 256, depth: int = 8,
                       num_filters: int = 64, seed: int = 0,
                       device="cuda") -> MainProgram:
    """Build the single-view mixed-loss training program (the main path)."""
    return build_program("single", "mixed", batch, size, depth, num_filters,
                         seed, device)
