"""The main-path program and its inputs: single-view model, mixed loss,
local renderer, material mixing, augmentation on, f32.

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
from svbrdf_tpu_torch.models import SingleViewModel
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


@dataclass
class MainProgram:
    """The main path, ready to drive: train_step(raw), eval_step(raw),
    predict(images)."""

    model: SingleViewModel
    train_step: TrainStep
    eval_step: Callable
    predict: Callable
    raw: dict
    prep: PrepConfig
    generator: torch.Generator


def build_main_program(batch: int = 8, size: int = 256, depth: int = 8,
                       num_filters: int = 64, seed: int = 0,
                       device="cuda") -> MainProgram:
    """Build the single-view training program at the given widths, with
    weights and data made from `seed`, on `device`."""
    dev = resolve_device(device)
    model = SingleViewModel(num_filters, depth, device=dev, seed=seed)
    optimizer = make_optimizer(model.parameters(), 1e-5)
    loss_fn = losses.make_loss_fn("mixed", "local")
    prep = PrepConfig(used_input_image_count=1, use_augmentation=True,
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
