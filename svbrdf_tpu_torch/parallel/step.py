"""Train, eval and predict steps.

Counterpart of svbrdf_tpu/parallel/step.py on one device: on-device batch
preparation -> model -> loss -> backward -> Adam. PyTorch runs eagerly, so
a step is a plain callable; the random draws of preparation and of the loss
scenes come from the step's torch.Generator, and dropout from torch's
default generator of the device.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Callable, NamedTuple

import torch

from svbrdf_tpu_torch.data import pipeline


class PrepConfig(NamedTuple):
    """Batch-preparation switches (see data/pipeline.prepare_batch)."""

    used_input_image_count: int = 1
    use_augmentation: bool = True
    is_linear: bool = False
    mix_materials: bool = False


def prepare(raw_batch: dict, prep: PrepConfig,
            generator: torch.Generator) -> dict:
    """Run pipeline.prepare_batch on a raw batch {'inputs', 'svbrdf'[,
    'partner_svbrdf']} of tensors on the device."""
    return pipeline.prepare_batch(
        raw_batch["inputs"], raw_batch["svbrdf"],
        raw_batch.get("partner_svbrdf") if prep.mix_materials else None,
        used_input_image_count=prep.used_input_image_count,
        use_augmentation=prep.use_augmentation, is_linear=prep.is_linear,
        generator=generator)


def make_optimizer(params, learning_rate: float = 1e-5) -> torch.optim.Adam:
    """f32 Adam with optax.adam's defaults (b1 0.9, b2 0.999, eps 1e-8
    added outside the square root, bias-corrected): the same update."""
    return torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999),
                            eps=1e-8)


class TrainStep:
    """step(raw_batch) -> loss: prepare, forward (in the model's current
    mode: training, so dropout on, unless the caller changed it), loss,
    backward, Adam update. `update(batch, scenes=None)` runs the same
    on a prepared batch, optionally with given loss scenes."""

    def __init__(self, model, optimizer, loss_fn: Callable, prep: PrepConfig,
                 generator: torch.Generator):
        self.model = model
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.prep = prep
        self.generator = generator

    def update(self, batch: dict, scenes=None) -> torch.Tensor:
        pred = self.model(batch["inputs"])
        loss = self.loss_fn(pred, batch["svbrdf"], self.generator,
                            scenes=scenes)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        return loss.detach()

    def __call__(self, raw_batch: dict) -> torch.Tensor:
        return self.update(prepare(raw_batch, self.prep, self.generator))


def make_train_step(model, optimizer, loss_fn: Callable, prep: PrepConfig,
                    generator: torch.Generator) -> TrainStep:
    return TrainStep(model, optimizer, loss_fn, prep, generator)


@contextmanager
def _eval_mode(model):
    """Dropout off for the duration; every submodule's mode restored after."""
    modes = [(m, m.training) for m in model.modules()]
    model.eval()
    try:
        yield
    finally:
        for m, training in modes:
            m.training = training


def make_eval_step(model, loss_fn: Callable, prep: PrepConfig,
                   generator: torch.Generator):
    """Validation step: eval(raw_batch, scenes=None) -> loss with dropout
    off, the same loss, value only (under no_grad the value-only kernel
    runs)."""

    def eval_step(raw_batch: dict, scenes=None) -> torch.Tensor:
        with torch.no_grad(), _eval_mode(model):
            batch = prepare(raw_batch, prep, generator)
            pred = model(batch["inputs"])
            return loss_fn(pred, batch["svbrdf"], generator, scenes=scenes)

    return eval_step


def make_predict_fn(model):
    """Inference: images (B, [N,] H, W, 3) -> SVBRDF maps (B, H, W, 12)."""

    def predict(images: torch.Tensor) -> torch.Tensor:
        with torch.no_grad(), _eval_mode(model):
            return model(images)

    return predict
