"""Train, eval and predict steps.

Counterpart of svbrdf_tpu/parallel/step.py on one device: on-device batch
preparation -> model -> loss -> backward -> Adam. PyTorch runs eagerly, so
a step is a plain callable; the random draws of preparation and of the loss
scenes come from the step's torch.Generator, and dropout from torch's
default generator of the device.

Precision, as in the JAX package: a model computing in bf16 (its
`compute_dtype`) gets its prepared inputs and its f32 maps cast to bf16 at
the step's boundaries (the fused loss then runs its bf16 kernels), Adam
with bf16 state (make_optimizer), and under the master-dtype policy
'bf16sr' (master_dtype_policy) bf16 >=2-D parameters, updated with
stochastic rounding salted per step from (seed, step) on the host.
"""

from __future__ import annotations

import os
from contextlib import contextmanager
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from svbrdf_tpu_torch.data import pipeline
from svbrdf_tpu_torch.parallel.optimizer import AdamBf16SR


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


def compute_dtype(model) -> torch.dtype:
    """The dtype `model` computes in (f32 unless it says otherwise)."""
    return getattr(model, "compute_dtype", torch.float32)


def make_optimizer(params, learning_rate: float = 1e-5,
                   model_dtype=torch.float32,
                   state_precision: Optional[str] = None):
    """Adam for the model's compute dtype, with optax.adam's defaults (b1
    0.9, b2 0.999, eps 1e-8 added outside the square root,
    bias-corrected).

    state_precision: None (SVBRDF_OPT_STATE, default 'auto') | 'auto' |
    'f32' | 'bf16' (mu only) | 'bf16sr'; 'auto' is 'bf16sr' for a bf16
    model and 'f32' otherwise. An f32 model with f32 state gets
    torch.optim.Adam, the same update; every other case AdamBf16SR
    (parallel/optimizer.py), which also updates bf16 masters."""
    if state_precision is None:
        state_precision = os.environ.get("SVBRDF_OPT_STATE", "auto")
    if state_precision == "auto":
        state_precision = ("bf16sr" if model_dtype == torch.bfloat16
                           else "f32")
    if state_precision == "f32" and model_dtype != torch.bfloat16:
        return torch.optim.Adam(params, lr=learning_rate,
                                betas=(0.9, 0.999), eps=1e-8)
    return AdamBf16SR(params, lr=learning_rate, precision=state_precision)


# The process-wide master-dtype override (the CLI's --master-dtype or a
# checkpoint's recorded policy); None leaves it to SVBRDF_MASTER_DTYPE.
_MASTER_DTYPE_OVERRIDE = None
MASTER_DTYPE_POLICIES = ("f32", "bf16sr")


def set_master_dtype_policy(policy) -> None:
    """Set the master-dtype policy ('f32' | 'bf16sr'; None: back to the
    environment variable)."""
    global _MASTER_DTYPE_OVERRIDE
    if policy is not None and policy not in MASTER_DTYPE_POLICIES:
        raise ValueError(f"unknown master dtype policy '{policy}'")
    _MASTER_DTYPE_OVERRIDE = policy


@contextmanager
def master_dtype_scope():
    """Restore the master-dtype override found at entry on exit, so a run
    that sets it (training/loop.py) does not hand its policy to a later run
    in the same process."""
    prev = _MASTER_DTYPE_OVERRIDE
    try:
        yield
    finally:
        set_master_dtype_policy(prev)


def master_dtype_policy() -> str:
    """Master-parameter storage policy for bf16 models: the override, else
    SVBRDF_MASTER_DTYPE, default 'bf16sr'.

    'bf16sr': >=2-D parameters stored bf16 and updated with stochastic
    rounding (unbiased); 1-D ones (biases, norm scales) stay f32.
    'f32': f32 masters, cast to bf16 where the layers use them."""
    if _MASTER_DTYPE_OVERRIDE is not None:
        return _MASTER_DTYPE_OVERRIDE
    return os.environ.get("SVBRDF_MASTER_DTYPE", "bf16sr")


@torch.no_grad()
def master_cast(model, model_dtype=None):
    """Bring `model`'s parameters (f32, freshly made or restored) to the
    storage dtypes the policy trains in: under 'bf16sr' and with a bf16
    model, every >=2-D parameter becomes bf16 in place (the Parameter
    objects stay, so an optimizer built before still holds them)."""
    if model_dtype is None:
        model_dtype = compute_dtype(model)
    if master_dtype_policy() == "bf16sr" and model_dtype == torch.bfloat16:
        for p in model.parameters():
            if p.dim() >= 2:
                p.data = p.data.to(torch.bfloat16)
    return model


# Entropy word of the master-SR salt stream beside a step's (seed, step)
# draws (the JAX step folds 17 into its step key for the same salt).
_MASTER_SALT_STREAM = 17


def stream_seed(*words: int) -> int:
    """A 64-bit seed from integers (seed, step, ...): distinct word lists
    give independent streams."""
    return int(np.random.SeedSequence(list(words)).generate_state(
        2, np.uint64)[0])


def master_salt(seed: int, step: int) -> int:
    """The bf16 masters' SR salt of training step `step`, a host integer in
    [0, 2^31 - 1) as the JAX step's randint draw."""
    return stream_seed(seed, step, _MASTER_SALT_STREAM) % (2 ** 31 - 1)


class TrainStep:
    """step(raw_batch, step=None) -> loss: prepare, forward (in the model's
    current mode: training, so dropout on, unless the caller changed it),
    loss, backward, Adam update. `update(batch, scenes=None, step=None)`
    runs the same on a prepared batch, optionally with given loss scenes.

    A bf16 model gets its inputs and its maps cast to bf16 (`forward`).
    `step` numbers the training step (the loop passes its own; by default
    the one after the last): with bf16 masters it picks the SR salt,
    master_salt(seed, step), so a step is repeatable from (seed, step)."""

    def __init__(self, model, optimizer, loss_fn: Callable, prep: PrepConfig,
                 generator: torch.Generator, seed: int = 0):
        self.model = model
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.prep = prep
        self.generator = generator
        self.seed = seed
        self.dtype = compute_dtype(model)
        self.step_index = 0

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        """The model's maps in its compute dtype."""
        return self.model(inputs.to(self.dtype)).to(self.dtype)

    def apply_gradients(self, step: int) -> None:
        """The optimizer step of training step `step`."""
        if isinstance(self.optimizer, AdamBf16SR):
            self.optimizer.step(master_salt=master_salt(self.seed, step))
        else:
            self.optimizer.step()

    def update(self, batch: dict, scenes=None,
               step: Optional[int] = None) -> torch.Tensor:
        step = self.step_index + 1 if step is None else step
        pred = self.forward(batch["inputs"])
        loss = self.loss_fn(pred, batch["svbrdf"], self.generator,
                            scenes=scenes)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.apply_gradients(step)
        self.step_index = step
        return loss.detach()

    def __call__(self, raw_batch: dict,
                 step: Optional[int] = None) -> torch.Tensor:
        return self.update(prepare(raw_batch, self.prep, self.generator),
                           step=step)


def make_train_step(model, optimizer, loss_fn: Callable, prep: PrepConfig,
                    generator: torch.Generator, seed: int = 0) -> TrainStep:
    return TrainStep(model, optimizer, loss_fn, prep, generator, seed)


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
    runs); a bf16 model's inputs and maps cast as in TrainStep."""
    dt = compute_dtype(model)

    def eval_step(raw_batch: dict, scenes=None) -> torch.Tensor:
        with torch.no_grad(), _eval_mode(model):
            batch = prepare(raw_batch, prep, generator)
            pred = model(batch["inputs"].to(dt)).to(dt)
            return loss_fn(pred, batch["svbrdf"], generator, scenes=scenes)

    return eval_step


def make_predict_fn(model):
    """Inference: images (B, [N,] H, W, 3) -> SVBRDF maps (B, H, W, 12),
    f32 whatever the compute dtype."""

    def predict(images: torch.Tensor) -> torch.Tensor:
        with torch.no_grad(), _eval_mode(model):
            return model(images)

    return predict
