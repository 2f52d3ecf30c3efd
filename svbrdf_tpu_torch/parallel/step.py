"""Train, eval and predict steps.

Counterpart of svbrdf_tpu/parallel/step.py: on-device batch preparation
-> model -> loss -> backward -> Adam. PyTorch runs eagerly, so a step is a
plain callable; the random draws of preparation and of the loss scenes come
from the step's torch.Generator, and dropout from torch's default generator
of the device. On one device that is TrainStep; on a rank of a data group
(parallel/mesh), DataParallelTrainStep, which runs the step one device runs
on the same global batch, the order of the gradient reduction aside.
A step's phases are host spans (utils/profiling.span): step.prepare,
step.forward, step.loss, step.backward (with the reduction) and
step.optimizer. DiffusionTrainStep trains the DDPM U-Net
(models/ddpm_unet) on the same prepared batches: it adds the spans
diffusion.noise and diffusion.ema.

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
import torch.distributed as dist

from svbrdf_tpu_torch import losses
from svbrdf_tpu_torch.data import pipeline
from svbrdf_tpu_torch.models import ddpm_unet
from svbrdf_tpu_torch.models.single_view import decode_head
from svbrdf_tpu_torch.ops import codecs
from svbrdf_tpu_torch.ops.pathtrace import RenderSamples, Samples
from svbrdf_tpu_torch.parallel import mesh
from svbrdf_tpu_torch.parallel.optimizer import AdamBf16SR
from svbrdf_tpu_torch.scene import Scene
from svbrdf_tpu_torch.utils import profiling


class PrepConfig(NamedTuple):
    """Batch-preparation switches (see data/pipeline.prepare_batch)."""

    used_input_image_count: int = 1
    use_augmentation: bool = True
    is_linear: bool = False
    mix_materials: bool = False


def prepare(raw_batch: dict, prep: PrepConfig,
            generator: Optional[torch.Generator], **draws) -> dict:
    """Run pipeline.prepare_batch on a raw batch {'inputs', 'svbrdf'[,
    'partner_svbrdf']} of tensors on the device; `draws` (as
    pipeline.draw_prepare_inputs makes them) instead of the generator's."""
    return pipeline.prepare_batch(
        raw_batch["inputs"], raw_batch["svbrdf"],
        _partners(raw_batch, prep),
        used_input_image_count=prep.used_input_image_count,
        use_augmentation=prep.use_augmentation, is_linear=prep.is_linear,
        generator=generator, **draws)


def _partners(raw_batch: dict, prep: PrepConfig):
    return raw_batch.get("partner_svbrdf") if prep.mix_materials else None


def _rows(value, lo: int, hi: int, axis: int = 0):
    """Rows lo:hi of a draw for a batch: a tensor's, a Scene's fields', or
    path-tracer samples' (the offsets' batch axis is their second). With
    `axis` another axis of a tensor: rows lo:hi of H of a prepared batch's
    (B, H, W, C) maps or (B, N, H, W, 3) photos take axis 1 or 2."""
    if isinstance(value, Scene):
        return Scene(*(f[lo:hi] for f in (value.camera_pos, value.light_pos,
                                          value.light_color)))
    if isinstance(value, RenderSamples):
        return RenderSamples(*(Samples(s.offsets[:, lo:hi], s.shift[lo:hi])
                               for s in value))
    return value.narrow(axis, lo, hi - lo)


def _span(n_rows: int, group=None) -> tuple:
    """(lo, hi, total): rank group.rank's n_rows rows of the global batch
    of world * n_rows items; without a data group the whole batch,
    (0, n_rows, n_rows)."""
    if group is None:
        return 0, n_rows, n_rows
    lo = group.rank * n_rows
    return lo, lo + n_rows, n_rows * group.world


def prepare_rows(raw_rows: dict, prep: PrepConfig,
                 generator: torch.Generator, group=None) -> tuple:
    """Prepare this rank's rows of a global batch (without a data group,
    the whole batch): the draws are made for the whole batch
    (pipeline.draw_prepare_inputs, so `generator` advances as one device's
    would) and the rank keeps its rows. Returns (prepared rows, their span
    as _span gives it). Every step draws through here."""
    svbrdf = raw_rows["svbrdf"]
    span = _span(svbrdf.shape[0], group)
    draws = pipeline.draw_prepare_inputs(
        span[2], raw_rows["inputs"].shape[1], svbrdf.shape[1],
        svbrdf.shape[2], prep.used_input_image_count, prep.use_augmentation,
        _partners(raw_rows, prep) is not None, generator=generator,
        device=svbrdf.device)
    batch = prepare(raw_rows, prep, None,
                    **{k: _rows(v, *span[:2]) for k, v in draws.items()})
    return batch, span


def loss_rows(loss_fn: Callable, pred: torch.Tensor, target: torch.Tensor,
              generator: torch.Generator, span: tuple, scenes=None,
              samples=None) -> torch.Tensor:
    """The loss of this rank's rows (the mean over them): its draws made
    for the global batch of span[2] items (losses.draw_loss_inputs; given
    scenes or samples are the global batch's) and cut to the rank's
    rows."""
    lo, hi, total = span
    if not hasattr(loss_fn, "draws"):
        # A loss that declares no draws makes its own: the whole batch only.
        if hi - lo != total:
            raise ValueError("a loss without `draws` takes the whole batch")
        return loss_fn(pred, target, generator, scenes=scenes)
    draws = losses.draw_loss_inputs(loss_fn, total, pred.shape[1],
                                    pred.shape[2], generator, pred.device,
                                    scenes, samples)
    return loss_fn(pred, target, generator,
                   **{k: _rows(v, lo, hi) for k, v in draws.items()})


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

    The draws go through the row-wise path (prepare_rows, loss_rows) with
    the whole batch as the span (0, B, B); a data-parallel step
    (DataParallelTrainStep) takes its rows of a global batch there and adds
    only its reduction (`reduce`).

    A bf16 model gets its inputs and its maps cast to bf16 (`forward`).
    `step` numbers the training step (the loop passes its own; by default
    the one after the last): with bf16 masters it picks the SR salt,
    master_salt(seed, step), so a step is repeatable from (seed, step)."""

    # The data group whose rows of a global batch the step trains on.
    group = None

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

    def reduce(self, loss: torch.Tensor) -> torch.Tensor:
        """After the backward: the step's loss, its gradients reduced where
        there is a group to reduce them over (none on one device)."""
        return loss.detach()

    def update(self, batch: dict, scenes=None, step: Optional[int] = None,
               samples=None, span: Optional[tuple] = None) -> torch.Tensor:
        """A step on prepared rows (`span` as prepare_rows gives it; by
        default the rows of the step's group, or the whole batch);
        `scenes` / `samples`, if given, are the global batch's loss
        draws."""
        step = self.step_index + 1 if step is None else step
        if span is None:
            span = _span(batch["svbrdf"].shape[0], self.group)
        with profiling.span("step.forward"):
            pred = self.forward(batch["inputs"])
        with profiling.span("step.loss"):
            loss = loss_rows(self.loss_fn, pred, batch["svbrdf"],
                             self.generator, span, scenes, samples)
        with profiling.span("step.backward"):
            self.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            loss = self.reduce(loss)
        with profiling.span("step.optimizer"):
            self.apply_gradients(step)
        self.step_index = step
        return loss

    def __call__(self, raw_batch: dict,
                 step: Optional[int] = None) -> torch.Tensor:
        with profiling.span("step.prepare"):
            batch, span = prepare_rows(raw_batch, self.prep, self.generator,
                                       self.group)
        return self.update(batch, step=step, span=span)


# Entropy word of the dropout streams of ranks > 0.
_DROPOUT_STREAM = 23


def seed_dropout(seed: int, rank: int) -> None:
    """Give rank `rank` > 0 dropout masks of its own: torch's default
    generators (the CPU's and every card's) reseeded from (seed, rank).
    Every process starts them from the same default seed, so unseeded
    ranks would draw the same masks for their rows. Rank 0 keeps what one
    device does."""
    if rank > 0:
        torch.manual_seed(stream_seed(seed, rank, _DROPOUT_STREAM))


@torch.no_grad()
def reduce_gradients(params, loss: torch.Tensor, group,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Sum the gradients of `params` (those that have one) and `loss` over
    the group in place, each rank's share multiplied by `scale` first (by
    default 1 / world, as DDP scales it: the data group's mean; the
    spatial step's shares sum with scale 1): one all-reduce per gradient
    dtype, in that dtype (a bf16 master's gradient in bf16, as the JAX
    step reduces its gradient tree in the leaves' dtypes; the loss with
    the f32 ones). Every rank receives the same sums. Returns the reduced
    loss."""
    if scale is None:
        scale = 1.0 / group.world
    loss = loss.detach().float().reshape(1)
    by_dtype = {torch.float32: [loss]}
    for p in params:
        if p.grad is not None:
            by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for tensors in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in tensors])
        if scale != 1.0:
            flat.mul_(scale)
        dist.all_reduce(flat)
        torch._foreach_copy_(tensors, [
            part.view_as(t) for part, t in zip(
                flat.split([t.numel() for t in tensors]), tensors)])
    return loss[0]


class DataParallelTrainStep(TrainStep):
    """TrainStep on one rank of a data group (parallel/mesh.DataGroup):
    world size N runs the step world size 1 runs on the same global batch,
    the order of the gradient reduction aside.

    The raw batch it is given is this rank's rows of the global batch
    (world x rows items; rank r holds rows r * rows .. (r + 1) * rows - 1).
    Every draw of the step (mixing alphas, the synthesized photos' scenes
    and noise, the loss scenes, the path tracer's samples) is made for the
    global batch from the step's generator, seeded alike on every rank, in
    TrainStep's order, and the rank keeps its rows (prepare_rows,
    loss_rows). Each rank's loss is the mean over its rows; after the
    backward reduce_gradients averages the gradients and the loss over the
    group, so every rank applies the same update with the same master salt
    and the replicas stay bit-identical.

    The gradients are reduced by one explicit all-reduce per dtype after
    the backward, not by DistributedDataParallel: the models hold
    parameters their forward never reads (enc1's merge, the single-view
    model's last global-track stage), on which DDP without
    find_unused_parameters raises at the second step, and with it walks
    the graph every step; the JAX step, too, reduces its gradient tree once
    after the backward; and the .grad tensors stay the ones autograd made
    (not views into DDP's buckets), so sr_adam's launch plan and its one
    launch a step are as on one device.

    At construction the weights, buffers and optimizer state are broadcast
    from rank 0 (mesh.replicate_tree) and ranks > 0 reseed dropout
    (seed_dropout). update() and __call__ return the group's mean loss."""

    def __init__(self, model, optimizer, loss_fn: Callable, prep: PrepConfig,
                 generator: torch.Generator, group, seed: int = 0):
        super().__init__(model, optimizer, loss_fn, prep, generator, seed)
        self.group = group
        self.params = replicate_training_state(model, optimizer, group)
        seed_dropout(seed, group.rank)

    def reduce(self, loss: torch.Tensor) -> torch.Tensor:
        return reduce_gradients(self.params, loss, self.group)


def replicate_training_state(model, optimizer, group) -> list:
    """Broadcast rank 0's weights, buffers and optimizer state to every
    rank of `group` (mesh.replicate_tree); returns the model's parameters
    in order."""
    params = list(model.parameters())
    mesh.replicate_tree(
        params + list(model.buffers())
        + [v for state in optimizer.state.values()
           for v in state.values() if isinstance(v, torch.Tensor)],
        group)
    return params


def make_train_step(model, optimizer, loss_fn: Callable, prep: PrepConfig,
                    generator: torch.Generator, seed: int = 0,
                    group=None) -> TrainStep:
    """A TrainStep, or with a data group (parallel/mesh.DataGroup) a
    DataParallelTrainStep."""
    if group is None:
        return TrainStep(model, optimizer, loss_fn, prep, generator, seed)
    return DataParallelTrainStep(model, optimizer, loss_fn, prep, generator,
                                 group, seed)


def diffusion_draws(span: tuple, height: int, width: int,
                    generator: torch.Generator, device) -> tuple:
    """(t, eps) of the rows span[0]:span[1] of a global batch of span[2]
    items: t ~ U{0, ..., T - 1} (span[2],) and then eps ~ N(0, I)
    (span[2], 9, height, width), drawn for the whole global batch from
    `generator`, so a rank's rows are one device's and a step's draws
    repeat from the generator's seed."""
    lo, hi, total = span
    t = torch.randint(0, ddpm_unet.TIMESTEPS, (total,), generator=generator,
                      device=device)
    eps = torch.randn((total, ddpm_unet.OUT_CHANNELS, height, width),
                      generator=generator, device=device)
    return t[lo:hi], eps[lo:hi]


class DiffusionTrainStep(TrainStep):
    """A train step of the DDPM U-Net (models/ddpm_unet) on the batches
    TrainStep prepares (prepare_rows: the maps, mixed, and the synthesized
    flash photo): the maps' 9-channel encoding x0 (codecs.encode_svbrdf),
    the draws of diffusion_draws after preparation's, x_t = sqrt(abar_t)
    x0 + sqrt(1 - abar_t) eps (abar accumulated in float64 and cast once),
    the model's eps on [x_t | photo], the loss mean((eps_hat - eps)^2),
    the backward, the gradients clipped to a global norm of 1, the
    optimizer (SR-Adam's master salt as TrainStep's), and an f32 EMA of
    the masters, ema <- ema + (1 - 0.9999) (p - ema): Ho et al.'s
    settings (models/ddpm_unet's constants).

    With a data group (parallel/mesh.DataGroup) it is a rank's step of
    the global batch, as DataParallelTrainStep is: rank 0's state
    broadcast at construction, the gradients and the loss averaged over
    the group after the backward, so the clip, the update and the EMA are
    every rank's alike.

    On the card, the model's training forward and backward are captured
    as CUDA graphs at the shape of the first batch it trains on
    (torch.cuda.make_graphed_callables, with the model's own hooks set
    aside for the capture) and replayed at that shape: some 4,000
    launches a step become two replays, so the step is paced by the card
    and not by the host's issue. A batch of another shape, and the model
    in eval mode, run eagerly.

    Spans: step.prepare, diffusion.noise (the encoding, the draws, x_t),
    step.forward, step.loss, step.backward, step.optimizer (the clip, the
    update and, inside it, diffusion.ema)."""

    def __init__(self, model, optimizer, prep: PrepConfig,
                 generator: torch.Generator, seed: int = 0, group=None):
        super().__init__(model, optimizer, None, prep, generator, seed)
        self.params = list(model.parameters())
        device = self.params[0].device
        abar = ddpm_unet.alphas_cumprod()
        self.sqrt_abar = abar.sqrt().float().to(device)
        self.sqrt_one_minus_abar = (1.0 - abar).sqrt().float().to(device)
        if group is not None:
            self.group = group
            replicate_training_state(model, optimizer, group)
            seed_dropout(seed, group.rank)
        self.ema = [p.detach().float().clone() for p in self.params]
        self.graph_shape = None

    def train_forward(self, inputs: torch.Tensor,
                      t: torch.Tensor) -> torch.Tensor:
        """The model's training forward, on the card a CUDA graph's replay
        where `inputs` has the first training batch's shape."""
        if inputs.device.type != "cuda":
            return self.model(inputs, t)
        if self.graph_shape is None:
            self.graph_shape = inputs.shape
            with _hooks_set_aside(self.model):
                torch.cuda.make_graphed_callables(
                    self.model, (torch.zeros_like(inputs),
                                 torch.zeros_like(t)))
        if inputs.shape == self.graph_shape:
            return self.model(inputs, t)
        graphed = self.model.__dict__.pop("forward")
        try:
            return self.model(inputs, t)
        finally:
            self.model.forward = graphed

    def noise_prediction(self, batch: dict, span: tuple,
                         forward: Optional[Callable] = None) -> tuple:
        """(eps_hat in the compute dtype, eps f32) of prepared rows, by
        `forward` (the model's own call unless given)."""
        with profiling.span("diffusion.noise"):
            x0 = codecs.encode_svbrdf(batch["svbrdf"]).permute(
                0, 3, 1, 2).contiguous()
            t, eps = diffusion_draws(span, x0.shape[2], x0.shape[3],
                                     self.generator, x0.device)
            scale = lambda table: table[t].view(-1, 1, 1, 1)  # noqa: E731
            x_t = scale(self.sqrt_abar) * x0 + scale(
                self.sqrt_one_minus_abar) * eps
            inputs = torch.cat([x_t, ddpm_unet.condition(batch["inputs"])],
                               dim=1).to(self.dtype)
        with profiling.span("step.forward"):
            return (forward or self.model)(inputs, t), eps

    def reduce(self, loss: torch.Tensor) -> torch.Tensor:
        if self.group is None:
            return loss.detach()
        return reduce_gradients(self.params, loss, self.group)

    @torch.no_grad()
    def update_ema(self) -> None:
        torch._foreach_lerp_(self.ema, [p.float() for p in self.params],
                             1.0 - ddpm_unet.EMA_DECAY)

    def ema_state(self) -> dict:
        """The EMA by parameter name (f32)."""
        return {name: e for (name, _), e in zip(
            self.model.named_parameters(), self.ema)}

    @torch.no_grad()
    def load_ema(self, state: dict) -> None:
        for (name, _), e in zip(self.model.named_parameters(), self.ema):
            e.copy_(state[name])

    def update(self, batch: dict, scenes=None, step: Optional[int] = None,
               samples=None, span: Optional[tuple] = None) -> torch.Tensor:
        step = self.step_index + 1 if step is None else step
        if span is None:
            span = _span(batch["svbrdf"].shape[0], self.group)
        pred, eps = self.noise_prediction(batch, span, self.train_forward)
        with profiling.span("step.loss"):
            loss = torch.mean(torch.square(pred.float() - eps))
        with profiling.span("step.backward"):
            self.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            loss = self.reduce(loss)
        with profiling.span("step.optimizer"):
            torch.nn.utils.clip_grad_norm_(self.params, ddpm_unet.CLIP_NORM,
                                           foreach=True)
            self.apply_gradients(step)
            with profiling.span("diffusion.ema"):
                self.update_ema()
        self.step_index = step
        return loss


def make_diffusion_eval_step(train_step: DiffusionTrainStep, group=None):
    """Validation step of a DiffusionTrainStep: eval(raw_batch) -> the same
    eps-MSE under no_grad with the model's current weights, drawn as the
    train step draws (prepare_rows, diffusion_draws); with a data group the
    raw batch is this rank's rows and the loss their mean."""

    def eval_step(raw_batch: dict, scenes=None) -> torch.Tensor:
        with torch.no_grad(), _eval_mode(train_step.model):
            batch, span = prepare_rows(raw_batch, train_step.prep,
                                       train_step.generator, group)
            pred, eps = train_step.noise_prediction(batch, span)
            return torch.mean(torch.square(pred.float() - eps))

    return eval_step


@contextmanager
def _hooks_set_aside(module):
    """The module's own hooks off for the duration (a CUDA graph's capture
    takes none, and its warm-up runs are no training steps), restored
    after."""
    names = ("_forward_pre_hooks", "_forward_hooks", "_backward_hooks")
    kept = [getattr(module, name) for name in names]
    for name in names:
        setattr(module, name, type(getattr(module, name))())
    try:
        yield
    finally:
        for name, hooks in zip(names, kept):
            setattr(module, name, hooks)


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
                   generator: torch.Generator, group=None):
    """Validation step: eval(raw_batch, scenes=None) -> loss with dropout
    off, the same loss, value only (under no_grad the value-only kernel
    runs); a bf16 model's inputs and maps cast as in TrainStep. It draws
    as TrainStep draws (prepare_rows, loss_rows).

    With a data group the raw batch is this rank's rows of a global batch,
    drawn for as DataParallelTrainStep draws (scenes given are the global
    batch's), and the loss is the mean over the rank's rows; it runs no
    collective."""
    dt = compute_dtype(model)

    def eval_step(raw_batch: dict, scenes=None) -> torch.Tensor:
        with torch.no_grad(), _eval_mode(model):
            batch, span = prepare_rows(raw_batch, prep, generator, group)
            pred = model(batch["inputs"].to(dt)).to(dt)
            return loss_rows(loss_fn, pred, batch["svbrdf"], generator, span,
                             scenes)

    return eval_step


def make_predict_fn(model):
    """Inference: images (B, [N,] H, W, 3) -> SVBRDF maps (B, H, W, 12),
    f32 whatever the compute dtype. For the DDPM U-Net, predict(images,
    seed=0): deterministic DDIM over 50 steps
    (ddpm_unet.ddim_sample) from x_T drawn by a generator seeded with
    `seed`, the maps decode_head(x0 clamped to [-1, 1])."""
    if isinstance(model, ddpm_unet.DDPMUNet):
        abar = ddpm_unet.alphas_cumprod()

        def sample(images: torch.Tensor, seed: int = 0) -> torch.Tensor:
            with torch.no_grad(), _eval_mode(model):
                gen = torch.Generator(device=images.device).manual_seed(seed)
                x0 = ddpm_unet.ddim_sample(model, images, abar,
                                           ddpm_unet.SAMPLE_STEPS, gen)
                return decode_head(x0.clamp(-1.0, 1.0).permute(0, 2, 3, 1))

        return sample

    def predict(images: torch.Tensor) -> torch.Tensor:
        with torch.no_grad(), _eval_mode(model):
            return model(images)

    return predict
