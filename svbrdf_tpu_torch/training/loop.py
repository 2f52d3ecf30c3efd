"""Train / test loop on one device.

Counterpart of svbrdf_tpu/training/loop.py: checkpoint-first argument
restore, model build + restore, dataset with a 1 % validation split, Adam,
the selected loss, per-step `loss` and per-epoch `val_loss` scalars, the
NaN guard, the checkpoint cadence and final save, and test mode's grids of
input + GT maps against predicted maps with metrics.json.

Randomness: the host draws (shuffle, mixing partners) come from the
dataset's np.random.default_rng(seed), as in the JAX package. The device
draws of training step n (mixing alphas, synthesized photos, loss scenes)
come from a torch.Generator re-seeded from (seed, n) before the step, and
validation batches from their own (seed, epoch, batch) streams, so a step's
draws do not depend on where the run resumed. Dropout masks come from
torch's default generator of the device.

Precision: --dtype picks the compute dtype (resolve_dtype: 'auto' is bf16
on a CUDA device, f32 on the CPU) and, through device.precision_scope, the
card's TF32 settings for the run; --master-dtype (else the checkpoint's
record, else SVBRDF_MASTER_DTYPE) picks the master-dtype policy for the
run (parallel/step.master_dtype_scope), and the checkpoint records the
policy in force.

Not ported: the multi-device and multi-host branches (ROADMAP Queue 1 item
14), the lax.scan chunk programs (the port dispatches each step) and AOT
compilation (TPU mechanisms).
"""

from __future__ import annotations

import math
import pathlib
import shutil
from contextlib import ExitStack, nullcontext
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from svbrdf_tpu_torch import losses as losses_lib
from svbrdf_tpu_torch import metrics as metrics_lib
from svbrdf_tpu_torch import viz
from svbrdf_tpu_torch.data.dataset import (SvbrdfDataset,
                                           split_train_validation)
from svbrdf_tpu_torch.data.device_cache import DeviceDataCache
from svbrdf_tpu_torch.device import precision_scope, resolve_device
from svbrdf_tpu_torch.models import build_model
from svbrdf_tpu_torch.parallel import step as step_lib
from svbrdf_tpu_torch.parallel.step import (PrepConfig, make_eval_step,
                                            make_optimizer, make_predict_fn,
                                            make_train_step, stream_seed)
from svbrdf_tpu_torch.training.checkpoint import Checkpoint
from svbrdf_tpu_torch.training.tensorboard import SummaryWriter
from svbrdf_tpu_torch.utils.profiling import StepTimer, trace_steps

# Entropy word that keeps the validation streams apart from the training
# steps' (seed, n) streams.
_VALIDATION_STREAM = 1_000_000_007
# Training steps of a run captured under --profile-dir: [first, last).
_PROFILE_STEPS = (1, 4)
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_dtype(name: str, device) -> torch.dtype:
    """--dtype as a torch dtype: 'auto' is bf16 on a CUDA device (the
    accelerator's configuration, as the JAX package picks bf16 on a TPU)
    and f32 on the CPU (the parity tests' oracle)."""
    if name == "auto":
        name = ("bfloat16" if torch.device(device).type == "cuda"
                else "float32")
    return DTYPES[name]


@dataclass
class TrainingRun:
    """What run_training did: the last fetched loss, the train steps and
    validation batches it ran, its step times, the times of its validation
    passes (one per validating epoch), and the model and optimizer it
    trained."""

    last_loss: float
    steps: int
    validation_batches: int
    timer: StepTimer
    validation_timer: StepTimer
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer


def _build_dataset(args, mode: str) -> SvbrdfDataset:
    return SvbrdfDataset(
        data_directory=args.input_dir,
        image_size=args.image_size,
        scale_mode=args.scale_mode,
        input_image_count=args.image_count,
        used_input_image_count=args.used_image_count,
        use_augmentation=True,
        mix_materials=(mode == "train"),
        no_svbrdf=args.no_svbrdf_input,
        is_linear=args.linear_input,
        seed=args.seed,
    )


def _loss_kind(name: str) -> str:
    return {"mixed": "mixed", "l1": "l1", "render": "rendering"}[name]


def setup(args, device):
    """Shared build: checkpoint -> args override -> master-dtype policy ->
    model / optimizer. In train mode the parameters are cast to the
    policy's master dtypes.

    Returns (args, model, optimizer, epoch_start).
    """
    checkpoint = Checkpoint(None)
    import_path = getattr(args, "import_torch_checkpoint", None)
    if import_path:
        checkpoint = Checkpoint.load(import_path)
        if not checkpoint.is_valid():
            raise SystemExit(
                f"No torch checkpoint found at '{import_path}'")
    elif not (args.mode == "train" and args.retrain):
        checkpoint = Checkpoint.load(args.model_dir)
    if checkpoint.is_valid():
        args = checkpoint.restore_args(args)

    # The CLI flag, or the policy the checkpoint recorded; 'auto' leaves
    # it to SVBRDF_MASTER_DTYPE.
    master_dtype = getattr(args, "master_dtype", "auto")
    step_lib.set_master_dtype_policy(
        None if master_dtype in ("auto", None) else master_dtype)
    dtype = resolve_dtype(args.dtype, device)
    model = build_model(args.model_type, args.use_coords,
                        depth=args.model_depth, num_filters=args.num_filters,
                        device=device, seed=args.seed, dtype=dtype)
    if checkpoint.is_valid():
        checkpoint.restore_params(model)
    elif args.mode == "test":
        raise SystemExit("No model found in the model directory but it is "
                         "required for testing.")
    if args.mode == "train":
        step_lib.master_cast(model)
    optimizer = make_optimizer(model.parameters(), args.learning_rate, dtype)
    if checkpoint.is_valid():
        checkpoint.restore_opt_state(optimizer)
    epoch_start = checkpoint.restore_epoch(0) if checkpoint.is_valid() else 0
    checkpoint.purge()
    return args, model, optimizer, epoch_start


def _to_device(raw: dict, device) -> dict:
    return {k: torch.as_tensor(v).to(device) for k, v in raw.items()}


def _validation_sums(eval_step, generator, data, val_idx, batch_size, seed,
                     epoch, device):
    """Sample-weighted (loss_sum, sample_count, batches) over the
    validation split: full batches, then a trailing partial batch at its
    true size, so no sample counts twice. Each batch draws from its own
    (seed, epoch, batch start) stream."""
    total, count, batches = 0.0, 0, 0
    for lo in range(0, len(val_idx), batch_size):
        vidx = np.asarray(val_idx[lo:lo + batch_size])
        raw = _to_device(data.raw_batch(vidx), device)
        generator.manual_seed(stream_seed(seed, _VALIDATION_STREAM, epoch,
                                          lo))
        total += float(eval_step(raw)) * len(vidx)
        count += len(vidx)
        batches += 1
    return total, count, batches


def run_training(args, device="cuda") -> TrainingRun:
    """Train on args.input_dir; writes <model_dir>/checkpoint.tar and
    <model_dir>/logs. Raises FloatingPointError (after saving) on a
    non-finite loss. The master-dtype policy and the TF32 settings are the
    run's and are restored when it ends."""
    device = resolve_device(device)
    with step_lib.master_dtype_scope(), precision_scope(
            resolve_dtype(args.dtype, device)):
        return _run_training(args, device)


def _run_training(args, device) -> TrainingRun:
    args, model, optimizer, epoch_start = setup(args, device)
    # The dataset's decode pool, if a prefetch started one, stops here.
    with _build_dataset(args, "train") as data:
        return _train(args, device, model, optimizer, epoch_start, data)


def _train(args, device, model, optimizer, epoch_start,
           data) -> TrainingRun:
    device_cache = None
    if args.device_data_cache:
        device_cache = DeviceDataCache(data, device)
        print(f"Device data cache: {len(device_cache)} samples, "
              f"{device_cache.nbytes / 1e9:.2f} GB on {device}")
    if args.steps_per_call > 1 and device_cache is None:
        raise ValueError("--steps-per-call > 1 needs --device-data-cache "
                         "(batches must already be on device)")
    train_idx, val_idx = split_train_validation(len(data), 0.01, args.seed)
    print(f"Training samples: {len(train_idx)}.")
    print(f"Validation samples: {len(val_idx)}.")

    prep = PrepConfig(used_input_image_count=args.used_image_count,
                      use_augmentation=True, is_linear=args.linear_input,
                      mix_materials=data.mix_materials)
    loss_fn = losses_lib.make_loss_fn(_loss_kind(args.loss), args.renderer)
    generator = torch.Generator(device=device)
    train_step = make_train_step(model, optimizer, loss_fn, prep, generator,
                                 seed=args.seed)
    eval_step = make_eval_step(model, loss_fn, prep, generator)
    print(f"Using renderer '{args.renderer}' on {device}")

    checkpoint_dir = pathlib.Path(args.model_dir)
    stats_dir = checkpoint_dir / "logs"
    if args.retrain and stats_dir.exists():
        shutil.rmtree(stats_dir)
    writer = SummaryWriter(str(stats_dir))

    batch_size = args.batch_size
    batch_count = max(1, int(math.ceil(len(train_idx) / batch_size)))

    def save(epoch):
        Checkpoint.save(checkpoint_dir, model, optimizer, epoch,
                        args.model_type, args.use_coords,
                        args.omit_optimizer_state_save,
                        model_depth=args.model_depth,
                        num_filters=args.num_filters,
                        master_dtype=step_lib.master_dtype_policy())

    print(f"Training from epoch {epoch_start} to {args.epochs}")
    sync = torch.cuda.synchronize if device.type == "cuda" else None
    timer = StepTimer(warmup=1, sync=sync)
    validation_timer = StepTimer(warmup=0, sync=sync)
    log_every = max(1, args.log_every)
    last_loss = float("nan")
    steps = validation_batches = 0
    with ExitStack() as profiling:
        for epoch in range(epoch_start, args.epochs):
            order = np.array(train_idx)
            data._host_rng.shuffle(order)
            if device_cache is None:
                data.prefetch(order[:batch_size])
            for i in range(batch_count):
                idx = order[i * batch_size:(i + 1) * batch_size]
                if len(idx) == 0:
                    continue
                if len(idx) < batch_size:
                    # Pad the final batch to a full one by wrapping.
                    idx = np.resize(idx, batch_size)
                batch_index = epoch * batch_count + i
                if args.profile_dir and steps == _PROFILE_STEPS[0]:
                    profiling.enter_context(trace_steps(args.profile_dir))
                elif steps == _PROFILE_STEPS[1]:
                    profiling.close()

                fetch = (i % log_every == 0 or i == batch_count - 1)
                # A measured step is the loop's whole iteration: batch
                # assembly, the host-to-device copy and the train step.
                with timer.measure() if fetch else nullcontext():
                    if device_cache is not None:
                        raw = device_cache.raw_batch(idx)
                    else:
                        raw = _to_device(data.raw_batch(idx), device)
                        # After raw_batch: the pool decodes in request
                        # order, so this batch's mixing partners (drawn
                        # and requested inside raw_batch) go first.
                        data.prefetch(
                            order[(i + 1) * batch_size:(i + 2) * batch_size])
                    generator.manual_seed(stream_seed(args.seed,
                                                      batch_index + 1))
                    loss = train_step(raw, step=batch_index + 1)
                    if fetch:
                        loss = float(loss)
                steps += 1
                if not fetch:
                    continue
                if not math.isfinite(loss):
                    save(epoch)
                    writer.close()
                    raise FloatingPointError(
                        f"non-finite loss at epoch {epoch}, batch {i}")
                print(f"Epoch {epoch}, Batch {i + 1}, loss: {loss:f}")
                writer.add_scalar("loss", loss, batch_index)
                last_loss = loss

            if epoch % args.save_frequency == 0:
                save(epoch)
            if epoch % args.validation_frequency == 0 and len(val_idx) > 0:
                with validation_timer.measure():
                    total, count, batches = _validation_sums(
                        eval_step, generator, data, val_idx, batch_size,
                        args.seed, epoch, device)
                validation_batches += batches
                val_loss = total / count
                print(f"Epoch {epoch}, validation loss: {val_loss:f}")
                writer.add_scalar("val_loss", val_loss, epoch * batch_count)

    save(args.epochs - 1 if args.epochs > epoch_start else epoch_start)
    writer.close()
    if timer.count:
        print(timer.summary())
    return TrainingRun(last_loss, steps, validation_batches, timer,
                       validation_timer, model, optimizer)


def run_test(args, device="cuda", out_dir: Optional[str] = None,
             validation_split_only: bool = False) -> list:
    """Predict SVBRDFs one sample at a time and save comparison grids.

    Grids go to <model_dir>/test_outputs (or out_dir), with metrics.json
    when the samples carry maps. With `validation_split_only` only the
    held-out 1 % is visualized (all samples when the split is empty).
    Returns the written grid paths.
    """
    device = resolve_device(device)
    with step_lib.master_dtype_scope(), precision_scope(
            resolve_dtype(args.dtype, device)):
        return _run_test(args, device, out_dir, validation_split_only)


def _run_test(args, device, out_dir, validation_split_only) -> list:
    args, model, _optimizer, epoch = setup(args, device)

    export_path = getattr(args, "export_torch_checkpoint", None)
    if export_path:
        torch.save({"model_type": args.model_type,
                    "use_coords": args.use_coords, "epoch": epoch,
                    "model_state_dict": model.state_dict()}, export_path)
        print(f"wrote torch checkpoint {export_path}")

    data = _build_dataset(args, "test")
    predict = make_predict_fn(model)
    out = pathlib.Path(out_dir or (pathlib.Path(args.model_dir)
                                   / "test_outputs"))
    out.mkdir(parents=True, exist_ok=True)

    indices = range(len(data))
    if validation_split_only:
        _train_idx, val_idx = split_train_validation(len(data), 0.01,
                                                     args.seed)
        if len(val_idx) > 0:
            indices = [int(i) for i in val_idx]

    written, per_sample = [], []
    for i in indices:
        sample = data[i]
        inputs = torch.from_numpy(sample["inputs"])[None].to(device)
        pred = predict(inputs)[0]
        path = out / f"sample_{i:04d}.png"
        viz.save_comparison_grid(str(path), sample["inputs"][0],
                                 sample["svbrdf"], pred.cpu().numpy())
        written.append(str(path))
        if not args.no_svbrdf_input:
            m = metrics_lib.to_python(metrics_lib.svbrdf_metrics(
                pred, torch.from_numpy(sample["svbrdf"]).to(device)))
            per_sample.append({"sample": int(i), "grid": str(path),
                               "metrics": m})
        print(f"wrote {path}")

    if per_sample:
        summary = metrics_lib.summarize(per_sample)
        metrics_path = out / "metrics.json"
        metrics_lib.write_metrics(metrics_path, summary)
        mean = summary["mean"]
        print("Test metrics (mean over "
              f"{len(per_sample)} samples): "
              + ", ".join(f"{k}={v:.4f}" for k, v in mean.items()))
        print(f"wrote {metrics_path}")
    return written
