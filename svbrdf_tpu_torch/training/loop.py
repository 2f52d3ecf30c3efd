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

Data parallel (run_training's `group`, a parallel/mesh.DataGroup): every
rank trains a replica through parallel/step.DataParallelTrainStep. Ranks of
one --num-devices launch (process_count 1) read the whole corpus and feed
their rows of each global batch, so the run is world size 1's on the same
global batches; the launcher's processes (process_count = world) read their
own file shards and wrap their local orders to one step count, as the JAX
package's processes do. Rank 0 alone writes the logs and the checkpoint;
validation sums are reduced over the group, so every rank logs the same
val_loss; in test mode rank 0 alone predicts.

Spatial sharding (--shard-spatial N) is training/spatial_loop's run, to
which run_training hands the group.

--model-type diffusion trains Ho et al.'s DDPM U-Net
(models/ddpm_unet) on the same batches through
parallel/step.DiffusionTrainStep (the eps-MSE, a global-norm clip, the
optimizer, an f32 EMA of the weights), validates by the same eps-MSE,
saves its widths and EMA in the checkpoint and resumes them, and in
test mode predicts from the EMA by DDIM. Its widths are Ho et al.'s at
--image-size, or a checkpoint's recorded ones. --model-depth and
--num-filters do not apply to it.

Not ported: the lax.scan chunk programs (the port dispatches each step) and
AOT compilation (TPU mechanisms).
"""

from __future__ import annotations

import math
import pathlib
import shutil
import warnings
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
from svbrdf_tpu_torch.models import build_model, ddpm_unet
from svbrdf_tpu_torch.parallel import mesh as mesh_lib
from svbrdf_tpu_torch.parallel import step as step_lib
from svbrdf_tpu_torch.parallel.spatial import make_spatial_mesh
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


def _build_dataset(args, mode: str, group=None) -> SvbrdfDataset:
    # The launcher's processes each read their own file shard in training.
    sharded = mode == "train" and group is not None
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
        process_index=group.process_index if sharded else 0,
        process_count=group.process_count if sharded else 1,
    )


class _NullWriter:
    """No-op SummaryWriter for ranks other than 0 (one writer per run)."""

    def add_scalar(self, *a, **k):
        pass

    def close(self):
        pass


def _mesh_size_for_batch(batch_size: int, n_available: int) -> int:
    """Largest divisor of batch_size that fits the available devices
    (batches split evenly across the ranks)."""
    return max(d for d in range(1, n_available + 1) if batch_size % d == 0)


def _make_training_mesh(batch_size: int, n_avail: int,
                        device_type: str = "cuda",
                        available: Optional[int] = None) -> int:
    """The data group's size: the largest divisor of the batch size that
    fits n_avail devices, more than `available` refused (mesh.make_mesh);
    warns loudly when that idles devices (an invisible throughput loss)."""
    mesh_lib.make_mesh(n_avail, device_type, available)
    mesh_size = _mesh_size_for_batch(batch_size, n_avail)
    if mesh_size < n_avail:
        warnings.warn(
            f"batch size {batch_size} is not divisible by {n_avail} "
            f"devices; using a {mesh_size}-device mesh and IDLING "
            f"{n_avail - mesh_size} device(s). Pick a batch size "
            f"divisible by the device count to use the full slice.",
            stacklevel=2)
    return mesh_size


def training_world(args, device) -> int:
    """The ranks a train run from one command takes: --shard-spatial N
    when given (N ranks split the height; it takes precedence over
    --num-devices, as in the JAX loop), else --num-devices (0: every
    visible card; the CPU counts as one device) cut to the largest divisor
    of the batch size; either refused beyond the visible cards."""
    if args.shard_spatial > 0:
        make_spatial_mesh(args.shard_spatial, torch.device(device).type)
        return args.shard_spatial
    if torch.device(device).type == "cpu":
        return _make_training_mesh(args.batch_size,
                                   max(1, args.num_devices), "cpu")
    visible = torch.cuda.device_count()
    return _make_training_mesh(args.batch_size,
                               args.num_devices or visible, "cuda", visible)


def _loss_kind(name: str) -> str:
    return {"mixed": "mixed", "l1": "l1", "render": "rendering"}[name]


def model_sizes(args) -> dict:
    """build_model's `sizes` of the run's model type: none for the
    U-Nets; a diffusion model's widths from its checkpoint, else Ho et
    al.'s at --image-size."""
    if args.model_type != "diffusion":
        return {}
    restored = getattr(args, "diffusion_sizes", None)
    if restored:
        return dict(restored)
    return {**ddpm_unet.PUBLISHED, "resolution": args.image_size}


def setup(args, device, with_ema: bool = False):
    """Shared build: checkpoint -> args override -> master-dtype policy ->
    model / optimizer. In train mode the parameters are cast to the
    policy's master dtypes; in test mode a diffusion model's weights are
    its checkpoint's EMA.

    Returns (args, model, optimizer, epoch_start), and with `with_ema`
    the checkpoint's EMA (or None) after them.
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
                        device=device, seed=args.seed, dtype=dtype,
                        **model_sizes(args))
    if checkpoint.is_valid():
        checkpoint.restore_params(model)
        if args.mode == "test":
            checkpoint.restore_ema_params(model)
    elif args.mode == "test":
        raise SystemExit("No model found in the model directory but it is "
                         "required for testing.")
    if args.mode == "train":
        step_lib.master_cast(model)
    optimizer = make_optimizer(model.parameters(), args.learning_rate, dtype)
    if checkpoint.is_valid():
        checkpoint.restore_opt_state(optimizer)
    epoch_start = checkpoint.restore_epoch(0) if checkpoint.is_valid() else 0
    ema = checkpoint.ema_state()
    checkpoint.purge()
    if with_ema:
        return args, model, optimizer, epoch_start, ema
    return args, model, optimizer, epoch_start


def _to_device(raw: dict, device) -> dict:
    return {k: torch.as_tensor(v).to(device) for k, v in raw.items()}


def _raw_batch(source, indices, rows):
    """source.raw_batch of `indices`, or of their `rows` (a rank's)."""
    if rows is None:
        return source.raw_batch(indices)
    return source.raw_batch(indices, rows)


def _validation_sums(eval_step, generator, data, val_idx, batch_size, seed,
                     epoch, device, group=None, eval_rows=None):
    """Sample-weighted (loss_sum, sample_count, batches) over the
    validation split: full batches, then a trailing partial batch at its
    true size, so no sample counts twice. Each batch draws from its own
    (seed, epoch, batch start) stream.

    With the ranks of one launch (`group`, and `eval_rows`, the eval step
    of a rank's rows) each full batch is split across the ranks and the
    partial one runs on rank 0 alone (the others advance their host RNG
    past it); the sums are this rank's share."""
    total, count, batches = 0.0, 0, 0
    for lo in range(0, len(val_idx), batch_size):
        vidx = np.asarray(val_idx[lo:lo + batch_size])
        rows = None
        if group is not None:
            if len(vidx) == batch_size:
                rows = group.rows(batch_size)
            elif not group.is_main:
                data.skip_batch(vidx)
                continue
        raw = _to_device(_raw_batch(data, vidx, rows), device)
        generator.manual_seed(stream_seed(seed, _VALIDATION_STREAM, epoch,
                                          lo))
        n = len(vidx) if rows is None else rows.stop - rows.start
        total += float((eval_step if rows is None else eval_rows)(raw)) * n
        count += n
        batches += 1
    return total, count, batches


def run_training(args, device="cuda", group=None) -> TrainingRun:
    """Train on args.input_dir; writes <model_dir>/checkpoint.tar and
    <model_dir>/logs. Raises FloatingPointError (after saving) on a
    non-finite loss. The master-dtype policy and the TF32 settings are the
    run's and are restored when it ends. With a data group
    (parallel/mesh.DataGroup) this is one rank's part of a data-parallel
    run on the group's device. With --shard-spatial N it is
    training/spatial_loop's run (the group's ranks split the height)."""
    if args.shard_spatial > 0:
        if args.model_type == "diffusion":
            raise ValueError("--shard-spatial trains the U-Nets only")
        from svbrdf_tpu_torch.training.spatial_loop import \
            run_training_spatial

        return run_training_spatial(args, device, group)
    device = resolve_device(device) if group is None else group.device
    with step_lib.master_dtype_scope(), precision_scope(
            resolve_dtype(args.dtype, device)):
        return _run_training(args, device, group)


def _run_training(args, device, group) -> TrainingRun:
    if group is not None:
        if group.process_count > 1:
            # The launcher: every process's rows are a share of each step.
            size = _make_training_mesh(args.batch_size,
                                       args.num_devices or group.world,
                                       device.type, group.world)
            if size != group.world:
                raise ValueError(
                    f"multi-process training needs a batch size divisible "
                    f"across ALL {group.world} processes (got "
                    f"{args.batch_size}); a smaller group would leave some "
                    f"process out")
        print(f"Data group: {group.world} rank(s) over {group.backend}, "
              f"rank {group.rank} on {device}"
              + (f" ({group.process_count} processes)"
                 if group.process_count > 1 else ""))
    args, model, optimizer, epoch_start, ema = setup(args, device,
                                                     with_ema=True)
    # The dataset's decode pool, if a prefetch started one, stops here.
    with _build_dataset(args, "train", group) as data:
        return _train(args, device, model, optimizer, epoch_start, data,
                      group, ema)


def _train(args, device, model, optimizer, epoch_start, data,
           group, ema=None) -> TrainingRun:
    pc = group.process_count if group is not None else 1
    is_main = group is None or group.is_main
    device_cache = None
    if args.device_data_cache:
        if pc > 1:
            raise ValueError("--device-data-cache is single-process only "
                             "(each process would need the full corpus)")
        device_cache = DeviceDataCache(data, device)
        print(f"Device data cache: {len(device_cache)} samples, "
              f"{device_cache.nbytes / 1e9:.2f} GB on {device}")
    if args.steps_per_call > 1 and device_cache is None:
        raise ValueError("--steps-per-call > 1 needs --device-data-cache "
                         "(batches must already be on device)")
    # The launcher: each process's share of a step is a local batch of its
    # own shard; in one launch a rank feeds its rows of the global batch.
    local_batch = mesh_lib.local_batch_size(args.batch_size, pc)
    rows = (group.rows(args.batch_size)
            if group is not None and pc == 1 else None)
    train_idx, val_idx = split_train_validation(len(data), 0.01, args.seed)
    print(f"Training samples: {len(train_idx)}.")
    print(f"Validation samples: {len(val_idx)}.")

    prep = PrepConfig(used_input_image_count=args.used_image_count,
                      use_augmentation=True, is_linear=args.linear_input,
                      mix_materials=data.mix_materials)
    loss_fn = losses_lib.make_loss_fn(_loss_kind(args.loss), args.renderer)
    generator = torch.Generator(device=device)
    diffusion = args.model_type == "diffusion"
    if diffusion:
        train_step = step_lib.DiffusionTrainStep(
            model, optimizer, prep, generator, seed=args.seed, group=group)
        if ema is not None:
            train_step.load_ema(ema)
        eval_step = step_lib.make_diffusion_eval_step(train_step)
        eval_rows = (step_lib.make_diffusion_eval_step(train_step, group)
                     if rows is not None else None)
    else:
        train_step = make_train_step(model, optimizer, loss_fn, prep,
                                     generator, seed=args.seed, group=group)
        eval_step = make_eval_step(model, loss_fn, prep, generator)
        eval_rows = (make_eval_step(model, loss_fn, prep, generator, group)
                     if rows is not None else None)
    print(f"Using renderer '{args.renderer}' on {device}")

    checkpoint_dir = pathlib.Path(args.model_dir)
    stats_dir = checkpoint_dir / "logs"
    if is_main and args.retrain and stats_dir.exists():
        shutil.rmtree(stats_dir)
    writer = SummaryWriter(str(stats_dir)) if is_main else _NullWriter()

    batch_size = args.batch_size
    if pc > 1:
        # Every process takes the same number of steps (each is a
        # collective): derived from the global file count, with each
        # process's local order wrapped to fill it.
        global_train_len = int(math.ceil(data.global_file_count * 0.99))
        batch_count = max(1, int(math.ceil(global_train_len / batch_size)))
    else:
        batch_count = max(1, int(math.ceil(len(train_idx) / batch_size)))
    step_size = local_batch

    def mine(idx):
        return idx if rows is None else idx[rows]

    def save(epoch):
        Checkpoint.save(checkpoint_dir, model, optimizer, epoch,
                        args.model_type, args.use_coords,
                        args.omit_optimizer_state_save,
                        model_depth=args.model_depth,
                        num_filters=args.num_filters,
                        master_dtype=step_lib.master_dtype_policy(),
                        group=group,
                        sizes=model.sizes if diffusion else None,
                        ema=train_step.ema_state() if diffusion else None)

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
            if pc > 1:
                order = np.resize(order, batch_count * local_batch)
            if device_cache is None:
                data.prefetch(mine(order[:step_size]))
            for i in range(batch_count):
                idx = order[i * step_size:(i + 1) * step_size]
                if len(idx) == 0:
                    continue
                if len(idx) < step_size:
                    # Pad the final batch to a full one by wrapping.
                    idx = np.resize(idx, step_size)
                batch_index = epoch * batch_count + i
                if (args.profile_dir and is_main
                        and steps == _PROFILE_STEPS[0]):
                    profiling.enter_context(trace_steps(args.profile_dir))
                elif steps == _PROFILE_STEPS[1]:
                    profiling.close()

                fetch = (i % log_every == 0 or i == batch_count - 1)
                # A measured step is the loop's whole iteration: batch
                # assembly, the host-to-device copy and the train step.
                with timer.measure() if fetch else nullcontext():
                    if device_cache is not None:
                        raw = _raw_batch(device_cache, idx, rows)
                    else:
                        raw = _to_device(_raw_batch(data, idx, rows),
                                         device)
                        # After raw_batch: the pool decodes in request
                        # order, so this batch's mixing partners (drawn
                        # and requested inside raw_batch) go first.
                        data.prefetch(mine(
                            order[(i + 1) * step_size:(i + 2) * step_size]))
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
            # The launcher's processes validate their own shards in local
            # batches, and each must reach the sums' reduction, with or
            # without samples; the ranks of one launch split the batches.
            if (epoch % args.validation_frequency == 0
                    and (len(val_idx) > 0 or pc > 1)):
                with validation_timer.measure():
                    total, count, batches = _validation_sums(
                        eval_step, generator, data, val_idx, local_batch,
                        args.seed, epoch, device,
                        group if rows is not None else None, eval_rows)
                    if group is not None:
                        total, count = mesh_lib.all_reduce_sum(
                            [total, count], group)
                validation_batches += batches
                if count > 0:
                    val_loss = total / count
                    print(f"Epoch {epoch}, validation loss: {val_loss:f}")
                    writer.add_scalar("val_loss", val_loss,
                                      epoch * batch_count)

    save(args.epochs - 1 if args.epochs > epoch_start else epoch_start)
    writer.close()
    if timer.count:
        print(timer.summary())
    return TrainingRun(last_loss, steps, validation_batches, timer,
                       validation_timer, model, optimizer)


def run_test(args, device="cuda", out_dir: Optional[str] = None,
             validation_split_only: bool = False, group=None) -> list:
    """Predict SVBRDFs one sample at a time and save comparison grids.

    Grids go to <model_dir>/test_outputs (or out_dir), with metrics.json
    when the samples carry maps. With `validation_split_only` only the
    held-out 1 % is visualized (all samples when the split is empty).
    Returns the written grid paths. With a data group every rank restores
    the checkpoint and rank 0 alone predicts; the others return []. So it
    runs after a spatial run too (--shard-spatial, the group's ranks): as
    the JAX CLI after its spatial run, rank 0 predicts each sample whole
    with the unsharded model on its device, on the whole corpus's 1 %
    split (every rank of that run read the whole corpus).
    """
    device = resolve_device(device) if group is None else group.device
    with step_lib.master_dtype_scope(), precision_scope(
            resolve_dtype(args.dtype, device)):
        return _run_test(args, device, out_dir, validation_split_only, group)


def _run_test(args, device, out_dir, validation_split_only, group) -> list:
    args, model, _optimizer, epoch = setup(args, device)
    if group is not None and not group.is_main:
        return []

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
        pc = group.process_count if group is not None else 1
        if pc > 1:
            # The launcher's training held out 1 % of each process's file
            # shard (sorted files, round-robin by index): each process's
            # local split mapped back to dataset indices.
            val_global = []
            for p in range(pc):
                local_len = len(range(p, len(data), pc))
                _tr, val = split_train_validation(local_len, 0.01,
                                                  args.seed)
                val_global += [int(v) * pc + p for v in val]
            val_idx = np.asarray(sorted(val_global))
        else:
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
