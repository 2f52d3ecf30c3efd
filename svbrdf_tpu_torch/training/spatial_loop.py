"""Spatially sharded training: `--shard-spatial N`.

Counterpart of svbrdf_tpu/training/spatial_loop.py: the image height split
over the N ranks of a group (parallel/spatial), for material scans whose
activations outgrow one card, with checkpoints, logging, validation,
resume and the NaN guard. main.py starts the N local ranks (one card a
rank over NCCL, or under --gpu-id -1 the CPU over gloo) and each runs
run_training_spatial with its group.

Differences from the batch loop (training/loop.py), as in the JAX package:
  - activations are split over H and the parameters replicated; the batch
    is not split, so any batch size works on any N;
  - every rank reads the whole corpus, shuffles it alike, and prepares the
    whole batch on its device through the step's one draw path, then keeps
    its rows (parallel/spatial.SpatialTrainStep);
  - the last batch of an epoch is wrap-padded to a full one, and a
    validation batch's loss is weighted by its true size;
  - f32 master weights, forced and recorded, with upconv 'fold' (the math
    the port's decoder runs) in the checkpoint, which the JAX CLI reads as
    it reads its own;
  - no device data cache: the mode is for large images (the flag is
    accepted and unused, as in the JAX loop).
Rank 0 alone writes the logs and the checkpoint; every rank computes the
same losses (each step's is summed over the group).
"""

from __future__ import annotations

import math
import pathlib
import shutil

import numpy as np
import torch

from svbrdf_tpu_torch.data.dataset import split_train_validation
from svbrdf_tpu_torch.device import precision_scope, resolve_device
from svbrdf_tpu_torch.parallel import spatial
from svbrdf_tpu_torch.parallel import step as step_lib
from svbrdf_tpu_torch.parallel.step import PrepConfig, stream_seed
from svbrdf_tpu_torch.training import loop
from svbrdf_tpu_torch.training.checkpoint import Checkpoint
from svbrdf_tpu_torch.training.tensorboard import SummaryWriter
from svbrdf_tpu_torch.utils.profiling import StepTimer


def run_training_spatial(args, device="cuda",
                         group=None) -> "loop.TrainingRun":
    """Train with the image height split over `group` (N =
    args.shard_spatial ranks; without a group N must be 1). The run's
    master-dtype policy and TF32 settings are restored when it ends."""
    device = resolve_device(device) if group is None else group.device
    with step_lib.master_dtype_scope(), precision_scope(
            loop.resolve_dtype(args.dtype, device)):
        return _run(args, device, group)


def _check(args, group) -> int:
    n = int(args.shard_spatial)
    world = 1 if group is None else group.world
    if world != n:
        raise ValueError(f"--shard-spatial {n} needs a group of {n} ranks, "
                         f"got {world}")
    if group is not None and group.process_count > 1:
        raise ValueError("--shard-spatial runs its ranks from one command; "
                         "the multi-process launcher trains data parallel")
    if args.image_size % n:
        raise ValueError(f"--shard-spatial {n} must divide --image-size "
                         f"{args.image_size} (H is split into equal shards)")
    if args.renderer != "local":
        raise ValueError("--shard-spatial supports the local renderer (the "
                         "fused loss at each shard's row offset); the path "
                         "tracer is unsharded")
    if args.loss not in ("mixed", "render"):
        raise ValueError("--shard-spatial needs a rendering-based loss "
                         "(--loss mixed|render); plain --loss l1 does not "
                         "need spatial sharding")
    return n


def _run(args, device, group) -> "loop.TrainingRun":
    n = _check(args, group)
    is_main = group is None or group.is_main
    if args.upconv != "fold":
        args.upconv = "fold"
        print("Spatial sharding: recording upconv='fold' (the port's "
              "decoder runs its math: upsample, pad, conv)")
    if args.master_dtype != "f32":
        args.master_dtype = "f32"
        print("Spatial sharding: training f32 master params (bf16-SR "
              "masters are a batch-DP step optimization)")
    backend = "one device" if group is None else f"over {group.backend}"
    print(f"Spatial group: H split over {n} rank(s) {backend}, rank "
          f"{0 if group is None else group.rank} on {device}")
    args, model, optimizer, epoch_start = loop.setup(args, device)
    with loop._build_dataset(args, "train") as data:
        return _train(args, device, group, model, optimizer, epoch_start,
                      data, is_main)


def _train(args, device, group, model, optimizer, epoch_start, data,
           is_main) -> "loop.TrainingRun":
    train_idx, val_idx = split_train_validation(len(data), 0.01, args.seed)
    print(f"Training samples: {len(train_idx)}.")
    print(f"Validation samples: {len(val_idx)}.")
    prep = PrepConfig(used_input_image_count=args.used_image_count,
                      use_augmentation=True, is_linear=args.linear_input,
                      mix_materials=data.mix_materials)
    loss_fn = spatial.make_spatial_loss_fn(loop._loss_kind(args.loss),
                                           group)
    generator = torch.Generator(device=device)
    train_step = spatial.SpatialTrainStep(model, optimizer, loss_fn, prep,
                                          generator, group, seed=args.seed)
    eval_step = spatial.make_spatial_eval_step(model, loss_fn, prep,
                                               generator, group)
    if args.device_data_cache:
        print("Spatial sharding: --device-data-cache is not used")

    checkpoint_dir = pathlib.Path(args.model_dir)
    stats_dir = checkpoint_dir / "logs"
    if is_main and args.retrain and stats_dir.exists():
        shutil.rmtree(stats_dir)
    writer = (SummaryWriter(str(stats_dir)) if is_main
              else loop._NullWriter())

    def save(epoch):
        Checkpoint.save(checkpoint_dir, model, optimizer, epoch,
                        args.model_type, args.use_coords,
                        args.omit_optimizer_state_save,
                        model_depth=args.model_depth,
                        num_filters=args.num_filters,
                        master_dtype=step_lib.master_dtype_policy(),
                        upconv=args.upconv, group=group)

    batch_size = args.batch_size
    batch_count = max(1, int(math.ceil(len(train_idx) / batch_size)))
    sync = torch.cuda.synchronize if device.type == "cuda" else None
    timer = StepTimer(warmup=1, sync=sync)
    validation_timer = StepTimer(warmup=0, sync=sync)
    last_loss = float("nan")
    steps = validation_batches = 0
    print(f"Training from epoch {epoch_start} to {args.epochs}")
    for epoch in range(epoch_start, args.epochs):
        order = np.array(train_idx)
        data._host_rng.shuffle(order)
        data.prefetch(order[:batch_size])
        for i in range(batch_count):
            idx = order[i * batch_size:(i + 1) * batch_size]
            if len(idx) < batch_size:  # wrap-pad the last batch
                idx = np.resize(idx, batch_size)
            batch_index = epoch * batch_count + i
            with timer.measure():
                raw = loop._to_device(data.raw_batch(idx), device)
                data.prefetch(order[(i + 1) * batch_size:
                                    (i + 2) * batch_size])
                generator.manual_seed(stream_seed(args.seed,
                                                  batch_index + 1))
                loss = float(train_step(raw, step=batch_index + 1))
            steps += 1
            if not math.isfinite(loss):
                save(epoch)
                writer.close()
                raise FloatingPointError(
                    f"non-finite loss at epoch {epoch}, batch {i + 1}")
            writer.add_scalar("loss", loss, batch_index)
            print(f"Epoch {epoch}, Batch {i + 1}, loss: {loss:f}")
            last_loss = loss
        if epoch % args.save_frequency == 0:
            save(epoch)
        if epoch % args.validation_frequency == 0 and len(val_idx) > 0:
            total, count = 0.0, 0
            with validation_timer.measure():
                for lo in range(0, len(val_idx), batch_size):
                    vidx = np.resize(np.asarray(val_idx[lo:lo + batch_size]),
                                     batch_size)
                    true_n = min(batch_size, len(val_idx) - lo)
                    raw = loop._to_device(data.raw_batch(vidx), device)
                    generator.manual_seed(stream_seed(
                        args.seed, loop._VALIDATION_STREAM, epoch, lo))
                    # A wrap-padded batch weighs by its true size.
                    total += float(eval_step(raw)) * true_n
                    count += true_n
                    validation_batches += 1
            val_loss = total / count
            print(f"Epoch {epoch}, validation loss: {val_loss:f}")
            writer.add_scalar("val_loss", val_loss, epoch * batch_count)
    save(max(epoch_start, args.epochs - 1))
    writer.close()
    if timer.count:
        print(timer.summary())
    return loop.TrainingRun(last_loss, steps, validation_batches, timer,
                            validation_timer, model, optimizer)
