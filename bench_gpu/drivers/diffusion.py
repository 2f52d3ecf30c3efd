"""The diffusion mix: the DDPM U-Net's training steps through the CLI
loop's feed.

Set-up writes the mix's corpus of maps-only strips from the seed and
builds the dataset as the CLI's training run builds it (crop mode, mixing
on, its decode pool), runs one warm epoch through the pool into the host
cache, builds the model by models.build_model("diffusion") at the
configuration's widths, loads the seeded weights (reference.ddpm), casts
the masters, builds the optimizer and the program's
parallel/step.DiffusionTrainStep, and takes the first `warm_steps` steps
through the train mix's call and feed (drivers/train: Feed, timed_step);
the reference follows the first `check_steps` of them. The window goes on
with the same objects: a step is timed from the request for its batch
until its loss is on the host. The peak memory is the window's peak of
what the caching allocator reserves, which holds the CUDA graphs' pool.

The readings the cell's limits are set from (on a card):

    python3 -m bench_gpu.drivers.diffusion --control \
        --workload svbrdf_ddpm.train_diffusion --seeds 1 2 3

one line of JSON a seed: the program against the f32 reference
("program"), the reference in float8 in the program's place ("control"),
and the program with a planted fault: the attention's 1 / sqrt(C) left
out ("no_attention_scale"), GroupNorm over one group ("one_group"), the
time embedding's sin and cos swapped ("sin_cos_swapped").
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import sys
import tempfile
import time

import numpy as np
import torch

from bench_gpu import core, corpus
from bench_gpu.drivers import train
from bench_gpu.reference import ddpm
from bench_gpu.reference.adam import stream_seed
from bench_gpu.reference.check import (CORPUS_WORD, DTYPES, WEIGHTS_WORD,
                                       _held, cotangent_norms, passed,
                                       worst_leaves)

SIZES = ("ch", "ch_mult", "num_res_blocks", "attn_resolutions",
         "resolution", "groups", "eps")


def setup(cell: dict, seed: int, device, warm_steps=None) -> train.State:
    from svbrdf_tpu_torch.parallel.step import DiffusionTrainStep

    from svbrdf_tpu_torch.data.dataset import (SvbrdfDataset,
                                               split_train_validation)
    from svbrdf_tpu_torch.device import precision_scope
    from svbrdf_tpu_torch.models import build_model
    from svbrdf_tpu_torch.parallel import step as step_lib

    cfg, mix = cell["config"], cell["traffic"]
    device = torch.device(device)
    dtype = DTYPES[cfg["dtype"]]
    marks = [time.perf_counter()]
    scopes = contextlib.ExitStack()
    scopes.enter_context(step_lib.master_dtype_scope())
    scopes.enter_context(precision_scope(dtype))
    step_lib.set_master_dtype_policy(cfg.get("master_dtype"))
    tmp = tempfile.TemporaryDirectory(prefix="bench_gpu_")
    strips = corpus.write_strips(f"{tmp.name}/train", mix["strips"],
                                 cfg["image_size"],
                                 stream_seed(seed, CORPUS_WORD))
    marks.append(time.perf_counter())
    data = SvbrdfDataset(
        data_directory=f"{tmp.name}/train", image_size=cfg["image_size"],
        scale_mode="crop", input_image_count=0,
        used_input_image_count=cfg["used_image_count"],
        use_augmentation=True, mix_materials=True, no_svbrdf=False,
        is_linear=False, seed=seed)
    scopes.callback(data.close)
    for lo in range(0, len(data), 32):
        chunk = range(lo, min(lo + 32, len(data)))
        data.prefetch(chunk)
        for i in chunk:
            data.load_scaled(i)
    marks.append(time.perf_counter())

    model = build_model("diffusion", device=device, seed=seed, dtype=dtype,
                        **{k: cfg[k] for k in SIZES})
    made = ddpm.make_weights(cfg, stream_seed(seed, WEIGHTS_WORD), device)
    if [n for n, _ in model.named_parameters()] != list(made):
        raise RuntimeError("the model's parameters are not the "
                           "configuration's, in name or order")
    model.load_state_dict(made, strict=True)
    del made
    step_lib.master_cast(model)
    optimizer = step_lib.make_optimizer(model.parameters(),
                                        cfg["learning_rate"], dtype)
    generator = torch.Generator(device=device)
    prep = step_lib.PrepConfig(
        used_input_image_count=cfg["used_image_count"],
        use_augmentation=True, is_linear=False,
        mix_materials=data.mix_materials)
    step = DiffusionTrainStep(model, optimizer, prep, generator, seed=seed)
    train_idx, _ = split_train_validation(len(data), 0.01, seed)
    state = train.State(cell, seed, device, scopes, tmp, strips, data, model,
                        optimizer, step, generator,
                        train.Feed(data, train_idx, cfg["batch_size"],
                                   device))
    marks.append(time.perf_counter())
    first_steps(state, mix["warm_steps"] if warm_steps is None
                else warm_steps)
    marks.append(time.perf_counter())
    state.setup_parts = dict(zip(
        ("corpus_s", "warm_epoch_s", "model_and_step_s", "first_steps_s"),
        (b - a for a, b in zip(marks, marks[1:]))))
    return state


def first_steps(state: train.State, warm_steps: int) -> None:
    """The first steps, through the window's call and feed; the readings
    the reference is held to are taken from the first check_steps."""
    checked = state.cell["traffic"]["check_steps"]
    step = state.step
    p0 = [p.detach().clone() for p in step.params]
    e0 = [e.clone() for e in step.ema]
    omb1 = float(np.float32(1.0 - 0.9))
    cotangent = []

    def capture(module, args, out) -> None:
        out.register_hook(lambda g: cotangent.append(g.detach().clone()))

    hook = state.model.register_forward_hook(capture)
    losses = []
    for k in range(max(warm_steps, checked)):
        rec = train.timed_step(state)
        if k < checked:
            state.inputs.append(rec["raw"])
            losses.append(rec["loss"])
        if k == 0:
            hook.remove()
            grads = []
            for p in step.params:
                mu = state.optimizer.state.get(p, {}).get("exp_avg")
                grads.append(None if mu is None else
                             float((mu.double() / omb1).norm()))
        if k == checked - 1:
            change = [float((p.detach().double() - q.double()).norm())
                      for p, q in zip(step.params, p0)]
            moved = [int((p.detach() != q).sum())
                     for p, q in zip(step.params, p0)]
            ema_change = [float((e.double() - f.double()).norm())
                          for e, f in zip(step.ema, e0)]
            p0 = e0 = None
    state.readings = {"losses": losses, "grads": grads, "change": change,
                      "moved": moved, "ema_change": ema_change,
                      **cotangent_norms(cotangent[0])}


def reference(state: train.State, quant=ddpm._identity) -> tuple:
    return ddpm.train_steps(state.cell, state.seed, state.strips,
                            state.inputs, state.device, quant)


def check(state: train.State) -> dict:
    ref, unmatched = reference(state)
    names = [n for n, _, _ in ddpm.param_spec(state.cell["config"])]
    values = {"batch_rows_unmatched": unmatched,
              **ddpm.diffusion_gaps(state.readings, ref)}
    print(f"readings: {values}\nworst leaves: "
          f"{worst_leaves(state.readings, ref, names)}\nlosses (program, "
          f"reference): {state.readings['losses']} {ref['losses']}",
          file=sys.stderr)
    return _held(values, state.cell["limits"])


def run(cell: dict, seed: int, seconds: float, trace: bool, device) -> dict:
    mix = cell["traffic"]
    state = setup(cell, seed, device)
    wall, start, spans = train.window(state, seconds)
    profiled = (core.trace(lambda labels: train.timed_step(state, labels),
                           mix["profile_steps"], state.device)
                if trace else None)
    # Reserved, not allocated: the CUDA graphs' private pool holds the
    # step's activations between replays as reserved memory.
    peak = (torch.cuda.max_memory_reserved(state.device)
            if state.device.type == "cuda" else 0)
    train.release(state)
    checks = check(state)
    failed = sum(not math.isfinite(s["loss"]) for s in spans)
    e2e = {}
    if spans:
        e2e = dict(zip(("train_samples_per_s", "train_step_ms_p95"),
                       core.window_metrics([s["end"] - s["start"]
                                            for s in spans],
                                           cell["config"]["batch_size"],
                                           seconds)))
    return {"window_wall": wall, "setup_parts": state.setup_parts,
            "attempted": len(spans), "failed": failed, "e2e": e2e,
            "spans": spans, "profiled": profiled,
            "memory_peak_bytes": peak, "checks": checks,
            "correct": failed == 0 and bool(spans) and passed(checks)}


# --- The control readings ----------------------------------------------------

def _faults() -> dict:
    """name -> (module-level function of models.ddpm_unet, its faulty
    stand-in)."""
    from torch.nn import functional as F

    from svbrdf_tpu_torch.models import ddpm_unet

    embedding, norm = ddpm_unet.timestep_embedding, ddpm_unet.group_norm

    def swapped(t, dim):
        e = embedding(t, dim)
        return torch.cat([e[:, dim // 2:], e[:, :dim // 2]], dim=1)

    return {
        "no_attention_scale": ("attention", lambda q, k, v: (
            F.scaled_dot_product_attention(q[:, None], k[:, None],
                                           v[:, None], scale=1.0)[:, 0])),
        "one_group": ("group_norm", lambda x, groups, w, b, eps: norm(
            x, 1, w, b, eps)),
        "sin_cos_swapped": ("timestep_embedding", swapped)}


def control_readings(cell: dict, seed: int, device) -> dict:
    """The program, the float8 control and the planted faults, each
    against the f32 reference."""
    from bench_gpu.reference.model import fp8
    from svbrdf_tpu_torch.models import ddpm_unet

    warm = cell["traffic"]["check_steps"]
    state = setup(cell, seed, device, warm_steps=warm)
    train.release(state)
    f32, _ = reference(state)
    low, _ = reference(state, fp8)
    out = {"program": ddpm.diffusion_gaps(state.readings, f32),
           "control": ddpm.diffusion_gaps(low, f32)}
    for name, (attr, faulty) in _faults().items():
        original = getattr(ddpm_unet, attr)
        setattr(ddpm_unet, attr, faulty)
        try:
            broken = setup(cell, seed, device, warm_steps=warm)
            train.release(broken)
        finally:
            setattr(ddpm_unet, attr, original)
        out[name] = ddpm.diffusion_gaps(broken.readings, f32)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--control", action="store_true", required=True)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    cell = core.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("the control readings need a CUDA card", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    for seed in args.seeds:
        print(json.dumps({"workload": args.workload, "seed": seed,
                          **control_readings(cell, seed, device)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
