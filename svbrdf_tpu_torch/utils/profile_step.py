"""Where a training path's train step spends its time on the card.

    python -m svbrdf_tpu_torch.utils.profile_step [--path PATH]
        [--dtype DTYPE] [--renderer RENDERER] [--out FILE]

PATH is single-mixed (the main path: single-view model, mixed loss; the
default) or multi-rendering (multi-view model with 3 synthesized views,
rendering-only loss). DTYPE is the compute dtype, float32 (the default,
TF32 off) or bfloat16 (TF32 settings left as torch has them, as the CLI's
device.precision_scope does; the master-dtype policy in force, bf16sr
unless SVBRDF_MASTER_DTYPE says f32). RENDERER is the loss's renderer,
local (the default: the fused loss kernels) or pathtracing (the
path-traced loss: the path tracer's kernels, csrc/pathtrace.cu, and torch
ops around them). Builds that program
(bench_setup.build_program: depth 8, 64 filters, 256^2, batch 8) and, after
warm-up, reports:
  - phases: CUDA-event medians of one step's parts (prepare, forward, loss,
    loss_backward: the loss's gradient for the maps, backward: the
    model's, Adam) over STEPS steps, the forward and the Adam step as the
    train step runs them (its casts; the fused SR-Adam kernel for a bf16
    model);
  - kernels: torch.profiler device time per kernel name over STEPS steps
    (annotation ranges such as Optimizer.step#Adam.step left out: they span
    kernels),
    grouped into categories, the device's busy time and its idle share of
    the wall time.
Prints one JSON object; --out also writes it to FILE. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import sys
import time

STEPS = 10  # timed train steps per measurement


def phase_times(program, steps):
    import torch

    from svbrdf_tpu_torch.parallel.step import prepare

    step = program.train_step
    names = ("prepare", "forward", "loss", "loss_backward", "backward",
             "adam")
    samples = {n: [] for n in names}
    for n in range(steps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(7)]
        ev[0].record()
        batch = prepare(program.raw, program.prep, program.generator)
        ev[1].record()
        pred = step.forward(batch["inputs"])
        ev[2].record()
        loss = step.loss_fn(pred, batch["svbrdf"], program.generator)
        ev[3].record()
        step.optimizer.zero_grad(set_to_none=True)
        (dpred,) = torch.autograd.grad(loss, pred)
        ev[4].record()
        pred.backward(dpred)
        ev[5].record()
        step.apply_gradients(step.step_index + 1)
        step.step_index += 1
        ev[6].record()
        ev[6].synchronize()
        for i, n in enumerate(names):
            samples[n].append(ev[i].elapsed_time(ev[i + 1]))
    return {n: statistics.median(v) for n, v in samples.items()}


_ANNOTATION = re.compile(r"[\w.]+#[\w.]+")

# Kernel-name patterns of each category; the first match wins.
PATHS = {"single-mixed": ("single", "mixed"),
         "multi-rendering": ("multi", "rendering")}

CATEGORIES = (
    # cuDNN's layout transforms around NCHW convolutions (bf16 kernels take
    # NHWC).
    ("layout_transform", ("nchwToNhwc", "nhwcToNchw", "nchw2nhwc",
                          "nhwc2nchw")),
    ("sr_adam", ("sr_adam_kernel",)),
    ("mixed_loss", ("mixed_fwdgrad_kernel", "value_loss_kernel<true>")),
    ("rendering_loss", ("rendering_fwdgrad_kernel",
                        "value_loss_kernel<false>")),
    ("pathtrace", ("shade_kernel", "shade_vjp_kernel")),
    # cuDNN's implicit-GEMM, FFT and Winograd convolutions; the model's few
    # small Linear layers' GEMMs land here too.
    ("convolution", ("conv", "xmma", "cudnn", "fft", "dgrad", "wgrad",
                     "pointwise_mult_and_sum_complex", "gemm")),
    ("optimizer", ("multi_tensor_apply",)),
    ("reduction", ("reduce_kernel",)),
    ("elementwise_and_copy", ("elementwise", "Copy", "copy", "cat")),
)


def _category(name: str) -> str:
    for category, patterns in CATEGORIES:
        if any(p in name for p in patterns):
            return category
    return "other"


def _kernel_times(program, steps):
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        for _ in range(steps):
            program.train_step(program.raw)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3
    rows = []
    for e in prof.key_averages():
        # Annotation ranges (Optimizer.step#Adam.step) span kernels; kernel
        # names are signatures and may hold '#' too ({lambda(int)#1}).
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or _ANNOTATION.fullmatch(e.key)):
            continue
        rows.append({"name": e.key[:120], "count": e.count,
                     "ms_per_step": e.self_device_time_total / 1e3 / steps})
    rows.sort(key=lambda r: -r["ms_per_step"])
    busy = sum(r["ms_per_step"] for r in rows)
    categories = {}
    for r in rows:
        c = _category(r["name"])
        categories[c] = categories.get(c, 0.0) + r["ms_per_step"]
    return {"wall_ms_per_step": wall_ms / steps, "busy_ms_per_step": busy,
            "idle_share": 1.0 - busy * steps / wall_ms,
            "categories_ms_per_step": categories,
            "top": rows[:25], "n_kernel_names": len(rows)}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--path", choices=sorted(PATHS),
                        default="single-mixed")
    parser.add_argument("--dtype", choices=("float32", "bfloat16"),
                        default="float32")
    parser.add_argument("--renderer", choices=("local", "pathtracing"),
                        default="local")
    parser.add_argument("--out", default="")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        sys.exit("profile_step: needs a CUDA device")
    from svbrdf_tpu_torch.device import precision_scope
    from svbrdf_tpu_torch.parallel.step import master_dtype_policy
    from svbrdf_tpu_torch.training.loop import DTYPES
    from svbrdf_tpu_torch.utils.bench_setup import build_program

    dtype = DTYPES[args.dtype]
    with precision_scope(dtype):
        program = build_program(*PATHS[args.path], dtype=dtype,
                                renderer=args.renderer)
        for _ in range(3):
            program.train_step(program.raw)
        torch.cuda.synchronize()
        result = {"path": args.path, "dtype": args.dtype,
                  "renderer": args.renderer,
                  "master_dtype": master_dtype_policy(),
                  "tf32": {"cudnn": torch.backends.cudnn.allow_tf32,
                           "matmul": torch.backends.cuda.matmul.allow_tf32},
                  "device": torch.cuda.get_device_name(0),
                  "torch": torch.__version__,
                  "phases_ms": phase_times(program, STEPS),
                  "kernels": _kernel_times(program, STEPS)}
    text = json.dumps(result, indent=1)
    print(text)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")


if __name__ == "__main__":
    main()
