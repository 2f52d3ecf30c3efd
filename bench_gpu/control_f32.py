"""The readings below f32 of an f32 training cell: the reference in the
precision below the one its configuration states, and the program with
TF32 on.

    python3 bench_gpu/control_f32.py --workload single_view.train_local_f32 \
        --seeds <n> [<n> ...]

For each seed, one line of JSON: the program's first steps against the
f32 reference ("program"); the reference with every conv and dense
layer's input and weight, the predicted maps and the local renderer's
target rounded to bf16 in the program's place ("control"); and the
program's first steps with TF32 on for its convolutions and matrix
products ("tf32"), which the cell's limits have to catch. control.py
gives the same cell's float8 and half-batch readings. The benchmark's
runs never run this; it needs a CUDA card.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import sys

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


@contextlib.contextmanager
def tf32_scope(dtype):
    """device.precision_scope's stand-in: TF32 on for the convolutions
    and matrix products, whatever `dtype` asks for."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def readings(cell, seed, device) -> dict:
    from bench_gpu.drivers import train
    from bench_gpu.reference import check
    from svbrdf_tpu_torch import device as device_lib

    steps = cell["traffic"]["check_steps"]
    state = train.setup(cell, seed, device, warm_steps=steps)
    train.release(state)
    ref, unmatched = check.reference_steps(cell, seed, state.strips,
                                           state.inputs, device)
    low, _ = check.reference_steps(cell, seed, state.strips, state.inputs,
                                   device, quant=bf16)
    scope = device_lib.precision_scope
    device_lib.precision_scope = tf32_scope
    try:
        tf32 = train.setup(cell, seed, device, warm_steps=steps)
        train.release(tf32)
    finally:
        device_lib.precision_scope = scope
    return {"program": check.gaps(state.readings, ref),
            "control": check.gaps(low, ref),
            "tf32": check.gaps(tf32.readings, ref), "unmatched": unmatched}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)

    from bench_gpu import core

    cell = core.load_cell(args.workload)
    if cell["config"]["dtype"] != "float32":
        print("control_f32.py reads f32 cells", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("control_f32.py needs a CUDA card", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    for seed in args.seeds:
        print(json.dumps({"workload": args.workload, "seed": seed,
                          **readings(cell, seed, device)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
