"""The readings that a cell's correctness limits are set from.

    python3 bench_gpu/control.py --workload <cell> --seeds <n> [<n> ...]

For each seed, one line of JSON with the numbers the run compares:
- a training cell: the program's first steps against the reference
  ("program"), the reference computed in float8 (e4m3, per-tensor scaled)
  in the program's place ("control"), and the program with half of each
  batch left out of the loss, the mean taken over the rest ("half_batch");
- the prediction cell: the program's sampled calls ("program") and the
  program's own bf16 path in its place ("control").
The benchmark's runs never run this; it needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def train_readings(cell, seed, device) -> dict:
    from svbrdf_tpu_torch.parallel import step as step_lib

    from bench_gpu.drivers import train
    from bench_gpu.reference import check
    from bench_gpu.reference.model import fp8

    warm = cell["traffic"]["check_steps"]
    state = train.setup(cell, seed, device, warm_steps=warm)
    train.release(state)
    ref, unmatched = check.reference_steps(cell, seed, state.strips,
                                           state.inputs, device)
    low, _ = check.reference_steps(cell, seed, state.strips, state.inputs,
                                   device, quant=fp8)
    cfg = cell["config"]
    names = [n for n, _, _ in check.param_spec(
        cfg["model_type"], cfg["num_filters"], cfg["model_depth"])]
    out = {"program": check.gaps(state.readings, ref),
           "control": check.gaps(low, ref), "unmatched": unmatched,
           "worst": check.worst_leaves(state.readings, ref, names)}
    original = step_lib.loss_rows

    def half_batch(loss_fn, pred, target, generator, span, *args):
        h = pred.shape[0] // 2
        return original(loss_fn, pred[:h], target[:h], generator, (0, h, h),
                        *args)

    step_lib.loss_rows = half_batch
    try:
        faulty = train.setup(cell, seed, device, warm_steps=warm)
        train.release(faulty)
    finally:
        step_lib.loss_rows = original
    out["half_batch"] = check.gaps(faulty.readings, ref)
    return out


def predict_readings(cell, seed, device, calls: int = 8) -> dict:
    from bench_gpu.drivers import predict
    from bench_gpu.reference import check

    out = {}
    for label, dtype in (("program", None), ("control", "bfloat16")):
        caller = predict.Caller(cell, seed, device, dtype=dtype)
        samples = []
        for _ in range(calls):
            _, k, written = caller.call()
            samples.append((caller.photos[k][1], written))
        caller.close()
        out[label] = {"map_gap_bytes": check.predict_gaps(cell, seed,
                                                          samples, device)}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)

    import torch

    from bench_gpu import core

    cell = core.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("control.py needs a CUDA card", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    readings = (train_readings if cell["traffic"]["driver"] == "train"
                else predict_readings)
    for seed in args.seeds:
        print(json.dumps({"workload": args.workload, "seed": seed,
                          **readings(cell, seed, device)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
