"""The main path's step times of two trees side by side on the card.

    python3 -m svbrdf_tpu_torch.utils.compare_steps OLD_ROOT NEW_ROOT \
        [--pairs 10] [--out FILE]

Each measurement runs in a process of its own started in the tree's root,
so that it imports that tree's package and builds that tree's kernels; the
two trees alternate which runs first in each pair. A measurement is
chip_smoke.py phase 5's: the single-view mixed program at full width
(depth 8, 64 filters, 256^2, batch 8), f32 with TF32 off, its train step,
eval step and predict, each the median of 20 CUDA-event timings after 2
warm-up calls. Prints every run, then per step and tree the median and
range, and in how many pairs the new tree was faster. The other tree is
usually the parent commit, unpacked with git archive.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

# What one process runs, in the tree's root: only calls an older tree has.
_MEASURE = r"""
import json, statistics, torch
from svbrdf_tpu_torch.parallel.step import prepare
from svbrdf_tpu_torch.utils.bench_setup import build_program

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
program = build_program("single", "mixed", 8, 256, 8, 64, seed=0,
                        device="cuda")
images = prepare(program.raw, program.prep, program.generator)["inputs"]


def ms(fn, runs=20, warmup=2):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


print(json.dumps({
    "train_step": ms(lambda: program.train_step(program.raw)),
    "eval_step": ms(lambda: program.eval_step(program.raw)),
    "predict": ms(lambda: program.predict(images))}))
"""

STEPS = ("train_step", "eval_step", "predict")


def measure(root: str) -> dict:
    """One measurement of the tree at `root`, in a process of its own."""
    env = dict(os.environ, PYTHONPATH=root)
    out = subprocess.run([sys.executable, "-c", _MEASURE], cwd=root,
                         env=env, check=True, capture_output=True,
                         text=True).stdout
    return json.loads(out.strip().splitlines()[-1])


def compare(old: str, new: str, pairs: int) -> dict:
    """`pairs` pairs of measurements, the first tree of pair k `old` for
    even k and `new` for odd k; per step and tree the runs, median and
    range, and the pairs `new` won."""
    runs = {"old": [], "new": []}
    roots = {"old": old, "new": new}
    for k in range(pairs):
        for name in (("old", "new") if k % 2 == 0 else ("new", "old")):
            result = measure(roots[name])
            runs[name].append(result)
            print(json.dumps({"pair": k, "tree": name, **result}),
                  flush=True)
    summary = {}
    for step in STEPS:
        summary[step] = {
            name: {"median": statistics.median(r[step] for r in rs),
                   "min": min(r[step] for r in rs),
                   "max": max(r[step] for r in rs)}
            for name, rs in runs.items()}
        summary[step]["new_faster_pairs"] = sum(
            n[step] < o[step] for o, n in zip(runs["old"], runs["new"]))
    return {"pairs": pairs, "runs": runs, "summary": summary}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("old", help="root of the tree to compare against")
    p.add_argument("new", help="root of the tree under test")
    p.add_argument("--pairs", type=int, default=10)
    p.add_argument("--out", help="write the result as JSON here")
    args = p.parse_args(argv)
    result = compare(os.path.abspath(args.old), os.path.abspath(args.new),
                     args.pairs)
    for step, s in result["summary"].items():
        print(f"{step}: old median {s['old']['median']:.2f} "
              f"({s['old']['min']:.2f}-{s['old']['max']:.2f}), new median "
              f"{s['new']['median']:.2f} ({s['new']['min']:.2f}-"
              f"{s['new']['max']:.2f}); new faster in "
              f"{s['new_faster_pairs']} of {args.pairs} pairs")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f)


if __name__ == "__main__":
    main()
