"""Run one benchmark cell once and print its result line.

    python3 bench_gpu/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell is an entry of BENCHMARK.json's `workloads`. With --trace 0 the
result's metrics are the cell's end-to-end metrics; with --trace 1 its
per-layer metrics, read from host spans over the window and from a
torch.profiler trace of the steps (or calls) that follow it. The last line
of standard output is the result, a JSON object; the numbers that decide
`correct` are also the last lines of standard error. The run needs a CUDA
card: without one (or with fewer than the cell asks for) it exits with a
code other than 0 and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys
import time


def _process_start() -> float:
    """Wall-clock time at which this process started (Linux /proc), else
    now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


START = _process_start()
ROOT = pathlib.Path(__file__).resolve().parent.parent
CACHE = ROOT / "bench_gpu" / ".cache"
# Every build and kernel cache at a fixed place inside the checkout.
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                 ("CUDA_CACHE_PATH", "nv_compute")):
    os.environ[var] = str(CACHE / sub)
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import importlib

    import torch

    from bench_gpu import core

    benchmark = core.load_benchmark()
    cell = core.load_cell(args.workload, benchmark)
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell["chips"]):
        print(f"bench_gpu: {args.workload} needs {cell['chips']} CUDA "
              f"card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    driver = importlib.import_module(
        f"bench_gpu.drivers.{cell['traffic']['driver']}")
    host_before = core.host_info()
    loop_before = core.host_loop_s()
    out = driver.run(cell, args.seed, args.seconds, bool(args.trace), device)
    setup_s = out["window_wall"] - START

    card = torch.cuda.get_device_name(device)
    device_info = {"platform": "gpu", "kind": card, "count": cell["chips"],
                   "memory_peak_bytes": int(out["memory_peak_bytes"])}
    metrics, breakdown = {}, None
    if args.trace:
        run = {"cell": cell, "spans": out["spans"], "seconds": args.seconds,
               "profiled": out["profiled"], "card": card}
        for m in core.metrics_of(benchmark, args.workload, "per_layer"):
            value = core.metric_reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_info["busy_s"] = out["profiled"].busy_s
        device_info["window_s"] = out["profiled"].window_s
        breakdown = out["profiled"].breakdown()
    else:
        values = {**out["e2e"], "setup_s": setup_s}
        for m in core.metrics_of(benchmark, args.workload, "end_to_end"):
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}

    found = core.forbidden_modules()
    if found:
        print(f"bench_gpu: the run loaded {found}", file=sys.stderr)
        return 4
    times = [s.get("end", 0) - s.get("start", 0) or s["call_s"]
             for s in out["spans"]]
    print(json.dumps({"card": card, **core.card_info(),
                      "setup_s": setup_s, "setup_parts": out["setup_parts"],
                      "memory_peak_bytes": out["memory_peak_bytes"],
                      "in_window": out["attempted"],
                      "host": [host_before, core.host_info()],
                      "ms_p5_p50_p95": [1e3 * core.percentile(times, q)
                                        for q in (5, 50, 95)]
                      if times else None,
                      # Ms a step (call): the window's, the profiled's.
                      "ms_window_traced": [
                          1e3 * args.seconds / len(times) if times else None,
                          1e3 * out["profiled"].window_s
                          / out["profiled"].steps if args.trace else None],
                      "host_loop_s": [loop_before, core.host_loop_s()]}))
    for line in core.check_line(out["checks"]):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(core.result(out["correct"], out["attempted"],
                                 out["failed"], metrics, device_info,
                                 out["checks"], breakdown)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
