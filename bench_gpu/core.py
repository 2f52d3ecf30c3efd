"""The harness's general parts: cells by name, statistics, the profiler
trace's reduction, the import check and the result line.

A cell (an entry of BENCHMARK.json's `workloads`) names a configuration,
bench_gpu/configs/<config>.json, and a traffic mix,
bench_gpu/traffic/<traffic>.json; the mix names the driver
(bench_gpu/drivers/<driver>.py) that runs it and may override
configuration keys under "config". The limits of a cell's correctness
check are bench_gpu/limits/<cell>.json. A per-layer metric is read by
bench_gpu/metrics/<metric>.py, whose read(run) returns a number or None.
"""

from __future__ import annotations

import bisect
import importlib.util
import json
import math
import os
import pathlib
import re
import subprocess
import sys
from typing import Optional

ROOT = pathlib.Path(__file__).resolve().parent.parent
BENCH = ROOT / "bench_gpu"
# Top-level module names that no run may hold: JAX and the JAX package.
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "svbrdf_tpu")


def _json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark() -> dict:
    return _json(ROOT / "BENCHMARK.json")


def load_cell(name: str, benchmark: Optional[dict] = None) -> dict:
    """{'name', 'chips', 'config' (the configuration with the mix's
    overrides), 'traffic', 'limits'} of workload `name`."""
    benchmark = benchmark or load_benchmark()
    entry = next((w for w in benchmark["workloads"] if w["name"] == name),
                 None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    config = _json(BENCH / "configs" / f"{entry['config']}.json")
    traffic = _json(BENCH / "traffic" / f"{entry['traffic']}.json")
    config = {**config, **traffic.get("config", {})}
    return {"name": name, "chips": entry["chips"], "config": config,
            "traffic": traffic,
            "limits": _json(BENCH / "limits" / f"{name}.json")}


def metrics_of(benchmark: dict, cell: str, kind: str) -> list:
    """The `kind` ('end_to_end' | 'per_layer') metrics that cell reports:
    those that list it, and those without a list (a per-layer one if the
    cell reports the end-to-end metric it moves)."""
    e2e = [m for m in benchmark["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]]
    if kind == "end_to_end":
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in benchmark["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in names)]


def metric_reader(name: str):
    """bench_gpu/metrics/<name>.py's read function."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_gpu_metric_" + re.sub(r"\W", "_", name), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


# --- Statistics ---------------------------------------------------------------

def percentile(values, q: float) -> float:
    """Nearest-rank q-th percentile of all the values."""
    ordered = sorted(values)
    if not ordered:
        raise ValueError("percentile of no values")
    return ordered[max(0, math.ceil(q / 100.0 * len(ordered)) - 1)]


def window_metrics(durations, items_per: int, seconds: float) -> tuple:
    """(items a second, p95 ms) of a window: every item of the steps or
    calls that ended inside it over the window's seconds, and the 95th
    percentile of all their durations (seconds)."""
    return (items_per * len(durations) / seconds,
            1e3 * percentile(durations, 95))


def merge_intervals(intervals) -> list:
    """Sorted, disjoint union of (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def clip_intervals(intervals, lo: float, hi: float) -> list:
    return [(max(s, lo), min(e, hi)) for s, e in intervals
            if e > lo and s < hi]


def union_length(intervals, lo: float, hi: float) -> float:
    return sum(e - s for s, e in merge_intervals(
        clip_intervals(intervals, lo, hi)))


def gaps(intervals, lo: float, hi: float) -> list:
    """The stretches of [lo, hi] that no interval covers."""
    out, cursor = [], lo
    for s, e in merge_intervals(clip_intervals(intervals, lo, hi)):
        if s > cursor:
            out.append((cursor, s))
        cursor = max(cursor, e)
    if cursor < hi:
        out.append((cursor, hi))
    return out


# --- The profiler trace ---------------------------------------------------------

WINDOW_SPAN = "bench:profiled"
_RUNTIME = re.compile(r"^(cuda|cu[A-Z]|Memcpy|Memset)")


def _raw_events(prof):
    """[(name, on_device, start_us, end_us)] of a finished torch.profiler
    run."""
    from torch.autograd import DeviceType

    out = []
    kineto = getattr(getattr(prof, "profiler", None), "kineto_results", None)
    if kineto is not None and hasattr(kineto, "events"):
        for e in kineto.events():
            if hasattr(e, "start_ns"):
                start, end = e.start_ns() / 1e3, e.end_ns() / 1e3
            else:
                start = e.start_us()
                end = start + e.duration_us()
            out.append((e.name(), e.device_type() == DeviceType.CUDA, start,
                        end))
        return out
    for e in prof.events():
        out.append((e.name, e.device_type == DeviceType.CUDA,
                    e.time_range.start, e.time_range.end))
    return out


class Profiled:
    """What a torch.profiler run over `steps` steps (or calls) shows: the
    traced window (the host span WINDOW_SPAN), the device's activity in
    it (kernels, copies and sets), kernel launches, and the host's
    operations."""

    def __init__(self, events, steps: int):
        """`events`: [(name, on_device, start_us, end_us)]."""
        spans = [e for e in events if e[0] == WINDOW_SPAN and not e[1]]
        if not spans:
            raise RuntimeError(f"the trace has no {WINDOW_SPAN!r} span")
        self.lo, self.hi = spans[0][2], spans[0][3]
        self.steps = steps
        # The harness's host spans appear on the device's timeline too, as
        # annotations: they are no device activity.
        device = [e for e in events if e[1] and e[3] > self.lo
                  and e[2] < self.hi and not e[0].startswith("bench:")]
        self.device = [(s, e) for _, _, s, e in device]
        self.kernels = [(n, s, e) for n, _, s, e in device
                        if not n.startswith(("Memcpy", "Memset"))]
        host = [(s, e, n) for n, on_dev, s, e in events if not on_dev]
        self.spans = sorted(h for h in host if h[2].startswith("bench:")
                            and h[2] != WINDOW_SPAN)
        self.ops = sorted(h for h in host if not h[2].startswith("bench:")
                          and not _RUNTIME.match(h[2]))
        self.window_s = (self.hi - self.lo) / 1e6
        self.busy_s = union_length(self.device, self.lo, self.hi) / 1e6

    @classmethod
    def of(cls, prof, steps: int) -> "Profiled":
        return cls(_raw_events(prof), steps)

    @property
    def launches(self) -> int:
        return len(self.kernels)

    def kernel_seconds(self, pattern: str) -> float:
        rx = re.compile(pattern)
        return sum(e - s for n, s, e in self.kernels if rx.search(n)) / 1e6

    @staticmethod
    def _innermost(events, t: float, reach: int):
        """The latest-starting of `events` (sorted (start, end, name))
        that holds time t, looking back `reach` events."""
        k = bisect.bisect_right(events, (t, float("inf"), "")) - 1
        for s, e, n in reversed(events[max(0, k - reach):k + 1]):
            if e >= t:
                return n
        return None

    def _host_label(self, t: float) -> str:
        span = self._innermost(self.spans, t, len(self.spans))
        op = self._innermost(self.ops, t, 5000)
        return f"{span or 'bench:other'} > {op or 'python'}"

    def breakdown(self, top: int = 10) -> dict:
        ops = {}
        for n, s, e in self.kernels:
            key = n if len(n) <= 120 else n[:117] + "..."
            ops[key] = ops.get(key, 0.0) + (e - s) / 1e6
        idle = {}
        for s, e in gaps(self.device, self.lo, self.hi):
            label = self._host_label((s + e) / 2)
            idle[label] = idle.get(label, 0.0) + (e - s) / 1e6
        rank = lambda d: [[k, v] for k, v in sorted(  # noqa: E731
            d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": rank(ops), "idle_gaps": rank(idle)}


def trace(call, steps: int, device) -> Profiled:
    """A torch.profiler run over `steps` calls of call(labels=True), one
    step or prediction call each, inside the host span WINDOW_SPAN. The
    profiler slows the host (about twofold in a host-bound step on an
    H100), so a metric that sets device time against the step's takes
    the step's from the window (run["seconds"] over its steps)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        with torch.autograd.profiler.record_function(WINDOW_SPAN):
            for _ in range(steps):
                call(True)
            if cuda:
                torch.cuda.synchronize(device)
    return Profiled.of(prof, steps)


def host_loop_s() -> float:
    """Seconds of a fixed pure-Python loop: the host core's speed as this
    process sees it, which swings from run to run on a shared host."""
    import time

    start, x = time.perf_counter(), 0
    for i in range(2_000_000):
        x += i * i
    return time.perf_counter() - start


# --- The run's surroundings --------------------------------------------------------

def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is one
    of FORBIDDEN, compared whole."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".", 1)[0] in FORBIDDEN})


def card_info() -> dict:
    """The card's name, power limit and clocks as nvidia-smi reads them
    (empty where it cannot)."""
    fields = "name,power.limit,clocks.sm,clocks.max.sm,temperature.gpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={fields}",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return {}
    return {"nvidia_smi": out}


def host_info() -> dict:
    """The host as this process sees it: load average, usable cores, the
    core the calling thread last ran on and that core's clock (Linux
    /proc; empty where unreadable)."""
    out = {}
    try:
        with open("/proc/loadavg") as f:
            out["loadavg"] = f.read().split()[:3]
        out["cores"] = len(os.sched_getaffinity(0))
        with open("/proc/thread-self/stat") as f:
            cpu = int(f.read().rsplit(")", 1)[1].split()[36])
        out["cpu"] = cpu
        with open("/proc/cpuinfo") as f:
            mhz = [line.split(":")[1].strip() for line in f
                   if line.startswith("cpu MHz")]
        out["cpu_mhz"] = mhz[cpu] if cpu < len(mhz) else None
    except (OSError, ValueError, IndexError):
        pass
    return out


def check_line(checks: dict) -> list:
    """'name value <= limit' lines of the numbers compared."""
    return [f"check {k}: {v['value']!r} (limit {v['limit']!r})"
            for k, v in checks.items()]


def result(correct: bool, attempted: int, failed: int, metrics: dict,
           device: dict, checks: dict, breakdown=None) -> dict:
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return out
