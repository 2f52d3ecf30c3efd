"""The file-to-file prediction mix: a closed loop of one caller.

Set-up sets the process's intra-op threads to the mix's `host_threads`,
writes the mix's flash photos from the seed, loads seeded weights into
the model at the configuration's inference dtype and warms the call.
Each call of the window is
SvbrdfEstimator(model).predict_to_files([photo], out_dir) on the next
photo, cycled; it is timed from the call until it returns, and its
written map strip is removed after it, but for a seeded sample of the
calls whose bytes are kept for the check.
"""

from __future__ import annotations

import contextlib
import gc
import os
import tempfile
import time

import numpy as np
import torch

from bench_gpu import core, corpus, weights
from bench_gpu.drivers.train import sync
from bench_gpu.reference import check as ref_check
from bench_gpu.reference.adam import stream_seed
from bench_gpu.reference.check import (DTYPES, PHOTOS_WORD, SAMPLE_WORD,
                                       WEIGHTS_WORD)


class Caller:
    def __init__(self, cell, seed, device, dtype=None):
        from svbrdf_tpu_torch.estimator import SvbrdfEstimator
        from svbrdf_tpu_torch.models import build_model

        cfg, mix = cell["config"], cell["traffic"]
        self.device = torch.device(device)
        self.tmp = tempfile.TemporaryDirectory(prefix="bench_gpu_")
        self.photos = corpus.write_photos(
            f"{self.tmp.name}/photos", mix["photos"], cfg["image_size"],
            stream_seed(seed, PHOTOS_WORD), self.device)
        self.out_dir = f"{self.tmp.name}/maps"
        self.model = build_model(
            cfg["model_type"], False, depth=cfg["model_depth"],
            num_filters=cfg["num_filters"], device=self.device, seed=seed,
            dtype=DTYPES[dtype or cfg["predict_dtype"]])
        self.model.load_state_dict(weights.make(
            cfg, stream_seed(seed, WEIGHTS_WORD), self.device), strict=True)
        self.estimator = SvbrdfEstimator
        self.calls = 0

    def call(self, labels: bool = False) -> tuple:
        """(seconds, photo index, written bytes) of the next call."""
        k = self.calls % len(self.photos)
        self.calls += 1
        start = time.perf_counter()
        with (torch.autograd.profiler.record_function("bench:predict_call")
              if labels else contextlib.nullcontext()):
            (path,) = self.estimator(self.model).predict_to_files(
                [self.photos[k][0]], self.out_dir)
        seconds = time.perf_counter() - start
        with open(path, "rb") as f:
            written = f.read()
        os.remove(path)
        return seconds, k, written

    def close(self):
        self.model = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        self.tmp.cleanup()


def run(cell: dict, seed: int, seconds: float, trace: bool, device) -> dict:
    mix = cell["traffic"]
    marks = [time.perf_counter()]
    # One caller's host work (the maps' unpacking and byte conversion on
    # a 256^2 photo) gains nothing from a pool of threads, and waking the
    # pool's threads on every call puts their stalls into the tail.
    if "host_threads" in mix:
        torch.set_num_threads(mix["host_threads"])
    caller = Caller(cell, seed, device)
    marks.append(time.perf_counter())
    for _ in range(mix["warm_calls"]):
        caller.call()
    marks.append(time.perf_counter())
    # A seeded reservoir of the window's calls, kept for the check.
    rng = np.random.default_rng(stream_seed(seed, SAMPLE_WORD))
    keep, times, failed = [], [], 0
    if caller.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(caller.device)
    sync(caller.device)
    wall, start = time.time(), time.perf_counter()
    while True:
        try:
            dt, k, written = caller.call()
        except (RuntimeError, OSError, ValueError):
            failed += 1
            dt, k, written = None, None, None
        if time.perf_counter() - start > seconds:
            break
        if dt is None:
            continue
        times.append(dt)
        n = len(times)
        if n <= mix["check_calls"]:
            keep.append((caller.photos[k][1], written))
        else:
            j = int(rng.integers(0, n))
            if j < mix["check_calls"]:
                keep[j] = (caller.photos[k][1], written)
    profiled = (core.trace(caller.call, mix["profile_calls"],
                           caller.device) if trace else None)
    peak = (torch.cuda.max_memory_allocated(caller.device)
            if caller.device.type == "cuda" else 0)
    caller.close()
    checks = ref_check.predict(cell, seed, keep, caller.device)
    e2e = {}
    if times:
        e2e = dict(zip(("predict_photos_per_s", "predict_ms_p95"),
                       core.window_metrics(times, 1, seconds)))
    parts = dict(zip(("photos_and_model_s", "warm_calls_s"),
                     (b - a for a, b in zip(marks, marks[1:]))))
    return {"window_wall": wall, "setup_parts": parts,
            "attempted": len(times) + failed,
            "failed": failed, "e2e": e2e,
            "spans": [{"call_s": t} for t in times], "profiled": profiled,
            "memory_peak_bytes": peak, "checks": checks,
            "correct": (failed == 0 and bool(times)
                        and ref_check.passed(checks))}
