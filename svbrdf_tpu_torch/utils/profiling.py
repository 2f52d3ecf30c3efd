"""Step-time statistics, trace capture and the program's host spans.

Counterpart of svbrdf_tpu/utils/profiling.py. `StepTimer` keeps the
wall-clock times of measured steps; given a `sync` (torch.cuda.synchronize
on the card) it waits for the device before reading the clock at both ends,
so a step's time is the card's and not the enqueue's. `trace_steps` wraps a
window of steps in a torch.profiler trace and writes it as a Chrome trace
(viewable in Perfetto or chrome://tracing). `span` names a stretch of the
program's host work on an active profiler's clock. The program's spans:
the train step's phases, step.prepare, step.forward, step.loss,
step.backward and step.optimizer (parallel/step.TrainStep and the steps
built on it); the data layer's data.raw_batch and, one a cache miss,
data.decode (data/dataset.SvbrdfDataset); a prediction call's
predict.decode, predict.forward and predict.encode
(estimator.SvbrdfEstimator.predict_to_files); a latent capture
iteration's capture.synthesis, capture.loss, capture.backward and
capture.optimizer (experiments/map_recovery.CaptureStep); a diffusion
train step's diffusion.noise (the maps' encoding, the draws of t and
eps, x_t) between step.prepare and step.forward, and diffusion.ema
inside step.optimizer (parallel/step.DiffusionTrainStep); and one
diffusion.sample a DDIM step of a diffusion model's prediction
(models/ddpm_unet.ddim_sample).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Iterator, Optional

import numpy as np
from torch._C._autograd import _profiler_enabled
from torch._C._profiler import _RecordFunctionFast

_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A context manager that records a host range `name`, with its start
    and end, on the active torch.profiler, on the clock of the profiler's
    device activity. Without an active profiler it records nothing and
    costs a few hundred ns; one open when a profiler starts records nothing
    (a profiler's start or stop inside a span is harmless).

    The range is a function-scope record: the profiler keeps it on the
    host's timeline only. A user-scope one (record_function) would be
    mirrored onto the card's timeline as an annotation."""
    return _RecordFunctionFast(name) if _profiler_enabled() else _NO_SPAN


@contextlib.contextmanager
def trace_steps(log_dir: Optional[str]) -> Iterator[None]:
    """Capture a torch.profiler trace (CPU and, where there is one, CUDA
    activity) into log_dir/trace.json (no-op when log_dir is None)."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepTimer:
    """Streaming wall-clock stats for train steps.

    Excludes the first `warmup` steps (cuDNN autotuning, kernel builds)
    from the summary.
    """

    def __init__(self, warmup: int = 1, sync: Optional[Callable] = None):
        self.warmup = warmup
        self._sync = sync or (lambda: None)
        self._times: list = []

    @contextlib.contextmanager
    def measure(self) -> Iterator[None]:
        self._sync()
        t0 = time.perf_counter()
        yield
        self._sync()
        self._times.append(time.perf_counter() - t0)

    @property
    def count(self) -> int:
        return len(self._times)

    def steady_times(self) -> np.ndarray:
        return np.asarray(self._times[self.warmup:] or self._times)

    def mean_ms(self) -> float:
        return float(self.steady_times().mean() * 1e3) if self._times else 0.0

    def median_ms(self) -> float:
        return (float(np.median(self.steady_times()) * 1e3)
                if self._times else 0.0)

    def summary(self) -> str:
        if not self._times:
            return "no steps timed"
        t = self.steady_times()
        first = self._times[0] * 1e3
        return (f"steps: {self.count}, first {first:.1f} ms (incl. warm-up), "
                f"median {np.median(t) * 1e3:.2f} ms, "
                f"mean {t.mean() * 1e3:.2f} ms, "
                f"p95 {np.percentile(t, 95) * 1e3:.2f} ms")
