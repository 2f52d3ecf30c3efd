"""The training mixes: the CLI's train loop driven step by step.

Set-up writes the mix's corpus of maps-only strips from the seed, builds
the dataset as the CLI's training run builds it (crop mode, mixing on,
its decode pool), runs one warm epoch through the pool into the host
cache, loads seeded weights into the model, builds Adam, the loss and the
train step from the program's public entries, and takes the first
`warm_steps` steps through the window's own call and feed. The first
`check_steps` of them are the ones the reference follows. The window then
goes on with the same object: a step is timed from the request for its
batch until its loss is on the host, as the CLI loop times it with
--log-every 1, and the loop, its shuffles, partner draws and per-step
reseeding are the CLI's.
"""

from __future__ import annotations

import contextlib
import gc
import math
import tempfile
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from bench_gpu import core, corpus, weights
from bench_gpu.reference import check as ref_check
from bench_gpu.reference.adam import stream_seed
from bench_gpu.reference.check import (CORPUS_WORD, DROPOUT_WORD, DTYPES,
                                       WEIGHTS_WORD)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class State:
    cell: dict
    seed: int
    device: torch.device
    scopes: contextlib.ExitStack
    tmp: tempfile.TemporaryDirectory
    strips: np.ndarray
    data: object
    model: object
    optimizer: object
    step: object
    generator: torch.Generator
    feed: "Feed"
    inputs: list = field(default_factory=list)
    readings: dict = field(default_factory=dict)
    setup_parts: dict = field(default_factory=dict)


class Feed:
    """Raw batches in the CLI loop's order: each epoch shuffles the
    training indices with the dataset's host RNG and hints the decode
    pool one batch ahead; a batch's partners are drawn inside raw_batch."""

    def __init__(self, data, train_idx, batch: int, device):
        self.data, self.train_idx, self.batch = data, train_idx, batch
        self.device = device
        self.count = max(1, math.ceil(len(train_idx) / batch))
        self.epoch, self.i, self.order = -1, self.count, None

    def next(self):
        """(step number, host batch, device batch)."""
        b = self.batch
        if self.i == self.count:
            self.epoch, self.i = self.epoch + 1, 0
            self.order = np.array(self.train_idx)
            self.data._host_rng.shuffle(self.order)
            self.data.prefetch(self.order[:b])
        idx = self.order[self.i * b:(self.i + 1) * b]
        if len(idx) < b:
            idx = np.resize(idx, b)
        raw = self.data.raw_batch(idx)
        dev = {k: torch.as_tensor(v).to(self.device) for k, v in raw.items()}
        self.data.prefetch(self.order[(self.i + 1) * b:(self.i + 2) * b])
        number = self.epoch * self.count + self.i + 1
        self.i += 1
        return number, raw, dev


def _label(name: str, on: bool):
    if not on:
        return contextlib.nullcontext()
    return torch.autograd.profiler.record_function(name)


def timed_step(state: State, labels: bool = False) -> dict:
    """One loop iteration: the batch, the step, its loss on the host."""
    t0 = time.perf_counter()
    with _label("bench:data", labels):
        number, raw, dev = state.feed.next()
    t1 = time.perf_counter()
    with _label("bench:step_call", labels):
        state.generator.manual_seed(stream_seed(state.seed, number))
        loss = state.step(dev, step=number)
    t2 = time.perf_counter()
    with _label("bench:loss_read", labels):
        loss = float(loss)
    t3 = time.perf_counter()
    return {"number": number, "raw": raw, "loss": loss, "start": t0,
            "end": t3, "data_s": t1 - t0, "call_s": t2 - t1,
            "wait_s": t3 - t2}


def setup(cell: dict, seed: int, device, warm_steps=None) -> State:
    from svbrdf_tpu_torch import losses
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
    # One warm epoch: every strip through the decode pool into the cache.
    for lo in range(0, len(data), 32):
        chunk = range(lo, min(lo + 32, len(data)))
        data.prefetch(chunk)
        for i in chunk:
            data.load_scaled(i)
    marks.append(time.perf_counter())

    model = build_model(cfg["model_type"], False, depth=cfg["model_depth"],
                        num_filters=cfg["num_filters"], device=device,
                        seed=seed, dtype=dtype)
    made = weights.make(cfg, stream_seed(seed, WEIGHTS_WORD), device)
    names = [n for n, _ in model.named_parameters()]
    if names != list(made):
        raise RuntimeError("the model's parameters are not the "
                           "configuration's, in name or order")
    model.load_state_dict(made, strict=True)
    del made
    step_lib.master_cast(model)
    optimizer = step_lib.make_optimizer(model.parameters(),
                                        cfg["learning_rate"], dtype)
    loss_fn = losses.make_loss_fn(cfg["loss"], cfg["renderer"],
                                  cfg["l1_weight"], tuple(cfg["spp"]))
    generator = torch.Generator(device=device)
    prep = step_lib.PrepConfig(
        used_input_image_count=cfg["used_image_count"],
        use_augmentation=True, is_linear=False,
        mix_materials=data.mix_materials)
    train_step = step_lib.make_train_step(model, optimizer, loss_fn, prep,
                                          generator, seed=seed)
    train_idx, _ = split_train_validation(len(data), 0.01, seed)
    state = State(cell, seed, device, scopes, tmp, strips, data, model,
                  optimizer, train_step, generator,
                  Feed(data, train_idx, cfg["batch_size"], device))
    marks.append(time.perf_counter())
    first_steps(state, mix["warm_steps"] if warm_steps is None
                else warm_steps)
    marks.append(time.perf_counter())
    state.setup_parts = dict(zip(
        ("corpus_s", "warm_epoch_s", "model_and_step_s", "first_steps_s"),
        (b - a for a, b in zip(marks, marks[1:]))))
    return state


def first_steps(state: State, warm_steps: int) -> None:
    """The first steps, through the window's call and feed; the readings
    the reference is held to are taken from the first check_steps."""
    checked = state.cell["traffic"]["check_steps"]
    params = list(state.model.parameters())
    p0 = [p.detach().clone() for p in params]
    omb1 = float(np.float32(1.0 - 0.9))
    # The first step's cotangent of the predicted maps, as the loss's
    # backward hands it to the model: a hook on the model's output for
    # that step alone.
    cotangent = []

    def capture(module, args, out) -> None:
        out.register_hook(lambda g: cotangent.append(g.detach().clone()))

    hook = state.model.register_forward_hook(capture)
    torch.manual_seed(stream_seed(state.seed, DROPOUT_WORD))
    losses = []
    for k in range(max(warm_steps, checked)):
        rec = timed_step(state)
        if k < checked:
            state.inputs.append(rec["raw"])
            losses.append(rec["loss"])
        if k == 0:
            hook.remove()
            grads = []
            for p in params:
                st = state.optimizer.state.get(p, {})
                mu = st.get("exp_avg")
                grads.append(None if mu is None else
                             float((mu.double() / omb1).norm()))
        if k == checked - 1:
            change = [float((p.detach().double() - q.double()).norm())
                      for p, q in zip(params, p0)]
            moved = [int((p.detach() != q).sum()) for p, q in zip(params, p0)]
            p0 = None
    state.readings = {"losses": losses, "grads": grads, "change": change,
                      "moved": moved,
                      **ref_check.cotangent_norms(cotangent[0])}


def window(state: State, seconds: float) -> tuple:
    """Steps until `seconds` have passed; those that ended inside count.
    Returns (window start on the wall clock, spans)."""
    if state.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(state.device)
    sync(state.device)
    wall = time.time()
    start = time.perf_counter()
    spans = []
    while True:
        rec = timed_step(state)
        if rec["end"] - start > seconds:
            break
        rec.pop("raw")
        spans.append(rec)
    return wall, start, spans


def release(state: State) -> None:
    """Stop the decode pool, drop the program's state, restore the
    precision settings and remove the corpus."""
    state.scopes.close()
    state.model = state.optimizer = state.step = state.data = None
    state.feed = None
    gc.collect()
    if state.device.type == "cuda":
        torch.cuda.empty_cache()
    state.tmp.cleanup()


def run(cell: dict, seed: int, seconds: float, trace: bool, device) -> dict:
    mix = cell["traffic"]
    state = setup(cell, seed, device)
    wall, start, spans = window(state, seconds)
    profiled = (core.trace(lambda labels: timed_step(state, labels),
                           mix["profile_steps"], state.device)
                if trace else None)
    peak = (torch.cuda.max_memory_allocated(state.device)
            if state.device.type == "cuda" else 0)
    release(state)
    checks = ref_check.train(cell, seed, state.strips, state.inputs,
                             state.readings, state.device)
    batch = cell["config"]["batch_size"]
    failed = sum(not math.isfinite(s["loss"]) for s in spans)
    e2e = {}
    if spans:
        e2e = dict(zip(("train_samples_per_s", "train_step_ms_p95"),
                       core.window_metrics([s["end"] - s["start"]
                                            for s in spans], batch,
                                           seconds)))
    return {"window_wall": wall, "setup_parts": state.setup_parts,
            "attempted": len(spans), "failed": failed,
            "e2e": e2e, "spans": spans, "profiled": profiled,
            "memory_peak_bytes": peak, "checks": checks,
            "correct": (failed == 0 and bool(spans)
                        and ref_check.passed(checks))}
