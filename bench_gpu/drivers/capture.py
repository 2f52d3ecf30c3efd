"""The capture mix: MaterialGAN's latent capture, a closed loop of
iterations.

Set-up draws the mix's materials from the seed (corpus.material), their
flash scenes and photos by the program's data pipeline
(generate_input_scenes, synthesize_inputs), builds the generator by
models.build_model("materialgan") and loads seeded weights into it
(reference.stylegan2.make_weights), draws the noise maps, builds the
program's capture step (experiments.map_recovery.CaptureStep, from w_avg)
and runs its first `warm_steps` iterations, of which the first
`check_steps` are read for the check. The window goes on with the same
step: an iteration is timed from its call until its loss is on the host.
The reference then follows the checked iterations from the same weights,
W+, noise, photos and scenes (reference.stylegan2).

The readings the cell's limits are set from (on a card):

    python3 -m bench_gpu.drivers.capture --control \
        --workload materialgan.capture --seeds 1 2 3

one line of JSON a seed: the program against the reference ("program"),
the reference in bf16 in the program's place ("control", every conv and
dense input and weight rounded to bf16), and the program with its
demodulation left out ("no_demodulation").
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import sys
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from bench_gpu import core, corpus
from bench_gpu.drivers.train import sync
from bench_gpu.reference import maps as ref_maps
from bench_gpu.reference import stylegan2 as ref
from bench_gpu.reference.adam import stream_seed
from bench_gpu.reference.check import _held, passed

# Words that keep the capture's seed streams apart: weights, materials,
# photos and scenes, noise maps.
WEIGHTS_WORD, MATERIALS_WORD, PHOTOS_WORD, NOISE_WORD = 101, 102, 104, 106
SIZES = ("resolution", "w_dim", "mapping_layers", "max_channels",
         "channel_base")


@dataclass
class State:
    cell: dict
    device: torch.device
    weights: dict
    photos: torch.Tensor
    scenes: object
    wplus0: torch.Tensor
    noises0: list
    step: object
    readings: dict = field(default_factory=dict)
    setup_parts: dict = field(default_factory=dict)


def inputs(cell: dict, seed: int, device) -> tuple:
    """(photos (B, N, H, W, 3) linear, Scene of (B, N, 3) fields): the
    mix's seeded materials under the data pipeline's flash scenes."""
    from svbrdf_tpu_torch.data import pipeline

    cfg, mix = cell["config"], cell["traffic"]
    rng = np.random.default_rng(stream_seed(seed, MATERIALS_WORD))
    strips = np.stack([corpus.material(rng, cfg["image_size"])
                       for _ in range(mix["materials"])])
    svbrdf = ref_maps.decode_u8_svbrdf(
        torch.from_numpy(corpus.strips_to_maps(strips)).to(device))
    gen = torch.Generator(device=device).manual_seed(
        stream_seed(seed, PHOTOS_WORD))
    with torch.no_grad():
        scenes = pipeline.generate_input_scenes(
            mix["materials"], mix["photos"], True, generator=gen,
            device=device)
        photos = pipeline.synthesize_inputs(svbrdf, mix["photos"], True,
                                            generator=gen, scenes=scenes)
    return photos, scenes


def setup(cell: dict, seed: int, device, warm_steps=None) -> State:
    from svbrdf_tpu_torch.experiments.map_recovery import CaptureStep
    from svbrdf_tpu_torch.models import build_model

    cfg, mix = cell["config"], cell["traffic"]
    device = torch.device(device)
    marks = [time.perf_counter()]
    photos, scenes = inputs(cell, seed, device)
    marks.append(time.perf_counter())
    model = build_model(cfg["model_type"], device=device, seed=seed,
                        **{k: cfg[k] for k in SIZES})
    made = ref.make_weights(cfg, stream_seed(seed, WEIGHTS_WORD), device)
    if set(model.state_dict()) != set(made):
        raise RuntimeError("the model's parameters are not the "
                           "configuration's, in name")
    model.load_state_dict(made, strict=True)
    gen = torch.Generator(device=device).manual_seed(
        stream_seed(seed, NOISE_WORD))
    noises = model.make_noises(mix["materials"], gen)
    wplus = made["w_avg"].expand(mix["materials"], model.num_ws, -1)
    step = CaptureStep(model, photos, scenes, wplus, noises,
                       learning_rate=cfg["learning_rate"])
    state = State(cell, device, made, photos, scenes,
                  wplus.clone(), [n.clone() for n in noises], step)
    marks.append(time.perf_counter())
    first_steps(state, mix["warm_steps"] if warm_steps is None
                else warm_steps)
    marks.append(time.perf_counter())
    state.setup_parts = dict(zip(
        ("inputs_s", "model_and_step_s", "first_steps_s"),
        (b - a for a, b in zip(marks, marks[1:]))))
    return state


def timed_step(state: State, labels: bool = False) -> dict:
    """One iteration: the step's call, its loss on the host."""
    label = ((lambda name: torch.autograd.profiler.record_function(name))
             if labels else (lambda name: contextlib.nullcontext()))
    t0 = time.perf_counter()
    with label("bench:capture_step"):
        loss = state.step()
    t1 = time.perf_counter()
    with label("bench:loss_read"):
        loss = float(loss)
    t2 = time.perf_counter()
    return {"loss": loss, "start": t0, "end": t2, "call_s": t1 - t0,
            "wait_s": t2 - t1}


def first_steps(state: State, warm_steps: int) -> None:
    """The first iterations, through the window's call; the check's
    readings are the first check_steps'."""
    checked = state.cell["traffic"]["check_steps"]
    step = state.step
    losses = []
    for k in range(max(warm_steps, checked)):
        rec = timed_step(state)
        if k < checked:
            losses.append(rec["loss"])
        if k == 0:
            first = [step.wplus.grad.detach().clone()] + [
                n.grad.detach().clone() for n in step.noises]
        if k == checked - 1:
            wplus_change = step.wplus.detach() - state.wplus0
            noise_changes = [n.detach() - n0 for n, n0 in zip(
                step.noises, state.noises0)]
    state.readings = {"losses": losses, "wplus_grad": first[0],
                      "noise_grads": first[1:],
                      "wplus_change": wplus_change,
                      "noise_changes": noise_changes}


def window(state: State, seconds: float) -> tuple:
    """Iterations until `seconds` have passed; those that ended inside
    count. Returns (window start on the wall clock, spans)."""
    if state.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(state.device)
    sync(state.device)
    wall, start = time.time(), time.perf_counter()
    spans = []
    while True:
        rec = timed_step(state)
        if rec["end"] - start > seconds:
            break
        spans.append(rec)
    return wall, spans


def release(state: State) -> None:
    """Drop the program's step and model."""
    state.step = None
    gc.collect()
    if state.device.type == "cuda":
        torch.cuda.empty_cache()


def reference_readings(state: State, quant=ref._identity) -> dict:
    cfg = state.cell["config"]
    scenes = ref_maps.Scene(state.scenes.camera_pos, state.scenes.light_pos,
                            state.scenes.light_color)
    return ref.capture(state.weights, cfg, state.photos, scenes,
                       state.wplus0, state.noises0,
                       state.cell["traffic"]["check_steps"], quant)


def check(state: State) -> dict:
    reference = reference_readings(state)
    values = ref.gaps(state.readings, reference)
    print(f"readings: {values}\nlosses (program, reference): "
          f"{state.readings['losses']} {reference['losses']}",
          file=sys.stderr)
    return _held(values, state.cell["limits"])


def run(cell: dict, seed: int, seconds: float, trace: bool, device) -> dict:
    mix = cell["traffic"]
    state = setup(cell, seed, device)
    wall, spans = window(state, seconds)
    profiled = (core.trace(lambda labels: timed_step(state, labels),
                           mix["profile_steps"], state.device)
                if trace else None)
    peak = (torch.cuda.max_memory_allocated(state.device)
            if state.device.type == "cuda" else 0)
    release(state)
    checks = check(state)
    failed = sum(not math.isfinite(s["loss"]) for s in spans)
    e2e = {}
    if spans:
        e2e = dict(zip(("train_samples_per_s", "train_step_ms_p95"),
                       core.window_metrics([s["end"] - s["start"]
                                            for s in spans],
                                           mix["materials"], seconds)))
    return {"window_wall": wall, "setup_parts": state.setup_parts,
            "attempted": len(spans), "failed": failed, "e2e": e2e,
            "spans": spans, "profiled": profiled,
            "memory_peak_bytes": peak, "checks": checks,
            "correct": failed == 0 and bool(spans) and passed(checks)}


def control_readings(cell: dict, seed: int, device) -> dict:
    """The program, the bf16 control and the program without its
    demodulation, each against the f32 reference."""
    from svbrdf_tpu_torch.models import stylegan2

    warm = cell["traffic"]["check_steps"]
    state = setup(cell, seed, device, warm_steps=warm)
    release(state)
    f32 = reference_readings(state)
    out = {"program": ref.gaps(state.readings, f32),
           "control": ref.gaps(reference_readings(state, ref.bf16), f32)}
    original = stylegan2.demodulation
    stylegan2.demodulation = lambda weight, styles: torch.ones(
        styles.shape[0], weight.shape[0], device=styles.device)
    try:
        faulty = setup(cell, seed, device, warm_steps=warm)
        release(faulty)
    finally:
        stylegan2.demodulation = original
    out["no_demodulation"] = ref.gaps(faulty.readings, f32)
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
