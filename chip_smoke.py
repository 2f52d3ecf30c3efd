"""Drive the PyTorch port's main paths on one NVIDIA GPU, hold each of its
hand-written kernels against its plain version at the paths' shapes, and
print each kernel's launches and device time beside its bound.

    python3 chip_smoke.py

A smoke run of a few minutes. The card's whole check is
tests/test_torch_card.py (small and ragged shapes, the CLI, the launcher,
data and spatial parallelism, the tools), and the port's end-to-end
timings are the benchmark's (bench_gpu/run.py --trace 1). Phases, each
raising (and so exiting non-zero) on a failure:

  1. device: the card's name and power limit, torch and CUDA versions;
     TF32 off.
  2. kernels at the paths' shapes, each against its plain version by the
     card suite's rules:
     - the five loss kernels at B=8, 12 x 256 x 256 planes, S=9
       (bench_setup.loss_inputs), f32 and bf16 planes: loss rel 1e-5; the
       training kernels' gradients within bench_setup.GRAD_EXACT (f32) or
       equal (bf16); the `both` kernel's against the plain version in
       float64 away from the loss's kinks, normwise no further than 2x
       the plain version's own distance (and 2e-4 for f32);
     - the block tails of both full-width models at batch 8
       (bench_setup.hold_tail_kernels);
     - SR-Adam over every leaf of both full-width models in the bf16-SR
       dtypes, bit-exact, one launch a table;
     - the path tracer's two kernels at B=8, S=9, 256^2, spp (16, 8), for
       an f32 and a bf16 SVBRDF (bench_setup.hold_pathtrace_kernels);
     - the styled conv tails of MaterialGAN's config-f generator at batch
       8 (bench_setup.hold_styled_tail_kernels).
  3. paths: each of bench_setup.PATHS at full width, built by
     bench_setup.build_program, in two parts, 5 train steps, then an eval
     step and a predict: every launch counter zeroed just before a part
     and read just after it, each equal to the path's table (the loss or
     path tracer kernels, the block tails, sr_adam), every other 0; the
     losses finite. Each part runs under torch.profiler. Then
     MaterialGAN's capture at the benchmark cell's shapes (config-f at
     256^2, 8 materials, 7 photos each): 2 iterations, then 3 counted and
     profiled, 13 + 13 styled_tail launches an iteration.
  4. the `kernels` line, one JSON record: for each path, part and
     kernel, its launches, its device time (ms, torch.profiler's CUPTI
     trace of that part) and its bound (ms: the larger of the bytes it
     must move over the memory rate and its operations over the peak
     rates, bench_gpu/counts/bounds.py; the block tails, the styled
     conv tails and SR-Adam by their bytes alone), and the bound's share
     of the device time.
"""

import json
import math
import re
import subprocess
import sys
import time

import torch

from bench_gpu.counts.bounds import (card_rates, loss_bound_s,
                                     pathtrace_bound_s)
from svbrdf_tpu_torch.data import pipeline
from svbrdf_tpu_torch.utils import bench_setup

BF16 = torch.bfloat16
BATCH, SIZE, DEPTH, FILTERS, SCENES, SPP = 8, 256, 8, 64, 9, (16, 8)
STEPS = 5
PHOTOS, CAPTURE_ITERATIONS = 7, 3
# The device function each launch counter (less its dtype suffix) runs.
DEVICE_NAMES = {"mixed_fwdgrad": "mixed_fwdgrad_kernel",
                "mixed_fwd": "value_loss_kernel",
                "render_fwdgrad": "rendering_fwdgrad_kernel",
                "render_fwd": "value_loss_kernel",
                "render_fwdgrad_both": "rendering_both_kernel",
                "pathtrace_shade": "shade_kernel",
                "pathtrace_shade_vjp": "shade_vjp_kernel",
                "norm_merge_fwd": "norm_merge_fwd_kernel",
                "norm_merge_bwd": "norm_merge_bwd_kernel",
                "sr_adam": "sr_adam_kernel",
                "styled_tail_fwd": "styled_tail_fwd_kernel",
                "styled_tail_bwd": "styled_tail_bwd_kernel"}


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.cuda.get_device_name(0)


def _outputs(out) -> tuple:
    return out if isinstance(out, tuple) else (out,)


def _kept_normwise(actual, expected, keep) -> float:
    """||actual - expected|| / ||expected|| in float64 over the pixels
    where `keep` ((B, H, W)) is true."""
    actual = actual.double() * keep[:, None]
    expected = expected.double() * keep[:, None]
    return float((actual - expected).norm() / expected.norm())


def hold_loss_kernels() -> None:
    from svbrdf_tpu_torch.ops import render_fused as rf

    for dtype in (torch.float32, BF16):
        inputs = bench_setup.loss_inputs(BATCH, SIZE, SCENES, device="cuda",
                                         dtype=dtype)
        inputs64 = tuple(x.double() for x in inputs)
        keep = rf.kink_distance(*inputs64) >= rf.KINK_MARGIN
        for name in sorted(rf.PLAIN_VERSIONS):
            out = _outputs(rf.CUDA_WRAPPERS[name](*inputs))
            ref = _outputs(rf.PLAIN_VERSIONS[name](*inputs))
            ref64 = (_outputs(rf.PLAIN_VERSIONS[name](*inputs64))
                     if name == "render_fwdgrad_both" else ref)
            loss_rel = abs(float(out[0]) - float(ref[0])) / abs(float(ref[0]))
            dists = []
            for grad, ref_grad, grad64 in zip(out[1:], ref[1:], ref64[1:]):
                if grad.dtype != dtype or not bool(
                        torch.isfinite(grad).all()):
                    raise RuntimeError(f"{name} {dtype}: a gradient not "
                                       f"finite or not in {dtype}")
                if name == "render_fwdgrad_both":
                    dists.append(_kept_normwise(grad, grad64, keep))
                    plain = _kept_normwise(ref_grad, grad64, keep)
                    ok = dists[-1] <= 2.0 * plain and (
                        dtype == BF16 or dists[-1] <= 2e-4)
                elif dtype == BF16:
                    dists.append(float(not torch.equal(grad, ref_grad)))
                    ok = dists[-1] == 0.0
                else:
                    dists.append(bench_setup.grad_distance(grad, ref_grad))
                    ok = dists[-1] <= bench_setup.GRAD_EXACT
                if not ok:
                    raise RuntimeError(f"{name} {dtype}: gradient off the "
                                       f"plain version's ({dists[-1]:.3e})")
            if not loss_rel <= 1e-5:
                raise RuntimeError(f"{name} {dtype}: loss rel {loss_rel:.3e}"
                                   f" off the plain version's")
            log(f"loss kernel {name} {dtype}: loss rel {loss_rel:.2e}, "
                f"gradients {', '.join(f'{d:.2e}' for d in dists)}")


def hold_tails() -> None:
    for kind in ("single", "multi"):
        cases = sorted(set(bench_setup.tail_cases(kind, BATCH, SIZE)))
        failed = {str(c): h["failed"] for c in cases
                  if (h := bench_setup.hold_tail_kernels(c))["failed"]}
        if failed:
            raise RuntimeError(f"norm_merge kernels off the plain version "
                               f"on the {kind}-view tails: {failed}")
        log(f"norm_merge: {len(cases)} tail shapes of the {kind}-view "
            f"model held to the plain version (f32 and bf16)")


def hold_sr_adam() -> None:
    from svbrdf_tpu_torch.ops import sr_adam
    from svbrdf_tpu_torch.parallel import optimizer as opt

    s = opt.adam_scalars(1e-5, (0.9, 0.999), 1e-8, 2148, 2148 * 1000003,
                         2 ** 32 - 40)
    for kind in ("single", "multi"):
        leaves = bench_setup.sr_adam_model_leaves(kind, "bf16sr")
        tables = math.ceil(len(leaves) / sr_adam.max_leaves())
        bench_setup.hold_sr_adam_multi(leaves, s, tables)
        log(f"sr_adam: {len(leaves)} leaves of the {kind}-view model "
            f"bit-exact, {tables} launch(es)")


def hold_pathtrace() -> None:
    for dtype in (torch.float32, BF16):
        case = bench_setup.pathtrace_case(BATCH, SIZE, SIZE, SPP, dtype)
        out = bench_setup.hold_pathtrace_kernels(case)
        log(f"path tracer {dtype}: renders {out['render']['beyond_rtol']:.2e}"
            f" beyond rtol, VJP sums within their tolerance")


def hold_styled_tails() -> None:
    cases = bench_setup.styled_tail_cases(BATCH)
    failed = {str(c): h for c in cases
              if (h := bench_setup.hold_styled_tail_kernels(c))["failed"]}
    if failed:
        raise RuntimeError(f"styled_tail kernels off the plain version: "
                           f"{failed}")
    log(f"styled_tail: {len(cases)} styled conv tails of the config-f "
        f"generator held to the plain version")


def _styled_tail_bytes(case: tuple) -> tuple:
    """(forward, backward, saved) bytes of a styled conv's tail, f32: what
    the function must move, each value read or written once (forward t
    in, out out, the noise map in; backward the cotangent and y, or about
    as many values of t, in, t's gradient out, the noise map in and its
    gradient out), and what the design adds beyond that, an up conv's
    blurred y written by the forward for the backward."""
    b, c, h, w, up = case
    n, t, noise = b * c * h * w, b * c * (h + up) * (w + up), b * h * w
    return 4 * (t + n + noise), 4 * (2 * n + t + 2 * noise), 4 * n * up


def _tail_bytes(case: tuple, size: int) -> tuple:
    """(forward, backward) bytes a tail must move, each value read or
    written once, activations `size` bytes a value: x in, out out where it
    is written; dout (and x with the norm) in, dx out where it is written;
    the per-plane vectors and the statistics."""
    b, c, h, w, norm, merge, tap, _ = case
    n, planes = b * c * h * w, b * c
    fwd = n * size * (2 if norm or merge else 1) + planes * (
        4 * (2 if norm else 1) + (size if merge else 0))
    bwd = 0
    if norm or tap or merge:
        bwd = n * size * (1 + norm + (norm or tap)) + planes * (
            4 * (2 * norm + tap) + (size if merge else 0) + 8 * norm)
    return fwd, bwd


def launch_bounds_ms(kind: str, dtype, train_step, model,
                     rates: dict) -> dict:
    """Each launch counter's bound a launch, in ms, at the paths' shapes
    (the tails': of one forward or backward, spread over its launches;
    sr_adam's: of the optimizer step on the last step's gradients, each
    tensor read or written once, spread over its tables)."""
    size = torch.tensor([], dtype=dtype).element_size()
    out = {}
    for key in ("mixed_fwdgrad", "mixed_fwd", "render_fwdgrad",
                "render_fwd", "render_fwdgrad_both"):
        for suffix, plane in (("", 4), ("_bf16", 2)):
            out[key + suffix] = loss_bound_s(key, BATCH, SIZE, SIZE, SCENES,
                                             rates, plane) * 1e3
    for key, spp in (("pathtrace_shade", SPP[0]),
                     ("pathtrace_shade_vjp", SPP[1])):
        for suffix, field in (("", 4), ("_bf16", 2)):
            out[key + suffix] = pathtrace_bound_s(
                key, BATCH, SCENES, SIZE, SIZE, spp, rates, field) * 1e3
    cases = bench_setup.tail_cases(kind, BATCH, SIZE)
    fwd, bwd = map(sum, zip(*(_tail_bytes(c, size) for c in cases)))
    out["norm_merge_fwd"] = fwd / len(cases) / rates["bytes"] * 1e3
    out["norm_merge_bwd"] = bwd / len(cases) / rates["bytes"] * 1e3
    state = train_step.optimizer.state
    step_bytes = sum(p.numel() * (p.grad.element_size() + 2 * (
        p.element_size() + state[p]["exp_avg"].element_size()
        + state[p]["exp_avg_sq"].element_size()))
        for p in model.parameters() if p.grad is not None)
    out["sr_adam"] = (step_bytes / rates["bytes"] * 1e3
                      / max(1, bench_setup.sr_adam_launches(model)))
    return out


def _device_ms(prof) -> dict:
    """Device ms of each device function in DEVICE_NAMES in a profile."""
    out = {}
    for name in set(DEVICE_NAMES.values()):
        pattern = re.compile(rf"\b{name}\b")
        out[name] = sum(e.self_device_time_total for e in prof.key_averages()
                        if pattern.search(e.key)) / 1e3
    return out


def _part(fn) -> tuple:
    """fn() with every launch counter zeroed just before and read just
    after, under torch.profiler: (result, launches, device ms by
    function)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    bench_setup.zero_launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        result = fn()
        torch.cuda.synchronize()
    return result, bench_setup.launch_counts(), _device_ms(prof)


def _expect(counts: dict, expected: dict, what: str) -> None:
    want = {k: expected.get(k, 0) for k in counts}
    if set(expected) - set(counts) or counts != want:
        raise RuntimeError(f"{what}: launches {counts}, expected {want}")


def _record(counts: dict, device_ms: dict, bounds: dict) -> dict:
    """Launches, device ms and bound ms of each device function a part
    launched."""
    out = {}
    for key, n in counts.items():
        if not n:
            continue
        name = DEVICE_NAMES[key.removesuffix("_bf16")]
        r = out.setdefault(name, {"launches": 0, "bound_ms": 0.0,
                                  "ms": device_ms[name] or None})
        r["launches"] += n
        r["bound_ms"] += n * bounds[key]
    for r in out.values():
        r["bound_pct"] = (100.0 * r["bound_ms"] / r["ms"] if r["ms"]
                          else None)
    return out


def phase_path(path: str, rates: dict) -> dict:
    from svbrdf_tpu_torch.device import precision_scope
    from svbrdf_tpu_torch.parallel.step import prepare

    kinds, dtype, master, renderer, (per_train, per_eval) = \
        bench_setup.PATHS[path]
    start = time.perf_counter()
    with precision_scope(dtype):
        program = bench_setup.build_program(
            *kinds, BATCH, SIZE, DEPTH, FILTERS, seed=0, device="cuda",
            dtype=dtype, master_dtype=master, renderer=renderer, spp=SPP)
        losses, train, train_ms = _part(lambda: [
            float(program.train_step(program.raw)) for _ in range(STEPS)])
        sr = ({"sr_adam": STEPS * bench_setup.sr_adam_launches(program.model)}
              if master == "bf16sr" else {})
        _expect(train, {**{k: STEPS * v for k, v in per_train.items()}, **sr,
                        **bench_setup.tail_launches(kinds[0], STEPS)},
                f"{path} train steps")
        images = prepare(program.raw, program.prep,
                         program.generator)["inputs"]
        (eval_loss, maps), evaluate, eval_ms = _part(lambda: (
            float(program.eval_step(program.raw)), program.predict(images)))
        _expect(evaluate, {**per_eval,
                           **bench_setup.tail_launches(kinds[0], 0, 2)},
                f"{path} eval step and predict")
    if not all(math.isfinite(x) for x in losses + [eval_loss]):
        raise RuntimeError(f"{path}: losses {losses}, eval {eval_loss}")
    if maps.shape != (BATCH, SIZE, SIZE, 12) or not bool(
            torch.isfinite(maps).all()):
        raise RuntimeError(f"{path}: maps {tuple(maps.shape)} not finite")
    bounds = launch_bounds_ms(kinds[0], dtype, program.train_step,
                              program.model, rates)
    out = {"train": _record(train, train_ms, bounds),
           "eval_predict": _record(evaluate, eval_ms, bounds)}
    log(f"path {path}: losses {', '.join(f'{x:.5f}' for x in losses)}, "
        f"eval {eval_loss:.5f}; launches as expected; "
        f"{time.perf_counter() - start:.1f} s")
    for part, record in out.items():
        for name, r in record.items():
            ms = "not measured" if r["ms"] is None else f"{r['ms']:.4f} ms"
            pct = "" if r["bound_pct"] is None else f", {r['bound_pct']:.1f} %"
            log(f"  {part} {name}: {r['launches']} launches, {ms}, bound "
                f"{r['bound_ms']:.4f} ms{pct}")
    del program
    torch.cuda.empty_cache()
    return out


def phase_capture(rates: dict) -> dict:
    """MaterialGAN's capture at the benchmark cell's shapes, the generator
    seeded: its launches and the styled_tail kernels' device ms against
    their bound."""
    from svbrdf_tpu_torch.experiments import CaptureStep
    from svbrdf_tpu_torch.models import build_model

    start = time.perf_counter()
    model = build_model("materialgan", device="cuda", seed=0)
    gen = torch.Generator(device="cuda").manual_seed(1)
    scenes = pipeline.generate_input_scenes(BATCH, PHOTOS, True,
                                            generator=gen, device="cuda")
    photos = torch.rand(BATCH, PHOTOS, SIZE, SIZE, 3, generator=gen,
                        device="cuda")
    step = CaptureStep(model, photos, scenes, generator=gen)
    for _ in range(2):
        step()
    losses, counts, device_ms = _part(lambda: [
        float(step()) for _ in range(CAPTURE_ITERATIONS)])
    convs = CAPTURE_ITERATIONS * len(model.convs)
    _expect(counts, {"styled_tail_fwd": convs, "styled_tail_bwd": convs},
            "capture iterations")
    if not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"capture: losses {losses}")
    cases = bench_setup.styled_tail_cases(BATCH)
    fwd, bwd, saved = map(sum, zip(*map(_styled_tail_bytes, cases)))
    bounds = {"styled_tail_fwd": fwd / len(cases) / rates["bytes"] * 1e3,
              "styled_tail_bwd": bwd / len(cases) / rates["bytes"] * 1e3}
    out = {"iterations": _record(counts, device_ms, bounds),
           "saved_y_ms": CAPTURE_ITERATIONS * saved / rates["bytes"] * 1e3}
    log(f"capture: losses {', '.join(f'{x:.5f}' for x in losses)}; "
        f"launches as expected; {time.perf_counter() - start:.1f} s")
    log(f"  the up convs' saved y, outside the forward's bound: "
        f"{saved / 1e9:.3f} GB an iteration, {out['saved_y_ms']:.4f} ms "
        f"at the memory rate over the {CAPTURE_ITERATIONS} iterations")
    for name, r in out["iterations"].items():
        ms = "not measured" if r["ms"] is None else f"{r['ms']:.4f} ms"
        pct = "" if r["bound_pct"] is None else f", {r['bound_pct']:.1f} %"
        log(f"  iterations {name}: {r['launches']} launches, {ms}, bound "
            f"{r['bound_ms']:.4f} ms{pct}")
    return out


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py: torch.cuda.is_available() is False; it "
                 "needs an NVIDIA GPU")
    t0 = time.perf_counter()
    card = phase_device()
    rates = card_rates(card)
    for hold in (hold_loss_kernels, hold_tails, hold_sr_adam,
                 hold_pathtrace, hold_styled_tails):
        start = time.perf_counter()
        hold()
        log(f"{hold.__name__}: {time.perf_counter() - start:.1f} s")
    kernels = {path: phase_path(path, rates) for path in bench_setup.PATHS}
    kernels["materialgan_capture"] = phase_capture(rates)
    print(json.dumps({"card": card, "kernels": kernels}), flush=True)
    log(f"chip_smoke ok in {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
