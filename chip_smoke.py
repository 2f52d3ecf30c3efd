"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each raising (and so exiting non-zero) on any failure:
  1. device: the card's name and power limit, torch and CUDA versions; TF32
     off for convolutions and matrix products;
  2. build: every CUDA kernel of the path compiled from csrc/ with nvcc;
  3. kernels: each kernel held against its plain torch version at the main
     path's shapes (B=8, 12 x 256 x 256 f32 planes, S=9 scenes), and
     checked to give a loss and gradient of exactly 0 for pred equal to gt;
  4. agreement: a small model's train step, eval loss and prediction on the
     card against the same program on the CPU;
  5. main path: SingleViewModel at full width (depth 8, 64 filters, 256^2,
     batch 8, f32, seeded weights): 5 train steps, 1 eval step, predict,
     with each kernel's launch counter set to 0 before and read after;
  6. times: CUDA-event medians of each kernel launched alone, its wrapper,
     its plain version and the main path's steps, and each kernel's bound.
The next-to-last line is the JSON `kernels` record; the last line is
{"ok": true, "device": {...}}. Without a CUDA device it exits non-zero and
prints no result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import torch

# The least operations per pixel that the mixed-loss function needs, from
# the math of svbrdf_tpu_torch/csrc/mixed_loss.cu. Each value is counted
# once: terms that do not depend on the colour channel once per side, terms
# that do not depend on the side once per scene. Each quotient is a multiply
# by a reciprocal, taken once per quantity (1/VN, 1/LN, 1/NH^2, 1/d^2,
# 1/denom, 1/(1 + sqrt(.)), 1/(r_p + 0.1), 1/(x + 0.01)), its powers being
# products; a square root and its reciprocal come from one rsqrt and a
# multiply. log, sqrt, rsqrt and reciprocal count as one special-function
# operation (SFU) each; add, sub, mul, max and compare-select as one FP32
# operation; abs and negation are free operand modifiers.
#   per scene, both kernels: geometry (v, l, h, (1 - VH)^5, 1/d^2) 44 FP /
#     4 SFU; two sides (dots, clamps, scale, the three tan^2 terms,
#     1/(4 VN LN)) 68 / 6; six channel shades (D, two G1, F, radiance)
#     186 / 30; three log-differences 12 / 6 -> 310 FP, 46 SFU;
#   per scene, fwdgrad adds the pred side's VJP: 3 channels x 72 FP / 1 SFU
#     and 32 FP for the normal's chain -> 558 FP, 49 SFU in all;
#   per pixel once: coordinates, the L1 value, the scaling and the block sum
#     46 FP / 12 SFU; with the L1 gradient and dpred's scaling 112 / 18.
# The FP32 peak counts a fused multiply-add as two operations, so the FP32
# time assumes every add pairs with a multiply. The kernels are built with
# -fmad=false and issue each add and multiply alone, at half that rate:
# `fp32_nofma_us` in the bound's parts is the built kernels' own FP32 floor.
FP32_PER_SCENE = {"mixed_fwdgrad": 558, "mixed_fwd": 310}
SFU_PER_SCENE = {"mixed_fwdgrad": 49, "mixed_fwd": 46}
FP32_PER_PIXEL = {"mixed_fwdgrad": 112, "mixed_fwd": 46}
SFU_PER_PIXEL = {"mixed_fwdgrad": 18, "mixed_fwd": 12}

# The torch build on which the kernels and their plain versions were seen to
# agree to the last bit on an H100 (see phase_kernels).
BIT_EXACT_TORCH = "2.11.0+cu128"

# Peak rates at full power: memory bytes/s, FP32 (non-tensor) FLOP/s, and
# special-function results/s (16 per clock per SM on compute capability 9.0,
# CUDA C++ Programming Guide throughput table, at the boost clock that
# gives the FP32 figure). NVIDIA data sheets. First match wins.
CARDS = (
    ("H100 PCIe", {"bytes": 2.0e12, "fp32": 51.2e12,
                   "sfu": 114 * 16 * 1.755e9}),
    ("H200", {"bytes": 4.8e12, "fp32": 66.9e12, "sfu": 132 * 16 * 1.98e9}),
    ("H100", {"bytes": 3.35e12, "fp32": 66.9e12, "sfu": 132 * 16 * 1.98e9}),
)

KERNELS = {
    "mixed_fwdgrad": {
        "route": "cuda", "source": "svbrdf_tpu_torch/csrc/mixed_loss.cu",
        "replaces": "svbrdf_tpu/ops/render_pallas.py:470",
        "tpu_kernel": "_mixed_fwdgrad_kernel"},
    "mixed_fwd": {
        "route": "cuda", "source": "svbrdf_tpu_torch/csrc/mixed_loss.cu",
        "replaces": "svbrdf_tpu/ops/render_pallas.py:440",
        "tpu_kernel": "_mixed_fwd_kernel"},
}

MAIN = {"batch": 8, "size": 256, "depth": 8, "num_filters": 64,
        "n_scenes": 9, "train_steps": 5}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_rates(name: str) -> dict:
    for key, rates in CARDS:
        if key in name:
            return rates
    raise RuntimeError(f"no peak rates recorded for {name!r}")


def cuda_ms(fn, runs: int = 20, warmup: int = 3) -> float:
    """Median of `runs` CUDA-event timings of fn() after `warmup` calls."""
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


def kernel_ms(with_grad: bool, inputs, reps: int = 10, runs: int = 20) -> float:
    """Device time of one raw kernel launch: the median over `runs` of
    `reps` back-to-back launches between two CUDA events, divided by reps.
    A launch queued before the start event keeps the card busy while the
    host queues the rest, so the events time the kernels alone (no wrapper
    sum of the partials, no host gaps)."""
    from svbrdf_tpu_torch.ops import render_fused as rf

    def launch():
        rf._launch(with_grad, *inputs, 0, 0, 0.1)

    for _ in range(3):
        launch()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        launch()
        start.record()
        for _ in range(reps):
            launch()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / reps)
    return statistics.median(times)


def bound(kernel: str, batch: int, height: int, width: int, n_scenes: int,
          rates: dict) -> tuple:
    """(bound_ms, bound_by, parts in us) for one call: the larger of the
    bytes it must move over the memory rate and its operations over the
    peak rates."""
    pixels = batch * height * width
    floats = 12 * 3 if kernel == "mixed_fwdgrad" else 12 * 2  # in + out
    bytes_moved = pixels * floats * 4 + batch * n_scenes * 9 * 4
    fp32 = pixels * (n_scenes * FP32_PER_SCENE[kernel]
                     + FP32_PER_PIXEL[kernel])
    sfu = pixels * (n_scenes * SFU_PER_SCENE[kernel] + SFU_PER_PIXEL[kernel])
    t_bytes = bytes_moved / rates["bytes"]
    t_ops = max(fp32 / rates["fp32"], sfu / rates["sfu"])
    parts = {"bytes_us": t_bytes * 1e6, "fp32_us": fp32 / rates["fp32"] * 1e6,
             "fp32_nofma_us": 2 * fp32 / rates["fp32"] * 1e6,
             "sfu_us": sfu / rates["sfu"] * 1e6}
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes", parts
    return t_ops * 1e3, "operations", parts


def phase_device() -> None:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log("TF32 off: torch.backends.cudnn.allow_tf32 = False, "
        "torch.backends.cuda.matmul.allow_tf32 = False")


def phase_build() -> None:
    from svbrdf_tpu_torch.ops import _build

    start = time.perf_counter()
    report = _build.build()
    for name, r in report.items():
        log(f"built {name}.cu in {r['seconds']:.1f} s")
        for line in r["log"].splitlines():
            if any(w in line for w in ("entry function", "registers",
                                       "spill")):
                log(f"  ptxas: {line.strip()}")
    log(f"build phase {time.perf_counter() - start:.1f} s")


def loss_inputs(batch: int, size: int, n_scenes: int, seed: int = 0):
    """Planes and scenes at the main path's shapes: gt and pred decoded
    from two synthetic raw batches (pred plays an untrained model's
    output), scenes from the loss sampler."""
    from svbrdf_tpu_torch.data import pipeline
    from svbrdf_tpu_torch.losses import to_planes
    from svbrdf_tpu_torch.ops import render_fused, sampling
    from svbrdf_tpu_torch.utils.bench_setup import synthetic_raw_batch

    dev = torch.device("cuda")

    def planes(s):
        raw = synthetic_raw_batch(batch, size, 0, s)["svbrdf"]
        return to_planes(pipeline._decode_u8_svbrdf(
            torch.from_numpy(raw).to(dev)))

    g = torch.Generator(device=dev).manual_seed(seed)
    scenes = sampling.generate_loss_scenes(batch, 3, n_scenes - 3,
                                           generator=g, device=dev)
    return planes(seed + 1), planes(seed), render_fused.pack_scenes(scenes)


def phase_kernels(inputs) -> dict:
    from svbrdf_tpu_torch.ops import render_fused as rf

    pred_t, gt_t, scenes9 = inputs
    loss_k, dp_k = rf.mixed_loss_fwdgrad_cuda(pred_t, gt_t, scenes9)
    loss_v = rf.mixed_loss_fwd_cuda(pred_t, gt_t, scenes9)
    torch.cuda.synchronize()
    loss_p, dp_p = rf.mixed_loss_fwdgrad_plain(pred_t, gt_t, scenes9)
    loss_vp = rf.mixed_loss_fwd_plain(pred_t, gt_t, scenes9)
    torch.cuda.synchronize()

    lk, lp, lv, lvp = (float(loss_k), float(loss_p), float(loss_v),
                       float(loss_vp))
    rel, rel_v = abs(lk - lp) / abs(lp), abs(lv - lvp) / abs(lvp)
    dp_err = float((dp_k - dp_p).abs().max())
    dp_scale = float(dp_p.abs().max())
    log(f"fwdgrad: loss kernel {lk:.9g} plain {lp:.9g} rel {rel:.3g}; "
        f"max |dpred| {dp_scale:.3g}; dpred max abs err {dp_err:.3g} "
        f"(ratio {dp_err / dp_scale:.3g})")
    log(f"fwd: loss kernel {lv:.9g} plain {lvp:.9g} rel {rel_v:.3g}")
    if not torch.isfinite(dp_k).all():
        raise RuntimeError("fwdgrad kernel produced non-finite dpred")
    if rel > 1e-5:
        raise RuntimeError(f"fwdgrad loss disagrees with its plain version: "
                           f"rel {rel:.3g} > 1e-5")
    # The kernel rounds every op as the plain version does on the card (no
    # FMA contraction; x / c as x * (1/c), as torch takes a tensor divided
    # by a Python number), and with torch BIT_EXACT_TORCH on an H100 the
    # two agree to the last bit. A kernel that rounds one op otherwise is
    # ~1e-4 * max|dpred| away (9.8e-5 measured with IEEE divisions by pi):
    # a normal's gradient scales one ulp by up to 1/denom^3 ~ 1e9, and a
    # log-difference within rounding of 0 flips |x|'s sign. So another torch
    # that rounds these ops otherwise fails this check with no fault in the
    # kernel; the message says so.
    if dp_err > 1e-6 * dp_scale:
        raise RuntimeError(
            f"fwdgrad dpred disagrees with its plain version: {dp_err:.3g} > "
            f"1e-6 * {dp_scale:.3g}; the two agreed to the last bit with "
            f"torch {BIT_EXACT_TORCH}, this is torch {torch.__version__}")
    if rel_v > 1e-5:
        raise RuntimeError(f"fwd loss disagrees with its plain version: "
                           f"rel {rel_v:.3g} > 1e-5")
    # pred equal to gt: both sides must round alike, to a loss and a
    # gradient of exactly 0, as the plain versions and the TPU kernels give.
    same = gt_t.clone()
    loss_0, dp_0 = rf.mixed_loss_fwdgrad_cuda(same, gt_t, scenes9)
    value_0 = rf.mixed_loss_fwd_cuda(same, gt_t, scenes9)
    nonzero = int(torch.count_nonzero(dp_0))
    log(f"pred == gt: fwdgrad loss {float(loss_0)!r}, {nonzero} non-zero "
        f"dpred values; fwd loss {float(value_0)!r}")
    if float(loss_0) != 0.0 or nonzero or float(value_0) != 0.0:
        raise RuntimeError("the kernels do not give 0 for pred equal to gt")
    return {"mixed_fwdgrad": {"max_abs_err": dp_err, "loss_rel_err": rel},
            "mixed_fwd": {"max_abs_err": abs(lv - lvp),
                          "loss_rel_err": rel_v}}


def phase_agreement() -> None:
    """One train step, the eval loss and a prediction of a small model on
    the card against the same program, weights, batch and scenes on the
    CPU (dropout off on both), where the loss runs the plain versions."""
    from svbrdf_tpu_torch import losses
    from svbrdf_tpu_torch.models import SingleViewModel
    from svbrdf_tpu_torch.ops import sampling
    from svbrdf_tpu_torch.parallel import step as step_lib
    from svbrdf_tpu_torch.utils.bench_setup import synthetic_raw_batch

    g = torch.Generator().manual_seed(3)
    prep = step_lib.PrepConfig(mix_materials=True)
    raw = {k: torch.from_numpy(v)
           for k, v in synthetic_raw_batch(2, 32, 0, seed=3).items()}
    batch = step_lib.prepare(raw, prep, g)
    scenes = sampling.generate_loss_scenes(2, generator=g)
    loss_fn = losses.make_loss_fn("mixed")
    results = {}
    for dev in ("cpu", "cuda"):
        model = SingleViewModel(8, 5, device="cpu", seed=3).to(dev)
        for m in model.modules():
            if isinstance(m, torch.nn.Dropout):
                m.eval()
        step = step_lib.make_train_step(
            model, step_lib.make_optimizer(model.parameters()), loss_fn,
            prep, None)
        b = {k: v.to(dev) for k, v in batch.items()}
        sc = scenes.to(dev)
        loss = float(step.update(b, scenes=sc))
        grads = torch.cat([p.grad.flatten() for p in model.parameters()
                           if p.grad is not None]).cpu()
        # The eval step's loss: dropout off, no autograd (value-only kernel).
        with torch.no_grad():
            pred = step_lib.make_predict_fn(model)(b["inputs"])
            eval_loss = float(loss_fn(pred, b["svbrdf"], scenes=sc))
        results[dev] = (loss, grads, eval_loss, pred.cpu())
    (lc, gc, ec, pc), (lg, gg, eg, pg) = results["cpu"], results["cuda"]
    grad_rel = float((gg - gc).norm() / gc.norm())
    pred_err = float((pg - pc).abs().max())
    log(f"agreement (depth 5, 32^2, 8 filters, batch 2): loss card {lg:.9g} "
        f"cpu {lc:.9g}; grad rel {grad_rel:.3g}; eval loss card {eg:.9g} "
        f"cpu {ec:.9g}; predict max abs err {pred_err:.3g}")
    if abs(lg - lc) > 1e-4 * abs(lc) or abs(eg - ec) > 1e-4 * abs(ec):
        raise RuntimeError("card and CPU losses disagree beyond rel 1e-4")
    if grad_rel > 1e-3 or pred_err > 1e-4:
        raise RuntimeError("card and CPU gradients or predictions disagree")


def phase_main_path(program) -> dict:
    """The main path with every launch counter set to 0 just before and
    read just after: 5 train steps, 1 eval step, predict."""
    from svbrdf_tpu_torch.ops import render_fused as rf
    from svbrdf_tpu_torch.parallel.step import prepare

    torch.cuda.synchronize()
    rf.mixed_loss_fwdgrad_cuda.launches = 0
    rf.mixed_loss_fwd_cuda.launches = 0
    train_losses = [float(program.train_step(program.raw))
                    for _ in range(MAIN["train_steps"])]
    after_train = (rf.mixed_loss_fwdgrad_cuda.launches,
                   rf.mixed_loss_fwd_cuda.launches)
    eval_loss = float(program.eval_step(program.raw))
    images = prepare(program.raw, program.prep, program.generator)["inputs"]
    svbrdf = program.predict(images)
    torch.cuda.synchronize()
    counts = {"mixed_fwdgrad": rf.mixed_loss_fwdgrad_cuda.launches,
              "mixed_fwd": rf.mixed_loss_fwd_cuda.launches}
    log(f"main path: train losses {train_losses}; eval loss {eval_loss!r}; "
        f"launches after train {after_train}, after eval+predict {counts}")

    if not all(torch.isfinite(torch.tensor(train_losses + [eval_loss]))):
        raise RuntimeError("non-finite loss on the main path")
    steps = MAIN["train_steps"]
    if after_train != (steps, 0) or counts != {"mixed_fwdgrad": steps,
                                               "mixed_fwd": 1}:
        raise RuntimeError(f"launch counts {after_train} / {counts} do not "
                           f"show {steps} fwdgrad and 1 fwd launch")
    size = MAIN["size"]
    if tuple(svbrdf.shape) != (MAIN["batch"], size, size, 12):
        raise RuntimeError(f"predict gave shape {tuple(svbrdf.shape)}")
    if not torch.isfinite(svbrdf).all():
        raise RuntimeError("predict gave non-finite maps")
    norm_err = float((svbrdf[..., :3].norm(dim=-1) - 1.0).abs().max())
    maps = svbrdf[..., 3:]
    if norm_err > 1e-4 or float(maps.min()) < 0.0 or float(maps.max()) > 1.0:
        raise RuntimeError(f"predicted maps out of range: normal norm err "
                           f"{norm_err:.3g}, maps in [{float(maps.min())}, "
                           f"{float(maps.max())}]")
    log(f"predict: {tuple(svbrdf.shape)}, unit normals (max err "
        f"{norm_err:.3g}), maps in [0, 1]")
    return counts


def phase_times(program, inputs, rates: dict) -> dict:
    from svbrdf_tpu_torch.ops import render_fused as rf
    from svbrdf_tpu_torch.parallel.step import prepare

    batch, _, height, width = inputs[0].shape
    n_scenes = inputs[2].shape[1]
    out = {}
    for name, with_grad, wrapper, plain in (
            ("mixed_fwdgrad", True, rf.mixed_loss_fwdgrad_cuda,
             rf.mixed_loss_fwdgrad_plain),
            ("mixed_fwd", False, rf.mixed_loss_fwd_cuda,
             rf.mixed_loss_fwd_plain)):
        ms = kernel_ms(with_grad, inputs)
        wrapper_ms = cuda_ms(lambda: wrapper(*inputs))
        plain_ms = cuda_ms(lambda: plain(*inputs))
        bound_ms, bound_by, parts = bound(name, batch, height, width,
                                          n_scenes, rates)
        out[name] = {"ms": ms, "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "bound_parts_us": parts}
        log(f"{name}: kernel {ms:.4f} ms (wrapper {wrapper_ms:.4f} ms), "
            f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}; "
            + ", ".join(f"{k} {v:.2f}" for k, v in parts.items()) + ")")
    images = prepare(program.raw, program.prep, program.generator)["inputs"]
    steps = {"train_step": lambda: program.train_step(program.raw),
             "eval_step": lambda: program.eval_step(program.raw),
             "predict": lambda: program.predict(images)}
    out["steps"] = {k: cuda_ms(fn, runs=20, warmup=2)
                    for k, fn in steps.items()}
    log(f"main path ms (median of 20, CUDA events): {out['steps']}")
    return out


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py: torch.cuda.is_available() is False; it "
                 "needs an NVIDIA GPU")
    t0 = time.perf_counter()
    phase_device()
    name = torch.cuda.get_device_name(0)
    rates = card_rates(name)
    phase_build()
    inputs = loss_inputs(MAIN["batch"], MAIN["size"], MAIN["n_scenes"])
    errors = phase_kernels(inputs)
    phase_agreement()

    from svbrdf_tpu_torch.utils.bench_setup import build_main_program

    program = build_main_program(MAIN["batch"], MAIN["size"], MAIN["depth"],
                                 MAIN["num_filters"], seed=0, device="cuda")
    counts = phase_main_path(program)
    times = phase_times(program, inputs, rates)
    calls = {"mixed_fwdgrad": MAIN["train_steps"], "mixed_fwd": 1}
    kernels = [dict(name=k, **KERNELS[k], launches=counts[k],
                    launches_per_step=counts[k] / calls[k],
                    max_abs_err=errors[k]["max_abs_err"],
                    **{e: v for e, v in errors[k].items()
                       if e != "max_abs_err"},
                    ms=times[k]["ms"], wrapper_ms=times[k]["wrapper_ms"],
                    plain_ms=times[k]["plain_ms"],
                    bound_ms=times[k]["bound_ms"],
                    bound_us=times[k]["bound_ms"] * 1e3,
                    bound_by=times[k]["bound_by"],
                    bound_parts_us=times[k]["bound_parts_us"],
                    library_ms=None)
               for k in KERNELS]
    log(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels, "steps_ms": times["steps"]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
