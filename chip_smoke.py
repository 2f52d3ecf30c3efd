"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each raising (and so exiting non-zero) on any failure:
  1. device: the card's name and power limit, torch and CUDA versions; TF32
     off for convolutions and matrix products;
  2. build: every CUDA kernel compiled from csrc/ with nvcc, one process per
     source, all started together;
  3. kernels: each of the five loss kernels held against its plain torch
     version at the paths' shapes (B=8, 12 x 256 x 256 f32 planes, S=9
     scenes), and checked to give a loss and gradients of exactly 0 for pred
     equal to gt;
  4. agreement: a small single-view mixed-loss model and a small multi-view
     rendering-loss model: train step, eval loss and prediction on the card
     against the same program on the CPU;
  5. paths, each with every kernel's launch counter set to 0 just before
     and read just after, at full width (depth 8, 64 filters, 256^2, batch
     8, f32, seeded weights):
       - single-view model, mixed loss: 5 train steps, 1 eval step, predict;
       - multi-view model (3 synthesized views), rendering-only loss: 5
         train steps, 1 eval step, predict;
       - the rendering loss with the target's gradient under autograd;
  6. times: CUDA-event medians of each kernel launched alone, its wrapper,
     its plain version and each path's steps, each kernel's bound, and the
     blocks of each kernel that fit one SM (the occupancy query of the
     library, beside the ptxas register and spill lines of phase 2).
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
# The rendering-only kernels (csrc/rendering_loss.cu) do the same per-scene
# work without the L1 term: fwd 310 / 46 and fwdgrad 558 / 49 per scene;
# fwdgrad_both adds the gt side's VJP, counted as the pred side's (3 x 72 /
# 1 and 32 for the normal): 806 / 52. Per pixel once: coordinates and the
# block sum 7 FP, and one multiply by 1/count per gradient value written
# (12 for fwdgrad, 24 for both); the division of the partials' sum by count
# is one operation per call.
# The FP32 peak counts a fused multiply-add as two operations, so the FP32
# time assumes every add pairs with a multiply. The kernels are built with
# -fmad=false and issue each add and multiply alone, at half that rate:
# `fp32_nofma_us` in the bound's parts is the built kernels' own FP32 floor.
FP32_PER_SCENE = {"mixed_fwdgrad": 558, "mixed_fwd": 310,
                  "render_fwdgrad": 558, "render_fwd": 310,
                  "render_fwdgrad_both": 806}
SFU_PER_SCENE = {"mixed_fwdgrad": 49, "mixed_fwd": 46, "render_fwdgrad": 49,
                 "render_fwd": 46, "render_fwdgrad_both": 52}
FP32_PER_PIXEL = {"mixed_fwdgrad": 112, "mixed_fwd": 46, "render_fwdgrad": 19,
                  "render_fwd": 7, "render_fwdgrad_both": 31}
SFU_PER_PIXEL = {"mixed_fwdgrad": 18, "mixed_fwd": 12, "render_fwdgrad": 0,
                 "render_fwd": 0, "render_fwdgrad_both": 0}
# Floats each kernel must move per pixel: pred and gt in, gradients out.
FLOATS_PER_PIXEL = {"mixed_fwdgrad": 36, "mixed_fwd": 24,
                    "render_fwdgrad": 36, "render_fwd": 24,
                    "render_fwdgrad_both": 48}

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

_MIXED = "svbrdf_tpu_torch/csrc/mixed_loss.cu"
_RENDERING = "svbrdf_tpu_torch/csrc/rendering_loss.cu"
KERNELS = {
    "mixed_fwdgrad": {
        "route": "cuda", "source": _MIXED,
        "replaces": "svbrdf_tpu/ops/render_pallas.py:470",
        "tpu_kernel": "_mixed_fwdgrad_kernel"},
    "mixed_fwd": {
        "route": "cuda", "source": _MIXED,
        "replaces": "svbrdf_tpu/ops/render_pallas.py:440",
        "tpu_kernel": "_mixed_fwd_kernel"},
    "render_fwdgrad": {
        "route": "cuda", "source": _RENDERING,
        "replaces": "svbrdf_tpu/ops/render_pallas.py:392",
        "tpu_kernel": "_fwdgrad_kernel"},
    "render_fwd": {
        "route": "cuda", "source": _RENDERING,
        "replaces": "svbrdf_tpu/ops/render_pallas.py:370",
        "tpu_kernel": "_fwd_kernel"},
    "render_fwdgrad_both": {
        "route": "cuda", "source": _RENDERING,
        "replaces": "svbrdf_tpu/ops/render_pallas.py:508",
        "tpu_kernel": "_fwdgrad_kernel_both"},
}

MAIN = {"batch": 8, "size": 256, "depth": 8, "num_filters": 64,
        "n_scenes": 9, "train_steps": 5}
# The paths driven at full width: (model kind, loss kind) and the launches
# each must show, by kernel (every other kernel: 0).
STEPS = MAIN["train_steps"]
PATHS = {
    "single_mixed": (("single", "mixed"),
                     {"mixed_fwdgrad": STEPS, "mixed_fwd": 1}),
    "multi_rendering": (("multi", "rendering"),
                        {"render_fwdgrad": STEPS, "render_fwd": 1}),
}
TARGET_GRAD_PATH = "rendering_target_grad"
# The path whose run each kernel's `launches` comes from, and its calls
# (train steps, eval steps or target-gradient calls) in that run.
KERNEL_PATH = {"mixed_fwdgrad": ("single_mixed", STEPS),
               "mixed_fwd": ("single_mixed", 1),
               "render_fwdgrad": ("multi_rendering", STEPS),
               "render_fwd": ("multi_rendering", 1),
               "render_fwdgrad_both": (TARGET_GRAD_PATH, 1)}


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


def bound(kernel: str, batch: int, height: int, width: int, n_scenes: int,
          rates: dict) -> tuple:
    """(bound_ms, bound_by, parts in us) for one call: the larger of the
    bytes it must move over the memory rate and its operations over the
    peak rates."""
    pixels = batch * height * width
    bytes_moved = (pixels * FLOATS_PER_PIXEL[kernel] * 4
                   + batch * n_scenes * 9 * 4)
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


def _outputs(out) -> tuple:
    """(loss, gradients...) of a kernel's wrapper or plain version."""
    return out if isinstance(out, tuple) else (out,)


def phase_kernels(inputs) -> dict:
    """Each kernel against its plain version on the same inputs: loss rel
    <= 1e-5, every gradient's max abs error <= 1e-6 * its max |value|, and
    exactly 0 for pred equal to gt."""
    from svbrdf_tpu_torch.ops import render_fused as rf

    pred_t, gt_t, scenes9 = inputs
    errors = {}
    for name, plain in rf.PLAIN_VERSIONS.items():
        out = _outputs(rf.CUDA_WRAPPERS[name](*inputs))
        torch.cuda.synchronize()
        ref = _outputs(plain(*inputs))
        torch.cuda.synchronize()
        loss, ref_loss = float(out[0]), float(ref[0])
        rel = abs(loss - ref_loss) / abs(ref_loss)
        grad_errs, parts = [], []
        for i, (g, g_ref) in enumerate(zip(out[1:], ref[1:])):
            if not torch.isfinite(g).all():
                raise RuntimeError(f"{name} produced non-finite gradient {i}")
            err = float((g - g_ref).abs().max())
            scale = float(g_ref.abs().max())
            grad_errs.append(err)
            parts.append(f"grad {i}: max |ref| {scale:.3g}, max abs err "
                         f"{err:.3g} (ratio {err / scale:.3g})")
            # The kernels round every op as the plain versions do on the
            # card (no FMA contraction; x / c as x * (1/c), as torch takes
            # a tensor divided by a Python number), and with torch
            # BIT_EXACT_TORCH on an H100 the two agree to the last bit. A
            # kernel that rounds one op otherwise is ~1e-4 * max|grad| away
            # (9.8e-5 measured with IEEE divisions by pi): a normal's
            # gradient scales one ulp by up to 1/denom^3 ~ 1e9, and a
            # log-difference within rounding of 0 flips |x|'s sign. So
            # another torch that rounds these ops otherwise fails this check
            # with no fault in the kernel; the message says so.
            if err > 1e-6 * scale:
                raise RuntimeError(
                    f"{name} gradient {i} disagrees with its plain version: "
                    f"{err:.3g} > 1e-6 * {scale:.3g}; the two agreed to the "
                    f"last bit with torch {BIT_EXACT_TORCH}, this is torch "
                    f"{torch.__version__}")
        log(f"{name}: loss kernel {loss:.9g} plain {ref_loss:.9g} rel "
            f"{rel:.3g}" + "".join(f"; {p}" for p in parts))
        if rel > 1e-5:
            raise RuntimeError(f"{name} loss disagrees with its plain "
                               f"version: rel {rel:.3g} > 1e-5")
        # pred equal to gt: both sides must round alike, to a loss and
        # gradients of exactly 0, as the plain versions and the TPU kernels
        # give.
        zero = _outputs(rf.CUDA_WRAPPERS[name](gt_t.clone(), gt_t, scenes9))
        nonzero = [int(torch.count_nonzero(g)) for g in zero[1:]]
        log(f"{name} pred == gt: loss {float(zero[0])!r}, non-zero gradient "
            f"values {nonzero}")
        if float(zero[0]) != 0.0 or any(nonzero):
            raise RuntimeError(f"{name} does not give 0 for pred equal to gt")
        errors[name] = {
            "max_abs_err": max(grad_errs) if grad_errs else abs(loss
                                                                - ref_loss),
            "loss_rel_err": rel}
    return errors


def _agreement(model_cls, loss_kind: str, n_views: int) -> None:
    """One train step, the eval loss and a prediction of a small model on
    the card against the same program, weights, batch and scenes on the
    CPU (dropout off on both), where the loss runs the plain versions."""
    from svbrdf_tpu_torch import losses
    from svbrdf_tpu_torch.ops import sampling
    from svbrdf_tpu_torch.parallel import step as step_lib
    from svbrdf_tpu_torch.utils.bench_setup import synthetic_raw_batch

    g = torch.Generator().manual_seed(3)
    prep = step_lib.PrepConfig(used_input_image_count=n_views,
                               mix_materials=True)
    raw = {k: torch.from_numpy(v)
           for k, v in synthetic_raw_batch(2, 32, 0, seed=3).items()}
    batch = step_lib.prepare(raw, prep, g)
    scenes = sampling.generate_loss_scenes(2, generator=g)
    loss_fn = losses.make_loss_fn(loss_kind)
    results = {}
    for dev in ("cpu", "cuda"):
        model = model_cls(8, 5, device="cpu", seed=3).to(dev)
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
    log(f"agreement {model_cls.__name__} + {loss_kind} (depth 5, 32^2, 8 "
        f"filters, batch 2, {n_views} view(s)): loss card {lg:.9g} cpu "
        f"{lc:.9g}; grad rel {grad_rel:.3g}; eval loss card {eg:.9g} cpu "
        f"{ec:.9g}; predict max abs err {pred_err:.3g}")
    if abs(lg - lc) > 1e-4 * abs(lc) or abs(eg - ec) > 1e-4 * abs(ec):
        raise RuntimeError("card and CPU losses disagree beyond rel 1e-4")
    if grad_rel > 1e-3 or pred_err > 1e-4:
        raise RuntimeError("card and CPU gradients or predictions disagree")


def phase_agreement() -> None:
    from svbrdf_tpu_torch.models import MultiViewModel, SingleViewModel

    _agreement(SingleViewModel, "mixed", 1)
    _agreement(MultiViewModel, "rendering", 3)


def _zero_counts() -> None:
    from svbrdf_tpu_torch.ops import render_fused as rf

    for wrapper in rf.CUDA_WRAPPERS.values():
        wrapper.launches = 0


def _counts() -> dict:
    from svbrdf_tpu_torch.ops import render_fused as rf

    return {k: w.launches for k, w in rf.CUDA_WRAPPERS.items()}


def _expect(counts: dict, expected: dict, what: str) -> None:
    want = {k: expected.get(k, 0) for k in counts}
    if counts != want:
        raise RuntimeError(f"{what}: launch counts {counts}, expected {want}")


def phase_path(path: str, program) -> dict:
    """One path with every launch counter set to 0 just before and read
    just after: 5 train steps, 1 eval step, predict."""
    from svbrdf_tpu_torch.parallel.step import prepare

    expected = PATHS[path][1]
    train_only = {k: v for k, v in expected.items() if k.endswith("fwdgrad")}
    torch.cuda.synchronize()
    _zero_counts()
    train_losses = [float(program.train_step(program.raw))
                    for _ in range(STEPS)]
    after_train = _counts()
    eval_loss = float(program.eval_step(program.raw))
    images = prepare(program.raw, program.prep, program.generator)["inputs"]
    svbrdf = program.predict(images)
    torch.cuda.synchronize()
    counts = _counts()
    log(f"{path}: train losses {train_losses}; eval loss {eval_loss!r}; "
        f"launches after train {after_train}, after eval+predict {counts}")

    if not all(torch.isfinite(torch.tensor(train_losses + [eval_loss]))):
        raise RuntimeError(f"{path}: non-finite loss")
    _expect(after_train, train_only, f"{path} after the train steps")
    _expect(counts, expected, f"{path} after eval and predict")
    size = MAIN["size"]
    if tuple(svbrdf.shape) != (MAIN["batch"], size, size, 12):
        raise RuntimeError(f"{path}: predict gave shape "
                           f"{tuple(svbrdf.shape)}")
    if not torch.isfinite(svbrdf).all():
        raise RuntimeError(f"{path}: predict gave non-finite maps")
    norm_err = float((svbrdf[..., :3].norm(dim=-1) - 1.0).abs().max())
    maps = svbrdf[..., 3:]
    if norm_err > 1e-4 or float(maps.min()) < 0.0 or float(maps.max()) > 1.0:
        raise RuntimeError(f"{path}: predicted maps out of range: normal "
                           f"norm err {norm_err:.3g}, maps in "
                           f"[{float(maps.min())}, {float(maps.max())}]")
    log(f"{path} predict: {tuple(svbrdf.shape)}, {tuple(images.shape)} "
        f"input, unit normals (max err {norm_err:.3g}), maps in [0, 1]")
    return counts


def phase_target_grad(inputs) -> dict:
    """rendering_loss_fused_planes with want_target_grad under autograd at
    the paths' shapes, both inputs requiring grad: one launch of the kernel
    with both gradients, and pred.grad / gt.grad equal to upstream * dpred
    / dgt of that kernel."""
    from svbrdf_tpu_torch.ops import render_fused as rf
    from svbrdf_tpu_torch.scene import Scene

    p, g, s9 = inputs
    scenes = Scene(s9[..., 0:3], s9[..., 3:6], s9[..., 6:9])
    pred, gt = p.clone().requires_grad_(), g.clone().requires_grad_()
    upstream = 3.0
    torch.cuda.synchronize()
    _zero_counts()
    loss = rf.rendering_loss_fused_planes(pred, gt, scenes,
                                          want_target_grad=True)
    (upstream * loss).backward()
    torch.cuda.synchronize()
    counts = _counts()
    log(f"{TARGET_GRAD_PATH}: loss {float(loss.detach())!r}; launches "
        f"{counts}")
    _expect(counts, {"render_fwdgrad_both": 1}, TARGET_GRAD_PATH)
    # The comparison's own launch, after the counts are read.
    ref_loss, dpred, dgt = rf.rendering_loss_fwdgrad_both_cuda(p, g, s9)
    if not (torch.equal(loss.detach(), ref_loss)
            and torch.equal(pred.grad, upstream * dpred)
            and torch.equal(gt.grad, upstream * dgt)):
        raise RuntimeError(f"{TARGET_GRAD_PATH}: the gradients are not "
                           f"upstream * dpred / dgt")
    log(f"{TARGET_GRAD_PATH}: pred.grad and gt.grad equal {upstream} * "
        f"dpred / dgt")
    return counts


def kernel_times(inputs, rates: dict) -> dict:
    """Each kernel launched alone and through its wrapper, its plain
    version, and its bound at these inputs."""
    from svbrdf_tpu_torch.ops import render_fused as rf
    from svbrdf_tpu_torch.utils.bench_setup import kernel_ms

    batch, _, height, width = inputs[0].shape
    n_scenes = inputs[2].shape[1]
    out = {}
    for name, plain in rf.PLAIN_VERSIONS.items():
        wrapper = rf.CUDA_WRAPPERS[name]
        ms = kernel_ms(name, inputs)
        wrapper_ms = cuda_ms(lambda: wrapper(*inputs))
        plain_ms = cuda_ms(lambda: plain(*inputs))
        bound_ms, bound_by, parts = bound(name, batch, height, width,
                                          n_scenes, rates)
        per_sm = rf.blocks_per_sm(name, n_scenes)
        out[name] = {"ms": ms, "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "bound_parts_us": parts, "blocks_per_sm": per_sm}
        log(f"{name}: kernel {ms:.4f} ms (wrapper {wrapper_ms:.4f} ms), "
            f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}; "
            + ", ".join(f"{k} {v:.2f}" for k, v in parts.items())
            + f"), {per_sm} blocks per SM")
    return out


def step_times(path: str, program) -> dict:
    from svbrdf_tpu_torch.parallel.step import prepare

    images = prepare(program.raw, program.prep, program.generator)["inputs"]
    steps = {"train_step": lambda: program.train_step(program.raw),
             "eval_step": lambda: program.eval_step(program.raw),
             "predict": lambda: program.predict(images)}
    out = {k: cuda_ms(fn, runs=20, warmup=2) for k, fn in steps.items()}
    log(f"{path} ms (median of 20, CUDA events): {out}")
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
    from svbrdf_tpu_torch.utils.bench_setup import build_program, loss_inputs

    inputs = loss_inputs(MAIN["batch"], MAIN["size"], MAIN["n_scenes"])
    errors = phase_kernels(inputs)
    phase_agreement()

    counts, steps_ms = {}, {}
    for path, (kinds, _) in PATHS.items():
        program = build_program(*kinds, MAIN["batch"], MAIN["size"],
                                MAIN["depth"], MAIN["num_filters"], seed=0,
                                device="cuda")
        counts[path] = phase_path(path, program)
        steps_ms[path] = step_times(path, program)
        del program
        torch.cuda.empty_cache()
    counts[TARGET_GRAD_PATH] = phase_target_grad(inputs)
    times = kernel_times(inputs, rates)
    kernels = []
    for k in KERNELS:
        path, calls = KERNEL_PATH[k]
        launches = counts[path][k]
        kernels.append(dict(
            name=k, **KERNELS[k], path=path, launches=launches,
            launches_per_call=launches / calls,
            max_abs_err=errors[k]["max_abs_err"],
            loss_rel_err=errors[k]["loss_rel_err"],
            ms=times[k]["ms"], wrapper_ms=times[k]["wrapper_ms"],
            plain_ms=times[k]["plain_ms"], bound_ms=times[k]["bound_ms"],
            bound_us=times[k]["bound_ms"] * 1e3,
            bound_by=times[k]["bound_by"],
            bound_parts_us=times[k]["bound_parts_us"],
            blocks_per_sm=times[k]["blocks_per_sm"], library_ms=None))
    log(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels, "steps_ms": steps_ms}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
