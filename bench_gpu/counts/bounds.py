"""Frozen least-work counts of the loss kernels and the path tracer, and
the card's peak rates: the yardstick of the roofline metrics.

A kernel's bound is the least time of its function at the call's shapes:
the larger of the bytes it must move (each input read once, each output
written once) over the memory rate and its operations over the peak FP32
and special-function rates. The per-scene, per-pixel and per-sample
operation counts were derived by hand from the shading algebra and
recounted in review; they are copied here so that a change to the
program cannot move them.
"""

from __future__ import annotations

# The fused losses: FP32 operations and special-function results a pixel
# for each scene, and once a pixel; plane values moved a pixel.
FP32_PER_SCENE = {"mixed_fwdgrad": 398, "mixed_fwd": 231,
                  "render_fwdgrad": 398, "render_fwd": 231,
                  "render_fwdgrad_both": 556}
SFU_PER_SCENE = {"mixed_fwdgrad": 27, "mixed_fwd": 27, "render_fwdgrad": 27,
                 "render_fwd": 27, "render_fwdgrad_both": 27}
FP32_PER_PIXEL = {"mixed_fwdgrad": 175, "mixed_fwd": 70, "render_fwdgrad": 58,
                  "render_fwd": 31, "render_fwdgrad_both": 85}
SFU_PER_PIXEL = {"mixed_fwdgrad": 12, "mixed_fwd": 12, "render_fwdgrad": 0,
                 "render_fwd": 0, "render_fwdgrad_both": 0}
FLOATS_PER_PIXEL = {"mixed_fwdgrad": 36, "mixed_fwd": 24,
                    "render_fwdgrad": 36, "render_fwd": 24,
                    "render_fwdgrad_both": 48}

# The path tracer: (FP32, SFU) a sample, a view (pixel and scene) and a
# pixel, for the forward estimator and its VJP.
PATHTRACE_OPS = {"pathtrace_shade": {"sample": (109, 6), "view": (69, 4),
                                     "pixel": (17, 2)},
                 "pathtrace_shade_vjp": {"sample": (182, 8),
                                         "view": (135, 4),
                                         "pixel": (38, 2)}}

# Peak rates at full power (NVIDIA data sheets; 16 special-function
# results a clock an SM on compute capability 9.0). First match wins.
CARDS = (
    ("H100 PCIe", {"bytes": 2.0e12, "fp32": 51.2e12,
                   "sfu": 114 * 16 * 1.755e9}),
    ("H200", {"bytes": 4.8e12, "fp32": 66.9e12, "sfu": 132 * 16 * 1.98e9}),
    ("H100", {"bytes": 3.35e12, "fp32": 66.9e12, "sfu": 132 * 16 * 1.98e9}),
)


def card_rates(name: str) -> dict:
    for key, rates in CARDS:
        if key in name:
            return rates
    raise ValueError(f"no peak rates recorded for the card {name!r}")


def _time(bytes_moved, fp32, sfu, rates) -> float:
    return max(bytes_moved / rates["bytes"], fp32 / rates["fp32"],
               sfu / rates["sfu"])


def loss_bound_s(kernel: str, batch: int, height: int, width: int,
                 n_scenes: int, rates: dict, plane_bytes: int) -> float:
    """Least seconds of one call of a fused-loss kernel."""
    pixels = batch * height * width
    bytes_moved = (pixels * FLOATS_PER_PIXEL[kernel] * plane_bytes
                   + batch * n_scenes * 9 * 4)
    fp32 = pixels * (n_scenes * FP32_PER_SCENE[kernel]
                     + FP32_PER_PIXEL[kernel])
    sfu = pixels * (n_scenes * SFU_PER_SCENE[kernel] + SFU_PER_PIXEL[kernel])
    return _time(bytes_moved, fp32, sfu, rates)


def pathtrace_bound_s(kernel: str, items: int, scenes: int, height: int,
                      width: int, spp: int, rates: dict,
                      field_bytes: int) -> float:
    """Least seconds of one launch of a path-tracer kernel on items x
    scenes x height x width at spp samples."""
    pixels = items * height * width
    views = pixels * scenes
    ops = PATHTRACE_OPS[kernel]
    fp32, sfu = (views * spp * ops["sample"][i] + views * ops["view"][i]
                 + pixels * ops["pixel"][i] for i in (0, 1))
    bytes_in = (height * width * 3 * field_bytes + pixels * 10 * field_bytes
                + items * scenes * (18 + 2 * spp) * 4 + views * 2 * 4)
    bytes_moved = bytes_in + (views * 3 * 4 if kernel == "pathtrace_shade"
                              else views * 3 * 4 + pixels * 10 * 4)
    return _time(bytes_moved, fp32, sfu, rates)
