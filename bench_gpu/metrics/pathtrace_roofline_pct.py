"""The path tracer's kernels' share of their roofline in training, in %:
the least time of a step's path-tracer work (two forward renders at the
forward spp, the prediction's in the compute dtype and the target's in
f32, and one VJP at the backward spp, on batch x 9 scenes x size^2;
bench_gpu/counts/bounds.py), over the device time per profiled step of
the kernels launched as
  shade_kernel     (csrc/pathtrace.cu, pathtrace_shade)
  shade_vjp_kernel (csrc/pathtrace.cu, pathtrace_shade_vjp)
"""

from bench_gpu.counts.bounds import card_rates, pathtrace_bound_s

PATTERN = r"\b(shade_kernel|shade_vjp_kernel)\b"
SCENES = 9
FIELD_BYTES = {"bfloat16": 2, "float32": 4}


def read(run):
    prof = run["profiled"]
    if prof is None:
        return None
    seconds = prof.kernel_seconds(PATTERN)
    if seconds <= 0:
        return None
    cfg = run["cell"]["config"]
    rates = card_rates(run["card"])
    shape = (cfg["batch_size"], SCENES, cfg["image_size"], cfg["image_size"])
    fwd, bwd = cfg["spp"]
    bound = (pathtrace_bound_s("pathtrace_shade", *shape, fwd, rates,
                               FIELD_BYTES[cfg["dtype"]])
             + pathtrace_bound_s("pathtrace_shade", *shape, fwd, rates, 4)
             + pathtrace_bound_s("pathtrace_shade_vjp", *shape, bwd, rates,
                                 FIELD_BYTES[cfg["dtype"]]))
    return 100.0 * bound * prof.steps / seconds
