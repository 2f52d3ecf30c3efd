"""The fused loss kernel's share of its roofline in training, in %: the
least time of a step's loss value and gradient at the cell's shapes and
plane dtype (bench_gpu/counts/bounds.py), over the device time of the
loss kernels per profiled step. The kernels, by the name they are
launched under:
  mixed_fwdgrad_kernel     (csrc/mixed_loss.cu, the mixed loss)
  rendering_fwdgrad_kernel (csrc/rendering_loss.cu, the rendering loss)
"""

from bench_gpu.counts.bounds import card_rates, loss_bound_s

KERNELS = {"mixed_fwdgrad": r"\bmixed_fwdgrad_kernel\b",
           "render_fwdgrad": r"\brendering_fwdgrad_kernel\b"}
SCENES = 9
PLANE_BYTES = {"bfloat16": 2, "float32": 4}


def read(run):
    prof = run["profiled"]
    if prof is None:
        return None
    cfg = run["cell"]["config"]
    for kernel, pattern in KERNELS.items():
        seconds = prof.kernel_seconds(pattern)
        if seconds > 0:
            bound = loss_bound_s(kernel, cfg["batch_size"],
                                 cfg["image_size"], cfg["image_size"],
                                 SCENES, card_rates(run["card"]),
                                 PLANE_BYTES[cfg["dtype"]])
            return 100.0 * bound * prof.steps / seconds
    return None
