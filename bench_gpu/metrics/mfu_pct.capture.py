"""Model FLOP utilization of the window's capture iterations, in %: the
frozen plan's convolution and dense FLOPs of an iteration over the mix's
materials (bench_gpu/counts/stylegan2_flops.py: one synthesis forward
and its gradient with respect to the inputs) times the iterations that
ended inside the window, over the window's seconds on the host's clock,
against the card's dense TF32 peak (494.7 TFLOP/s on an H100 SXM at
full power). Read only where the traced iterations ran on a card."""

from bench_gpu.counts.stylegan2_flops import (PEAK_TF32_FLOPS,
                                              capture_step_flops)


def read(run):
    prof = run["profiled"]
    if (run["cell"]["traffic"]["driver"] != "capture" or prof is None
            or not prof.kernels or not run["spans"]):
        return None
    flops = capture_step_flops(run["cell"]["config"],
                               run["cell"]["traffic"]["materials"])
    return (100.0 * flops * len(run["spans"]) / run["seconds"]
            / PEAK_TF32_FLOPS)
