"""Model FLOP utilization of the window's f32 training steps, in %: the
frozen plan's convolution and dense FLOPs of a step at the cell's shapes
(bench_gpu/counts/flops.py: three forwards, no recomputation) times the
steps that ended inside the window, over the window's seconds on the
host's clock, against the card's f32 peak without TF32 (67 TFLOP/s on
an H100 SXM at full power). Read only where an f32 cell's traced steps
ran on a card."""

from bench_gpu.counts.flops import train_step_flops

PEAK_F32_FLOPS = 67e12


def read(run):
    prof = run["profiled"]
    if (run["cell"]["traffic"]["driver"] != "train"
            or run["cell"]["config"]["dtype"] != "float32" or prof is None
            or not prof.kernels or not run["spans"]):
        return None
    flops = train_step_flops(run["cell"]["config"]) * len(run["spans"])
    return 100.0 * flops / run["seconds"] / PEAK_F32_FLOPS
