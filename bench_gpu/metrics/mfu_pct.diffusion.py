"""Model FLOP utilization of the window's diffusion training steps, in %:
the frozen plan's convolution, dense and attention FLOPs of a step at the
cell's widths and batch (bench_gpu/counts/ddpm_flops.py: three forwards,
less conv_in's input gradient) times the steps that ended inside the
window, over the window's seconds on the host's clock, against the
card's dense bf16 peak (989 TFLOP/s on an H100 SXM at full power). Read
only where the traced steps ran on a card."""

from bench_gpu.counts.ddpm_flops import PEAK_BF16_FLOPS, train_step_flops


def read(run):
    prof = run["profiled"]
    if (run["cell"]["traffic"]["driver"] != "diffusion" or prof is None
            or not prof.kernels or not run["spans"]):
        return None
    flops = train_step_flops(run["cell"]["config"]) * len(run["spans"])
    return 100.0 * flops / run["seconds"] / PEAK_BF16_FLOPS
