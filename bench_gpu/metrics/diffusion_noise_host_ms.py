"""Host milliseconds a step inside the program's diffusion.noise span:
DiffusionTrainStep's noising (the maps' encoding, the draws of t and
eps, x_t and the input's concatenation), issued. Summed over the
profiled steps that follow the window (the profiler slows the host),
over their count; None where the program records no such span."""

from bench_gpu.program_spans import mean_ms

SPAN = "diffusion.noise"


def read(run):
    return mean_ms(run, SPAN)
