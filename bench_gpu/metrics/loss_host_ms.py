"""Host milliseconds a step inside the program's step.loss span:
TrainStep.update's loss (parallel/step.loss_rows: the loss draws and the
fused loss kernels, or the path tracer's forward renders and torch
glue), issued. Summed over the profiled steps that follow the window
(the profiler slows the host, about twofold in a host-bound step), over
their count; None where the program records no such span."""

from bench_gpu.program_spans import mean_ms

SPAN = "step.loss"


def read(run):
    return mean_ms(run, SPAN)
