"""Host milliseconds a step inside the program's step.forward span:
TrainStep.update's forward (TrainStep.forward: the model on the prepared
inputs, in its compute dtype), issued. Summed over the profiled steps
that follow the window (the profiler slows the host, about twofold in a
host-bound step), over their count; None where the program records no
such span."""

from bench_gpu.program_spans import mean_ms

SPAN = "step.forward"


def read(run):
    return mean_ms(run, SPAN)
