"""Host milliseconds a step inside the program's step.backward span:
TrainStep.update's backward (zero_grad, loss.backward() and the step's
gradient reduction), issued. Summed over the profiled steps that follow
the window (the profiler slows the host, about twofold in a host-bound
step), over their count; None where the program records no such span."""

from bench_gpu.program_spans import mean_ms

SPAN = "step.backward"


def read(run):
    return mean_ms(run, SPAN)
