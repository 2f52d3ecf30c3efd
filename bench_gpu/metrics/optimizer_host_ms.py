"""Host milliseconds a step inside the program's step.optimizer span:
TrainStep.update's optimizer step (TrainStep.apply_gradients: SR-Adam's
one launch, or torch's Adam), issued. Summed over the profiled steps
that follow the window (the profiler slows the host, about twofold in a
host-bound step), over their count; None where the program records no
such span."""

from bench_gpu.program_spans import mean_ms

SPAN = "step.optimizer"


def read(run):
    return mean_ms(run, SPAN)
