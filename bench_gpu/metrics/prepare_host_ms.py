"""Host milliseconds a step inside the program's step.prepare span:
TrainStep.__call__'s preparation of the batch on the device
(parallel/step.prepare_rows: the step's draws, mixing, photo synthesis),
issued. Summed over the profiled steps that follow the window (the
profiler slows the host, about twofold in a host-bound step), over their
count; None where the program records no such span."""

from bench_gpu.program_spans import mean_ms

SPAN = "step.prepare"


def read(run):
    return mean_ms(run, SPAN)
