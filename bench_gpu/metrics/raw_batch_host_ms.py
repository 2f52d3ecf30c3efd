"""Host milliseconds a step inside the program's data.raw_batch span:
SvbrdfDataset.raw_batch: partner draws, cache reads, any decode or wait
on the decode pool (data.decode spans, inside it), and the stacking of
the batch. Summed over the profiled steps that follow the window (the
profiler slows the host, about twofold in a host-bound step), over their
count; None where the program records no such span."""

from bench_gpu.program_spans import mean_ms

SPAN = "data.raw_batch"


def read(run):
    return mean_ms(run, SPAN)
