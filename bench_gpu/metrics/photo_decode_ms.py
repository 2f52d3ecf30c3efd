"""Host milliseconds a call inside the program's predict.decode span:
SvbrdfEstimator.predict_to_files's reading of the photos (PNG decode)
and their linearisation on the host. Summed over the profiled calls that
follow the window (the profiler slows the host), over their count; None
where the program records no such span."""

from bench_gpu.program_spans import mean_ms

SPAN = "predict.decode"


def read(run):
    return mean_ms(run, SPAN)
