"""Host milliseconds a call inside the program's predict.encode span:
SvbrdfEstimator.predict_to_files's map strips: unpacking, concatenating
and writing each as a PNG (zlib). Summed over the profiled calls that
follow the window (the profiler slows the host), over their count; None
where the program records no such span."""

from bench_gpu.program_spans import mean_ms

SPAN = "predict.encode"


def read(run):
    return mean_ms(run, SPAN)
