"""Host milliseconds a call inside the program's predict.forward span:
SvbrdfEstimator.predict_to_files's forward: the photos to the device,
the model, the maps back to host numpy (which waits for the card).
Summed over the profiled calls that follow the window (the profiler
slows the host), over their count; None where the program records no
such span."""

from bench_gpu.program_spans import mean_ms

SPAN = "predict.forward"


def read(run):
    return mean_ms(run, SPAN)
