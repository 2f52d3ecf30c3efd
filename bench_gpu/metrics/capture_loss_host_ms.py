"""Host milliseconds an iteration inside the program's capture.loss span:
CaptureStep's renders of the maps under each material's scenes and the
log-L1 loss against the photos, issued. Summed over the profiled
iterations that follow the window, over their count; None where the
program records no such span."""

from bench_gpu.program_spans import mean_ms

SPAN = "capture.loss"


def read(run):
    return mean_ms(run, SPAN)
