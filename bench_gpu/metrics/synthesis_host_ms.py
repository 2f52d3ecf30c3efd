"""Host milliseconds an iteration inside the program's capture.synthesis
span: CaptureStep's forward (the generator's synthesis from W+ and the
noise maps, and the decode to maps), issued. Summed over the profiled
iterations that follow the window, over their count; None where the
program records no such span."""

from bench_gpu.program_spans import mean_ms

SPAN = "capture.synthesis"


def read(run):
    return mean_ms(run, SPAN)
