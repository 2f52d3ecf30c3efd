"""Host milliseconds an iteration inside the program's capture.backward
span: CaptureStep's zero_grad and loss.backward() (the gradients of W+
and the noise maps through the frozen generator and the renderer),
issued. Summed over the profiled iterations that follow the window, over
their count; None where the program records no such span."""

from bench_gpu.program_spans import mean_ms

SPAN = "capture.backward"


def read(run):
    return mean_ms(run, SPAN)
