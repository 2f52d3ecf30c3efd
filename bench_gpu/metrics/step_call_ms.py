"""Host milliseconds inside TrainStep.__call__ (preparation, forward, loss,
backward and the optimizer step issued, with any wait inside the step),
before the loss is read, averaged over every step of the window."""


def read(run):
    spans = [s["call_s"] for s in run["spans"] if "call_s" in s
             and "data_s" in s]
    return 1e3 * sum(spans) / len(spans) if spans else None
