"""Host milliseconds a training step spends in the data layer: the
harness's span around SvbrdfDataset.raw_batch (its partner draws and cache
reads), the copy of the batch to the card and the decode pool's hint for
the next batch, averaged over every step of the window."""


def read(run):
    spans = [s["data_s"] for s in run["spans"] if "data_s" in s]
    return 1e3 * sum(spans) / len(spans) if spans else None
