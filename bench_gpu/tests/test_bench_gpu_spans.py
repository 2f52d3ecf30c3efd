"""The readers of the program's host spans: the mean ms a profiled step
(call) of each span, None without it; a span stays off the device's
busy time and its launches."""

import json

import pytest

from bench_gpu import core

# Each reader and the span it reads.
READERS = {"prepare_host_ms": "step.prepare",
           "forward_host_ms": "step.forward",
           "loss_host_ms": "step.loss",
           "backward_host_ms": "step.backward",
           "optimizer_host_ms": "step.optimizer",
           "raw_batch_host_ms": "data.raw_batch",
           "photo_decode_ms": "predict.decode",
           "predict_forward_ms": "predict.forward",
           "maps_encode_ms": "predict.encode"}


def _events(span=None):
    """Two steps of 100 us in a 200 us window; `span` twice inside them,
    for 25 and 70 us, with an op inside the first."""
    events = [(core.WINDOW_SPAN, False, 0.0, 200.0),
              ("bench:step_call", False, 0.0, 90.0),
              ("bench:step_call", False, 100.0, 190.0),
              ("aten::conv2d", False, 20.0, 25.0),
              ("conv_kernel", True, 20.0, 40.0),
              ("conv_kernel", True, 120.0, 150.0)]
    if span is not None:
        events += [(span, False, 5.0, 30.0), (span, False, 110.0, 180.0)]
    return events


def _run(events, steps=2):
    return {"profiled": core.Profiled(events, steps=steps), "spans": [{}],
            "seconds": 1.0, "cell": {"traffic": {"driver": "train"}}}


@pytest.mark.parametrize("metric,span", sorted(READERS.items()))
def test_reader_is_the_mean_ms_a_step_of_its_span(metric, span):
    read = core.metric_reader(metric)
    assert read(_run(_events(span))) == pytest.approx(95e-3 / 2)
    assert read(_run(_events(span), steps=4)) == pytest.approx(95e-3 / 4)
    # Without its span (the parent's program; another span): nothing.
    assert read(_run(_events())) is None
    other = "predict.decode" if span != "predict.decode" else "step.loss"
    assert read(_run(_events(other))) is None
    assert read({"profiled": None}) is None


def test_a_host_span_is_no_device_activity_and_no_launch():
    plain = core.Profiled(_events(), steps=2)
    spanned = core.Profiled(_events("step.forward"), steps=2)
    assert spanned.launches == plain.launches == 2
    assert spanned.busy_s == pytest.approx(plain.busy_s)
    assert spanned.device == plain.device
    breakdown = spanned.breakdown()
    assert all("step." not in name for name, _ in breakdown["device_ops"])
    # An idle gap whose middle lies inside the span but inside no op is
    # the span's (0-20 and 150-200 us); the rest stays the harness's.
    idle = dict(breakdown["idle_gaps"])
    assert idle["bench:step_call > step.forward"] == pytest.approx(70e-6)
    assert idle["bench:step_call > python"] == pytest.approx(80e-6)
    assert dict(plain.breakdown()["idle_gaps"])[
        "bench:step_call > python"] == pytest.approx(150e-6)


def test_each_reader_is_a_per_layer_metric_of_its_cells():
    with open(core.ROOT / "BENCHMARK.json") as f:
        per_layer = {m["name"]: m for m in json.load(f)["per_layer"]}
    for metric, span in READERS.items():
        entry = per_layer[metric]
        assert (entry["unit"], entry["better"], entry["source"]) == (
            "ms", "lower", "device_trace")
        train = span.startswith(("step.", "data."))
        assert entry["moves"] == ("train_samples_per_s" if train
                                  else "predict_photos_per_s")
        assert all(("predict" in c) != train for c in entry["workloads"])
