"""The trace's reduction: the device's busy union, its idle gaps and what
the host was doing in them."""

import pytest

from bench_gpu import core


def _events():
    W = core.WINDOW_SPAN
    return [
        (W, False, 0.0, 100.0),
        ("bench:step_call", False, 0.0, 60.0),
        ("bench:loss_read", False, 60.0, 100.0),
        ("aten::conv2d", False, 5.0, 30.0),
        ("aten::cat", False, 40.0, 45.0),
        ("cudaLaunchKernel", False, 41.0, 42.0),
        # The host span's annotation on the device's timeline.
        ("bench:step_call", True, 10.0, 58.0),
        ("conv_kernel", True, 10.0, 20.0),
        ("conv_kernel", True, 15.0, 25.0),  # overlaps the first
        ("Memcpy HtoD", True, 30.0, 35.0),
        ("mixed_fwdgrad_kernel<float>", True, 50.0, 58.0),
        ("late_kernel", True, 95.0, 110.0),  # ends after the window
    ]


def test_busy_is_the_union_of_device_activity_without_annotations():
    prof = core.Profiled(_events(), steps=2)
    assert prof.window_s == pytest.approx(100e-6)
    # 10-25, 30-35, 50-58, 95-100 (clipped to the window).
    assert prof.busy_s == pytest.approx(33e-6)
    assert prof.launches == 4
    assert prof.kernel_seconds(r"\bmixed_fwdgrad_kernel\b") == \
        pytest.approx(8e-6)


def test_idle_gaps_by_what_the_host_was_doing():
    idle = dict(core.Profiled(_events(), steps=2).breakdown()["idle_gaps"])
    assert idle["bench:step_call > aten::conv2d"] == pytest.approx(15e-6)
    assert idle["bench:step_call > aten::cat"] == pytest.approx(15e-6)
    assert idle["bench:loss_read > python"] == pytest.approx(37e-6)
    assert sum(idle.values()) == pytest.approx(67e-6)
    ops = dict(core.Profiled(_events(), steps=2).breakdown()["device_ops"])
    assert ops["conv_kernel"] == pytest.approx(20e-6)
    assert "bench:step_call" not in ops


def test_the_idle_share_sets_busy_time_a_step_against_the_windows_step():
    # The profiler slows the host: the share takes the step's time from
    # the window (20 steps in 1 ms: 50 us a step), not from the trace.
    prof = core.Profiled(_events(), steps=2)  # 33 us busy: 16.5 a step
    run = {"cell": {"traffic": {"driver": "train"}}, "profiled": prof,
           "spans": [{}] * 20, "seconds": 1e-3}
    idle = core.metric_reader("device_idle_pct.train")(run)
    assert idle == pytest.approx(100.0 * (1.0 - 16.5 / 50.0))
    run["cell"]["traffic"]["driver"] = "predict"
    assert core.metric_reader("device_idle_pct.train")(run) is None
    assert core.metric_reader("device_idle_pct.predict")(run) == \
        pytest.approx(idle)
