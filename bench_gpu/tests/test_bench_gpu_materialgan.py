"""The MaterialGAN capture cell's files, yardstick, readers and driver on
the CPU (a tiny generator: 32^2, channels capped at 32, w 32, 4 mapping
layers, 2 materials x 3 photos)."""

import copy
import subprocess
import sys

import pytest

from bench_gpu import core
from bench_gpu.counts import stylegan2_flops
from bench_gpu.tests.conftest import SEED
from bench_gpu.tests.test_bench_gpu_imports import _BLOCK, ROOT

CELL = "materialgan.capture"
METRICS = ("mfu_pct.capture", "device_idle_pct.capture",
           "synthesis_host_ms", "capture_loss_host_ms",
           "capture_backward_host_ms")
SPANS = {"synthesis_host_ms": "capture.synthesis",
         "capture_loss_host_ms": "capture.loss",
         "capture_backward_host_ms": "capture.backward"}
SMALL = dict(resolution=32, image_size=32, w_dim=32, mapping_layers=4,
             max_channels=32)


def tiny_cell() -> dict:
    cell = copy.deepcopy(core.load_cell(CELL))
    cell["config"].update(SMALL)
    cell["traffic"].update(materials=2, photos=3)
    return cell


def test_the_cell_its_configuration_traffic_and_limits_parse():
    benchmark = core.load_benchmark()
    (config,) = [c for c in benchmark["configs"]
                 if c["name"] == "materialgan"]
    assert config["reduced"] == [] and config["source"].startswith("https")
    cell = core.load_cell(CELL)
    cfg, mix = cell["config"], cell["traffic"]
    assert cfg["reduced"] == [] and cfg["assumed"]
    # The published widths: config-f at 256^2.
    assert (cfg["resolution"], cfg["w_dim"], cfg["z_dim"], cfg["num_ws"],
            cfg["mapping_layers"], cfg["noise_maps"], cfg["rgb_channels"]
            ) == (256, 512, 512, 14, 8, 13, 9)
    assert cfg["channels"] == {str(r): min(512, 32768 // r)
                               for r in (4, 8, 16, 32, 64, 128, 256)}
    assert cfg["channels"]["128"] == 256 and cfg["channels"]["256"] == 128
    assert (mix["driver"], mix["materials"], mix["photos"],
            mix["warm_steps"], mix["check_steps"],
            mix["profile_steps"]) == ("capture", 8, 7, 5, 3, 10)
    assert set(cell["limits"]) == {"loss_gap", "wplus_grad_gap_median",
                                   "noise_grad_gap_median",
                                   "change_gap_median"}
    e2e = {m["name"] for m in core.metrics_of(benchmark, CELL,
                                               "end_to_end")}
    assert e2e == {"train_samples_per_s", "train_step_ms_p95", "setup_s"}
    layer = core.metrics_of(benchmark, CELL, "per_layer")
    assert sorted(m["name"] for m in layer) == sorted(METRICS)
    assert all(m["workloads"] == [CELL] for m in layer)


def test_the_flop_plan_against_a_hand_count():
    # 32^2, 32 channels everywhere, w 32: a 3x3 conv at r^2 is
    # 2 r^2 9 32^2, an up-sampling one 2 (r/2)^2 9 32^2, a toRGB
    # 2 r^2 32 9, and each of the 11 affines 2 * 32 * 32.
    convs = sum(2 * r * r * 9 * 1024 for r in (4, 8, 16, 32))
    ups = sum(2 * r * r * 9 * 1024 for r in (4, 8, 16))
    rgbs = sum(2 * r * r * 32 * 9 for r in (4, 8, 16, 32))
    hand = convs + ups + rgbs + 11 * 2 * 32 * 32
    assert hand == 32_066_560
    assert stylegan2_flops.synthesis_flops(32, 32, 32) == hand
    small = dict(resolution=32, w_dim=32, max_channels=32,
                 channel_base=32768)
    assert stylegan2_flops.capture_step_flops(small, 3) == 2 * 3 * hand
    # The cell's: 90.4 GFLOP a material's forward, 1.45 TFLOP a step.
    cfg = core.load_cell(CELL)["config"]
    assert stylegan2_flops.synthesis_flops() == 90_429_669_376
    assert stylegan2_flops.capture_step_flops(cfg, 8) == 16 * 90_429_669_376


def _run(events=None, spans=None, driver="capture", steps=2):
    profiled = None if events is None else core.Profiled(events, steps)
    return {"cell": {**tiny_cell(), "traffic": {
                **tiny_cell()["traffic"], "driver": driver}},
            "spans": [{"start": 0.0, "end": 0.04}] * 25 if spans is None
            else spans, "seconds": 1.0, "profiled": profiled,
            "card": "NVIDIA H100 80GB HBM3"}


def _events(span=None):
    events = [(core.WINDOW_SPAN, False, 0.0, 200.0),
              ("bench:capture_step", False, 0.0, 90.0),
              ("bench:capture_step", False, 100.0, 190.0),
              ("aten::conv2d", False, 20.0, 25.0),
              ("conv_kernel", True, 20.0, 60.0),
              ("conv_kernel", True, 120.0, 170.0)]
    if span is not None:
        events += [(span, False, 5.0, 30.0), (span, False, 110.0, 180.0)]
    return events


@pytest.mark.parametrize("metric,span", sorted(SPANS.items()))
def test_span_readers(metric, span):
    read = core.metric_reader(metric)
    assert read(_run(_events(span))) == pytest.approx(95e-3 / 2)
    # Without the span (the parent's program), or without a trace.
    assert read(_run(_events())) is None
    assert read(_run(_events("step.forward"))) is None
    assert read(_run()) is None


def test_the_device_readers():
    mfu = core.metric_reader("mfu_pct.capture")
    idle = core.metric_reader("device_idle_pct.capture")
    run = _run(_events())
    flops = stylegan2_flops.capture_step_flops(run["cell"]["config"], 2)
    assert mfu(run) == pytest.approx(100 * 25 * flops / 494.7e12)
    # 90 us busy over 2 steps against the window's 40 ms a step.
    assert idle(run) == pytest.approx(100 * (1 - 45e-6 / 0.04))
    # Nothing to read: no trace, no kernel, no window, another driver;
    # never 0 for the share of a peak.
    host_only = [e for e in _events() if not e[1]]
    for run in (_run(), _run(host_only), _run(_events(), spans=[]),
                _run(_events(), driver="train")):
        assert mfu(run) is None and idle(run) is None


def test_the_capture_loop_on_the_cpu():
    from bench_gpu.drivers import capture

    cell = tiny_cell()
    out = capture.run(cell, SEED, 0.5, True, "cpu")
    assert out["correct"], out["checks"]
    # f32 against f32 on the CPU: rounding alone, far under the limits.
    assert all(c["value"] < 1e-4 for c in out["checks"].values())
    assert out["attempted"] == len(out["spans"]) > 0 and out["failed"] == 0
    assert out["e2e"]["train_samples_per_s"] == pytest.approx(
        2 * out["attempted"] / 0.5)
    assert out["profiled"].steps == cell["traffic"]["profile_steps"]
    run = {"cell": cell, "spans": out["spans"], "seconds": 0.5,
           "profiled": out["profiled"], "card": "cpu"}
    for metric in SPANS:
        assert core.metric_reader(metric)(run) > 0
    # No device on the CPU: the device's metrics have nothing to read.
    for metric in ("mfu_pct.capture", "device_idle_pct.capture"):
        assert core.metric_reader(metric)(run) is None


def test_a_capture_without_demodulation_is_not_correct(monkeypatch):
    from svbrdf_tpu_torch.models import stylegan2

    from bench_gpu.drivers import capture

    monkeypatch.setattr(stylegan2, "demodulation",
                        lambda weight, styles: styles.new_ones(
                            styles.shape[0], weight.shape[0]))
    out = capture.run(tiny_cell(), SEED, 0.2, False, "cpu")
    assert not out["correct"]
    assert out["checks"]["wplus_grad_gap_median"]["value"] > 0.1


def test_the_capture_driver_imports_no_jax():
    body = """
import bench_gpu.drivers.capture, bench_gpu.reference.stylegan2
import svbrdf_tpu_torch.experiments.map_recovery
import svbrdf_tpu_torch.models.stylegan2
print(sorted(m for m in sys.modules if m.split(".", 1)[0] in BLOCKED))
"""
    out = subprocess.run([sys.executable, "-c", _BLOCK % str(ROOT) + body],
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("[]")


def test_the_control_entry_needs_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry would run")
    out = subprocess.run(
        [sys.executable, "-m", "bench_gpu.drivers.capture", "--control",
         "--workload", CELL, "--seeds", "1"], capture_output=True,
        text=True, timeout=300, cwd=ROOT)
    assert out.returncode != 0 and not out.stdout.strip()
    assert "CUDA" in out.stderr
