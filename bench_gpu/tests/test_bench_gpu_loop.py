"""A cell's loop on a tiny program on the CPU, through the harness's own
functions; the command itself refuses the CPU."""

import subprocess
import sys

import pytest
import torch

from bench_gpu import core
from bench_gpu.drivers import predict, train
from bench_gpu.tests.conftest import SEED, tiny


def _per_layer(cell, out):
    run = {"cell": cell, "spans": out["spans"], "profiled": out["profiled"],
           "seconds": 1.0, "card": "cpu"}
    return {m["name"]: core.metric_reader(m["name"])(run)
            for m in core.metrics_of(core.load_benchmark(), cell["name"],
                                     "per_layer")}


def test_train_cell_loop_on_the_cpu():
    cell = tiny("single_view.train_local")
    out = train.run(cell, SEED, 1.0, True, "cpu")
    assert out["correct"], out["checks"]
    assert out["attempted"] == len(out["spans"]) > 0 and out["failed"] == 0
    assert out["e2e"]["train_samples_per_s"] == pytest.approx(
        8 * out["attempted"] / 1.0)
    assert out["e2e"]["train_step_ms_p95"] > 0
    assert [s["number"] for s in out["spans"]] == list(
        range(6, 6 + out["attempted"]))
    layer = _per_layer(cell, out)
    assert layer["data_ms_per_step"] > 0 and layer["step_call_ms"] > 0
    # No device on the CPU: the device's metrics have nothing to read.
    for name in ("kernel_launches_per_step", "device_idle_pct.train",
                 "mfu_pct", "loss_kernel_roofline_pct"):
        assert layer[name] is None
    assert out["profiled"].steps == cell["traffic"]["profile_steps"]


def test_predict_cell_loop_on_the_cpu():
    cell = tiny("single_view.predict_files")
    out = predict.run(cell, SEED, 0.5, False, "cpu")
    assert out["correct"], out["checks"]
    # f32 on both sides: a value that lies at a byte's boundary may round
    # either way, one byte of a 32x128x3 strip (8.1e-5) on some photos.
    assert out["checks"]["map_gap_bytes"]["value"] < 1e-3
    assert out["attempted"] > 0 and out["profiled"] is None
    assert torch.get_num_threads() == cell["traffic"]["host_threads"] == 1


def test_the_command_refuses_a_machine_without_a_card():
    out = subprocess.run(
        [sys.executable, str(core.BENCH / "run.py"), "--workload",
         "single_view.train_local", "--seed", str(SEED), "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=core.ROOT)
    assert out.returncode != 0
    assert not any(line.startswith("{") for line in out.stdout.splitlines())
    assert "CUDA" in out.stderr
