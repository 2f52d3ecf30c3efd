"""BENCHMARK.json and every file a cell is found by parse and agree."""

import json
import re

import pytest

from bench_gpu import core

BENCHMARK = core.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCHMARK["workloads"]]


def test_top_level_keys_and_command():
    assert set(BENCHMARK) == {"command", "paths", "run_seconds", "configs",
                              "workloads", "end_to_end", "per_layer"}
    assert BENCHMARK["command"] == ["python3", "bench_gpu/run.py"]
    assert BENCHMARK["paths"] == ["bench_gpu"]
    assert 1 <= BENCHMARK["run_seconds"] <= 51
    assert len((core.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_keys():
    for c in BENCHMARK["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and 1 <= len(c["source"]) <= 200
        assert c["file"] == f"bench_gpu/configs/{c['name']}.json"
        assert c["reduced"] == []
    for w in BENCHMARK["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["chips"] == 1
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    for m in BENCHMARK["end_to_end"] + BENCHMARK["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in BENCHMARK["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCHMARK["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in BENCHMARK["end_to_end"]}
        assert (core.BENCH / "metrics" / f"{m['name']}.py").exists()
    names = [x["name"] for k in ("configs", "workloads") for x in
             BENCHMARK[k]]
    names += [m["name"] for m in BENCHMARK["end_to_end"]
              + BENCHMARK["per_layer"]]
    assert len(names) == len(set(names))
    assert any(m["name"] == "setup_s" and "workloads" not in m
               for m in BENCHMARK["end_to_end"])


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_parses_and_reports_its_metrics(cell):
    found = core.load_cell(cell)
    cfg, mix = found["config"], found["traffic"]
    assert mix["driver"] in ("train", "predict")
    assert (core.BENCH / "drivers" / f"{mix['driver']}.py").exists()
    assert cfg["image_size"] == 256 and cfg["model_depth"] == 8
    assert cfg["num_filters"] == 64 and cfg["batch_size"] == 8
    from bench_gpu.reference import check

    # Every number a limit names is one the check reads.
    if mix["driver"] == "predict":
        assert set(found["limits"]) == {"map_gap_bytes"}
    else:
        readings = {"batch_rows_unmatched": 0,
                    **check.gaps({"losses": [1.0], "grads": [1.0],
                                  "change": [1.0], "pred_grads": [1.0],
                                  "pred_grads_l1": [1.0]},
                                 {"losses": [1.0], "grads": [1.0],
                                  "change": [1.0], "pred_grads": [1.0],
                                  "pred_grads_l1": [1.0]})}
        assert set(found["limits"]) <= set(readings)
        assert {"batch_rows_unmatched", "stray_leaves",
                "change_gap_median"} <= set(found["limits"])
        assert {"loss_gap", "loss_gap_first"} & set(found["limits"])
    e2e = core.metrics_of(BENCHMARK, cell, "end_to_end")
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    layer = core.metrics_of(BENCHMARK, cell, "per_layer")
    assert layer and all(m["moves"] in {e["name"] for e in e2e}
                         for m in layer)


def test_every_configuration_file_names_its_source():
    for path in (core.BENCH / "configs").glob("*.json"):
        cfg = json.loads(path.read_text())
        assert cfg["reduced"] == [] and 1 <= len(cfg["source"]) <= 200
        assert cfg["dtype"] in ("bfloat16", "float32")
