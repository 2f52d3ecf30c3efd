"""Each cell's control comes out not correct: the reference in float8 in
the training program's place, the program's own bf16 path in the
prediction's, held to the cell's limits (at a size a test run holds; the
readings the limits were set from are the card's, at the cells' sizes)."""

import pytest

from bench_gpu.drivers import predict, train
from bench_gpu.reference import check
from bench_gpu.reference.model import fp8
from bench_gpu.tests.conftest import SEED, tiny


@pytest.mark.parametrize("name", ["single_view.train_local",
                                  "multi_view.train_local",
                                  "single_view.train_pathtraced"])
def test_the_float8_control_fails_a_train_cells_limits(name):
    cell = tiny(name)
    state = train.setup(cell, SEED, "cpu", warm_steps=3)
    train.release(state)
    ref, _ = check.reference_steps(cell, SEED, state.strips, state.inputs,
                                   "cpu")
    low, _ = check.reference_steps(cell, SEED, state.strips, state.inputs,
                                   "cpu", quant=fp8)
    limits = cell["limits"]
    values = {"batch_rows_unmatched": 0, **check.gaps(low, ref)}
    assert not check.passed(check._held(values, limits)), values
    program = {"batch_rows_unmatched": 0, **check.gaps(state.readings, ref)}
    assert check.passed(check._held(program, limits)), program


def test_the_bf16_control_fails_the_prediction_cells_limit():
    # bf16's error grows with the network: at depth 5 and 8 filters it
    # stays under the limit, at depth 7, 32 filters and 128^2 it does not.
    cell = tiny("single_view.predict_files", model_depth=7, num_filters=32,
                image_size=128)
    out = {}
    for label, dtype in (("program", None), ("control", "bfloat16")):
        caller = predict.Caller(cell, SEED, "cpu", dtype=dtype)
        samples = []
        for _ in range(4):
            _, k, written = caller.call()
            samples.append((caller.photos[k][1], written))
        caller.close()
        out[label] = check.predict_gaps(cell, SEED, samples, "cpu")
    limit = cell["limits"]["map_gap_bytes"]
    assert out["program"] <= limit < out["control"], out
