"""A run with the timed path broken underneath comes out not correct:
once for each fault a cell can have."""

import pytest

from bench_gpu.drivers import predict, train
from bench_gpu.tests.conftest import SEED, tiny


def test_a_step_that_leaves_its_state_unchanged(monkeypatch):
    from svbrdf_tpu_torch.parallel import step as step_lib

    monkeypatch.setattr(step_lib.TrainStep, "apply_gradients",
                   lambda self, step: None)
    out = train.run(tiny("single_view.train_local"), SEED, 0.3, False, "cpu")
    assert not out["correct"]
    assert out["checks"]["change_gap_median"]["value"] > 0.9


@pytest.mark.parametrize("cell", ["single_view.train_local",
                                  "multi_view.train_local",
                                  "single_view.train_pathtraced"])
def test_half_of_the_batch_left_out(monkeypatch, cell):
    from svbrdf_tpu_torch.parallel import step as step_lib

    original = step_lib.loss_rows

    def half_batch(loss_fn, pred, target, generator, span, *args):
        h = pred.shape[0] // 2
        return original(loss_fn, pred[:h], target[:h], generator, (0, h, h),
                        *args)

    monkeypatch.setattr(step_lib, "loss_rows", half_batch)
    out = train.run(tiny(cell), SEED, 0.3, False, "cpu")
    assert not out["correct"], out["checks"]
    held = out["checks"].get("pred_grad_l1_gap_median")
    if held is not None:
        # Half the rows get no cotangent, the other half twice theirs: the
        # cotangent's number fails by itself.
        assert held["value"] > max(0.5, held["limit"])


def test_an_answer_altered_where_it_is_produced(monkeypatch):
    from svbrdf_tpu_torch.estimator import SvbrdfEstimator

    original = SvbrdfEstimator.predict
    monkeypatch.setattr(SvbrdfEstimator, "predict",
                   lambda self, images: original(self, images) * 0.9)
    out = predict.run(tiny("single_view.predict_files"), SEED, 0.3, False,
                      "cpu")
    assert not out["correct"]


def test_a_batch_row_that_is_no_strip_of_the_corpus(monkeypatch):
    from svbrdf_tpu_torch.data.dataset import SvbrdfDataset

    original = SvbrdfDataset.raw_batch

    def shifted(self, indices, rows=None):
        batch = original(self, indices, rows)
        batch["svbrdf"] = batch["svbrdf"][:, ::-1].copy()
        return batch

    monkeypatch.setattr(SvbrdfDataset, "raw_batch", shifted)
    out = train.run(tiny("single_view.train_local"), SEED, 0.3, False, "cpu")
    assert not out["correct"]
    assert out["checks"]["batch_rows_unmatched"]["value"] > 0
