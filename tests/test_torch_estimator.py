"""The port's inference API (svbrdf_tpu_torch/estimator.py) against the JAX
package's (svbrdf_tpu/estimator.py), on the CPU: one checkpoint.tar
written by the port (depth 4, 4 filters, 16^2: the JAX test's tiny
checkpoint sizes) is loaded by both estimators.

Tolerances: the maps within rtol 1e-4 / atol 1e-5 (the same weights; the
two frameworks' convolutions sum in other orders); map files decoded
within 1 u8 level (a value within rounding of a level's edge may fall on
either side of the truncation to bytes).
"""

import contextlib
import io

import jax
import numpy as np
import pytest
import torch

from svbrdf_tpu.estimator import SvbrdfEstimator as JaxEstimator
from svbrdf_tpu_torch.data import strips
from svbrdf_tpu_torch.estimator import SvbrdfEstimator
from svbrdf_tpu_torch.models import build_model
from svbrdf_tpu_torch.training.checkpoint import Checkpoint

torch.set_num_threads(1)

SIZE = 16


def _quiet():
    return contextlib.redirect_stdout(io.StringIO())


def _write(d, model_type="single"):
    model = build_model(model_type, False, 4, 4, device="cpu", seed=3)
    with _quiet():
        Checkpoint.save(d, model, None, 0, model_type, False,
                        omit_optimizer_state=True, model_depth=4,
                        num_filters=4)
    return model


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    d = tmp_path_factory.mktemp("est") / "model"
    _write(d)
    with _quiet():
        jax_est = JaxEstimator.from_checkpoint(d, image_size=SIZE)
        est = SvbrdfEstimator.from_checkpoint(d, image_size=SIZE,
                                              device="cpu")
    return d, est, jax_est


def _jax_predict(jax_est, images):
    with jax.default_matmul_precision("highest"):
        return jax_est.predict(images)


def _images(shape, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(
        np.float32)


def test_predict_matches_jax(checkpoint):
    _, est, jax_est = checkpoint
    images = _images((2, SIZE, SIZE, 3))
    mine = est.predict(images)
    assert isinstance(mine, np.ndarray) and mine.shape == (2, SIZE, SIZE, 12)
    assert mine.dtype == np.float32
    np.testing.assert_allclose(mine, _jax_predict(jax_est, images),
                               rtol=1e-4, atol=1e-5)
    # A tensor in gives the same maps as numpy.
    np.testing.assert_array_equal(est.predict(torch.from_numpy(images)),
                                  mine)


def test_multi_view_input_matches_jax(checkpoint):
    """(B, N, H, W, 3) into the single-view model (view 0 is used)."""
    _, est, jax_est = checkpoint
    images = _images((2, 3, SIZE, SIZE, 3), seed=1)
    np.testing.assert_allclose(est.predict(images),
                               _jax_predict(jax_est, images), rtol=1e-4,
                               atol=1e-5)


def test_multi_view_model_matches_jax(tmp_path):
    """A multi-view checkpoint: the architecture comes from the file."""
    _write(tmp_path / "multi", "multi")
    with _quiet():
        jax_est = JaxEstimator.from_checkpoint(tmp_path / "multi",
                                               image_size=SIZE)
        est = SvbrdfEstimator.from_checkpoint(tmp_path / "multi",
                                              device="cpu")
    assert type(est.model).__name__ == "MultiViewModel"
    images = _images((1, 3, SIZE, SIZE, 3), seed=2)
    np.testing.assert_allclose(est.predict(images),
                               _jax_predict(jax_est, images), rtol=1e-4,
                               atol=1e-5)


def test_predict_to_files_matches_jax(checkpoint, tmp_path):
    _, est, jax_est = checkpoint
    photos = []
    for k in range(2):
        path = tmp_path / f"photo{k}.png"
        strips.write_image(str(path), _images((SIZE, SIZE, 3), seed=10 + k))
        photos.append(str(path))
    mine = est.predict_to_files(photos, str(tmp_path / "port"))
    with jax.default_matmul_precision("highest"):
        theirs = jax_est.predict_to_files(photos, str(tmp_path / "jax"))
    assert [p.rsplit("/", 1)[1] for p in mine] == \
        [p.rsplit("/", 1)[1] for p in theirs] == \
        ["photo0_svbrdf.png", "photo1_svbrdf.png"]
    for a, b in zip(mine, theirs):
        x = strips.read_image_u8(a).astype(int)
        y = strips.read_image_u8(b).astype(int)
        assert x.shape == (SIZE, 4 * SIZE, 3)
        assert np.abs(x - y).max() <= 1


def test_missing_checkpoint_raises(tmp_path):
    (tmp_path / "empty").mkdir()
    (tmp_path / "empty" / "meta.json").write_text("{}")
    with _quiet(), pytest.raises(FileNotFoundError):
        SvbrdfEstimator.from_checkpoint(tmp_path / "empty", device="cpu")
    with _quiet(), pytest.raises(FileNotFoundError):
        SvbrdfEstimator.from_checkpoint(tmp_path / "nowhere", device="cpu")


def test_orbax_only_directory_raises(tmp_path):
    (tmp_path / "jax" / "state").mkdir(parents=True)
    with pytest.raises(ValueError, match="export-torch-checkpoint"):
        SvbrdfEstimator.from_checkpoint(tmp_path / "jax", device="cpu")


def test_bf16_compute(checkpoint):
    """dtype=bfloat16: the generator computes in bf16, the maps come out
    f32 and near the f32 model's."""
    d, est, _ = checkpoint
    with _quiet():
        bf = SvbrdfEstimator.from_checkpoint(d, dtype=torch.bfloat16,
                                             device="cpu")
    images = _images((2, SIZE, SIZE, 3), seed=4)
    out = bf.predict(images)
    assert out.dtype == np.float32
    assert np.abs(out - est.predict(images)).max() < 0.1
