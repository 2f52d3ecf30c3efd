"""The port's quality metrics (metrics.py) and comparison grid (viz.py)
against the JAX package.

Tolerances: the metric scene table equals JAX's draw exactly (f32). ssim and
svbrdf_metrics: rtol 1e-5 at batch 1, 32^2 (JAX's convolutions at highest
precision, the port's f32 conv2d). summarize / write_metrics: the same JSON.
The grid PNG: the same bytes.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from svbrdf_tpu import metrics as jmetrics
from svbrdf_tpu import viz as jviz
from svbrdf_tpu.ops import sampling as jsampling
from svbrdf_tpu_torch import metrics, viz

torch.set_num_threads(1)


def _svbrdf(rng, n=1, size=32):
    normals = rng.normal(size=(n, size, size, 3)).astype(np.float32)
    normals[..., 2] = np.abs(normals[..., 2]) + 0.5
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    maps = rng.uniform(0.02, 0.98, (n, size, size, 9)).astype(np.float32)
    return np.concatenate([normals, maps], axis=-1)


def test_scene_table_is_the_jax_draw():
    s = jsampling.generate_loss_scenes(
        jax.random.key(jmetrics.METRIC_SCENE_KEY), 1,
        jmetrics.N_RANDOM_SCENES, jmetrics.N_SPECULAR_SCENES)
    mine = metrics.metric_scenes()
    for field in ("camera_pos", "light_pos", "light_color"):
        np.testing.assert_array_equal(getattr(mine, field).numpy(),
                                      np.asarray(getattr(s, field)))


@pytest.mark.parametrize("data_range", [1.0, 2.0])
def test_ssim_matches_jax(data_range):
    rng = np.random.default_rng(int(data_range))
    a = rng.uniform(size=(1, 32, 32, 3)).astype(np.float32)
    b = np.clip(a + 0.1 * rng.normal(size=a.shape), 0, 1).astype(np.float32)
    np.testing.assert_allclose(
        float(metrics.ssim(torch.from_numpy(a), torch.from_numpy(b),
                           data_range)),
        float(jmetrics.ssim(jnp.asarray(a), jnp.asarray(b), data_range)),
        rtol=1e-5)
    assert float(metrics.ssim(torch.from_numpy(a), torch.from_numpy(a))) \
        == pytest.approx(1.0, abs=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_svbrdf_metrics_match_jax(seed):
    rng = np.random.default_rng(seed)
    target = _svbrdf(rng)
    pred = np.clip(target + 0.05 * rng.normal(size=target.shape), -1,
                   1).astype(np.float32)
    pred[..., :3] /= np.linalg.norm(pred[..., :3], axis=-1, keepdims=True)
    mine = metrics.to_python(metrics.svbrdf_metrics(
        torch.from_numpy(pred[0]), torch.from_numpy(target[0])))
    ref = jmetrics.to_python(jmetrics.svbrdf_metrics(
        jnp.asarray(pred[0]), jnp.asarray(target[0])))
    assert sorted(mine) == sorted(ref)
    for key in ref:
        np.testing.assert_allclose(mine[key], ref[key], rtol=1e-5,
                                   err_msg=key)


def test_summary_json_matches_jax(tmp_path):
    per_sample = [{"sample": i, "grid": f"g{i}.png",
                   "metrics": {"rmse_normals": 0.1 * (i + 1),
                               "ssim_diffuse": 0.5 + 0.01 * i}}
                  for i in range(3)]
    assert metrics.summarize(per_sample) == jmetrics.summarize(per_sample)
    assert metrics.summarize([]) == jmetrics.summarize([])
    metrics.write_metrics(tmp_path / "port.json",
                          metrics.summarize(per_sample))
    jmetrics.write_metrics(tmp_path / "jax.json",
                           jmetrics.summarize(per_sample))
    assert (tmp_path / "port.json").read_text() == \
        (tmp_path / "jax.json").read_text()
    assert json.loads((tmp_path / "port.json").read_text())["mean"][
        "rmse_normals"] == pytest.approx(0.2)


def test_comparison_grid_matches_jax(tmp_path):
    rng = np.random.default_rng(4)
    photo = rng.uniform(size=(16, 16, 3)).astype(np.float32)
    gt, pred = _svbrdf(rng, 2, 16)
    viz.save_comparison_grid(str(tmp_path / "port.png"), photo, gt, pred)
    jviz.save_comparison_grid(str(tmp_path / "jax.png"), photo, gt, pred)
    mine = np.asarray(Image.open(tmp_path / "port.png"))
    assert mine.shape == (32, 80, 3)
    np.testing.assert_array_equal(mine,
                                  np.asarray(Image.open(tmp_path / "jax.png")))
    for t, r in zip(viz.svbrdf_to_tiles(gt), jviz.svbrdf_to_tiles(gt)):
        np.testing.assert_array_equal(t, r)
