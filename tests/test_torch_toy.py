"""The port's toy dataset (svbrdf_tpu_torch/data/toy.py) against the JAX
package's (svbrdf_tpu/data/toy.py), on the CPU.

Tolerances: the maps bit-equal (the same numpy calls in the same order);
maps-only strips equal to the byte; photos rendered under JAX's own
scenes within 1 u8 level (the two renderers round differently in f32, and
a value within rounding of a level's edge truncates to either side).
"""

import jax
import numpy as np
import pytest
import torch

from svbrdf_tpu.data import pipeline as jpipeline
from svbrdf_tpu.data import toy as jtoy
from svbrdf_tpu_torch.data import strips, toy
from svbrdf_tpu_torch.scene import Scene

torch.set_num_threads(1)


@pytest.mark.parametrize("seed, size", [(0, 32), (313, 64), (7, 16)])
def test_make_toy_svbrdf_bit_equal(seed, size):
    mine = toy.make_toy_svbrdf(np.random.default_rng(seed), size)
    ref = jtoy.make_toy_svbrdf(np.random.default_rng(seed), size)
    assert mine.dtype == np.float32 and mine.shape == (size, size, 12)
    np.testing.assert_array_equal(mine, ref)


def test_maps_only_dataset_equal_to_jax(tmp_path):
    """generate_toy_dataset(n_inputs=0) at 32^2: the same files, decoded
    pixels equal."""
    mine = toy.generate_toy_dataset(str(tmp_path / "port"), 2, 1, 32, 0,
                                    seed=5, device="cpu")
    ref = jtoy.generate_toy_dataset(str(tmp_path / "jax"), 2, 1, 32, 0,
                                    seed=5)
    assert [p.split("port/")[1] for p in mine] == \
        [p.split("jax/")[1] for p in ref]
    for a, b in zip(mine, ref):
        x, y = strips.read_image_u8(a), strips.read_image_u8(b)
        assert x.shape == (32, 4 * 32, 3)
        np.testing.assert_array_equal(x, y)


def test_photos_under_jax_scenes_within_one_level():
    """render_photos under JAX's scenes of a strip seed: the photos within
    1 u8 level of the JAX strip's."""
    rng = np.random.default_rng(11)
    sv = jtoy.make_toy_svbrdf(rng, 32)
    seed, n = 1234, 4
    js = jpipeline.generate_input_scenes(jax.random.key(seed), n,
                                         use_augmentation=False)
    scenes = Scene.make(np.asarray(js.camera_pos), np.asarray(js.light_pos),
                        np.asarray(js.light_color))
    mine = toy.render_photos(sv, scenes, device="cpu")
    ref = jtoy.render_strip(sv, n, seed)[:, :n * 32]
    assert mine.shape == (n, 32, 32, 3)
    mine_u8 = np.uint8(np.clip(np.concatenate(list(mine), axis=1), 0, 1)
                       * 255.0).astype(int)
    ref_u8 = np.uint8(np.clip(ref, 0, 1) * 255.0).astype(int)
    assert np.abs(mine_u8 - ref_u8).max() <= 1
    # The photos are lit, not black.
    assert mine.mean() > 0.05


def test_strip_layout_and_cli(tmp_path):
    """A strip with photos: (H, (n + 4) W, 3), the maps' tiles as JAX's
    strip holds them; `main` writes train/ and test/."""
    sv = toy.make_toy_svbrdf(np.random.default_rng(2), 16)
    strip = toy.render_strip(sv, 3, seed=9, device="cpu")
    assert strip.shape == (16, 7 * 16, 3)
    assert 0.0 <= strip.min() and strip.max() <= 1.0
    np.testing.assert_array_equal(strip[:, 3 * 16:],
                                  jtoy.render_strip(sv, 0, 9))
    toy.main([str(tmp_path / "d"), "--size", "16", "--train", "1",
              "--test", "1", "--inputs", "2", "--device", "cpu"])
    for split in ("train", "test"):
        (path,) = (tmp_path / "d" / split).iterdir()
        assert strips.read_image_u8(str(path)).shape == (16, 6 * 16, 3)


def test_device_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    sv = toy.make_toy_svbrdf(np.random.default_rng(0), 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        toy.render_strip(sv, 1, seed=0)
