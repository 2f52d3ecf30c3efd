"""The perspective half of the port's viz (svbrdf_tpu_torch/viz.py) and its
GIF writer (svbrdf_tpu_torch/data/gif.py) against the JAX package's
svbrdf_tpu/viz.py, on the CPU.

Tolerances: the homography, the warp and the mapping are the same float64
numpy code: 1e-12; the turntable frames render through the two renderers
(f32, other roundings) and the same warp: 1e-5. The GIF is read back with
Pillow here, in the test only (the port itself never imports it): its
frame count, delays and loop, and its frames within one palette step of
the input (a level of 255/7 for red and green, 255/3 for blue; each
channel goes to its nearest level, so within half of that).
"""

import numpy as np
import pytest
import torch

from svbrdf_tpu import viz as jviz
from svbrdf_tpu_torch import viz
from svbrdf_tpu_torch.data import gif, strips
from tests.test_render import random_svbrdf

torch.set_num_threads(1)

# One palette step of each channel, in 8-bit levels.
STEP = np.array([255 / 7, 255 / 7, 255 / 3])


def test_find_homography_matches_jax():
    rng = np.random.default_rng(0)
    src = np.array([[0, 0], [0, 32], [32, 32], [32, 0]], np.float64)
    dst = src + rng.uniform(-6, 6, src.shape)
    np.testing.assert_allclose(viz.find_homography(src, dst),
                               jviz.find_homography(src, dst), rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("camera", [[0.0, -1.0, 2.0], [1.2, 0.4, 1.5],
                                    [0.0, 0.0, 2.0]])
def test_mapping_and_warp_match_jax(camera):
    rng = np.random.default_rng(1)
    img = rng.uniform(0, 1, (32, 32, 3)).astype(np.float32)
    mine = viz.OrthoToPerspectiveMapping(camera, (48, 40))
    ref = jviz.OrthoToPerspectiveMapping(camera, (48, 40))
    np.testing.assert_allclose(mine.get_homography((32, 32)),
                               ref.get_homography((32, 32)), rtol=0,
                               atol=1e-12)
    for t in (0.0, 0.5, 1.0):
        out = mine.apply(img, t)
        assert out.shape == (40, 48, 3) and out.dtype == np.float32
        np.testing.assert_allclose(out, ref.apply(img, t), rtol=0,
                                   atol=1e-12)
    H = mine.get_homography((32, 32))
    np.testing.assert_allclose(viz.warp_perspective(img, H, (48, 40)),
                               jviz.warp_perspective(img, H, (48, 40)),
                               rtol=0, atol=1e-12)


def test_turntable_frames_match_jax():
    """4 frames of a 32^2 map on a 48^2 sensor."""
    sv = random_svbrdf(np.random.default_rng(2), 32, 32)
    mine = viz.turntable_frames(sv, n_frames=4, sensor_size=(48, 48),
                                device="cpu")
    ref = jviz.turntable_frames(sv, n_frames=4, sensor_size=(48, 48))
    assert len(mine) == 4
    for a, b in zip(mine, ref):
        assert a.shape == (48, 48, 3) and a.dtype == np.float32
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
    assert max(float(f.mean()) for f in mine) > 0.05  # lit, not black


def _pillow_frames(path):
    from PIL import Image

    im = Image.open(path)
    frames, delays = [], []
    for k in range(im.n_frames):
        im.seek(k)
        delays.append(im.info["duration"])
        frames.append(np.asarray(im.convert("RGB"), np.int64))
    return im, frames, delays


@pytest.mark.parametrize("fps, delay_cs", [(15, 7), (10, 10), (4, 25)])
def test_save_animation_reads_back(tmp_path, fps, delay_cs):
    rng = np.random.default_rng(3)
    frames = [rng.uniform(0, 1, (24, 40, 3)).astype(np.float32)
              for _ in range(3)]
    path = str(tmp_path / "a.gif")
    viz.save_animation(path, frames, fps=fps)
    info = gif.gif_info(path)
    assert info == {"size": (40, 24), "frames": 3,
                    "delays_cs": [delay_cs] * 3, "loop": 0}
    im, decoded, delays = _pillow_frames(path)
    assert im.info.get("loop") == 0 and delays == [10 * delay_cs] * 3
    for got, want in zip(decoded, frames):
        want8 = np.uint8(np.clip(want, 0, 1) * 255).astype(np.int64)
        assert got.shape == (24, 40, 3)
        assert (np.abs(got - want8) <= STEP / 2 + 0.5).all()


def test_lzw_past_a_full_table(tmp_path):
    """A frame of noise fills the 4096-entry table several times over (the
    clear code mid-stream) and an even frame stays small; both decode to
    their palette colours exactly."""
    rng = np.random.default_rng(4)
    noise = rng.integers(0, 256, (160, 200, 3), dtype=np.uint8)
    flat = np.full((160, 200, 3), 200, np.uint8)
    path = str(tmp_path / "n.gif")
    gif.write_gif(path, [noise, flat], delay_cs=5)
    _, decoded, _ = _pillow_frames(path)
    pal = gif.palette().astype(np.int64)
    for got, want in zip(decoded, (noise, flat)):
        np.testing.assert_array_equal(got, pal[gif.quantize(want)])
    assert gif.palette().shape == (256, 3)


def test_make_training_video(tmp_path):
    paths = []
    for k in range(2):
        p = str(tmp_path / f"e{k}.png")
        strips.write_image(p, np.full((8, 16, 3), 0.25 * (k + 1)))
        paths.append(p)
    viz.make_training_video(paths, str(tmp_path / "v.gif"))
    assert gif.gif_info(str(tmp_path / "v.gif"))["frames"] == 2


def test_write_gif_rejects_mixed_sizes(tmp_path):
    with pytest.raises(ValueError, match="frames must all be"):
        gif.write_gif(str(tmp_path / "x.gif"),
                      [np.zeros((4, 4, 3), np.uint8),
                       np.zeros((4, 5, 3), np.uint8)], 5)
