"""The port's codecs, renderer and samplers against the JAX package.

Codecs and the renderer are compared by value on the same numpy inputs,
the renderer's autograd gradients against jax.grad; the samplers, whose
random streams differ, by shape, constants and distribution.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svbrdf_tpu.ops import codecs as jcodecs
from svbrdf_tpu.ops import render as jrender
from svbrdf_tpu.ops import sampling as jsampling
from svbrdf_tpu.scene import Scene as JScene
from svbrdf_tpu_torch.ops import codecs, render, sampling
from svbrdf_tpu_torch.scene import Scene
from tests.test_render import random_svbrdf

torch.set_num_threads(1)


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _scenes(seed, batch=2, n_scenes=9):
    """One scene set drawn with the JAX sampler, for both frameworks."""
    js = jsampling.generate_loss_scenes(jax.random.key(seed), batch, 3,
                                        n_scenes - 3)
    fields = [np.asarray(f) for f in (js.camera_pos, js.light_pos,
                                      js.light_color)]
    return js, Scene.make(*fields)


def test_gamma_roundtrip_matches_jax():
    x = np.random.default_rng(0).uniform(0, 1, (4, 8, 8, 3)).astype(np.float32)
    np.testing.assert_allclose(codecs.gamma_decode(_t(x)).numpy(),
                               np.asarray(jcodecs.gamma_decode(x)),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(codecs.gamma_encode(_t(x)).numpy(),
                               np.asarray(jcodecs.gamma_encode(x)),
                               rtol=1e-6, atol=1e-7)


def test_pack_unpack_and_unit_interval_match_jax():
    x = np.random.default_rng(1).uniform(-1, 1, (2, 4, 4, 12)).astype(
        np.float32)
    for encoded, xs in ((False, x), (True, x[..., :9])):
        mine = codecs.unpack_svbrdf(_t(xs), is_encoded=encoded)
        ref = jcodecs.unpack_svbrdf(xs, is_encoded=encoded)
        for a, b in zip(mine, ref):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(
        codecs.pack_svbrdf(*codecs.unpack_svbrdf(_t(x))).numpy(), x)
    np.testing.assert_allclose(
        codecs.encode_as_unit_interval(_t(x)).numpy(),
        np.asarray(jcodecs.encode_as_unit_interval(x)), rtol=1e-7)
    np.testing.assert_allclose(
        codecs.decode_from_unit_interval(_t(x)).numpy(),
        np.asarray(jcodecs.decode_from_unit_interval(x)), rtol=1e-7)


def test_decode_svbrdf_matches_jax():
    x = np.random.default_rng(2).uniform(-1, 1, (2, 8, 8, 9)).astype(
        np.float32)
    np.testing.assert_allclose(codecs.decode_svbrdf(_t(x)).numpy(),
                               np.asarray(jcodecs.decode_svbrdf(x)),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("anchor", [(0, 0), (3, 5), (10, 10)])
def test_crop_square_matches_jax(anchor):
    x = np.random.default_rng(3).uniform(0, 1, (2, 12, 12, 3)).astype(
        np.float32)
    np.testing.assert_array_equal(
        codecs.crop_square(_t(x), anchor, 6).numpy(),
        np.asarray(jcodecs.crop_square(jnp.asarray(x), anchor, 6)))


def test_patch_coords_match_jax():
    np.testing.assert_allclose(render.patch_coords(7, 9).numpy(),
                               np.asarray(jrender.patch_coords(7, 9)),
                               atol=1e-7)


@pytest.mark.parametrize("size", [8, 16])
def test_render_matches_jax(size):
    rng = np.random.default_rng(size)
    sv = random_svbrdf(rng, size, size, batch=(2,))
    js, ts = _scenes(size)
    ref = np.asarray(jrender.render_scene_set(js, jnp.asarray(sv)))
    mine = render.render_scene_set(ts, _t(sv)).numpy()
    assert mine.shape == ref.shape == (2, 9, size, size, 3)
    # The tolerance of the JAX package's own renderer test against the
    # PyTorch reference (tests/test_render.py): GGX highlights near NH = 1
    # amplify last-ulp differences of 1 - NH^2.
    np.testing.assert_allclose(mine, ref, rtol=2e-4, atol=1e-5)


def test_render_gradients_match_jax():
    """Autograd through the plain renderer equals jax.grad of the same
    scalar (a weighted sum of log renders) wrt the SVBRDF and the scene."""
    rng = np.random.default_rng(4)
    sv = random_svbrdf(rng, 8, 8, batch=(2,))
    js, ts = _scenes(4)
    w = rng.uniform(-1, 1, (2, 9, 8, 8, 3)).astype(np.float32)

    def jf(s, light):
        scene = JScene(js.camera_pos, light, js.light_color)
        return jnp.sum(jnp.log(jrender.render_scene_set(scene, s) + 0.1) * w)

    g_sv, g_light = jax.grad(jf, argnums=(0, 1))(jnp.asarray(sv),
                                                 js.light_pos)
    s = _t(sv).requires_grad_()
    light = ts.light_pos.clone().requires_grad_()
    scene = Scene(ts.camera_pos, light, ts.light_color)
    torch.sum(torch.log(render.render_scene_set(scene, s) + 0.1)
              * _t(w)).backward()
    np.testing.assert_allclose(s.grad.numpy(), np.asarray(g_sv), rtol=2e-4,
                               atol=1e-5)
    np.testing.assert_allclose(light.grad.numpy(), np.asarray(g_light),
                               rtol=2e-4, atol=1e-4)


def test_cosine_hemisphere_direction_constants():
    g = torch.Generator().manual_seed(0)
    d = sampling.cosine_hemisphere_direction((4096,), 0.001, 0.1,
                                             generator=g).numpy()
    assert d.shape == (4096, 3)
    np.testing.assert_allclose(np.linalg.norm(d, axis=-1), 1.0, atol=1e-6)
    r_sq = d[:, 0] ** 2 + d[:, 1] ** 2
    assert r_sq.min() >= 0.001 - 1e-6 and r_sq.max() <= 0.9 + 1e-6
    assert (d[:, 2] > 0).all()


def _quantiles(x):
    return np.quantile(x, [0.25, 0.5, 0.75], axis=0)


def test_loss_scenes_match_jax_distribution():
    """3 random + 6 specular scenes per item: same layout and constants as
    the JAX sampler, and the same distribution (quartiles of every field,
    and the view/light x correlation that the (-1, -1, 1) mirror sets)."""
    n = 4096
    g = torch.Generator().manual_seed(1)
    mine = sampling.generate_loss_scenes(n, 3, 6, generator=g)
    ref = jsampling.generate_loss_scenes(jax.random.key(1), n, 3, 6)
    assert mine.camera_pos.shape == mine.light_pos.shape == (n, 9, 3)
    color = mine.light_color.numpy()
    np.testing.assert_array_equal(color[:, :3], 20.0)
    np.testing.assert_array_equal(color[:, 3:], 50.0)
    cam = mine.camera_pos.numpy()
    assert (cam[:, 3:, 2] > 1e-4).all()
    for kind in (slice(0, 3), slice(3, 9)):
        for field_m, field_r in ((mine.camera_pos, ref.camera_pos),
                                 (mine.light_pos, ref.light_pos)):
            a = field_m.numpy()[:, kind].reshape(-1, 3)
            b = np.asarray(field_r)[:, kind].reshape(-1, 3)
            np.testing.assert_allclose(_quantiles(a), _quantiles(b),
                                       atol=0.05, rtol=0.05)
        corr_m = np.corrcoef(cam[:, kind, 0].ravel(),
                             mine.light_pos.numpy()[:, kind, 0].ravel())[0, 1]
        corr_r = np.corrcoef(
            np.asarray(ref.camera_pos)[:, kind, 0].ravel(),
            np.asarray(ref.light_pos)[:, kind, 0].ravel())[0, 1]
        assert abs(corr_m - corr_r) < 0.05, (corr_m, corr_r)


def test_samplers_follow_the_generator():
    """Same seed, same scenes; another seed, other scenes."""
    def draw(seed):
        g = torch.Generator().manual_seed(seed)
        return sampling.generate_loss_scenes(2, generator=g).camera_pos

    assert torch.equal(draw(5), draw(5))
    assert not torch.equal(draw(5), draw(6))
