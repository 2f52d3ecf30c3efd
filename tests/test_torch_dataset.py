"""The port's host data path against the JAX package: host scaling
(data/pipeline.py), SvbrdfDataset, the validation split, and the device
cache (here on the CPU).

Tolerances: uint8 batches, partners, split indices: equal. Float batches of
resize mode and the scaling functions: atol 1e-6 (torch's bilinear
interpolate against the JAX package's separable resize, both f32). Test
mode's prepared items: atol 1e-6 (gamma decode, torch.pow against
jnp.power).
"""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svbrdf_tpu.data import pipeline as jpipeline
from svbrdf_tpu.data.dataset import SvbrdfDataset as JaxDataset
from svbrdf_tpu.data.dataset import \
    split_train_validation as jsplit_train_validation
from svbrdf_tpu_torch.data import pipeline, png, strips
from svbrdf_tpu_torch.data.dataset import (SvbrdfDataset,
                                           split_train_validation)
from svbrdf_tpu_torch.data.device_cache import DeviceDataCache

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
TRAIN = str(REPO / "data" / "train")
TEST = str(REPO / "data" / "test")


def write_maps_only(out_dir: pathlib.Path, tile: int, count: int) -> str:
    """`count` maps-only strips (normals | diffuse | roughness | specular,
    tile x tile each), cut from the repo's training strips at shifting
    offsets, written with the port's writer."""
    out_dir.mkdir(parents=True, exist_ok=True)
    sources = [strips.read_image_u8(p)
               for p in strips.list_sample_files(TRAIN)]
    for n in range(count):
        src = sources[n % len(sources)]
        off = (7 * n) % (256 - tile)
        maps = [src[off:off + tile, (10 + k) * 256 + off:
                    (10 + k) * 256 + off + tile] for k in range(4)]
        png.write_png_rgb8(str(out_dir / f"maps_{n:03d}.png"),
                           np.concatenate(maps, axis=1))
    return str(out_dir)


@pytest.fixture(scope="module")
def maps_dir(tmp_path_factory):
    return write_maps_only(tmp_path_factory.mktemp("maps"), 64, 5)


@pytest.mark.parametrize("shape,size", [((2, 40, 56, 3), 32),
                                        ((37, 29, 12), 16),
                                        ((3, 20, 20, 3), 32)])
def test_scaling_functions_match_jax(shape, size):
    x = np.random.default_rng(size).uniform(size=shape).astype(np.float32)
    crop = pipeline.center_crop_to_square(torch.from_numpy(x))
    np.testing.assert_array_equal(crop.numpy(),
                                  jpipeline.center_crop_to_square(x))
    np.testing.assert_allclose(
        pipeline.resize_bilinear(crop, size).numpy(),
        np.asarray(jpipeline.resize_bilinear(jnp.asarray(crop.numpy()),
                                             size=size)), atol=1e-6, rtol=0)


@pytest.mark.parametrize("mode,anchor", [("resize", (0, 0)),
                                         ("crop", (3, 5)), ("crop", (40, 1))])
def test_scale_sample_matches_jax(mode, anchor):
    rng = np.random.default_rng(3)
    images = rng.uniform(size=(2, 48, 60, 3)).astype(np.float32)
    svbrdf = rng.uniform(size=(48, 60, 12)).astype(np.float32)
    mine = pipeline.scale_sample(torch.from_numpy(images),
                                 torch.from_numpy(svbrdf), 24, mode, anchor)
    ref = jpipeline.scale_sample(images, svbrdf, 24, mode, anchor)
    for m, r in zip(mine, ref):
        np.testing.assert_allclose(m.numpy(), np.asarray(r), atol=1e-6,
                                   rtol=0)


@pytest.mark.parametrize("n", [1, 2, 99, 100, 101, 1000])
def test_split_is_identical(n):
    for mine, ref in zip(split_train_validation(n, 0.01, 7),
                         jsplit_train_validation(n, 0.01, 7)):
        np.testing.assert_array_equal(mine, ref)


CASES = {
    # name: (directory, image_count, used, size, scale_mode, random_crop)
    "photos_crop": ("train", 10, 1, 64, "crop", False),
    "photos_crop_3_used": ("train", 10, 3, 32, "crop", False),
    "photos_resize": ("train", 10, 2, 64, "resize", False),
    "maps_mixing": ("maps", 0, 1, 32, "crop", False),
    "maps_mixing_random_crop": ("maps", 0, 1, 32, "crop", True),
    "maps_mixing_resize": ("maps", 0, 1, 32, "resize", False),
}


def _pair(case, maps_dir, seed=11):
    directory, count, used, size, mode, random_crop = CASES[case]
    kwargs = dict(data_directory=TRAIN if directory == "train" else maps_dir,
                  image_size=size, scale_mode=mode, input_image_count=count,
                  used_input_image_count=used, mix_materials=True,
                  random_crop=random_crop, seed=seed)
    return (SvbrdfDataset(**kwargs),
            JaxDataset(**kwargs, use_native_prefetch=False))


@pytest.mark.parametrize("case", list(CASES))
def test_raw_batches_match_jax(case, maps_dir):
    """Shuffle, then batches: the same bytes (floats in resize mode) and
    the same mixing partners, call after call."""
    mine, ref = _pair(case, maps_dir)
    assert len(mine) == len(ref) and mine.mix_materials == ref.mix_materials
    orders = []
    for ds in (mine, ref):
        order = np.arange(len(ds))
        ds._host_rng.shuffle(order)
        orders.append(order)
    np.testing.assert_array_equal(*orders)
    for lo, hi in ((0, 2), (1, 3), (0, 2)):
        a = mine.raw_batch(orders[0][lo:hi])
        b = ref.raw_batch(orders[1][lo:hi])
        assert sorted(a) == sorted(b)
        for key in a:
            assert a[key].dtype == b[key].dtype, key
            np.testing.assert_allclose(a[key], b[key], atol=1e-6, rtol=0,
                                       err_msg=key)


def test_test_mode_items_match_jax():
    """Test mode: photos read, no mixing and no synthesis, so the prepared
    item is deterministic in both packages."""
    kwargs = dict(data_directory=TEST, image_size=32, input_image_count=10,
                  used_input_image_count=1, mix_materials=False)
    mine = SvbrdfDataset(**kwargs)[0]
    ref = JaxDataset(**kwargs, use_native_prefetch=False)[0]
    for key in ("inputs", "svbrdf"):
        assert mine[key].shape == ref[key].shape
        np.testing.assert_allclose(mine[key], ref[key], atol=1e-6, rtol=0)


def test_items_with_synthesis_and_mixing(maps_dir):
    """Maps only: mixing and the synthesized photo are drawn from the
    dataset's generator, so equal seeds give equal items."""
    def item(seed):
        return SvbrdfDataset(maps_dir, image_size=32, input_image_count=0,
                             used_input_image_count=2, mix_materials=True,
                             seed=seed)[1]

    a, b, c = item(5), item(5), item(6)
    assert a["inputs"].shape == (2, 32, 32, 3)
    assert a["svbrdf"].shape == (32, 32, 12)
    assert np.isfinite(a["inputs"]).all() and np.isfinite(a["svbrdf"]).all()
    np.testing.assert_array_equal(a["inputs"], b["inputs"])
    assert not np.array_equal(a["inputs"], c["inputs"])


def test_strip_caches_respect_their_budget():
    ds = SvbrdfDataset(TRAIN, image_size=32, input_image_count=10,
                       cache_bytes=1 << 30)
    ds.raw_batch([0, 1])
    assert len(ds._scaled_cache) == 2 and ds._cache_used > 0
    none = SvbrdfDataset(TRAIN, image_size=32, input_image_count=10,
                         cache_bytes=0)
    none.raw_batch([0, 1])
    assert not none._scaled_cache and none._cache_used == 0


@pytest.mark.parametrize("case", ["photos_crop", "maps_mixing"])
def test_device_cache_serves_the_datasets_batches(case, maps_dir):
    host, _ = _pair(case, maps_dir)
    cached, _ = _pair(case, maps_dir)
    cache = DeviceDataCache(cached, device="cpu")
    assert len(cache) == len(host)
    assert cache.nbytes == sum(a.nbytes for a in cache._store.values())
    for idx in ([0, 1], [1, 1], [1, 0]):
        a = host.raw_batch(idx)
        b = cache.raw_batch(idx)
        assert sorted(a) == sorted(b)
        for key in a:
            assert b[key].dtype == torch.uint8
            np.testing.assert_array_equal(a[key], b[key].numpy(),
                                          err_msg=key)


@pytest.mark.parametrize("case,kwargs,message", [
    ("photos_resize", {}, "uint8 fast path"),
    ("maps_mixing_random_crop", {}, "random crops"),
    ("photos_crop", {"max_bytes": 1000}, "budget"),
])
def test_device_cache_rejects_what_the_jax_cache_rejects(case, kwargs,
                                                         message, maps_dir):
    with pytest.raises(ValueError, match=message):
        DeviceDataCache(_pair(case, maps_dir)[0], device="cpu", **kwargs)
