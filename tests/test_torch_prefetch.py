"""The port's PNG decode pool (svbrdf_tpu_torch/data/prefetch.py) and the
dataset's use of it, on the CPU.

Batches assembled with the pool are byte-equal to those without it, on the
repo's strips and on maps-only strips written by the port, with the host
cache on and off (off: every epoch decodes through the pool), and the host
RNG ends in the same state: the pool changes where a strip is decoded,
never what is drawn. Each pool's workers are gone after close().
"""

import multiprocessing
import pathlib

import numpy as np
import pytest

from svbrdf_tpu_torch.data import png, strips
from svbrdf_tpu_torch.data.dataset import SvbrdfDataset
from svbrdf_tpu_torch.data.prefetch import PrefetchPool

REPO = pathlib.Path(__file__).resolve().parents[1]
TRAIN = str(REPO / "data" / "train")


@pytest.fixture(scope="module")
def maps_dir(tmp_path_factory):
    """Nine maps-only 48 x 192 strips written with the port's PNG
    writer (48^2 tiles: random 32^2 crops have anchors to draw)."""
    out = tmp_path_factory.mktemp("prefetch_maps")
    rng = np.random.default_rng(0)
    for n in range(9):
        png.write_png_rgb8(str(out / f"maps_{n}.png"),
                           rng.integers(0, 256, (48, 192, 3), np.uint8))
    return str(out)


def _epochs(ds, batch_size, epochs=2):
    """The loop's use of a dataset: per epoch a shuffle, the epoch-start
    prefetch, then per batch this batch and the next batch's prefetch."""
    batches = []
    for _ in range(epochs):
        order = np.arange(len(ds))
        ds._host_rng.shuffle(order)
        ds.prefetch(order[:batch_size])
        for lo in range(0, len(order), batch_size):
            batches.append(ds.raw_batch(order[lo:lo + batch_size]))
            ds.prefetch(order[lo + batch_size:lo + 2 * batch_size])
    return batches


@pytest.mark.parametrize("cache_bytes", [1 << 30, 0])
@pytest.mark.parametrize("source", ["train", "maps", "maps_random_crop"])
def test_batches_equal_with_and_without_the_pool(source, cache_bytes,
                                                 maps_dir):
    """Mixing partners are drawn up front and decoded by the pool unless
    random crops draw anchors from the host RNG between them."""
    if source == "train":
        kwargs = dict(data_directory=TRAIN, input_image_count=10,
                      used_input_image_count=1, batch=1)
    else:
        kwargs = dict(data_directory=maps_dir, input_image_count=0,
                      mix_materials=True, batch=2,
                      random_crop=source == "maps_random_crop")
    batch = kwargs.pop("batch")
    common = dict(image_size=32, seed=5, cache_bytes=cache_bytes, **kwargs)
    with SvbrdfDataset(**common) as pooled:
        with_pool = _epochs(pooled, batch)
        assert pooled._pool is not None
        pooled_state = pooled._host_rng.bit_generator.state
    plain = SvbrdfDataset(use_native_prefetch=False, **common)
    without = _epochs(plain, batch)
    assert plain._pool is None
    assert pooled_state == plain._host_rng.bit_generator.state
    assert len(with_pool) == len(without)
    for a, b in zip(with_pool, without):
        assert sorted(a) == sorted(b)
        for key in a:
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_take_decodes_requested_and_unrequested_indices(maps_dir):
    paths = strips.list_sample_files(maps_dir)
    with PrefetchPool(paths, workers=2) as pool:
        assert pool.capacity == 32
        pool.request(3)
        pool.request(3)
        np.testing.assert_array_equal(pool.take(3),
                                      strips.read_image_u8(paths[3]))
        np.testing.assert_array_equal(pool.take(5),
                                      strips.read_image_u8(paths[5]))
        with pytest.raises(IndexError):
            pool.request(len(paths))


def test_requests_beyond_capacity_are_dropped_and_still_taken(maps_dir):
    paths = strips.list_sample_files(maps_dir)[:1] * 40
    with PrefetchPool(paths, workers=1) as pool:
        assert pool.capacity == 32
        for i in range(40):
            pool.request(i)
        assert len(pool._queued) == 32
        for i in range(40):
            np.testing.assert_array_equal(pool.take(i),
                                          strips.read_image_u8(paths[i]))
        assert not pool._queued


def test_a_corrupt_strip_raises_naming_its_file(tmp_path, maps_dir):
    bad = tmp_path / "bad.png"
    bad.write_bytes(png.SIGNATURE + b"not a png")
    good = strips.list_sample_files(maps_dir)[0]
    with PrefetchPool([good, str(bad)], workers=1) as pool:
        pool.request(1)
        with pytest.raises(RuntimeError, match="bad.png"):
            pool.take(1)
        with pytest.raises(RuntimeError, match="bad.png"):
            pool.take(1)  # not requested: decoded in the caller
        assert pool.take(0).shape == (48, 192, 3)


def test_no_worker_outlives_close(maps_dir):
    before = set(multiprocessing.active_children())
    ds = SvbrdfDataset(maps_dir, image_size=32, input_image_count=0)
    ds.prefetch([0, 1, 2])
    ds.raw_batch([0, 1, 2])
    workers = set(multiprocessing.active_children()) - before
    assert workers
    ds.close()
    assert ds._pool is None
    for worker in workers:
        worker.join(timeout=10)
        assert not worker.is_alive()
    assert not set(multiprocessing.active_children()) - before
