"""The port's host spans (utils/profiling.span) under a CPU torch.profiler:
the train step's five phases in every step class, the data layer's batch
and cache misses, a prediction call's three parts, and nothing recorded
without a profiler. Tiny shapes: depth 4, 4 filters, 16^2, batch 2.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile

from svbrdf_tpu_torch import losses
from svbrdf_tpu_torch.data import png
from svbrdf_tpu_torch.data.dataset import SvbrdfDataset
from svbrdf_tpu_torch.estimator import SvbrdfEstimator
from svbrdf_tpu_torch.models import build_model
from svbrdf_tpu_torch.parallel import mesh
from svbrdf_tpu_torch.parallel import step as step_lib
from svbrdf_tpu_torch.parallel.spatial import SpatialTrainStep
from svbrdf_tpu_torch.utils import bench_setup
from svbrdf_tpu_torch.utils.profiling import span

torch.set_num_threads(1)

DEPTH, FILTERS, SIZE, BATCH = 4, 4, 16, 2
STEP_SPANS = ("step.prepare", "step.forward", "step.loss", "step.backward",
              "step.optimizer")
PREDICT_SPANS = ("predict.decode", "predict.forward", "predict.encode")
PREP = step_lib.PrepConfig(used_input_image_count=1, use_augmentation=True,
                           is_linear=False, mix_materials=True)


def _profiled(fn):
    """(fn's result, [(name, start_ns, end_ns)] of the host events a CPU
    profiler recorded while it ran, in order of start)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    events = [(e.name(), e.start_ns(), e.end_ns())
              for e in prof.profiler.kineto_results.events()]
    return out, sorted(events, key=lambda e: e[1])


def _named(events, names):
    return [e for e in events if e[0] in names]


@pytest.fixture
def world_one(tmp_path):
    """A world-1 data group over gloo (a file store, no network)."""
    made = not dist.is_initialized()
    if made:
        dist.init_process_group("gloo", init_method=f"file://{tmp_path}/s",
                                rank=0, world_size=1)
    yield mesh.DataGroup(1, 0, 0, torch.device("cpu"), "gloo", 1, None,
                         mesh.COLLECTIVE_TIMEOUT)
    if made:
        dist.destroy_process_group()


def _train_step(kind, group):
    model = build_model("single", False, DEPTH, FILTERS, device="cpu",
                        seed=3)
    optimizer = step_lib.make_optimizer(model.parameters(), 1e-3)
    loss_fn = losses.make_loss_fn("mixed", "local")
    generator = torch.Generator().manual_seed(5)
    if kind == "spatial":
        return SpatialTrainStep(model, optimizer, loss_fn, PREP, generator,
                                None, seed=5)
    return step_lib.make_train_step(model, optimizer, loss_fn, PREP,
                                    generator, seed=5,
                                    group=group if kind == "dp" else None)


@pytest.mark.parametrize("kind", ["plain", "dp", "spatial"])
def test_train_step_shows_its_five_phases_once_a_step_in_order(kind,
                                                                world_one):
    step = _train_step(kind, world_one)
    raw = {k: torch.from_numpy(v) for k, v in
           bench_setup.synthetic_raw_batch(BATCH, SIZE, 0, seed=1).items()}
    losses_, events = _profiled(lambda: [float(step(raw, step=n))
                                         for n in (1, 2)])
    assert all(np.isfinite(losses_))
    spans = _named(events, STEP_SPANS)
    assert [n for n, _, _ in spans] == list(STEP_SPANS) * 2
    for (_, _, end), (_, start, _) in zip(spans, spans[1:]):
        assert end <= start
    # The phases hold the step's work: the model's convolutions run
    # inside step.forward.
    _, f0, f1 = spans[1]
    assert any(n == "aten::convolution" and f0 <= s and e <= f1
               for n, s, e in events)


def _write_strips(directory, count, seed=0):
    """`count` maps-only strips (4 maps of SIZE x SIZE) of random bytes."""
    directory.mkdir()
    rng = np.random.default_rng(seed)
    for n in range(count):
        png.write_png_rgb8(str(directory / f"maps_{n:03d}.png"),
                           rng.integers(0, 256, (SIZE, 4 * SIZE, 3),
                                        dtype=np.uint8))
    return str(directory)


@pytest.mark.parametrize("pool", [False, True])
def test_raw_batch_spans_count_the_cache_misses(tmp_path, pool):
    """A fresh dataset decodes every strip it touches once (the batch and
    its mixing partners, all of the 4 strips), each a data.decode span
    inside the call's data.raw_batch; a repeat of the same indices finds
    every strip cached."""
    with SvbrdfDataset(_write_strips(tmp_path / "strips", 4), SIZE,
                       mix_materials=True, seed=3, use_native_prefetch=pool,
                       prefetch_threads=1) as data:
        indices = [0, 1, 2, 3]
        if pool:
            data.prefetch(indices)
        first, events = _profiled(lambda: data.raw_batch(indices))
        batch = _named(events, ("data.raw_batch",))
        decodes = _named(events, ("data.decode",))
        assert len(batch) == 1 and len(decodes) == 4
        assert len(data._scaled_cache) == 4
        (_, lo, hi), = batch
        assert all(lo <= s and e <= hi for _, s, e in decodes)

        again, events = _profiled(lambda: data.raw_batch(indices))
        assert len(_named(events, ("data.raw_batch",))) == 1
        assert _named(events, ("data.decode",)) == []
    np.testing.assert_array_equal(first["svbrdf"], again["svbrdf"])


def test_predict_to_files_shows_three_parts_and_writes_the_same_bytes(
        tmp_path):
    photo = str(tmp_path / "photo.png")
    png.write_png_rgb8(photo, np.random.default_rng(2).integers(
        0, 256, (SIZE, SIZE, 3), dtype=np.uint8))
    est = SvbrdfEstimator(build_model("single", False, DEPTH, FILTERS,
                                      device="cpu", seed=3))

    def written(out):
        (path,) = est.predict_to_files([photo], str(tmp_path / out))
        with open(path, "rb") as f:
            return f.read()

    plain = written("plain")
    traced, events = _profiled(lambda: [written("a"), written("b")])
    spans = _named(events, PREDICT_SPANS)
    assert [n for n, _, _ in spans] == list(PREDICT_SPANS) * 2
    for (_, _, end), (_, start, _) in zip(spans, spans[1:]):
        assert end <= start
    assert traced == [plain, plain]


def test_span_records_nothing_without_a_profiler():
    for _ in range(1000):
        with span("step.forward"):
            pass
    # A span open when a profiler starts records nothing; neither a
    # profiler's start nor its stop inside a span raises; a span inside
    # the profiler is recorded.
    before = span("step.loss")
    before.__enter__()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        before.__exit__(None, None, None)
        with span("step.backward"):
            torch.ones(2).sum()
        after = span("step.optimizer")
        after.__enter__()
    after.__exit__(None, None, None)
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert names.count("step.backward") == 1
    assert not {"step.forward", "step.loss"} & set(names)
