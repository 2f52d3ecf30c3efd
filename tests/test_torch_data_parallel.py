"""Data-parallel training in the port (parallel/mesh, the data-parallel
step, the dataset's rows) on the CPU, over gloo, against world size 1, the
JAX package's helpers and the JAX step.

Depth 5, 32^2, 8 filters, global batch 4, 5 steps; world size 2 runs two
spawned ranks (bench_setup.data_parallel_runs, every program of the module
in one spawn), under a time limit. Tolerances, from these CPU runs (the
measured worst in brackets):
  - world 2 against world 1 in f32, each step's loss rel 1e-5 (single view
    1.3e-7, multi view 5.0e-6, path-traced 1.2e-7); the update theta_5 -
    theta_0 normwise 1e-4 for the single-view paths (1.6e-5, path-traced
    4.3e-5) and 5e-2 for the multi-view one (1.5e-2): its max-pool over the
    views routes a gradient to one view of a near-tie, so its first
    gradient already differs 2.7e-5 normwise (the single view's 1.0e-6),
    and Adam's first steps, about lr * sign(g), magnify that where a
    gradient is near 0 (3.2e-3 after one step);
  - bf16 compute with bf16-SR masters, single and multi view, the loss rel
    2^-7, one bf16 ulp (2.0e-4, 4.0e-4): an SR rounding that a last-bit
    change of the update flips moves a master by a whole bf16 ulp;
  - the replicas bit-identical across ranks, always; world size 1 through
    a process group bit-equal to the plain step;
  - the world-2 step against the JAX step assembled from public pieces
    (tests/test_torch_step.py's, dropout off, JAX at highest matmul
    precision) on the same global batch and injected scenes: loss rtol
    1e-4 over 3 steps (test_torch_step's: the two differ in convolution
    order).
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from svbrdf_tpu.data import dataset as jdataset
from svbrdf_tpu.parallel import mesh as jmesh
from svbrdf_tpu.training import loop as jloop
from svbrdf_tpu_torch.data import dataset as dataset_lib
from svbrdf_tpu_torch.data.device_cache import DeviceDataCache
from svbrdf_tpu_torch.interop.jax_params import params_from_jax
from svbrdf_tpu_torch.parallel import dryrun, mesh
from svbrdf_tpu_torch.training import loop
from svbrdf_tpu_torch.utils import bench_setup
from tests.test_torch_cli import _maps_only
from tests.test_torch_step import (DEPTH, FILTERS, SIZE, _jax_loss,
                                   _port_scene, parity)  # noqa: F401

torch.set_num_threads(1)

STEPS, TIMEOUT = 5, 120
SMALL = dict(batch=4, size=32, depth=5, num_filters=8, seed=0,
             device="cpu")
PATHS = {
    # name: (program, loss rel, update normwise; None: not held)
    "single_mixed": (dict(model_kind="single", loss_kind="mixed"),
                     1e-5, 1e-4),
    "multi_rendering": (dict(model_kind="multi", loss_kind="rendering"),
                        1e-5, 5e-2),
    "single_mixed_pathtracing": (dict(model_kind="single",
                                      loss_kind="mixed",
                                      renderer="pathtracing", spp=(4, 2)),
                                 1e-5, 1e-4),
    "single_mixed_bf16sr": (dict(model_kind="single", loss_kind="mixed",
                                 dtype=torch.bfloat16,
                                 master_dtype="bf16sr"), 2.0 ** -7, None),
    "multi_rendering_bf16sr": (dict(model_kind="multi",
                                    loss_kind="rendering",
                                    dtype=torch.bfloat16,
                                    master_dtype="bf16sr"), 2.0 ** -7, None),
}


@pytest.fixture
def one_thread(monkeypatch):
    """Spawned ranks start with one intra-op thread each."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def _jax_job(parity):
    """The world-2 job of test_world_two_step_matches_jax: JAX's weights,
    the rows of the global batch, the injected global scenes."""
    program = dict(model_kind="single", loss_kind="mixed",
                   batch=len(parity["batch"]["svbrdf"]), size=SIZE,
                   depth=DEPTH, num_filters=FILTERS, device="cpu")
    state = params_from_jax(jax.tree.map(np.asarray, parity["params"]))
    return ((program, 3), dict(
        state=state, batch=parity["batch"],
        scenes=[_port_scene(s) for s in parity["scenes"]]))


@pytest.fixture(scope="module")
def world_two(parity):
    """Rank 0's results of every world-2 program of the module, run in one
    spawn of two ranks: PATHS by name, and "jax"."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        jobs = [((dict(SMALL, **PATHS[name][0]), STEPS), {})
                for name in PATHS] + [_jax_job(parity)]
        results = bench_setup.data_parallel_runs(2, jobs, timeout=TIMEOUT)
    return dict(zip(list(PATHS) + ["jax"], results))


def update_normwise(run, ref) -> float:
    """|| (theta_k - theta_0) - (ref's) || / || ref's ||, over every leaf."""
    num = sum(float(((b - a) - (rb - ra)).double().norm() ** 2)
              for a, b, ra, rb in zip(run["params0"], run["params"],
                                      ref["params0"], ref["params"]))
    den = sum(float((rb - ra).double().norm() ** 2)
              for ra, rb in zip(ref["params0"], ref["params"]))
    return (num / den) ** 0.5


@pytest.mark.parametrize("batch", range(1, 17))
def test_group_size_and_local_batch_match_jax(batch, monkeypatch):
    """_mesh_size_for_batch for 1-8 devices, local_batch_size for 1-3
    processes (JAX's reads jax.process_count()), the same values or the
    same refusal."""
    for n in range(1, 9):
        assert (loop._mesh_size_for_batch(batch, n)
                == jloop._mesh_size_for_batch(batch, n))
    for pc in (1, 2, 3):
        monkeypatch.setattr(jax, "process_count", lambda pc=pc: pc)
        if batch % pc:
            with pytest.raises(ValueError, match="divisible"):
                jmesh.local_batch_size(batch)
            with pytest.raises(ValueError, match="divisible"):
                mesh.local_batch_size(batch, pc)
        else:
            assert (mesh.local_batch_size(batch, pc)
                    == jmesh.local_batch_size(batch))


@pytest.mark.parametrize("process_count", [1, 2, 3])
def test_file_shards_and_seeds_match_jax(tmp_path, process_count,
                                         monkeypatch, capsys):
    """Each process's file shard (shard_files_for_host) and its host RNG
    (seed * 1000 + process index) against the JAX dataset's with
    shard_across_hosts, and the "k of n files" line."""
    data = _maps_only(tmp_path / "maps", 7)
    paths = [f"f{i:02d}" for i in range(11)][::-1]
    monkeypatch.setattr(jax, "process_count", lambda: process_count)
    for pi in range(process_count):
        assert (dataset_lib.shard_files_for_host(paths, pi, process_count)
                == jdataset.shard_files_for_host(paths, pi, process_count))
        monkeypatch.setattr(jax, "process_index", lambda pi=pi: pi)
        ref = jdataset.SvbrdfDataset(data, 32, input_image_count=0,
                                     mix_materials=True, seed=5,
                                     use_native_prefetch=False,
                                     shard_across_hosts=True)
        capsys.readouterr()
        mine = dataset_lib.SvbrdfDataset(data, 32, input_image_count=0,
                                         mix_materials=True, seed=5,
                                         use_native_prefetch=False,
                                         process_index=pi,
                                         process_count=process_count)
        assert mine.file_paths == ref.file_paths
        assert mine.global_file_count == ref.global_file_count == 7
        np.testing.assert_array_equal(mine._host_rng.integers(0, 99, 8),
                                      ref._host_rng.integers(0, 99, 8))
        out = capsys.readouterr().out
        shard = len(mine.file_paths)
        assert (f"Host {pi}/{process_count}: {shard} of 7 files" in out) == (
            process_count > 1)


def test_group_helpers_refuse_truncation_and_warn():
    """make_mesh refuses more ranks than devices (the card count injected);
    the training group warns when the batch idles devices; a rank's rows
    need an even split."""
    assert mesh.make_mesh(2, "cuda", available=2) == [
        torch.device("cuda", 0), torch.device("cuda", 1)]
    with pytest.raises(ValueError, match="requested a 3-device group but "
                                         "only 2 cuda"):
        mesh.make_mesh(3, "cuda", available=2)
    with pytest.raises(ValueError, match="at least 1"):
        mesh.make_mesh(0, "cpu")
    assert mesh.make_mesh(3, "cpu") == [torch.device("cpu")] * 3
    with pytest.raises(ValueError, match="only 2 cuda"):
        loop._make_training_mesh(8, 3, "cuda", available=2)
    with pytest.warns(UserWarning, match="IDLING 1"):
        assert loop._make_training_mesh(8, 3, "cpu") == 2
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert loop._make_training_mesh(8, 4, "cuda", available=4) == 4
    group = mesh.DataGroup(2, 1, 1, torch.device("cpu"), "gloo", 1, None,
                           mesh.COLLECTIVE_TIMEOUT)
    assert group.rows(8) == slice(4, 8)
    with pytest.raises(ValueError, match="divisible by the world size"):
        group.rows(7)


def _dataset(data):
    return dataset_lib.SvbrdfDataset(data, 32, input_image_count=0,
                                     mix_materials=True, seed=3,
                                     use_native_prefetch=False)


@pytest.mark.parametrize("world", [2, 4])
def test_rows_of_a_batch_are_world_one_batch(tmp_path, world):
    """The ranks' rows of raw_batch (host path and device cache)
    concatenated are byte-equal to world 1's batch, and every rank's host
    RNG ends where world 1's does; skip_batch advances it as raw_batch."""
    data = _maps_only(tmp_path / "maps", 9)
    idx = np.array([4, 0, 7, 7, 2, 8, 1, 5])
    ref = _dataset(data)
    whole = ref.raw_batch(idx)
    for make in (lambda d: d, lambda d: DeviceDataCache(d, "cpu")):
        ranks = [_dataset(data) for _ in range(world)]
        sources = [make(d) for d in ranks]
        n = len(idx) // world
        parts = [src.raw_batch(idx, slice(r * n, (r + 1) * n))
                 for r, src in enumerate(sources)]
        for key in ("inputs", "svbrdf", "partner_svbrdf"):
            np.testing.assert_array_equal(
                np.concatenate([np.asarray(p[key]) for p in parts]),
                whole[key])
        for d in ranks:
            assert (d._host_rng.bit_generator.state
                    == ref._host_rng.bit_generator.state)
    skipped = _dataset(data)
    skipped.raw_batch(idx[:3])
    skipped.skip_batch(idx[:5])
    again = _dataset(data)
    again.raw_batch(idx[:3])
    again.raw_batch(idx[:5])
    assert (skipped._host_rng.bit_generator.state
            == again._host_rng.bit_generator.state)


@pytest.mark.parametrize("path", list(PATHS))
def test_world_two_matches_world_one(path, world_two):
    """World 2 on the same global batch against world 1: each step's loss,
    the update, the replicas bit-identical (module docstring)."""
    program, loss_rtol, update_tol = PATHS[path]
    one = bench_setup.train_steps(dict(SMALL, **program), STEPS)
    two = world_two[path]
    assert two["backend"] == "gloo"
    assert len(set(two["checksums"])) == 1
    np.testing.assert_allclose(two["losses"], one["losses"],
                               rtol=loss_rtol)
    if update_tol is not None:
        assert update_normwise(two, one) <= update_tol
    assert len(set(one["losses"])) == STEPS  # the weights moved


def test_world_two_step_matches_jax(parity, world_two):
    """Three world-2 steps with JAX's weights, on the rows of the global
    batch and the global injected scenes, against the JAX step
    (test_torch_step.test_train_step_matches_jax's) on the whole batch."""
    batch = parity["batch"]
    loss_of = _jax_loss(parity["jmodel"], jnp.asarray(batch["inputs"].numpy()),
                        batch["svbrdf"].numpy())
    opt = optax.adam(1e-5)
    params = parity["params"]
    opt_state = opt.init(params)
    jax_losses = []
    with jax.default_matmul_precision("highest"):
        value_and_grad = jax.jit(jax.value_and_grad(loss_of))
        for scenes in parity["scenes"]:
            loss, grads = value_and_grad(params, scenes)
            updates, opt_state = opt.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            jax_losses.append(float(loss))
    two = world_two["jax"]
    assert len(set(two["checksums"])) == 1
    np.testing.assert_allclose(two["losses"], jax_losses, rtol=1e-4)
    assert len(set(two["losses"])) == 3  # the weights moved between steps


def test_world_one_group_is_the_plain_step(one_thread):
    """The data-parallel step at world size 1 (what the launcher runs on
    one card) draws what the plain step draws: bit-equal losses and
    weights."""
    program = dict(SMALL, model_kind="single", loss_kind="mixed")
    plain = bench_setup.train_steps(program, 3)
    (group,) = bench_setup.data_parallel_runs(1, [((program, 3), {})],
                                              timeout=TIMEOUT)
    assert group["losses"] == plain["losses"]
    for a, b in zip(group["params"], plain["params"]):
        assert torch.equal(a, b)


def test_dryrun_runs_on_two_ranks(monkeypatch, capfd):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    loss = dryrun.run(2, "cpu", timeout=TIMEOUT)
    assert np.isfinite(loss)
    out = capfd.readouterr().out
    assert out.count("batch-DP single-step program OK") == 2
    assert "replicas bit-identical" in out
    # Then the spatial step in the same ranks, as the JAX dry run runs it.
    assert out.count("spatial (H split over 2 ranks") == 2


def test_dryrun_runs_on_the_cards_unless_asked_for_the_cpu(monkeypatch):
    """Without --cpu the dry run takes one card a rank: with fewer cards
    than ranks it raises before a rank starts, never falling back to the
    CPU."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="2-device group but only 1 cuda"):
        dryrun.run(2)
    with pytest.raises(ValueError, match="2-device group but only 1 cuda"):
        dryrun.main(["2"])


@pytest.mark.parametrize("program", [dict(SMALL, device="cuda"),
                                     {k: v for k, v in SMALL.items()
                                      if k != "device"}],
                         ids=["cuda", "default"])
def test_data_parallel_runs_take_the_programs_device(program, monkeypatch):
    """The ranks run where the jobs' programs ask (build_program's default
    is the card): a program on the card beside one on the CPU is refused,
    and a card program alone needs the cards, never falling back to CPU
    ranks."""
    with pytest.raises(ValueError, match=r"\['cpu', 'cuda'\]"):
        bench_setup.data_parallel_runs(
            2, [((dict(SMALL), 1), {}), ((program, 1), {})],
            timeout=TIMEOUT)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(ValueError, match="2-device group but only 0 cuda"):
        bench_setup.data_parallel_runs(2, [((program, 1), {})],
                                       timeout=TIMEOUT)


def test_build_program_refuses_a_device_other_than_the_groups():
    group = mesh.DataGroup(world=1, rank=0, local_rank=0,
                           device=torch.device("cuda", 0), backend="nccl",
                           process_count=1, host_group=None,
                           timeout=mesh.COLLECTIVE_TIMEOUT)
    with pytest.raises(ValueError, match="not the data group's"):
        bench_setup.build_program("single", "mixed", 2, 32, 5, 8,
                                  device="cpu", group=group)


@pytest.mark.parametrize("cudnn", [True, False])
def test_train_steps_switch_cudnn_and_keep_f32_without_tf32(cudnn,
                                                           monkeypatch):
    """train_steps(cudnn=) turns cuDNN on or off and nothing else: an f32
    program still runs with TF32 off (precision_scope), and the caller's
    settings come back afterwards."""
    seen = []

    def record(*args):
        seen.append((torch.backends.cudnn.enabled,
                     torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32))
        return {}

    monkeypatch.setattr(bench_setup, "_train_steps", record)
    before = (torch.backends.cudnn.enabled, torch.backends.cudnn.allow_tf32,
              torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.benchmark,
              torch.backends.cudnn.deterministic)
    bench_setup.train_steps(dict(SMALL, model_kind="single",
                                 loss_kind="mixed"), 1, cudnn=cudnn)
    assert seen == [(cudnn, False, False)]
    assert (torch.backends.cudnn.enabled, torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.benchmark,
            torch.backends.cudnn.deterministic) == before
