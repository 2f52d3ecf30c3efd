"""Data-parallel training through the port's entry points on the CPU, over
gloo: the global validation sums, the CLI's `--num-devices 2 --gpu-id -1`
and the launcher's two processes.

Depth 5, 32^2, 8 filters. Tolerance: the validation loss of world 2
against world 1 rel 1e-5, every sample counted once. Every rank and
process runs under a time limit, and each run picks a free port. The
spawned ranks import this module, so it imports neither JAX nor the JAX
package at its top.
"""

import collections
import math
import os
import pathlib
import re
import signal
import subprocess
import sys
from datetime import timedelta

import numpy as np
import pytest
import torch

from svbrdf_tpu_torch.data import dataset as dataset_lib
from svbrdf_tpu_torch.parallel import mesh
from svbrdf_tpu_torch.parallel import step as step_lib
from svbrdf_tpu_torch.training import loop
from svbrdf_tpu_torch.training.tensorboard import read_scalars
from svbrdf_tpu_torch.utils import bench_setup

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
TIMEOUT = 120
SMALL = ["--image-size", "32", "--model-depth", "5", "--num-filters", "8",
         "--gpu-id", "-1"]


def _env():
    return {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1",
            "PYTHONUNBUFFERED": "1"}


def _run(cmd, timeout=TIMEOUT):
    """Run a command in its own session, killed with every process it
    started when it outlives `timeout`: (returncode, output)."""
    proc = subprocess.Popen(cmd, cwd=REPO, env=_env(), text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        pytest.fail(f"{cmd[:4]} still running after {timeout} s:\n"
                    f"{out[-3000:]}")
    return proc.returncode, out


VAL_IDX = np.array([6, 1, 8, 3, 5])  # two full batches of 2, then 1


def _validation(data, group):
    """loop._validation_sums over VAL_IDX in batches of 2 (the group's
    share, reduced over it): (sum, count, the host RNG's state)."""
    program = bench_setup.build_program("single", "mixed", 2, 32, 5, 8,
                                        seed=1, device="cpu", group=group)
    # The loop's two eval steps: whole batches, and a rank's rows; one
    # generator, which _validation_sums seeds per batch.
    plain = step_lib.make_eval_step(program.model,
                                    program.train_step.loss_fn,
                                    program.prep, program.generator)
    dataset = dataset_lib.SvbrdfDataset(data, 32, input_image_count=0,
                                        mix_materials=True, seed=3,
                                        use_native_prefetch=False)
    total, count, _ = loop._validation_sums(
        plain, program.generator, dataset, VAL_IDX, 2, 313, 0,
        torch.device("cpu"), group, program.eval_step if group else None)
    if group is not None:
        total, count = mesh.all_reduce_sum([total, count], group)
    return total, count, dataset._host_rng.bit_generator.state


def _validation_rank(rank, address, data, out_path):
    group = mesh.init_group(2, rank, "cpu", address,
                            timeout=timedelta(seconds=TIMEOUT))
    result = _validation(data, group)
    gathered = [None, None]
    torch.distributed.all_gather_object(gathered, result,
                                        group=group.host_group)
    if group.is_main:
        torch.save(gathered, out_path)
    mesh.destroy_group()


def test_validation_sums_over_two_ranks(tmp_path, monkeypatch):
    """Full batches split across the ranks, the trailing one on rank 0
    alone: every sample counts once, the loss is world 1's, and both
    ranks' host RNGs end where world 1's does."""
    from tests.test_torch_cli import _maps_only

    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    data = _maps_only(tmp_path / "maps", 9)
    total1, count1, state1 = _validation(data, None)
    out_path = str(tmp_path / "ranks.pt")
    mesh.spawn(_validation_rank, 2,
               (f"tcp://localhost:{mesh.free_port()}", data, out_path),
               TIMEOUT)
    for total, count, state in torch.load(out_path, weights_only=False):
        assert count == count1 == len(VAL_IDX)
        assert total / count == pytest.approx(total1 / count1, rel=1e-5)
        assert state == state1


def _cli(*args):
    return [sys.executable, "-m", "svbrdf_tpu_torch.main", *args]


def test_num_devices_two_trains_resumes_and_tests(tmp_path):
    """--num-devices 2 --gpu-id -1: two CPU ranks train 1 epoch on 101
    maps-only strips (13 steps of 8, one held out), resume to 2 with the
    device cache and test the held-out sample: one checkpoint.tar and one
    event file a run, the loss logged once a step, val_loss once an epoch,
    one grid."""
    from tests.test_torch_cli import _maps_only

    data = _maps_only(tmp_path / "maps", 101)
    model_dir = tmp_path / "model"
    train = ["--mode", "train", "--input-dir", data, "--image-count", "0",
             "--batch-size", "8", "--save-frequency", "1",
             "--validation-frequency", "1", "--model-dir", str(model_dir),
             "--num-devices", "2"] + SMALL
    outs = []
    # The first run reads batches on the host (its rows of each), the
    # resume from the device cache.
    for extra in (["--epochs", "1", "--retrain"],
                  ["--epochs", "2", "--device-data-cache"]):
        rc, out = _run(_cli(*train, *extra))
        assert rc == 0, out[-3000:]
        assert "Starting 2 ranks (cpu)" in out
        assert out.count("Data group: 2 rank(s) over gloo") == 2
        outs.append(out)
    # The resume restores epoch 0 and trains epochs 0 and 1.
    assert "Restored epoch 0" in outs[1]
    assert "Training from epoch 0 to 2" in outs[1]
    assert sorted(p.name for p in model_dir.iterdir()) == [
        "checkpoint.tar", "logs", "test_outputs"]
    assert len(list((model_dir / "logs").iterdir())) == 2  # one a run
    scalars = read_scalars(str(model_dir / "logs"))
    assert sorted(s for s, _ in scalars["loss"]) == sorted(
        list(range(13)) + list(range(26)))
    assert sorted(s for s, _ in scalars["val_loss"]) == [0, 0, 13]
    # Both ranks print each epoch's val_loss, the same global value.
    val = re.findall(r"Epoch (\d+), validation loss: (\S+)", outs[1])
    assert sorted(collections.Counter(val).values()) == [2, 2]
    blob = torch.load(model_dir / "checkpoint.tar", weights_only=True)
    assert int(blob["optimizer_state_dict"]["state"][0]["step"]) == 39
    assert len(list((model_dir / "test_outputs").glob("sample_*.png"))) == 1
    assert (model_dir / "test_outputs" / "metrics.json").exists()
    assert outs[1].count("wrote ") == 2  # rank 0 alone tests


def test_launcher_trains_two_processes(tmp_path):
    """Two launcher processes on the JAX package's toy strips: each reads
    its own 100-file shard, the step count is global, rank 0 alone writes
    the checkpoint and the logs, both end with rc 0."""
    from svbrdf_tpu.data import toy

    data = tmp_path / "data"
    toy.generate_toy_dataset(str(data), n_train=200, n_test=1, size=32,
                             seed=17)
    model_dir = tmp_path / "model"
    port = mesh.free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "svbrdf_tpu_torch.parallel.multihost",
         "--coordinator", f"localhost:{port}", "--num-processes", "2",
         "--process-id", str(i), "--",
         "--mode", "train", "--input-dir", str(data / "train"),
         "--image-count", "10", "--used-image-count", "1",
         "--batch-size", "8", "--epochs", "1", "--save-frequency", "1",
         "--validation-frequency", "1", "--model-dir", str(model_dir),
         "--retrain"] + SMALL,
        cwd=REPO, env=_env(), text=True, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, start_new_session=True) for i in range(2)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                os.killpg(q.pid, signal.SIGKILL)
            pytest.fail("the launcher's processes outlived the time limit")
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {i}:\n{out[-3000:]}"
        assert f"process {i}/2: 1 local / 2 global devices (gloo" in out
        assert f"Host {i}/2: 100 of 200 files" in out
        assert "(2 processes)" in out
        # 25 global steps (ceil(198 / 8)); one validation sample each.
        assert "Epoch 0, Batch 25, loss" in out
        assert "Epoch 0, validation loss" in out
    assert (model_dir / "checkpoint.tar").exists()
    assert len(list((model_dir / "logs").iterdir())) == 1
    losses = read_scalars(str(model_dir / "logs"))["loss"]
    assert len(losses) == 25 and all(math.isfinite(v) for _, v in losses)
