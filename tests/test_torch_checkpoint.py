"""The port's checkpoint.tar and TensorBoard files, alone and read by the JAX
package, and the loop's step timer.

Depth 5, 32^2, 8 filters. Tolerances: a save/load round trip restores
parameters and Adam state bit for bit. A port checkpoint opened by the JAX
package's Checkpoint.load predicts what the port predicts within atol 1e-5
(rtol 1e-4), JAX at highest matmul precision. TensorBoard scalars: equal
(tag, step, value) in f32.
"""

import argparse
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svbrdf_tpu.interop.torch_port import export_torch_state_dict
from svbrdf_tpu.models import SingleViewModel as JaxSingleViewModel
from svbrdf_tpu.training import tensorboard as jtensorboard
from svbrdf_tpu.training.checkpoint import Checkpoint as JaxCheckpoint
from svbrdf_tpu_torch.models import build_model
from svbrdf_tpu_torch.parallel.step import make_optimizer
from svbrdf_tpu_torch.training import tensorboard
from svbrdf_tpu_torch.training.checkpoint import Checkpoint
from svbrdf_tpu_torch.utils.profiling import StepTimer, trace_steps

torch.set_num_threads(1)

DEPTH, FILTERS, SIZE = 5, 8, 32


def _trained(model_type="single", steps=2, seed=0):
    """A small model and its Adam after `steps` updates on random data."""
    model = build_model(model_type, False, DEPTH, FILTERS, "cpu", seed)
    optimizer = make_optimizer(model.parameters())
    g = torch.Generator().manual_seed(seed)
    for _ in range(steps):
        x = torch.rand(2, 1, SIZE, SIZE, 3, generator=g)
        loss = model(x).square().mean()
        optimizer.zero_grad()
        loss.backward()
        optimizer.step()
    return model, optimizer


def _args(**kw):
    base = dict(model_type="multi", use_coords=True, model_depth=8,
                num_filters=64, master_dtype="auto", upconv="auto")
    return argparse.Namespace(**{**base, **kw})


def _images(seed=1, batch=2):
    return np.random.default_rng(seed).uniform(
        size=(batch, 1, SIZE, SIZE, 3)).astype(np.float32)


def test_round_trip_restores_everything(tmp_path, capsys):
    model, optimizer = _trained()
    path = Checkpoint.save(tmp_path, model, optimizer, 4, "single", False,
                           model_depth=DEPTH, num_filters=FILTERS)
    assert path == tmp_path / "checkpoint.tar"
    ckpt = Checkpoint.load(tmp_path)
    assert ckpt.is_valid()
    args = ckpt.restore_args(_args())
    assert (args.model_type, args.use_coords, args.model_depth,
            args.num_filters) == ("single", False, DEPTH, FILTERS)
    fresh = build_model(args.model_type, args.use_coords, args.model_depth,
                        args.num_filters, "cpu", seed=9)
    fresh_opt = make_optimizer(fresh.parameters())
    ckpt.restore_params(fresh)
    ckpt.restore_opt_state(fresh_opt)
    assert ckpt.restore_epoch(0) == 4
    for key, value in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[key], value), key
    saved, restored = optimizer.state_dict(), fresh_opt.state_dict()
    assert saved["param_groups"] == restored["param_groups"]
    for i, state in saved["state"].items():
        for k, v in state.items():
            assert torch.equal(restored["state"][i][k], v), (i, k)
    assert int(restored["state"][0]["step"]) == 2
    out = capsys.readouterr().out
    for line in ("Restored model type 'single'", "Restored model state",
                 "Restored optimizer state", "Restored epoch 4"):
        assert line in out
    ckpt.purge()
    assert not ckpt.is_valid()


def test_omitted_optimizer_state(tmp_path, capsys):
    model, optimizer = _trained(steps=1)
    Checkpoint.save(tmp_path, model, optimizer, 0, "single", False,
                    omit_optimizer_state=True, model_depth=DEPTH,
                    num_filters=FILTERS)
    blob = torch.load(tmp_path / "checkpoint.tar", weights_only=True)
    assert "optimizer_state_dict" not in blob
    fresh_opt = make_optimizer(model.parameters())
    Checkpoint.load(tmp_path).restore_opt_state(fresh_opt)
    assert fresh_opt.state_dict()["state"] == {}
    assert "Failed to restore optimizer state" in capsys.readouterr().out


def test_missing_legacy_and_jax_directories(tmp_path, capsys):
    assert not Checkpoint.load(tmp_path).is_valid()
    assert "No checkpoint found" in capsys.readouterr().out
    model, _ = _trained(steps=0)
    legacy = tmp_path / "legacy"
    legacy.mkdir()
    torch.save(model.state_dict(), legacy / "model.data")
    (legacy / "state.json").write_text(json.dumps({"epoch": 12}))
    ckpt = Checkpoint.load(legacy)
    fresh = build_model("single", False, DEPTH, FILTERS, "cpu", seed=5)
    ckpt.restore_params(fresh)
    assert ckpt.restore_epoch(0) == 12
    assert torch.equal(fresh.generator.enc1.conv.conv.weight,
                       model.generator.enc1.conv.conv.weight)
    orbax = tmp_path / "orbax"
    (orbax / "state").mkdir(parents=True)
    with pytest.raises(ValueError, match="--export-torch-checkpoint"):
        Checkpoint.load(orbax)


def test_jax_package_loads_the_ports_checkpoint(tmp_path):
    """The JAX CLI's Checkpoint.load picks checkpoint.tar up from a model
    directory, keeps depth and filters, and its restored params predict
    what the port predicts."""
    model, optimizer = _trained(steps=2)
    Checkpoint.save(tmp_path, model, optimizer, 3, "single", False,
                    model_depth=DEPTH, num_filters=FILTERS)
    ckpt = JaxCheckpoint.load(tmp_path)
    assert ckpt.is_valid()
    args = ckpt.restore_args(_args())
    assert (args.model_type, args.model_depth, args.num_filters) == (
        "single", DEPTH, FILTERS)
    assert ckpt.restore_epoch(0) == 3
    jmodel = JaxSingleViewModel(use_coords=False, num_filters=FILTERS,
                                depth=DEPTH)
    x = _images()
    template = jmodel.init(jax.random.key(0), jnp.asarray(x[:1]))["params"]
    params = ckpt.restore_params(template)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x),
                                      deterministic=True))
    with torch.no_grad():
        mine = model.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(mine, ref, atol=1e-5, rtol=1e-4)


def test_a_jax_exported_checkpoint_loads_strictly(tmp_path):
    """The dict the JAX CLI's --export-torch-checkpoint writes (model_type,
    use_coords, epoch, model_state_dict) restores into the port, which
    then predicts what the JAX model predicts."""
    jmodel = JaxSingleViewModel(use_coords=False, num_filters=FILTERS,
                                depth=DEPTH)
    x = _images(2)
    params = jmodel.init(jax.random.key(3), jnp.asarray(x[:1]))["params"]
    state = {k: torch.tensor(np.asarray(v))
             for k, v in export_torch_state_dict(params).items()}
    torch.save({"model_type": "single", "use_coords": False, "epoch": 6,
                "model_state_dict": state}, tmp_path / "checkpoint.tar")
    ckpt = Checkpoint.load(tmp_path / "checkpoint.tar")
    args = ckpt.restore_args(_args(model_depth=DEPTH, num_filters=FILTERS))
    model = build_model(args.model_type, args.use_coords, DEPTH, FILTERS,
                        "cpu")
    ckpt.restore_params(model)  # strict
    assert ckpt.restore_epoch(0) == 6
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x),
                                      deterministic=True))
    with torch.no_grad():
        mine = model.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(mine, ref, atol=1e-5, rtol=1e-4)


def test_recorded_tpu_knobs_fill_only_auto(capsys):
    ckpt = Checkpoint(None, {"master_dtype": "f32", "upconv": "fold"})
    args = ckpt.restore_args(_args(upconv="naive"))
    assert (args.master_dtype, args.upconv) == ("f32", "naive")
    assert "Restored master_dtype 'f32'" in capsys.readouterr().out


def test_tensorboard_files_cross_both_ways(tmp_path):
    scalars = [("loss", 0, 1.5), ("loss", 1, 0.25), ("val_loss", 13, 0.75),
               ("loss", 2, float("inf"))]
    with tensorboard.SummaryWriter(str(tmp_path / "port")) as w:
        for tag, step, value in scalars:
            w.add_scalar(tag, value, step)
    with jtensorboard.SummaryWriter(str(tmp_path / "jax")) as w:
        for tag, step, value in scalars:
            w.add_scalar(tag, value, step)
    expected = {}
    for tag, step, value in scalars:
        expected.setdefault(tag, []).append(
            (step, float(np.float32(value))))
    for d in ("port", "jax"):
        assert jtensorboard.read_scalars(str(tmp_path / d)) == expected
        assert tensorboard.read_scalars(str(tmp_path / d)) == expected
    assert tensorboard._crc32c(b"123456789") == 0xE3069283  # RFC 3720


def test_step_timer_syncs_and_skips_warmup(tmp_path):
    calls = []
    timer = StepTimer(warmup=1, sync=lambda: calls.append(1))
    for _ in range(3):
        with timer.measure():
            pass
    assert timer.count == 3 and len(calls) == 6
    assert len(timer.steady_times()) == 2
    assert timer.median_ms() >= 0.0 and "steps: 3" in timer.summary()
    with trace_steps(str(tmp_path / "trace")):
        torch.ones(4).sum()
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
