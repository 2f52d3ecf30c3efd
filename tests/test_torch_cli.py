"""The port's CLI end to end on the CPU (`--gpu-id -1`): train, resume and
test from the repo's PNG strips, in f32 and with bf16 compute (bf16-SR or
f32 masters), validation, the device cache, the error paths and the
unported flags, and the port-trained checkpoints tested by the JAX
package's CLI.

Depth 5, 32^2, 8 filters, batch 2. Tolerances: the JAX package's and the
port's metrics.json on one port-trained checkpoint agree at rtol 1e-4 (JAX
at highest matmul precision; the two differ in convolution order only).
The device cache and the host path give equal losses (same seed, same
dropout stream).
"""

import argparse
import contextlib
import io
import json
import math
import pathlib
import re

import jax
import numpy as np
import pytest
import torch

from svbrdf_tpu.cli import parse_args as jparse_args
from svbrdf_tpu.training import loop as jloop
from svbrdf_tpu_torch import main as main_mod
from svbrdf_tpu_torch.data import png, strips
from svbrdf_tpu_torch.training import loop
from svbrdf_tpu_torch.training.tensorboard import read_scalars

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
TRAIN = str(REPO / "data" / "train")
TEST = str(REPO / "data" / "test")
SMALL = ["--image-size", "32", "--model-depth", "5", "--num-filters", "8",
         "--gpu-id", "-1"]
METRIC_KEYS = {"rmse_normals", "rmse_diffuse", "rmse_roughness",
               "rmse_specular", "log_rmse_diffuse", "log_rmse_specular",
               "ssim_normals", "ssim_diffuse", "ssim_roughness",
               "ssim_specular", "rendering_rmse"}


def _train_args(model_dir, *extra, input_dir=TRAIN, count="10"):
    return (["--mode", "train", "--input-dir", input_dir, "--image-count",
             count, "--batch-size", "2", "--save-frequency", "1",
             "--validation-frequency", "1", "--model-dir", str(model_dir)]
            + SMALL + list(extra))


def _run(argv):
    """main(argv) with its printout captured: (result, printout)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = main_mod.main(argv)
    return result, out.getvalue()


def _maps_only(out_dir: pathlib.Path, samples: int) -> str:
    """Maps-only 32^2 strips: the map tiles of the two training strips'
    corners, and symlinks to them up to `samples` files."""
    out_dir.mkdir()
    for n, path in enumerate(strips.list_sample_files(TRAIN)):
        strip = strips.read_image_u8(path)
        maps = [strip[:32, (10 + k) * 256:(10 + k) * 256 + 32]
                for k in range(4)]
        png.write_png_rgb8(str(out_dir / f"maps_{n}.png"),
                           np.concatenate(maps, axis=1))
    for n in range(2, samples):
        (out_dir / f"link_{n:03d}.png").symlink_to(
            out_dir / f"maps_{n % 2}.png")
    return str(out_dir)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Train 2 epochs on data/train, then resume to 3: (model dir,
    (first run, its printout), (resumed run, its printout))."""
    model_dir = tmp_path_factory.mktemp("cli") / "model"
    first = _run(_train_args(model_dir, "--epochs", "2", "--retrain"))
    resumed = _run(_train_args(model_dir, "--epochs", "3"))
    return model_dir, first, resumed


def test_train_and_resume(trained):
    model_dir, (first, out1), (resumed, out2) = trained
    # 2 samples, none held out (ceil(0.99 * 2) = 2), batch 2: one step per
    # epoch.
    assert "Training samples: 2." in out1 and "Validation samples: 0." in out1
    assert (first.steps, first.validation_batches) == (2, 0)
    assert first.validation_timer.count == 0
    assert math.isfinite(first.last_loss) and math.isfinite(
        resumed.last_loss)
    assert "Restored epoch 1" in out2
    assert "Training from epoch 1 to 3" in out2
    assert "Restored optimizer state" in out2
    assert resumed.steps == 2
    blob = torch.load(model_dir / "checkpoint.tar", weights_only=True)
    assert blob["epoch"] == 2
    assert (blob["model_depth"], blob["num_filters"]) == (5, 8)
    assert int(blob["optimizer_state_dict"]["state"][0]["step"]) == 4
    losses = read_scalars(str(model_dir / "logs"))["loss"]
    # The first run's two steps, then the resumed run's (epochs 1 and 2).
    assert [s for s, _ in losses] == [0, 1, 1, 2]
    assert all(math.isfinite(v) for _, v in losses)
    # After training, main tests on the validation split (all samples
    # here, the split being empty).
    assert len(list((model_dir / "test_outputs").glob("sample_*.png"))) == 2


def test_test_mode_writes_grids_and_metrics(trained, tmp_path):
    model_dir = trained[0]
    written, out = _run(["--mode", "test", "--input-dir", TEST,
                         "--image-count", "10", "--model-dir",
                         str(model_dir)] + SMALL)
    assert len(written) == 1
    grid = png.read_png_rgb8(written[0])
    assert grid.shape == (64, 160, 3)
    summary = json.loads((model_dir / "test_outputs" /
                          "metrics.json").read_text())
    assert set(summary["mean"]) == METRIC_KEYS
    assert all(math.isfinite(v) for v in summary["mean"].values())
    assert "Restored epoch 2" in out


def test_photos_only_and_resize_modes(trained, tmp_path):
    """The dataset's float path through the CLI: test mode on photos
    without maps (the test strip read as 14 photos) writes grids and no
    metrics; training in resize mode (256^2 -> 32^2) runs."""
    written, out = _run(["--mode", "test", "--input-dir", TEST,
                         "--image-count", "14", "--no-svbrdf-input",
                         "--model-dir", str(trained[0]),
                         "--scale-mode", "resize"] + SMALL)
    assert len(written) == 1 and "metrics.json" not in out
    assert png.read_png_rgb8(written[0]).shape == (64, 160, 3)
    run, _ = _run(_train_args(tmp_path / "resize", "--epochs", "1",
                              "--retrain", "--scale-mode", "resize"))
    assert run.steps == 1 and math.isfinite(run.last_loss)


def test_jax_cli_tests_the_port_trained_checkpoint(trained, tmp_path):
    """ROADMAP Queue 1 item 9's acceptance: the JAX package's run_test and
    the port's, on the same port-trained checkpoint.tar, write
    metrics.json files that agree."""
    model_dir = trained[0]
    argv = ["--mode", "test", "--input-dir", TEST, "--image-count", "10",
            "--model-dir", str(model_dir)] + SMALL
    with contextlib.redirect_stdout(io.StringIO()):
        loop.run_test(main_mod.parse_args(argv), "cpu",
                      out_dir=str(tmp_path / "port"))
        with jax.default_matmul_precision("highest"):
            jloop.run_test(jparse_args(argv), out_dir=str(tmp_path / "jax"))
    mine = json.loads((tmp_path / "port" / "metrics.json").read_text())
    ref = json.loads((tmp_path / "jax" / "metrics.json").read_text())
    assert set(mine["mean"]) == set(ref["mean"]) == METRIC_KEYS
    for key, value in ref["mean"].items():
        np.testing.assert_allclose(mine["mean"][key], value, rtol=1e-4,
                                   err_msg=key)


def test_validation_holds_one_sample_out(tmp_path):
    data = _maps_only(tmp_path / "maps", 101)
    model_dir = tmp_path / "model"
    run, out = _run(_train_args(model_dir, "--epochs", "1", "--retrain",
                                "--batch-size", "8", input_dir=data,
                                count="0"))
    assert "Training samples: 100." in out
    assert "Validation samples: 1." in out
    assert (run.steps, run.validation_batches) == (13, 1)
    # One timed validation pass per validating epoch.
    assert run.validation_timer.count == 1
    assert float(run.validation_timer.steady_times()[0]) > 0.0
    scalars = read_scalars(str(model_dir / "logs"))
    assert [s for s, _ in scalars["loss"]] == list(range(13))
    ((step, val_loss),) = scalars["val_loss"]
    assert step == 0 and math.isfinite(val_loss)
    printed = re.search(r"Epoch 0, validation loss: (\S+)", out).group(1)
    assert float(printed) == pytest.approx(val_loss, abs=1e-6)
    # The post-training test pass shows the held-out sample only.
    grids = list((model_dir / "test_outputs").glob("sample_*.png"))
    assert len(grids) == 1


def test_validation_sums_are_sample_weighted():
    """Full batches, then the trailing partial batch at its true size:
    each batch's mean loss counts once per sample it holds."""
    class Data:
        def raw_batch(self, idx):
            return {"x": np.asarray(idx, np.float32)}

    def eval_step(raw):  # a batch's loss: the mean of its indices
        return raw["x"].mean()

    total, count, batches = loop._validation_sums(
        eval_step, torch.Generator(), Data(), np.arange(5), 2, 313, 0,
        torch.device("cpu"))
    assert (count, batches) == (5, 3)
    assert total / count == pytest.approx(np.arange(5).mean())


def test_device_cache_trains_as_the_host_path(tmp_path):
    data = _maps_only(tmp_path / "maps", 5)
    losses = {}
    for name, extra in (("host", []), ("cache", ["--device-data-cache"])):
        torch.manual_seed(0)  # the dropout stream
        _run(_train_args(tmp_path / name, "--epochs", "2", "--retrain",
                         *extra, input_dir=data, count="0"))
        losses[name] = read_scalars(str(tmp_path / name / "logs"))
    assert losses["host"] == losses["cache"]
    assert len(losses["host"]["loss"]) == 6


def test_profile_export_and_import(trained, tmp_path):
    model_dir = trained[0]
    exported = tmp_path / "exported.tar"
    _run(["--mode", "test", "--input-dir", TEST, "--image-count", "10",
          "--model-dir", str(model_dir), "--export-torch-checkpoint",
          str(exported)] + SMALL)
    blob = torch.load(exported, weights_only=True)
    assert set(blob) == {"model_type", "use_coords", "epoch",
                         "model_state_dict"}
    run, out = _run(_train_args(
        tmp_path / "from_import", "--epochs", "3", "--import-torch-checkpoint",
        str(exported), "--profile-dir", str(tmp_path / "trace")))
    assert "Restored epoch 2" in out and run.steps == 1
    assert "Failed to restore optimizer state" in out
    # The trace window starts at a run's second step; this run took one.
    assert not (tmp_path / "trace" / "trace.json").exists()
    run, _ = _run(_train_args(
        tmp_path / "profiled", "--epochs", "3", "--retrain",
        "--profile-dir", str(tmp_path / "trace")))
    assert run.steps == 3
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0


def test_nan_guard_saves_then_raises(tmp_path, monkeypatch):
    """A non-finite fetched loss saves the checkpoint, then raises."""
    def nan_loss_fn(kind, renderer):
        def fn(pred, target, generator=None, scenes=None):
            return (pred * float("nan")).mean()
        return fn

    monkeypatch.setattr(loop.losses_lib, "make_loss_fn", nan_loss_fn)
    with pytest.raises(FloatingPointError, match="epoch 0, batch 0"):
        _run(_train_args(tmp_path / "m", "--epochs", "2", "--retrain"))
    blob = torch.load(tmp_path / "m" / "checkpoint.tar", weights_only=True)
    assert blob["epoch"] == 0


@pytest.mark.parametrize("argv,error,message", [
    (["--no-svbrdf-input"], RuntimeError, "without SVBRDF"),
    (["--steps-per-call", "2"], ValueError, "--device-data-cache"),
    (["--import-torch-checkpoint", "/nonexistent/checkpoint.tar"],
     SystemExit, "No torch checkpoint"),
])
def test_train_error_paths(tmp_path, argv, error, message):
    with pytest.raises(error, match=message):
        _run(_train_args(tmp_path / "m", "--epochs", "1", *argv))


def test_test_mode_needs_a_model(tmp_path):
    with pytest.raises(SystemExit, match="No model found"):
        _run(["--mode", "test", "--input-dir", TEST, "--image-count", "10",
              "--model-dir", str(tmp_path / "empty")] + SMALL)
    with pytest.raises(RuntimeError, match="No SVBRDF and no image input"):
        main_mod.main(["--mode", "test", "--input-dir", TEST,
                       "--image-count", "0", "--no-svbrdf-input",
                       "--model-dir", str(tmp_path)] + SMALL)


@pytest.mark.parametrize("flag,error,message", [
    pytest.param(["--num-devices", "2", "--gpu-id", "0"], RuntimeError,
                 "device='cpu'", id="flag0-item 14"),
])
def test_unported_flags_raise_naming_their_item(tmp_path, flag, error,
                                                message):
    """--num-devices (ROADMAP Queue 1 item 14) is ported: two ranks asked
    of cards on a machine without one raise the no-card error before a
    rank starts (the last --gpu-id counts; under --gpu-id -1 it is a
    two-rank run on the CPU, tests/test_torch_multihost.py).
    --shard-spatial (item 15) runs in tests/test_torch_spatial.py."""
    if error is RuntimeError and torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the cards would be used")
    with pytest.raises(error, match=message):
        main_mod.main(_train_args(tmp_path, *flag))


def test_pathtracing_trains_resumes_and_tests(tmp_path):
    """--renderer pathtracing (the path tracer's unfused losses): train 1
    epoch, resume to 2, test mode on the checkpoint."""
    model_dir = tmp_path / "model"
    traced = ["--renderer", "pathtracing"]
    first, out1 = _run(_train_args(model_dir, *traced, "--epochs", "1",
                                   "--retrain"))
    assert "Using renderer 'pathtracing'" in out1
    assert first.steps == 1 and math.isfinite(first.last_loss)
    resumed, out2 = _run(_train_args(model_dir, *traced, "--epochs", "2"))
    assert "Restored epoch 0" in out2 and "Restored optimizer state" in out2
    assert resumed.steps >= 1 and math.isfinite(resumed.last_loss)
    losses = [v for _, v in read_scalars(str(model_dir / "logs"))["loss"]]
    assert len(losses) == first.steps + resumed.steps
    assert all(map(math.isfinite, losses))
    written, out3 = _run(["--mode", "test", "--input-dir", TEST,
                          "--image-count", "10", "--model-dir",
                          str(model_dir)] + traced + SMALL)
    assert len(written) == 1
    summary = json.loads((model_dir / "test_outputs" /
                          "metrics.json").read_text())
    assert all(math.isfinite(v) for v in summary["mean"].values())


def test_pathtracing_validates(tmp_path):
    """--renderer pathtracing with a validation split: the eval step runs
    the path-traced loss under no_grad."""
    data = _maps_only(tmp_path / "maps", 101)
    run, out = _run(_train_args(tmp_path / "m", "--renderer", "pathtracing",
                                "--epochs", "1", "--retrain",
                                input_dir=data, count="0"))
    assert "Validation samples: 1." in out
    assert run.validation_batches == 1
    val = re.search(r"validation loss: (\S+)", out)
    assert val and math.isfinite(float(val.group(1)))


@pytest.fixture(scope="module")
def trained_bf16(tmp_path_factory):
    """bf16 compute with bf16-SR masters: train 2 epochs on data/train,
    then resume to 3 with the policy left at 'auto': (model dir, (first
    run, its printout), (resumed run, its printout))."""
    model_dir = tmp_path_factory.mktemp("cli_bf16") / "model"
    bf16 = ["--dtype", "bfloat16"]
    first = _run(_train_args(model_dir, *bf16, "--master-dtype", "bf16sr",
                             "--epochs", "2", "--retrain"))
    resumed = _run(_train_args(model_dir, *bf16, "--epochs", "3"))
    return model_dir, first, resumed


def test_bf16sr_trains_resumes_and_tests(trained_bf16):
    model_dir, (first, out1), (resumed, out2) = trained_bf16
    for run in (first, resumed):
        assert run.steps == 2 and math.isfinite(run.last_loss)
        for p in run.model.parameters():
            assert p.dtype == (torch.bfloat16 if p.dim() >= 2
                               else torch.float32)
    assert "Restored master_dtype 'bf16sr'" in out2
    assert "Restored optimizer state" in out2 and "Restored epoch 1" in out2
    blob = torch.load(model_dir / "checkpoint.tar", weights_only=True)
    assert blob["master_dtype"] == "bf16sr"
    assert {v.dtype for v in blob["model_state_dict"].values()} == {
        torch.float32}
    moments = blob["optimizer_state_dict"]["state"][0]
    assert moments["exp_avg_sq"].dtype == torch.bfloat16
    assert int(moments["step"]) == 4
    written, out = _run(["--mode", "test", "--input-dir", TEST,
                         "--image-count", "10", "--model-dir", str(model_dir),
                         "--dtype", "bfloat16"] + SMALL)
    assert len(written) == 1 and "Restored master_dtype 'bf16sr'" in out
    summary = json.loads((model_dir / "test_outputs" /
                          "metrics.json").read_text())
    assert all(math.isfinite(v) for v in summary["mean"].values())


def test_bf16_with_f32_masters_trains(tmp_path):
    run, _ = _run(_train_args(tmp_path / "m", "--dtype", "bfloat16",
                              "--master-dtype", "f32", "--epochs", "1",
                              "--retrain"))
    assert run.steps == 1 and math.isfinite(run.last_loss)
    assert {p.dtype for p in run.model.parameters()} == {torch.float32}
    state = run.optimizer.state[run.model.generator.enc2.conv.conv.weight]
    assert state["exp_avg_sq"].dtype == torch.bfloat16  # bf16sr moments
    blob = torch.load(tmp_path / "m" / "checkpoint.tar", weights_only=True)
    assert blob["master_dtype"] == "f32"


def test_jax_cli_tests_the_bf16sr_model(trained_bf16, tmp_path):
    """The JAX package's run_test and the port's (both f32, the CPU's
    'auto') on the bf16sr checkpoint.tar write metrics.json files that
    agree at rtol 1e-4."""
    argv = ["--mode", "test", "--input-dir", TEST, "--image-count", "10",
            "--model-dir", str(trained_bf16[0])] + SMALL
    with contextlib.redirect_stdout(io.StringIO()):
        loop.run_test(main_mod.parse_args(argv), "cpu",
                      out_dir=str(tmp_path / "port"))
        with jax.default_matmul_precision("highest"):
            jloop.run_test(jparse_args(argv), out_dir=str(tmp_path / "jax"))
    mine = json.loads((tmp_path / "port" / "metrics.json").read_text())
    ref = json.loads((tmp_path / "jax" / "metrics.json").read_text())
    assert set(mine["mean"]) == set(ref["mean"]) == METRIC_KEYS
    for key, value in ref["mean"].items():
        np.testing.assert_allclose(mine["mean"][key], value, rtol=1e-4,
                                   err_msg=key)


def test_flag_surface_matches_the_jax_cli():
    """Every flag of the JAX CLI, with its default."""
    from svbrdf_tpu.cli import build_parser as jbuild_parser

    from svbrdf_tpu_torch.cli import build_parser

    def surface(parser):
        return {(a.dest, tuple(a.option_strings),
                 None if isinstance(a.default, type(argparse.SUPPRESS))
                 else repr(a.default))
                for a in parser._actions}

    assert surface(build_parser()) == surface(jbuild_parser())
