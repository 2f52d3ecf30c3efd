"""The port's examples (svbrdf_tpu_torch/examples/*.py), each run through
its main(argv) on the CPU at 32^2 on a toy strip with 10 photos and a
port-written checkpoint (depth 4, 4 filters): each writes its output, of
the expected size. Their numbers are the modules' they call, which the
other tests hold against the JAX package."""

import contextlib
import io

import pytest
import torch

from svbrdf_tpu_torch.data import gif, strips, toy
from svbrdf_tpu_torch.examples import (predict, recover_maps,
                                       renderer_compare, turntable)
from svbrdf_tpu_torch.models import build_model
from svbrdf_tpu_torch.training.checkpoint import Checkpoint

torch.set_num_threads(1)

SIZE = 32


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("ex")
    with contextlib.redirect_stdout(io.StringIO()):
        (strip,) = toy.generate_toy_dataset(str(root / "toy"), 1, 0, SIZE,
                                            10, seed=3, device="cpu")
        model = build_model("single", False, 4, 4, device="cpu")
        Checkpoint.save(root / "model", model, None, 0, "single", False,
                        omit_optimizer_state=True, model_depth=4,
                        num_filters=4)
    return root, strip


def _run(main, argv):
    with contextlib.redirect_stdout(io.StringIO()) as out:
        result = main(argv + ["--device", "cpu"])
    return result, out.getvalue()


def test_predict(data, tmp_path):
    root, strip = data
    photo = tmp_path / "photo.png"
    strips.write_image(str(photo), strips.read_image(strip)[:, :SIZE])
    written, out = _run(predict.main, [str(root / "model"),
                                       str(tmp_path / "out"), str(photo)])
    assert written == [str(tmp_path / "out" / "photo_svbrdf.png")]
    assert f"wrote {written[0]}" in out
    assert strips.read_image_u8(written[0]).shape == (SIZE, 4 * SIZE, 3)


def test_turntable(data, tmp_path):
    _, strip = data
    out = str(tmp_path / "t.gif")
    _run(turntable.main, [strip, out, "3"])
    info = gif.gif_info(out)
    assert info["frames"] == 3 and info["size"] == (384, 384)


def test_renderer_compare(data, tmp_path):
    _, strip = data
    out = str(tmp_path / "c.png")
    _run(renderer_compare.main, [strip, out, "5"])
    grid = strips.read_image_u8(out)
    assert grid.shape == (3 * SIZE, 5 * SIZE, 3)
    assert grid[SIZE:].mean() > 5  # the renders are lit


def test_recover_maps(data, tmp_path):
    _, strip = data
    out = str(tmp_path / "r.png")
    result, printed = _run(recover_maps.main, [strip, "diffuse", out, "30"])
    assert "loss" in printed and result.losses.shape == (30,)
    assert float(result.losses[-1]) < float(result.losses[0])
    assert strips.read_image_u8(out).shape == (2 * SIZE, 5 * SIZE, 3)


def test_usage_without_arguments():
    with pytest.raises(SystemExit), \
            contextlib.redirect_stderr(io.StringIO()):
        predict.main([])


def test_examples_default_to_the_card(data, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    _, strip = data
    with pytest.raises(RuntimeError, match="device='cpu'"):
        turntable.main([strip, str(tmp_path / "x.gif"), "1"])
