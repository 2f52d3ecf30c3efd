"""Guards of the port: it imports nothing of JAX or of the JAX package, its
entry points never quietly run on the CPU, and a kernel library built from
older sources is never loaded."""

import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from svbrdf_tpu_torch import main as main_mod
from svbrdf_tpu_torch import viz
from svbrdf_tpu_torch.data import toy
from svbrdf_tpu_torch.device import resolve_device
from svbrdf_tpu_torch.estimator import SvbrdfEstimator
from svbrdf_tpu_torch.examples import (predict, recover_maps,
                                       renderer_compare, turntable)
from svbrdf_tpu_torch.experiments import map_recovery
from svbrdf_tpu_torch.models import MultiViewModel, SingleViewModel
from svbrdf_tpu_torch.ops import _build
from svbrdf_tpu_torch.utils import bench_setup

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]

_IMPORT_ALL = """
import sys
for name in ("jax", "jaxlib", "flax", "optax", "svbrdf_tpu", "PIL"):
    sys.modules[name] = None  # any import of these now raises ImportError
import importlib, pkgutil
import svbrdf_tpu_torch
names = [m.name for m in pkgutil.walk_packages(svbrdf_tpu_torch.__path__,
                                               "svbrdf_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
print(len(names))
"""
# Modules the import test must reach: the inference API and the tools
# (estimator, toy data, map recovery, the GIF writer, FLOP accounting, the
# examples) among them.
_TAIL = ("svbrdf_tpu_torch.estimator", "svbrdf_tpu_torch.data.toy",
         "svbrdf_tpu_torch.data.gif", "svbrdf_tpu_torch.experiments",
         "svbrdf_tpu_torch.experiments.map_recovery",
         "svbrdf_tpu_torch.utils.flops", "svbrdf_tpu_torch.viz",
         "svbrdf_tpu_torch.examples.predict",
         "svbrdf_tpu_torch.examples.turntable",
         "svbrdf_tpu_torch.examples.renderer_compare",
         "svbrdf_tpu_torch.examples.recover_maps")


def test_imports_without_jax_or_the_jax_package():
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 56  # every module was imported


_COLLECT_CARD_TESTS = """
import sys
for name in ("jax", "jaxlib", "flax", "optax", "svbrdf_tpu", "PIL"):
    sys.modules[name] = None  # any import of these now raises ImportError
import pytest
sys.exit(pytest.main(["--noconftest", "--collect-only", "-q",
                      "-p", "no:cacheprovider", "tests/test_torch_card.py"]))
"""


def test_card_tests_collect_without_jax():
    """The card suite, as a card machine without JAX runs it (--noconftest,
    the repo's conftest.py being the one that sets JAX up): every test
    collects with JAX, the JAX package and Pillow unimportable."""
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    out = subprocess.run([sys.executable, "-c", _COLLECT_CARD_TESTS],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "error" not in out.stdout.lower()
    collected = [line for line in out.stdout.splitlines()
                 if line.startswith("tests/test_torch_card.py::")]
    assert len(collected) >= 141
    for test in ("test_paths_launch_every_counter[single_mixed_bf16]",
                 "test_kernels_on_the_paths_inputs[render_fwdgrad-bf16-far]",
                 "test_pathtrace_kernels_match_plain[8-256-dtype1]"):
        assert f"tests/test_torch_card.py::{test}" in collected


def test_the_import_walk_reaches_the_tail_modules():
    import pkgutil

    import svbrdf_tpu_torch

    names = {m.name for m in pkgutil.walk_packages(svbrdf_tpu_torch.__path__,
                                                   "svbrdf_tpu_torch.")}
    assert set(_TAIL) <= names


def _needs_no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")


@pytest.mark.parametrize("entry", [
    lambda: resolve_device(),
    lambda: resolve_device("cuda:0"),
    lambda: SingleViewModel(8, 5),
    lambda: bench_setup.build_main_program(2, 32, 5, 8),
    lambda: MultiViewModel(8, 5),
    lambda: bench_setup.build_program("multi", "rendering", 2, 32, 5, 8),
    lambda: main_mod.main(["--mode", "train", "--input-dir", "data/train",
                           "--image-count", "10", "--model-dir", "unused"]),
    lambda: SvbrdfEstimator.from_checkpoint("unused"),
    lambda: toy.generate_toy_dataset("unused"),
    lambda: toy.render_photos(np.zeros((4, 4, 12), np.float32), None),
    lambda: map_recovery.recover_maps(None, np.zeros((4, 4, 12))),
    lambda: viz.turntable_frames(np.zeros((4, 4, 12), np.float32)),
    lambda: predict.main(["unused", "unused", "unused.png"]),
    lambda: turntable.main(["data/train/toy_train_00.png", "unused.gif"]),
    lambda: renderer_compare.main(["data/train/toy_train_00.png",
                                   "unused.png"]),
    lambda: recover_maps.main(["data/train/toy_train_00.png", "diffuse",
                               "unused.png"]),
])
def test_entry_points_raise_without_a_card(entry):
    _needs_no_card()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry()


def test_cpu_is_used_only_when_asked():
    assert resolve_device("cpu") == torch.device("cpu")
    model = SingleViewModel(8, 5, device="cpu")
    assert {p.device.type for p in model.parameters()} == {"cpu"}


def test_library_path_follows_sources_and_shared_headers(tmp_path):
    """The library's name hashes its source and every csrc/*.cuh: editing
    the shared header renames every library, editing one source only its
    own, and adding a header renames them all."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)

    def paths():
        return {n: _build.library_path(n, csrc) for n in _build.SOURCES}

    first = paths()
    assert first == {n: _build.library_path(n) for n in _build.SOURCES}
    header = csrc / "shading.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    second = paths()
    assert all(second[n] != first[n] for n in _build.SOURCES)
    source = csrc / "rendering_loss.cu"
    source.write_text(source.read_text() + "\n// edited\n")
    third = paths()
    assert third["rendering_loss"] != second["rendering_loss"]
    assert third["mixed_loss"] == second["mixed_loss"]
    (csrc / "other.cuh").write_text("// a new header\n")
    assert all(p != third[n] for n, p in paths().items())
