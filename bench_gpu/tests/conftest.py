"""Tiny cells for the CPU: the program at depth 5, 8 filters, 32^2."""

import copy

import pytest
import torch

from bench_gpu import core

SEED = 2 ** 31 + 977  # beyond 32 signed bits, as the benchmark's seeds


def tiny(name: str, **config) -> dict:
    """Cell `name` at depth 5, 8 filters, 32^2; in f32 with f32 masters
    unless `config` says otherwise (on the CPU the program's f32 path
    agrees with the reference to rounding, so a check that fails there
    fails for its fault alone)."""
    cell = copy.deepcopy(core.load_cell(name))
    cell["config"].update(model_depth=5, num_filters=8, image_size=32,
                          dtype="float32", master_dtype="f32")
    cell["config"].update(config)
    return cell


@pytest.fixture(autouse=True)
def _few_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)
