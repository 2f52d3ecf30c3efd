"""The port's FLOP accounting (svbrdf_tpu_torch/utils/flops.py) against the
JAX package's (svbrdf_tpu/utils/flops.py): the counts equal at
folded_decoder=False (the port's plain decoder) to the FLOP; the peaks are
an H100's, by the card's name."""

import pytest

from svbrdf_tpu.utils import flops as jflops
from svbrdf_tpu_torch.utils import flops

SIZES = [(8, 64, 256), (5, 8, 32)]  # (depth, ngf, image size)


@pytest.mark.parametrize("depth, ngf, size", SIZES)
def test_generator_and_shading_counts_equal_jax(depth, ngf, size):
    assert flops.generator_forward_flops(size, ngf=ngf, depth=depth) == \
        jflops.generator_forward_flops(size, ngf=ngf, depth=depth,
                                       folded_decoder=False)
    assert flops.generator_forward_flops(
        size, ngf=ngf, depth=depth, use_global_track=False) == \
        jflops.generator_forward_flops(size, ngf=ngf, depth=depth,
                                       folded_decoder=False,
                                       use_global_track=False)
    assert flops.shading_flops(size) == jflops.shading_flops(size)


@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("size", [256, 32])
def test_train_step_counts_equal_jax(size, batch):
    """The train step of the published width (depth 8, 64 filters) at each
    size, as the JAX package counts it."""
    mine = flops.train_step_flops(batch, size)
    assert mine == jflops.train_step_flops(batch, size, folded_decoder=False)
    assert mine == 3 * batch * (flops.generator_forward_flops(size)
                                + flops.shading_flops(size))


def test_mfu_against_the_h100_table():
    """The peaks MFU is taken against, by the card's name: the SXM part
    (which names itself "NVIDIA H100 80GB HBM3") and the PCIe part, in bf16
    and f32, by name or as a torch dtype."""
    import torch

    sxm = "NVIDIA H100 80GB HBM3"
    assert flops.peak_flops(sxm) == 989e12
    assert flops.peak_flops(sxm, "float32") == 67e12
    assert flops.peak_flops("NVIDIA H100 SXM5 80GB", torch.bfloat16) == 989e12
    assert flops.peak_flops("NVIDIA H100 PCIe") == 756e12
    assert flops.peak_flops("NVIDIA H100 PCIe", torch.float32) == 51e12


@pytest.mark.parametrize("name", ["NVIDIA A100-SXM4-80GB", "TPU v5 lite",
                                  ""])
def test_unknown_card_raises(name):
    with pytest.raises(ValueError, match="no peak"):
        flops.peak_flops(name)


def test_folded_decoder_raises():
    with pytest.raises(ValueError, match="folded"):
        flops.generator_forward_flops(folded_decoder=True)
