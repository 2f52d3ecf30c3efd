"""The frozen yardsticks against hand-derived values."""

import pytest

from bench_gpu.counts import bounds, flops

H100 = bounds.card_rates("NVIDIA H100 80GB HBM3")


def test_generator_flops_of_the_single_view_network():
    assert flops.generator_forward_flops(256) == 47_365_622_886


def test_multi_view_flops_are_three_generators_and_the_head():
    gen64 = flops.generator_forward_flops(256, out_channels=64)
    # dec1 at 256^2 with 64 outputs: 2 * 256^2 * 16 * (128*64 + 64*64).
    assert gen64 - flops.generator_forward_flops(256) > 0
    px = 256 * 256
    head = (2 * 64 * 64 + 2 * px * 9 * (64 * 64 + 64 * 32 + 32 * 9)
            + 2 * (128 * 64 + 128 * 32 + 64 * 9)
            + 2 * (64 * 64 + 32 * 32 + 9 * 9))
    assert flops.multi_view_forward_flops(256) == 3 * gen64 + head


def test_train_step_flops_per_configuration():
    single = {"model_type": "single", "image_size": 256, "num_filters": 64,
              "model_depth": 8, "batch_size": 8, "used_image_count": 1}
    assert flops.train_step_flops(single) == 3 * 8 * 47_365_622_886
    multi = dict(single, model_type="multi", used_image_count=3)
    assert flops.train_step_flops(multi) == pytest.approx(5.26e12, rel=0.01)


def test_loss_kernel_bounds_at_the_cells_shapes():
    # Special-function bound: 8 * 256^2 pixels * (9 * 27 + 12) SFU over
    # 132 SMs * 16 * 1.98 GHz.
    mixed = bounds.loss_bound_s("mixed_fwdgrad", 8, 256, 256, 9, H100, 2)
    assert mixed == pytest.approx(8 * 65536 * 255 / (132 * 16 * 1.98e9))
    assert mixed * 1e3 == pytest.approx(0.0320, abs=5e-5)
    render = bounds.loss_bound_s("render_fwdgrad", 8, 256, 256, 9, H100, 2)
    assert render * 1e3 == pytest.approx(0.0305, abs=5e-5)


def test_path_tracer_bounds_at_the_cells_shapes():
    fwd = bounds.pathtrace_bound_s("pathtrace_shade", 8, 9, 256, 256, 16,
                                   H100, 4)
    views = 8 * 9 * 65536
    ops = views * 16 * 109 + views * 69 + 8 * 65536 * 17
    assert fwd == pytest.approx(ops / 66.9e12)
    assert fwd * 1e3 == pytest.approx(0.1280, abs=5e-5)
    vjp = bounds.pathtrace_bound_s("pathtrace_shade_vjp", 8, 9, 256, 256, 8,
                                   H100, 2)
    assert vjp * 1e3 == pytest.approx(0.1125, abs=5e-5)


def test_an_unknown_card_has_no_rates():
    with pytest.raises(ValueError):
        bounds.card_rates("a CPU")
