"""The port's SingleViewModel against the JAX package's, weights carried
across by interop.jax_params.params_from_jax.

The JAX forward runs at highest matmul precision (its default conv
precision on the CPU is bf16-grade); forward parity rtol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svbrdf_tpu.interop.torch_port import export_torch_state_dict
from svbrdf_tpu.models import SingleViewModel as JaxSingleViewModel
from svbrdf_tpu_torch.interop.jax_params import params_from_jax
from svbrdf_tpu_torch.models import SingleViewModel, layers

torch.set_num_threads(1)


def _jax_model_and_params(depth, filters, size, seed=0):
    model = JaxSingleViewModel(use_coords=False, num_filters=filters,
                               depth=depth)
    x = jnp.zeros((1, 1, size, size, 3), jnp.float32)
    params = model.init(jax.random.key(seed), x)["params"]
    return model, jax.tree.map(np.asarray, params)


def _port(params, filters, depth):
    model = SingleViewModel(filters, depth, device="cpu")
    model.load_state_dict(params_from_jax(params), strict=True)
    return model.eval()


def test_params_from_jax_equals_export_torch_state_dict():
    """Key for key and array for array equal to the JAX package's own
    export, and loadable strictly (the enc1 merge weight synthesized)."""
    _, params = _jax_model_and_params(5, 8, 32)
    mine = params_from_jax(params)
    ref = export_torch_state_dict(params)
    assert set(mine) == set(ref)
    for key, value in ref.items():
        np.testing.assert_array_equal(mine[key].numpy(), value, err_msg=key)
    assert "generator.enc1.conv.merge.fully_connected.weight" in mine
    model = SingleViewModel(8, 5, device="cpu")
    assert set(model.state_dict()) == set(mine)
    model.load_state_dict(mine, strict=True)


def test_full_width_layout_loads_strictly():
    """depth 8, 64 filters: every key and shape of the JAX tree (shapes
    only, via eval_shape) lands on a port parameter of the same shape."""
    model = JaxSingleViewModel(use_coords=False, num_filters=64, depth=8)
    shapes = jax.eval_shape(
        model.init, jax.random.key(0),
        jax.ShapeDtypeStruct((1, 1, 256, 256, 3), jnp.float32))["params"]
    zeros = jax.tree.map(
        lambda s: np.broadcast_to(np.float32(0.0), s.shape), shapes)
    state = params_from_jax(zeros)
    port = SingleViewModel(64, 8, device="cpu").state_dict()
    assert set(state) == set(port)
    for key, value in state.items():
        assert tuple(value.shape) == tuple(port[key].shape), key
    assert port["generator.dec8.deconv.conv.2.weight"].shape == (512, 512, 4, 4)
    assert port["generator.gte1.fully_connected.weight"].shape == (128, 3)


def _forward_parity(depth, filters, size, batch):
    model, params = _jax_model_and_params(depth, filters, size)
    x = np.random.default_rng(depth).uniform(
        0, 1, (batch, 1, size, size, 3)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(model.apply({"params": params}, jnp.asarray(x),
                                     deterministic=True))
    with torch.no_grad():
        mine = _port(params, filters, depth)(torch.from_numpy(x)).numpy()
    assert mine.shape == ref.shape == (batch, size, size, 12)
    np.testing.assert_allclose(mine, ref, rtol=1e-4, atol=1e-5)


def test_forward_matches_jax_depth5():
    _forward_parity(5, 8, 32, 2)


@pytest.mark.slow
def test_forward_matches_jax_depth8_256():
    _forward_parity(8, 64, 256, 1)


def test_single_view_uses_first_view_and_nhwc():
    model = SingleViewModel(8, 5, device="cpu").eval()
    x = torch.rand(2, 3, 32, 32, 3, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        assert torch.equal(model(x), model(x[:, 0]))


def test_init_contract():
    """conv ~ N(0, 0.02); merge ~ N(0, 0.01/sqrt(fan_in)); global track ~
    N(0, 1/sqrt(fan_in)) with zero bias; InstanceNorm 1 / 0; and the same
    seed gives the same weights."""
    model = SingleViewModel(16, 6, device="cpu", seed=1)
    convs = torch.cat([m.weight.detach().flatten() for m in model.modules()
                       if isinstance(m, torch.nn.Conv2d)])
    assert abs(float(convs.std()) - 0.02) < 0.02 * 0.02
    assert abs(float(convs.mean())) < 1e-3
    for m in model.modules():
        if isinstance(m, layers.Merge):
            w = m.fully_connected.weight.detach()
            expect = 0.01 / w.shape[1] ** 0.5
            assert abs(float(w.std()) - expect) < 0.2 * expect
        elif isinstance(m, layers.GlobalTrack):
            w = m.fully_connected.weight.detach()
            expect = 1.0 / w.shape[1] ** 0.5
            assert abs(float(w.std()) - expect) < 0.3 * expect
            assert torch.equal(m.fully_connected.bias,
                               torch.zeros_like(m.fully_connected.bias))
        elif isinstance(m, layers.InstanceNorm):
            assert torch.equal(m.weight, torch.ones_like(m.weight))
            assert torch.equal(m.bias, torch.zeros_like(m.bias))
    again = SingleViewModel(16, 6, device="cpu", seed=1).state_dict()
    for key, value in model.state_dict().items():
        assert torch.equal(value, again[key]), key


def test_instance_norm_matches_torch():
    """One-pass statistics equal torch's InstanceNorm2d (biased variance)."""
    x = torch.randn(2, 5, 8, 8, generator=torch.Generator().manual_seed(2))
    norm = layers.InstanceNorm(5)
    with torch.no_grad():
        norm.weight.uniform_(0.5, 1.5)
        norm.bias.uniform_(-0.5, 0.5)
        ref = torch.nn.functional.instance_norm(
            x, weight=norm.weight, bias=norm.bias, eps=1e-5)
        torch.testing.assert_close(norm(x), ref, rtol=1e-5, atol=1e-5)


def test_upsample_and_pad_match_reference_ops():
    x = torch.randn(2, 3, 4, 5, generator=torch.Generator().manual_seed(3))
    torch.testing.assert_close(
        layers.upsample_nearest_2x(x),
        torch.nn.functional.interpolate(x, scale_factor=2, mode="nearest"),
        rtol=0, atol=0)
    padded = layers._pad_1212(x)
    assert padded.shape == (2, 3, 7, 8)
    assert torch.equal(padded[:, :, 1:5, 1:6], x)
    assert float(padded.abs().sum()) == float(x.abs().sum())
