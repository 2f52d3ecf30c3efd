"""The port's MultiViewModel, ConvFeatureBlock, append_coords and use_coords
against the JAX package, weights carried across by
interop.jax_params.params_from_jax.

The JAX model computes its fusion head in a space-to-depth phase layout;
the port computes the plain full-resolution form with the same parameter
tree, so forward parity here is what shows the two are the same function.
The JAX forward runs at highest matmul precision (its default conv
precision on the CPU is bf16-grade); forward parity rtol 1e-4, atol 1e-5,
as for the single-view model.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svbrdf_tpu.interop.torch_port import export_torch_state_dict
from svbrdf_tpu.models import MultiViewModel as JaxMultiViewModel
from svbrdf_tpu.models import SingleViewModel as JaxSingleViewModel
from svbrdf_tpu.models import layers as jlayers
from svbrdf_tpu_torch.interop.jax_params import params_from_jax
from svbrdf_tpu_torch.models import MultiViewModel, SingleViewModel, layers

torch.set_num_threads(1)

DEPTH, FILTERS, SIZE, VIEWS = 5, 8, 32, 3


def _jax_multi(use_coords=False, depth=DEPTH, filters=FILTERS, size=SIZE,
               seed=0):
    model = JaxMultiViewModel(use_coords=use_coords, num_filters=filters,
                              depth=depth)
    x = jnp.zeros((1, VIEWS, size, size, 3), jnp.float32)
    params = model.init(jax.random.key(seed), x)["params"]
    return model, jax.tree.map(np.asarray, params)


def _port_multi(params, use_coords=False, depth=DEPTH, filters=FILTERS):
    model = MultiViewModel(filters, depth, use_coords=use_coords,
                           device="cpu")
    model.load_state_dict(params_from_jax(params), strict=True)
    return model.eval()


@pytest.mark.parametrize("use_coords", [False, True])
def test_params_from_jax_equals_export_torch_state_dict(use_coords):
    """Key for key and array for array equal to the JAX package's export,
    and the same key set as the port's model, so it loads strictly."""
    _, params = _jax_multi(use_coords)
    mine = params_from_jax(params)
    ref = export_torch_state_dict(params)
    assert set(mine) == set(ref)
    for key, value in ref.items():
        np.testing.assert_array_equal(mine[key].numpy(), value, err_msg=key)
    for key in ("merge.fully_connected.weight", "gt1.fully_connected.bias",
                "conv1.conv.conv.weight", "conv1.conv.norm.weight",
                "conv1.conv.merge.fully_connected.weight",
                "conv3.conv.merge.fully_connected.weight",
                "generator.enc1.conv.merge.fully_connected.weight"):
        assert key in mine, key
    assert "conv3.conv.norm.weight" not in mine
    model = MultiViewModel(FILTERS, DEPTH, use_coords=use_coords,
                           device="cpu")
    assert set(model.state_dict()) == set(mine)
    model.load_state_dict(mine, strict=True)
    in_channels = 5 if use_coords else 3
    assert mine["generator.enc1.conv.conv.weight"].shape[1] == in_channels
    assert mine["generator.gte1.fully_connected.weight"].shape[1] == in_channels


def test_full_width_layout_loads_strictly():
    """depth 8, 64 filters, 64 generator channels: every key and shape of
    the JAX tree (shapes only, via eval_shape) lands on a port parameter of
    the same shape."""
    model = JaxMultiViewModel(use_coords=False, num_filters=64, depth=8)
    shapes = jax.eval_shape(
        model.init, jax.random.key(0),
        jax.ShapeDtypeStruct((1, VIEWS, 256, 256, 3), jnp.float32))["params"]
    zeros = jax.tree.map(
        lambda s: np.broadcast_to(np.float32(0.0), s.shape), shapes)
    state = params_from_jax(zeros)
    port = MultiViewModel(64, 8, device="cpu").state_dict()
    assert set(state) == set(port)
    for key, value in state.items():
        assert tuple(value.shape) == tuple(port[key].shape), key
    assert port["conv1.conv.conv.weight"].shape == (64, 64, 3, 3)
    assert port["conv3.conv.conv.weight"].shape == (9, 32, 3, 3)
    assert port["gt1.fully_connected.weight"].shape == (64, 128)
    assert port["generator.dec1.deconv.conv.4.weight"].shape == (64, 64, 4, 4)


def _forward_parity(depth, filters, size, batch, use_coords=False):
    model, params = _jax_multi(use_coords, depth, filters, size)
    x = np.random.default_rng(depth).uniform(
        0, 1, (batch, VIEWS, size, size, 3)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(model.apply({"params": params}, jnp.asarray(x),
                                     deterministic=True))
    port = _port_multi(params, use_coords, depth, filters)
    with torch.no_grad():
        mine = port(torch.from_numpy(x)).numpy()
    assert mine.shape == ref.shape == (batch, size, size, 12)
    np.testing.assert_allclose(mine, ref, rtol=1e-4, atol=1e-5)
    return port, x, mine


@pytest.mark.parametrize("use_coords", [False, True])
def test_forward_matches_jax_depth5(use_coords):
    _forward_parity(DEPTH, FILTERS, SIZE, 2, use_coords)


@pytest.mark.slow
def test_forward_matches_jax_depth8_256():
    _forward_parity(8, 64, 256, 1)


def test_view_permutation_invariance_and_single_view_input():
    """Max-pooling over views makes the output independent of their order;
    a (B, H, W, 3) input is one view."""
    model = MultiViewModel(FILTERS, DEPTH, device="cpu", seed=1).eval()
    x = torch.rand(2, VIEWS, SIZE, SIZE, 3,
                   generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        out = model(x)
        torch.testing.assert_close(model(x[:, [2, 0, 1]]), out, rtol=1e-5,
                                   atol=1e-6)
        assert torch.equal(model(x[:, 0]), model(x[:, :1]))


def test_conv_feature_block_matches_jax():
    """The plain 3x3 ConvFeatureBlock against the JAX one (NHWC there,
    NCHW here), with and without norm and activation."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 8, 8, 6)).astype(np.float32)
    gvec = rng.normal(size=(2, 4)).astype(np.float32)
    for use_norm, use_act in ((True, False), (True, True), (False, True)):
        jblock = jlayers.ConvFeatureBlock(4, use_norm, use_act)
        params = jblock.init(jax.random.key(1), jnp.asarray(x),
                             jnp.asarray(gvec))["params"]
        with jax.default_matmul_precision("highest"):
            ref, ref_mean = jblock.apply({"params": params}, jnp.asarray(x),
                                         jnp.asarray(gvec))
        block = layers.ConvFeatureBlock(6, 4, use_norm, use_act)
        state = params_from_jax({"conv1": jax.tree.map(np.asarray, params)})
        block.load_state_dict({k[len("conv1."):]: v
                               for k, v in state.items()}, strict=True)
        with torch.no_grad():
            out, mean = block(torch.from_numpy(x).permute(0, 3, 1, 2),
                              torch.from_numpy(gvec))
        np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(ref), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(mean.numpy(), np.asarray(ref_mean),
                                   rtol=1e-5, atol=1e-6)


def test_append_coords_matches_jax():
    """torch.linspace and jnp.linspace may round an inner point to
    neighbouring floats: atol 2.5e-7, two ulps of values up to 1; the ends
    are exact."""
    x = np.random.default_rng(4).normal(size=(2, 5, 7, 3)).astype(np.float32)
    ref = np.asarray(jlayers.append_coords(jnp.asarray(x)))
    mine = layers.append_coords(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(mine.permute(0, 2, 3, 1).numpy(), ref,
                               rtol=0, atol=2.5e-7)
    assert float(mine[0, 4, 0, 0]) == 1.0 and float(mine[0, 4, -1, 0]) == -1.0
    assert float(mine[0, 3, 0, 0]) == -1.0 and float(mine[0, 3, 0, -1]) == 1.0


def test_single_view_use_coords_matches_jax():
    model = JaxSingleViewModel(use_coords=True, num_filters=FILTERS,
                               depth=DEPTH)
    params = jax.tree.map(np.asarray, model.init(
        jax.random.key(2), jnp.zeros((1, 1, SIZE, SIZE, 3)))["params"])
    x = np.random.default_rng(5).uniform(
        0, 1, (2, 1, SIZE, SIZE, 3)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(model.apply({"params": params}, jnp.asarray(x),
                                     deterministic=True))
    port = SingleViewModel(FILTERS, DEPTH, use_coords=True, device="cpu")
    port.load_state_dict(params_from_jax(params), strict=True)
    with torch.no_grad():
        mine = port.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(mine, ref, rtol=1e-4, atol=1e-5)


def test_dropout_masks_differ_between_views():
    """In training mode each view draws its own dropout mask (the JAX model
    splits its dropout key over the views): identical views give different
    generator outputs."""
    model = MultiViewModel(FILTERS, DEPTH, device="cpu", seed=2)
    x = torch.rand(1, 1, SIZE, SIZE, 3,
                   generator=torch.Generator().manual_seed(1))
    x = x.expand(1, VIEWS, SIZE, SIZE, 3)
    torch.manual_seed(0)
    spatial, _ = model.generator(x.reshape(VIEWS, SIZE, SIZE, 3)
                                 .permute(0, 3, 1, 2))
    assert not torch.equal(spatial[0], spatial[1])
    model.eval()
    with torch.no_grad():
        spatial, _ = model.generator(x.reshape(VIEWS, SIZE, SIZE, 3)
                                     .permute(0, 3, 1, 2))
    assert torch.equal(spatial[0], spatial[1])
