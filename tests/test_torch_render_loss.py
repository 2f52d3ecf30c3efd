"""The fused rendering-only loss: plain versions of its three CUDA kernels
against the JAX package's Pallas kernels (interpret mode on the CPU) and
against the port's own autograd composition; the autograd.Function, the
NHWC entry and the wrappers' guards.

Tolerances: value rtol 2e-5 against the Pallas kernels (their f32 per-tile
sums, see tests/test_torch_render_fused.py) and 1e-5 against the port's
composition; dpred and dgt rtol 2e-4, atol 1e-6, as tests/test_render_pallas.py
holds the Pallas kernels to the jnp composition. The kernels themselves are
compared with the plain versions on the card, by tests/test_torch_card.py
and by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svbrdf_tpu.ops import render_pallas
from svbrdf_tpu_torch import losses
from svbrdf_tpu_torch.ops import render_fused as rf
from svbrdf_tpu_torch.utils.bench_setup import loss_inputs, loss_inputs_near
from tests.test_torch_render_fused import (PALLAS_RTOL, _case, _t,
                                           assert_near_convergence)

torch.set_num_threads(1)


def _jax_value_and_grads(c, **kw):
    """Value and (d/dpred, d/dgt) of the JAX entry with want_target_grad:
    the custom VJP's forward runs _fwdgrad_kernel_both."""
    return jax.value_and_grad(
        lambda p, t: render_pallas.rendering_loss_fused_planes(
            p, t, c["js"], want_target_grad=True, **kw), argnums=(0, 1))(
                jnp.asarray(c["pred_t"]), jnp.asarray(c["gt_t"]))


def _assert_grad(actual, expected):
    np.testing.assert_allclose(actual.numpy(), np.asarray(expected),
                               rtol=2e-4, atol=1e-6)


@pytest.mark.parametrize("size", [16, 32])
def test_plain_versions_match_pallas(size):
    c = _case(size, seed=10)
    s9 = rf.pack_scenes(c["ts"])
    p, g = _t(c["pred_t"]), _t(c["gt_t"])
    value, (gp, gt) = _jax_value_and_grads(c)
    loss, dpred, dgt = rf.rendering_loss_fwdgrad_both_plain(p, g, s9)
    np.testing.assert_allclose(float(loss), float(value), rtol=PALLAS_RTOL)
    _assert_grad(dpred, gp)
    _assert_grad(dgt, gt)
    # _fwdgrad_kernel: the JAX entry's default, the target stop-gradiented.
    value_p, grad_p = jax.value_and_grad(
        lambda q: render_pallas.rendering_loss_fused_planes(
            q, jnp.asarray(c["gt_t"]), c["js"]))(jnp.asarray(c["pred_t"]))
    loss, dpred = rf.rendering_loss_fwdgrad_plain(p, g, s9)
    np.testing.assert_allclose(float(loss), float(value_p), rtol=PALLAS_RTOL)
    _assert_grad(dpred, grad_p)
    # _fwd_kernel: the JAX entry outside autodiff.
    value_f = render_pallas.rendering_loss_fused_planes(
        jnp.asarray(c["pred_t"]), jnp.asarray(c["gt_t"]), c["js"])
    np.testing.assert_allclose(float(rf.rendering_loss_fwd_plain(p, g, s9)),
                               float(value_f), rtol=PALLAS_RTOL)


@pytest.mark.parametrize("size,seed", [(16, 0), (32, 1)])
def test_fwd_plain_near_convergence(size, seed):
    """pred within sigma = 1e-3 of gt (bench_setup.loss_inputs_near): the
    value plain version against float64 (measured 2.4e-6 and 6.3e-7 here;
    held at 5e-6) and against _fwd_kernel (2.2e-6 and 4.8e-6; held at 3e-5,
    the tolerances of tests/test_torch_render_fused.py)."""
    assert_near_convergence(rf.rendering_loss_fwd_plain,
                            render_pallas.rendering_loss_fused_planes, size,
                            seed)


def test_plain_versions_match_autograd_composition():
    """All three plain versions equal the port's losses.rendering_loss and
    its autograd gradients with respect to both inputs."""
    c = _case(16, seed=11)
    pred = _t(c["pred"]).requires_grad_()
    gt = _t(c["gt"]).requires_grad_()
    ref = losses.rendering_loss(pred, gt, c["ts"])
    ref.backward()
    ref = ref.detach()
    s9 = rf.pack_scenes(c["ts"])
    p, g = _t(c["pred_t"]), _t(c["gt_t"])
    loss, dpred, dgt = rf.rendering_loss_fwdgrad_both_plain(p, g, s9)
    loss_p, dpred_p = rf.rendering_loss_fwdgrad_plain(p, g, s9)
    value = rf.rendering_loss_fwd_plain(p, g, s9)
    for v in (loss, loss_p, value):
        np.testing.assert_allclose(float(v), float(ref), rtol=1e-5)
    for mine, grad in ((dpred, pred.grad), (dpred_p, pred.grad),
                       (dgt, gt.grad)):
        np.testing.assert_allclose(mine.numpy(),
                                   grad.numpy().transpose(0, 3, 1, 2),
                                   rtol=2e-4, atol=1e-6)


def test_zero_on_identical():
    c = _case(16, seed=12)
    p = _t(c["pred_t"])
    s9 = rf.pack_scenes(c["ts"])
    loss, dpred, dgt = rf.rendering_loss_fwdgrad_both_plain(p, p.clone(), s9)
    assert float(loss) == 0.0
    np.testing.assert_array_equal(dpred.numpy(), 0.0)
    np.testing.assert_array_equal(dgt.numpy(), 0.0)
    assert float(rf.rendering_loss_fwd_plain(p, p.clone(), s9)) == 0.0


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("near", [False, True])
def test_both_plain_matches_float64(near, seed):
    """The plain version with both gradients (value_shading.cuh's algebra
    and its VJP, IEEE rsqrt, reciprocal and log) on loss_inputs (pred far
    from gt) and loss_inputs_near, B=2, 32^2, S=9:
    - in float64, its dpred and dgt equal the gradients of shading.cuh's
      algebra (rendering_loss_fwdgrad_plain's dpred, of pred and, the loss
      being symmetric, of gt with the two swapped) to 1e-12: the same
      function and the same derivative conventions at the clamps;
    - in f32, dpred and dgt against float64 normwise <= 2e-4 (measured
      4e-5 to 6e-5 at 32^2 to 128^2), as test_plain_dpred_matches_float64
      holds the training kernels', over the pixels at least KINK_MARGIN
      from the loss's kinks (render_fused.kink_distance): closer, f32 may
      take the other one-sided derivative. That sets apart under 1 % of
      the pixels far from gt and under 10 % near it (measured 0.07 % and
      4.5 %), where over all pixels the same distances read up to 9.4e-3
      (one pixel at a clamp) and 4.8e-4 (many at |log(r_p / r_t)| ~ 0);
    - pred = gt gives a loss and gradients of exactly 0."""
    make = loss_inputs_near if near else loss_inputs
    p, g, s9 = make(2, 32, 9, seed=seed, device="cpu")
    _, dp32, dg32 = rf.rendering_loss_fwdgrad_both_plain(p, g, s9)
    p64, g64, s64 = p.double(), g.double(), s9.double()
    _, dp64, dg64 = rf.rendering_loss_fwdgrad_both_plain(p64, g64, s64)
    _, ref_dp = rf.rendering_loss_fwdgrad_plain(p64, g64, s64)
    _, ref_dg = rf.rendering_loss_fwdgrad_plain(g64, p64, s64)
    for mine, ref in ((dp64, ref_dp), (dg64, ref_dg)):
        assert float((mine - ref).norm() / ref.norm()) <= 1e-12
    keep = (rf.kink_distance(p64, g64, s64) >= rf.KINK_MARGIN)[:, None]
    assert 1.0 - float(keep.double().mean()) <= (0.1 if near else 0.01)
    for d32, d64 in ((dp32, dp64), (dg32, dg64)):
        err = float(((d32.double() - d64) * keep).norm() / (d64 * keep).norm())
        assert err <= 2e-4, err
    loss, dpred, dgt = rf.rendering_loss_fwdgrad_both_plain(g, g.clone(), s9)
    assert float(loss) == 0.0
    assert not dpred.any() and not dgt.any()


def test_row_offset_and_global_height_match_pallas():
    """Two row halves with their offset and the global height: each equals
    the JAX entry's value and both gradients for the same shard, and the
    halves add up to the whole image."""
    c = _case(32, seed=13)
    s9 = rf.pack_scenes(c["ts"])
    full = rf.rendering_loss_fwd_plain(_t(c["pred_t"]), _t(c["gt_t"]), s9)
    total = 0.0
    for r0 in (0, 16):
        half = {**c, "pred_t": c["pred_t"][:, :, r0:r0 + 16],
                "gt_t": c["gt_t"][:, :, r0:r0 + 16]}
        value, (gp, gt) = _jax_value_and_grads(half, row_offset=r0,
                                               global_height=32)
        loss, dpred, dgt = rf.rendering_loss_fwdgrad_both_plain(
            _t(half["pred_t"]), _t(half["gt_t"]), s9, row_offset=r0,
            global_height=32)
        np.testing.assert_allclose(float(loss), float(value),
                                   rtol=PALLAS_RTOL)
        _assert_grad(dpred, gp)
        _assert_grad(dgt, gt)
        total += float(loss)
    np.testing.assert_allclose(total, float(full), rtol=1e-5)


@pytest.mark.parametrize("want_target_grad", [False, True])
def test_function_gradients(want_target_grad):
    """rendering_loss_fused_planes under autograd: pred.grad is upstream *
    dpred of the value+gradient plain version (the one with both gradients
    with want_target_grad); gt.grad upstream * dgt with want_target_grad,
    else none (the target is detached). Under no_grad the value-only path
    gives the same value (to rounding: `both` shades on another algebra)."""
    c = _case(16, seed=14)
    pred = _t(c["pred_t"]).requires_grad_()
    gt = _t(c["gt_t"]).requires_grad_()
    loss = rf.rendering_loss_fused_planes(pred, gt, c["ts"],
                                          want_target_grad=want_target_grad)
    (3.0 * loss).backward()
    plain = (rf.rendering_loss_fwdgrad_both_plain if want_target_grad
             else rf.rendering_loss_fwdgrad_plain)
    ref_loss, dpred, *dgt = plain(_t(c["pred_t"]), _t(c["gt_t"]),
                                  rf.pack_scenes(c["ts"]))
    assert float(loss.detach()) == float(ref_loss)
    np.testing.assert_allclose(pred.grad.numpy(), 3.0 * dpred.numpy(),
                               rtol=1e-6)
    if want_target_grad:
        np.testing.assert_allclose(gt.grad.numpy(), 3.0 * dgt[0].numpy(),
                                   rtol=1e-6)
    else:
        assert gt.grad is None
    with torch.no_grad():
        value = rf.rendering_loss_fused_planes(pred, gt, c["ts"])
    assert float(value) == float(rf.rendering_loss_fwd_plain(
        _t(c["pred_t"]), _t(c["gt_t"]), rf.pack_scenes(c["ts"])))
    np.testing.assert_allclose(float(value), float(ref_loss), rtol=1e-6)


def test_target_only_gradient():
    """With want_target_grad and only the target requiring grad, the
    target still gets its gradient."""
    c = _case(16, seed=15)
    gt = _t(c["gt_t"]).requires_grad_()
    rf.rendering_loss_fused_planes(_t(c["pred_t"]), gt, c["ts"],
                                   want_target_grad=True).backward()
    _, _, dgt = rf.rendering_loss_fwdgrad_both_plain(
        _t(c["pred_t"]), _t(c["gt_t"]), rf.pack_scenes(c["ts"]))
    np.testing.assert_allclose(gt.grad.numpy(), dgt.numpy(), rtol=1e-6)
    # Without it the target is data and nothing needs a gradient.
    value = rf.rendering_loss_fused_planes(_t(c["pred_t"]), gt, c["ts"])
    assert not value.requires_grad


def test_nhwc_entry_matches_pallas():
    """rendering_loss_fused on NHWC against the JAX NHWC entry, value and
    both gradients."""
    c = _case(16, seed=16)
    value, (gp, gt) = jax.value_and_grad(
        lambda p, t: render_pallas.rendering_loss_fused(
            p, t, c["js"], want_target_grad=True), argnums=(0, 1))(
                jnp.asarray(c["pred"]), jnp.asarray(c["gt"]))
    pred = _t(c["pred"]).requires_grad_()
    gt_in = _t(c["gt"]).requires_grad_()
    loss = rf.rendering_loss_fused(pred, gt_in, c["ts"],
                                   want_target_grad=True)
    loss.backward()
    np.testing.assert_allclose(float(loss), float(value), rtol=PALLAS_RTOL)
    _assert_grad(pred.grad, gp)
    _assert_grad(gt_in.grad, gt)


def test_make_loss_fn_rendering_matches_pallas():
    """make_loss_fn("rendering") with given scenes: the JAX entry's value
    and pred gradient."""
    c = _case(16, seed=17)
    value, grad = jax.value_and_grad(
        lambda p: render_pallas.rendering_loss_fused(
            p, jnp.asarray(c["gt"]), c["js"]))(jnp.asarray(c["pred"]))
    pred = _t(c["pred"]).requires_grad_()
    loss = losses.make_loss_fn("rendering")(pred, _t(c["gt"]),
                                            scenes=c["ts"])
    loss.backward()
    np.testing.assert_allclose(float(loss), float(value), rtol=PALLAS_RTOL)
    _assert_grad(pred.grad, grad)


def test_wrappers_reject_what_the_kernels_do_not_take():
    c = _case(16, seed=18)
    p, g = _t(c["pred_t"]), _t(c["gt_t"])
    s9 = rf.pack_scenes(c["ts"])
    with pytest.raises(TypeError, match="float32"):
        rf.rendering_loss_fwdgrad(p.half(), g.half(), s9)
    with pytest.raises(ValueError, match="contiguous"):
        rf.rendering_loss_fwd(p.transpose(2, 3), g.transpose(2, 3), s9)
    with pytest.raises(ValueError, match=r"\(B, S, 9\)"):
        rf.rendering_loss_fwdgrad_both(p, g, s9[:1])
    # CPU tensors never reach a kernel: the CUDA wrappers raise instead.
    for fn in (rf.rendering_loss_fwdgrad_cuda, rf.rendering_loss_fwd_cuda,
               rf.rendering_loss_fwdgrad_both_cuda):
        before = fn.launches
        with pytest.raises(RuntimeError, match="CUDA tensors"):
            fn(p, g, s9)
        assert fn.launches == before
