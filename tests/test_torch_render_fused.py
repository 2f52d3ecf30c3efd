"""The fused mixed loss: plain versions of both CUDA kernels against the JAX
package's Pallas kernels (interpret mode on the CPU) and against the port's
own autograd composition; the autograd.Function and the wrappers' guards.

Tolerances: gradient rtol 2e-4 (atol 1e-6), as tests/test_render_pallas.py
holds the Pallas kernels to the jnp composition; value rtol 1e-5 against
the port's composition and 2e-5 against the Pallas kernels, whose f32
per-tile sums differ from a float64 evaluation of the same loss by up to
1.05e-5 on these inputs (the plain versions: under 2e-7, tested below).
On inputs near convergence (pred within 1e-3 of gt) the loss is ~100x
smaller and the same f32 rounding weighs more: see NEAR_PALLAS_RTOL.
The kernels themselves are compared with the plain versions on the card,
by tests/test_torch_card.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svbrdf_tpu.ops import render_pallas
from svbrdf_tpu.ops import sampling as jsampling
from svbrdf_tpu.scene import Scene as JaxScene
from svbrdf_tpu_torch import losses
from svbrdf_tpu_torch.ops import render_fused as rf
from svbrdf_tpu_torch.scene import Scene
from svbrdf_tpu_torch.utils.bench_setup import loss_inputs_near
from tests.test_render import random_svbrdf

torch.set_num_threads(1)

PALLAS_RTOL = 2e-5  # see the module docstring
# Near convergence (loss_inputs_near, loss ~1e-2 where loss_inputs' is
# ~1): the Pallas kernels read 1.3e-6 to 1.4e-5 from float64 at 16^2 and
# 32^2 (their f32 tile sums), the plain versions 5.5e-7 to 2.4e-6, and the
# two 6e-7 to 1.33e-5 from each other.
NEAR_PALLAS_RTOL = 3e-5
NEAR_FLOAT64_RTOL = 5e-6


def _case(size, seed=0, batch=2):
    """NHWC pred/target, their planes, and 3 + 6 scenes per item drawn with
    the JAX sampler (the Scene for each framework)."""
    rng = np.random.default_rng(seed + size)
    pred = random_svbrdf(rng, size, size, batch=(batch,))
    gt = random_svbrdf(rng, size, size, batch=(batch,))
    js = jsampling.generate_loss_scenes(jax.random.key(seed), batch, 3, 6)
    ts = Scene.make(*[np.asarray(f) for f in (js.camera_pos, js.light_pos,
                                              js.light_color)])
    return dict(pred=pred, gt=gt,
                pred_t=np.ascontiguousarray(pred.transpose(0, 3, 1, 2)),
                gt_t=np.ascontiguousarray(gt.transpose(0, 3, 1, 2)),
                js=js, ts=ts)


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _near_case(size, seed):
    """loss_inputs_near on the CPU at B=2, S=9, and its scenes as the JAX
    package's Scene."""
    pred_t, gt_t, s9 = loss_inputs_near(2, size, 9, seed=seed, device="cpu")
    s = s9.numpy()
    js = JaxScene.make(*(jnp.asarray(s[..., k:k + 3]) for k in (0, 3, 6)))
    return pred_t, gt_t, s9, js


def assert_near_convergence(plain, pallas_entry, size, seed):
    """The value plain version `plain` on loss_inputs_near against itself in
    float64 and against the JAX entry `pallas_entry` (outside autodiff: its
    value-only Pallas kernel, in interpret mode)."""
    pred_t, gt_t, s9, js = _near_case(size, seed)
    value = float(plain(pred_t, gt_t, s9))
    ref = float(plain(pred_t.double(), gt_t.double(), s9.double()))
    np.testing.assert_allclose(value, ref, rtol=NEAR_FLOAT64_RTOL)
    pallas = float(pallas_entry(jnp.asarray(pred_t.numpy()),
                                jnp.asarray(gt_t.numpy()), js))
    np.testing.assert_allclose(value, pallas, rtol=NEAR_PALLAS_RTOL)


def _jax_value_and_grad(c, **kw):
    gt = jnp.asarray(c["gt_t"])
    return jax.value_and_grad(
        lambda p: render_pallas.mixed_loss_fused_planes(p, gt, c["js"], **kw))(
            jnp.asarray(c["pred_t"]))


@pytest.mark.parametrize("size", [16, 32])
def test_fwdgrad_plain_matches_pallas(size):
    c = _case(size)
    value, grad = _jax_value_and_grad(c)
    loss, dpred = rf.mixed_loss_fwdgrad_plain(_t(c["pred_t"]), _t(c["gt_t"]),
                                              rf.pack_scenes(c["ts"]))
    np.testing.assert_allclose(float(loss), float(value), rtol=PALLAS_RTOL)
    np.testing.assert_allclose(dpred.numpy(), np.asarray(grad), rtol=2e-4,
                               atol=1e-6)


@pytest.mark.parametrize("size", [16, 32])
def test_fwd_plain_matches_pallas(size):
    """Outside autodiff the JAX entry runs _mixed_fwd_kernel."""
    c = _case(size, seed=1)
    value = render_pallas.mixed_loss_fused_planes(
        jnp.asarray(c["pred_t"]), jnp.asarray(c["gt_t"]), c["js"])
    loss = rf.mixed_loss_fwd_plain(_t(c["pred_t"]), _t(c["gt_t"]),
                                   rf.pack_scenes(c["ts"]))
    np.testing.assert_allclose(float(loss), float(value), rtol=PALLAS_RTOL)


@pytest.mark.parametrize("size,seed", [(16, 0), (32, 1)])
def test_fwd_plain_near_convergence(size, seed):
    """pred within sigma = 1e-3 of gt (bench_setup.loss_inputs_near), where
    validation runs once a model trains: the value plain version against
    float64 (measured 2.2e-6 and 5.5e-7 here; held at NEAR_FLOAT64_RTOL)
    and against _mixed_fwd_kernel (8.1e-6 and 1.03e-5; held at
    NEAR_PALLAS_RTOL)."""
    assert_near_convergence(rf.mixed_loss_fwd_plain,
                            render_pallas.mixed_loss_fused_planes, size, seed)


@pytest.mark.parametrize("size,seed", [(16, 1), (32, 1)])
def test_plain_value_matches_float64(size, seed):
    """The f32 plain versions' sums stay within 1e-6 of the same math in
    float64 (the reference accuracy the kernels' partial sums are held to)."""
    c = _case(size, seed=seed)
    s9 = rf.pack_scenes(c["ts"])
    ref = float(rf.mixed_loss_fwd_plain(
        torch.from_numpy(c["pred_t"]).double(),
        torch.from_numpy(c["gt_t"]).double(), s9.double()))
    loss, _ = rf.mixed_loss_fwdgrad_plain(_t(c["pred_t"]), _t(c["gt_t"]), s9)
    np.testing.assert_allclose(float(loss), ref, rtol=1e-6)
    value = rf.mixed_loss_fwd_plain(_t(c["pred_t"]), _t(c["gt_t"]), s9)
    np.testing.assert_allclose(float(value), ref, rtol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("kind", ["mixed", "rendering"])
def test_plain_dpred_matches_float64(kind, seed):
    """dpred of the f32 plain versions (one reciprocal per quantity, as the
    kernels take them) against the same function in float64: normwise
    ||d32 - d64|| / ||d64|| <= 2e-4. Both the rewritten formula and the
    one with a division per quotient read 2.2e-5 to 7.3e-5 here; what is
    left comes from log-differences within rounding of 0, whose sign
    flips, and from the normals' gradients, which scale an ulp by up to
    1 / denom^3."""
    fn = {"mixed": rf.mixed_loss_fwdgrad_plain,
          "rendering": rf.rendering_loss_fwdgrad_plain}[kind]
    c = _case(32, seed=seed)
    s9 = rf.pack_scenes(c["ts"])
    p, g = torch.from_numpy(c["pred_t"]), torch.from_numpy(c["gt_t"])
    _, d32 = fn(p.float(), g.float(), s9)
    _, d64 = fn(p.double(), g.double(), s9.double())
    err = float((d32.double() - d64).norm() / d64.norm())
    assert err <= 2e-4, err


@pytest.mark.parametrize("l1_weight", [0.1, 0.0, 1.0])
def test_plain_matches_autograd_composition(l1_weight):
    """Both plain versions equal the port's losses.mixed_loss, and its
    autograd gradient, on the same scenes."""
    c = _case(16, seed=2)
    pred = _t(c["pred"]).requires_grad_()
    ref = losses.mixed_loss(pred, _t(c["gt"]), c["ts"], l1_weight)
    ref.backward()
    ref = ref.detach()
    s9 = rf.pack_scenes(c["ts"])
    loss, dpred = rf.mixed_loss_fwdgrad_plain(
        _t(c["pred_t"]), _t(c["gt_t"]), s9, l1_weight=l1_weight)
    value = rf.mixed_loss_fwd_plain(_t(c["pred_t"]), _t(c["gt_t"]), s9,
                                    l1_weight=l1_weight)
    np.testing.assert_allclose(float(loss), float(ref), rtol=1e-5)
    np.testing.assert_allclose(float(value), float(ref), rtol=1e-5)
    np.testing.assert_allclose(dpred.numpy(),
                               pred.grad.numpy().transpose(0, 3, 1, 2),
                               rtol=2e-4, atol=1e-6)


def test_zero_on_identical():
    c = _case(16, seed=3)
    p = _t(c["pred_t"])
    loss, dpred = rf.mixed_loss_fwdgrad_plain(p, p.clone(),
                                              rf.pack_scenes(c["ts"]))
    assert float(loss) == 0.0
    np.testing.assert_array_equal(dpred.numpy(), 0.0)
    assert float(rf.mixed_loss_fwd_plain(p, p.clone(),
                                         rf.pack_scenes(c["ts"]))) == 0.0


def test_function_gradient_and_target():
    """mixed_loss_fused_planes under autograd: the gradient is upstream *
    dpred, the target gets none; under no_grad the value-only path gives
    the same value."""
    c = _case(16, seed=4)
    pred = _t(c["pred_t"]).requires_grad_()
    gt = _t(c["gt_t"]).requires_grad_()
    loss = rf.mixed_loss_fused_planes(pred, gt, c["ts"])
    (3.0 * loss).backward()
    ref_loss, dpred = rf.mixed_loss_fwdgrad_plain(
        _t(c["pred_t"]), _t(c["gt_t"]), rf.pack_scenes(c["ts"]))
    assert float(loss.detach()) == float(ref_loss)
    np.testing.assert_allclose(pred.grad.numpy(), 3.0 * dpred.numpy(),
                               rtol=1e-6)
    assert gt.grad is None
    with torch.no_grad():
        value = rf.mixed_loss_fused_planes(pred, gt, c["ts"])
    assert float(value) == float(ref_loss)


def test_row_offset_and_global_height_match_pallas():
    """Two row halves with their offset and the global height: each equals
    the JAX entry's value and gradient for the same shard, and the halves
    add up to the whole image."""
    c = _case(32, seed=5)
    s9 = rf.pack_scenes(c["ts"])
    full, _ = rf.mixed_loss_fwdgrad_plain(_t(c["pred_t"]), _t(c["gt_t"]), s9)
    total = 0.0
    for r0 in (0, 16):
        half = {**c, "pred_t": c["pred_t"][:, :, r0:r0 + 16],
                "gt_t": c["gt_t"][:, :, r0:r0 + 16]}
        value, grad = _jax_value_and_grad(half, row_offset=r0,
                                          global_height=32)
        loss, dpred = rf.mixed_loss_fwdgrad_plain(
            _t(half["pred_t"]), _t(half["gt_t"]), s9, row_offset=r0,
            global_height=32)
        np.testing.assert_allclose(float(loss), float(value),
                                   rtol=PALLAS_RTOL)
        np.testing.assert_allclose(dpred.numpy(), np.asarray(grad),
                                   rtol=2e-4, atol=1e-6)
        total += float(loss)
    np.testing.assert_allclose(total, float(full), rtol=1e-5)


def test_make_loss_fn_kinds():
    c = _case(16, seed=6)
    pred, gt = _t(c["pred"]), _t(c["gt"])
    mixed = losses.make_loss_fn("mixed")(pred, gt, scenes=c["ts"])
    np.testing.assert_allclose(float(mixed),
                               float(losses.mixed_loss(pred, gt, c["ts"])),
                               rtol=1e-5)
    l1 = losses.make_loss_fn("l1")(pred, gt)
    assert float(l1) == float(losses.svbrdf_l1_loss(pred, gt))
    rendering = losses.make_loss_fn("rendering")(pred, gt, scenes=c["ts"])
    np.testing.assert_allclose(
        float(rendering), float(losses.rendering_loss(pred, gt, c["ts"])),
        rtol=1e-5)
    with pytest.raises(ValueError, match="unknown loss kind"):
        losses.make_loss_fn("render")


def test_wrappers_reject_what_the_kernel_does_not_take():
    c = _case(16, seed=7)
    p, g = _t(c["pred_t"]), _t(c["gt_t"])
    s9 = rf.pack_scenes(c["ts"])
    with pytest.raises(TypeError, match="float32"):
        rf.mixed_loss_fwdgrad(p.half(), g.half(), s9)
    with pytest.raises(ValueError, match="contiguous"):
        rf.mixed_loss_fwd(p.transpose(2, 3), g.transpose(2, 3), s9)
    with pytest.raises(ValueError, match=r"\(B, 12, H, W\)"):
        rf.mixed_loss_fwd(p[:, :9].contiguous(), g[:, :9].contiguous(), s9)
    # CPU tensors never reach a kernel: the CUDA wrappers raise instead.
    for fn in (rf.mixed_loss_fwdgrad_cuda, rf.mixed_loss_fwd_cuda):
        before = fn.launches
        with pytest.raises(RuntimeError, match="CUDA tensors"):
            fn(p, g, s9)
        assert fn.launches == before

