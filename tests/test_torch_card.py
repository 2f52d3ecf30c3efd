"""The loss CUDA kernels and the port's training programs on the card.

Every test here needs a CUDA device (and nvcc, which builds the kernels at
first use); each decides inside the test and skips without one. The file
imports nothing of JAX, so on a machine with a card and without JAX it runs
on its own, without the repo's conftest.py (which sets JAX up):

    python -m pytest --noconftest tests/test_torch_card.py -q

Tolerances: loss rtol 1e-5 (the kernel sums one partial per block, the
plain version over the whole image). dpred and dgt rtol 2e-4 with an absolute floor
of 1e-3 * max|dpred|. The kernels round every op as the plain versions do
on the card, and on an H100 the two agree to the last bit (chip_smoke.py
holds that at the main path's shapes); the floor keeps these tests true
under a torch that rounds some op otherwise, where an ulp grows large: a
normal's gradient sums 27 terms per pixel, some scaled by 1 / denom^3 (up
to 1e9 near the clamp). TF32 is off for every test.
"""

import math

import pytest
import torch

from svbrdf_tpu_torch.data import pipeline
from svbrdf_tpu_torch.losses import to_planes
from svbrdf_tpu_torch.ops import render_fused as rf
from svbrdf_tpu_torch.ops import sampling
from svbrdf_tpu_torch.scene import Scene
from svbrdf_tpu_torch.utils import bench_setup

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(dev, size, batch=2, seed=0):
    """pred and gt planes decoded from two synthetic raw batches, and the
    packed 3 + 6 loss scenes per item, on `dev`."""
    def planes(s):
        raw = bench_setup.synthetic_raw_batch(batch, size, 0, s)["svbrdf"]
        return to_planes(pipeline._decode_u8_svbrdf(torch.from_numpy(raw)))

    g = torch.Generator().manual_seed(seed)
    scenes = rf.pack_scenes(sampling.generate_loss_scenes(batch, generator=g))
    return (planes(seed + 1).to(dev), planes(seed).to(dev), scenes.to(dev))


def _assert_close(actual, expected, rtol, atol=0.0):
    torch.testing.assert_close(actual.cpu(), expected.cpu(), rtol=rtol,
                               atol=atol)


def _assert_grad_close(actual, expected):
    _assert_close(actual, expected, rtol=2e-4,
                  atol=1e-3 * float(expected.abs().max()))


@pytest.mark.parametrize("size", [32, 20])  # 20^2 = 400: a ragged last block
def test_kernels_match_plain(cuda, size):
    p, g, s9 = _case(cuda, size)
    counts = (rf.mixed_loss_fwdgrad_cuda.launches,
              rf.mixed_loss_fwd_cuda.launches)
    loss, dpred = rf.mixed_loss_fwdgrad_cuda(p, g, s9)
    value = rf.mixed_loss_fwd_cuda(p, g, s9)
    assert (rf.mixed_loss_fwdgrad_cuda.launches,
            rf.mixed_loss_fwd_cuda.launches) == (counts[0] + 1, counts[1] + 1)
    ref_loss, ref_dpred = rf.mixed_loss_fwdgrad_plain(p, g, s9)
    _assert_close(loss, ref_loss, rtol=1e-5)
    _assert_close(value, ref_loss, rtol=1e-5)
    _assert_grad_close(dpred, ref_dpred)


def test_row_offset_and_global_height(cuda):
    """Row halves with their offset and the global height match the plain
    version on the same shard and add up to the whole image."""
    p, g, s9 = _case(cuda, 32, seed=1)
    full = rf.mixed_loss_fwd_cuda(p, g, s9)
    total = 0.0
    for r0 in (0, 16):
        ph = p[:, :, r0:r0 + 16].contiguous()
        gh = g[:, :, r0:r0 + 16].contiguous()
        loss, dpred = rf.mixed_loss_fwdgrad_cuda(ph, gh, s9, row_offset=r0,
                                                 global_height=32)
        ref_loss, ref_dpred = rf.mixed_loss_fwdgrad_plain(
            ph, gh, s9, row_offset=r0, global_height=32)
        _assert_close(loss, ref_loss, rtol=1e-5)
        _assert_grad_close(dpred, ref_dpred)
        total += float(loss)
    assert math.isclose(total, float(full), rel_tol=1e-5)


def test_zero_on_identical(cuda):
    """sign(0) is 0 in the kernels, as jnp.sign: no loss, no gradient."""
    p, _, s9 = _case(cuda, 32, seed=2)
    loss, dpred = rf.mixed_loss_fwdgrad_cuda(p, p.clone(), s9)
    assert float(loss) == 0.0
    assert int(torch.count_nonzero(dpred)) == 0
    assert float(rf.mixed_loss_fwd_cuda(p, p.clone(), s9)) == 0.0


def test_fused_planes_autograd(cuda):
    """Under autograd the value+gradient kernel runs once and the gradient
    is upstream * dpred, with none for the target; under no_grad only the
    value-only kernel runs."""
    p, g, s9 = _case(cuda, 32, seed=3)
    scenes = Scene(s9[..., 0:3], s9[..., 3:6], s9[..., 6:9])
    pred, gt = p.clone().requires_grad_(), g.clone().requires_grad_()
    before = (rf.mixed_loss_fwdgrad_cuda.launches,
              rf.mixed_loss_fwd_cuda.launches)
    loss = rf.mixed_loss_fused_planes(pred, gt, scenes)
    (3.0 * loss).backward()
    assert (rf.mixed_loss_fwdgrad_cuda.launches,
            rf.mixed_loss_fwd_cuda.launches) == (before[0] + 1, before[1])
    ref_loss, ref_dpred = rf.mixed_loss_fwdgrad_plain(p, g, s9)
    _assert_close(loss.detach(), ref_loss, rtol=1e-5)
    _assert_grad_close(pred.grad, 3.0 * ref_dpred)
    assert gt.grad is None
    with torch.no_grad():
        value = rf.mixed_loss_fused_planes(pred, gt, scenes)
    assert (rf.mixed_loss_fwdgrad_cuda.launches,
            rf.mixed_loss_fwd_cuda.launches) == (before[0] + 1, before[1] + 1)
    _assert_close(value, ref_loss, rtol=1e-5)


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    p, g, s9 = _case(cuda, 32, seed=4)
    counts = (rf.mixed_loss_fwdgrad_cuda.launches,
              rf.mixed_loss_fwd_cuda.launches)
    with pytest.raises(TypeError, match="float32"):
        rf.mixed_loss_fwdgrad(p.bfloat16(), g.bfloat16(), s9)
    with pytest.raises(ValueError, match="contiguous"):
        rf.mixed_loss_fwd(p.transpose(2, 3), g.transpose(2, 3), s9)
    with pytest.raises(ValueError, match="scenes is on cpu"):
        rf.mixed_loss_fwd(p, g, s9.cpu())
    assert (rf.mixed_loss_fwdgrad_cuda.launches,
            rf.mixed_loss_fwd_cuda.launches) == counts


def test_main_program_on_card(cuda):
    """A small main program: train steps launch the value+gradient kernel
    once each, the eval step the value-only kernel once, predict neither."""
    program = bench_setup.build_main_program(2, 32, 5, 8, seed=1,
                                             device="cuda")
    rf.mixed_loss_fwdgrad_cuda.launches = 0
    rf.mixed_loss_fwd_cuda.launches = 0
    losses = [float(program.train_step(program.raw)) for _ in range(2)]
    eval_loss = float(program.eval_step(program.raw))
    images = torch.rand(2, 1, 32, 32, 3, device=cuda)
    out = program.predict(images)
    assert all(math.isfinite(x) for x in losses + [eval_loss])
    assert (rf.mixed_loss_fwdgrad_cuda.launches,
            rf.mixed_loss_fwd_cuda.launches) == (2, 1)
    assert out.shape == (2, 32, 32, 12) and bool(torch.isfinite(out).all())


RENDERING = (
    (rf.rendering_loss_fwd_cuda, rf.rendering_loss_fwd_plain),
    (rf.rendering_loss_fwdgrad_cuda, rf.rendering_loss_fwdgrad_plain),
    (rf.rendering_loss_fwdgrad_both_cuda,
     rf.rendering_loss_fwdgrad_both_plain),
)


def _rendering_launches():
    return tuple(cuda_fn.launches for cuda_fn, _ in RENDERING)


def _assert_matches_plain(cuda_fn, plain_fn, *args, **kwargs):
    """The kernel's outputs against its plain version's; returns the
    kernel's (loss, grads...)."""
    out = cuda_fn(*args, **kwargs)
    ref = plain_fn(*args, **kwargs)
    out = out if isinstance(out, tuple) else (out,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    _assert_close(out[0], ref[0], rtol=1e-5)
    for grad, ref_grad in zip(out[1:], ref[1:]):
        _assert_grad_close(grad, ref_grad)
    return out


@pytest.mark.parametrize("size", [32, 64])
def test_rendering_kernels_match_plain(cuda, size):
    """Each rendering-loss kernel launches once and agrees with its plain
    version; the three give the same value, and `both` the same dpred as
    fwdgrad."""
    p, g, s9 = _case(cuda, size, seed=5)
    before = _rendering_launches()
    outs = [_assert_matches_plain(cuda_fn, plain_fn, p, g, s9)
            for cuda_fn, plain_fn in RENDERING]
    assert _rendering_launches() == tuple(n + 1 for n in before)
    value, (loss, dpred), (loss_b, dpred_b, dgt) = outs[0][0], outs[1], outs[2]
    _assert_close(value, loss, rtol=1e-6)
    _assert_close(loss_b, loss, rtol=0)
    _assert_close(dpred_b, dpred, rtol=0)
    assert bool(torch.isfinite(dgt).all()) and float(dgt.abs().max()) > 0


def test_rendering_row_offset_and_global_height(cuda):
    """Row halves with their offset and the global height match the plain
    version on the same shard and add up to the whole image."""
    p, g, s9 = _case(cuda, 32, seed=6)
    full = rf.rendering_loss_fwd_cuda(p, g, s9)
    total = 0.0
    for r0 in (0, 16):
        ph = p[:, :, r0:r0 + 16].contiguous()
        gh = g[:, :, r0:r0 + 16].contiguous()
        for cuda_fn, plain_fn in RENDERING:
            out = _assert_matches_plain(cuda_fn, plain_fn, ph, gh, s9,
                                        row_offset=r0, global_height=32)
        total += float(out[0])
    assert math.isclose(total, float(full), rel_tol=1e-5)


def test_rendering_zero_on_identical(cuda):
    p, _, s9 = _case(cuda, 32, seed=7)
    assert float(rf.rendering_loss_fwd_cuda(p, p.clone(), s9)) == 0.0
    loss, dpred, dgt = rf.rendering_loss_fwdgrad_both_cuda(p, p.clone(), s9)
    assert float(loss) == 0.0
    assert int(torch.count_nonzero(dpred)) == 0
    assert int(torch.count_nonzero(dgt)) == 0
    loss, dpred = rf.rendering_loss_fwdgrad_cuda(p, p.clone(), s9)
    assert float(loss) == 0.0 and int(torch.count_nonzero(dpred)) == 0


@pytest.mark.parametrize("want_target_grad", [False, True])
def test_rendering_fused_planes_autograd(cuda, want_target_grad):
    """Under autograd one value+gradient kernel runs (the `both` one with
    want_target_grad) and the gradients are upstream * dpred (and dgt);
    without want_target_grad the target gets none. Under no_grad only the
    value-only kernel runs."""
    p, g, s9 = _case(cuda, 32, seed=8)
    scenes = Scene(s9[..., 0:3], s9[..., 3:6], s9[..., 6:9])
    pred, gt = p.clone().requires_grad_(), g.clone().requires_grad_()
    before = _rendering_launches()
    loss = rf.rendering_loss_fused_planes(pred, gt, scenes,
                                          want_target_grad=want_target_grad)
    (3.0 * loss).backward()
    fwd, fwdgrad, both = before
    expect = ((fwd, fwdgrad, both + 1) if want_target_grad
              else (fwd, fwdgrad + 1, both))
    assert _rendering_launches() == expect
    ref_loss, ref_dpred, ref_dgt = rf.rendering_loss_fwdgrad_both_plain(
        p, g, s9)
    _assert_close(loss.detach(), ref_loss, rtol=1e-5)
    _assert_grad_close(pred.grad, 3.0 * ref_dpred)
    if want_target_grad:
        _assert_grad_close(gt.grad, 3.0 * ref_dgt)
    else:
        assert gt.grad is None
    with torch.no_grad():
        value = rf.rendering_loss_fused_planes(pred, gt, scenes)
    assert _rendering_launches() == (expect[0] + 1,) + expect[1:]
    _assert_close(value, ref_loss, rtol=1e-5)


@pytest.mark.parametrize("batch", [1, 3])
def test_kernels_on_a_ragged_grid(cuda, batch):
    """All five kernels against their plain versions on 250 x 243 planes,
    one block per 256-pixel tile of each item: the image is not square and
    H*W is no multiple of the block, so each item's last block is ragged
    and masked. At B=3 the items past the first (grid row blockIdx.y) read,
    write and index their partials at their own offsets. pred = gt gives
    exactly 0."""
    p, g, s9 = _case(cuda, 256, batch=batch, seed=9)
    p = p[:, :, :250, :243].contiguous()
    g = g[:, :, :250, :243].contiguous()
    for name, plain in rf.PLAIN_VERSIONS.items():
        _assert_matches_plain(rf.CUDA_WRAPPERS[name], plain, p, g, s9)
        zero = rf.CUDA_WRAPPERS[name](g.clone(), g, s9)
        zero = zero if isinstance(zero, tuple) else (zero,)
        assert float(zero[0]) == 0.0
        assert all(int(torch.count_nonzero(z)) == 0 for z in zero[1:])


def test_multi_view_rendering_program_on_card(cuda):
    """A small multi-view rendering-loss program: train steps launch the
    rendering value+gradient kernel once each, the eval step the value-only
    kernel once, predict none, and no mixed-loss kernel runs."""
    program = bench_setup.build_program("multi", "rendering", 2, 32, 5, 8,
                                        seed=1, device="cuda")
    for fn in rf.CUDA_WRAPPERS.values():
        fn.launches = 0
    losses = [float(program.train_step(program.raw)) for _ in range(2)]
    eval_loss = float(program.eval_step(program.raw))
    out = program.predict(torch.rand(2, 3, 32, 32, 3, device=cuda))
    assert all(math.isfinite(x) for x in losses + [eval_loss])
    assert {k: fn.launches for k, fn in rf.CUDA_WRAPPERS.items()} == {
        "mixed_fwdgrad": 0, "mixed_fwd": 0, "render_fwdgrad": 2,
        "render_fwd": 1, "render_fwdgrad_both": 0}
    assert out.shape == (2, 32, 32, 12) and bool(torch.isfinite(out).all())
