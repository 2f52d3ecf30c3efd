"""The port on the card: its CUDA kernels against their plain versions,
its programs, CLI, launcher, data and spatial parallelism, inference API
and tools, each with its kernel launches counted.

Every test here needs a CUDA device (and nvcc, which builds the kernels at
first use); each decides inside the test or a fixture and skips without
one. The file imports nothing of JAX, so on a machine with a card and
without JAX it runs on its own, without the repo's conftest.py (which sets
JAX up):

    python -m pytest --noconftest tests/test_torch_card.py -q

It is the port's one card check; its timings come from the benchmark
(bench_gpu/run.py --trace 1). Full width (B=8, 256^2, S=9; depth 8, 64
filters) where a check is about the kernels' shapes or the main path's
launches; the smallest size that exercises it elsewhere (the CLI, the
launcher, the toy data, the examples, spatial sharding).

Tolerances: loss rtol 1e-5 (the kernel sums one partial per block, the
plain version over the whole image; the value-only kernels and the kernel
with both gradients also shade with other roundings, csrc/value_shading.cuh
and csrc/value_vjp.cuh). dpred rtol 2e-4 with an absolute floor of 1e-3 *
max|dpred| for the two training kernels at small sizes: they round every op
as the plain versions do on the card, and on an H100 the two agree to the
last bit, which the paths' shapes hold (_assert_grad_exact); the floor
keeps the small tests true under a torch that rounds some op otherwise,
where an ulp grows large: a normal's gradient sums 27 terms per pixel, some
scaled by 1 / denom^3 (up to 1e9 near the clamp). The kernel with both
gradients is held normwise (_assert_both_close,
test_both_kernel_within_tolerance). A bf16 kernel computes what its f32
instantiation computes on the upcast planes, each gradient rounded once to
bf16. The fused SR-Adam kernel (csrc/sr_adam.cu) is bit-exact against its
plain version, in its 'bf16' state mode too; a bf16 step with bf16-SR
masters on the card is held to the same step on the CPU. TF32 is off in
the test process (the `cuda` fixture); ranks it spawns start with torch's
defaults.
"""

import contextlib
import io
import itertools
import json
import math
import pathlib

import numpy as np
import pytest
import torch

from svbrdf_tpu_torch.data import pipeline
from svbrdf_tpu_torch.losses import to_planes
from svbrdf_tpu_torch.ops import render_fused as rf
from svbrdf_tpu_torch.ops import sampling
from svbrdf_tpu_torch.scene import Scene
from svbrdf_tpu_torch.utils import bench_setup

torch.set_num_threads(1)

BF16 = torch.bfloat16
REPO = pathlib.Path(__file__).resolve().parents[1]


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


def _normwise(actual, expected, keep=None):
    """||actual - expected|| / ||expected|| in float64, over the pixels
    where `keep` ((B, H, W)) is true, or all."""
    actual, expected = actual.double(), expected.double()
    if keep is not None:
        actual, expected = actual * keep[:, None], expected * keep[:, None]
    return float((actual - expected).norm() / expected.norm())


def _assert_both_close(out, ref):
    """The kernel with both gradients against its plain version (loss,
    dpred, dgt): it shades with other roundings, so loss rtol 1e-5 and
    each gradient normwise within 1e-3 of the plain version's, where a
    log-difference within rounding of 0 may flip its sign in one and not
    in the other."""
    _assert_close(out[0], ref[0], rtol=1e-5)
    for grad, ref_grad in zip(out[1:], ref[1:]):
        assert grad.dtype == ref_grad.dtype
        assert _normwise(grad, ref_grad) <= 1e-3


def _assert_grad_exact(actual, expected):
    """A training kernel's gradient against its plain version at the
    paths' shapes (bench_setup.grad_distance)."""
    assert bench_setup.grad_distance(actual, expected) \
        <= bench_setup.GRAD_EXACT


def _outputs(out):
    """(loss, gradients...) of a kernel's wrapper or plain version."""
    return out if isinstance(out, tuple) else (out,)


def _counted(fn):
    """fn() with every launch counter set to 0 just before and read just
    after: (result, launches)."""
    torch.cuda.synchronize()
    bench_setup.zero_launch_counts()
    result = fn()
    torch.cuda.synchronize()
    return result, bench_setup.launch_counts()


def _expect_launches(counts, expected):
    """Every launch counter (bench_setup.launch_counts) at `expected`'s
    value, 0 where `expected` names none."""
    assert set(expected) <= set(counts)
    assert counts == {k: expected.get(k, 0) for k in counts}


def _spatial_tail_launches(train, forwards, size, depth, world=2):
    """bench_setup.tail_launches of the single-view model sharded by
    height over `world` ranks (parallel/spatial), on each rank: only the
    blocks that run whole there launch the kernels, those whose height does
    not split (spatial.splits: a multiple of the world and at least one row
    a rank); the sharded ones take spatial._norm_merge. The first encoder
    block has no tail."""
    def whole(height):
        return height % world != 0 or height < world

    tails = (sum(whole(size >> (i + 1)) for i in range(1, depth))
             + sum(whole(size >> (depth - i)) for i in range(depth)))
    return {"norm_merge_fwd": tails * (train + forwards),
            "norm_merge_bwd": tails * train}


def _grids(printout):
    """Comparison grids a CLI run printed that it wrote: after training it
    predicts each held-out sample, one forward each (on rank 0 alone)."""
    return sum(line.startswith("wrote ") and line.endswith(".png")
               for line in printout.splitlines())


@contextlib.contextmanager
def _torch_default_tf32():
    """TF32 as torch sets it by default (convolutions on, matrix products
    off), as a process that never set it runs: the spatial CLI's ranks."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


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
        rf.mixed_loss_fwdgrad(p.half(), g.half(), s9)
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
    if cuda_fn is rf.rendering_loss_fwdgrad_both_cuda:
        _assert_both_close(out, ref)
        return out
    _assert_close(out[0], ref[0], rtol=1e-5)
    for grad, ref_grad in zip(out[1:], ref[1:]):
        _assert_grad_close(grad, ref_grad)
    return out


@pytest.mark.parametrize("size", [32, 64])
def test_rendering_kernels_match_plain(cuda, size):
    """Each rendering-loss kernel launches once and agrees with its plain
    version; the three give the same value, and `both`, which shades on
    another algebra (csrc/value_vjp.cuh), dpred normwise within 1e-3 of
    fwdgrad's."""
    p, g, s9 = _case(cuda, size, seed=5)
    before = _rendering_launches()
    outs = [_assert_matches_plain(cuda_fn, plain_fn, p, g, s9)
            for cuda_fn, plain_fn in RENDERING]
    assert _rendering_launches() == tuple(n + 1 for n in before)
    value, (loss, dpred), (loss_b, dpred_b, dgt) = outs[0][0], outs[1], outs[2]
    _assert_close(value, loss, rtol=1e-6)
    _assert_close(loss_b, loss, rtol=1e-5)
    assert _normwise(dpred_b, dpred) <= 1e-3
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
    """pred = gt: exactly 0 from every rendering kernel, in f32 and bf16
    (`both`'s two sides run the same instructions, csrc/value_vjp.cuh)."""
    p, _, s9 = _case(cuda, 32, seed=7)
    for planes in (p, p.bfloat16()):
        assert float(rf.rendering_loss_fwd_cuda(planes, planes.clone(),
                                                s9)) == 0.0
        loss, dpred, dgt = rf.rendering_loss_fwdgrad_both_cuda(
            planes, planes.clone(), s9)
        assert float(loss) == 0.0
        assert int(torch.count_nonzero(dpred)) == 0
        assert int(torch.count_nonzero(dgt)) == 0
        loss, dpred = rf.rendering_loss_fwdgrad_cuda(planes, planes.clone(),
                                                     s9)
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
    if want_target_grad:
        ref_loss, *ref_grads = rf.rendering_loss_fwdgrad_both_plain(p, g, s9)
        _assert_both_close((loss.detach(), pred.grad, gt.grad),
                           (ref_loss, *(3.0 * d for d in ref_grads)))
    else:
        ref_loss, ref_dpred = rf.rendering_loss_fwdgrad_plain(p, g, s9)
        _assert_close(loss.detach(), ref_loss, rtol=1e-5)
        _assert_grad_close(pred.grad, 3.0 * ref_dpred)
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


@pytest.mark.parametrize("name", sorted(rf.PLAIN_VERSIONS))
def test_bf16_kernels_match_plain(cuda, name):
    """Each kernel on bf16 planes (20^2: a ragged last block) launches once,
    computes what its f32 instantiation computes on the upcast planes, the
    loss to the bit and each gradient rounded once to bf16, and agrees with
    its plain version on the same bf16 planes: the two training kernels'
    gradients within one bf16 ulp (their f32 ones agree to the last bit on
    an H100), the value kernels' loss at rtol 1e-5, `both` as in
    _assert_both_close. pred = gt gives exactly 0."""
    wrapper, plain = rf.CUDA_WRAPPERS[name], rf.PLAIN_VERSIONS[name]
    p, g, s9 = _case(cuda, 20, seed=11)
    p, g = p.bfloat16(), g.bfloat16()
    before = wrapper.launches
    out = wrapper(p, g, s9)
    assert wrapper.launches == before + 1
    out = out if isinstance(out, tuple) else (out,)
    out32 = wrapper(p.float(), g.float(), s9)
    out32 = out32 if isinstance(out32, tuple) else (out32,)
    assert out[0].dtype == torch.float32 and torch.equal(out[0], out32[0])
    for grad, grad32 in zip(out[1:], out32[1:]):
        assert grad.dtype == torch.bfloat16
        assert torch.equal(grad, grad32.to(torch.bfloat16))
    ref = plain(p, g, s9)
    ref = ref if isinstance(ref, tuple) else (ref,)
    if name == "render_fwdgrad_both":
        _assert_both_close(out, ref)
    else:
        _assert_close(out[0], ref[0], rtol=1e-5)
        for grad, ref_grad in zip(out[1:], ref[1:]):
            _assert_close(grad.float(), ref_grad.float(), rtol=8e-3,
                          atol=1e-3 * float(ref_grad.float().abs().max()))
    zero = wrapper(g.clone(), g, s9)
    zero = zero if isinstance(zero, tuple) else (zero,)
    assert float(zero[0]) == 0.0
    assert all(int(torch.count_nonzero(z)) == 0 for z in zero[1:])


@pytest.mark.parametrize("near", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_both_kernel_within_tolerance(cuda, dtype, near):
    """The kernel with both gradients (csrc/value_vjp.cuh) on
    bench_setup.loss_inputs (far) or loss_inputs_near at the paths' shapes
    (B=8, 256^2, S=9, seed 3; test_kernels_on_the_paths_inputs takes
    seed 0): loss rel
    <= 1e-5 against its plain version; dpred and dgt against the plain
    version in float64 (on the same, quantized, planes) normwise no further
    than 2x the plain version's own distance from it, and for f32 <= 2e-4
    (bf16's own rounding is ~2e-3), over the pixels at least
    render_fused.KINK_MARGIN from the loss's kinks, where f32 evaluations
    agree on the one-sided derivative (closer, one such pixel can put the
    plain version itself 1e-2 from float64 over the whole image); exactly 0
    for pred = gt; a NaN in pred gives a NaN loss."""
    make = bench_setup.loss_inputs_near if near else bench_setup.loss_inputs
    p, g, s9 = make(8, 256, 9, seed=3, device=cuda, dtype=dtype)
    out = rf.rendering_loss_fwdgrad_both_cuda(p, g, s9)
    ref = rf.rendering_loss_fwdgrad_both_plain(p, g, s9)
    inputs64 = (p.double(), g.double(), s9.double())
    ref64 = rf.rendering_loss_fwdgrad_both_plain(*inputs64)
    keep = rf.kink_distance(*inputs64) >= rf.KINK_MARGIN
    _assert_close(out[0], ref[0], rtol=1e-5)
    for grad, plain_grad, grad64 in zip(out[1:], ref[1:], ref64[1:]):
        err = _normwise(grad, grad64, keep)
        assert err <= 2.0 * _normwise(plain_grad, grad64, keep)
        if dtype == torch.float32:
            assert err <= 2e-4
    zero = rf.rendering_loss_fwdgrad_both_cuda(g.clone(), g, s9)
    assert float(zero[0]) == 0.0
    assert all(int(torch.count_nonzero(z)) == 0 for z in zero[1:])
    q = p.clone()
    q[1, 3, 7, 5] = math.nan
    assert math.isnan(float(rf.rendering_loss_fwdgrad_both_cuda(q, g, s9)[0]))


@pytest.mark.parametrize("near", [False, True], ids=["far", "near"])
@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", sorted(rf.PLAIN_VERSIONS))
def test_kernels_on_the_paths_inputs(cuda, name, dtype, near):
    """Each loss kernel at the paths' shapes (B=8, 12 x 256 x 256 planes,
    S=9) on bench_setup.loss_inputs (pred far from gt) or loss_inputs_near
    (pred near gt, as validation sees a trained model), f32 or bf16 planes:
    loss rel 1e-5 against its plain version; every gradient finite and in
    the planes' dtype; the two training kernels' gradients exact
    (_assert_grad_exact for f32 planes, equal for bf16: each the f32 value
    rounded once), `both`'s held by test_both_kernel_within_tolerance. A
    bf16 launch equals its f32 instantiation on the upcast planes, the
    gradients rounded once; with pred far from gt its loss lies within
    rel 2e-2 of the f32 loss on the unquantized planes, as the JAX
    package's bf16 test holds it (near gt, rounding each side to bf16,
    ~2e-3, moves it further than the 1e-3 that parts them). pred = gt gives
    a loss and gradients of exactly 0."""
    make = bench_setup.loss_inputs_near if near else bench_setup.loss_inputs
    inputs = make(8, 256, 9, device=cuda, dtype=dtype)
    wrapper, plain = rf.CUDA_WRAPPERS[name], rf.PLAIN_VERSIONS[name]
    out, ref = _outputs(wrapper(*inputs)), _outputs(plain(*inputs))
    _assert_close(out[0], ref[0], rtol=1e-5)
    for grad, ref_grad in zip(out[1:], ref[1:]):
        assert grad.dtype == dtype and bool(torch.isfinite(grad).all())
        if name == "render_fwdgrad_both":
            continue
        if dtype == BF16:
            assert torch.equal(grad, ref_grad)
        else:
            _assert_grad_exact(grad, ref_grad)
    if dtype == BF16:
        pred_t, gt_t, scenes9 = inputs
        out32 = _outputs(wrapper(pred_t.float(), gt_t.float(), scenes9))
        assert torch.equal(out[0], out32[0])
        for grad, grad32 in zip(out[1:], out32[1:]):
            assert torch.equal(grad, grad32.to(BF16))
        if not near:
            loss32 = float(_outputs(wrapper(*make(8, 256, 9,
                                                  device=cuda)))[0])
            assert abs(float(out[0]) - loss32) <= 2e-2 * abs(loss32)
    gt_t, scenes9 = inputs[1], inputs[2]
    zero = _outputs(wrapper(gt_t.clone(), gt_t, scenes9))
    assert float(zero[0]) == 0.0
    assert all(int(torch.count_nonzero(z)) == 0 for z in zero[1:])


# The planes entries under autograd, each with the one kernel it must
# launch: entry, its keywords, the kernel, the planes' dtype, the upstream
# scalar (for bf16 not a bf16 value, so the product rounds).
PLANES_ENTRIES = {
    "rendering_target_grad": ("rendering_loss_fused_planes",
                              {"want_target_grad": True},
                              "render_fwdgrad_both", torch.float32, 3.0),
    "mixed_bf16": ("mixed_loss_fused_planes", {}, "mixed_fwdgrad", BF16,
                   3.1),
    "rendering_target_grad_bf16": ("rendering_loss_fused_planes",
                                   {"want_target_grad": True},
                                   "render_fwdgrad_both", BF16, 3.1),
}


@pytest.mark.parametrize("case", sorted(PLANES_ENTRIES))
def test_planes_entries_give_the_kernels_gradients(cuda, case):
    """A planes entry under autograd at the paths' shapes, both inputs
    requiring grad, every launch counter read around the call and its
    backward: the one value+gradient kernel launches once (its bf16
    instantiation on bf16 planes) and nothing else; the loss equals that
    kernel's, each .grad is in the planes' dtype and equals the kernel's
    gradient times the upstream scalar in f32, rounded once; without the
    target's gradient the target gets none."""
    entry, kw, kernel, dtype, upstream = PLANES_ENTRIES[case]
    p, g, s9 = bench_setup.loss_inputs(8, 256, 9, device=cuda, dtype=dtype)
    scenes = Scene(s9[..., 0:3], s9[..., 3:6], s9[..., 6:9])
    pred, gt = p.clone().requires_grad_(), g.clone().requires_grad_()

    def call():
        loss = getattr(rf, entry)(pred, gt, scenes, **kw)
        (upstream * loss).backward()
        return loss.detach()

    loss, counts = _counted(call)
    _expect_launches(counts, {kernel + rf.PLANE_DTYPES[dtype]: 1})
    ref_loss, *grads = rf.CUDA_WRAPPERS[kernel](p, g, s9)
    assert torch.equal(loss, ref_loss)
    have = [pred.grad, gt.grad] if len(grads) == 2 else [pred.grad]
    if len(grads) == 1:
        assert gt.grad is None
    for grad, d in zip(have, grads):
        assert grad.dtype == dtype
        assert torch.equal(grad, (d.float() * upstream).to(dtype))


@pytest.mark.parametrize("name", ["mixed_fwd", "render_fwd"])
def test_value_kernels_near_convergence(cuda, name):
    """The value-only kernels, which shade with their own roundings, on
    pred near gt (bench_setup.loss_inputs_near), where a loss term is
    ~1e-2 and a bias that near-equal sides do not cancel would show: loss
    rtol 1e-5 against the plain version on a ragged grid (20^2 = 400: two
    blocks, the second masked), and exactly 0 for pred = gt."""
    p, g, s9 = bench_setup.loss_inputs_near(2, 20, 9, seed=1, device=cuda)
    value = rf.CUDA_WRAPPERS[name](p, g, s9)
    _assert_close(value, rf.PLAIN_VERSIONS[name](p, g, s9), rtol=1e-5)
    assert float(rf.CUDA_WRAPPERS[name](g.clone(), g, s9)) == 0.0
    assert float(rf.CUDA_WRAPPERS[name](p, p.clone(), s9)) == 0.0


@pytest.mark.parametrize("name", ["mixed_fwd", "render_fwd"])
def test_value_kernels_propagate_non_finite_predictions(cuda, name):
    """A NaN or an infinite value in one pixel of pred (its diffuse red,
    which the rendering term and the mixed loss's log-space L1 term both
    read) gives a non-finite loss, as the plain version does, and a NaN
    gives NaN: a model that diverged logs a non-finite validation loss."""
    p, g, s9 = _case(cuda, 20, seed=10)
    for bad in (math.nan, math.inf):
        q = p.clone()
        q[1, 3, 7, 5] = bad
        value = float(rf.CUDA_WRAPPERS[name](q, g, s9))
        plain = float(rf.PLAIN_VERSIONS[name](q, g, s9))
        assert not math.isfinite(value) and not math.isfinite(plain)
        if math.isnan(bad):
            assert math.isnan(value) and math.isnan(plain)


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


@pytest.mark.parametrize("kind, loss_kind, views", [
    ("single", "mixed", 1), ("multi", "rendering", 3)])
def test_step_card_matches_cpu(cuda, kind, loss_kind, views):
    """One f32 train step, the eval loss and a prediction of a small model
    (depth 5, 32^2, 8 filters, batch 2, dropout off) on the card against
    the same program, weights, batch and scenes on the CPU, where the loss
    runs the plain versions: losses rel 1e-4, the gradients normwise 1e-3,
    the maps within 1e-4."""
    from svbrdf_tpu_torch import losses
    from svbrdf_tpu_torch.models import build_model
    from svbrdf_tpu_torch.parallel import step as step_lib

    g = torch.Generator().manual_seed(3)
    prep = step_lib.PrepConfig(used_input_image_count=views,
                               mix_materials=True)
    raw = {k: torch.from_numpy(v) for k, v in
           bench_setup.synthetic_raw_batch(2, 32, 0, seed=3).items()}
    batch = step_lib.prepare(raw, prep, g)
    scenes = sampling.generate_loss_scenes(2, generator=g)
    loss_fn = losses.make_loss_fn(loss_kind)
    results = {}
    for dev in ("cpu", cuda):
        model = build_model(kind, False, 5, 8, device="cpu", seed=3).to(dev)
        for m in model.modules():
            if isinstance(m, torch.nn.Dropout):
                m.eval()
        step = step_lib.make_train_step(
            model, step_lib.make_optimizer(model.parameters()), loss_fn,
            prep, None)
        b = {k: v.to(dev) for k, v in batch.items()}
        sc = scenes.to(dev)
        loss = float(step.update(b, scenes=sc))
        grads = torch.cat([p.grad.flatten() for p in model.parameters()
                           if p.grad is not None]).cpu()
        with torch.no_grad():
            pred = step_lib.make_predict_fn(model)(b["inputs"])
            eval_loss = float(loss_fn(pred, b["svbrdf"], scenes=sc))
        results[str(dev)] = (loss, grads, eval_loss, pred.cpu())
    (lc, gc, ec, pc), (lg, gg, eg, pg) = results["cpu"], results[str(cuda)]
    assert abs(lg - lc) <= 1e-4 * abs(lc)
    assert abs(eg - ec) <= 1e-4 * abs(ec)
    assert float((gg - gc).norm() / gc.norm()) <= 1e-3
    assert float((pg - pc).abs().max()) <= 1e-4


STEPS = 5


@pytest.mark.parametrize("path", sorted(bench_setup.PATHS))
def test_paths_launch_every_counter(cuda, path):
    """A path at full width: 5 train steps, then an eval step and predict,
    every launch counter read after the train steps and after the rest:
    each exactly as the path's kernels, the block tails (one forward launch
    a tail a forward, one backward a tail a train step) and sr_adam (one a
    bf16-SR step) say, every other 0. Finite losses; a bf16-SR path keeps
    bf16 >=2-D masters and f32 1-D ones and moves more than 5 % of the
    bf16 elements (as tests/test_training.py::TestBf16SRMasters asks); the
    prediction f32 maps of the batch's shape, unit normals, maps in
    [0, 1]."""
    from svbrdf_tpu_torch.device import precision_scope
    from svbrdf_tpu_torch.parallel.step import prepare

    kinds, dtype, master, renderer, (per_train, per_eval) = \
        bench_setup.PATHS[path]
    with precision_scope(dtype):
        program = bench_setup.build_program(
            *kinds, 8, 256, 8, 64, seed=0, device="cuda", dtype=dtype,
            master_dtype=master, renderer=renderer)
        before = [p.detach().clone() for p in program.model.parameters()]
        losses, after_train = _counted(lambda: [
            float(program.train_step(program.raw)) for _ in range(STEPS)])
        sr = ({"sr_adam": STEPS
               * bench_setup.sr_adam_launches(program.model)}
              if master == "bf16sr" else {})
        _expect_launches(after_train, {
            **{k: STEPS * v for k, v in per_train.items()}, **sr,
            **bench_setup.tail_launches(kinds[0], STEPS)})
        images = prepare(program.raw, program.prep,
                         program.generator)["inputs"]
        (eval_loss, maps), counts = _counted(lambda: (
            float(program.eval_step(program.raw)), program.predict(images)))
    _expect_launches(counts, {**per_eval,
                              **bench_setup.tail_launches(kinds[0], 0, 2)})
    assert all(math.isfinite(x) for x in losses + [eval_loss])
    if master == "bf16sr":
        changed = total = 0
        for p0, p in zip(before, program.model.parameters()):
            assert p.dtype == (BF16 if p.dim() >= 2 else torch.float32)
            if p.dim() >= 2:
                changed += int((p0 != p).sum())
                total += p.numel()
        assert changed > 0.05 * total
    assert maps.shape == (8, 256, 256, 12) and maps.dtype == torch.float32
    assert bool(torch.isfinite(maps).all())
    assert float((maps[..., :3].norm(dim=-1) - 1.0).abs().max()) <= 1e-4
    assert 0.0 <= float(maps[..., 3:].min()) <= float(maps[..., 3:].max()) \
        <= 1.0


def test_cli_trains_resumes_and_tests_on_the_card(cuda, tmp_path):
    """The CLI at depth 5, 32^2, 8 filters, f32, on cuda:0: each train step
    launches the mixed value+gradient kernel once and nothing else runs a
    loss kernel (no validation split with 2 samples); resume continues from
    the saved epoch; test mode writes a grid and metrics.json. The
    checkpoint written on the card, loaded on the CPU, predicts within 1e-4
    of the card."""
    from svbrdf_tpu_torch.main import main
    from svbrdf_tpu_torch.models import build_model
    from svbrdf_tpu_torch.parallel.step import make_predict_fn
    from svbrdf_tpu_torch.training.checkpoint import Checkpoint

    data = REPO / "data"
    common = ["--image-count", "10", "--image-size", "32", "--model-depth",
              "5", "--num-filters", "8", "--batch-size", "2",
              "--model-dir", str(tmp_path / "m"), "--gpu-id", "0",
              "--num-devices", "1", "--dtype", "float32"]
    train = ["--mode", "train", "--input-dir", str(data / "train"),
             "--save-frequency", "1", "--validation-frequency", "1"] + common
    runs = []
    for extra in (["--epochs", "2", "--retrain"], ["--epochs", "3"]):
        for fn in rf.CUDA_WRAPPERS.values():
            fn.launches = 0
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            run = main(train + extra)
        torch.cuda.synchronize()
        assert {k: fn.launches for k, fn in rf.CUDA_WRAPPERS.items()} == {
            "mixed_fwdgrad": run.steps, "mixed_fwd": 0, "render_fwdgrad": 0,
            "render_fwd": 0, "render_fwdgrad_both": 0}
        assert run.steps == 2 and math.isfinite(run.last_loss)
        runs.append((run, out.getvalue()))
    assert "Restored epoch 1" in runs[1][1]
    with contextlib.redirect_stdout(io.StringIO()):
        written = main(["--mode", "test", "--input-dir", str(data / "test")]
                       + common)
    summary = json.loads((tmp_path / "m" / "test_outputs" /
                          "metrics.json").read_text())
    assert len(written) == 1
    assert all(math.isfinite(v) for v in summary["mean"].values())

    model = runs[1][0].model
    cpu_model = build_model("single", False, 5, 8, device="cpu")
    with contextlib.redirect_stdout(io.StringIO()):
        Checkpoint.load(tmp_path / "m").restore_params(cpu_model)
    images = torch.rand(2, 1, 32, 32, 3,
                        generator=torch.Generator().manual_seed(0))
    on_card = make_predict_fn(model)(images.to(cuda)).cpu()
    on_cpu = make_predict_fn(cpu_model)(images)
    torch.testing.assert_close(on_cpu, on_card, rtol=0, atol=1e-4)


# The CLI runs: 101 maps-only 32^2 strips (the 1 % split holds one out:
# 13 steps of 8 an epoch, one validation batch), depth 5, 8 filters.
CLI_SAMPLES = 101
PER_EPOCH = math.ceil(math.ceil(CLI_SAMPLES * 0.99) / 8)
WIDTH = ["--image-size", "32", "--model-depth", "5", "--num-filters", "8",
         "--batch-size", "8", "--gpu-id", "0"]
MIXED = ["--used-image-count", "1", "--loss", "mixed"]
RENDER = ["--model-type", "multi", "--used-image-count", "3", "--loss",
          "render"]
F32 = ["--dtype", "float32"]
# The keys of the JAX package's metrics.json (svbrdf_tpu/metrics.py).
METRIC_KEYS = ("rmse_normals", "rmse_diffuse", "rmse_roughness",
               "rmse_specular", "log_rmse_diffuse", "log_rmse_specular",
               "ssim_normals", "ssim_diffuse", "ssim_roughness",
               "ssim_specular", "rendering_rmse")


@pytest.fixture(scope="module")
def maps_corpus(tmp_path_factory):
    """CLI_SAMPLES maps-only 32^2 strips: the map tiles' corners of the two
    training strips, written with the port's PNG writer, and symlinks."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CLI runs on the card")
    from svbrdf_tpu_torch.data import png, strips

    out = tmp_path_factory.mktemp("maps")
    for n, path in enumerate(strips.list_sample_files(
            str(REPO / "data" / "train"))):
        strip = strips.read_image_u8(path)
        png.write_png_rgb8(str(out / f"maps_{n}.png"), np.concatenate(
            [strip[:32, (10 + k) * 256:(10 + k) * 256 + 32]
             for k in range(4)], axis=1))
    for n in range(2, CLI_SAMPLES):
        (out / f"link_{n:03d}.png").symlink_to(out / f"maps_{n % 2}.png")
    return out


def _train_argv(data, model_dir, *extra, devices=True):
    return (["--mode", "train", "--input-dir", str(data), "--image-count",
             "0", "--save-frequency", "1", "--validation-frequency", "1",
             "--model-dir", str(model_dir)] + WIDTH
            + (["--num-devices", "1"] if devices else []) + list(extra))


def _cli(argv, entry=None):
    """main(argv) (or entry(argv)) with its printout captured and every
    launch counter read around it: (result, printout, launches)."""
    from svbrdf_tpu_torch.main import main

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result, counts = _counted(lambda: (entry or main)(argv))
    return result, out.getvalue(), counts


def _cli_train(argv, kernels, epochs, sr_adam=False, entry=None,
               kind="single"):
    """A training run of `epochs` epochs: PER_EPOCH steps and one
    validation batch an epoch, the loss kernels (train step, eval step)
    once each, sr_adam once a step where `sr_adam`, the block tails for
    the steps, the validation batches and the held-out samples' grids, 0
    elsewhere; a finite last loss. (run, printout)."""
    run, text, counts = _cli(argv, entry)
    assert (run.steps, run.validation_batches) == (epochs * PER_EPOCH,
                                                   epochs)
    expected = {kernels[0]: run.steps, kernels[1]: run.validation_batches,
                **bench_setup.tail_launches(
                    kind, run.steps, run.validation_batches + _grids(text),
                    5)}
    if sr_adam:
        expected["sr_adam"] = (run.steps
                               * bench_setup.sr_adam_launches(run.model))
    _expect_launches(counts, expected)
    assert math.isfinite(run.last_loss)
    return run, text


def _adam_steps(model_dir):
    blob = torch.load(model_dir / "checkpoint.tar", map_location="cpu",
                      weights_only=True)
    return int(blob["optimizer_state_dict"]["state"][0]["step"])


def _reloaded(model_dir, dtype=torch.float32, master=None):
    """A fresh single-view model (depth 5, 8 filters) on the card restored
    from the checkpoint in `model_dir`, its masters cast by `master`."""
    from svbrdf_tpu_torch.models import build_model
    from svbrdf_tpu_torch.parallel import step as step_lib
    from svbrdf_tpu_torch.training.checkpoint import Checkpoint

    fresh = build_model("single", False, 5, 8, device="cuda", seed=1,
                        dtype=dtype)
    with contextlib.redirect_stdout(io.StringIO()):
        Checkpoint.load(model_dir).restore_params(fresh)
    if master is not None:
        with step_lib.master_dtype_scope():
            step_lib.set_master_dtype_policy(master)
            step_lib.master_cast(fresh)
    return fresh


def _same_prediction(a, b):
    from svbrdf_tpu_torch.parallel.step import make_predict_fn

    images = torch.rand(2, 1, 32, 32, 3, device="cuda",
                        generator=torch.Generator("cuda").manual_seed(0))
    return torch.equal(make_predict_fn(a)(images), make_predict_fn(b)(images))


def test_cli_with_a_validation_split_on_the_card(cuda, maps_corpus,
                                                 tmp_path):
    """The CLI in f32 on maps-only strips with a validation split: 2
    epochs, then resumed to 3, then test mode, each with every launch
    counter (_cli_train); the checkpoint's Adam step is the steps taken,
    the logs hold a finite loss a step and a val_loss an epoch, a fresh
    model restored from the checkpoint predicts the trained model's bits;
    the resume continues from epoch 1; test mode runs one forward a sample
    and writes a grid and every metric, finite."""
    from svbrdf_tpu_torch.data import strips
    from svbrdf_tpu_torch.training.tensorboard import read_scalars

    model_dir = tmp_path / "single"
    kernels = ("mixed_fwdgrad", "mixed_fwd")
    first, _ = _cli_train(_train_argv(maps_corpus, model_dir, *MIXED, *F32,
                                      "--epochs", "2", "--retrain"),
                          kernels, 2)
    assert _adam_steps(model_dir) == first.steps
    scalars = read_scalars(str(model_dir / "logs"))
    losses = [v for _, v in scalars["loss"]]
    assert len(losses) == first.steps and all(map(math.isfinite, losses))
    assert len(scalars["val_loss"]) == 2
    assert _same_prediction(_reloaded(model_dir), first.model)

    _, text = _cli_train(_train_argv(maps_corpus, model_dir, *MIXED, *F32,
                                     "--epochs", "3"), kernels, 2)
    assert "Restored epoch 1" in text
    assert "Training from epoch 1 to 3" in text
    assert _adam_steps(model_dir) == 4 * PER_EPOCH

    written, _, counts = _cli(["--mode", "test", "--input-dir",
                               str(REPO / "data" / "test"), "--image-count",
                               "10", "--model-dir", str(model_dir),
                               "--num-devices", "1"] + F32 + WIDTH)
    _expect_launches(counts,
                     bench_setup.tail_launches("single", 0, len(written), 5))
    assert strips.read_image_u8(written[0]).shape == (64, 160, 3)
    summary = json.loads((model_dir / "test_outputs" /
                          "metrics.json").read_text())
    assert all(math.isfinite(summary["mean"].get(k, math.nan))
               for k in METRIC_KEYS)


# CLI runs held by their launches: arguments, epochs, the loss kernels
# (train step, eval step). The host path's first epoch decodes the strips
# through the decode pool, the second reads its caches.
CLI_RUNS = {
    "single_mixed_cache": (MIXED + F32 + ["--device-data-cache"], 1,
                           ("mixed_fwdgrad", "mixed_fwd")),
    "multi_rendering_cache": (RENDER + F32 + ["--device-data-cache"], 1,
                              ("render_fwdgrad", "render_fwd")),
    "multi_rendering": (RENDER + F32, 2, ("render_fwdgrad", "render_fwd")),
}


@pytest.mark.parametrize("name", sorted(CLI_RUNS))
def test_cli_runs_launch_once_a_step(cuda, maps_corpus, tmp_path, name):
    """The CLI with the device data cache, and the multi-view model with
    the rendering loss: every launch counter as _cli_train says."""
    args, epochs, kernels = CLI_RUNS[name]
    _cli_train(_train_argv(maps_corpus, tmp_path / name, *args, "--epochs",
                           str(epochs), "--retrain"), kernels, epochs,
               kind="multi" if "--model-type" in args else "single")


@pytest.mark.parametrize("f32", [False, True], ids=["default", "f32"])
def test_cli_path_traced_on_the_card(cuda, maps_corpus, tmp_path, f32):
    """--renderer pathtracing for 1 epoch at the CLI's defaults (bf16,
    bf16-SR masters) or in f32: no loss kernel; the path tracer's kernels
    as on the path (bench_setup.PATHS) a step and a validation batch;
    sr_adam once a bf16-SR step; the block tails."""
    path = "single_mixed_pathtracing" + ("_f32" if f32 else "")
    run, text, counts = _cli(_train_argv(
        maps_corpus, tmp_path / path, *MIXED, "--renderer", "pathtracing",
        "--epochs", "1", "--retrain", *(F32 if f32 else ())))
    assert (run.steps, run.validation_batches) == (PER_EPOCH, 1)
    assert "Using renderer 'pathtracing'" in text
    per_step, per_batch = bench_setup.PATHS[path][4]
    expected = {k: run.steps * per_step.get(k, 0)
                + run.validation_batches * per_batch.get(k, 0)
                for k in {**per_step, **per_batch}}
    expected.update(bench_setup.tail_launches(
        "single", run.steps, run.validation_batches + _grids(text), 5))
    if not f32:
        expected["sr_adam"] = (run.steps
                               * bench_setup.sr_adam_launches(run.model))
    _expect_launches(counts, expected)
    assert math.isfinite(run.last_loss)


def test_cli_default_precision_resumes_and_reloads(cuda, maps_corpus,
                                                   tmp_path):
    """The CLI at its defaults (--dtype auto: bf16 on the card, bf16-SR
    masters), as a user runs it: 2 epochs, then resumed to 3, the bf16
    loss kernels and sr_adam once a step. The resume restores the policy
    from the checkpoint and continues from epoch 1; the checkpoint holds
    f32 weights and master_dtype 'bf16sr'; the resumed model's >=2-D
    masters are bf16, its 1-D ones f32; a fresh bf16-SR model reloaded
    from the checkpoint predicts the trained model's bits."""
    model_dir = tmp_path / "default"
    kernels = ("mixed_fwdgrad_bf16", "mixed_fwd_bf16")
    _cli_train(_train_argv(maps_corpus, model_dir, *MIXED, "--epochs", "2",
                           "--retrain"), kernels, 2, sr_adam=True)
    resumed, text = _cli_train(_train_argv(maps_corpus, model_dir, *MIXED,
                                           "--epochs", "3"),
                               kernels, 2, sr_adam=True)
    assert "Restored master_dtype 'bf16sr'" in text
    assert "Training from epoch 1 to 3" in text
    assert _adam_steps(model_dir) == 4 * PER_EPOCH
    blob = torch.load(model_dir / "checkpoint.tar", map_location="cpu",
                      weights_only=True)
    assert {v.dtype for v in blob["model_state_dict"].values()} == {
        torch.float32}
    assert blob.get("master_dtype") == "bf16sr"
    for p in resumed.model.parameters():
        assert p.dtype == (BF16 if p.dim() >= 2 else torch.float32)
    assert _same_prediction(_reloaded(model_dir, BF16, "bf16sr"),
                            resumed.model)


@pytest.mark.parametrize("dtypes", list(itertools.product(
    (torch.float32, BF16), repeat=4)), ids=lambda d: "-".join(
        "bf16" if t == BF16 else "f32" for t in d))
def test_sr_adam_kernel_matches_plain(cuda, dtypes):
    """The fused SR-Adam update, each of its 16 storage combinations of (p,
    g, mu, nu), on a leaf whose size is no multiple of the block, on one
    past a grid's stride, and on the largest conv and 1-D leaves of the
    full-width single-view model, at three (count, salt) pairs (salts at 0,
    the largest and another; counts past JAX's int32 wrap of the moment
    salt): p, mu and nu equal to the plain version's to the bit, one launch
    each."""
    from svbrdf_tpu_torch.models.generator import Generator
    from svbrdf_tpu_torch.ops import sr_adam
    from svbrdf_tpu_torch.parallel import optimizer as opt

    with torch.device("meta"):
        params = list(Generator(9, 64, 8).parameters())
    largest = [tuple(max((p for p in params if (p.dim() >= 2) == conv),
                         key=lambda p: p.numel()).shape)
               for conv in (True, False)]
    g = torch.Generator(device=cuda).manual_seed(4)
    for shape in ((61, 33, 4, 4), (4096 * 256 + 7,), *largest):
        for count, salt in ((1, 0), (2148, 2 ** 31 - 2),
                            (5000, 123456789)):
            leaf = [(torch.randn(shape, generator=g, device=cuda)
                     * sc).to(dt) for sc, dt in zip((0.02, 1e-3, 1e-4),
                                                    dtypes)]
            leaf.append((torch.rand(shape, generator=g, device=cuda)
                         * 1e-6).to(dtypes[3]))
            s = opt.adam_scalars(1e-5, (0.9, 0.999), 1e-8, count,
                                 count * 1000003 + 3, salt + 3)
            kern = [t.clone() for t in leaf]
            plain = [t.clone() for t in leaf]
            before = sr_adam.sr_adam_multi_cuda.launches
            sr_adam.sr_adam_update_cuda(*kern, s)
            assert sr_adam.sr_adam_multi_cuda.launches == before + 1
            opt.adam_update_plain(*plain, s)
            torch.cuda.synchronize()
            for a, b in zip(kern, plain):
                assert a.dtype == b.dtype and torch.equal(a, b)


def test_bf16_step_card_matches_cpu(cuda):
    """A bf16 single-view step with bf16-SR masters (depth 5, 32^2, 8
    filters, batch 2, dropout off, the same weights, batch, scenes and step
    salt) on the card and on the CPU: the loss within rel 2e-2; the masters
    within one bf16 ulp of each other except where the two gradients'
    signs differ (<= 0.1 %), and within one ulp plus 2 lr everywhere (each
    side rounds p + u, |u| <= lr, to a bf16 neighbour; where p is small
    against lr a sign flip is many ulps); one sr_adam launch for the step
    (one bucket: every leaf shares its group and count)."""
    from svbrdf_tpu_torch import losses
    from svbrdf_tpu_torch.models import SingleViewModel
    from svbrdf_tpu_torch.ops import sr_adam
    from svbrdf_tpu_torch.parallel import step as step_lib

    g = torch.Generator().manual_seed(3)
    prep = step_lib.PrepConfig(used_input_image_count=1, mix_materials=True)
    raw = {k: torch.from_numpy(v) for k, v in
           bench_setup.synthetic_raw_batch(2, 32, 0, seed=3).items()}
    batch = step_lib.prepare(raw, prep, g)
    scenes = sampling.generate_loss_scenes(2, generator=g)
    results = {}
    for dev in ("cpu", cuda):
        model = SingleViewModel(8, 5, device="cpu", seed=3, dtype=BF16).to(dev)
        for m in model.modules():
            if isinstance(m, torch.nn.Dropout):
                m.eval()
        with step_lib.master_dtype_scope():
            step_lib.set_master_dtype_policy("bf16sr")
            step_lib.master_cast(model)
        step = step_lib.make_train_step(
            model, step_lib.make_optimizer(model.parameters(), 1e-5, BF16),
            losses.make_loss_fn("mixed"), prep, None, seed=3)
        before = sr_adam.sr_adam_multi_cuda.launches
        loss = float(step.update({k: v.to(dev) for k, v in batch.items()},
                                 scenes=scenes.to(dev), step=1))
        launched = sr_adam.sr_adam_multi_cuda.launches - before
        assert launched == (0 if dev == "cpu" else 1)
        results[str(dev)] = (loss, [p.detach().double().cpu()
                                    for p in model.parameters()
                                    if p.dim() >= 2])
    (lc, mc), (lg, mg) = results["cpu"], results[str(cuda)]
    assert abs(lg - lc) <= 2e-2 * abs(lc)
    mg, mc = torch.cat([m.flatten() for m in mg]), torch.cat(
        [m.flatten() for m in mc])
    diff = (mg - mc).abs()
    big = torch.maximum(mg.abs(), mc.abs()).clamp_min(1e-38)
    ulp = torch.exp2(torch.floor(torch.log2(big)) - 7)
    assert bool((diff <= ulp + 2e-5).all())  # one ulp + 2 lr
    assert float((diff > ulp).double().mean()) <= 1e-3


def _multi_leaves(dev, specs, seed):
    """Leaves (SrLeaf) of `specs`: (index, n, (p, g, mu, nu) dtypes,
    offset), each tensor a contiguous view `offset` elements into a larger
    buffer where that tensor's offset is non-zero (so not 16-byte
    aligned)."""
    from svbrdf_tpu_torch.ops import sr_adam

    g = torch.Generator(device=dev).manual_seed(seed)
    leaves = []
    for index, n, dtypes, offsets in specs:
        ts = []
        for k, (dt, off) in enumerate(zip(dtypes, offsets)):
            x = (torch.rand(n + off, generator=g, device=dev) * 1e-6 if k == 3
                 else torch.randn(n + off, generator=g, device=dev)
                 * (0.02, 1e-3, 1e-4)[k])
            ts.append(x.to(dt)[off:])
        leaves.append(sr_adam.SrLeaf(index, *ts))
    return leaves


# (moment salt base, master salt base): 0; both near 2^32, so leaf index +
# base wraps.
@pytest.mark.parametrize("bases", [(0, 0), (2 ** 32 - 40, 2 ** 32 - 3),
                                   (2148 * 1000003 % 2 ** 32, 2 ** 31 - 2)])
def test_sr_adam_multi_kernel_matches_plain(cuda, bases):
    """One launch over a table of every (p, g, mu, nu) dtype combination
    (16), each with a tail of 1-7 elements past a multiple of 8, beside
    leaves that are misaligned contiguous views (one tensor or all four a
    storage offset of one element in), an empty leaf and a leaf above 2^23
    elements: bit-exact against the plain version, leaf i taking the salts
    base + i."""
    from svbrdf_tpu_torch.parallel import optimizer as opt

    combos = list(itertools.product((torch.float32, BF16), repeat=4))
    specs = [(3 * k, 8 * (k + 1) * 37 + 1 + k % 7, dts, (0, 0, 0, 0))
             for k, dts in enumerate(combos)]
    specs += [(70, 4100, combos[15], (0, 1, 0, 0)),
              (71, 1000, combos[0], (1, 1, 1, 1)),
              (72, 0, combos[15], (0, 0, 0, 0)),
              (73, 2 ** 23 + 13, combos[15], (0, 0, 0, 0)),
              (74, 2 ** 23 + 9, combos[0], (0, 0, 0, 0))]
    s = opt.adam_scalars(1e-5, (0.9, 0.999), 1e-8, 2148, *bases)
    bench_setup.hold_sr_adam_multi(_multi_leaves(cuda, specs, seed=5), s,
                                   1)


def test_sr_adam_multi_splits_tables(cuda):
    """A leaf set larger than one table: one launch per table, each leaf
    still bit-exact with its own index's salts."""
    from svbrdf_tpu_torch.ops import sr_adam
    from svbrdf_tpu_torch.parallel import optimizer as opt

    n = sr_adam.max_leaves() + 5
    specs = [(i, 33 + i, (BF16, BF16, BF16, BF16) if i % 2
              else (torch.float32,) * 4, (0, 0, 0, 0)) for i in range(n)]
    s = opt.adam_scalars(1e-5, (0.9, 0.999), 1e-8, 7, 7 * 1000003, 99)
    bench_setup.hold_sr_adam_multi(_multi_leaves(cuda, specs, seed=6), s,
                                   2)


@pytest.mark.parametrize("count", [1, 2148])
def test_sr_adam_bf16_state_mode_matches_plain(cuda, count):
    """The 'bf16' state mode (optax's bf16-mu order, the launch's flag): a
    table of every (p, g, mu, nu) dtype combination, the mode's own (f32 p
    and g, bf16 mu, f32 nu) among them, with tails, bit-exact against the
    plain version in one launch; and the flag changes mu (it is not the
    other kernel under another name)."""
    from svbrdf_tpu_torch.parallel import optimizer as opt

    combos = list(itertools.product((torch.float32, BF16), repeat=4))
    specs = [(k, 8 * (k + 1) * 29 + k % 5, dts, (0, 0, 0, 0))
             for k, dts in enumerate(combos)]
    specs.append((16, 4096 * 64 + 3, (torch.float32, torch.float32, BF16,
                                      torch.float32), (0, 0, 0, 0)))
    s = opt.adam_scalars(1e-5, (0.9, 0.999), 1e-8, count,
                         count * 1000003, 2 ** 31 - 2, bf16_mu_product=True)
    leaves = _multi_leaves(cuda, specs, seed=7)
    bench_setup.hold_sr_adam_multi(leaves, s, 1)
    from svbrdf_tpu_torch.ops import sr_adam

    flagged = [sr_adam.SrLeaf(lf.index, *(t.clone() for t in lf[1:]))
               for lf in leaves[-1:]]
    plain = [sr_adam.SrLeaf(lf.index, *(t.clone() for t in lf[1:]))
             for lf in leaves[-1:]]
    sr_adam.sr_adam_multi_cuda(flagged, s)
    sr_adam.sr_adam_multi_cuda(plain, s._replace(bf16_mu_product=False))
    torch.cuda.synchronize()
    assert not torch.equal(flagged[0].mu, plain[0].mu)


def test_sr_adam_rounding_is_unbiased(cuda):
    """The kernel's stochastic rounding on the card: nu = x * x (b2 = 1,
    1 - b2 = 1) stored in bf16 through SR, the mean over 400 salts within
    rel 1e-3 of the f32 value of every element, as the JAX package's test
    holds sr_bf16."""
    from svbrdf_tpu_torch.ops import sr_adam
    from svbrdf_tpu_torch.parallel import optimizer as opt

    g = torch.Generator(device=cuda).manual_seed(11)
    x = torch.sqrt(torch.empty(64, device=cuda).uniform_(1e-8, 1e-4,
                                                         generator=g))
    acc = torch.zeros(64, dtype=torch.float64, device=cuda)
    salts = 400
    for salt in range(salts):
        nu = torch.zeros(64, dtype=BF16, device=cuda)
        sr_adam.sr_adam_update_cuda(
            torch.zeros_like(x), x, torch.zeros_like(x), nu,
            opt.AdamScalars(b1=0.9, omb1=0.1, b2=1.0, omb2=1.0, bc1=1.0,
                            bc2=1.0, eps=1e-8, neg_lr=0.0, nu_salt=salt,
                            master_salt=0))
        acc += nu.double()
    target = (x * x).double()
    assert float(((acc / salts - target).abs() / target).max()) <= 1e-3


@pytest.mark.parametrize("kind, state, count", [
    ("single", "bf16sr", 2148), ("multi", "bf16sr", 2148),
    ("single", "bf16", 1), ("single", "bf16", 2148)])
def test_sr_adam_every_leaf_of_the_models(cuda, kind, state, count):
    """Every leaf of the full-width `kind` model in one multi-tensor call,
    random gradients and moments, a master salt that wraps with the leaf
    index: bit-exact against the plain version, one launch a table. State
    'bf16sr': the bf16-SR main path's dtypes (>=2-D leaves bf16 master,
    gradient and moments; 1-D f32); 'bf16': the 'bf16' state mode's (f32
    parameters and gradients, bf16 mu, f32 nu, optax's bf16-mu order)."""
    from svbrdf_tpu_torch.ops import sr_adam
    from svbrdf_tpu_torch.parallel import optimizer as opt

    leaves = bench_setup.sr_adam_model_leaves(kind, state, device=cuda)
    s = opt.adam_scalars(1e-5, (0.9, 0.999), 1e-8, count, count * 1000003,
                         2 ** 32 - 40, bf16_mu_product=state == "bf16")
    bench_setup.hold_sr_adam_multi(
        leaves, s, math.ceil(len(leaves) / sr_adam.max_leaves()))


def test_path_tracer_card_matches_cpu(cuda):
    """The path tracer (its kernels) on the card against the CPU on the same
    injected samples (B=2, S=9, 32^2, spp (4, 2)): renders by bench_setup.hold_render (rel 1e-5, or where f32 is
    ill-conditioned against float64; the card sums 3-term dot products in
    another order than the CPU); the mixed loss rel 1e-5; its gradient for
    pred within 1e-4 of the CPU's (normwise) and as close to float64 as
    the CPU's; loss and gradient exactly 0 for pred equal to target."""
    from svbrdf_tpu_torch import losses
    from svbrdf_tpu_torch.ops import pathtrace as pt

    loss_fn = losses.make_loss_fn("mixed", "pathtracing")

    def run(device, cast=lambda x: x):
        pred, target, scenes, samples = bench_setup.pathtrace_inputs(
            2, 32, (4, 2), device=device)
        scenes = Scene(*map(cast, (scenes.camera_pos, scenes.light_pos,
                                   scenes.light_color)))
        samples = pt.RenderSamples(*(pt.Samples(*map(cast, s))
                                     for s in samples))
        pred, target = cast(pred), cast(target)
        render = pt.render_mc(scenes, pred[:, None], samples)
        p = pred.clone().requires_grad_()
        loss = loss_fn(p, target, scenes=scenes, samples=samples)
        loss.backward()
        return (render.double().cpu(), float(loss.detach()),
                p.grad.double().cpu())

    (rc, lc, gc), (rp, lp, gp) = run("cuda"), run("cpu")
    r64, _, g64 = run("cpu", lambda x: x.double())
    pred, _, scenes, samples = bench_setup.pathtrace_inputs(2, 32, (4, 2),
                                                            device="cpu")
    bench_setup.hold_render(rc, rp, r64, bench_setup.render_conditioning(
        scenes, pred[:, None], samples))
    assert abs(lc - lp) <= 1e-5 * abs(lp)
    assert float((gc - gp).norm() / gp.norm()) <= 1e-4
    assert float((gc - g64).norm() / g64.norm()) <= (
        2 * float((gp - g64).norm() / g64.norm()) + 1e-5)

    target = bench_setup.pathtrace_inputs(2, 32, (4, 2), device="cuda")[1]
    p = target.clone().requires_grad_()
    zero = loss_fn(p, target, torch.Generator(device=cuda).manual_seed(1))
    zero.backward()
    assert float(zero.detach()) == 0.0
    assert int(torch.count_nonzero(p.grad)) == 0


def test_path_traced_full_width_step(cuda):
    """A full-width path-traced train step (single view, mixed loss, depth
    8, 64 filters, 256^2, batch 8, bf16 with bf16-SR masters, spp (16, 8)):
    a finite loss, no loss kernel launched, one sr_adam launch, the path
    tracer's forward kernel once for each render and its VJP once."""
    from svbrdf_tpu_torch.ops import sr_adam

    with torch.backends.cudnn.flags(allow_tf32=True):
        program = bench_setup.build_program(
            "single", "mixed", 8, 256, 8, 64, seed=0, device="cuda",
            dtype=BF16, master_dtype="bf16sr", renderer="pathtracing")
        bench_setup.zero_launch_counts()
        loss = float(program.train_step(program.raw))
    assert math.isfinite(loss)
    assert all(w.launches == 0 for w in rf.CUDA_WRAPPERS.values())
    assert sr_adam.sr_adam_multi_cuda.launches == 1
    # The prediction's render (bf16) and the target's (f32), and the
    # prediction's VJP.
    counts = bench_setup.launch_counts()
    assert {k: v for k, v in counts.items() if k.startswith("pathtrace")} \
        == {"pathtrace_shade": 1, "pathtrace_shade_bf16": 1,
            "pathtrace_shade_vjp": 0, "pathtrace_shade_vjp_bf16": 1}


def test_path_traced_training_stays_finite(cuda):
    """20 path-traced train steps at full width at the CLI's default
    precision (utils/pathtrace_stability: structured maps, spp (16, 8)):
    every fetched loss and every Adam second moment finite."""
    from svbrdf_tpu_torch.parallel.step import master_dtype_scope
    from svbrdf_tpu_torch.utils import pathtrace_stability

    with master_dtype_scope(), contextlib.redirect_stderr(io.StringIO()):
        record = pathtrace_stability.run(steps=20)
    assert record["all_finite"] and record["adam_nu_finite"]


def _dp_program(**extra):
    return dict(model_kind="single", loss_kind="mixed", batch=4, size=32,
                depth=5, num_filters=8, seed=0, device="cuda", **extra)


def _update_normwise(run, ref):
    num = sum(float(((b - a) - (rb - ra)).double().norm() ** 2)
              for a, b, ra, rb in zip(run["params0"], run["params"],
                                      ref["params0"], ref["params"]))
    den = sum(float((rb - ra).double().norm() ** 2)
              for ra, rb in zip(ref["params0"], ref["params"]))
    return (num / den) ** 0.5


def _assert_losses(losses, ref):
    """The first step's loss (the same weights and draws) rel 1e-5, every
    step's rel 1e-4 (after it the weights part: cuDNN, see below)."""
    np.testing.assert_allclose(losses[0], ref[0], rtol=1e-5)
    np.testing.assert_allclose(losses, ref, rtol=1e-4)


def _dp_launches(kernel, steps, bf16sr=False):
    """A rank's launches in `steps` data-parallel steps of _dp_program:
    the loss kernel and the block tails once a step, sr_adam too with
    bf16-SR masters."""
    return {kernel: steps,
            **bench_setup.tail_launches("single", steps, depth=5),
            **({"sr_adam": steps} if bf16sr else {})}


def test_data_parallel_world_one_over_nccl(cuda):
    """The data-parallel step in a world-1 NCCL group (what the launcher
    runs on one card) against the plain step on the card: the losses as
    test_data_parallel_world_two_on_the_card holds them (bit-equal where
    cuDNN runs deterministically); in f32 and bf16-SR, every launch
    counter (_dp_launches)."""
    bf16 = _dp_program(dtype=BF16, master_dtype="bf16sr")
    one, one_bf16 = bench_setup.data_parallel_runs(
        1, [((_dp_program(), 3), {}), ((bf16, 3), {})], timeout=300)
    plain = bench_setup.train_steps(_dp_program(), 3)
    assert one["backend"] == one_bf16["backend"] == "nccl"
    _assert_losses(one["losses"], plain["losses"])
    _expect_launches(one["launches"][0], _dp_launches("mixed_fwdgrad", 3))
    _expect_launches(one_bf16["launches"][0],
                     _dp_launches("mixed_fwdgrad_bf16", 3, True))


def test_data_parallel_world_two_on_the_card(cuda):
    """World 2 on the card (two cards over NCCL where there are two, else
    both ranks on cuda:0 over gloo) against world 1 on the same global
    batch, f32: the first step's loss rel 1e-5, every step's 1e-4, the
    update normwise 5e-2, not the CPU's 1e-5 and 1e-4: cuDNN's backward
    takes other algorithms at batch 2 than at 4, so the weights part after
    the first step and Adam's first steps magnify that (the same run with
    cuDNN off is held at the CPU's tolerances below); then bf16-SR; the
    replicas bit-identical after each, every launch counter of each rank
    (_dp_launches)."""
    backend = "nccl" if torch.cuda.device_count() >= 2 else "gloo"
    bf16 = _dp_program(dtype=torch.bfloat16, master_dtype="bf16sr")
    two, two_bf16 = bench_setup.data_parallel_runs(
        2, [((_dp_program(), 3), {}), ((bf16, 3), {})], backend,
        timeout=300)
    one = bench_setup.train_steps(_dp_program(), 3)
    _assert_losses(two["losses"], one["losses"])
    assert _update_normwise(two, one) <= 5e-2
    for run, kernel in ((two, "mixed_fwdgrad"),
                        (two_bf16, "mixed_fwdgrad_bf16")):
        assert run["backend"] == backend
        assert len(set(run["checksums"])) == 1
        for counts in run["launches"]:
            _expect_launches(counts, _dp_launches(kernel, 3,
                                                  run is two_bf16))


def test_data_parallel_world_two_on_the_card_without_cudnn(cuda):
    """World 2 on the card against world 1 on the same global batch with
    cuDNN off in the ranks and in the reference (torch's own convolutions,
    whose sums do not follow cuDNN's choice of algorithm for a batch size),
    f32, 5 steps: the CPU tests' tolerances, each step's loss rel 1e-5 and
    the update normwise 1e-4, so that a fault of the gradient reduction or
    of the rows' draws cannot hide under cuDNN; replicas bit-identical;
    every launch counter of each rank (_dp_launches)."""
    backend = "nccl" if torch.cuda.device_count() >= 2 else "gloo"
    (two,) = bench_setup.data_parallel_runs(
        2, [((_dp_program(), 5), {"cudnn": False})], backend,
        timeout=300)
    one = bench_setup.train_steps(_dp_program(), 5, cudnn=False)
    np.testing.assert_allclose(two["losses"], one["losses"], rtol=1e-5)
    assert _update_normwise(two, one) <= 1e-4
    assert len(set(two["checksums"])) == 1
    for counts in two["launches"]:
        _expect_launches(counts, _dp_launches("mixed_fwdgrad", 5))


def _max_abs(a, b):
    return max(float((x.float() - y.float()).abs().max())
               for x, y in zip(a, b))


def test_launcher_world_one_matches_the_plain_cli(cuda, maps_corpus,
                                                  tmp_path):
    """The CLI's defaults (bf16, bf16-SR masters) for 1 epoch: plain,
    through the launcher at world 1 (parallel/multihost --num-processes 1,
    a world-1 NCCL group), plain again, dropout's generators reseeded
    alike; every launch counter of each (_cli_train); the launcher's final
    weights bit-equal to the plain runs' where those are, else no further
    from the first than twice the plain runs' own distance (three draws of
    one nondeterministic run: the third need not be the nearest)."""
    from svbrdf_tpu_torch.parallel import multihost

    weights = {}
    for name, entry in (("plain_a", None), ("launcher", multihost.main),
                        ("plain_b", None)):
        argv = _train_argv(maps_corpus, tmp_path / name, *MIXED, "--epochs",
                           "1", "--retrain", devices=entry is None)
        if entry is not None:
            argv = ["--num-processes", "1", "--"] + argv
        torch.manual_seed(0)
        run, text = _cli_train(argv, ("mixed_fwdgrad_bf16", "mixed_fwd_bf16"),
                               1, sr_adam=True, entry=entry)
        if entry is not None:
            assert "process 0/1" in text and "over nccl" in text
        weights[name] = [p.detach() for p in run.model.parameters()]
    plain = _max_abs(weights["plain_a"], weights["plain_b"])
    assert _max_abs(weights["launcher"], weights["plain_a"]) <= 2 * plain


def test_spatial_world_two_on_the_card_without_cudnn(cuda):
    """Spatial sharding at world 2 on the card (two cards over NCCL where
    there are two, else both ranks on cuda:0 over gloo): the height split
    over the ranks against world 1 on the same batch, cuDNN off in the
    ranks and in the reference, f32, 5 steps: each step's loss rel 1e-5
    and the update normwise 1e-4 (the CPU tests' tolerances); replicas
    bit-identical; render_fwdgrad once a step on each rank at its row
    offset, the mixed-loss kernels not at all, the block tails only where
    a block runs whole on the rank (_spatial_tail_launches)."""
    backend = "nccl" if torch.cuda.device_count() >= 2 else "gloo"
    (two,) = bench_setup.rank_runs(
        2, [(bench_setup.spatial_train_steps, (_dp_program(), 5),
             {"cudnn": False})], "cuda", backend, timeout=300)
    one = bench_setup.train_steps(_dp_program(), 5, cudnn=False)
    np.testing.assert_allclose(two[0]["losses"], one["losses"], rtol=1e-5)
    assert _update_normwise(two[0], one) <= 1e-4
    assert len(set(two[0]["checksums"])) == 1
    for counts in two[0]["launches"]:
        _expect_launches(counts, {"render_fwdgrad": 5,
                                  **_spatial_tail_launches(5, 0, 32, 5)})


@pytest.mark.parametrize("batch, size", [(2, 32), (8, 256)])
@pytest.mark.parametrize("name", ["render_fwdgrad", "render_fwd"])
def test_rendering_kernels_at_a_row_offset(cuda, name, batch, size):
    """The two kernels of the spatial path on the two row halves of an
    image (row offset 0 and size / 2 of the global height; small, and at
    the paths' shapes, B=8, 256^2, S=9) against their plain versions at
    the same offset (at 256^2 the gradient exact, _assert_grad_exact), and
    the halves' losses summed (and gradients put together) against the
    whole image's."""
    pred_t, gt_t, scenes9 = bench_setup.loss_inputs(batch, size, 9,
                                                    device=cuda)
    wrapper, plain = rf.CUDA_WRAPPERS[name], rf.PLAIN_VERSIONS[name]
    whole = _outputs(wrapper(pred_t, gt_t, scenes9))
    half = size // 2
    halves = []
    for lo in (0, half):
        args = (pred_t[:, :, lo:lo + half].contiguous(),
                gt_t[:, :, lo:lo + half].contiguous(), scenes9, lo, size)
        got, ref = _outputs(wrapper(*args)), _outputs(plain(*args))
        _assert_close(got[0], ref[0], rtol=1e-5)
        for g, r in zip(got[1:], ref[1:]):
            if size == 256:
                _assert_grad_exact(g, r)
            else:
                _assert_grad_close(g, r)
        halves.append(got)
    _assert_close(halves[0][0] + halves[1][0], whole[0], rtol=1e-6)
    if len(whole) > 1:
        _assert_close(torch.cat([h[1] for h in halves], dim=2), whole[1],
                      rtol=1e-6, atol=1e-6 * float(whole[1].abs().max()))


def _spatial_eval_rank(program, images, group):
    """In a rank of the spatial group: the eval step on the program's raw
    batch and the sharded predict of `images`, f32, each with every launch
    counter read around it; the eval loss and the maps gathered on rank
    0."""
    from svbrdf_tpu_torch.device import precision_scope
    from svbrdf_tpu_torch.parallel import spatial

    with precision_scope(torch.float32):
        prog = bench_setup.build_program(**program, space=group)
        loss, eval_launches = _counted(lambda: float(prog.eval_step(
            prog.raw)))
        rows, predict_launches = _counted(lambda: prog.predict(
            images.to(group.device)))
    maps = spatial.gather_maps(rows, group)
    return {"eval": loss, "eval_launches": eval_launches,
            "predict_launches": predict_launches,
            "maps": None if maps is None else maps.cpu()}


@pytest.mark.parametrize("size", [32, 64])
def test_spatial_eval_and_predict_match_one_device(cuda, size):
    """An eval step and the sharded predict at world 2 on the card (both
    ranks on cuda:0 over gloo where there is one card), f32, against one
    device's: the eval loss rel 1e-5, the gathered maps within 1e-4; on
    each rank render_fwd once for the eval step, the block tails only where
    a block runs whole (at 32^2 the 1-row ones; at 64^2, depth 5, none)."""
    backend = "nccl" if torch.cuda.device_count() >= 2 else "gloo"
    program = dict(_dp_program(), size=size)
    images = torch.rand((4, 1, size, size, 3),
                        generator=torch.Generator().manual_seed(5))
    (ranks,) = bench_setup.rank_runs(
        2, [(_spatial_eval_rank, (program, images), {})], "cuda", backend,
        timeout=300)
    prog = bench_setup.build_program(**program)
    one_eval = float(prog.eval_step(prog.raw))
    one_maps = prog.predict(images.to(cuda)).cpu()
    whole = _spatial_tail_launches(0, 1, size, 5)
    for rank in ranks:
        _expect_launches(rank["eval_launches"], {"render_fwd": 1, **whole})
        _expect_launches(rank["predict_launches"], whole)
    assert abs(ranks[0]["eval"] - one_eval) <= 1e-5 * abs(one_eval)
    assert float((ranks[0]["maps"] - one_maps).abs().max()) <= 1e-4


def _spatial_cli_rank(argv, images, group):
    """In a rank of the spatial group: main.main(argv, group) with every
    launch counter read around it; the run's steps, validation batches,
    last loss, printout, the sr_adam launches a step of its optimizer, and
    on rank 0 the trained model's maps of `images` (unsharded predict)."""
    from svbrdf_tpu_torch import main as cli_main
    from svbrdf_tpu_torch.parallel.optimizer import AdamBf16SR
    from svbrdf_tpu_torch.parallel.step import make_predict_fn

    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        run, launches = _counted(lambda: cli_main.main(argv, group))
    out = {"launches": launches, "steps": run.steps,
           "validation_batches": run.validation_batches,
           "last_loss": run.last_loss, "text": text.getvalue(),
           "sr_adam_per_step": (bench_setup.sr_adam_launches(run.model)
                                if isinstance(run.optimizer, AdamBf16SR)
                                else 0)}
    if group.is_main:
        out["maps"] = make_predict_fn(run.model)(
            images.to(group.device)).cpu()
    return out


def test_spatial_cli_trains_on_two_ranks(cuda, maps_corpus, tmp_path):
    """The CLI at its defaults with --shard-spatial 2 for 1 epoch,
    main.main(argv, group) in two ranks: on each, PER_EPOCH steps and one
    validation batch, render_fwdgrad once a step, render_fwd once a
    validation batch, sr_adam as its optimizer takes it, the block tails
    where a block runs whole plus rank 0's whole forwards of the held-out
    samples, 0 elsewhere; a finite loss; the checkpoint's meta (upconv
    'fold', master_dtype 'f32', epoch 0); a fresh model restored from it
    predicts the trained model's bits."""
    from svbrdf_tpu_torch.parallel.step import make_predict_fn
    from svbrdf_tpu_torch.training.loop import resolve_dtype

    backend = "nccl" if torch.cuda.device_count() >= 2 else "gloo"
    model_dir = tmp_path / "spatial"
    argv = _train_argv(maps_corpus, model_dir, *MIXED, "--epochs", "1",
                       "--retrain", "--shard-spatial", "2", devices=False)
    images = torch.rand((2, 1, 32, 32, 3),
                        generator=torch.Generator().manual_seed(5))
    (runs,) = bench_setup.rank_runs(
        2, [(_spatial_cli_rank, (argv, images), {})], "cuda", backend,
        timeout=600)
    for run in runs:
        assert (run["steps"], run["validation_batches"]) == (PER_EPOCH, 1)
        sharded = _spatial_tail_launches(run["steps"],
                                         run["validation_batches"], 32, 5)
        whole = bench_setup.tail_launches("single", 0, _grids(run["text"]), 5)
        _expect_launches(run["launches"], {
            "render_fwdgrad": run["steps"],
            "render_fwd": run["validation_batches"],
            "sr_adam": run["steps"] * run["sr_adam_per_step"],
            **{k: sharded[k] + whole[k] for k in sharded}})
        assert math.isfinite(run["last_loss"])
        assert "Spatial group: H split over 2 rank(s)" in run["text"]
    blob = torch.load(model_dir / "checkpoint.tar", map_location="cpu",
                      weights_only=True)
    assert {k: blob.get(k) for k in ("upconv", "master_dtype", "epoch")} \
        == {"upconv": "fold", "master_dtype": "f32", "epoch": 0}
    fresh = _reloaded(model_dir, resolve_dtype("auto", "cuda"))
    # TF32 as the ranks' processes left it: torch's defaults.
    with _torch_default_tf32():
        maps = make_predict_fn(fresh)(images.to(cuda)).cpu()
    assert torch.equal(maps, runs[0]["maps"])


def test_dryrun_spatial_needs_two_cards(cuda):
    """dryrun.run_spatial(2): with one card it raises the no-card error
    before a rank starts; with two, one spatial step gives a finite
    loss."""
    from svbrdf_tpu_torch.parallel import dryrun

    if torch.cuda.device_count() >= 2:
        assert math.isfinite(dryrun.run_spatial(2, timeout=300))
    else:
        with pytest.raises(ValueError):
            dryrun.run_spatial(2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch, size", [(2, 64), (8, 256)])
def test_pathtrace_kernels_match_plain(cuda, batch, size, dtype):
    """The path tracer's forward kernel and its VJP against their plain
    versions (S=9, spp (16, 8); B=2 at 64^2, and the path's B=8 at 256^2)
    by bench_setup's rules: renders by hold_render, each sum of the VJP as
    close to float64 as the plain version (2x, plus 1e-5) and for an f32
    SVBRDF within 1e-4 of it where the plain version is within 1e-4 of
    float64."""
    case = bench_setup.pathtrace_case(batch, size, size, dtype=dtype)
    out = bench_setup.hold_pathtrace_kernels(case)
    assert out["render"]["beyond_rtol"] <= 0.01


@pytest.mark.parametrize("spp", [(4, 2), (16, 8)])
def test_pathtrace_kernels_on_a_ragged_grid(cuda, spp):
    """250 x 243 pixels (a ragged last block of each row of blocks), B=3,
    at a small spp and at the path's."""
    case = bench_setup.pathtrace_case(3, 250, 243, spp=spp)
    bench_setup.hold_pathtrace_kernels(case)


@pytest.mark.parametrize("spp", [(4, 2), (16, 8)])
def test_pathtrace_vjp_with_scene_gradients(cuda, spp):
    """The VJP's scene instantiation (wo's cotangent and the scene fields'
    per-block partials) at 32^2, at a small spp and at the path's, and
    render_mc's gradients for the SVBRDF and every scene field on the card
    against the CPU (normwise 1e-4, as the CPU holds the port to JAX)."""
    from svbrdf_tpu_torch.ops import pathtrace as pt

    case = bench_setup.pathtrace_case(2, 32, 32, spp=spp)
    bench_setup.hold_pathtrace_kernels(case, scene_grads=True)

    def grads(device):
        leaves = [x.detach().to(device).requires_grad_() for x in (
            case["svbrdf"], case["scenes"].camera_pos,
            case["scenes"].light_pos, case["scenes"].light_color)]
        samples = pt.RenderSamples(*(pt.Samples(*(x.to(device) for x in s))
                                     for s in case["samples"]))
        out = pt.render_mc(Scene(*leaves[1:]), leaves[0], samples)
        out.backward(case["d_render"].to(device))
        return [x.grad.double().cpu() for x in leaves]

    for card, cpu in zip(grads("cuda"), grads("cpu")):
        assert float((card - cpu).norm() / cpu.norm()) <= 1e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch, size", [(2, 32), (8, 256)])
def test_pathtrace_loss_zero_for_identical_maps(cuda, batch, size, dtype):
    """The path-traced mixed loss through the kernels, small and at the
    path's shapes: pred equal to the target (same dtype, same samples)
    gives loss and gradient exactly 0."""
    from svbrdf_tpu_torch import losses

    target = bench_setup.pathtrace_inputs(batch, size,
                                          device="cuda")[1].to(dtype)
    pred = target.clone().requires_grad_()
    loss = losses.make_loss_fn("mixed", "pathtracing")(
        pred, target, torch.Generator(device=cuda).manual_seed(1))
    loss.backward()
    assert float(loss.detach()) == 0.0
    assert int(torch.count_nonzero(pred.grad)) == 0


def test_pathtrace_wrappers_reject_what_the_kernels_do_not_take(cuda):
    from svbrdf_tpu_torch.ops import pathtrace as pt

    flat = bench_setup.pathtrace_case(1, 16, 16, spp=(4, 2))["flat"]
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        pt.shade_cuda(*(x.double() for x in flat))
    with pytest.raises(ValueError, match="shift must be"):
        pt.shade_cuda(*flat[:12], flat[12][:, :, :8])
    with pytest.raises(ValueError, match="contiguous"):
        pt.shade_cuda(*flat[:1], flat[1].transpose(1, 2).contiguous()
                      .transpose(1, 2), *flat[2:])



# The block tail's kernels (csrc/norm_merge.cu, ops/norm_merge.py):
# bench_setup.hold_tail_kernels' rules at every tail shape of the two
# full-width models, on ragged shapes, with strided cotangents.
TAIL_CONFIGS = {"single": ("single", 8), "multi": ("multi", 8),
                "predict": ("single", 1)}


def _tail_failures(cases):
    return {str(h["case"]): h for h in map(bench_setup.hold_tail_kernels,
                                           cases) if h["failed"]}


@pytest.mark.parametrize("config", sorted(TAIL_CONFIGS))
def test_norm_merge_kernels_match_plain(cuda, config):
    """Every tail of the single-view model at batch 8 and 1 (the
    estimator's) and of the multi-view one at batch 8 (24 U-Net rows): the
    warp, block and cluster mappings, f32 and bf16."""
    kind, batch = TAIL_CONFIGS[config]
    cases = sorted(set(bench_setup.tail_cases(kind, batch, 256)))
    assert _tail_failures(cases) == {}


def test_norm_merge_kernels_on_ragged_shapes(cuda):
    """Planes that are no multiple of 8 values (the scalar loop), a large
    ragged plane (scalar, block mapping, a cluster), 9 channels, one row,
    channels last."""
    cases = [(3, 5, 5, 7, True, True, True, False),
             (2, 9, 3, 3, False, True, True, False),
             (2, 4, 33, 33, True, True, False, False),
             (1, 9, 100, 70, True, False, True, False),
             (1, 3, 257, 255, True, True, True, False),
             (4, 9, 64, 64, False, True, False, False),
             (3, 5, 5, 7, True, True, True, True),
             (2, 24, 40, 40, True, True, True, True),
             (1, 16, 128, 128, True, True, True, True)]
    assert _tail_failures(cases) == {}


def test_norm_merge_takes_channels_last_and_strided_tensors(cuda):
    """x channels last (the encoder's conv outputs), dout as a permuted NHWC
    gradient and as a channel slice of a wider one, g a slice of a
    concatenation's gradient: out and dx in x's layout, every result within
    f32 summation order (1e-6 normwise) of the contiguous tensors'."""
    from svbrdf_tpu_torch.ops import norm_merge as nm

    t = bench_setup.tail_inputs((4, 16, 32, 32, True, True, True, False), 1)
    x, w, b, m = (t[k] for k in ("x", "weight", "bias", "m"))
    out, stats = nm.norm_merge_fwd_cuda(x, w, b, m)
    ref = nm.norm_merge_bwd_cuda(t["dout"], t["g"], x, stats, w, True)
    last = x.contiguous(memory_format=torch.channels_last)
    out_last, stats_last = nm.norm_merge_fwd_cuda(last, w, b, m)
    assert out_last.is_contiguous(memory_format=torch.channels_last)
    assert bench_setup._normwise(out_last, out) <= 1e-6
    assert bench_setup._normwise(stats_last, stats) <= 1e-6
    nhwc = t["dout"].contiguous(memory_format=torch.channels_last)
    wide = torch.cat([t["dout"], t["dout"]], dim=1)[:, :16]
    g = torch.cat([t["g"], t["g"]], dim=1)[:, 16:]
    for xs, st, dout in ((x, stats, nhwc), (x, stats, wide),
                         (last, stats_last, nhwc)):
        got = nm.norm_merge_bwd_cuda(dout, g, xs, st, w, True)
        assert got[0].stride() == xs.stride()
        for a, r in zip(got, ref):
            assert bench_setup._normwise(a, r) <= 1e-6
    # Without the norm: dx in dout's layout.
    dx, dm, _ = nm.norm_merge_bwd_cuda(nhwc, g, want_dm=True)
    dx_ref, dm_ref, _ = nm.norm_merge_bwd_cuda(t["dout"], g, want_dm=True)
    assert dx.stride() == nhwc.stride()
    assert torch.equal(dx, dx_ref)
    assert bench_setup._normwise(dm, dm_ref) <= 1e-6


def test_norm_merge_propagates_nan(cuda):
    """A NaN in one plane's input: that plane's tap, and with the norm all
    of its outputs and its dx, are NaN; no other plane's are."""
    from svbrdf_tpu_torch.ops import norm_merge as nm

    for case in ((2, 3, 64, 64, True, True, True, False),
                 (2, 3, 8, 8, True, False, True, True),
                 (2, 3, 64, 64, False, True, True, True)):
        t = bench_setup.tail_inputs(case, 2)
        t["x"][1, 2, 5, 3] = float("nan")
        w, b, m = t.get("weight"), t.get("bias"), t.get("m")
        out, stats = nm.norm_merge_fwd_cuda(t["x"], w, b, m)
        dx, _, parts = nm.norm_merge_bwd_cuda(
            t["dout"], t["g"], t["x"] if case[4] else None,
            stats if case[4] else None, w, m is not None)
        mean = stats[0]
        assert torch.isnan(mean[1, 2]) and int(torch.isnan(mean).sum()) == 1
        if case[4]:
            for a in (out, dx):
                assert bool(torch.isnan(a[1, 2]).all())
                assert int(torch.isnan(a).sum()) == a[1, 2].numel()
            assert bool(torch.isnan(parts[0, 1, 2]))
        else:
            assert bool(torch.isnan(out[1, 2, 5, 3]))
            assert int(torch.isnan(out).sum()) == 1


def test_norm_merge_launches_once_a_tail(cuda):
    """A forward and backward of each model on the card launches the
    forward and the backward kernel once a tail (the first encoder block
    has none: no norm, no global track); an inference forward launches no
    backward."""
    from svbrdf_tpu_torch.models import build_model
    from svbrdf_tpu_torch.ops import norm_merge as nm

    for kind, shape in (("single", (2, 64, 64, 3)),
                        ("multi", (2, 3, 64, 64, 3))):
        model = build_model(kind, depth=6, num_filters=8, device="cuda",
                            dtype=BF16)
        images = torch.rand(*shape, device=cuda)
        nm.norm_merge_fwd_cuda.launches = nm.norm_merge_bwd_cuda.launches = 0
        model(images).sum().backward()
        tails = 2 * 6 - 1 + (4 if kind == "multi" else 0)
        assert (nm.norm_merge_fwd_cuda.launches,
                nm.norm_merge_bwd_cuda.launches) == (tails, tails)
        with torch.no_grad():
            model(images)
        assert (nm.norm_merge_fwd_cuda.launches,
                nm.norm_merge_bwd_cuda.launches) == (2 * tails, tails)


def test_norm_merge_wrappers_reject_what_the_kernels_do_not_take(cuda):
    from svbrdf_tpu_torch.ops import norm_merge as nm

    x = torch.zeros(2, 3, 4, 4, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        nm.norm_merge_fwd_cuda(x.transpose(2, 3))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        nm.norm_merge_fwd_cuda(x.double())
    with pytest.raises(ValueError, match="weight and bias"):
        nm.norm_merge_fwd_cuda(x, torch.ones(3, device=cuda))
    with pytest.raises(ValueError, match="m must be"):
        nm.norm_merge_fwd_cuda(x, m=torch.zeros(2, 3, device=cuda,
                                                dtype=BF16))


# The styled conv's tail (csrc/styled_tail.cu, ops/styled_tail.py):
# bench_setup.hold_styled_tail_kernels' rule (each result within twice the
# f32 plain version's normwise distance from float64, or 1e-6: the kernels
# sum the FIR's taps, the channel sum of grad_noise and the H x W sum of
# grad_d, up to 65,536 terms, in another order) at every styled conv of
# the config-f generator at batch 8, and on ragged shapes; NaN, the sums
# that cross blocks repeat to the bit, the launches of a capture.
@pytest.mark.parametrize("case", bench_setup.styled_tail_cases(8), ids=str)
def test_styled_tail_kernels_match_plain(cuda, case):
    held = bench_setup.hold_styled_tail_kernels(case)
    assert held["failed"] == [], held


def test_styled_tail_kernels_on_ragged_shapes(cuda):
    """Tiles cut at the edges, a tall narrow plane, one pixel, more channels
    than a group holds."""
    cases = [(3, 5, 33, 40, True), (2, 7, 5, 7, False), (1, 3, 100, 3, True),
             (2, 70, 4, 4, False), (1, 1, 1, 1, True), (2, 40, 129, 17, True)]
    held = map(bench_setup.hold_styled_tail_kernels, cases)
    assert {str(h["case"]): h for h in held if h["failed"]} == {}


@pytest.mark.parametrize("case", [(2, 128, 256, 256, True),
                                  (2, 512, 16, 16, False)], ids=str)
def test_styled_tail_propagates_nan(cuda, case):
    """A NaN in t or in the cotangent: every result NaN exactly where the
    plain version's is."""
    for where in ("t", "g"):
        x = bench_setup.styled_tail_inputs(case, 3)
        x[where][1, 7, 5, 9] = float("nan")
        got = bench_setup.styled_tail_kernels(x, case[4])
        want = bench_setup.styled_tail_reference(x, case[4])
        for name, r in want.items():
            assert torch.equal(torch.isnan(got[name]), torch.isnan(r)), name


def test_styled_tail_repeats_to_the_bit(cuda):
    """The partials of grad_d, grad_bias, grad_noise and grad_strength meet
    in a fixed order: two backward launches agree to the bit."""
    from svbrdf_tpu_torch.ops import styled_tail as st

    for case in ((8, 128, 256, 256, True), (8, 512, 32, 32, False)):
        x = bench_setup.styled_tail_inputs(case, 5)
        args = [x[k] for k in ("t", "d", "bias", "noise", "strength")]
        _, y = st.styled_tail_fwd_cuda(*args, case[4], True)
        first = st.styled_tail_bwd_cuda(x["g"], y, *args[1:], case[4])
        again = st.styled_tail_bwd_cuda(x["g"], y, *args[1:], case[4])
        assert all(torch.equal(a, b) for a, b in zip(first, again))


def _capture(dev, batch=2, photos=3, seed=0, **sizes):
    """A CaptureStep on `dev` over a seeded generator of `sizes` (the
    generator built on the CPU and copied, so both devices hold the same
    weights) and seeded photos and scenes."""
    from svbrdf_tpu_torch.experiments import CaptureStep
    from svbrdf_tpu_torch.models import build_model

    model = build_model("materialgan", device="cpu", seed=seed, **sizes)
    gen = torch.Generator().manual_seed(seed + 1)
    res = model.noise_sizes[-1]
    scenes = pipeline.generate_input_scenes(batch, photos, True,
                                            generator=gen)
    shots = torch.rand(batch, photos, res, res, 3, generator=gen)
    noises = model.make_noises(batch, gen)
    return CaptureStep(model.to(dev), shots.to(dev),
                       scenes.to(dev),
                       noises=[n.to(dev) for n in noises])


CAPTURE_SMALL = dict(w_dim=32, mapping_layers=2, max_channels=32)


def test_styled_tail_launches_once_a_conv(cuda):
    """A capture iteration launches the forward and the backward kernel once
    for each of the 256^2 generator's 13 styled convs; a forward without
    gradients the forward alone. A generator whose bias and strengths take
    gradients launches the same pair, which gives them."""
    step = _capture(cuda, **CAPTURE_SMALL)
    _, counts = _counted(step)
    _expect_launches(counts, {"styled_tail_fwd": 13, "styled_tail_bwd": 13})
    with torch.no_grad():
        _, counts = _counted(step.maps)
    _expect_launches(counts, {"styled_tail_fwd": 13})
    model = step.model.requires_grad_(True)
    _, counts = _counted(lambda: step.maps().square().mean().backward())
    _expect_launches(counts, {"styled_tail_fwd": 13, "styled_tail_bwd": 13})
    assert all(c.bias.grad is not None and c.noise_strength.grad is not None
               for c in model.convs)


def test_styled_conv_parameter_gradients_card_match_cpu(cuda):
    """A generator that trains its styled convs' biases and noise strengths
    (every parameter wanting a gradient) at 32^2 (channels 32): those
    gradients from the card's kernels against the CPU's plain version, TF32
    off, within 1e-4 normwise (each kind stacked over the 7 convs; f32
    summation orders through 7 convs, as the capture's W+ gradients)."""
    grads = []
    for dev in (cuda, torch.device("cpu")):
        step = _capture(dev, resolution=32, **CAPTURE_SMALL)
        model = step.model.requires_grad_(True)
        step.maps().square().mean().backward()
        grads.append([torch.cat([c.bias.grad.cpu() for c in model.convs]),
                      torch.stack([c.noise_strength.grad.cpu()
                                   for c in model.convs])])
    for a, b in zip(*grads):
        assert _normwise(a, b) <= 1e-4


def test_capture_step_card_matches_cpu(cuda):
    """One capture iteration at 32^2 (channels 32) on the card, through the
    kernels, against the same on the CPU through the plain version, TF32
    off: the loss within 1e-5, W+'s and the noise maps' gradients and
    updates within 1e-4 normwise (f32 summation orders through 7 convs)."""
    runs = []
    for dev in (cuda, torch.device("cpu")):
        step = _capture(dev, resolution=32, **CAPTURE_SMALL)
        loss = float(step())
        runs.append([loss, step.wplus.grad, step.wplus.detach()]
                    + [n.grad for n in step.noises])
    (card_loss, *card), (cpu_loss, *cpu) = runs
    assert abs(card_loss - cpu_loss) <= 1e-5 * abs(cpu_loss)
    for a, b in zip(card, cpu):
        assert _normwise(a.cpu(), b) <= 1e-4


def test_styled_tail_wrappers_reject_what_the_kernels_do_not_take(cuda):
    from svbrdf_tpu_torch.ops import styled_tail as st

    x = bench_setup.styled_tail_inputs((2, 3, 4, 4, False), 0)
    args = [x[k] for k in ("t", "d", "bias", "noise", "strength")]
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        st.styled_tail_fwd_cuda(*(a.cpu() for a in args), False)
    with pytest.raises(ValueError, match="contiguous float32"):
        st.styled_tail_fwd_cuda(args[0].transpose(2, 3), *args[1:], False)
    with pytest.raises(ValueError, match="contiguous float32"):
        st.styled_tail_fwd_cuda(args[0].double(), *args[1:], False)
    with pytest.raises(ValueError, match="shapes"):
        st.styled_tail_fwd_cuda(*args, True)
    with pytest.raises(ValueError, match="contiguous float32"):
        st.styled_tail(args[0], args[1].bfloat16(), *args[2:])


# The inference API and the tools on the card, on a toy corpus made there:
# TOY_STRIPS train and as many test strips of 10 photos at 32^2, the train
# directory filled with symlinks up to CLI_SAMPLES files.
TOY_STRIPS = 8


@pytest.fixture(scope="module")
def toy_run(tmp_path_factory):
    """The toy corpus generated on the card, the first photo of each test
    strip written as a photo file, and the CLI at its defaults trained on
    the photo strips for 1 epoch; each with the launches it made."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the toy data render on the card")
    from svbrdf_tpu_torch.data import png, strips, toy

    root = tmp_path_factory.mktemp("toy")
    n = TOY_STRIPS
    with contextlib.redirect_stdout(io.StringIO()):
        written, toy_launches = _counted(lambda: toy.generate_toy_dataset(
            str(root / "toy"), n, n, 32, 10, seed=313, device="cuda"))
    train = root / "toy" / "train"
    for k in range(n, CLI_SAMPLES):
        (train / f"link_{k:03d}.png").symlink_to(
            train / f"toy_train_{k % n:02d}.png")
    (root / "photos").mkdir()
    photos = []
    for path in written[n:]:
        photo = root / "photos" / pathlib.Path(path).name
        png.write_png_rgb8(str(photo), strips.read_image_u8(path)[:, :32])
        photos.append(str(photo))
    model_dir = root / "model"
    run, text, cli_launches = _cli(
        ["--mode", "train", "--input-dir", str(train), "--image-count", "10",
         "--used-image-count", "1", "--loss", "mixed", "--epochs", "1",
         "--retrain", "--save-frequency", "1", "--validation-frequency",
         "1", "--model-dir", str(model_dir), "--num-devices", "1"] + WIDTH)
    return {"root": root, "written": written, "toy_launches": toy_launches,
            "photos": photos, "test": written[n:], "model_dir": model_dir,
            "run": run, "text": text, "cli_launches": cli_launches}


def test_toy_data_and_the_cli_on_the_card(cuda, toy_run):
    """data/toy on the card: every strip (10 photos and 4 maps at 32^2)
    written, no kernel launched (torch ops); the CLI at its defaults on
    the photo strips: PER_EPOCH steps, one validation batch, the bf16 loss
    kernels, sr_adam and the block tails (_cli_train's rule)."""
    from svbrdf_tpu_torch.data import strips

    assert len(toy_run["written"]) == 2 * TOY_STRIPS
    for path in toy_run["test"]:
        assert strips.read_image_u8(path).shape == (32, 14 * 32, 3)
    _expect_launches(toy_run["toy_launches"], {})
    run, text = toy_run["run"], toy_run["text"]
    assert (run.steps, run.validation_batches) == (PER_EPOCH, 1)
    _expect_launches(toy_run["cli_launches"], {
        "mixed_fwdgrad_bf16": run.steps, "mixed_fwd_bf16": 1,
        "sr_adam": run.steps * bench_setup.sr_adam_launches(run.model),
        **bench_setup.tail_launches("single", run.steps, 1 + _grids(text), 5)})
    assert math.isfinite(run.last_loss)


def test_estimator_on_the_card(cuda, toy_run):
    """SvbrdfEstimator.from_checkpoint on the card: predict on the test
    photos, one forward (its block tails) a call, equal to a fresh model
    restored from the same checkpoint and finite; predict_to_files writes
    a map strip a photo, one forward a call."""
    from svbrdf_tpu_torch.data import strips
    from svbrdf_tpu_torch.estimator import SvbrdfEstimator
    from svbrdf_tpu_torch.parallel.step import make_predict_fn

    with contextlib.redirect_stdout(io.StringIO()):
        est = SvbrdfEstimator.from_checkpoint(toy_run["model_dir"],
                                              device="cuda")
    assert est.device.type == "cuda"
    photos = toy_run["photos"]
    images = np.stack([strips.read_image(p) for p in photos]) ** 2.2
    maps, counts = _counted(lambda: est.predict(images))
    _expect_launches(counts, bench_setup.tail_launches("single", 0, 1, 5))
    direct = make_predict_fn(_reloaded(toy_run["model_dir"]))(
        torch.from_numpy(images).to(cuda))
    assert np.array_equal(maps, direct.cpu().numpy())
    assert maps.shape == (len(photos), 32, 32, 12)
    assert np.isfinite(maps).all()
    written, counts = _counted(lambda: est.predict_to_files(
        photos, str(toy_run["root"] / "predicted")))
    _expect_launches(counts, bench_setup.tail_launches("single", 0, 1, 5))
    assert len(written) == len(photos)
    for path in written:
        assert strips.read_image_u8(path).shape == (32, 128, 3)


def test_map_recovery_on_the_card(cuda):
    """experiments/map_recovery on the card: the diffuse map of a 256^2
    toy material over 200 steps under 6 fixed scenes converges (last loss
    below 0.3 x the first) and launches no kernel; at 16^2, 10 steps
    against the same call on the CPU: loss rel 1e-4, maps 1e-4."""
    from svbrdf_tpu_torch.data import toy
    from svbrdf_tpu_torch.experiments import recover_maps

    def scenes(seed):
        drawn = sampling.generate_loss_scenes(
            1, 3, 3, generator=torch.Generator().manual_seed(seed))
        return Scene(drawn.camera_pos[0], drawn.light_pos[0],
                     drawn.light_color[0])

    target = toy.make_toy_svbrdf(np.random.default_rng(5), 256)
    result, counts = _counted(lambda: recover_maps(
        torch.Generator(device=cuda).manual_seed(0), target,
        optimize=("diffuse",), steps=200, scenes=scenes(1), device=cuda))
    _expect_launches(counts, {})
    assert result.svbrdf.device.type == "cuda"
    losses = result.losses.cpu()
    assert float(losses[-1]) < 0.3 * float(losses[0])
    small = toy.make_toy_svbrdf(np.random.default_rng(6), 16)
    card, cpu = (recover_maps(torch.Generator(device=d).manual_seed(0),
                              small, optimize=("diffuse",), steps=10,
                              scenes=scenes(2), device=d)
                 for d in ("cuda", "cpu"))
    assert float(((card.losses.cpu() - cpu.losses).abs()
                  / cpu.losses.abs()).max()) <= 1e-4
    assert float((card.svbrdf.cpu() - cpu.svbrdf).abs().max()) <= 1e-4


def test_turntable_gif_on_the_card(cuda, tmp_path):
    """viz.turntable_frames on the card: 8 frames of 384^2 from a 256^2
    toy material, no kernel launched, written as a GIF whose header,
    frames, delays and loop block read back, and not black."""
    from svbrdf_tpu_torch import viz
    from svbrdf_tpu_torch.data import gif, toy

    target = toy.make_toy_svbrdf(np.random.default_rng(7), 256)
    path = tmp_path / "turntable.gif"
    frames, counts = _counted(lambda: viz.turntable_frames(
        target, n_frames=8, sensor_size=(384, 384), device=cuda))
    _expect_launches(counts, {})
    viz.save_animation(str(path), frames)
    assert gif.gif_info(str(path)) == {"size": (384, 384), "frames": 8,
                                       "delays_cs": [7] * 8, "loop": 0}
    assert max(float(f.mean()) for f in frames) > 0.05


@pytest.mark.parametrize("name", ["predict", "turntable", "renderer_compare",
                                  "recover_maps"])
def test_examples_on_the_card(cuda, toy_run, tmp_path, name):
    """Each example's main(argv) on the toy run, --device cuda, writing its
    file: predict runs one forward of the model (its block tails),
    renderer_compare renders its f32 maps once through the path tracer's
    forward kernel, the others launch no kernel."""
    import importlib

    strip, photos = toy_run["test"][0], toy_run["photos"][:2]
    runs = {
        "predict": ([str(toy_run["model_dir"]), str(tmp_path), *photos],
                    [tmp_path / (pathlib.Path(p).stem + "_svbrdf.png")
                     for p in photos],
                    bench_setup.tail_launches("single", 0, 1, 5)),
        "turntable": ([strip, str(tmp_path / "t.gif"), "4"],
                      [tmp_path / "t.gif"], {}),
        "renderer_compare": ([strip, str(tmp_path / "compare.png")],
                             [tmp_path / "compare.png"],
                             {"pathtrace_shade": 1}),
        "recover_maps": ([strip, "diffuse", str(tmp_path / "r.png"), "50"],
                         [tmp_path / "r.png"], {}),
    }
    argv, files, expected = runs[name]
    main = importlib.import_module("svbrdf_tpu_torch.examples." + name).main
    with contextlib.redirect_stdout(io.StringIO()):
        _, counts = _counted(lambda: main(argv + ["--device", "cuda"]))
    _expect_launches(counts, expected)
    assert all(f.is_file() for f in files)
