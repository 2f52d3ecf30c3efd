"""The loss CUDA kernels and the port's training programs on the card.

Every test here needs a CUDA device (and nvcc, which builds the kernels at
first use); each decides inside the test and skips without one. The file
imports nothing of JAX, so on a machine with a card and without JAX it runs
on its own, without the repo's conftest.py (which sets JAX up):

    python -m pytest --noconftest tests/test_torch_card.py -q

Tolerances: loss rtol 1e-5 (the kernel sums one partial per block, the
plain version over the whole image; the value-only kernels and the kernel
with both gradients also shade with other roundings, csrc/value_shading.cuh
and csrc/value_vjp.cuh). dpred rtol 2e-4 with an absolute floor of 1e-3 *
max|dpred| for the two training kernels: they round every op as the plain
versions do on the card, and on an H100 the two agree to the last bit
(chip_smoke.py holds that at the main path's shapes); the floor keeps these
tests true under a torch that rounds some op otherwise, where an ulp grows
large: a normal's gradient sums 27 terms per pixel, some scaled by
1 / denom^3 (up to 1e9 near the clamp). The kernel with both gradients is
held normwise (_assert_both_close, test_both_kernel_within_tolerance). A
bf16 kernel computes what its f32 instantiation computes on the upcast
planes, each gradient rounded once to bf16. The fused SR-Adam kernel
(csrc/sr_adam.cu) is bit-exact against its plain version, in its 'bf16'
state mode too; a bf16 step with bf16-SR masters on the card is held to
the same step on the CPU as chip_smoke.py holds it. TF32 is off for every test.
"""

import itertools
import math

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
    (B=8, 256^2, S=9; seed 3, where chip_smoke.py takes seed 0): loss rel
    <= 1e-5 against its plain version; dpred and dgt against the plain
    version in float64 (on the same, quantized, planes) normwise no further
    than 2x the plain version's own distance from it, and for f32 <= 2e-4
    (bf16's own rounding is ~2e-3), over the pixels at least
    render_fused.KINK_MARGIN from the loss's kinks, where f32 evaluations
    agree on the one-sided derivative (chip_smoke.py prints the distances
    over all pixels); exactly 0 for pred = gt; a NaN in pred gives a NaN
    loss."""
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


def test_cli_trains_resumes_and_tests_on_the_card(cuda, tmp_path):
    """The CLI at depth 5, 32^2, 8 filters, f32, on cuda:0: each train step
    launches the mixed value+gradient kernel once and nothing else runs a
    loss kernel (no validation split with 2 samples); resume continues from
    the saved epoch; test mode writes a grid and metrics.json. The
    checkpoint written on the card, loaded on the CPU, predicts within 1e-4
    of the card."""
    import contextlib
    import io
    import json
    import pathlib

    from svbrdf_tpu_torch.main import main
    from svbrdf_tpu_torch.models import build_model
    from svbrdf_tpu_torch.parallel.step import make_predict_fn
    from svbrdf_tpu_torch.training.checkpoint import Checkpoint

    data = pathlib.Path(__file__).resolve().parents[1] / "data"
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


BF16 = torch.bfloat16


@pytest.mark.parametrize("dtypes", list(itertools.product(
    (torch.float32, BF16), repeat=4)), ids=lambda d: "-".join(
        "bf16" if t == BF16 else "f32" for t in d))
def test_sr_adam_kernel_matches_plain(cuda, dtypes):
    """The fused SR-Adam update, each of its 16 storage combinations of (p,
    g, mu, nu), on a leaf whose size is no multiple of the block and on
    one past a grid's stride, at two (count, salt) pairs (the second past
    JAX's int32 wrap of the moment salt): p, mu and nu equal to the plain
    version's to the bit, one launch each."""
    from svbrdf_tpu_torch.ops import sr_adam
    from svbrdf_tpu_torch.parallel import optimizer as opt

    g = torch.Generator(device=cuda).manual_seed(4)
    for shape in ((61, 33, 4, 4), (4096 * 256 + 7,)):
        for count, salt in ((1, 0), (2148, 2 ** 31 - 2)):
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


def _hold_multi(leaves, s, launches):
    """The multi-tensor kernel on copies of `leaves` against
    sr_adam_multi_plain on other copies: p, mu and nu equal to the bit,
    `launches` launches."""
    from svbrdf_tpu_torch.ops import sr_adam
    from svbrdf_tpu_torch.parallel import optimizer as opt

    def copy(lf):
        return sr_adam.SrLeaf(lf.index, *(t.clone() for t in lf[1:]))

    kern = [copy(lf) for lf in leaves]
    plain = [copy(lf) for lf in leaves]
    before = sr_adam.sr_adam_multi_cuda.launches
    sr_adam.sr_adam_multi_cuda(kern, s, {})
    assert sr_adam.sr_adam_multi_cuda.launches == before + launches
    opt.sr_adam_multi_plain(plain, s)
    torch.cuda.synchronize()
    for a, b in zip(kern, plain):
        for x, y in zip(a[1:], b[1:]):
            assert x.dtype == y.dtype and torch.equal(x, y)


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
    _hold_multi(_multi_leaves(cuda, specs, seed=5), s, 1)


def test_sr_adam_multi_splits_tables(cuda):
    """A leaf set larger than one table: one launch per table, each leaf
    still bit-exact with its own index's salts."""
    from svbrdf_tpu_torch.ops import sr_adam
    from svbrdf_tpu_torch.parallel import optimizer as opt

    n = sr_adam.max_leaves() + 5
    specs = [(i, 33 + i, (BF16, BF16, BF16, BF16) if i % 2
              else (torch.float32,) * 4, (0, 0, 0, 0)) for i in range(n)]
    s = opt.adam_scalars(1e-5, (0.9, 0.999), 1e-8, 7, 7 * 1000003, 99)
    _hold_multi(_multi_leaves(cuda, specs, seed=6), s, 2)


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
    _hold_multi(leaves, s, 1)
    from svbrdf_tpu_torch.ops import sr_adam

    flagged = [sr_adam.SrLeaf(lf.index, *(t.clone() for t in lf[1:]))
               for lf in leaves[-1:]]
    plain = [sr_adam.SrLeaf(lf.index, *(t.clone() for t in lf[1:]))
             for lf in leaves[-1:]]
    sr_adam.sr_adam_multi_cuda(flagged, s)
    sr_adam.sr_adam_multi_cuda(plain, s._replace(bf16_mu_product=False))
    torch.cuda.synchronize()
    assert not torch.equal(flagged[0].mu, plain[0].mu)


def test_path_tracer_card_matches_cpu(cuda):
    """The path tracer (its kernels) on the card against the CPU on the same
    injected samples (B=2, S=9, 32^2, spp (4, 2)), as chip_smoke.py holds
    it: renders by bench_setup.hold_render (rel 1e-5, or where f32 is
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


def test_data_parallel_world_one_over_nccl(cuda):
    """The data-parallel step in a world-1 NCCL group (what the launcher
    runs on one card) against the plain step on the card: the losses as
    test_data_parallel_world_two_on_the_card holds them (bit-equal where
    cuDNN runs deterministically), mixed_fwdgrad once a step."""
    (one,) = bench_setup.data_parallel_runs(
        1, [((_dp_program(), 3), {})], timeout=300)
    plain = bench_setup.train_steps(_dp_program(), 3)
    assert one["backend"] == "nccl"
    _assert_losses(one["losses"], plain["losses"])
    assert one["launches"][0]["mixed_fwdgrad"] == 3


def test_data_parallel_world_two_on_the_card(cuda):
    """World 2 on the card (two cards over NCCL where there are two, else
    both ranks on cuda:0 over gloo) against world 1 on the same global
    batch, f32: the first step's loss rel 1e-5, every step's 1e-4, the
    update normwise 5e-2, not the CPU's 1e-5 and 1e-4: cuDNN's backward
    takes other algorithms at batch 2 than at 4, so the weights part after
    the first step and Adam's first steps magnify that (the same run with
    cuDNN off is held at the CPU's tolerances below); then bf16-SR; the
    replicas bit-identical after each, mixed_fwdgrad (and sr_adam in
    bf16-SR) once a step on each rank."""
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
            assert counts[kernel] == 3
    assert [c["sr_adam"] for c in two_bf16["launches"]] == [3, 3]


def test_data_parallel_world_two_on_the_card_without_cudnn(cuda):
    """World 2 on the card against world 1 on the same global batch with
    cuDNN off in the ranks and in the reference (torch's own convolutions,
    whose sums do not follow cuDNN's choice of algorithm for a batch size),
    f32, 5 steps: the CPU tests' tolerances, each step's loss rel 1e-5 and
    the update normwise 1e-4, so that a fault of the gradient reduction or
    of the rows' draws cannot hide under cuDNN; replicas bit-identical."""
    backend = "nccl" if torch.cuda.device_count() >= 2 else "gloo"
    (two,) = bench_setup.data_parallel_runs(
        2, [((_dp_program(), 5), {"cudnn": False})], backend,
        timeout=300)
    one = bench_setup.train_steps(_dp_program(), 5, cudnn=False)
    np.testing.assert_allclose(two["losses"], one["losses"], rtol=1e-5)
    assert _update_normwise(two, one) <= 1e-4
    assert len(set(two["checksums"])) == 1
    assert [c["mixed_fwdgrad"] for c in two["launches"]] == [5, 5]


def test_spatial_world_two_on_the_card_without_cudnn(cuda):
    """Spatial sharding at world 2 on the card (two cards over NCCL where
    there are two, else both ranks on cuda:0 over gloo): the height split
    over the ranks against world 1 on the same batch, cuDNN off in the
    ranks and in the reference, f32, 5 steps: each step's loss rel 1e-5
    and the update normwise 1e-4 (the CPU tests' tolerances); replicas
    bit-identical; render_fwdgrad once a step on each rank at its row
    offset, the mixed-loss kernels not at all."""
    backend = "nccl" if torch.cuda.device_count() >= 2 else "gloo"
    (two,) = bench_setup.rank_runs(
        2, [(bench_setup.spatial_train_steps, (_dp_program(), 5),
             {"cudnn": False})], "cuda", backend, timeout=300)
    one = bench_setup.train_steps(_dp_program(), 5, cudnn=False)
    np.testing.assert_allclose(two[0]["losses"], one["losses"], rtol=1e-5)
    assert _update_normwise(two[0], one) <= 1e-4
    assert len(set(two[0]["checksums"])) == 1
    for counts in two[0]["launches"]:
        assert counts["render_fwdgrad"] == 5 and counts["mixed_fwdgrad"] == 0


@pytest.mark.parametrize("name", ["render_fwdgrad", "render_fwd"])
def test_rendering_kernels_at_a_row_offset(cuda, name):
    """The two kernels of the spatial path on the two row halves of an
    image (row offset 0 and 16 of a global height 32) against their plain
    versions at the same offset, and the halves' losses summed (and
    gradients put together) against the whole image's."""
    pred_t, gt_t, scenes9 = bench_setup.loss_inputs(2, 32, 9, device=cuda)
    wrapper, plain = rf.CUDA_WRAPPERS[name], rf.PLAIN_VERSIONS[name]
    whole = wrapper(pred_t, gt_t, scenes9)
    whole = whole if isinstance(whole, tuple) else (whole,)
    halves = []
    for lo in (0, 16):
        args = (pred_t[:, :, lo:lo + 16].contiguous(),
                gt_t[:, :, lo:lo + 16].contiguous(), scenes9, lo, 32)
        got, ref = wrapper(*args), plain(*args)
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        torch.testing.assert_close(got[0], ref[0], rtol=1e-5, atol=0)
        for g, r in zip(got[1:], ref[1:]):
            torch.testing.assert_close(g, r, rtol=2e-4,
                                       atol=1e-3 * float(r.abs().max()))
        halves.append(got)
    torch.testing.assert_close(halves[0][0] + halves[1][0], whole[0],
                               rtol=1e-6, atol=0)
    if len(whole) > 1:
        torch.testing.assert_close(
            torch.cat([h[1] for h in halves], dim=2), whole[1], rtol=1e-6,
            atol=1e-6 * float(whole[1].abs().max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pathtrace_kernels_match_plain(cuda, dtype):
    """The path tracer's forward kernel and its VJP against their plain
    versions (B=2, S=9, 64^2, spp (16, 8)) by bench_setup's rules:
    renders by hold_render, each sum of the VJP as close to float64 as
    the plain version (2x, plus 1e-5) and for an f32 SVBRDF within 1e-4 of
    it where the plain version is within 1e-4 of float64."""
    case = bench_setup.pathtrace_case(2, 64, 64, dtype=dtype)
    out = bench_setup.hold_pathtrace_kernels(case)
    assert out["render"]["beyond_rtol"] <= 0.01


def test_pathtrace_kernels_on_a_ragged_grid(cuda):
    """250 x 243 pixels (a ragged last block of each row of blocks), B=3."""
    case = bench_setup.pathtrace_case(3, 250, 243, spp=(4, 2))
    bench_setup.hold_pathtrace_kernels(case)


def test_pathtrace_vjp_with_scene_gradients(cuda):
    """The VJP's scene instantiation (wo's cotangent and the scene fields'
    per-block partials) at 32^2, and render_mc's gradients for the SVBRDF
    and every scene field on the card against the CPU (normwise 1e-4, as
    the CPU holds the port to JAX)."""
    from svbrdf_tpu_torch.ops import pathtrace as pt

    case = bench_setup.pathtrace_case(2, 32, 32, spp=(4, 2))
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
def test_pathtrace_loss_zero_for_identical_maps(cuda, dtype):
    """The path-traced mixed loss through the kernels: pred equal to the
    target (same dtype, same samples) gives loss and gradient exactly 0."""
    from svbrdf_tpu_torch import losses

    target = bench_setup.pathtrace_inputs(2, 32, device="cuda")[1].to(dtype)
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
