"""The U-Net block's tail as one op (ops/norm_merge.py) on the CPU.

The plain path through NormMerge, which CPU tensors take, must compute what
the blocks computed before the op existed, to the bit: the chain below
(`_chain`, a copy of layers.spatial_mean, InstanceNorm.forward and
Merge.forward as they were) in its values and in every gradient, in f32
and bf16, with f32 or bf16 (master) norm parameters, with and without the
norm, with and without a global track, with and without a use of the tap.
A model's autograd graph holds one NormMerge node per block tail, the
first encoder block's excepted (no norm and no global track: its output is
its conv's, its tap unread): the engagement count on the CPU (the card counts the kernels' launches,
tests/test_torch_card.py). The CUDA wrappers refuse CPU tensors.
"""

import pytest
import torch

from svbrdf_tpu_torch.models import SingleViewModel
from svbrdf_tpu_torch.models import layers as L
from svbrdf_tpu_torch.models.generator import Generator
from svbrdf_tpu_torch.models.multi_view import MultiViewModel
from svbrdf_tpu_torch.ops import norm_merge as nm
from svbrdf_tpu_torch.utils import bench_setup

torch.set_num_threads(1)

EPS = 1e-5
# (compute dtype, norm parameters' dtype)
DTYPES = {"f32": (torch.float32, torch.float32),
          "bf16": (torch.bfloat16, torch.bfloat16),
          "bf16_f32_params": (torch.bfloat16, torch.float32)}


def _chain(x, weight, bias, fc, g):
    """The tail as the blocks ran it: spatial_mean, InstanceNorm, Merge."""
    dtype = x.dtype
    mean = torch.mean(x.float(), dim=(2, 3))
    if weight is not None:
        xf = x.float()
        mu = torch.mean(xf, dim=(2, 3), keepdim=True)
        mean_sq = torch.mean(torch.square(xf), dim=(2, 3), keepdim=True)
        var = torch.clamp(mean_sq - torch.square(mu), min=0.0)
        y = (xf - mu) * torch.rsqrt(var + EPS)
        y = y * weight[:, None, None] + bias[:, None, None]
        x = y.to(dtype)
    if g is not None:
        x = x + fc(g)[:, :, None, None]
    return x, mean


def _fused(x, weight, bias, fc, g):
    m = None if g is None else fc(g)
    return nm.norm_merge(x, weight, bias, m, EPS)


def _inputs(dtype, param_dtype, size, norm, track, seed):
    gen = torch.Generator().manual_seed(seed)
    b, c, gdim = 3, 5, 7

    def draw(*shape, scale=1.0, offset=0.0):
        return torch.randn(*shape, generator=gen) * scale + offset

    # Per-plane offsets: conv outputs' channel means are not zero.
    x = (draw(b, c, size, size) + draw(b, c, 1, 1, scale=2.0)).to(dtype)
    leaves = {"x": x.requires_grad_()}
    if norm:
        leaves["weight"] = draw(c, offset=1.0).to(param_dtype).requires_grad_()
        leaves["bias"] = draw(c, scale=0.5).to(param_dtype).requires_grad_()
    fc = L.Linear(gdim, c, bias=False, compute_dtype=dtype)
    with torch.no_grad():
        fc.weight.copy_(draw(c, gdim, scale=0.3))
    if track:
        leaves["g"] = draw(b, gdim).requires_grad_()
    cot = (draw(b, c, size, size).to(dtype), draw(b, c))
    return leaves, fc, cot


def _run(fn, leaves, fc, cot, use_tap):
    out, mean = fn(leaves["x"], leaves.get("weight"), leaves.get("bias"), fc,
                   leaves.get("g"))
    wanted = list(leaves.values()) + [fc.weight]
    outputs, grads = [out], [cot[0]]
    if use_tap:
        outputs.append(mean)
        grads.append(cot[1])
    got = torch.autograd.grad(outputs, wanted, grads, allow_unused=True)
    return [out, mean, *got]


@pytest.mark.parametrize("dtypes", sorted(DTYPES))
@pytest.mark.parametrize("norm", [True, False], ids=["norm", "no_norm"])
@pytest.mark.parametrize("track", [True, False], ids=["track", "no_track"])
@pytest.mark.parametrize("size", [1, 2, 5, 32])
def test_plain_path_equals_the_chain_to_the_bit(dtypes, norm, track, size):
    dtype, param_dtype = DTYPES[dtypes]
    for seed, use_tap in ((0, True), (1, False)):
        leaves, fc, cot = _inputs(dtype, param_dtype, size, norm, track, seed)
        ref = _run(_chain, leaves, fc, cot, use_tap)
        got = _run(_fused, leaves, fc, cot, use_tap)
        names = ["out", "mean", *leaves, "fc.weight"]
        for name, a, r in zip(names, got, ref):
            if r is None:
                assert a is None or not a.abs().max(), name
                continue
            assert a.dtype == r.dtype and a.shape == r.shape, name
            assert torch.equal(a, r), (name, (a - r).float().abs().max())


def test_no_grad_forward_is_the_plain_chain():
    leaves, fc, _ = _inputs(torch.bfloat16, torch.bfloat16, 8, True, True, 3)
    with torch.no_grad():
        got = _fused(leaves["x"], leaves["weight"], leaves["bias"], fc,
                     leaves["g"])
        ref = _chain(leaves["x"], leaves["weight"], leaves["bias"], fc,
                     leaves["g"])
    for a, r in zip(got, ref):
        assert a.grad_fn is None and torch.equal(a, r)


def _count_nodes(*outputs, name="NormMergeBackward"):
    """NormMerge nodes in the autograd graph behind `outputs`."""
    seen, stack, count = set(), [o.grad_fn for o in outputs], 0
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        count += type(node).__name__ == name
        stack.extend(f for f, _ in node.next_functions)
    return count


@pytest.mark.parametrize("depth,size", [(5, 32), (8, 256)])
def test_one_node_per_block_tail(depth, size):
    torch.manual_seed(0)
    model = Generator(9, num_filters=2, depth=depth)
    h, g = model(torch.randn(1, 3, size, size))
    assert _count_nodes(h, g) == 2 * depth - 1
    h.float().sum().backward()  # every node runs its backward


def test_multi_view_head_takes_four_more_tails():
    model = MultiViewModel(num_filters=4, depth=5,
                           generator_output_channels=8, device="cpu")
    maps = model(torch.rand(1, 2, 32, 32, 3))
    assert _count_nodes(maps) == 2 * 5 - 1 + 4


def test_tail_cases_follow_the_models():
    """bench_setup.tail_cases, the tails' shapes the card's checks and
    timings run, are the shapes a forward of each model gives its tails."""
    seen = []

    def recording(x, weight=None, bias=None, m=None, eps=EPS):
        seen.append((*x.shape, weight is not None, m is not None))
        return nm.norm_merge_plain(x, weight, bias, m, eps)

    mp = pytest.MonkeyPatch()
    mp.setattr(L, "norm_merge", recording)
    mp.setattr("svbrdf_tpu_torch.models.multi_view.norm_merge", recording)
    try:
        for kind, batch, views in (("single", 2, 1), ("multi", 2, 3)):
            seen.clear()
            if kind == "single":
                model = SingleViewModel(4, 5, device="cpu")
                model(torch.rand(batch, 32, 32, 3))
            else:
                model = MultiViewModel(4, 5, device="cpu")
                model(torch.rand(batch, views, 32, 32, 3))
            cases = bench_setup.tail_cases(kind, batch, 32, depth=5,
                                           num_filters=4)
            assert [tuple(c[:6]) for c in cases] == seen
    finally:
        mp.undo()


def test_cuda_wrappers_refuse_cpu_tensors():
    x = torch.zeros(1, 2, 4, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        nm.norm_merge_fwd_cuda(x)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        nm.norm_merge_bwd_cuda(x.double(), want_dm=True)
