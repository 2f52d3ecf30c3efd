"""The U-Net block's tail as one op a direction (csrc/norm_merge.cu).

A block's tail takes its conv's output x (B, C, H, W) to the block's output
and its channel means: the pre-norm channel-mean tap (the block's returned
mean, f32), the optional InstanceNorm (one-pass statistics in f32, eps 1e-5,
the affine w, b in f32) rounded to x's dtype, and the merge, which adds the
projected global-track vector m (B, C) in x's dtype. `norm_merge(x, weight,
bias, m)` runs it: `NormMerge`, one autograd node a tail, whose forward and
backward are one kernel launch each for CUDA tensors
(`norm_merge_fwd_cuda`, `norm_merge_bwd_cuda`; each launch adds one to the
wrapper's `launches`) and the plain version `norm_merge_plain` for CPU
tensors: the op chain the blocks ran before the kernels (`spatial_mean`,
`instance_norm`, the merge's broadcast add) with its autograd graph, so a
CPU run computes that chain's values and gradients to the bit. Without
gradients (inference, evaluation) the node is skipped. The kernels are
held to the plain version on the card (tests/test_torch_card.py,
chip_smoke.py).

Not the spatially sharded tail (parallel/spatial._norm_merge), whose
statistics need an all-reduce between the sums and the normalisation.
"""

from __future__ import annotations

import ctypes

import torch

from svbrdf_tpu_torch.ops import _build

SOURCE = "norm_merge"
EPS = 1e-5
DTYPES = (torch.float32, torch.bfloat16)

# Flag bits of the C entries (csrc/norm_merge.cu).
_BF16, _PARAM_BF16, _NORM, _MERGE, _TAP = 1, 2, 4, 8, 16
_FN = {}


def spatial_mean(x):
    """Channel means over H, W (the pre-norm tap into the global track),
    in f32."""
    return torch.mean(x.float(), dim=(2, 3))


def instance_norm(x, weight, bias, eps=EPS, dtype=None):
    """Per-sample, per-channel normalization over H, W with the affine
    weight, bias: biased variance, one-pass statistics E[x^2] - E[x]^2
    clamped at 0, as the JAX package computes them; statistics and affine
    in f32, the result in `dtype` (x's by default)."""
    dtype = x.dtype if dtype is None else dtype
    x = x.float()
    mean = torch.mean(x, dim=(2, 3), keepdim=True)
    mean_sq = torch.mean(torch.square(x), dim=(2, 3), keepdim=True)
    var = torch.clamp(mean_sq - torch.square(mean), min=0.0)
    y = (x - mean) * torch.rsqrt(var + eps)
    y = y * weight[:, None, None] + bias[:, None, None]
    return y.to(dtype)


def norm_merge_plain(x, weight=None, bias=None, m=None, eps=EPS):
    """The tail as torch ops: (out, mean). The tap, then InstanceNorm where
    `weight` (and `bias`) are given, then the merge's add where `m` is; with
    neither, out is x itself."""
    mean = spatial_mean(x)
    if weight is not None:
        x = instance_norm(x, weight, bias, eps)
    if m is not None:
        x = x + m[:, :, None, None]
    return x, mean


def _functions():
    """The C entries, the library built and loaded at first use."""
    if not _FN:
        lib = _build.load(SOURCE)
        ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fwd = lib.svbrdf_norm_merge_fwd
        # x and its row, channel and pixel strides; w, b, m, out, stats;
        # planes, channels, n, flags, eps; device, stream
        fwd.argtypes = ([ptr, i64, i64, i64] + [ptr] * 5
                        + [i64, i32, i64, i32, ctypes.c_float, i32, ptr])
        fwd.restype = i32
        bwd = lib.svbrdf_norm_merge_bwd
        # dout and its strides; g and its row stride; x and its strides;
        # stats, w; dx and its strides; dm, parts; planes, channels, n,
        # flags; device, stream
        bwd.argtypes = ([ptr, i64, i64, i64, ptr, i64, ptr, i64, i64, i64,
                         ptr, ptr, ptr, i64, i64, i64, ptr, ptr]
                        + [i64, i32, i64, i32, i32, ptr])
        bwd.restype = i32
        attributes = lib.svbrdf_norm_merge_attributes
        attributes.argtypes = [i32, i32, i32, ptr, ptr]
        attributes.restype = i32
        _FN.update(fwd=fwd, bwd=bwd, attributes=attributes)
    return _FN


def _ptr(t):
    return None if t is None else t.data_ptr()


def _raise(what: str, rc: int) -> None:
    raise RuntimeError(f"norm_merge {what} kernel launch failed: CUDA error "
                       f"{rc}")


def _strides(t) -> tuple:
    """A (B, C, H, W) tensor's row, channel and pixel strides."""
    return t.stride(0), t.stride(1), t.stride(3)


def _dense(t) -> bool:
    """Contiguous NCHW, or channels last (the encoder's conv outputs)."""
    return (t.is_contiguous()
            or t.is_contiguous(memory_format=torch.channels_last))


def _check(x, weight, bias, m) -> None:
    if x.device.type != "cuda":
        raise RuntimeError(f"the norm_merge kernels need CUDA tensors, got "
                           f"{x.device}")
    if x.dim() != 4 or x.dtype not in DTYPES or not _dense(x):
        raise ValueError(f"x must be a contiguous or channels-last (B, C, H, "
                         f"W) float32 or bfloat16 tensor, got "
                         f"{tuple(x.shape)} {x.dtype} with strides "
                         f"{x.stride()}")
    c = x.shape[1]
    for name, t in (("weight", weight), ("bias", bias)):
        if (weight is None) != (t is None):
            raise ValueError("weight and bias come together")
        if t is not None and (t.shape != (c,) or t.dtype != weight.dtype
                              or t.dtype not in DTYPES
                              or t.device != x.device):
            raise ValueError(f"{name} must be ({c},) float32 or bfloat16 on "
                             f"{x.device}, as weight, got {tuple(t.shape)} "
                             f"{t.dtype} on {t.device}")
    if m is not None and (m.shape != x.shape[:2] or m.dtype != x.dtype
                          or m.device != x.device
                          or not m.is_contiguous()):
        raise ValueError(f"m must be a contiguous {tuple(x.shape[:2])} "
                         f"{x.dtype} tensor on {x.device}, got "
                         f"{tuple(m.shape)} {m.dtype} on {m.device}")


def _flags(dtype, weight) -> int:
    flags = _BF16 if dtype == torch.bfloat16 else 0
    if weight is not None:
        flags |= _NORM
        if weight.dtype == torch.bfloat16:
            flags |= _PARAM_BF16
    return flags


def norm_merge_fwd_cuda(x, weight=None, bias=None, m=None, eps=EPS):
    """One launch of the forward kernel on the current stream: (out,
    stats), stats (2, B, C) f32 holding the tap (the block's mean) and, with
    the norm, rstd. out takes x's layout (NCHW or channels last); it is x
    itself where there is neither a norm nor m."""
    _check(x, weight, bias, m)
    b, c, h, w = x.shape
    stats = torch.empty((2, b, c), dtype=torch.float32, device=x.device)
    out = x if weight is None and m is None else torch.empty_like(x)
    flags = _flags(x.dtype, weight) | (_MERGE if m is not None else 0)
    device = x.get_device()
    rc = _functions()["fwd"](
        x.data_ptr(), *_strides(x), _ptr(weight), _ptr(bias), _ptr(m),
        None if out is x else out.data_ptr(), stats.data_ptr(), b * c, c,
        h * w, flags, eps, device, torch._C._cuda_getCurrentRawStream(device))
    if rc != 0:
        _raise("forward", rc)
    norm_merge_fwd_cuda.launches += 1
    return out, stats


def norm_merge_bwd_cuda(dout, g=None, x=None, stats=None, weight=None,
                        want_dm=False):
    """One launch of the backward kernel on the current stream, from the
    output's cotangent dout (B, C, H, W; its pixels may be strided), the
    tap's g (B, C) f32 or None, and, with the norm, x, the forward's stats
    and weight: (dx, dm, parts). dx takes x's layout with the norm, dout's
    otherwise, and is dout itself where there is neither a norm nor g; dm
    (B, C) in dout's dtype where `want_dm`; parts (2, B, C) f32 with the
    norm: each plane's sum(dout * xhat), then its sum(dout). Nothing is
    launched where nothing is to be computed."""
    if weight is None and g is None and not want_dm:
        return dout, None, None
    b, c, h, w = dout.shape
    if dout.device.type != "cuda" or dout.dtype not in DTYPES:
        raise ValueError(f"dout must be a float32 or bfloat16 CUDA tensor, "
                         f"got {dout.dtype} on {dout.device}")
    if dout.stride(2) != w * dout.stride(3):
        dout = dout.contiguous()  # the pixels of a plane one stride apart
    if g is not None and g.stride(1) != 1:
        g = g.contiguous()
    norm = weight is not None
    if norm and (x is None or x.shape != dout.shape or x.dtype != dout.dtype
                 or not _dense(x) or stats is None):
        raise ValueError("the norm's backward needs the forward's x and stats")
    if norm:
        dx = torch.empty_like(x)
    else:
        dx = torch.empty_like(dout) if g is not None else dout
    dm = (torch.empty((b, c), dtype=dout.dtype, device=dout.device)
          if want_dm else None)
    parts = (torch.empty((2, b, c), dtype=torch.float32, device=dout.device)
             if norm else None)
    flags = (_flags(dout.dtype, weight) | (_MERGE if want_dm else 0)
             | (_TAP if g is not None else 0))
    device = dout.get_device()
    x = x if norm else None
    rc = _functions()["bwd"](
        dout.data_ptr(), *_strides(dout), _ptr(g),
        0 if g is None else g.stride(0), _ptr(x),
        *(_strides(x) if norm else (0, 0, 0)), _ptr(stats) if norm else None,
        _ptr(weight), None if dx is dout else dx.data_ptr(), *_strides(dx),
        _ptr(dm), _ptr(parts), b * c, c, h * w, flags, device,
        torch._C._cuda_getCurrentRawStream(device))
    if rc != 0:
        _raise("backward", rc)
    norm_merge_bwd_cuda.launches += 1
    return dx, dm, parts


norm_merge_fwd_cuda.launches = 0
norm_merge_bwd_cuda.launches = 0


# Each kernel's instances, one a mapping of planes onto the card: a warp a
# plane, a block (or a cluster) a plane, channels last.
MAPPINGS = ("plane_warp", "plane_block", "columns")


def kernel_attributes(backward: bool, dtype, mapping: str) -> dict:
    """Registers and blocks per SM of one kernel instance: the forward or
    the backward, for `dtype` activations, of one of MAPPINGS."""
    regs, per_sm = ctypes.c_int(), ctypes.c_int()
    rc = _functions()["attributes"](int(backward), int(dtype == torch.bfloat16),
                                    MAPPINGS.index(mapping),
                                    ctypes.byref(regs), ctypes.byref(per_sm))
    if rc != 0:
        raise RuntimeError(f"norm_merge attribute query failed: CUDA error "
                           f"{rc}")
    return {"registers": regs.value, "blocks_per_sm": per_sm.value}


class NormMerge(torch.autograd.Function):
    """The tail as one autograd node: (x, weight, bias, m, eps) -> (out,
    mean). CUDA tensors take the kernels; CPU tensors the plain version,
    whose own graph, kept from the forward, gives the backward."""

    @staticmethod
    def forward(ctx, x, weight, bias, m, eps):
        ctx.set_materialize_grads(False)
        if x.device.type == "cpu":
            leaves = [None if t is None else t.detach().requires_grad_(need)
                      for t, need in zip((x, weight, bias, m),
                                         ctx.needs_input_grad)]
            with torch.enable_grad():
                out, mean = norm_merge_plain(*leaves, eps)
            ctx.graph = (leaves, (out, mean))
            return (x if out is leaves[0] else out.detach()), mean.detach()
        out, stats = norm_merge_fwd_cuda(x, weight, bias, m, eps)
        ctx.norm = weight is not None
        ctx.like = (x.shape, x.dtype, x.device)
        if ctx.norm:
            ctx.save_for_backward(x, stats, weight)
        return out, stats[0]

    @staticmethod
    def backward(ctx, dout, dmean):
        if hasattr(ctx, "graph"):
            return (*_plain_backward(ctx, dout, dmean), None)
        if dout is None:  # the output unused: only the tap's cotangent
            shape, dtype, device = ctx.like
            dout = torch.zeros(shape, dtype=dtype, device=device)
        x = stats = weight = None
        if ctx.norm:
            x, stats, weight = ctx.saved_tensors
        dx, dm, parts = norm_merge_bwd_cuda(dout, dmean, x, stats, weight,
                                            ctx.needs_input_grad[3])
        dw = db = None
        if parts is not None:
            dw, db = parts.sum(1).to(weight.dtype)
        return dx, dw, db, dm, None


def _plain_backward(ctx, dout, dmean):
    """The plain version's gradients: autograd through the graph the
    forward kept."""
    leaves, outputs = ctx.graph
    del ctx.graph
    pairs = [(o, g) for o, g in zip(outputs, (dout, dmean))
             if g is not None and o.requires_grad]
    wanted = [t for t in leaves if t is not None and t.requires_grad]
    if not pairs or not wanted:
        return (None,) * len(leaves)
    grads = iter(torch.autograd.grad([o for o, _ in pairs], wanted,
                                     [g for _, g in pairs],
                                     allow_unused=True))
    return tuple(next(grads) if t is not None and t.requires_grad else None
                 for t in leaves)


def norm_merge(x, weight=None, bias=None, m=None, eps=EPS):
    """The block's tail on its conv's output x: (out, mean), out in x's
    dtype and mean (B, C) f32. InstanceNorm where `weight` and `bias` are
    given, the merge where `m` (the projected global vector, (B, C) in x's
    dtype) is. One NormMerge node where a gradient is wanted; otherwise the
    forward alone (its kernel on the card, the plain version on the CPU)."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, weight, bias, m)):
        return NormMerge.apply(x, weight, bias, m, eps)
    if x.device.type == "cpu":
        return norm_merge_plain(x, weight, bias, m, eps)
    out, stats = norm_merge_fwd_cuda(x, weight, bias, m, eps)
    return out, stats[0]
