"""StyleGAN2's styled-conv tail as one op a direction (csrc/styled_tail.cu).

A styled conv's tail takes its modulated conv's output t (B, C, H', W') to
the layer's output: for an up-sampling conv the [1, 3, 3, 1] FIR `blur`
((2h + 1)^2 -> (2h)^2), then the demodulation d (B, C) and the bias, the
noise map (B, 1, H, W) times the layer's strength, leaky ReLU 0.2 and the
gain sqrt 2. `styled_tail(t, d, bias, noise, strength, up)` runs it, `up`
whether the conv up-samples (its FIR the taps of `fir_kernel`):

- CPU tensors take the plain version `styled_tail_plain`, the op chain the
  generator ran before the kernels, with its own autograd graph, so a CPU
  run computes that chain's values and gradients to the bit;
- CUDA tensors (f32, contiguous) take the kernels: one `StyledTail`
  autograd node whose forward and backward are one launch each
  (`styled_tail_fwd_cuda`, `styled_tail_bwd_cuda`; each launch adds one to
  the wrapper's `launches`); without gradients the forward launch alone.
  The backward gives each of t, d, the bias, the noise and the strength
  its gradient where it wants one. CUDA tensors of another dtype or
  layout raise.

The kernels are held to the plain version on the card
(tests/test_torch_card.py); the launch plan (`plan`) is pure Python.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch
from torch.nn import functional as F

from svbrdf_tpu_torch.ops import _build

SOURCE = "styled_tail"
SQRT2 = math.sqrt(2.0)
SLOPE = 0.2
MAX_THREADS = 256
MAX_TILE = 1024  # output pixels a block, 4 a thread at most
MAX_GROUP = 32  # channels a block
BLOCKS_PER_SM = 4  # what the channel groups narrow to give
_NAMES = ("t", "d", "bias", "noise", "strength")
# The C entries' arguments. Forward: t, d, bias, noise, strength, out,
# keep; batch, channels, h, w, up; th, tw, cg, threads; device, stream.
# Backward: g, y, d, bias, noise, strength, grad_t, grad_d, grad_bias,
# grad_noise, grad_strength, scratch; its size; the sizes, the plan,
# device, stream as above.
FWD_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
BWD_ARGTYPES = ([ctypes.c_void_p] * 12 + [ctypes.c_longlong]
                + [ctypes.c_int] * 10 + [ctypes.c_void_p])
_FN = {}
_PLANS = {}


def fir_kernel(device=None, dtype=torch.float32) -> torch.Tensor:
    """The 4x4 FIR of [1, 3, 3, 1] (outer product), summing to 4: the gain
    of a 2x up-sampling."""
    k = torch.tensor([1.0, 3.0, 3.0, 1.0], device=device, dtype=dtype)
    return torch.outer(k, k) / 16.0


def depthwise(kernel: torch.Tensor, channels: int) -> torch.Tensor:
    """`kernel` as the weight of a depthwise conv over `channels`."""
    return kernel[None, None].expand(channels, 1, *kernel.shape)


def blur(x: torch.Tensor, fir: torch.Tensor) -> torch.Tensor:
    """The FIR after a transposed conv of stride 2: (2H + 1)^2 -> (2H)^2,
    padded by 1 (upfirdn2d with pad (1, 1))."""
    return F.conv2d(x, depthwise(fir, x.shape[1]), padding=1,
                    groups=x.shape[1])


def styled_tail_plain(t, d, bias, noise, strength, up: bool = False):
    """The tail as torch ops: blur with fir_kernel where `up`, the two
    addcmul, leaky ReLU 0.2, times sqrt 2."""
    y = blur(t, fir_kernel(t.device, t.dtype)) if up else t
    y = torch.addcmul(bias[:, None, None], y, d[:, :, None, None])
    y = torch.addcmul(y, noise, strength)
    return F.leaky_relu(y, SLOPE) * SQRT2


class Plan(NamedTuple):
    """A launch's mapping: tiles of th x tw output pixels, cg channels a
    block, `threads` threads a block; tiles and groups of them."""

    th: int
    tw: int
    cg: int
    threads: int
    tiles: int
    groups: int


def plan(batch: int, channels: int, h: int, w: int, sms: int) -> Plan:
    """The mapping of an output (batch, channels, h, w) on a card of `sms`
    SMs: tiles up to 32 pixels wide and MAX_TILE pixels in all, a warp's
    multiple of threads up to MAX_THREADS (4 pixels a thread at most), and
    channel groups of MAX_GROUP halved until the grid gives every SM
    BLOCKS_PER_SM blocks (or one channel a group)."""
    tw = min(w, 32)
    th = min(h, MAX_TILE // tw)
    threads = min(MAX_THREADS, -(-th * tw // 32) * 32)
    tiles = -(-w // tw) * -(-h // th)
    cg = MAX_GROUP
    while cg > 1 and batch * tiles * -(-channels // cg) < BLOCKS_PER_SM * sms:
        cg //= 2
    return Plan(th, tw, cg, threads, tiles, -(-channels // cg))


def entries(lib: ctypes.CDLL) -> dict:
    """The library's two C entries, typed: {"fwd": .., "bwd": ..}."""
    fwd, bwd = lib.svbrdf_styled_tail_fwd, lib.svbrdf_styled_tail_bwd
    fwd.argtypes, bwd.argtypes = FWD_ARGTYPES, BWD_ARGTYPES
    fwd.restype = bwd.restype = ctypes.c_int
    return {"fwd": fwd, "bwd": bwd}


def _functions():
    """The C entries, the library built and loaded at first use."""
    if not _FN:
        _FN.update(entries(_build.load(SOURCE)))
    return _FN


def _plan_for(batch, channels, h, w, index: int) -> Plan:
    """plan() for the card `index`, memoised by shape."""
    key = (batch, channels, h, w, index)
    p = _PLANS.get(key)
    if p is None:
        sms = torch.cuda.get_device_properties(index).multi_processor_count
        p = _PLANS[key] = plan(batch, channels, h, w, sms)
    return p


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check(t, d, bias, noise, strength, up: bool) -> None:
    """Raises on what the kernels do not take."""
    if not t.is_cuda:
        raise RuntimeError(f"the styled_tail kernels need CUDA tensors, got "
                           f"{t.device}")
    device = t.device
    for name, x in zip(_NAMES, (t, d, bias, noise, strength)):
        if (x.dtype != torch.float32 or not x.is_contiguous()
                or x.device != device):
            raise ValueError(f"{name} must be a contiguous float32 tensor on "
                             f"{device}, got {x.dtype} on {x.device} with "
                             f"strides {x.stride()}")
    if t.dim() != 4 or noise.dim() != 4:
        raise ValueError(f"t and noise must be 4-d, got {tuple(t.shape)} and "
                         f"{tuple(noise.shape)}")
    b, c, ht, wt = t.shape
    nb, one, h, w = noise.shape
    if ((nb, one) != (b, 1) or (ht, wt) != (h + up, w + up)
            or tuple(d.shape) != (b, c) or tuple(bias.shape) != (c,)
            or strength.numel() != 1):
        raise ValueError(
            f"shapes: t {tuple(t.shape)} (B, C, H + {int(up)}, W + "
            f"{int(up)}), noise {tuple(noise.shape)} (B, 1, H, W), d "
            f"{tuple(d.shape)} (B, C), bias {tuple(bias.shape)} (C,), "
            f"strength {tuple(strength.shape)} (one value)")


def _raise(what: str, rc: int) -> None:
    raise RuntimeError(f"styled_tail {what} kernel launch failed: CUDA error "
                       f"{rc}")


def launch_fwd(fn, t, d, bias, noise, strength, up: bool, keep: bool,
               p: Plan, device: int, stream) -> tuple:
    """One call of the forward's C entry `fn` with plan `p` on checked
    tensors: (out, y) as styled_tail_fwd_cuda returns them."""
    b, c, h, w = t.shape[0], t.shape[1], noise.shape[2], noise.shape[3]
    out = t.new_empty((b, c, h, w))
    y = t.new_empty((b, c, h, w)) if up and keep else None
    rc = fn(t.data_ptr(), d.data_ptr(), bias.data_ptr(), noise.data_ptr(),
            strength.data_ptr(), out.data_ptr(), _ptr(y), b, c, h, w,
            int(up), p.th, p.tw, p.cg, p.threads, device, stream)
    if rc != 0:
        _raise("forward", rc)
    return out, (t if keep and not up else y)


def scratch_floats(p: Plan, batch: int, channels: int, h: int, w: int,
                   wants: tuple) -> int:
    """The f32 the backward's partials and counters take (0: none), in the
    C entry's layout: grad_d's and grad_bias's tile partials where the plan
    has more than one tile, grad_bias's (B, C) sums, grad_noise's group
    partials where it has more than one group, grad_strength's one a block,
    then the counters."""
    _, want_d, want_bias, want_noise, want_strength = wants
    split_c = (want_d or want_bias) and p.tiles > 1
    split_noise = want_noise and p.groups > 1
    if not (split_c or split_noise or want_bias or want_strength):
        return 0
    bc = batch * channels
    return (p.tiles * bc * split_c * (want_d + want_bias) + bc * want_bias
            + p.groups * batch * h * w * split_noise
            + batch * p.groups * p.tiles * want_strength
            + batch * (p.groups + p.tiles) + 1)


def launch_bwd(fn, g, y, d, bias, noise, strength, up: bool, wants: tuple,
               p: Plan, device: int, stream) -> tuple:
    """One call of the backward's C entry `fn` with plan `p` on checked
    tensors, `wants` (t, d, bias, noise, strength): the gradients as
    styled_tail_bwd_cuda returns them."""
    want_t, want_d, want_bias, want_noise, want_strength = wants
    b, c, h, w = y.shape
    grad_t = y.new_empty((b, c, h + up, w + up)) if want_t else None
    grad_d = d.new_empty((b, c)) if want_d else None
    grad_bias = bias.new_empty((c,)) if want_bias else None
    grad_noise = noise.new_empty((b, 1, h, w)) if want_noise else None
    grad_strength = (strength.new_empty(strength.shape) if want_strength
                     else None)
    # The partials that cross blocks and the blocks' counters, one buffer.
    n = scratch_floats(p, b, c, h, w, wants)
    scratch = y.new_empty((n,)) if n else None
    rc = fn(g.data_ptr(), y.data_ptr(), d.data_ptr(), bias.data_ptr(),
            noise.data_ptr(), strength.data_ptr(), _ptr(grad_t),
            _ptr(grad_d), _ptr(grad_bias), _ptr(grad_noise),
            _ptr(grad_strength), _ptr(scratch), n, b, c, h, w, int(up),
            p.th, p.tw, p.cg, p.threads, device, stream)
    if rc != 0:
        _raise("backward", rc)
    return grad_t, grad_d, grad_bias, grad_noise, grad_strength


def _fwd(t, d, bias, noise, strength, up: bool, keep: bool) -> tuple:
    """The forward launch on checked tensors, counted."""
    device = t.get_device()
    result = launch_fwd(_functions()["fwd"], t, d, bias, noise, strength, up,
                        keep, _plan_for(t.shape[0], t.shape[1],
                                        noise.shape[2], noise.shape[3],
                                        device),
                        device, torch._C._cuda_getCurrentRawStream(device))
    styled_tail_fwd_cuda.launches += 1
    return result


def _bwd(g, y, d, bias, noise, strength, up: bool, wants: tuple) -> tuple:
    """The backward launch on checked tensors (g contiguous), counted."""
    device = y.get_device()
    grads = launch_bwd(_functions()["bwd"], g, y, d, bias, noise, strength,
                       up, wants, _plan_for(*y.shape, device), device,
                       torch._C._cuda_getCurrentRawStream(device))
    styled_tail_bwd_cuda.launches += 1
    return grads


def styled_tail_fwd_cuda(t, d, bias, noise, strength, up: bool,
                         keep: bool = False):
    """One launch of the forward kernel on the current stream: (out, y), y
    the FIR's output (B, C, H, W) where `up` and `keep`, t itself for a
    plain conv where `keep`, None otherwise."""
    _check(t, d, bias, noise, strength, up)
    return _fwd(t, d, bias, noise, strength, up, keep)


def styled_tail_bwd_cuda(g, y, d, bias, noise, strength, up: bool,
                         wants: tuple = (True,) * 5):
    """One launch of the backward kernel on the current stream, from the
    output's cotangent g and the forward's y: (grad_t, grad_d, grad_bias,
    grad_noise, grad_strength), each None where `wants` (the same order)
    says no. Nothing is launched where nothing is wanted."""
    if not any(wants):
        return (None,) * 5
    _check(y, d, bias, noise, strength, False)
    if g.shape != y.shape or g.dtype != y.dtype or g.device != y.device:
        raise ValueError(f"g must be f32 {tuple(y.shape)} on {y.device}, as "
                         f"y, got {g.dtype} {tuple(g.shape)} on {g.device}")
    return _bwd(g.contiguous(), y, d, bias, noise, strength, up,
                tuple(wants))


styled_tail_fwd_cuda.launches = 0
styled_tail_bwd_cuda.launches = 0


class StyledTail(torch.autograd.Function):
    """The tail on the card as one autograd node: (t, d, bias, noise,
    strength, up) -> out; a gradient for each tensor that wants one."""

    @staticmethod
    def forward(ctx, t, d, bias, noise, strength, up):
        out, y = styled_tail_fwd_cuda(t, d, bias, noise, strength, up,
                                      keep=True)
        ctx.up = up
        ctx.save_for_backward(y, d, bias, noise, strength)
        return out

    @staticmethod
    def backward(ctx, g):
        wants = ctx.needs_input_grad[:5]
        if not any(wants):
            return (None,) * 6
        return (*_bwd(g.contiguous(), *ctx.saved_tensors, ctx.up, wants),
                None)


def styled_tail(t, d, bias, noise, strength, up: bool = False):
    """The styled conv's tail on its conv's output t, `up` whether the conv
    up-samples: the plain version for CPU tensors; otherwise the kernels,
    one StyledTail node where any input wants a gradient, else the forward
    launch alone."""
    if t.is_cpu:
        return styled_tail_plain(t, d, bias, noise, strength, up)
    if torch.is_grad_enabled() and (
            t.requires_grad or d.requires_grad or bias.requires_grad
            or noise.requires_grad or strength.requires_grad):
        return StyledTail.apply(t, d, bias, noise, strength, up)
    return styled_tail_fwd_cuda(t, d, bias, noise, strength, up)[0]
