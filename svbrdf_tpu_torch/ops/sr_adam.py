"""The fused Adam update with stochastic rounding (csrc/sr_adam.cu).

`sr_adam_update_cuda(p, g, mu, nu, s)` updates one parameter tensor and its
two moments in place on the card, in one launch: Adam in f32, mu stored
round-to-nearest, a bf16 nu and a bf16 p stochastically rounded with the
salts of `s` (parallel/optimizer.AdamScalars). Its plain version is
parallel/optimizer.adam_update_plain, bit-exact with it;
parallel/optimizer.update picks the one for the tensors' device. Each
launch adds one to `sr_adam_update_cuda.launches`.
"""

from __future__ import annotations

import ctypes

import torch

from svbrdf_tpu_torch.ops import _build

SOURCE = "sr_adam"
STORAGE_DTYPES = (torch.float32, torch.bfloat16)
_FN = []


def _kernel():
    """The C entry, its library built and loaded at first use."""
    if not _FN:
        fn = _build.load(SOURCE).svbrdf_sr_adam
        # p, g, mu, nu; n; four bf16 flags; two salts; eight floats; stream
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong]
                       + [ctypes.c_int] * 4 + [ctypes.c_uint] * 2
                       + [ctypes.c_float] * 8 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FN.append(fn)
    return _FN[0]


def _check(p, g, mu, nu) -> None:
    for name, t in (("p", p), ("g", g), ("mu", mu), ("nu", nu)):
        if t.device != p.device or t.device.type != "cuda":
            raise RuntimeError(f"the sr_adam kernel needs CUDA tensors on one "
                               f"device, {name} is on {t.device}")
        if t.dtype not in STORAGE_DTYPES:
            raise TypeError(f"{name} must be float32 or bfloat16, got "
                            f"{t.dtype}")
        if t.shape != p.shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, p "
                             f"{tuple(p.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


@torch.no_grad()
def sr_adam_update_cuda(p: torch.Tensor, g: torch.Tensor, mu: torch.Tensor,
                        nu: torch.Tensor, s) -> None:
    """Launch the fused update of one leaf on the current stream."""
    _check(p, g, mu, nu)
    fn = _kernel()
    with torch.cuda.device(p.device):
        rc = fn(p.data_ptr(), g.data_ptr(), mu.data_ptr(), nu.data_ptr(),
                p.numel(), *(int(t.dtype == torch.bfloat16)
                             for t in (p, g, mu, nu)),
                s.nu_salt, s.master_salt, s.b1, s.omb1, s.b2, s.omb2, s.bc1,
                s.bc2, s.eps, s.neg_lr,
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"sr_adam kernel launch failed: CUDA error {rc}")
    sr_adam_update_cuda.launches += 1


sr_adam_update_cuda.launches = 0
