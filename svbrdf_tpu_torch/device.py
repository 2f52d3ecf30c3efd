"""Explicit device selection (the port never falls back to the CPU) and
the precision policy of float32 work on the card."""

from __future__ import annotations

from contextlib import contextmanager

import torch


def resolve_device(device="cuda") -> torch.device:
    """Return `device` as a torch.device, checking that it can be used.

    The default is the card. A caller that wants the CPU says so with
    device="cpu" (the tests do); asking for CUDA on a machine without it
    raises rather than silently running somewhere slower.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU")
    return dev


@contextmanager
def precision_scope(dtype: torch.dtype):
    """Run the body with the card's float32 convolutions and matrix
    products at the precision `dtype` asks for, and restore the caller's
    settings on exit.

    float32: TF32 off (torch.backends.cudnn.allow_tf32 and
    torch.backends.cuda.matmul.allow_tf32 False), so float32 means f32 on
    the card as on the CPU (torch's default runs cuDNN convolutions in
    TF32). bfloat16: the settings are left as they are; the convolutions
    run in bf16, and TF32 touches only the small f32 remainder."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    if dtype == torch.float32:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
