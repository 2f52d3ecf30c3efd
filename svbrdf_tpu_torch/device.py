"""Explicit device selection: the port never falls back to the CPU."""

from __future__ import annotations

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
