"""Plain reference of the optimizer: Adam (b1 0.9, b2 0.999, eps 1e-8
outside the square root, bias-corrected) with bf16 masters and moments
under stochastic rounding.

The configuration's master policy 'bf16sr': every >= 2-D parameter is
stored in bf16 and so are its two moments; the first moment is rounded to
nearest, the second and the parameter stochastically: the f32 value's bit
pattern plus a 16-bit dither, truncated. The dither of element k of leaf i
is a counter hash of (k, salt), the salt of the second moment
count * 1000003 + i and the parameter's the step's master salt + i (uint32
sums): the hash and the salts are the method's own, so the reference
rounds with the same dither. 1-D parameters and their moments stay f32.
"""

from __future__ import annotations

import numpy as np
import torch

_MASK32 = 0xFFFFFFFF
_SALT_STEP = 1000003
_MASTER_SALT_STREAM = 17
BETAS, EPS = (0.9, 0.999), 1e-8


def stream_seed(*words: int) -> int:
    """A 64-bit seed from integers: numpy's SeedSequence of the words."""
    return int(np.random.SeedSequence(list(words)).generate_state(
        2, np.uint64)[0])


def master_salt(seed: int, step: int) -> int:
    return stream_seed(seed, step, _MASTER_SALT_STREAM) % (2 ** 31 - 1)


def _dither(n: int, salt: int, device) -> torch.Tensor:
    z = torch.arange(n, dtype=torch.int64, device=device)
    z = (z * 0x9E3779B9 + ((salt & _MASK32) * 0x85EBCA6B & _MASK32)) \
        & _MASK32
    z = z ^ (z >> 16)
    z = (z * 0x7FEB352D) & _MASK32
    z = z ^ (z >> 15)
    return z ^ (z >> 16)


def sr_bf16(x: torch.Tensor, salt: int) -> torch.Tensor:
    bits = x.float().reshape(-1).view(torch.int32).to(torch.int64) & _MASK32
    hi = ((bits + (_dither(bits.numel(), salt, x.device) & 0xFFFF))
          & _MASK32) >> 16
    hi = hi - ((hi & 0x8000) << 1)
    return hi.to(torch.int16).view(torch.bfloat16).reshape(x.shape)


def _f32(x: float) -> float:
    return float(np.float32(x))


class Adam:
    """Adam over `params` (a list in leaf order; bf16 masters where the
    tensor is bf16). step(step_number, seed) updates the leaves that have a
    gradient."""

    def __init__(self, params: list, lr: float):
        self.params, self.lr = params, lr
        self.state = {}

    @torch.no_grad()
    def step(self, step: int, seed: int) -> None:
        salt = master_salt(seed, step)
        b1, b2 = BETAS
        for i, p in enumerate(self.params):
            if p.grad is None:
                continue
            dt = torch.bfloat16 if p.dim() >= 2 else torch.float32
            st = self.state.setdefault(i, {
                "count": 0, "mu": torch.zeros(p.shape, dtype=dt,
                                              device=p.device),
                "nu": torch.zeros(p.shape, dtype=dt, device=p.device)})
            st["count"] += 1
            count = st["count"]
            bc1 = _f32(1.0 - np.float32(float(np.float32(b1)) ** count))
            bc2 = _f32(1.0 - np.float32(float(np.float32(b2)) ** count))
            g = p.grad.float()
            mu = st["mu"].float() * _f32(b1) + g * _f32(1.0 - b1)
            nu = st["nu"].float() * _f32(b2) + g * g * _f32(1.0 - b2)
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + _f32(EPS)) * _f32(-self.lr)
            st["mu"].copy_(mu)
            st["nu"].copy_(sr_bf16(nu, count * _SALT_STEP + i)
                           if dt == torch.bfloat16 else nu)
            p.copy_(sr_bf16(p.float() + u, salt + i)
                    if p.dtype == torch.bfloat16 else p + u)

    def first_moment(self, i: int):
        st = self.state.get(i)
        return None if st is None else st["mu"]
