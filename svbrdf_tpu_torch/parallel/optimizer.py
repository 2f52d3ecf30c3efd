"""Adam with reduced-precision state, and stochastic rounding to bf16.

Counterpart of svbrdf_tpu/parallel/optimizer.py. bf16 moments halve
Adam's state traffic, but round-to-nearest storage would freeze the second
moment: its EMA increments are (1 - beta2) = 1e-3-scale relative changes,
far below bf16's ~0.4 % mantissa step. Stochastic rounding (SR) adds a
uniform dither below the cut before truncating, so the stored value is
unbiased (E[sr_bf16(x)] = x) and the EMA is followed in expectation. The
same rounding lands the sub-ulp updates of bf16 master weights
(parallel/step.master_dtype_policy).

The dither is the JAX package's counter-based hash over (element index,
salt), bit for bit: torch has no full uint32 arithmetic, so it runs on
int64 tensors masked to 32 bits after every multiply and shift, and the
salt's own product (which would overflow int64) is reduced on the host.

AdamBf16SR computes optax's Adam (bias-corrected, eps outside the square
root) in f32 and stores the state in the dtypes of its precision:
  - 'bf16sr': >=2-D leaves keep mu bf16 (round to nearest) and nu bf16
    (stochastically rounded); 1-D leaves keep f32 moments;
  - 'bf16': mu bf16 (round to nearest), nu f32, every leaf, in the order
    of optax.adam(mu_dtype=bfloat16): b1 enters as bf16(b1) = 0.8984375
    and its product with the bf16 mu (exact in f32) is rounded to bf16
    before the f32 sum with (1 - b1) * g; u is computed from that f32 sum,
    and only the stored mu is rounded (AdamScalars.bf16_mu_product);
  - 'f32': f32 moments.
A bf16 parameter (a bf16 master) is updated as sr_bf16(p + u, salt + i)
with the caller's master salt; an f32 one as p + u. The state's keys are
torch.optim.Adam's (step, exp_avg, exp_avg_sq), so checkpoints load across
the two and across precisions: load_state_dict casts the moments to this
optimizer's dtypes.

A step updates its leaves together: the leaves with a gradient, grouped
into buckets that share a param group, a step count and a device (one on
the main path). On CPU tensors a bucket runs the plain version
(sr_adam_multi_plain: adam_update_plain leaf by leaf); on CUDA tensors the
fused kernel of csrc/sr_adam.cu (ops/sr_adam.sr_adam_multi_cuda), one
launch for the bucket, which computes the same ops in the same order and is
bit-exact with it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from svbrdf_tpu_torch.ops import sr_adam

_MASK32 = 0xFFFFFFFF
_SALT_STEP = 1000003  # per-step stride of the per-leaf moment salt
_ONE = torch.tensor(1.0)  # a step's increment of the step counts


def u32(salt: int) -> int:
    """An integer salt read as uint32, as JAX's int32 salts are read by
    .astype(uint32): two's complement, modulo 2^32."""
    return int(salt) & _MASK32


def dither_bits(shape, salt: int, device=None) -> torch.Tensor:
    """Per-element uint32 hash of the row-major element index and `salt`
    (JAX's _dither_bits), as int64 values in [0, 2^32)."""
    n = 1
    for d in shape:
        n *= int(d)
    salt_term = (u32(salt) * 0x85EBCA6B) & _MASK32
    z = torch.arange(n, dtype=torch.int64, device=device)
    z = (z * 0x9E3779B9 + salt_term) & _MASK32
    z = z ^ (z >> 16)
    z = (z * 0x7FEB352D) & _MASK32
    z = z ^ (z >> 15)
    return (z ^ (z >> 16)).reshape(tuple(int(d) for d in shape))


def sr_bf16(x: torch.Tensor, salt: int) -> torch.Tensor:
    """Stochastically round to bf16: add the dither's low 16 bits to the
    f32 bit pattern and truncate. Unbiased: E[result] = x."""
    bits = x.float().view(torch.int32).to(torch.int64) & _MASK32
    noise = dither_bits(x.shape, salt, x.device) & 0xFFFF
    hi = ((bits + noise) & _MASK32) >> 16
    hi = hi - ((hi & 0x8000) << 1)  # the bf16 pattern as a signed int16
    return hi.to(torch.int16).view(torch.bfloat16)


def moment_dtype(p: torch.Tensor) -> torch.dtype:
    """bf16 moments for >=2-D leaves (conv and linear weights, where the
    bytes are), f32 for 1-D ones (biases, norm scales), as the master-dtype
    policy's >=2-D rule."""
    return torch.bfloat16 if p.dim() >= 2 else torch.float32


PRECISIONS = ("bf16sr", "bf16", "f32")


def state_dtypes(p: torch.Tensor, precision: str) -> tuple:
    """(mu dtype, nu dtype) of parameter `p` under state `precision`."""
    if precision == "bf16sr":
        return moment_dtype(p), moment_dtype(p)
    if precision == "bf16":
        return torch.bfloat16, torch.float32
    return torch.float32, torch.float32


class AdamScalars(NamedTuple):
    """The scalars of one step, each float exactly an f32 value: b1, 1 -
    b1, b2, 1 - b2, the bias corrections 1 - b^count, eps and -lr; the two
    salts as uint32 (master_salt unused for an f32 parameter): one leaf's
    in adam_update_plain, the bases that leaf i adds i to in a multi-leaf
    update (ops/sr_adam.leaf_salts)."""

    b1: float
    omb1: float
    b2: float
    omb2: float
    bc1: float
    bc2: float
    eps: float
    neg_lr: float
    nu_salt: int
    master_salt: int
    bf16_mu_product: bool = False


def _f32(x) -> float:
    return float(np.float32(x))


def _bias_correction(b: float, count: int) -> float:
    """1 - b ** count as the JAX update forms it in f32: b rounded to f32,
    its power rounded once to f32 (computed in float64; XLA's and numpy's
    f32 pow each miss the rounded value by an ulp at some counts), then
    subtracted in f32."""
    power = np.float32(float(np.float32(b)) ** count)
    return float(np.float32(1.0) - power)


def adam_scalars(lr: float, betas: tuple, eps: float, count: int,
                 nu_salt: int, master_salt: int = 0,
                 bf16_mu_product: bool = False) -> AdamScalars:
    """The scalars as the JAX update forms them in f32: b1 and 1 - b1 from
    Python floats, the bias corrections by _bias_correction (with b1 as it
    is, also where bf16_mu_product rounds it for the product)."""
    b1, b2 = betas
    return AdamScalars(
        b1=_f32(b1), omb1=_f32(1.0 - b1), b2=_f32(b2), omb2=_f32(1.0 - b2),
        bc1=_bias_correction(b1, count), bc2=_bias_correction(b2, count),
        eps=_f32(eps), neg_lr=_f32(-lr), nu_salt=u32(nu_salt),
        master_salt=u32(master_salt),
        bf16_mu_product=bool(bf16_mu_product))


@torch.no_grad()
def adam_update_plain(p: torch.Tensor, g: torch.Tensor, mu: torch.Tensor,
                      nu: torch.Tensor, s: AdamScalars) -> None:
    """One leaf's update in place, in f32: mu stored round-to-nearest, nu
    through sr_bf16 when it is bf16, p through sr_bf16 with the master salt
    when it is bf16, else p + u; with s.bf16_mu_product the product b1 * mu
    is taken with bf16(b1) and rounded to bf16 before the sum. The bias
    corrections divide as tensors on p's device (torch takes a division by
    a Python number on the card as a product with its reciprocal; the
    kernel and JAX divide)."""
    def scalar(v):
        return torch.tensor(v, dtype=torch.float32, device=p.device)

    g32 = g.float()
    if s.bf16_mu_product:
        b1 = float(torch.tensor(s.b1).to(torch.bfloat16))
        mu32 = (mu.float() * b1).to(torch.bfloat16).float() + g32 * s.omb1
    else:
        mu32 = mu.float() * s.b1 + g32 * s.omb1
    nu32 = nu.float() * s.b2 + g32 * g32 * s.omb2
    u = (mu32 / scalar(s.bc1)) / (torch.sqrt(nu32 / scalar(s.bc2)) + s.eps)
    u = u * s.neg_lr
    mu.copy_(mu32)
    nu.copy_(sr_bf16(nu32, s.nu_salt) if nu.dtype == torch.bfloat16
             else nu32)
    p.copy_(sr_bf16(p.float() + u, s.master_salt)
            if p.dtype == torch.bfloat16 else p + u)


def sr_adam_multi_plain(leaves, s: AdamScalars) -> None:
    """The update of every leaf (ops/sr_adam.SrLeaf) in place, leaf i with
    the salts ops/sr_adam.leaf_salts(s, i): the fused kernel's plain
    version."""
    for lf in leaves:
        nu_salt, master = sr_adam.leaf_salts(s, lf.index)
        adam_update_plain(lf.p, lf.g, lf.mu, lf.nu,
                          s._replace(nu_salt=nu_salt, master_salt=master))


def update_leaves(leaves, s: AdamScalars, plans=None) -> None:
    """The update of a bucket of leaves on one device: the plain version for
    CPU tensors, the fused kernel (ops/sr_adam) for CUDA tensors, with the
    launch plans cached in `plans`."""
    if leaves[0].p.device.type == "cpu":
        sr_adam_multi_plain(leaves, s)
    else:
        sr_adam.sr_adam_multi_cuda(leaves, s, plans)


class AdamBf16SR(torch.optim.Optimizer):
    """Adam with its state in the dtypes of `precision` ('bf16sr', 'bf16'
    or 'f32'; see the module docstring) and SR updates of bf16 parameters.

    step(master_salt=None): the per-step salt of the bf16 masters' SR
    (leaf i rounds with master_salt + i, modulo 2^32); required when any
    parameter is bf16. Leaf i's moment salt is count * 1000003 + i modulo
    2^32, count being its step after the increment, as JAX's int32 product
    wraps. i is the parameter's position over the param groups, counting
    the parameters without a gradient, which the step leaves alone.
    """

    def __init__(self, params, lr: float = 1e-5, betas=(0.9, 0.999),
                 eps: float = 1e-8, precision: str = "bf16sr"):
        if precision not in PRECISIONS:
            raise ValueError(f"unknown optimizer state precision "
                             f"{precision!r}")
        self.precision = precision
        # weight_decay 0: torch.optim.Adam reads it from the groups of a
        # state this optimizer saved.
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps,
                                      weight_decay=0.0))

    def _leaves(self):
        return [(group, p) for group in self.param_groups
                for p in group["params"]]

    def _init_state(self, p):
        mu_dtype, nu_dtype = state_dtypes(p, self.precision)
        state = self.state[p]
        state["step"] = torch.tensor(0.0)
        state["exp_avg"] = torch.zeros(p.shape, dtype=mu_dtype,
                                       device=p.device)
        state["exp_avg_sq"] = torch.zeros(p.shape, dtype=nu_dtype,
                                          device=p.device)
        return state

    @torch.no_grad()
    def step(self, closure=None, master_salt: Optional[int] = None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        stepped = [(i, group, p) for i, (group, p) in
                   enumerate(self._leaves()) if p.grad is not None]
        if not stepped:
            return loss
        if master_salt is None and any(p.dtype == torch.bfloat16
                                       for _, _, p in stepped):
            raise ValueError("AdamBf16SR.step needs master_salt: a "
                             "parameter is bf16")
        states = [self.state[p] or self._init_state(p) for _, _, p in stepped]
        # The step counts live on the host (CPU tensors, as in
        # torch.optim.Adam), so the salts and bias corrections need no
        # device read: one increment and one read for all of them. The 1
        # is a tensor, as torch.optim.Adam passes it: with a Python number
        # the CPU loop of _foreach_add_ wraps it once per tensor.
        counts = [state["step"] for state in states]
        torch._foreach_add_(counts, _ONE, alpha=1.0)
        buckets = {}
        for (i, group, p), state, count in zip(stepped, states,
                                               torch.stack(counts).tolist()):
            buckets.setdefault((id(group), int(count), p.get_device()),
                               (group, int(count), []))[2].append(
                sr_adam.SrLeaf(i, p, p.grad, state["exp_avg"],
                               state["exp_avg_sq"]))
        plans = self.__dict__.setdefault("_sr_adam_plans", {})
        for group, count, leaves in buckets.values():
            s = adam_scalars(group["lr"], group["betas"], group["eps"], count,
                             count * _SALT_STEP,
                             0 if master_salt is None else master_salt,
                             bf16_mu_product=self.precision == "bf16")
            update_leaves(leaves, s, plans)
        return loss

    def load_state_dict(self, state_dict) -> None:
        """Load torch.optim.Adam's or this class's state; the moments are
        cast from the stored tensors to this optimizer's dtypes (torch's
        own load casts them to the parameter's dtype first, which would
        round f32 moments of a bf16 parameter)."""
        saved = state_dict["state"]
        super().load_state_dict(state_dict)
        self.__dict__.get("_sr_adam_plans", {}).clear()
        ids = [i for g in state_dict["param_groups"] for i in g["params"]]
        for i, (_, p) in zip(ids, self._leaves()):
            if i not in saved:
                continue
            mu_dtype, nu_dtype = state_dtypes(p, self.precision)
            state = self.state[p]
            state["step"] = torch.tensor(float(saved[i]["step"]))
            state["exp_avg"] = saved[i]["exp_avg"].to(p.device, mu_dtype)
            state["exp_avg_sq"] = saved[i]["exp_avg_sq"].to(p.device,
                                                            nu_dtype)
