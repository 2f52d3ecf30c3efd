"""The fused Adam update with stochastic rounding (csrc/sr_adam.cu).

`sr_adam_multi_cuda(leaves, s, plans)` updates every leaf of `leaves`
(SrLeaf: index, p, g, mu, nu) and its two moments in place on the card, in
one launch per table of at most `max_leaves()` leaves: Adam in f32 with the
scalars of `s` (parallel/optimizer.AdamScalars), mu stored
round-to-nearest, a bf16 nu and a bf16 p stochastically rounded; with
s.bf16_mu_product (the 'bf16' state mode) the launch's flag picks the
kernel that forms mu in optax's bf16-mu order. Leaf i
takes the salts `leaf_salts(s, i)`: s.nu_salt + i and s.master_salt + i in
uint32. Its plain version is parallel/optimizer.sr_adam_multi_plain,
bit-exact with it; parallel/optimizer.update_leaves picks the one for the
tensors' device. Each launch adds one to `sr_adam_multi_cuda.launches`.

The launch plan of a leaf layout (its tables and their chunk maps on the
device) is built once and kept in `plans`, the caller's dict; the static
tensors (p, mu, nu) are checked then, the gradients on every call.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from svbrdf_tpu_torch.ops import _build

SOURCE = "sr_adam"
STORAGE_DTYPES = (torch.float32, torch.bfloat16)
VEC = 8  # elements of one 16-byte vector step (bf16; two float4 for f32)
CHUNK = 8192  # elements one block updates; a multiple of VEC
ALIGNED = 16  # the dtype code's bit: all four pointers 16-byte aligned
MAX_PLANS = 8  # layouts kept per plans dict
_MASK32 = 0xFFFFFFFF
_FN = {}


class SrLeaf(NamedTuple):
    """One parameter tensor of an update: its position over all the
    optimizer's parameters (the salts' offset), the parameter, its
    gradient and its two moments."""

    index: int
    p: torch.Tensor
    g: torch.Tensor
    mu: torch.Tensor
    nu: torch.Tensor


def leaf_salts(s, index: int) -> tuple:
    """(moment salt, master salt) of leaf `index` under the bases of `s`:
    each base + index, modulo 2^32, as the kernel adds them in uint32."""
    return ((s.nu_salt + index) & _MASK32, (s.master_salt + index) & _MASK32)


def chunk_map(sizes, chunk: int = CHUNK) -> np.ndarray:
    """(entry, first element, length) int64 rows cutting leaves of `sizes`
    elements, entry by entry, into chunks of at most `chunk` elements, each
    starting at a multiple of `chunk` (so of VEC). An empty leaf has none."""
    if chunk <= 0 or chunk % VEC:
        raise ValueError(f"chunk must be a positive multiple of {VEC}")
    rows = [np.zeros((0, 3), np.int64)]
    for entry, n in enumerate(sizes):
        first = np.arange(0, int(n), chunk, dtype=np.int64)
        rows.append(np.stack([np.full_like(first, entry), first,
                              np.minimum(chunk, int(n) - first)], axis=1))
    return np.concatenate(rows)


def split_tables(n_leaves: int, capacity: int) -> list:
    """Consecutive ranges of at most `capacity` leaves, one per launch."""
    return [range(k, min(k + capacity, n_leaves))
            for k in range(0, n_leaves, capacity)]


def dtype_code(p, g, mu, nu) -> int:
    """The kernel's dtype code: bit k set where the k-th of (p, g, mu, nu)
    holds bf16 (a tensor given as None sets no bit)."""
    return sum(1 << k for k, t in enumerate((p, g, mu, nu))
               if t is not None and t.dtype == torch.bfloat16)


def pack_records(words: np.ndarray, static: np.ndarray, ptrs: list,
                 g_bf16: list) -> None:
    """Fill the (n, 5) uint64 records of csrc/sr_adam.cu's Leaf in place:
    the p, g, mu and nu pointers (`ptrs`, four a leaf) and word 4, the
    dtype code in its low half and the leaf index in its high half:
    `static` (p, mu and nu's bits | index << 32) with g's bf16 bit and the
    ALIGNED bit where all four pointers are 16-byte aligned."""
    words[:, :4] = np.array(ptrs, np.uint64).reshape(-1, 4)
    aligned = (words[:, :4] % 16 == 0).all(axis=1)
    words[:, 4] = (static | np.array(g_bf16, np.uint64) << np.uint64(1)
                   | aligned.astype(np.uint64) * np.uint64(ALIGNED))


def _kernel():
    """The C entries, the library built and loaded at first use."""
    if not _FN:
        lib = _build.load(SOURCE)
        fn = lib.svbrdf_sr_adam_multi
        # leaves, n_leaves, chunks, n_chunks; two salt bases; eight floats;
        # the bf16-mu flag; stream
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                        ctypes.c_longlong] + [ctypes.c_uint] * 2
                       + [ctypes.c_float] * 8
                       + [ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.svbrdf_sr_adam_max_leaves.restype = ctypes.c_int
        _FN["multi"] = fn
        _FN["max_leaves"] = lib.svbrdf_sr_adam_max_leaves()
    return _FN["multi"]


def max_leaves() -> int:
    """The leaves one launch's table holds (builds the library)."""
    _kernel()
    return _FN["max_leaves"]


def layout_key(leaves) -> tuple:
    """What a launch plan depends on: each leaf's index, parameter (its
    identity, dtype and shape) and moments (their identity; a plan keeps
    them alive, so an identity is not reused while it is cached)."""
    return tuple((lf.index, id(lf.p), lf.p.dtype, lf.p.shape, id(lf.mu),
                  id(lf.nu)) for lf in leaves)


class _Table(NamedTuple):
    positions: range  # the leaves of this launch, in the caller's list
    words: np.ndarray  # (n, 5) uint64: the packed csrc Leaf records
    static: np.ndarray  # (n,) uint64: code bits of p, mu, nu | index << 32
    chunks: torch.Tensor  # (n_chunks, 3) int64 on the device
    n_chunks: int


class _Plan:
    """The launches of one leaf layout: the static tensors checked, each
    table's chunk map on the device, the packed records reused."""

    def __init__(self, leaves):
        # Held so that layout_key's identities stay unique while cached.
        self.tensors = [(lf.p, lf.mu, lf.nu) for lf in leaves]
        self.device = leaves[0].p.device
        for lf in leaves:
            for name, t in (("p", lf.p), ("mu", lf.mu), ("nu", lf.nu)):
                _check_tensor(name, t, lf.p, self.device)
        self.tables = []
        for positions in split_tables(len(leaves), max_leaves()):
            part = [leaves[k] for k in positions]
            chunks = chunk_map([lf.p.numel() for lf in part], CHUNK)
            words = np.zeros((len(part), 5), np.uint64)
            static = np.array(
                [dtype_code(lf.p, None, lf.mu, lf.nu)
                 | (lf.index & _MASK32) << 32 for lf in part], np.uint64)
            self.tables.append(_Table(
                positions, words, static,
                torch.from_numpy(chunks).to(self.device), len(chunks)))

    def launch(self, leaves, s) -> None:
        fn = _kernel()
        index = self.device.index
        stream = torch.cuda.current_stream(self.device).cuda_stream
        for table in self.tables:
            ptrs, g_bf16 = [], []
            for k in table.positions:
                lf = leaves[k]
                g = lf.g
                if (not g.is_cuda or g.get_device() != index
                        or g.shape != lf.p.shape or not g.is_contiguous()
                        or g.dtype not in STORAGE_DTYPES):
                    _check_tensor("g", g, lf.p, self.device)
                ptrs += (lf.p.data_ptr(), g.data_ptr(), lf.mu.data_ptr(),
                         lf.nu.data_ptr())
                g_bf16.append(g.dtype == torch.bfloat16)
            words = table.words
            pack_records(words, table.static, ptrs, g_bf16)
            with torch.cuda.device(self.device):
                rc = fn(words.ctypes.data, len(words),
                        table.chunks.data_ptr(), table.n_chunks,
                        s.nu_salt & _MASK32, s.master_salt & _MASK32, s.b1,
                        s.omb1, s.b2, s.omb2, s.bc1, s.bc2, s.eps, s.neg_lr,
                        int(s.bf16_mu_product), stream)
            if rc != 0:
                raise RuntimeError(f"sr_adam kernel launch failed: CUDA "
                                   f"error {rc}")
            if table.n_chunks:
                sr_adam_multi_cuda.launches += 1


def _check_tensor(name: str, t: torch.Tensor, p: torch.Tensor,
                  device: torch.device) -> None:
    if t.device != device or device.type != "cuda":
        raise RuntimeError(f"the sr_adam kernel needs CUDA tensors on one "
                           f"device, {name} is on {t.device}")
    if t.dtype not in STORAGE_DTYPES:
        raise TypeError(f"{name} must be float32 or bfloat16, got {t.dtype}")
    if t.shape != p.shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, p "
                         f"{tuple(p.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


@torch.no_grad()
def sr_adam_multi_cuda(leaves, s, plans=None) -> None:
    """Launch the fused update of every leaf (SrLeaf) on the current
    stream: one launch per table of max_leaves() leaves. `plans` (a dict
    the caller keeps from step to step) caches the launch plan of each
    leaf layout; without it the plan is built for this call."""
    if not leaves:
        return
    key = layout_key(leaves) if plans is not None else None
    plan = plans.get(key) if plans is not None else None
    if plan is None:
        plan = _Plan(leaves)
        if plans is not None:
            if len(plans) >= MAX_PLANS:
                plans.clear()
            plans[key] = plan
    plan.launch(leaves, s)


sr_adam_multi_cuda.launches = 0


def sr_adam_update_cuda(p: torch.Tensor, g: torch.Tensor, mu: torch.Tensor,
                        nu: torch.Tensor, s) -> None:
    """One leaf's update with the salts of `s` as they are: a one-entry
    table (leaf index 0)."""
    sr_adam_multi_cuda([SrLeaf(0, p, g, mu, nu)], s)
