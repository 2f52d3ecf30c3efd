"""The multi-tensor SR-Adam step (svbrdf_tpu_torch/ops/sr_adam.py and
parallel/optimizer.py) on the CPU: the launch plan's pure parts (chunk map,
tables, salts, packed records), and the bucketed AdamBf16SR.step against
the per-leaf loop it replaced (one adam_update_plain per leaf with the
host's salts u32(count * 1000003 + i) and u32(master_salt + i)), bit for
bit. The kernel itself is held to the plain version on the card
(tests/test_torch_card.py).
"""

import itertools

import numpy as np
import pytest
import torch

from svbrdf_tpu_torch.models import SingleViewModel
from svbrdf_tpu_torch.ops import sr_adam
from svbrdf_tpu_torch.parallel import optimizer as opt

torch.set_num_threads(1)

BF16 = torch.bfloat16
F32 = torch.float32


def _model_sizes():
    model = SingleViewModel(8, 5, device="cpu", seed=0)
    return [p.numel() for p in model.parameters()]


@pytest.mark.parametrize("sizes, chunk", [
    ((1,), sr_adam.CHUNK), ((7,), sr_adam.CHUNK), ((9,), sr_adam.CHUNK),
    ((8, 16, 3, 5, 2, 6, 4), 8), ((81, 162, 9, 0, 64), 16),
    ((0,), sr_adam.CHUNK), ((), sr_adam.CHUNK),
    ((sr_adam.CHUNK - 1, sr_adam.CHUNK, sr_adam.CHUNK + 7), sr_adam.CHUNK),
    ((2 ** 23 + 5, 9), sr_adam.CHUNK), ("depth-5 model", sr_adam.CHUNK),
])
def test_chunk_map_covers_each_element_once(sizes, chunk):
    """Every element of every leaf in exactly one chunk, entries in order,
    chunk starts multiples of 8 (and of the chunk), lengths in (0, chunk];
    tails of 1-7 elements, a 1-D leaf, (9, 9) and (9, 18) leaves, an empty
    leaf (no chunk) and a leaf above 2^23 elements."""
    if sizes == "depth-5 model":
        sizes = _model_sizes()
    rows = sr_adam.chunk_map(sizes, chunk)
    assert rows.dtype == np.int64 and rows.shape == (len(rows), 3)
    assert (np.diff(rows[:, 0]) >= 0).all()
    assert (rows[:, 1] % 8 == 0).all() and (rows[:, 1] % chunk == 0).all()
    assert ((rows[:, 2] > 0) & (rows[:, 2] <= chunk)).all()
    for entry, n in enumerate(sizes):
        mine = rows[rows[:, 0] == entry]
        covered = np.zeros(n, np.int64)
        for _, first, length in mine:
            covered[first:first + length] += 1
        assert (covered == 1).all()
        assert int(mine[:, 2].sum()) == n


def test_chunk_map_rejects_unaligned_chunks():
    with pytest.raises(ValueError, match="multiple of 8"):
        sr_adam.chunk_map([16], 12)


@pytest.mark.parametrize("n_leaves, capacity", [
    (0, 256), (1, 256), (95, 256), (114, 256), (256, 256), (257, 256),
    (600, 80)])
def test_split_tables_in_order(n_leaves, capacity):
    tables = sr_adam.split_tables(n_leaves, capacity)
    assert [k for t in tables for k in t] == list(range(n_leaves))
    assert all(0 < len(t) <= capacity for t in tables)
    assert len(tables) == -(-n_leaves // capacity)


# Counts past 2147 wrap JAX's int32 count * 1000003; master salts near 2^31
# and 2^32 wrap with the leaf index.
@pytest.mark.parametrize("count, master_salt", [
    (1, 0), (2147, 2 ** 31 - 2), (2148, 2 ** 31 - 1), (4294, 2 ** 32 - 3),
    (5000, 123456789), (10 ** 6, -5)])
def test_leaf_salts_equal_the_host_salts(count, master_salt):
    """The kernel's nu_base + i and master_salt + i (uint32) are the
    per-leaf loop's u32(count * 1000003 + i) and u32(master_salt + i)."""
    s = opt.adam_scalars(1e-5, (0.9, 0.999), 1e-8, count,
                         count * opt._SALT_STEP, master_salt)
    for i in (0, 1, 2, 94, 113, 2 ** 20):
        assert sr_adam.leaf_salts(s, i) == (
            opt.u32(count * opt._SALT_STEP + i), opt.u32(master_salt + i))


@pytest.mark.parametrize("flags", list(itertools.product((0, 1), repeat=4)),
                         ids=lambda f: "".join(map(str, f)))
def test_dtype_code_bits(flags):
    """Bit k of the code is the k-th of (p, g, mu, nu) in bf16, as the
    kernel's dispatch reads it (16 combinations)."""
    tensors = [torch.zeros(2, dtype=BF16 if f else F32) for f in flags]
    assert sr_adam.dtype_code(*tensors) == sum(f << k for k, f in
                                               enumerate(flags))


def test_pack_records_layout():
    """Five uint64 words a leaf (csrc Leaf): four pointers, and the code
    (low half: the static bits, g's bf16 bit, the aligned bit) with the
    leaf index in the high half; one pointer off 16 bytes clears the
    aligned bit."""
    words = np.zeros((3, 5), np.uint64)
    static = np.array([0b1101 | 7 << 32, 0 | 95 << 32, 0b0100 | 2 ** 31 << 32],
                      np.uint64)
    base = 0x7F0000000000
    ptrs = [base, base + 0x100, base + 0x200, base + 0x300,
            base, base + 0x100, base + 0x208, base + 0x300,
            base + 2, base + 0x10, base + 0x20, base + 0x30]
    sr_adam.pack_records(words, static, ptrs, [True, False, False])
    assert words[:, :4].tolist() == np.array(ptrs).reshape(3, 4).tolist()
    code = (words[:, 4] & np.uint64(0xFFFFFFFF)).tolist()
    index = (words[:, 4] >> np.uint64(32)).tolist()
    assert code == [0b1111 | sr_adam.ALIGNED, 0, 0b0100]
    assert index == [7, 95, 2 ** 31]
    assert words.flags["C_CONTIGUOUS"] and words.itemsize * 5 == 40


def test_cuda_wrapper_raises_on_cpu_tensors():
    """A CPU tensor never reaches the kernel's wrapper quietly."""
    t = torch.zeros(4)
    s = opt.adam_scalars(1e-3, (0.9, 0.999), 1e-8, 1, 0)
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        sr_adam.sr_adam_multi_cuda([sr_adam.SrLeaf(0, t, t, t, t)], s)


def _leaf_dtypes(shape, precision):
    """(p, g, mu, nu) dtypes of a leaf on the bf16 main path: bf16 masters
    and gradients for >=2-D leaves under 'bf16sr', f32 elsewhere."""
    p = torch.empty(shape)
    bf16_master = precision == "bf16sr" and len(shape) >= 2
    master = BF16 if bf16_master else F32
    return (master, master) + opt.state_dtypes(p, precision)


def _random_leaves(shapes, precision, seed):
    rng = np.random.default_rng(seed)
    leaves = []
    for shape in shapes:
        dts = _leaf_dtypes(shape, precision)
        vals = [rng.normal(0, sc, shape) for sc in (0.02, 1e-3, 1e-4)]
        vals.append(rng.uniform(0, 1e-6, shape))
        leaves.append([torch.from_numpy(v.astype(np.float32)).to(dt)
                       for v, dt in zip(vals, dts)])
    return leaves


def _leaf_loop(leaves, count, master_salt, lr=1e-5):
    """The per-leaf loop that the multi-tensor step replaced."""
    s = opt.adam_scalars(lr, (0.9, 0.999), 1e-8, count, 0)
    for i, leaf in leaves:
        opt.adam_update_plain(*leaf, s._replace(
            nu_salt=opt.u32(count * opt._SALT_STEP + i),
            master_salt=opt.u32(master_salt + i)))


@pytest.mark.parametrize("precision", opt.PRECISIONS)
def test_multi_plain_bit_equal_to_the_leaf_loop(precision):
    """sr_adam_multi_plain over a depth-5 model's leaves (salts past the
    int32 wrap, indices with a gap) equals the per-leaf loop to the bit."""
    model = SingleViewModel(8, 5, device="cpu", seed=0)
    shapes = [tuple(p.shape) for p in model.parameters()]
    leaves = _random_leaves(shapes, precision, seed=1)
    index = [i + (i >= 3) for i in range(len(leaves))]  # leaf 3 not stepped
    count, master_salt = 2148, 2 ** 31 - 10
    mine = [[t.clone() for t in leaf] for leaf in leaves]
    ref = [[t.clone() for t in leaf] for leaf in leaves]
    s = opt.adam_scalars(1e-5, (0.9, 0.999), 1e-8, count,
                         count * opt._SALT_STEP, master_salt)
    opt.sr_adam_multi_plain([sr_adam.SrLeaf(i, *leaf)
                             for i, leaf in zip(index, mine)], s)
    _leaf_loop(list(zip(index, ref)), count, master_salt)
    for a, b in zip(mine, ref):
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and torch.equal(x, y)
    assert any(not torch.equal(a[0], b[0]) for a, b in zip(mine, leaves))


class _LeafLoopAdamBf16SR(opt.AdamBf16SR):
    """AdamBf16SR with the step it had before the multi-tensor one: one
    update per leaf, each count incremented and read on its own (the
    'bf16' state mode in optax's bf16-mu order, as the step forms it)."""

    @torch.no_grad()
    def step(self, closure=None, master_salt=None):
        for i, (group, p) in enumerate(self._leaves()):
            if p.grad is None:
                continue
            state = self.state[p] or self._init_state(p)
            state["step"] += 1
            count = int(state["step"])
            s = opt.adam_scalars(group["lr"], group["betas"], group["eps"],
                                 count, 0, bf16_mu_product=(
                                     self.precision == "bf16"))._replace(
                nu_salt=opt.u32(count * opt._SALT_STEP + i),
                master_salt=opt.u32(0 if master_salt is None
                                    else master_salt + i))
            opt.adam_update_plain(p, p.grad, state["exp_avg"],
                                  state["exp_avg_sq"], s)


def _params(precision, seed):
    """A depth-5 model's parameter shapes as leaves in two param groups,
    with bf16 >=2-D masters under 'bf16sr'."""
    model = SingleViewModel(8, 5, device="cpu", seed=0)
    shapes = [tuple(p.shape) for p in model.parameters()]
    leaves = _random_leaves(shapes, precision, seed)
    return [torch.nn.Parameter(leaf[0]) for leaf in leaves]


def _grads(params, seed):
    rng = np.random.default_rng(seed)
    return [None if k % 7 == 3 else torch.from_numpy(
        rng.normal(0, 1e-3, tuple(p.shape)).astype(np.float32)).to(p.dtype)
            for k, p in enumerate(params)]


@pytest.mark.parametrize("precision", opt.PRECISIONS)
def test_step_bit_equal_to_the_leaf_loop(precision):
    """Three AdamBf16SR steps over two param groups, with leaves that have
    no gradient (they keep their index for the leaves after them) and a
    load_state_dict after the first step of a state whose counts differ
    between leaves (so the step has several buckets): parameters, moments
    and counts equal to the per-leaf loop's, to the bit."""
    runs = []
    for cls in (opt.AdamBf16SR, _LeafLoopAdamBf16SR):
        params = _params(precision, seed=2)
        half = len(params) // 2
        optimizer = cls([{"params": params[:half]},
                         {"params": params[half:], "lr": 3e-5}], lr=1e-5,
                        precision=precision)
        for step in range(3):
            for p, g in zip(params, _grads(params, seed=10 + step)):
                p.grad = g
            optimizer.step(master_salt=2 ** 31 - 2 + step)
            if step == 0:
                state = optimizer.state_dict()
                for k, entry in state["state"].items():
                    entry["step"] = torch.tensor(float(1 + k % 3 * 1073))
                optimizer = cls([{"params": params[:half]},
                                 {"params": params[half:], "lr": 3e-5}],
                                lr=1e-5, precision=precision)
                optimizer.load_state_dict(state)
        runs.append((params, optimizer))
    (mine, mine_opt), (ref, ref_opt) = runs
    for p, q in zip(mine, ref):
        assert p.dtype == q.dtype and torch.equal(p, q)
        a, b = mine_opt.state[p], ref_opt.state[q]
        assert set(a) == set(b)
        if not b:
            continue
        assert float(a["step"]) == float(b["step"])
        for key in ("exp_avg", "exp_avg_sq"):
            assert a[key].dtype == b[key].dtype
            assert torch.equal(a[key], b[key])


def test_step_launches_one_update_per_bucket(monkeypatch):
    """One bucket when every leaf shares its group and count; a leaf with
    another count, or another param group, makes another."""
    calls = []
    real = opt.update_leaves

    def spy(leaves, s, plans=None):
        calls.append([lf.index for lf in leaves])
        real(leaves, s, plans)

    monkeypatch.setattr(opt, "update_leaves", spy)
    ps = [torch.nn.Parameter(torch.ones(4, 4)) for _ in range(3)]
    optimizer = opt.AdamBf16SR(ps, lr=1e-3)
    for p in ps:
        p.grad = torch.full_like(p, 1e-3)
    optimizer.step()
    assert calls == [[0, 1, 2]]
    optimizer.state[ps[1]]["step"] = torch.tensor(7.0)
    calls.clear()
    optimizer.step()
    assert sorted(calls) == [[0, 2], [1]]
    two = opt.AdamBf16SR([{"params": ps[:1]}, {"params": ps[1:]}], lr=1e-3)
    calls.clear()
    two.step()
    assert calls == [[0], [1, 2]]
