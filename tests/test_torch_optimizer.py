"""The port's reduced-precision Adam (svbrdf_tpu_torch/parallel/optimizer.py)
against the JAX package's (svbrdf_tpu/parallel/optimizer.py), on the CPU,
where AdamBf16SR runs its plain version (the card's kernel is held to that
in tests/test_torch_card.py).

Tolerances: the dither and the stochastic rounding are bit-equal to JAX's
on the same flat arrays and salts (uint32 arithmetic, no rounding). An
Adam trace on one (32, 32) bf16 master leaf with the same salts on both
sides: the master, mu and nu equal in >= 99.9 % of the elements and the
rest within one bf16 ulp (the bias correction's f32 power may differ from
XLA's in its last bit, and SR turns a last-bit difference into a
neighbouring bf16 value where the dither's cut falls between); an f32 leaf
within rtol 1e-6 of JAX's adam_bf16sr and, against f32 Adam, the JAX
test's rtol 2e-2 / atol 2e-4. The rest are ports of
tests/test_optimizer.py with its tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from svbrdf_tpu.parallel import optimizer as jopt
from svbrdf_tpu_torch.parallel import optimizer as opt
from svbrdf_tpu_torch.parallel import step as step_lib

torch.set_num_threads(1)

BF16 = torch.bfloat16


def _wrap_int32(x: int) -> int:
    """x as JAX's int32 arithmetic leaves it (two's complement)."""
    x &= 0xFFFFFFFF
    return x - (1 << 32) if x >= 1 << 31 else x


# Salts: 0, 1, the largest master salt, and int32 products that wrap: the
# moment salt count * 1000003 + i past count 2147, and a master salt + i.
SALTS = [0, 1, 2 ** 31 - 2, _wrap_int32(2148 * 1000003),
         _wrap_int32(5000 * 1000003 + 7), _wrap_int32(2 ** 31 - 2 + 5)]


def _values(n=4099, seed=0):
    """Normals over many magnitudes and both signs, with zeros and exact
    bf16 values."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, n) * 10.0 ** rng.integers(-30, 30, n)
    x[:5] = [0.0, -0.0, 1.0, -2.5, 0.00390625]
    return x.astype(np.float32)


@pytest.mark.parametrize("salt", SALTS)
def test_dither_and_sr_bit_equal_to_jax(salt):
    assert min(SALTS) < 0  # the wrapped salts are negative int32
    x = _values()
    jbits = np.asarray(jopt._dither_bits(x.shape, jnp.int32(salt)))
    np.testing.assert_array_equal(opt.dither_bits(x.shape, salt).numpy(),
                                  jbits.astype(np.int64))
    ref = np.asarray(jopt.sr_bf16(jnp.asarray(x), jnp.int32(salt)))
    mine = opt.sr_bf16(torch.from_numpy(x), salt)
    assert mine.dtype == BF16
    np.testing.assert_array_equal(
        mine.view(torch.int16).numpy(), ref.view(np.int16))


def test_sr_bf16_unbiased():
    """The mean over 400 salts recovers the f32 value (rtol 1e-3; round to
    nearest would be off by up to half a bf16 step, ~0.2 %)."""
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        1e-8, 1e-4, (64,)).astype(np.float32))
    acc = torch.zeros(64, dtype=torch.float64)
    for s in range(400):
        acc += opt.sr_bf16(x, s).double()
    np.testing.assert_allclose((acc / 400).numpy(), x.double().numpy(),
                               rtol=1e-3)


def test_sr_bf16_rounds_to_neighbours():
    """Every SR output is one of the two bf16 values around the input."""
    x = torch.tensor([1.2345e-3, 7.7e2, 3.3e-6])
    for s in range(50):
        out = opt.sr_bf16(x, s).double()
        assert bool(((out - x.double()).abs()
                     <= x.double().abs() * 2 ** -7).all())


def test_ema_tracks_where_bf16_stalls():
    """nu follows a constant-gradient EMA to within 5 % under SR; with
    round-to-nearest bf16 storage it stalls below 80 % of it."""
    g, beta2, steps = 0.1, 0.999, 3000
    nu_sr = torch.zeros(128, dtype=BF16)
    nu_rn = torch.zeros(128, dtype=BF16)
    for s in range(steps):
        nu_sr = opt.sr_bf16(nu_sr.float() * beta2 + (1 - beta2) * g * g, s)
        nu_rn = (nu_rn.float() * beta2 + (1 - beta2) * g * g).to(BF16)
    target = g * g * (1 - beta2 ** steps)
    np.testing.assert_allclose(float(nu_sr.float().mean()), target,
                               rtol=0.05)
    assert float(nu_rn.float().mean()) < 0.8 * target


def _trace(n_steps=20):
    rng = np.random.default_rng(1)
    w = rng.normal(0, 1, (32, 32)).astype(np.float32)
    grads = [rng.normal(0, 0.1, (32, 32)).astype(np.float32)
             for _ in range(n_steps)]
    return w, grads


def _one_ulp_apart(a, b):
    """|a - b| within one bf16 ulp of the larger magnitude."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    ulp = np.maximum(np.abs(a), np.abs(b)) * 2.0 ** -7
    return np.abs(a - b) <= ulp


def test_adam_trace_matches_jax_adam_bf16sr():
    """20 steps of one (32, 32) bf16 master leaf (bf16 moments) against
    JAX's adam_bf16sr and the JAX step's sr_bf16(p + u, salt + i), with the
    same salts: the master and both moments equal in >= 99.9 % of the
    elements, the rest one bf16 ulp apart (the bias corrections' f32 power
    may differ in its last bit, _bias_correction)."""
    w, grads = _trace()
    salts = [7919 * k + 3 for k in range(len(grads))]
    jp = {"w": jnp.asarray(w).astype(jnp.bfloat16)}
    tx = jopt.adam_bf16sr(1e-3)
    js = tx.init(jp)
    for g, salt in zip(grads, salts):
        u, js = tx.update({"w": jnp.asarray(g).astype(jnp.bfloat16)}, js)
        jp = {"w": jopt.sr_bf16(jp["w"].astype(jnp.float32) + u["w"],
                                jnp.int32(salt))}

    p = torch.nn.Parameter(torch.from_numpy(w).to(BF16))
    optimizer = opt.AdamBf16SR([p], lr=1e-3)
    for g, salt in zip(grads, salts):
        p.grad = torch.from_numpy(g).to(BF16)
        optimizer.step(master_salt=salt)
    state = optimizer.state[p]
    assert p.dtype == state["exp_avg"].dtype == state["exp_avg_sq"].dtype \
        == BF16
    for mine, ref in ((p.detach(), jp["w"]), (state["exp_avg"], js[0].mu["w"]),
                      (state["exp_avg_sq"], js[0].nu["w"])):
        mine = mine.float().numpy()
        ref = np.asarray(ref, np.float32)
        assert np.mean(mine == ref) >= 0.999
        assert _one_ulp_apart(mine, ref).all()


def test_f32_leaf_trace_matches_jax():
    """20 steps of an f32 leaf: against JAX's adam_bf16sr within rtol 1e-6
    (the f32 parameters take p + u, where a last-bit difference of the bias
    correction shows), and against f32 optax.adam at the JAX test's rtol
    2e-2 / atol 2e-4."""
    w, grads = _trace()
    jparams = {"w": jnp.asarray(w)}
    results = []
    for tx in (jopt.adam_bf16sr(1e-3), optax.adam(1e-3)):
        state, jp = tx.init(jparams), jparams
        for g in grads:
            u, state = tx.update({"w": jnp.asarray(g)}, state)
            jp = optax.apply_updates(jp, u)
        results.append(np.asarray(jp["w"]))
    p = torch.nn.Parameter(torch.from_numpy(w.copy()))
    optimizer = opt.AdamBf16SR([p], lr=1e-3)
    for g in grads:
        p.grad = torch.from_numpy(g)
        optimizer.step()
    np.testing.assert_allclose(p.detach().numpy(), results[0], rtol=1e-6)
    np.testing.assert_allclose(p.detach().numpy(), results[1], rtol=2e-2,
                               atol=2e-4)


def test_bf16_master_update_matches_jax():
    """One step of a bf16 master leaf: the JAX step's sr_bf16(p + u, salt +
    i) after adam_bf16sr, with the same master salt; bit-equal."""
    w, grads = _trace(1)
    salt = 2 ** 31 - 10  # salt + i wraps past int32 for leaf i >= 10
    p32 = jnp.asarray(w).astype(jnp.bfloat16)
    tx = jopt.adam_bf16sr(1e-5)
    u, _ = tx.update({"w": jnp.asarray(grads[0]).astype(jnp.bfloat16)},
                     tx.init({"w": p32}))
    i = 11
    ref = jopt.sr_bf16(p32.astype(jnp.float32) + u["w"],
                       jnp.int32(salt) + jnp.int32(i))

    params = [torch.nn.Parameter(torch.zeros(2)) for _ in range(i)]
    p = torch.nn.Parameter(torch.from_numpy(w).to(BF16))
    p.grad = torch.from_numpy(grads[0]).to(BF16)
    optimizer = opt.AdamBf16SR(params + [p], lr=1e-5)
    # Leaf i = 11 takes moment salt 1000003 + 11 here and 1000003 + 0 in
    # the one-leaf JAX tree; its nu does not enter this step's p.
    optimizer.step(master_salt=salt)
    assert p.dtype == BF16
    np.testing.assert_array_equal(p.detach().view(torch.int16).numpy(),
                                  np.asarray(ref).view(np.int16))
    with pytest.raises(ValueError, match="master_salt"):
        optimizer.step()


def test_state_structure_matches_torch_adam():
    """AdamBf16SR's state has torch.optim.Adam's keys and step, in the
    dtypes of its precision."""
    def states(optimizer, p):
        p.grad = torch.full_like(p, 0.01)
        optimizer.step()
        return optimizer.state[p]

    p = torch.nn.Parameter(torch.ones(4, 4))
    ref = states(torch.optim.Adam([p], lr=1e-3), p)
    mine = states(opt.AdamBf16SR([p], lr=1e-3), p)
    assert set(mine) == set(ref)
    assert float(mine["step"]) == float(ref["step"]) == 1.0
    assert mine["step"].device.type == "cpu"
    assert (mine["exp_avg"].dtype, mine["exp_avg_sq"].dtype) == (BF16, BF16)
    bf16 = states(opt.AdamBf16SR([p], lr=1e-3, precision="bf16"), p)
    assert (bf16["exp_avg"].dtype, bf16["exp_avg_sq"].dtype) == (
        BF16, torch.float32)
    with pytest.raises(ValueError, match="precision"):
        opt.AdamBf16SR([p], precision="fp8")


def test_one_d_leaves_keep_f32_moments():
    w = torch.nn.Parameter(torch.ones(4, 4))
    b = torch.nn.Parameter(torch.ones(4))
    optimizer = opt.AdamBf16SR([w, b], lr=1e-3)
    for p in (w, b):
        p.grad = torch.full_like(p, 1e-3)
    optimizer.step()
    assert optimizer.state[w]["exp_avg_sq"].dtype == BF16
    assert optimizer.state[b]["exp_avg"].dtype == torch.float32
    assert optimizer.state[b]["exp_avg_sq"].dtype == torch.float32
    # The 1-D nu update is exact f32, no SR noise.
    np.testing.assert_allclose(optimizer.state[b]["exp_avg_sq"].numpy(),
                               1e-6 * (1 - 0.999) * np.ones(4), rtol=1e-6)


def test_make_optimizer_selection(monkeypatch):
    p = [torch.nn.Parameter(torch.ones(4, 4))]
    assert type(step_lib.make_optimizer(p, 1e-5)) is torch.optim.Adam
    assert type(step_lib.make_optimizer(p, 1e-5, torch.float32,
                                        "auto")) is torch.optim.Adam
    sr = step_lib.make_optimizer(p, 1e-5, torch.bfloat16)
    assert isinstance(sr, opt.AdamBf16SR) and sr.precision == "bf16sr"
    assert step_lib.make_optimizer(p, 1e-5, torch.bfloat16,
                                   "bf16").precision == "bf16"
    monkeypatch.setenv("SVBRDF_OPT_STATE", "bf16sr")
    assert isinstance(step_lib.make_optimizer(p, 1e-5), opt.AdamBf16SR)
    p[0].grad = torch.full((4, 4), 0.01)
    sr.step()
    assert torch.isfinite(p[0]).all()


@pytest.mark.parametrize("direction", ["adam_to_sr", "sr_to_adam"])
def test_state_dict_crosses_torch_adam(direction):
    """A torch.optim.Adam state loads into AdamBf16SR with its moments cast
    to bf16 (>=2-D) from the stored f32, and the reverse into f32; the
    step count carries over."""
    def make(kind, params):
        return (torch.optim.Adam(params, lr=1e-3) if kind == "adam"
                else opt.AdamBf16SR(params, lr=1e-3))

    src_kind, dst_kind = direction.split("_to_")
    w = torch.nn.Parameter(torch.ones(4, 4))
    b = torch.nn.Parameter(torch.ones(4))
    src = make(src_kind, [w, b])
    for _ in range(3):
        for p in (w, b):
            p.grad = torch.randn(p.shape, generator=torch.Generator()
                                 .manual_seed(p.dim()))
        src.step()
    dst = make(dst_kind, [w, b])
    dst.load_state_dict(src.state_dict())
    for p in (w, b):
        for key in ("exp_avg", "exp_avg_sq"):
            want = (BF16 if dst_kind == "sr" and p.dim() >= 2
                    else torch.float32)
            got = dst.state[p][key]
            assert got.dtype == want
            assert torch.equal(got, src.state[p][key].to(want))
        assert float(dst.state[p]["step"]) == 3.0
    for p in (w, b):
        p.grad = torch.full_like(p, 0.01)
    dst.step()
    assert float(dst.state[w]["step"]) == 4.0
