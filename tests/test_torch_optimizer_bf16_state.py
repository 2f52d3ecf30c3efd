"""The 'bf16' optimizer-state mode (SVBRDF_OPT_STATE=bf16) against
optax.adam(mu_dtype=bfloat16), the JAX package's choice for that mode
(svbrdf_tpu/parallel/step.py make_optimizer), on the CPU, where AdamBf16SR
runs its plain version (the card's kernel is held to that in
tests/test_torch_card.py).

Tolerances: mu bit-equal to optax's at every step (optax rounds b1 to bf16,
rounds the product b1 * mu to bf16 and adds (1 - b1) * g in f32, which the
port now does op for op), and nu too; the parameters within rtol 1e-6 and
atol 1e-9: from step 1 on, ~0.1 % of the elements of XLA's update u
differ from the port's in their last bit (its division and square root;
mu, nu and the bias corrections are bit-equal), and where a parameter
passes near 0 that last bit of a 1e-3-sized u (1.2e-10) is more than
1e-6 of the parameter. The other two modes must not change by a bit:
their 10-step traces are pinned by SHA-256 digests of every parameter and
moment after every step, recorded from the tree before the 'bf16' mode's
order was added.
"""

import hashlib

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from svbrdf_tpu_torch.parallel import optimizer as opt
from svbrdf_tpu_torch.parallel import step as step_lib

torch.set_num_threads(1)

STEPS = 10
LR = 1e-3


def _grads(seed=0, shape=(64, 64)):
    rng = np.random.default_rng(seed)
    return [(1e-2 * rng.normal(0, 1, shape)).astype(np.float32)
            for _ in range(STEPS)]


def _optax_trace(p0, grads):
    tx = optax.adam(LR, mu_dtype=jnp.bfloat16)
    params = jnp.asarray(p0)
    state = tx.init(params)
    out = []
    for g in grads:
        updates, state = tx.update(jnp.asarray(g), state, params)
        params = optax.apply_updates(params, updates)
        adam = state[0]
        out.append((np.asarray(params), np.asarray(adam.mu),
                    np.asarray(adam.nu)))
    return out


def _port_trace(p0, grads, precision="bf16"):
    p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    o = opt.AdamBf16SR([p], lr=LR, precision=precision)
    out = []
    for g in grads:
        p.grad = torch.from_numpy(g)
        o.step()
        st = o.state[p]
        out.append((p.detach().clone(), st["exp_avg"].clone(),
                    st["exp_avg_sq"].clone()))
    return out


def test_bf16_state_mu_bit_equal_to_optax():
    """A (64, 64) f32 leaf, numpy seed 0, gradients 1e-2 N(0, 1), lr 1e-3,
    10 steps: mu bf16 and nu f32, both bit-equal to optax's at every step;
    the parameters within rtol 1e-6, atol 1e-9."""
    grads = _grads()
    p0 = np.random.default_rng(1).normal(0, 0.05, (64, 64)).astype(
        np.float32)
    ref = _optax_trace(p0, grads)
    mine = _port_trace(p0, grads)
    for t, ((jp, jmu, jnu), (p, mu, nu)) in enumerate(zip(ref, mine)):
        assert jmu.dtype == jnp.bfloat16 and mu.dtype == torch.bfloat16
        assert nu.dtype == torch.float32
        np.testing.assert_array_equal(mu.view(torch.int16).numpy(),
                                      jmu.view(np.int16),
                                      err_msg=f"mu at step {t + 1}")
        np.testing.assert_array_equal(nu.numpy(), jnu,
                                      err_msg=f"nu at step {t + 1}")
        np.testing.assert_allclose(p.numpy(), jp, rtol=1e-6, atol=1e-9,
                                   err_msg=f"params at step {t + 1}")


def test_bf16_state_product_is_rounded_once():
    """The order itself on one element: mu' = f32(bf16(mu * bf16(b1))) +
    g (1 - b1), against the f32 product the other modes form."""
    mu = torch.tensor([1.0 + 2 ** -7], dtype=torch.bfloat16)
    g = torch.tensor([0.0])
    s = opt.adam_scalars(LR, (0.9, 0.999), 1e-8, 1, 0, 0,
                         bf16_mu_product=True)
    p, nu = torch.zeros(1), torch.zeros(1)
    opt.adam_update_plain(p, g, mu, nu, s)
    b1 = float(torch.tensor(0.9).to(torch.bfloat16))
    assert b1 == 0.8984375
    expected = torch.tensor([(1.0 + 2 ** -7) * b1]).to(torch.bfloat16)
    assert torch.equal(mu, expected)


def test_bf16_state_through_make_optimizer(monkeypatch):
    """SVBRDF_OPT_STATE=bf16 gives the 'bf16' mode, whose steps carry the
    flag of optax's order."""
    monkeypatch.setenv("SVBRDF_OPT_STATE", "bf16")
    p = torch.nn.Parameter(torch.zeros(4, 4))
    o = step_lib.make_optimizer([p], 1e-3, torch.float32)
    assert o.precision == "bf16"
    seen = []
    monkeypatch.setattr(opt, "update_leaves",
                        lambda leaves, s, plans=None: seen.append(s))
    p.grad = torch.ones(4, 4)
    o.step()
    assert seen and seen[0].bf16_mu_product


def _digest(precision: str, master_bf16: bool) -> str:
    rng = np.random.default_rng(0)
    p0 = rng.normal(0, 0.05, (64, 64)).astype(np.float32)
    b0 = rng.normal(0, 0.05, (64,)).astype(np.float32)
    p = torch.nn.Parameter(torch.from_numpy(p0).to(
        torch.bfloat16 if master_bf16 else torch.float32))
    b = torch.nn.Parameter(torch.from_numpy(b0))
    o = opt.AdamBf16SR([p, b], lr=LR, precision=precision)
    h = hashlib.sha256()
    for t in range(STEPS):
        p.grad = torch.from_numpy((1e-2 * rng.normal(0, 1, (64, 64))).astype(
            np.float32)).to(p.dtype)
        b.grad = torch.from_numpy((1e-2 * rng.normal(0, 1, (64,))).astype(
            np.float32))
        o.step(master_salt=1000 + t)
        for x in (p, b):
            st = o.state[x]
            for y in (x.detach(), st["exp_avg"], st["exp_avg_sq"]):
                h.update(y.contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("precision,master_bf16,digest", [
    ("bf16sr", False,
     "4e34daee3da1edc4a1a30480e7eb2203b23cb22579e3522fad303e84e263dc10"),
    ("bf16sr", True,
     "abccd14972a7b56d1622e51ec1d73e8844aab49e6d39539f71e6c4144f6f5392"),
    ("f32", False,
     "ce8f5e7c3aa3964944e604ea9b535b49063b2810fcdc519e6e3c61cce201516f"),
    ("f32", True,
     "056b787af1cd65adcc25f76843eaad2194d6c4ee6b7aeb6685b09122faf5bff1"),
])
def test_other_modes_unchanged_to_the_bit(precision, master_bf16, digest):
    """'bf16sr' (scale_by_adam_bf16sr multiplies in f32) and 'f32', with f32
    and bf16 masters: every parameter and moment after each of 10 steps
    equal to the bits recorded before the 'bf16' mode's order was added."""
    assert _digest(precision, master_bf16) == digest
