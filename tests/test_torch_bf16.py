"""bf16 planes through the fused losses on the CPU: the port's planes
entries and plain versions against the JAX package's entries (Pallas
kernels in interpret mode), as tests/test_render_pallas.py::
test_bf16_planes_match_f32 holds the JAX entries.

Both frameworks load bf16 planes into f32, shade in f32 and round each
gradient once to bf16. Tolerances:
- loss against JAX's on the same bf16 planes rtol 2e-5 (PALLAS_RTOL: the
  same f32 math, summed in another order);
- a bf16 gradient against JAX's bf16 gradient within one bf16 ulp (rtol
  8e-3, atol 1e-6): each is the f32 gradient, which the two frameworks
  hold to rtol 2e-4, rounded once;
- against f32: the bf16 loss within rel 2e-2 of the f32 loss on the
  unquantized inputs, the bf16 gradient within rtol 1e-2 / atol 1e-5 of
  the f32 gradient on the bf16-quantized inputs (the JAX test's).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svbrdf_tpu.ops import render_pallas
from svbrdf_tpu_torch import losses
from svbrdf_tpu_torch.ops import render_fused as rf
from tests.test_torch_render_fused import PALLAS_RTOL, _case, _t

torch.set_num_threads(1)

BF16 = torch.bfloat16
UPSTREAM = 3.1  # not a bf16 value: the backward multiplies in f32

# The planes entries under autograd: (port, JAX, keyword arguments, the
# inputs that get a gradient).
ENTRIES = {
    "mixed": (rf.mixed_loss_fused_planes, render_pallas.mixed_loss_fused_planes,
              {}, (0,)),
    "rendering": (rf.rendering_loss_fused_planes,
                  render_pallas.rendering_loss_fused_planes, {}, (0,)),
    "rendering_target_grad": (rf.rendering_loss_fused_planes,
                              render_pallas.rendering_loss_fused_planes,
                              {"want_target_grad": True}, (0, 1)),
}


def _planes(c, dtype):
    """(pred, gt) planes of case c as torch tensors of `dtype` and as JAX
    arrays of the same values."""
    p, g = _t(c["pred_t"]).to(dtype), _t(c["gt_t"]).to(dtype)
    jdtype = jnp.bfloat16 if dtype == BF16 else jnp.float32
    return (p, g), (jnp.asarray(c["pred_t"]).astype(jdtype),
                    jnp.asarray(c["gt_t"]).astype(jdtype))


def _to_torch(x):
    return torch.from_numpy(np.array(x, np.float32))


def _jax_value_and_grads(entry, js, planes, kw, argnums):
    return jax.value_and_grad(lambda p, t: entry(p, t, js, **kw),
                              argnums=argnums)(*planes)


@pytest.mark.parametrize("name", ["mixed", "rendering"])
def test_bf16_value_matches_jax(name):
    """Outside autograd (the value-only kernels' plain versions): the bf16
    loss against JAX's on the same planes and against the f32 loss."""
    port, jax_entry, _, _ = ENTRIES[name]
    c = _case(16, seed=40)
    (p, g), jplanes = _planes(c, BF16)
    value = port(p, g, c["ts"])
    assert value.dtype == torch.float32
    np.testing.assert_allclose(float(value),
                               float(jax_entry(*jplanes, c["js"])),
                               rtol=PALLAS_RTOL)
    f32 = port(_t(c["pred_t"]), _t(c["gt_t"]), c["ts"])
    np.testing.assert_allclose(float(value), float(f32), rtol=2e-2)


@pytest.mark.parametrize("name", sorted(ENTRIES))
def test_bf16_gradients_match_jax(name):
    """Under autograd: the loss and the bf16 gradients against JAX's on the
    same bf16 planes and against the f32 path on the quantized inputs;
    each .grad is the saved gradient times the upstream scalar in f32,
    rounded once to bf16."""
    port, jax_entry, kw, argnums = ENTRIES[name]
    c = _case(16, seed=41)
    (p, g), jplanes = _planes(c, BF16)
    inputs = [p.clone(), g.clone()]
    for i in argnums:
        inputs[i].requires_grad_()
    loss = port(*inputs, c["ts"], **kw)
    (UPSTREAM * loss).backward()
    value, jgrads = _jax_value_and_grads(jax_entry, c["js"], jplanes, kw,
                                         argnums)
    np.testing.assert_allclose(float(loss.detach()), float(value),
                               rtol=PALLAS_RTOL)
    # The f32 path on the bf16-quantized inputs, and on the f32 inputs.
    quantized = tuple(x.astype(jnp.float32) for x in jplanes)
    _, jgrads32 = _jax_value_and_grads(jax_entry, c["js"], quantized, kw,
                                       argnums)
    f32 = port(_t(c["pred_t"]), _t(c["gt_t"]), c["ts"], **kw)
    np.testing.assert_allclose(float(loss.detach()), float(f32), rtol=2e-2)
    for i, jgrad, jgrad32 in zip(argnums, jgrads, jgrads32):
        grad = inputs[i].grad
        assert grad.dtype == BF16
        np.testing.assert_allclose(grad.float().numpy(),
                                   UPSTREAM * _to_torch(jgrad).numpy(),
                                   rtol=8e-3, atol=1e-6)
        np.testing.assert_allclose(grad.float().numpy(),
                                   UPSTREAM * _to_torch(jgrad32).numpy(),
                                   rtol=1e-2, atol=1e-5)
    # The saved gradients: the value+gradient plain versions' on the same
    # planes.
    s9 = rf.pack_scenes(c["ts"])
    if name == "mixed":
        saved = rf.mixed_loss_fwdgrad_plain(p, g, s9)[1:]
    elif name == "rendering":
        saved = rf.rendering_loss_fwdgrad_plain(p, g, s9)[1:]
    else:
        saved = rf.rendering_loss_fwdgrad_both_plain(p, g, s9)[1:]
    for i, d in zip(argnums, saved):
        assert torch.equal(inputs[i].grad, (d.float() * UPSTREAM).to(BF16))


@pytest.mark.parametrize("name", sorted(rf.PLAIN_VERSIONS))
def test_bf16_plain_versions_are_f32_on_quantized_inputs(name):
    """Each plain version on bf16 planes is its f32 version on the
    quantized planes: the same loss in f32 and the gradients rounded once
    to bf16."""
    c = _case(16, seed=42)
    (p, g), _ = _planes(c, BF16)
    s9 = rf.pack_scenes(c["ts"])
    plain = rf.PLAIN_VERSIONS[name]
    out = plain(p, g, s9)
    ref = plain(p.float(), g.float(), s9)
    out = out if isinstance(out, tuple) else (out,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    assert out[0].dtype == torch.float32 and torch.equal(out[0], ref[0])
    for grad, ref_grad in zip(out[1:], ref[1:]):
        assert torch.equal(grad, ref_grad.to(BF16))


@pytest.mark.parametrize("kind", ["mixed", "rendering"])
def test_make_loss_fn_casts_the_target(kind):
    """A bf16 prediction with an f32 target: the target is cast to bf16
    before the planes entry, as the JAX loss callers cast it, so the loss
    and the bf16 gradient are those of two bf16 inputs."""
    c = _case(16, seed=43)
    loss_fn = losses.make_loss_fn(kind)
    pred = _t(c["pred"]).to(BF16).requires_grad_()
    loss = loss_fn(pred, _t(c["gt"]), scenes=c["ts"])
    loss.backward()
    ref_pred = _t(c["pred"]).to(BF16).requires_grad_()
    ref = loss_fn(ref_pred, _t(c["gt"]).to(BF16), scenes=c["ts"])
    ref.backward()
    assert torch.equal(loss, ref)
    assert pred.grad.dtype == BF16 and torch.equal(pred.grad, ref_pred.grad)


def test_wrappers_reject_other_dtypes():
    """f32 or bf16 planes, both in one dtype, and f32 scenes: anything else
    raises before a plain version or a kernel runs."""
    c = _case(16, seed=44)
    p, g = _t(c["pred_t"]), _t(c["gt_t"])
    s9 = rf.pack_scenes(c["ts"])
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        rf.mixed_loss_fwdgrad(p.half(), g.half(), s9)
    with pytest.raises(TypeError, match="share one dtype"):
        rf.rendering_loss_fwd(p.to(BF16), g, s9)
    with pytest.raises(TypeError, match="share one dtype"):
        rf.rendering_loss_fwdgrad_both(p, g.to(BF16), s9)
    with pytest.raises(TypeError, match="scenes must be float32"):
        rf.rendering_loss_fwdgrad(p, g, s9.double())
    # CPU tensors never reach a kernel, in either dtype.
    for fn in rf.CUDA_WRAPPERS.values():
        before = fn.launches
        with pytest.raises(RuntimeError, match="CUDA tensors"):
            fn(p.to(BF16), g.to(BF16), s9)
        assert fn.launches == before


def test_kernel_symbols_by_dtype():
    """Each kernel's C entry for bf16 planes is its f32 entry's with the
    suffix _bf16; no other dtype has one."""
    for name, entry in rf._ENTRIES.items():
        assert rf.symbol(name) == entry[1]
        assert rf.symbol(name, BF16) == entry[1] + "_bf16"
    assert set(rf.PLANE_DTYPES) == {torch.float32, BF16}
