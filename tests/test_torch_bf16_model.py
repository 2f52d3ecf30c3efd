"""bf16 compute, bf16-SR masters and the master-dtype policy of the port
against the JAX package on the CPU, at depth 5, 32^2, 8 filters, batch 2.

Both frameworks run the models in bf16 with f32 parameters or bf16
masters, f32 normalization statistics and channel means, an f32 head
decode, and round at the same layers; they differ in how the convolutions
sum (XLA's and oneDNN's bf16 convolutions, and the JAX decoder's rewritten
forms, which pre-sum kernel taps in f32). JAX runs at highest matmul
precision, dropout off on both sides. Tolerances:
- forward: the port's bf16 maps no further from JAX's f32 maps than twice
  JAX's own bf16 maps are (normwise; measured: single view 1.22e-3 against
  1.45e-3, multi view 9.75e-3 against 1.02e-2), and within 3e-2 normwise
  of JAX's bf16 maps (measured 1.10e-3 and 8.14e-3);
- one train step with bf16-SR masters (the JAX step assembled from
  model.apply and render_pallas.mixed_loss_fused_planes on bf16 planes,
  with the same scenes): the loss within rel 2e-2 (measured 1.2e-4); the
  gradients, all leaves together, no further (normwise) from the JAX
  step's f32 gradients than twice the JAX step's own bf16 gradients are
  (measured 0.113 against 0.111; the two frameworks' bf16 gradients are
  8.2e-2 apart; per leaf the two
  frameworks' bf16 gradients differ by 2-20 % normwise, and where a
  gradient is within bf16 noise of 0 its sign, and so -lr * sign(g), the
  first step's update, differs); and the update on the port's gradients as
  JAX's adam_bf16sr forms it: each >=2-D master one of the two bf16 values
  around JAX's f32 sum p + u (the SR set; the two frameworks number the
  leaves, and so salt them, differently), each 1-D leaf (f32, p + u)
  JAX's to rtol 1e-6.
"""

import contextlib
import io
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svbrdf_tpu.interop.torch_port import (export_torch_state_dict,
                                           port_torch_state_dict)
from svbrdf_tpu.models import MultiViewModel as JaxMultiViewModel
from svbrdf_tpu.models import SingleViewModel as JaxSingleViewModel
from svbrdf_tpu.ops import render_pallas
from svbrdf_tpu.ops import sampling as jsampling
from svbrdf_tpu.parallel import optimizer as jopt
from svbrdf_tpu.parallel import step as jstep
from svbrdf_tpu.training.checkpoint import Checkpoint as JaxCheckpoint
from svbrdf_tpu_torch import losses
from svbrdf_tpu_torch.device import precision_scope
from svbrdf_tpu_torch.interop.jax_params import params_from_jax
from svbrdf_tpu_torch.models import (MultiViewModel, SingleViewModel,
                                     build_model)
from svbrdf_tpu_torch.parallel import optimizer as opt
from svbrdf_tpu_torch.parallel import step as step_lib
from svbrdf_tpu_torch.scene import Scene
from svbrdf_tpu_torch.training import loop
from svbrdf_tpu_torch.training.checkpoint import Checkpoint
from svbrdf_tpu_torch.utils import bench_setup

torch.set_num_threads(1)

DEPTH, FILTERS, SIZE, BATCH = 5, 8, 32, 2
BF16 = torch.bfloat16
LR = 1e-5
PREP = step_lib.PrepConfig(used_input_image_count=1, use_augmentation=True,
                           is_linear=False, mix_materials=True)
MODELS = {"single": (JaxSingleViewModel, SingleViewModel, 1),
          "multi": (JaxMultiViewModel, MultiViewModel, 3)}


def _normwise(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _port_model(params, model_cls, dtype=BF16):
    model = model_cls(FILTERS, DEPTH, device="cpu", dtype=dtype)
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)),
                          strict=True)
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.eval()
    return model


@pytest.mark.parametrize("kind", sorted(MODELS))
def test_bf16_forward_matches_jax(kind):
    jax_cls, port_cls, views = MODELS[kind]
    x = np.random.default_rng(0).uniform(
        0, 1, (BATCH, views, SIZE, SIZE, 3)).astype(np.float32)
    params = jax_cls(num_filters=FILTERS, depth=DEPTH).init(
        jax.random.key(0), jnp.zeros((1, views, SIZE, SIZE, 3)))["params"]
    with jax.default_matmul_precision("highest"):
        ref32, ref16 = (np.asarray(jax_cls(
            num_filters=FILTERS, depth=DEPTH, dtype=dt).apply(
                {"params": params}, jnp.asarray(x), deterministic=True),
            np.float32) for dt in (jnp.float32, jnp.bfloat16))
    model = _port_model(params, port_cls)
    with torch.no_grad():
        mine = model(torch.from_numpy(x))
    assert mine.dtype == torch.float32
    mine = mine.numpy()
    jax_own = _normwise(ref16, ref32)
    assert _normwise(mine, ref32) <= 2.0 * jax_own
    assert _normwise(mine, ref16) <= 3e-2


@pytest.fixture(scope="module")
def step_case():
    """A prepared batch, JAX params (f32) and their bf16-SR masters, the
    loss scenes, and the JAX step's loss and gradients with those masters
    in bf16 and, for the reference, in f32 on the same values."""
    g = torch.Generator().manual_seed(0)
    raw = {k: torch.from_numpy(v) for k, v in
           bench_setup.synthetic_raw_batch(BATCH, SIZE, 0, 0).items()}
    batch = step_lib.prepare(raw, PREP, g)
    params = JaxSingleViewModel(num_filters=FILTERS, depth=DEPTH).init(
        jax.random.key(0), jnp.zeros((1, 1, SIZE, SIZE, 3)))["params"]
    masters = jstep.compute_cast(params, jnp.bfloat16)  # bf16sr's cast
    scenes = jsampling.generate_loss_scenes(jax.random.key(10), BATCH, 3, 6)
    out = dict(batch=batch, params=params, masters=masters, scenes=scenes)
    for name, dt in (("bf16", jnp.bfloat16), ("f32", jnp.float32)):
        jmodel = JaxSingleViewModel(num_filters=FILTERS, depth=DEPTH,
                                    dtype=dt)
        inputs = jnp.asarray(batch["inputs"].numpy()).astype(dt)
        gt_t = jnp.transpose(jnp.asarray(batch["svbrdf"].numpy()),
                             (0, 3, 1, 2)).astype(dt)

        def loss_of(p, jmodel=jmodel, inputs=inputs, gt_t=gt_t, dt=dt):
            pred = jmodel.apply({"params": p}, inputs, deterministic=True)
            pred_t = jnp.transpose(pred.astype(dt), (0, 3, 1, 2))
            return render_pallas.mixed_loss_fused_planes(pred_t, gt_t, scenes)

        tree = masters if dt == jnp.bfloat16 else jax.tree.map(
            lambda x: x.astype(jnp.float32), masters)
        with jax.default_matmul_precision("highest"):
            loss, grads = jax.jit(jax.value_and_grad(loss_of))(tree)
        out[name] = (float(loss), export_torch_state_dict(grads))
    return out


def _bf16_neighbours(x32):
    """The bit patterns of the two bf16 values around each f32 value: its
    truncation and the next one away from 0 (equal where x is bf16)."""
    bits = torch.from_numpy(np.ascontiguousarray(x32, np.float32)).view(
        torch.int32).to(torch.int64) & 0xFFFFFFFF
    exact = (bits & 0xFFFF) == 0
    low = bits >> 16
    return low, torch.where(exact, low, low + 1)


def test_bf16sr_train_step_matches_jax(step_case):
    """One TrainStep with bf16-SR masters against the JAX step: the loss;
    the gradients (all leaves, normwise) no further from JAX's f32
    gradients than twice JAX's own bf16 ones; and the update on the port's
    gradients as JAX's adam_bf16sr computes it, each >=2-D master one of
    the two bf16 values around JAX's f32 p + u and each 1-D leaf JAX's p +
    u to rtol 1e-6 (XLA's f32 quotient or square root can round a last bit
    otherwise: 1 element of the leaves measured)."""
    c = step_case
    model = _port_model(c["params"], SingleViewModel)
    with step_lib.master_dtype_scope():
        step_lib.set_master_dtype_policy("bf16sr")
        step_lib.master_cast(model)
    optimizer = step_lib.make_optimizer(model.parameters(), LR, BF16)
    assert isinstance(optimizer, opt.AdamBf16SR)
    step = step_lib.make_train_step(model, optimizer,
                                    losses.make_loss_fn("mixed"), PREP,
                                    torch.Generator(), seed=313)
    scenes = Scene.make(*[np.asarray(f) for f in (
        c["scenes"].camera_pos, c["scenes"].light_pos,
        c["scenes"].light_color)])
    loss = float(step.update(c["batch"], scenes=scenes, step=1))
    assert step.step_index == 1
    ref_loss, ref16 = c["bf16"]
    assert abs(loss - ref_loss) <= 2e-2 * abs(ref_loss)

    grads = {k: (np.zeros(p.shape, np.float32) if p.grad is None
                 else p.grad.float().numpy())
             for k, p in model.named_parameters()}
    ref32 = c["f32"][1]
    keys = sorted(ref32)
    flat = {name: np.concatenate([d[k].ravel() for k in keys])
            for name, d in (("port", grads), ("jax", ref16),
                            ("f32", ref32))}
    jax_own = _normwise(flat["jax"], flat["f32"])
    assert _normwise(flat["port"], flat["f32"]) <= 2.0 * jax_own

    tx = jopt.adam_bf16sr(LR)
    updates, _ = tx.update(port_torch_state_dict(grads, c["masters"]),
                           tx.init(c["masters"]))
    sums = export_torch_state_dict(jax.tree.map(
        lambda p, u: p.astype(jnp.float32) + u, c["masters"], updates))
    for name, p in model.named_parameters():
        if p.dim() >= 2:
            assert p.dtype == BF16, name
            low, high = _bf16_neighbours(sums[name])
            mine = p.detach().view(torch.int16).to(torch.int64) & 0xFFFF
            assert bool(((mine == low) | (mine == high)).all()), name
        else:
            assert p.dtype == torch.float32, name
            np.testing.assert_allclose(p.detach().numpy(), sums[name],
                                       rtol=1e-6, err_msg=name)


def test_master_policy_scope_and_cast(monkeypatch):
    monkeypatch.delenv("SVBRDF_MASTER_DTYPE", raising=False)
    assert step_lib.master_dtype_policy() == "bf16sr"
    monkeypatch.setenv("SVBRDF_MASTER_DTYPE", "f32")
    assert step_lib.master_dtype_policy() == "f32"
    with step_lib.master_dtype_scope():
        step_lib.set_master_dtype_policy("bf16sr")
        assert step_lib.master_dtype_policy() == "bf16sr"
        model = build_model("single", False, DEPTH, FILTERS, "cpu",
                            dtype=BF16)
        step_lib.master_cast(model)
        for p in model.parameters():
            assert p.dtype == (BF16 if p.dim() >= 2 else torch.float32)
        f32_model = build_model("single", False, DEPTH, FILTERS, "cpu")
        step_lib.master_cast(f32_model)  # an f32 model keeps f32 masters
        assert {p.dtype for p in f32_model.parameters()} == {torch.float32}
    assert step_lib.master_dtype_policy() == "f32"  # the override is gone
    with pytest.raises(ValueError, match="master dtype policy"):
        step_lib.set_master_dtype_policy("fp8")


def test_train_step_is_bitwise_repeatable():
    """Two programs from one seed, each stepping (seed, step) 7 with the
    same dropout stream, end with equal masters; step 8 from the same state
    differs from step 7's SR."""
    masters = []
    for _ in range(2):
        program = bench_setup.build_program("single", "mixed", BATCH, SIZE,
                                            DEPTH, FILTERS, device="cpu",
                                            dtype=BF16, master_dtype="bf16sr")
        program.generator.manual_seed(5)
        torch.manual_seed(0)
        program.train_step(program.raw, step=7)
        assert program.train_step.step_index == 7
        masters.append([p.detach().clone()
                        for p in program.model.parameters()])
    for a, b in zip(*masters):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert {p.dtype for p in masters[0]} == {BF16, torch.float32}


def test_f32_steps_keep_their_ops():
    """At f32 every cast is a no-op: the optimizer is torch.optim.Adam, the
    step's forward returns the model's own output, and the eval step gives
    the model's loss."""
    program = bench_setup.build_program("single", "mixed", BATCH, SIZE,
                                        DEPTH, FILTERS, device="cpu")
    assert type(program.train_step.optimizer) is torch.optim.Adam
    assert {p.dtype for p in program.model.parameters()} == {torch.float32}
    images = torch.rand(BATCH, 1, SIZE, SIZE, 3,
                        generator=torch.Generator().manual_seed(0))
    program.model.eval()
    with torch.no_grad():
        assert torch.equal(program.train_step.forward(images),
                           program.model(images))


def test_precision_scope_and_dtype_resolution():
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    try:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        with precision_scope(torch.float32):
            assert not torch.backends.cudnn.allow_tf32
            assert not torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.allow_tf32
        with precision_scope(BF16):
            assert torch.backends.cudnn.allow_tf32
            torch.backends.cuda.matmul.allow_tf32 = False
        assert torch.backends.cuda.matmul.allow_tf32  # restored
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
    assert loop.resolve_dtype("auto", "cuda:0") == BF16
    assert loop.resolve_dtype("auto", "cpu") == torch.float32
    assert loop.resolve_dtype("bfloat16", "cpu") == BF16


def _bf16sr_trained(steps=2):
    program = bench_setup.build_program("single", "mixed", BATCH, SIZE,
                                        DEPTH, FILTERS, device="cpu",
                                        dtype=BF16, master_dtype="bf16sr")
    for _ in range(steps):
        program.train_step(program.raw)
    return program.model, program.train_step.optimizer


def _quiet(fn, *args):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args)


def test_bf16sr_checkpoint_round_trips(tmp_path):
    """Saved with f32 weights and the policy; reloaded into an f32 template
    and cast again, the masters and the Adam state come back bit for bit."""
    model, optimizer = _bf16sr_trained()
    Checkpoint.save(tmp_path, model, optimizer, 1, "single", False,
                    model_depth=DEPTH, num_filters=FILTERS,
                    master_dtype="bf16sr")
    blob = torch.load(tmp_path / "checkpoint.tar", weights_only=True)
    assert blob["master_dtype"] == "bf16sr"
    assert {v.dtype for v in blob["model_state_dict"].values()} == {
        torch.float32}
    ckpt = _quiet(Checkpoint.load, tmp_path)
    fresh = build_model("single", False, DEPTH, FILTERS, "cpu", seed=9,
                        dtype=BF16)
    _quiet(ckpt.restore_params, fresh)
    with step_lib.master_dtype_scope():
        step_lib.set_master_dtype_policy("bf16sr")
        step_lib.master_cast(fresh)
    fresh_opt = step_lib.make_optimizer(fresh.parameters(), LR, BF16)
    _quiet(ckpt.restore_opt_state, fresh_opt)
    for (name, a), b in zip(model.named_parameters(), fresh.parameters()):
        assert a.dtype == b.dtype and torch.equal(a, b), name
        sa, sb = optimizer.state[a], fresh_opt.state[b]
        if not sa:  # unread by the forward: never stepped
            assert not sb
            continue
        for key in ("exp_avg", "exp_avg_sq"):
            assert sa[key].dtype == sb[key].dtype
            assert torch.equal(sa[key], sb[key]), (name, key)
        assert float(sa["step"]) == float(sb["step"]) == 2.0


def test_f32_adam_checkpoint_resumes_under_bf16sr(tmp_path):
    """A checkpoint of an f32 model and torch.optim.Adam (what f32
    training writes) resumes as a bf16 model with bf16-SR masters: the
    weights cast once, Adam's f32 moments cast to bf16 and its step kept."""
    model = build_model("single", False, DEPTH, FILTERS, "cpu")
    adam = step_lib.make_optimizer(model.parameters(), LR)
    x = torch.rand(BATCH, 1, SIZE, SIZE, 3,
                   generator=torch.Generator().manual_seed(1))
    model(x).square().mean().backward()
    adam.step()
    Checkpoint.save(tmp_path, model, adam, 0, "single", False,
                    model_depth=DEPTH, num_filters=FILTERS)
    ckpt = _quiet(Checkpoint.load, tmp_path)
    fresh = build_model("single", False, DEPTH, FILTERS, "cpu", seed=3,
                        dtype=BF16)
    _quiet(ckpt.restore_params, fresh)
    with step_lib.master_dtype_scope():
        step_lib.set_master_dtype_policy("bf16sr")
        step_lib.master_cast(fresh)
    sr = step_lib.make_optimizer(fresh.parameters(), LR, BF16)
    _quiet(ckpt.restore_opt_state, sr)
    for a, b in zip(model.parameters(), fresh.parameters()):
        assert torch.equal(a.detach().to(b.dtype), b)
        if not adam.state[a]:  # unread by the forward: never stepped
            continue
        for key in ("exp_avg", "exp_avg_sq"):
            want = BF16 if b.dim() >= 2 else torch.float32
            assert torch.equal(sr.state[b][key], adam.state[a][key].to(want))
    fresh(x.to(BF16)).float().square().mean().backward()
    sr.step(master_salt=1)
    assert all(float(sr.state[p]["step"]) == 2.0 for p in fresh.parameters()
               if p.grad is not None)


def test_jax_reads_a_bf16sr_checkpoint(tmp_path):
    """The JAX package's Checkpoint.load_torch reads the port's bf16sr
    checkpoint.tar, and its f32 model predicts what the port's f32 model
    predicts with those weights (atol 1e-5, rtol 1e-4, as the f32
    checkpoint test)."""
    model, optimizer = _bf16sr_trained(1)
    Checkpoint.save(tmp_path, model, optimizer, 0, "single", False,
                    model_depth=DEPTH, num_filters=FILTERS,
                    master_dtype="bf16sr")
    ckpt = _quiet(JaxCheckpoint.load_torch, tmp_path / "checkpoint.tar")
    assert ckpt.is_valid()
    jmodel = JaxSingleViewModel(num_filters=FILTERS, depth=DEPTH)
    x = np.random.default_rng(2).uniform(
        size=(BATCH, 1, SIZE, SIZE, 3)).astype(np.float32)
    template = jmodel.init(jax.random.key(0), jnp.asarray(x[:1]))["params"]
    params = _quiet(ckpt.restore_params, template)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x),
                                      deterministic=True))
    f32_model = build_model("single", False, DEPTH, FILTERS, "cpu")
    _quiet(Checkpoint.load(tmp_path).restore_params, f32_model)
    with torch.no_grad():
        mine = f32_model.eval()(torch.from_numpy(x)).numpy()
    assert math.isfinite(float(np.abs(mine).sum()))
    np.testing.assert_allclose(mine, ref, atol=1e-5, rtol=1e-4)
