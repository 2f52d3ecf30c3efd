"""The slice end to end: batch preparation and the train, eval and predict
steps of the port against the JAX package, at depth 5, 32^2, 8 filters,
batch 2.

Random draws cannot be shared between jax.random and torch.Generator, so
preparation is compared with JAX's draws injected, and the train step
against a JAX step assembled from public pieces (model.apply with
deterministic=True, render_pallas.mixed_loss_fused_planes with the same
scenes, jax.value_and_grad, optax.adam) with dropout off on both sides. The
JAX side runs at highest matmul precision. Tolerances: prepared SVBRDF
rtol 1e-5; synthesized photos, which are renders, the renderer tests'
rtol 2e-4 (atol 1e-5); loss and eval loss rtol 1e-4; each gradient leaf
|diff| / |g| <= 1e-3.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from svbrdf_tpu.data import pipeline as jpipeline
from svbrdf_tpu.interop.torch_port import export_torch_state_dict
from svbrdf_tpu.models import MultiViewModel as JaxMultiViewModel
from svbrdf_tpu.models import SingleViewModel as JaxSingleViewModel
from svbrdf_tpu.ops import render_pallas
from svbrdf_tpu.ops import sampling as jsampling
from svbrdf_tpu.utils import bench_setup as jbench_setup
from svbrdf_tpu_torch import losses
from svbrdf_tpu_torch.data import pipeline
from svbrdf_tpu_torch.interop.jax_params import params_from_jax
from svbrdf_tpu_torch.models import MultiViewModel, SingleViewModel
from svbrdf_tpu_torch.parallel import step as step_lib
from svbrdf_tpu_torch.scene import Scene
from svbrdf_tpu_torch.utils import bench_setup

torch.set_num_threads(1)

DEPTH, FILTERS, SIZE, BATCH = 5, 8, 32, 2
PREP = step_lib.PrepConfig(used_input_image_count=1, use_augmentation=True,
                           is_linear=False, mix_materials=True)
PREP_MULTI = PREP._replace(used_input_image_count=3)


def _raw(seed=0, n_views=0):
    return bench_setup.synthetic_raw_batch(BATCH, SIZE, n_views, seed)


def _torch_raw(raw):
    return {k: torch.from_numpy(v) for k, v in raw.items()}


def _port_scene(js):
    return Scene.make(*[np.asarray(f) for f in (js.camera_pos, js.light_pos,
                                                js.light_color)])


def test_synthetic_raw_batch_has_the_jax_bytes():
    mine = bench_setup.synthetic_raw_batch(3, 16, 1, seed=4)
    ref = jbench_setup.synthetic_raw_batch(3, 16, n_views=1, seed=4)
    for key in ("inputs", "svbrdf", "partner_svbrdf"):
        np.testing.assert_array_equal(mine[key], ref[key])


def _jax_prep_draws(key, count=1):
    """The draws jax prepare_batch makes from `key` (see its source):
    alphas from fold_in(key, 1); per item k_scene, k_std, k_noise."""
    mix_keys = jax.random.split(jax.random.fold_in(key, 1), BATCH)
    alphas = np.stack([np.asarray(jax.random.uniform(
        k, (), minval=0.1, maxval=0.9)) for k in mix_keys])
    scenes, stds, noises = [], [], []
    for k in jax.random.split(key, BATCH):
        k_scene, k_std, k_noise = jax.random.split(k, 3)
        scenes.append(jpipeline.generate_input_scenes(k_scene, count, True))
        stds.append(np.exp(math.log(0.005) + 0.3 * np.asarray(
            jax.random.normal(k_std, (count, 1, 1, 1)))))
        noises.append(np.asarray(jax.random.normal(k_noise,
                                                   (count, SIZE, SIZE, 3))))
    scene = Scene.make(*[np.stack([np.asarray(getattr(s, f)) for s in scenes])
                         for f in ("camera_pos", "light_pos", "light_color")])
    return dict(alphas=torch.from_numpy(alphas), scenes=scene,
                noise_std=torch.from_numpy(np.stack(stds).astype(np.float32)),
                noise=torch.from_numpy(np.stack(noises)))


@pytest.mark.parametrize("count", [1, 3])
def test_prepare_batch_matches_jax_with_injected_draws(count):
    """Every view synthesized (the strips hold no photos): one for the
    single-view model, three for the multi-view one."""
    raw = _raw(seed=1)
    key = jax.random.key(7)
    ref = jpipeline.prepare_batch(key, raw["inputs"], raw["svbrdf"],
                                  raw["partner_svbrdf"],
                                  used_input_image_count=count,
                                  use_augmentation=True)
    t = _torch_raw(raw)
    mine = pipeline.prepare_batch(t["inputs"], t["svbrdf"],
                                  t["partner_svbrdf"], count, True,
                                  **_jax_prep_draws(key, count))
    assert mine["inputs"].shape == (BATCH, count, SIZE, SIZE, 3)
    assert mine["svbrdf"].shape == (BATCH, SIZE, SIZE, 12)
    np.testing.assert_allclose(mine["svbrdf"].numpy(),
                               np.asarray(ref["svbrdf"]), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(mine["inputs"].numpy(),
                               np.asarray(ref["inputs"]), rtol=2e-4,
                               atol=1e-5)


def test_prepare_batch_real_photos_match_jax():
    """Photos read from strips are gamma-decoded; nothing is synthesized
    and no partner is mixed."""
    raw = _raw(seed=2, n_views=1)
    raw["inputs"] = np.random.default_rng(2).integers(
        0, 256, raw["inputs"].shape, dtype=np.uint8)
    ref = jpipeline.prepare_batch(jax.random.key(0), raw["inputs"],
                                  raw["svbrdf"], None,
                                  used_input_image_count=1)
    t = _torch_raw(raw)
    mine = pipeline.prepare_batch(t["inputs"], t["svbrdf"], None, 1)
    for key in ("inputs", "svbrdf"):
        np.testing.assert_allclose(mine[key].numpy(), np.asarray(ref[key]),
                                   rtol=1e-5, atol=1e-6)


def test_generate_input_scenes_constants():
    g = torch.Generator().manual_seed(0)
    s = pipeline.generate_input_scenes(512, 3, True, generator=g)
    light, view = s.light_pos.numpy(), s.camera_pos.numpy()
    np.testing.assert_array_equal(light[:, 0, 2],
                                  np.float32(pipeline.FIXED_LIGHT_DISTANCE))
    assert np.abs(light[:, 0, :2]).max() <= 0.75
    assert np.abs(view[:, 0, :2]).max() <= 0.25
    np.testing.assert_allclose(np.linalg.norm(light[:, 1:], axis=-1),
                               pipeline.FIXED_LIGHT_DISTANCE, rtol=1e-5)
    dist = np.linalg.norm(view[:, 1:], axis=-1)
    assert dist.min() >= 0.25 - 1e-5 and dist.max() <= 2.75 + 1e-5
    assert (s.light_color.numpy() > 0).all()
    fixed = pipeline.generate_input_scenes(4, 2, False, generator=g)
    np.testing.assert_array_equal(fixed.light_color.numpy(), 30.0)
    np.testing.assert_array_equal(fixed.camera_pos.numpy()[:, 0, 2],
                                  np.float32(pipeline.FIXED_VIEW_DISTANCE))


@pytest.fixture(scope="module")
def parity():
    """A prepared batch, the JAX model + params, and 3 scene sets."""
    g = torch.Generator().manual_seed(0)
    batch = step_lib.prepare(_torch_raw(_raw()), PREP, g)
    jmodel = JaxSingleViewModel(use_coords=False, num_filters=FILTERS,
                                depth=DEPTH)
    params = jmodel.init(jax.random.key(0),
                         jnp.zeros((1, 1, SIZE, SIZE, 3)))["params"]
    scenes = [jsampling.generate_loss_scenes(jax.random.key(10 + i), BATCH,
                                             3, 6) for i in range(3)]
    return dict(batch=batch, jmodel=jmodel, params=params, scenes=scenes)


def _port_model(params, model_cls=SingleViewModel):
    model = model_cls(FILTERS, DEPTH, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)),
                          strict=True)
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.eval()
    return model


def _jax_loss(jmodel, inputs, target,
              fused_loss=render_pallas.mixed_loss_fused_planes):
    gt_t = jnp.transpose(jnp.asarray(target), (0, 3, 1, 2))

    def loss_of(p, scenes):
        pred = jmodel.apply({"params": p}, inputs, deterministic=True)
        return fused_loss(jnp.transpose(pred, (0, 3, 1, 2)), gt_t, scenes)

    return loss_of


def _assert_grads_match(model, jax_grads):
    """Each port gradient within 1e-3 (normwise) of the JAX one; a leaf the
    forward never reads has no port gradient and a zero JAX one."""
    grads = {k: p.grad for k, p in model.named_parameters()}
    ref = export_torch_state_dict(jax_grads)
    assert set(ref) == set(grads)
    for key, g_ref in ref.items():
        if grads[key] is None:
            # Unused by the forward: the enc1 merge (no global track reaches
            # it) and, in the single-view model, the last global-track stage.
            np.testing.assert_array_equal(g_ref, 0.0, err_msg=key)
            continue
        diff = np.linalg.norm(grads[key].numpy() - g_ref)
        assert diff <= 1e-3 * np.linalg.norm(g_ref), key


def test_train_step_matches_jax(parity):
    batch = parity["batch"]
    inputs = jnp.asarray(batch["inputs"].numpy())
    loss_of = _jax_loss(parity["jmodel"], inputs, batch["svbrdf"].numpy())
    opt = optax.adam(1e-5)
    params = parity["params"]
    opt_state = opt.init(params)
    jax_losses, jax_grads = [], None
    with jax.default_matmul_precision("highest"):
        value_and_grad = jax.jit(jax.value_and_grad(loss_of))
        for scenes in parity["scenes"]:
            loss, grads = value_and_grad(params, scenes)
            jax_grads = jax_grads or grads
            updates, opt_state = opt.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            jax_losses.append(float(loss))

    model = _port_model(parity["params"])
    step = step_lib.make_train_step(
        model, step_lib.make_optimizer(model.parameters(), 1e-5),
        losses.make_loss_fn("mixed"), PREP, torch.Generator())
    port_losses = []
    for i, scenes in enumerate(parity["scenes"]):
        port_losses.append(float(step.update(batch,
                                             scenes=_port_scene(scenes))))
        if i == 0:
            _assert_grads_match(model, jax_grads)
    np.testing.assert_allclose(port_losses, jax_losses, rtol=1e-4)
    assert len(set(port_losses)) == 3  # the weights moved between steps


def test_eval_step_matches_jax(parity):
    """The eval step's loss (dropout off, value-only path) equals the JAX
    forward + mixed_loss_fused_planes value on the same batch and scenes,
    and leaves every module's mode as it found it."""
    model = _port_model(parity["params"])
    raw = _torch_raw(_raw(seed=3))
    batch = step_lib.prepare(raw, PREP, torch.Generator().manual_seed(9))
    scenes = parity["scenes"][0]
    eval_step = step_lib.make_eval_step(model, losses.make_loss_fn("mixed"),
                                        PREP,
                                        torch.Generator().manual_seed(9))
    modes = [m.training for m in model.modules()]
    value = float(eval_step(raw, scenes=_port_scene(scenes)))
    assert [m.training for m in model.modules()] == modes
    with jax.default_matmul_precision("highest"):
        ref = _jax_loss(parity["jmodel"], jnp.asarray(batch["inputs"].numpy()),
                        batch["svbrdf"].numpy())(parity["params"], scenes)
    np.testing.assert_allclose(value, float(ref), rtol=1e-4)


@pytest.fixture(scope="module")
def multi_parity():
    """A prepared 3-view batch, an eval batch, the JAX MultiViewModel +
    params, 3 scene sets, and the JAX loss's value and gradient under the
    rendering-only loss (one jit for every call)."""
    g = torch.Generator().manual_seed(1)
    batch = step_lib.prepare(_torch_raw(_raw(seed=4)), PREP_MULTI, g)
    raw_eval = _torch_raw(_raw(seed=5))
    eval_batch = step_lib.prepare(raw_eval, PREP_MULTI,
                                  torch.Generator().manual_seed(9))
    jmodel = JaxMultiViewModel(use_coords=False, num_filters=FILTERS,
                               depth=DEPTH)
    params = jmodel.init(jax.random.key(1),
                         jnp.zeros((1, 3, SIZE, SIZE, 3)))["params"]
    scenes = [jsampling.generate_loss_scenes(jax.random.key(20 + i), BATCH,
                                             3, 6) for i in range(3)]

    def loss_of(p, scenes, inputs, target):
        return _jax_loss(jmodel, inputs, target,
                         render_pallas.rendering_loss_fused_planes)(p, scenes)

    return dict(batch=batch, raw_eval=raw_eval, eval_batch=eval_batch,
                params=params, scenes=scenes,
                value_and_grad=jax.jit(jax.value_and_grad(loss_of)))


def test_multi_view_rendering_train_step_matches_jax(multi_parity):
    """Three steps of the multi-view model with the rendering-only loss
    against the JAX model, render_pallas.rendering_loss_fused_planes and
    optax.adam: loss rtol 1e-4, first-step gradients 1e-3 normwise."""
    mp = multi_parity
    batch = mp["batch"]
    inputs = jnp.asarray(batch["inputs"].numpy())
    target = batch["svbrdf"].numpy()
    opt = optax.adam(1e-5)
    params = mp["params"]
    opt_state = opt.init(params)
    jax_losses, jax_grads = [], None
    with jax.default_matmul_precision("highest"):
        for scenes in mp["scenes"]:
            loss, grads = mp["value_and_grad"](params, scenes, inputs, target)
            jax_grads = jax_grads or grads
            updates, opt_state = opt.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            jax_losses.append(float(loss))

    model = _port_model(mp["params"], MultiViewModel)
    step = step_lib.make_train_step(
        model, step_lib.make_optimizer(model.parameters(), 1e-5),
        losses.make_loss_fn("rendering"), PREP_MULTI, torch.Generator())
    port_losses = []
    for i, scenes in enumerate(mp["scenes"]):
        port_losses.append(float(step.update(batch,
                                             scenes=_port_scene(scenes))))
        if i == 0:
            _assert_grads_match(model, jax_grads)
    np.testing.assert_allclose(port_losses, jax_losses, rtol=1e-4)
    assert len(set(port_losses)) == 3  # the weights moved between steps


def test_multi_view_rendering_eval_step_matches_jax(multi_parity):
    """The eval step (dropout off, value-only rendering path) against the
    JAX forward + rendering_loss_fused_planes on the same batch and
    scenes."""
    mp = multi_parity
    model = _port_model(mp["params"], MultiViewModel)
    eval_step = step_lib.make_eval_step(
        model, losses.make_loss_fn("rendering"), PREP_MULTI,
        torch.Generator().manual_seed(9))
    scenes = mp["scenes"][0]
    value = float(eval_step(mp["raw_eval"], scenes=_port_scene(scenes)))
    eb = mp["eval_batch"]
    with jax.default_matmul_precision("highest"):
        ref, _ = mp["value_and_grad"](
            mp["params"], scenes, jnp.asarray(eb["inputs"].numpy()),
            eb["svbrdf"].numpy())
    np.testing.assert_allclose(value, float(ref), rtol=1e-4)


def test_train_step_runs_from_raw_batch():
    """The whole step as the trainer calls it: dropout on, every draw from
    the step's generator; the loss is finite and the weights move."""
    model = SingleViewModel(FILTERS, DEPTH, device="cpu", seed=2)
    before = [p.detach().clone() for p in model.parameters()]
    step = step_lib.make_train_step(
        model, step_lib.make_optimizer(model.parameters()),
        losses.make_loss_fn("mixed"), PREP, torch.Generator().manual_seed(1))
    raw = _torch_raw(_raw())
    first, second = float(step(raw)), float(step(raw))
    assert math.isfinite(first) and math.isfinite(second)
    assert first != second
    assert any(not torch.equal(a, p) for a, p in zip(before,
                                                     model.parameters()))


def test_predict_is_the_eval_forward():
    model = SingleViewModel(FILTERS, DEPTH, device="cpu", seed=3)
    images = torch.rand(BATCH, 1, SIZE, SIZE, 3,
                        generator=torch.Generator().manual_seed(0))
    out = step_lib.make_predict_fn(model)(images)
    assert out.shape == (BATCH, SIZE, SIZE, 12) and not out.requires_grad
    assert model.training
    model.eval()
    with torch.no_grad():
        assert torch.equal(out, model(images))


def test_main_program_builds_on_cpu_when_asked():
    program = bench_setup.build_main_program(BATCH, SIZE, DEPTH, FILTERS,
                                             device="cpu")
    assert program.raw["svbrdf"].dtype == torch.uint8
    assert math.isfinite(float(program.eval_step(program.raw)))


def test_multi_view_rendering_program_builds_on_cpu_when_asked():
    """build_program("multi", "rendering"): 3 synthesized views, the
    rendering-only loss; a train step moves the weights and eval and
    predict give finite values of the right shapes."""
    program = bench_setup.build_program("multi", "rendering", BATCH, SIZE,
                                        DEPTH, FILTERS, device="cpu")
    assert isinstance(program.model, MultiViewModel)
    assert program.prep.used_input_image_count == 3
    before = [p.detach().clone() for p in program.model.parameters()]
    assert math.isfinite(float(program.train_step(program.raw)))
    assert any(not torch.equal(a, p) for a, p in
               zip(before, program.model.parameters()))
    assert math.isfinite(float(program.eval_step(program.raw)))
    images = step_lib.prepare(program.raw, program.prep,
                              program.generator)["inputs"]
    assert images.shape == (BATCH, 3, SIZE, SIZE, 3)
    assert program.predict(images).shape == (BATCH, SIZE, SIZE, 12)
    with pytest.raises(ValueError, match="unknown model kind"):
        bench_setup.build_program("triple", "rendering", device="cpu")


def test_one_draw_path_is_the_parents_draw_order():
    """The train and eval steps draw through the row-wise path
    (prepare_rows, loss_rows, the whole batch as the span) and stay
    bit-equal to the order they drew in before: prepare_batch drawing from
    the generator itself, then the loss drawing its scenes (written out
    here). Three train steps with dropout on, then an eval step: the same
    losses and weights to the bit."""
    loss_fn = losses.make_loss_fn("mixed")
    raw = _torch_raw(_raw(seed=6))

    def build():
        torch.manual_seed(5)
        model = SingleViewModel(FILTERS, DEPTH, device="cpu", seed=4)
        return model, step_lib.make_optimizer(model.parameters())

    model, opt = build()
    g = torch.Generator()
    parent = []
    for n in range(3):
        g.manual_seed(100 + n)
        batch = pipeline.prepare_batch(
            raw["inputs"], raw["svbrdf"], raw["partner_svbrdf"],
            used_input_image_count=1, use_augmentation=True, generator=g)
        loss = loss_fn(model(batch["inputs"]), batch["svbrdf"], g)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        parent.append(loss.detach())
    g.manual_seed(200)
    model.eval()
    with torch.no_grad():
        batch = pipeline.prepare_batch(
            raw["inputs"], raw["svbrdf"], raw["partner_svbrdf"],
            used_input_image_count=1, use_augmentation=True, generator=g)
        parent.append(loss_fn(model(batch["inputs"]), batch["svbrdf"], g))
    weights = [p.detach().clone() for p in model.parameters()]

    model, opt = build()
    g = torch.Generator()
    step = step_lib.make_train_step(model, opt, loss_fn, PREP, g)
    eval_step = step_lib.make_eval_step(model, loss_fn, PREP, g)
    mine = []
    for n in range(3):
        g.manual_seed(100 + n)
        mine.append(step(raw))
    g.manual_seed(200)
    mine.append(eval_step(raw))
    for a, b in zip(mine, parent):
        assert torch.equal(a, b)
    for a, b in zip(model.parameters(), weights):
        assert torch.equal(a, b)
