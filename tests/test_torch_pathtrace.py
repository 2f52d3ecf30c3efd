"""The port's path tracer (svbrdf_tpu_torch/ops/pathtrace.py) and the
path-traced losses against the JAX package, on the CPU.

torch cannot reproduce jax.random, so each comparison hands the port the
samples JAX draws: for a render key k, the forward estimator's offsets and
per-pixel shift from jax.random.split(k) as JAX's _shade draws them, the
backward estimator's from fold_in(k, 1); for the losses, k is JAX's per-call
render key, fold_in(fold_in(key, _RENDER_KEY_TAG), seed 0).

Tolerances. Renders: rel 1e-5 per value, except where f32 itself is
ill-conditioned: the Blinn lobe pow(n.h, e) has e up to 2e4 at the
roughness clamp, so one ulp of n.h moves it ~1e-3. Such a value (at most
1 % of them) is held against a float64 evaluation of the same samples
instead (bench_setup.hold_render): no further from it than 4x the largest
of JAX's own f32 distance, rel 1e-5 and the value's f32 conditioning (the
most one f32 ulp of the maps moves the float64 render,
bench_setup.render_conditioning). Gradients
(normwise): within 1e-4 of JAX's, and as close to float64 as JAX's (2x,
plus 1e-5). Losses: rel 1e-5 in f32, their gradient where no L1 tie touches it
(there JAX's abs takes the subgradient 1 and torch's 0: a recorded
difference, pinned by test_l1_ties_take_the_zero_subgradient) normwise
1e-4, and as close to float64 as JAX's. A bf16 prediction (bf16
coordinates, maps and Blinn exponents, as JAX's dtypes give them): renders
normwise 5e-5, each value rel 1e-2, at most 2 % of values beyond rel 1e-5;
the loss rel 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svbrdf_tpu import losses as jlosses
from svbrdf_tpu.ops import pathtrace as jpt
from svbrdf_tpu.ops import sampling as jsampling
from svbrdf_tpu_torch import losses
from svbrdf_tpu_torch.data import pipeline
from svbrdf_tpu_torch.ops import pathtrace as pt
from svbrdf_tpu_torch.ops import render
from svbrdf_tpu_torch.scene import Scene
from svbrdf_tpu_torch.utils import bench_setup
from tests.test_render import random_svbrdf

torch.set_num_threads(1)

B, SIZE, S = 2, 16, 9


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.array(x, dtype=np.float32)).to(dtype)


def _svbrdf(seed, batch=B, size=SIZE):
    """Decoded (B, H, W, 12) maps of a synthetic raw batch (roughness down
    to 0.05: the Blinn exponent reaches its clamp)."""
    raw = bench_setup.synthetic_raw_batch(batch, size, 0, seed)["svbrdf"]
    return pipeline._decode_u8_svbrdf(torch.from_numpy(raw)).numpy()


def _scenes(key, batch=B):
    js = jsampling.generate_loss_scenes(key, batch, 3, 6)
    return js, Scene.make(*[np.asarray(f) for f in
                            (js.camera_pos, js.light_pos, js.light_color)])


def _jax_samples(k, spp, shape, hw):
    """The samples JAX's _shade draws from key k."""
    k_off, k_px = jax.random.split(k)
    return pt.Samples(_t(jpt._stratified_offsets(k_off, spp, shape)),
                      _t(jax.random.uniform(k_px, shape + hw + (2,))))


def _jax_render_samples(k, shape, hw, spp=(16, 8)):
    """The forward samples of _render_mc(key=k) and its backward's."""
    return pt.RenderSamples(
        _jax_samples(k, spp[0], shape, hw),
        _jax_samples(jax.random.fold_in(k, 1), spp[1], shape, hw))


def _loss_render_key(key):
    """The key make_render_fn() renders with inside JAX's rendering loss."""
    return jax.random.fold_in(
        jax.random.fold_in(key, jlosses._RENDER_KEY_TAG), 0)


def _f64(samples):
    return pt.Samples(*(x.double() for x in samples))


def _scene64(scene):
    return Scene(*(x.double() for x in (scene.camera_pos, scene.light_pos,
                                        scene.light_color)))


def _normwise(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_shade_matches_jax():
    js, scene = _scenes(jax.random.key(5))
    sv = _svbrdf(3)
    k = jax.random.key(7)
    shape = (B, S)
    smp = _jax_samples(k, 16, shape, (SIZE, SIZE))
    ref = np.asarray(jpt._shade(js, jnp.asarray(sv)[:, None], k, 16))
    port = pt._shade(scene, torch.from_numpy(sv)[:, None], *smp).numpy()
    port64 = pt._shade(_scene64(scene), torch.from_numpy(sv).double()[:, None],
                       *_f64(smp))
    assert port.shape == (B, S, SIZE, SIZE, 3) and port.dtype == np.float32
    cond = bench_setup.render_conditioning(
        scene, torch.from_numpy(sv)[:, None], pt.RenderSamples(smp, smp))
    bench_setup.hold_render(torch.from_numpy(port), _t(ref),
                            port64, cond)


def test_shade_matches_jax_for_a_bf16_prediction():
    js, scene = _scenes(jax.random.key(5))
    sv = jnp.asarray(_svbrdf(3)).astype(jnp.bfloat16)
    k = jax.random.key(7)
    smp = _jax_samples(k, 16, (B, S), (SIZE, SIZE))
    ref = np.asarray(jpt._shade(js, sv[:, None], k, 16))
    sv_bf16 = _t(sv.astype(jnp.float32), torch.bfloat16)
    port = pt._shade(scene, sv_bf16[:, None], *smp)
    assert port.dtype == torch.float32 and ref.dtype == np.float32
    port = port.numpy()
    zero = ref == 0
    np.testing.assert_array_equal(port[zero], 0.0)
    rel = np.abs(port - ref)[~zero] / np.abs(ref[~zero])
    assert _normwise(port, ref) <= 5e-5
    assert rel.max() <= 1e-2
    assert (rel > 1e-5).mean() <= 0.02


def test_render_gradient_matches_jax():
    """The custom VJP's gradients (backward samples from fold_in(k, 1)) of
    a weighted sum of the render, for the SVBRDF and every scene field."""
    js, scene = _scenes(jax.random.key(11))
    sv = _svbrdf(4)
    k = jax.random.key(12)
    smp = _jax_render_samples(k, (B, S), (SIZE, SIZE))
    w = np.random.default_rng(0).uniform(
        0.5, 1.5, (B, S, SIZE, SIZE, 3)).astype(np.float32)

    def jax_fn(sc, s):
        return jnp.sum(jnp.asarray(w)
                       * jpt._render_mc(sc, s[:, None], k, 16, 8))

    jsc, jsv = jax.grad(jax_fn, argnums=(0, 1))(js, jnp.asarray(sv))
    ref = [np.asarray(g) for g in (jsv, jsc.camera_pos, jsc.light_pos,
                                   jsc.light_color)]

    def port(dtype):
        leaves = [_t(x, dtype).requires_grad_() for x in
                  (sv, scene.camera_pos, scene.light_pos, scene.light_color)]
        samples = pt.RenderSamples(*(pt.Samples(*(x.to(dtype) for x in s))
                                     for s in smp))
        out = pt.render_mc(Scene(*leaves[1:]), leaves[0][:, None], samples)
        (_t(w, dtype) * out).sum().backward()
        return [x.grad.numpy() for x in leaves]

    for name, mine, jax_g, g64 in zip(
            ("svbrdf", "camera_pos", "light_pos", "light_color"),
            port(torch.float32), ref, port(torch.float64)):
        assert _normwise(mine, jax_g) <= 1e-4, name
        assert (_normwise(mine, g64)
                <= 2 * _normwise(jax_g, g64) + 1e-5), name


def _untied(pred, target, scene, samples, kind):
    """(B, H, W, 12) mask of the gradient values no L1 tie touches: at
    |x| with x exactly 0 JAX's abs takes the subgradient 1, torch's 0 (a
    recorded difference, ROADMAP Queue 3). Ties: equal map values (mixed
    loss), and pixels where any scene's log-render values are equal (there
    all 12 channels)."""
    logs = [torch.log(pt.render_mc(scene, torch.from_numpy(x)[:, None],
                                   samples) + 0.1) for x in (pred, target)]
    pixel_tie = (logs[0] == logs[1]).any(dim=4).any(dim=1).numpy()
    mask = np.broadcast_to(~pixel_tie[..., None], pred.shape).copy()
    if kind == "mixed":
        mask &= pred != target
    return mask


@pytest.mark.parametrize("kind", ["mixed", "rendering"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_loss_matches_jax(kind, dtype):
    """make_loss_fn(kind, "pathtracing") with JAX's scenes and samples
    injected against svbrdf_tpu.losses (unfused, as JAX builds it for the
    path tracer): the value, and in f32 the prediction's gradient where no
    L1 tie touches it (normwise 1e-4), and everywhere as close to a float64
    evaluation as JAX's. A bf16 prediction meets an f32 target, uncast, as
    in JAX."""
    key = jax.random.key(21)
    js, scene = _scenes(key)
    pred, target = _svbrdf(6), _svbrdf(7)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jpred = jnp.asarray(pred).astype(jdt)
    samples = _jax_render_samples(_loss_render_key(key), (B, S),
                                  (SIZE, SIZE))
    jfn = jlosses.make_loss_fn(kind, "pathtracing")
    ref, jgrad = jax.value_and_grad(
        lambda p: jfn(p, jnp.asarray(target), key))(jpred)

    def port(dt, cast=lambda x: x):
        p = _t(np.asarray(jpred.astype(jnp.float32)), dt).requires_grad_()
        loss = losses.make_loss_fn(kind, "pathtracing")(
            p, cast(torch.from_numpy(target)), scenes=Scene(*map(cast, (
                scene.camera_pos, scene.light_pos, scene.light_color))),
            samples=pt.RenderSamples(*(pt.Samples(*map(cast, smp))
                                       for smp in samples)))
        loss.backward()
        return loss.detach(), p.grad

    loss, grad = port(dtype)
    assert loss.dtype == torch.float32 and grad.dtype == dtype
    if dtype == torch.bfloat16:
        np.testing.assert_allclose(float(loss), float(ref), rtol=1e-4)
        assert torch.isfinite(grad).all()
        return
    np.testing.assert_allclose(float(loss), float(ref), rtol=1e-5)
    grad, jgrad = grad.numpy(), np.asarray(jgrad)
    keep = _untied(pred, target, scene, samples, kind)
    assert keep.mean() >= 0.75
    assert _normwise(grad[keep], jgrad[keep]) <= 1e-4
    g64 = port(torch.float64, lambda x: x.double())[1].numpy()
    assert _normwise(grad, g64) <= 2 * _normwise(jgrad, g64) + 1e-5


def test_l1_ties_take_the_zero_subgradient():
    """The recorded difference: at pred == target the port's path-traced
    loss has gradient 0 (torch's abs takes the subgradient 0 at 0), JAX's
    does not (jnp.abs takes 1); the loss is 0 in both."""
    key = jax.random.key(23)
    target = _svbrdf(8)
    jloss, jgrad = jax.value_and_grad(lambda p: jlosses.make_loss_fn(
        "mixed", "pathtracing")(p, jnp.asarray(target), key))(
            jnp.asarray(target))
    p = torch.from_numpy(target.copy()).requires_grad_()
    loss = losses.make_loss_fn("mixed", "pathtracing")(
        p, torch.from_numpy(target), torch.Generator().manual_seed(1))
    loss.backward()
    assert float(jloss) == 0.0 and float(loss.detach()) == 0.0
    assert np.count_nonzero(np.asarray(jgrad)) > 0
    assert torch.count_nonzero(p.grad) == 0


@pytest.mark.parametrize("kind", ["mixed", "rendering"])
def test_loss_and_gradient_are_zero_at_identical_maps(kind):
    """pred and target share the generator's samples (common random
    numbers), so the loss and its gradient are exactly 0."""
    target = torch.from_numpy(_svbrdf(8))
    pred = target.clone().requires_grad_()
    g = torch.Generator().manual_seed(3)
    loss = losses.make_loss_fn(kind, "pathtracing")(pred, target, g)
    loss.backward()
    assert float(loss.detach()) == 0.0
    assert torch.count_nonzero(pred.grad) == 0


def test_same_seed_same_bits_and_fresh_samples_per_draw():
    """A generator in the same state gives the same bits; the next call
    draws fresh samples; without a generator every call renders on the
    seed's samples."""
    sv = torch.from_numpy(_svbrdf(9))[:, None]
    _, scene = _scenes(jax.random.key(1))
    fn = pt.make_render_fn()
    g = torch.Generator().manual_seed(5)
    first, second = fn(scene, sv, generator=g), fn(scene, sv, generator=g)
    again = fn(scene, sv, generator=torch.Generator().manual_seed(5))
    assert torch.equal(first, again)
    assert not torch.equal(first, second)
    assert torch.equal(fn(scene, sv), fn(scene, sv))

    loss_fn = losses.make_loss_fn("mixed", "pathtracing")
    target = torch.from_numpy(_svbrdf(10))
    a = loss_fn(sv[:, 0], target, torch.Generator().manual_seed(2))
    b = loss_fn(sv[:, 0], target, torch.Generator().manual_seed(2))
    assert torch.equal(a, b)


def test_training_and_evaluation_consume_the_generator_alike():
    """The forward draws the backward's samples too, so a loss under
    no_grad leaves the generator where a loss with a gradient does."""
    target = torch.from_numpy(_svbrdf(11))
    pred = torch.from_numpy(_svbrdf(12))
    loss_fn = losses.make_loss_fn("rendering", "pathtracing")
    g_train = torch.Generator().manual_seed(4)
    loss_fn(pred.clone().requires_grad_(), target, g_train).backward()
    g_eval = torch.Generator().manual_seed(4)
    with torch.no_grad():
        loss_fn(pred, target, g_eval)
    assert torch.equal(g_train.get_state(), g_eval.get_state())


def test_samples_are_drawn_in_the_documented_order():
    """draw_render_samples: forward jitter, forward extra samples (spp not
    a square), forward shift, then the same for the backward estimator;
    each stratified sample lies in its own cell."""
    shape, hw = (2, 3), (4, 5)
    smp = pt.draw_render_samples(torch.Generator().manual_seed(6), (5, 4),
                                 shape, *hw)
    g = torch.Generator().manual_seed(6)
    draws = [torch.rand((4,) + shape + (2,), generator=g),
             torch.rand((1,) + shape + (2,), generator=g),
             torch.rand(shape + hw + (2,), generator=g),
             torch.rand((4,) + shape + (2,), generator=g),
             torch.rand(shape + hw + (2,), generator=g)]
    fwd, bwd = smp
    assert fwd.offsets.shape == (5,) + shape + (2,)
    assert bwd.offsets.shape == (4,) + shape + (2,)
    assert torch.equal(fwd.offsets[4], draws[1][0] - 0.5)
    assert torch.equal(fwd.shift, draws[2])
    assert torch.equal(bwd.shift, draws[4])
    for offsets, jitter in ((fwd.offsets[:4], draws[0]),
                            (bwd.offsets, draws[3])):
        cells = torch.tensor([[-0.25, -0.25], [-0.25, 0.25], [0.25, -0.25],
                              [0.25, 0.25]]).reshape(4, 1, 1, 2)
        torch.testing.assert_close(offsets, cells + (jitter - 0.5) * 0.5,
                                   rtol=0, atol=1e-7)
        assert (torch.abs(offsets - cells) <= 0.25).all()


def test_the_loss_threads_its_generator_only_to_renderers_that_take_it():
    def positional(scene, svbrdf):
        return svbrdf

    def keyword(scene, svbrdf, generator=None):
        return svbrdf

    assert losses._render_fn_accepts_generator(pt.make_render_fn())
    assert losses._render_fn_accepts_generator(keyword)
    assert not losses._render_fn_accepts_generator(positional)
    with pytest.raises(TypeError, match="accepts_generator"):
        losses._render_fn_accepts_generator(max)


def test_train_step_matches_jax_with_the_path_tracer():
    """The slice end to end: a depth-5 single-view model with JAX's weights
    (dropout off), a TrainStep over make_loss_fn("mixed", "pathtracing")
    with JAX's scenes and render samples, against jax.value_and_grad of the
    JAX model and losses.mixed_loss over make_render_fn(); loss rtol 1e-4,
    each gradient leaf within 1e-3 normwise (test_torch_step's tolerances:
    the two differ in convolution order)."""
    from tests.test_torch_step import (BATCH, DEPTH, FILTERS, PREP, SIZE as
                                       STEP_SIZE, _assert_grads_match,
                                       _port_model, _raw, _torch_raw)
    from svbrdf_tpu.models import SingleViewModel as JaxSingleViewModel
    from svbrdf_tpu_torch.parallel import step as step_lib

    batch = step_lib.prepare(_torch_raw(_raw()), PREP,
                             torch.Generator().manual_seed(0))
    jmodel = JaxSingleViewModel(use_coords=False, num_filters=FILTERS,
                                depth=DEPTH)
    params = jmodel.init(jax.random.key(0),
                         jnp.zeros((1, 1, STEP_SIZE, STEP_SIZE, 3)))["params"]
    key = jax.random.key(31)
    js, scene = _scenes(key, BATCH)
    samples = _jax_render_samples(_loss_render_key(key), (BATCH, S),
                                  (STEP_SIZE, STEP_SIZE))
    inputs = jnp.asarray(batch["inputs"].numpy())
    target = jnp.asarray(batch["svbrdf"].numpy())
    render_fn = jpt.make_render_fn()

    def loss_of(p):
        pred = jmodel.apply({"params": p}, inputs, deterministic=True)
        return jlosses.mixed_loss(pred, target, key, render_fn=render_fn)

    with jax.default_matmul_precision("highest"):
        ref, grads = jax.value_and_grad(loss_of)(params)

    traced = losses.make_loss_fn("mixed", "pathtracing")

    def loss_fn(pred, target, generator=None, scenes=None):
        return traced(pred, target, generator, scenes=scene, samples=samples)

    model = _port_model(params)
    step = step_lib.make_train_step(
        model, step_lib.make_optimizer(model.parameters(), 1e-5), loss_fn,
        PREP, torch.Generator())
    loss = step.update(batch)
    np.testing.assert_allclose(float(loss), float(ref), rtol=1e-4)
    _assert_grads_match(model, grads)


def test_small_light_matches_point_light(monkeypatch):
    """As the quad shrinks, the estimate tends to the analytic point light
    (the local renderer) times the emitter's cosine (no specular, so the
    two BRDF models agree)."""
    sv = random_svbrdf(np.random.default_rng(1), 8, 8)
    sv[..., 9:12] = 0.0
    cam, light = [0.3, -0.4, 2.0], [0.2, 0.1, 1.8]
    scene = Scene.make(cam, light, [30.0] * 3)
    monkeypatch.setattr(pt, "LIGHT_SIZE", (1e-3, 1e-3))
    ours = pt.render(scene, torch.from_numpy(sv), spp=(16, 8)).numpy()
    analytic = render.render(scene, torch.from_numpy(sv)).numpy()
    coords = render.patch_coords(8, 8).numpy()
    n_l = -np.asarray(light) / np.linalg.norm(light)
    wi = np.asarray(light) - coords
    wi = wi / np.linalg.norm(wi, axis=-1, keepdims=True)
    cos_l = np.clip((-wi * n_l).sum(-1, keepdims=True), 0, None)
    np.testing.assert_allclose(ours, analytic * cos_l, rtol=0.08, atol=1e-4)


def test_smith_g1_matches_exact_beckmann():
    """The rational Smith-Blinn G1 tracks the exact Smith-Beckmann G1 of
    the equivalent width to 0.01 over incidence angles and roughness."""
    from scipy.special import erf

    for r in (0.05, 0.2, 0.6):
        exponent = 2.0 / r - 2.0
        cos_t = torch.linspace(0.05, 0.999, 64)
        ours = pt._blinn_smith_g1(cos_t, torch.tensor(exponent)).numpy()
        c = cos_t.double().numpy()
        a = np.sqrt(0.5 * exponent + 1.0) * c / np.sqrt(1.0 - c ** 2)
        lam = (erf(a) - 1.0) / 2.0 + np.exp(-a * a) / (
            2.0 * a * np.sqrt(np.pi))
        np.testing.assert_allclose(ours, 1.0 / (1.0 + lam), atol=0.01)


def test_stability_script_runs_small():
    """utils/pathtrace_stability at a tiny size on the CPU: a loss for
    every step (N/20 < 1), all finite, finite Adam second moments."""
    from svbrdf_tpu_torch.utils import pathtrace_stability

    record = pathtrace_stability.run(steps=5, batch=2, size=32, depth=5,
                                     num_filters=8, device="cpu")
    assert record["card"] == "cpu" and record["timed_steps"] == 2
    assert [i for i, _ in record["losses"]] == [0, 1, 2, 3, 4]
    assert record["all_finite"] and record["adam_nu_finite"]
    assert record["step_ms"] > 0.0


def test_hold_render_takes_conditioning_and_rejects_the_rest():
    """bench_setup.hold_render: a value off by rel 1e-3 fails unless its
    f32 conditioning (or the reference's own float64 distance) allows it."""
    ref = torch.ones(100)
    ref64 = ref.double()
    bench_setup.hold_render(ref.clone(), ref, ref64, torch.zeros(100))
    off = ref.clone()
    off[3] = 1.001
    with pytest.raises(RuntimeError, match="beyond both tolerances"):
        bench_setup.hold_render(off, ref, ref64, torch.zeros(100))
    bench_setup.hold_render(off, ref, ref64, torch.full((100,), 1e-3))
    far = ref.clone()
    far[:2] = 1.001
    with pytest.raises(RuntimeError):  # 2 % beyond rel 1e-5
        bench_setup.hold_render(far, ref, ref64, torch.full((100,), 1e-3))
