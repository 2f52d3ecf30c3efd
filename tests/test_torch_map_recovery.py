"""The port's map recovery (svbrdf_tpu_torch/experiments/map_recovery.py)
against the JAX package's (svbrdf_tpu/experiments/map_recovery.py), on the
CPU.

Tolerances: the fixed-scene loss exactly 0 for identical maps; with JAX's
scenes, 20 fixed-scene steps at 16^2 (lr 2e-2, the function's default)
give a loss trace within rel 1e-4 and maps within atol 1e-4 (the two
renderers and Adams round differently in f32: torch.optim.Adam divides by
sqrt(nu) / sqrt(bc2) where optax divides nu by bc2 first). Recovering the
diffuse map, 2 of its 768 elements end further apart (6.5e-4, seen on
this test's inputs; 3 elements and 1.1e-2 at lr 5e-2): near convergence a
log-render difference of the L1 loss sits within rounding of 0, where its
gradient takes the sign of the rounding, and Adam's normalized step turns
that into a full step either way. There the maps are held at atol 1e-4
for 99.5 % of the elements and 1e-3 for all; on four more inputs the
port is held to JAX's own spread under a one-ulp change of the target,
and the largest outlier among them is shown to start at a tie. The
flexible-scene recovery
draws its scenes from a torch.Generator (jax.random's stream cannot be
reproduced), so it is held to convergence, as tests/test_map_recovery.py
holds the JAX one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svbrdf_tpu.experiments import map_recovery as jrec
from svbrdf_tpu.ops import sampling as jsampling
from svbrdf_tpu_torch.experiments import map_recovery as rec
from svbrdf_tpu_torch.ops import pathtrace
from svbrdf_tpu_torch.scene import Scene
from tests.test_render import random_svbrdf

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def target():
    return random_svbrdf(np.random.default_rng(0), 16, 16)


def _scenes(js):
    return Scene.make(np.asarray(js.camera_pos), np.asarray(js.light_pos),
                      np.asarray(js.light_color))


def test_fixed_scene_loss_zero_on_identical(target):
    js = jsampling.generate_random_scenes(jax.random.key(0), 4)
    t = torch.from_numpy(target)
    assert float(rec.fixed_scene_rendering_loss(t, t, _scenes(js))) == 0.0
    # A renderer that takes a generator: common random numbers, still 0.
    g = torch.Generator().manual_seed(3)
    loss = rec.fixed_scene_rendering_loss(
        t, t, _scenes(js), pathtrace.make_render_fn((2, 1)), generator=g)
    assert float(loss) == 0.0


def test_fixed_scene_loss_matches_jax(target):
    js = jsampling.generate_specular_scenes(jax.random.key(1), 5)
    pred = random_svbrdf(np.random.default_rng(1), 16, 16)
    ref = float(jrec.fixed_scene_rendering_loss(jnp.asarray(pred),
                                                jnp.asarray(target), js))
    mine = float(rec.fixed_scene_rendering_loss(
        torch.from_numpy(pred), torch.from_numpy(target), _scenes(js)))
    assert mine == pytest.approx(ref, rel=1e-5)


@pytest.mark.parametrize("optimize", [("diffuse",),
                                      ("normals", "roughness", "specular")])
def test_fixed_scene_recovery_matches_jax(target, optimize):
    """20 steps under JAX's 8 specular scenes, lr 2e-2: the loss trace and
    the recovered maps (see the module docstring for the diffuse map)."""
    js = jsampling.generate_specular_scenes(jax.random.key(2), 8)
    ref = jrec.recover_maps(jax.random.key(3), jnp.asarray(target),
                            optimize=optimize, steps=20, scenes=js)
    mine = rec.recover_maps(torch.Generator().manual_seed(3), target,
                            optimize=optimize, steps=20, scenes=_scenes(js),
                            device="cpu")
    assert mine.losses.shape == (20,) and mine.svbrdf.shape == (16, 16, 12)
    np.testing.assert_allclose(mine.losses.numpy(), np.asarray(ref.losses),
                               rtol=1e-4)
    err = np.abs(mine.svbrdf.numpy() - np.asarray(ref.svbrdf))
    if "diffuse" in optimize:
        assert np.mean(err <= 1e-4) >= 0.995 and err.max() <= 1e-3
    else:
        assert err.max() <= 1e-4
    # The maps that were not optimized are the target's.
    for name, sl in (("normals", slice(0, 3)), ("diffuse", slice(3, 6)),
                     ("roughness", slice(6, 9)), ("specular", slice(9, 12))):
        if name not in optimize and name != "normals":
            np.testing.assert_array_equal(mine.svbrdf[..., sl].numpy(),
                                          target[..., sl])


# (target seed, specular scenes key): the first is the input above.
TIE_INPUTS = [(0, 2), (1, 2), (2, 5), (3, 7), (4, 11)]


def _diffuse_run(seed, key, steps, nudge=False):
    """The diffuse recovery of random_svbrdf(seed) under JAX's specular
    scenes of `key`, by JAX and by the port; nudge moves the target up by
    one ulp (JAX's run only)."""
    t = random_svbrdf(np.random.default_rng(seed), 16, 16)
    js = jsampling.generate_specular_scenes(jax.random.key(key), 8)
    jt = np.nextafter(t, np.float32(np.inf)).astype(np.float32) if nudge \
        else t
    ref = jrec.recover_maps(jax.random.key(3), jnp.asarray(jt),
                            optimize=("diffuse",), steps=steps, scenes=js)
    if nudge:
        return t, np.asarray(ref.svbrdf), None
    mine = rec.recover_maps(torch.Generator().manual_seed(3), t,
                            optimize=("diffuse",), steps=steps,
                            scenes=_scenes(js), device="cpu")
    return t, np.asarray(ref.svbrdf), mine.svbrdf.numpy()


@pytest.mark.parametrize("seed,key", TIE_INPUTS)
def test_diffuse_recovery_differs_from_jax_no_more_than_jax_from_itself(
        seed, key):
    """The diffuse maps' outliers are a property of the recovery, not of
    the port: the port's 20-step result differs from JAX's (beyond 1e-4)
    in no more elements than JAX's differs from JAX's own run on the
    target moved by one ulp."""
    _, ref, mine = _diffuse_run(seed, key, 20)
    _, nudged, _ = _diffuse_run(seed, key, 20, nudge=True)
    port = int((np.abs(mine - ref)[..., 3:6] > 1e-4).sum())
    itself = int((np.abs(nudged - ref)[..., 3:6] > 1e-4).sum())
    assert port <= itself, (port, itself)


def test_diffuse_outlier_sits_at_a_tie():
    """The largest outlier of TIE_INPUTS (target seed 3, element (7, 13)
    of the diffuse map's red channel, 2.5e-2 apart after 20 steps): after
    12 steps both runs agree within 2e-6 and both sit within 2e-6 of the
    target, on either side of it, so the L1 gradient's sign at step 13 is
    set by rounding."""
    idx = (7, 13, 3)
    t, ref, mine = _diffuse_run(3, 7, 12)
    assert abs(mine[idx] - ref[idx]) <= 2e-6
    assert abs(ref[idx] - t[idx]) <= 2e-6 and abs(mine[idx] - t[idx]) <= 2e-6
    assert (ref[idx] - t[idx]) * (mine[idx] - t[idx]) < 0
    _, ref, mine = _diffuse_run(3, 7, 20)
    assert abs(mine[idx] - ref[idx]) > 1e-2


def test_diffuse_recovery_converges(target):
    """The flexible-scene variant (fresh scenes every step): 100 steps at
    lr 5e-2, as tests/test_map_recovery.py runs the JAX one."""
    result = rec.recover_maps(torch.Generator().manual_seed(1), target,
                              optimize=("diffuse",), steps=100,
                              learning_rate=5e-2, device="cpu")
    first, last = float(result.losses[0]), float(result.losses[-1])
    assert last < first * 0.3, (first, last)
    d_err = float((result.svbrdf[..., 3:6] - torch.from_numpy(
        target[..., 3:6])).abs().mean())
    assert d_err < 0.12, d_err


def test_path_traced_recovery_threads_a_generator(target):
    """With a renderer that takes a generator, each step renders on fresh
    samples drawn from a per-step generator (so the run is repeatable
    from the seed, and not on the renderer's fixed samples)."""
    fn = pathtrace.make_render_fn((2, 1))
    runs = [rec.recover_maps(torch.Generator().manual_seed(s), target,
                             steps=3, learning_rate=5e-2, render_fn=fn,
                             device="cpu") for s in (4, 4, 5)]
    torch.testing.assert_close(runs[0].losses, runs[1].losses, rtol=0,
                               atol=0)
    assert not torch.equal(runs[0].losses, runs[2].losses)
    assert torch.isfinite(runs[0].svbrdf).all()


def test_device_defaults_to_the_card(target):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rec.recover_maps(torch.Generator(), target, steps=1)
