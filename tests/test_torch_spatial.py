"""Spatial H-sharding in the port (parallel/spatial, training/spatial_loop)
on the CPU over gloo, against the JAX package's spatial entry points
(svbrdf_tpu/parallel/spatial.py on 2- and 4-device meshes of the virtual
CPU devices) and against the unsharded port.

The ranks are spawned processes (bench_setup.rank_runs), every case of one
world in one spawn; the rank functions below import no JAX, and neither
does this module at its top (JAX is imported inside the fixtures), so a
spawned rank that imports this module for them starts quickly. Inputs come
from numpy seeds; JAX's weights cross over through
interop/torch_port.export_torch_state_dict (a fold-upconv model keeps the
4x4 kernels), and JAX runs at highest matmul precision.

Tolerances:
  - the sharded primitives (halo_rows, gather_rows) bit-equal to the
    unsharded op where no sum is involved; every gradient through them
    (and through shard_sum) rtol 1e-6 of the unsharded op's;
  - spatial_rendering_loss against JAX's: the shares' sum rel 5e-5 and the
    gradient atol 2e-5 (tests/test_spatial_sharding.py's);
  - sharded predict against JAX's make_spatial_predict_fn, atol 2e-6
    (that file's inference rule); the multi-view model's, whose f32 maps
    sit further than 2e-6 from float64 even unsharded, against its float64
    forward at twice the unsharded f32 model's distance;
  - train steps against JAX's spatial step (assembled from public pieces,
    dropout off) and, with dropout on or at depth 8, against the port's
    own single-device step: loss rel 5e-5, parameters atol 2e-5 (Adam at
    lr 1e-4), each gradient leaf 1e-3 normwise of JAX's (test_torch_step's
    rule) and 1e-4 of the single device's; the replicas bit-identical. The
    dropout case checks that its first step lies away from the rendering
    loss's kinks (DROPOUT_SEED).
"""

import json
import math
import re

import numpy as np
import pytest
import torch
from torch.nn import functional as F

from svbrdf_tpu_torch import losses
from svbrdf_tpu_torch import main as main_mod
from svbrdf_tpu_torch.models import MultiViewModel, SingleViewModel
from svbrdf_tpu_torch.ops import render_fused
from svbrdf_tpu_torch.parallel import dryrun, mesh, spatial
from svbrdf_tpu_torch.parallel import step as step_lib
from svbrdf_tpu_torch.scene import Scene
from svbrdf_tpu_torch.utils import bench_setup

torch.set_num_threads(1)

WORLDS = (2, 4)
TIMEOUT = 240
SIZE, DEPTH, FILTERS, BATCH = 16, 4, 4, 2
HALOS = ((1, 1), (1, 2), (2, 0))
STEPS = 2
PROGRAM = dict(model_kind="single", loss_kind="mixed", batch=BATCH,
               size=SIZE, depth=DEPTH, num_filters=FILTERS, seed=0,
               device="cpu", learning_rate=1e-4)
# Depth 8 needs 2^8 rows: 256^2 with 2 filters, so that enc8 and dec8 (1
# and 2 rows) run replicated over 2 ranks.
DEEP = dict(PROGRAM, batch=1, size=256, depth=8, num_filters=2)
# The default generators' seed of the dropout case. An f32 comparison of
# two steps holds only away from the rendering loss's kinks, where f32 may
# take either one-sided derivative and Adam turns a flipped sign of a small
# gradient into a full step: under seed 7 the first prediction has one
# pixel 4.4e-8 from a kink (render_fused.kink_distance) and, at world 4,
# that pixel's gradient takes the other side; under seed 8 a pixel lies
# 8.2e-6 from one. The case checks that its first step lies at
# render_fused.KINK_MARGIN or further.
DROPOUT_SEED = 9


def _weights(shape, rank, salt):
    return torch.randn(shape, generator=torch.Generator().manual_seed(
        1000 * salt + rank))


# -- rank functions (run in the spawned ranks) --------------------------


def _primitives_rank(x, group):
    """Each primitive on the rank's rows of `x` (B, C, H, W), a loss of its
    output against the rank's own weights, and the rows' gradient."""
    out = {}
    for above, below in HALOS:
        rows = spatial.take_rows(x, group).clone().requires_grad_()
        y = spatial.halo_rows(rows, above, below, group)
        (y * _weights(y.shape, group.rank, 1)).sum().backward()
        out[("halo", above, below)] = (y.detach(), rows.grad)
    rows = spatial.take_rows(x, group).clone().requires_grad_()
    s = spatial.shard_sum(rows.sum(dim=(2, 3)), group)
    (s * _weights(s.shape, group.rank, 2)).sum().backward()
    out["sum"] = (s.detach(), rows.grad)
    rows = spatial.take_rows(x, group).clone().requires_grad_()
    y = spatial.gather_rows(rows, group)
    (y * _weights(y.shape, group.rank, 3)).sum().backward()
    out["gather"] = (y.detach(), rows.grad)
    return out


def _loss_rank(pred, target, scenes, group):
    """The rank's share of spatial_rendering_loss on its rows of pred and
    target (NHWC), and its rows' gradient."""
    rows = spatial.take_rows(pred, group, 1).clone().requires_grad_()
    share = spatial.spatial_rendering_loss(
        rows, spatial.take_rows(target, group, 1), group, scenes=scenes)
    share.backward()
    return {"share": share.detach(), "grad": rows.grad}


def _predict_rank(models, group):
    """Sharded predict of each (model class, state, images): the rank's
    rows, and the maps gathered on rank 0."""
    out = []
    for cls, state, images in models:
        model = cls(FILTERS, DEPTH, device="cpu")
        model.load_state_dict(state, strict=True)
        rows = spatial.make_spatial_predict_fn(model, group)(images)
        out.append((rows, spatial.gather_maps(rows, group)))
    return out


def _eval_rank(program, group):
    """The spatial eval step's loss on the program's raw batch."""
    prog = bench_setup.build_program(**program, space=group)
    return float(prog.eval_step(prog.raw))


# -- fixtures -----------------------------------------------------------


@pytest.fixture(scope="module")
def inputs():
    """Every case's inputs, made from numpy seeds, and JAX's results on a
    2- and a 4-device mesh."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from svbrdf_tpu import losses as jlosses
    from svbrdf_tpu.interop.torch_port import export_torch_state_dict
    from svbrdf_tpu.models import SingleViewModel as JaxSingleViewModel
    from svbrdf_tpu.ops import sampling as jsampling
    from svbrdf_tpu.parallel import spatial as jspatial
    from tests.test_render import random_svbrdf

    def port_scene(js):
        return Scene.make(*[np.asarray(f) for f in (
            js.camera_pos, js.light_pos, js.light_color)])

    def state_of(params):
        return {k: torch.from_numpy(np.array(v)) for k, v in
                export_torch_state_dict(jax.tree.map(np.asarray,
                                                     params)).items()}

    rng = np.random.default_rng(3)
    pred = random_svbrdf(rng, 32, 32, batch=(2,))
    target = random_svbrdf(rng, 32, 32, batch=(2,))
    loss_key = jax.random.key(4)
    jmodel = JaxSingleViewModel(num_filters=FILTERS, depth=DEPTH,
                                upconv="fold")
    params = jmodel.init(jax.random.key(0),
                         jnp.zeros((1, 1, SIZE, SIZE, 3)))["params"]
    images = rng.uniform(0, 1, (BATCH, 1, SIZE, SIZE, 3)).astype(np.float32)
    batch = {"inputs": rng.uniform(0, 1, (BATCH, 1, SIZE, SIZE, 3)).astype(
        np.float32), "svbrdf": random_svbrdf(rng, SIZE, SIZE, batch=(BATCH,))}
    step_keys = [jax.random.key(10 + k) for k in range(STEPS)]
    optimizer = optax.adam(1e-4)
    multi = MultiViewModel(FILTERS, DEPTH, device="cpu", seed=1)
    multi_images = torch.from_numpy(rng.uniform(
        0, 1, (BATCH, 3, SIZE, SIZE, 3)).astype(np.float32))

    out = {"x": torch.from_numpy(rng.standard_normal(
               (2, 3, 16, 5)).astype(np.float32)),
           "pred": torch.from_numpy(pred),
           "target": torch.from_numpy(target),
           "scenes": port_scene(jsampling.generate_loss_scenes(
               loss_key, 2, 3, 6)),
           "state": state_of(params), "images": torch.from_numpy(images),
           "batch": {k: torch.from_numpy(v) for k, v in batch.items()},
           "step_scenes": [port_scene(jsampling.generate_loss_scenes(
               k, BATCH, 3, 6)) for k in step_keys],
           "multi_state": multi.state_dict(), "multi_images": multi_images,
           "jax": {}}
    with jax.default_matmul_precision("highest"):
        for world in WORLDS:
            mesh = jspatial.make_spatial_mesh(n_devices=world)
            with mesh:
                value, grad = jax.jit(jax.value_and_grad(
                    lambda p: jspatial.spatial_rendering_loss(
                        p, target, loss_key, mesh)))(pred)
            maps = jspatial.make_spatial_predict_fn(jmodel, mesh)(
                params, images)
            repl = NamedSharding(mesh, P())
            shardings = {"inputs": NamedSharding(mesh, P(None, None,
                                                          "space")),
                         "svbrdf": NamedSharding(mesh, P(None, "space"))}

            def step(p, s, b, key, mesh=mesh):
                def loss_of(q):
                    m = jmodel.apply({"params": q}, b["inputs"],
                                     deterministic=True)
                    return (0.1 * jlosses.svbrdf_l1_loss(m, b["svbrdf"])
                            + jspatial.spatial_rendering_loss(
                                m, b["svbrdf"], key, mesh))

                loss, grads = jax.value_and_grad(loss_of)(p)
                updates, s = optimizer.update(grads, s, p)
                return optax.apply_updates(p, updates), s, loss, grads

            step = jax.jit(step, in_shardings=(repl, repl, shardings, repl),
                           out_shardings=(repl, repl, repl, repl))
            p, s, step_losses = params, optimizer.init(params), []
            for key in step_keys:
                p, s, loss, grads = step(p, s, batch, key)
                step_losses.append(float(loss))
            out["jax"][world] = {
                "loss": float(value), "grad": np.asarray(grad),
                "maps": np.asarray(maps), "losses": step_losses,
                "params": state_of(p), "grads": state_of(grads)}
    return out


def _jobs(inputs, world):
    jax_state = inputs["state"]
    jobs = [(_primitives_rank, (inputs["x"],), {}),
            (_loss_rank, (inputs["pred"], inputs["target"],
                          inputs["scenes"]), {}),
            (_predict_rank, ([(SingleViewModel, jax_state,
                               inputs["images"]),
                              (MultiViewModel, inputs["multi_state"],
                               inputs["multi_images"])],), {}),
            (bench_setup.spatial_train_steps, (PROGRAM, STEPS),
             dict(state=jax_state, batch=inputs["batch"],
                  scenes=inputs["step_scenes"], grads=True)),
            (bench_setup.spatial_train_steps, (PROGRAM, 3),
             dict(dropout_seed=DROPOUT_SEED, grads=True)),
            (_eval_rank, (PROGRAM,), {})]
    if world == 2:
        jobs.append((bench_setup.spatial_train_steps, (DEEP, STEPS),
                     dict(grads=True)))
    return jobs


JOBS = ("primitives", "loss", "predict", "jax_step", "dropout", "eval",
        "deep")


@pytest.fixture(scope="module")
def ranks(inputs):
    """Every case's results, rank by rank, for each world: one spawn a
    world."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        return {world: dict(zip(JOBS, bench_setup.rank_runs(
            world, _jobs(inputs, world), "cpu", timeout=TIMEOUT)))
            for world in WORLDS}


def _rows_of(x, world, rank, dim=2):
    n = x.shape[dim] // world
    return x.narrow(dim, rank * n, n)


def _normwise(a, b) -> float:
    return float((a - b).norm() / b.norm())


def _float64_forward(model, images):
    """The model's forward in float64 (the model is raised in place):
    every layer's compute dtype and the f32 casts of its statistics and
    head raised to float64."""
    model = model.double()
    for module in model.modules():
        if hasattr(module, "compute_dtype"):
            module.compute_dtype = torch.float64
    with pytest.MonkeyPatch.context() as mp, torch.no_grad():
        mp.setattr(torch.Tensor, "float",
                   lambda self, *a, **k: self.to(torch.float64))
        return model(images.double())


# -- the cases ----------------------------------------------------------


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("halo", HALOS)
def test_halo_rows_match_the_zero_padded_op(inputs, ranks, world, halo):
    """halo_rows: each rank's rows with its neighbours' equal the rows of
    the zero-padded whole, bit for bit; the gradient (every rank's loss
    against its own weights) equals the unsharded op's."""
    above, below = halo
    x = inputs["x"].clone().requires_grad_()
    padded = F.pad(x, (0, 0, above, below))
    n = x.shape[2] // world
    total = 0.0
    for rank, result in enumerate(ranks[world]["primitives"]):
        y, _ = result[("halo", above, below)]
        ref = padded[:, :, rank * n:rank * n + n + above + below]
        assert torch.equal(y, ref.detach())
        total = total + (ref * _weights(ref.shape, rank, 1)).sum()
    total.backward()
    grads = torch.cat([r[("halo", above, below)][1]
                       for r in ranks[world]["primitives"]], dim=2)
    torch.testing.assert_close(grads, x.grad, rtol=1e-6, atol=0)


@pytest.mark.parametrize("world", WORLDS)
def test_shard_sum_and_gather_rows_match_the_whole(inputs, ranks, world):
    """shard_sum: the sum over the whole height (rtol 1e-6: another
    order), gather_rows: the whole tensor bit for bit; both gradients
    equal the unsharded op's."""
    x = inputs["x"].clone().requires_grad_()
    results = ranks[world]["primitives"]
    whole = x.sum(dim=(2, 3))
    total = 0.0
    for rank, r in enumerate(results):
        torch.testing.assert_close(r["sum"][0], whole.detach(), rtol=1e-6,
                                   atol=1e-6)
        assert torch.equal(r["gather"][0], x.detach())
        total = total + (whole * _weights(whole.shape, rank, 2)).sum()
        total = total + (x * _weights(x.shape, rank, 3)).sum()
    total.backward()
    grads = sum(torch.cat([r[k][1] for r in results], dim=2)
                for k in ("sum", "gather"))
    torch.testing.assert_close(grads, x.grad, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("world", WORLDS)
def test_spatial_rendering_loss_matches_jax(inputs, ranks, world):
    """The shares' sum and the gathered gradient against JAX's
    spatial_rendering_loss on a mesh of as many devices, same scenes."""
    ref = inputs["jax"][world]
    results = ranks[world]["loss"]
    value = sum(float(r["share"]) for r in results)
    assert abs(value - ref["loss"]) <= 5e-5 * abs(ref["loss"])
    grad = torch.cat([r["grad"] for r in results], dim=1).numpy()
    np.testing.assert_allclose(grad, ref["grad"], atol=2e-5)
    # A share is the rank's rows' part, not the whole loss.
    assert all(abs(float(r["share"])) < abs(value) for r in results)


@pytest.mark.parametrize("world", WORLDS)
def test_spatial_predict_matches_jax_and_the_unsharded_model(inputs, ranks,
                                                             world):
    """The single-view model's sharded predict against JAX's
    make_spatial_predict_fn (depth 4, 16^2, 4 filters); the multi-view
    model's against the unsharded port's forward in float64; the rows
    gathered on rank 0 are the ranks' rows."""
    results = ranks[world]["predict"]
    (single_rows, single), (multi_rows, multi) = results[0]
    for rank, ((s_rows, s_whole), (m_rows, m_whole)) in enumerate(results):
        assert s_rows.shape == (BATCH, SIZE // world, SIZE, 12)
        if rank:
            assert s_whole is None and m_whole is None
    assert torch.equal(single, torch.cat([r[0][0] for r in results], 1))
    assert torch.equal(multi, torch.cat([r[1][0] for r in results], 1))
    np.testing.assert_allclose(single.numpy(), inputs["jax"][world]["maps"],
                               atol=2e-6)
    model = MultiViewModel(FILTERS, DEPTH, device="cpu")
    model.load_state_dict(inputs["multi_state"], strict=True)
    model.eval()
    with torch.no_grad():
        ref = model(inputs["multi_images"])
    exact = _float64_forward(model, inputs["multi_images"])
    # The multi-view model's own f32 error is above 2e-6 (its unsharded
    # maps sit 1.8e-6 to 6.5e-6 from float64 on six seeds): the sharded
    # maps are held to float64 at twice the unsharded model's distance.
    own = float((ref.double() - exact).abs().max())
    assert float((multi.double() - exact).abs().max()) <= 2 * own


def _hold_step(run, losses, params, grads, grad_tol):
    assert len(set(run["checksums"])) == 1
    np.testing.assert_allclose(run["losses"], losses, rtol=5e-5)
    for mine, ref in zip(run["params"], params):
        torch.testing.assert_close(mine, ref, atol=2e-5, rtol=0)
    for mine, ref in zip(run["grads"], grads):
        if mine is None or ref is None or not ref.norm():
            # A parameter the forward never reads.
            assert mine is None and (ref is None or not ref.norm())
            continue
        assert _normwise(mine, ref) <= grad_tol


@pytest.mark.parametrize("world", WORLDS)
def test_spatial_train_step_matches_jax(inputs, ranks, world):
    """Two spatial steps with JAX's weights, batch and scenes against
    JAX's spatial step (model.apply deterministic, svbrdf_l1_loss +
    spatial_rendering_loss, optax.adam at lr 1e-4, jitted under the space
    shardings), dropout off: losses, parameters, the last step's
    gradients."""
    run = ranks[world]["jax_step"][0]
    ref = inputs["jax"][world]
    model = SingleViewModel(FILTERS, DEPTH, device="cpu")
    keys = list(model.state_dict())
    _hold_step(run, ref["losses"], [ref["params"][k] for k in keys],
               [ref["grads"][k] for k in keys], 1e-3)
    assert run["launches"][0]["render_fwdgrad"] == 0  # the CPU's plain path
    assert len(set(run["losses"])) == STEPS


def _single_device(program, steps, **kwargs):
    return bench_setup.train_steps(program, steps, grads=True, **kwargs)


def _first_step_kink_distance(program, dropout_seed) -> float:
    """How far the single device's first prediction (dropout on, the
    default generators seeded with `dropout_seed`, as train_steps runs it)
    lies from the rendering loss's kinks under the step's own scenes, in
    float64 (render_fused.kink_distance)."""
    torch.manual_seed(dropout_seed)
    prog = bench_setup.build_program(**program)
    step = prog.train_step
    batch, span = step_lib.prepare_rows(prog.raw, prog.prep, prog.generator)
    with torch.no_grad():
        pred = step.forward(batch["inputs"])
    scenes = losses.draw_loss_inputs(step.loss_fn, span[2], SIZE, SIZE,
                                     prog.generator, pred.device, None,
                                     None)["scenes"]
    return float(render_fused.kink_distance(
        losses.to_planes(pred).double(),
        losses.to_planes(batch["svbrdf"]).double(),
        render_fused.pack_scenes(scenes).double()).min())


@pytest.mark.parametrize("world", WORLDS)
def test_spatial_step_with_dropout_is_the_single_devices(ranks, world):
    """Three spatial steps with dropout on, the default generators seeded
    alike, against the port's single-device step: the ranks draw the masks
    one device draws."""
    assert _first_step_kink_distance(PROGRAM, DROPOUT_SEED) >= (
        render_fused.KINK_MARGIN)
    run = ranks[world]["dropout"][0]
    one = _single_device(PROGRAM, 3, dropout_seed=DROPOUT_SEED)
    _hold_step(run, one["losses"], one["params"], one["grads"], 1e-4)
    off = _single_device(PROGRAM, 1)
    assert off["losses"][0] != run["losses"][0]  # dropout did draw


@pytest.mark.parametrize("world", WORLDS)
def test_spatial_eval_step_is_the_single_devices(ranks, world):
    """The spatial eval step (every rank returns the group's loss) against
    the unsharded eval step on the same raw batch and draws."""
    one = bench_setup.build_program(**PROGRAM)
    ref = float(one.eval_step(one.raw))
    values = ranks[world]["eval"]
    assert len(set(values)) == 1
    assert abs(values[0] - ref) <= 5e-5 * abs(ref)


def test_depth_eight_replicates_the_short_levels(ranks):
    """Depth 8 at 256^2 over 2 ranks: enc8 and dec8 (1 and 2 rows) and the
    global track run replicated, each rank's share of their gradients
    summed with the rest; against the unsharded step."""
    run = ranks[2]["deep"][0]
    one = _single_device(DEEP, STEPS)
    _hold_step(run, one["losses"], one["params"], one["grads"], 1e-4)
    group = mesh.DataGroup(2, 0, 0, torch.device("cpu"), "gloo", 1, None,
                           mesh.COLLECTIVE_TIMEOUT)
    assert spatial.splits(2, group) and not spatial.splits(1, group)


def _meta(model_dir):
    blob = torch.load(model_dir / "checkpoint.tar", map_location="cpu",
                      weights_only=True)
    return blob["upconv"], blob["master_dtype"], blob["epoch"]


def test_cli_trains_resumes_and_tests_spatially(tmp_path, capfd,
                                                monkeypatch):
    """`--shard-spatial 2 --gpu-id -1` through main: two ranks train 1
    epoch on 101 maps-only 16^2 strips (13 steps of 8, the last
    wrap-padded; 1 held out), validate, checkpoint (upconv 'fold',
    master_dtype 'f32'), resume to 2 epochs, then test mode."""
    from tests.test_torch_cli import _maps_only

    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    data = _maps_only(tmp_path / "maps", 101)
    model_dir = tmp_path / "model"
    base = ["--mode", "train", "--input-dir", data, "--image-count", "0",
            "--used-image-count", "1", "--image-size", str(SIZE),
            "--model-depth", str(DEPTH), "--num-filters", str(FILTERS),
            "--batch-size", "8", "--save-frequency", "1",
            "--validation-frequency", "1", "--model-dir", str(model_dir),
            "--gpu-id", "-1", "--shard-spatial", "2"]
    assert main_mod.main(base + ["--epochs", "1", "--retrain"]) is None
    first = capfd.readouterr().out
    assert _meta(model_dir) == ("fold", "f32", 0)
    main_mod.main(base + ["--epochs", "2"])
    second = capfd.readouterr().out
    assert _meta(model_dir) == ("fold", "f32", 1)
    for out, epoch in ((first, 0), (second, 1)):
        assert out.count("Spatial group: H split over 2 rank(s) over "
                         "gloo") == 2
        # Both ranks print to one stream, a line's text and its newline in
        # two writes: a value is read by its format, not up to a space.
        losses = [float(v) for v in re.findall(
            rf"Epoch {epoch}, Batch \d+, loss: (-?\d+\.\d{{6}}|-?nan|-?inf)",
            out)]
        assert len(losses) == 2 * 13 and all(map(math.isfinite, losses))
        assert out.count(f"Epoch {epoch}, validation loss:") == 2
    assert "Restored epoch 0" in second
    written = main_mod.main(["--mode", "test", "--input-dir", data,
                             "--image-count", "0", "--image-size",
                             str(SIZE), "--model-dir", str(model_dir),
                             "--gpu-id", "-1"])
    assert len(written) == 101
    metrics = json.loads((model_dir / "test_outputs"
                          / "metrics.json").read_text())
    assert math.isfinite(metrics["mean"]["rendering_rmse"])


def test_spatial_dryrun_runs_on_two_ranks(monkeypatch, capfd):
    """dryrun.run_spatial(2, 'cpu'): one spatial step in two gloo ranks, a
    finite loss and replicas bit-identical; without 'cpu' it needs a card
    a rank and raises here before a rank starts."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    assert math.isfinite(dryrun.run_spatial(2, "cpu", timeout=TIMEOUT))
    out = capfd.readouterr().out
    assert out.count("spatial (H split over 2 ranks") == 2
    assert "replicas bit-identical" in out
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="2-device group but only 1 cuda"):
        dryrun.run_spatial(2)


def test_training_world_takes_the_spatial_ranks(monkeypatch):
    """--shard-spatial N takes N ranks ahead of --num-devices, and more
    than the visible cards raises."""
    from svbrdf_tpu_torch.cli import parse_args
    from svbrdf_tpu_torch.training import loop

    args = parse_args(["--mode", "train", "--input-dir", "x",
                       "--image-count", "0", "--model-dir", "m",
                       "--shard-spatial", "4", "--num-devices", "2",
                       "--batch-size", "3"])
    assert loop.training_world(args, "cpu") == 4
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(ValueError, match="4-device group but only 2 cuda"):
        loop.training_world(args, "cuda")
    with pytest.raises(ValueError, match="needs a rendering-based loss"):
        spatial.make_spatial_loss_fn("l1", None)
