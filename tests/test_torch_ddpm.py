"""The DDPM U-Net (models/ddpm_unet), its train step
(parallel/step.DiffusionTrainStep), DDIM and its CLI and estimator paths,
against the benchmark's plain reference (bench_gpu/reference/ddpm.py), on
the reference's seeded weights at a small size on the CPU: ch 32,
ch_mult (1, 2, 2), 1 res block, attention at 8^2, 32^2, batch 2, and 8
GroupNorm groups (at 32 groups the first level's groups hold one channel
each, which cancels every per-channel shift before a norm, so the
gradients of those biases and time projections are round-off alone).

Tolerances: both sides compute in f32 on the CPU, the same sums in other
forms (the program's attention through scaled_dot_product_attention, the
reference's as two einsums and a softmax; the up-sampling copy by
interpolate against repeat_interleave), so they differ by f32 rounding
alone: measured 6e-7 normwise on the noise, up to 2e-6 on the gradients.
The step runs the program's SR-Adam in its 'bf16sr' state with f32
masters, which is the reference's Adam with the same dither salts, so the
updates agree to the rounding of their inputs. Each limit leaves ten
times the measured gap or more; the reference's convs and dense layers
computed in bf16 read 1e-3 and more on the same numbers, above every
limit.
"""

import os

import numpy as np
import pytest
import torch

from bench_gpu import corpus
from bench_gpu.counts import ddpm_flops
from bench_gpu.reference import ddpm as ref
from bench_gpu.reference import maps as ref_maps
from bench_gpu.reference.adam import stream_seed
from svbrdf_tpu_torch import main as main_mod
from svbrdf_tpu_torch.estimator import SvbrdfEstimator
from svbrdf_tpu_torch.models import build_model, ddpm_unet
from svbrdf_tpu_torch.models.single_view import decode_head
from svbrdf_tpu_torch.ops import codecs
from svbrdf_tpu_torch.parallel import step as step_lib
from svbrdf_tpu_torch.utils import bench_setup

torch.set_num_threads(1)

SIZES = dict(ch=32, ch_mult=(1, 2, 2), num_res_blocks=1,
             attn_resolutions=(8,), resolution=32, groups=8)
CFG = dict(SIZES, eps=1e-6, timesteps=1000, beta_start=1e-4,
           beta_end=0.02, learning_rate=2e-5, grad_clip=1.0,
           ema_decay=0.9999, used_image_count=1, dtype="float32",
           master_dtype="f32", image_size=32, batch_size=2)
PREP = step_lib.PrepConfig(used_input_image_count=1, use_augmentation=True,
                           mix_materials=True)
SEED, STEPS = 2 ** 31 + 11, 3


def _rel(a, b):
    return float((a - b).detach().norm() / b.norm())


@pytest.fixture(scope="module")
def case():
    """Seeded weights, a corpus of 6 maps-only strips and 3 raw batches
    (rows and mixing partners drawn from the corpus)."""
    rng = np.random.default_rng(4)
    strips = np.stack([corpus.material(rng, 32) for _ in range(6)])
    maps_u8 = corpus.strips_to_maps(strips)
    raws = []
    for k in range(STEPS):
        own, partner = rng.choice(6, 2), rng.choice(6, 2)
        raws.append({"inputs": np.zeros((2, 0, 32, 32, 3), np.uint8),
                     "svbrdf": maps_u8[own],
                     "partner_svbrdf": maps_u8[partner]})
    return dict(weights=ref.make_weights(CFG, 5, "cpu"), strips=strips,
                raws=raws)


def _step(weights, group=None):
    model = build_model("diffusion", device="cpu", **SIZES)
    model.load_state_dict(weights, strict=True)
    opt = step_lib.make_optimizer(model.parameters(), CFG["learning_rate"],
                                  torch.float32, state_precision="bf16sr")
    gen = torch.Generator()
    return step_lib.DiffusionTrainStep(model, opt, PREP, gen, seed=SEED,
                                       group=group)


def _tensors(raw):
    return {k: torch.from_numpy(v) for k, v in raw.items()}


def _program(case, steps):
    """The program's `steps` steps: (losses, first clipped gradients by
    name, leaves after, EMA after)."""
    step = _step(case["weights"])
    losses, first = [], None
    for k in range(steps):
        step.generator.manual_seed(stream_seed(SEED, k + 1))
        losses.append(float(step(_tensors(case["raws"][k]), step=k + 1)))
        if k == 0:
            first = {n: p.grad.clone()
                     for n, p in step.model.named_parameters()}
    return (losses, first, dict(step.model.named_parameters()),
            step.ema_state())


def _reference(case, steps):
    cell = {"config": CFG}
    out, unmatched = ref.train_steps(cell, SEED, case["strips"],
                                     case["raws"][:steps], "cpu",
                                     made=case["weights"], keep=True)
    assert unmatched == 0
    return out


def _leaf_gaps(got: dict, want: dict) -> dict:
    """Per leaf, ||got - want|| over the larger of the reference leaf's
    norm and the median leaf's (a leaf whose gradient is zero in exact
    arithmetic, such as an attention key's bias, is held to the scale of
    the others)."""
    med = float(np.median([float(w.norm()) for w in want.values()]))
    return {n: float((got[n] - w).norm()) / max(float(w.norm()), med)
            for n, w in want.items()}


def test_forward_matches_the_reference(case):
    model = build_model("diffusion", device="cpu", **SIZES)
    model.load_state_dict(case["weights"], strict=True)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 12, 32, 32, generator=gen)
    t = torch.tensor([3, 917])
    got = model(x, t)
    want = ref.unet(case["weights"], x, t, CFG)
    assert got.shape == (2, 9, 32, 32)
    # f32 rounding of two forms of the same sums (6e-7 measured).
    assert _rel(got, want) < 1e-5


@pytest.mark.parametrize("steps", [1, STEPS])
def test_train_steps_match_the_reference(case, steps):
    losses, first, params, ema = _program(case, steps)
    want = _reference(case, steps)
    # The loss: f32 rounding of the same sums (measured 1e-7).
    np.testing.assert_allclose(losses, want["losses"], rtol=1e-5)
    # Each leaf's first (clipped) gradient, as a tensor (measured 2e-6).
    assert max(_leaf_gaps(first, want["first_grads"]).values()) < 1e-4
    # The update and the EMA: each leaf's change, as a tensor, over the
    # leaves whose gradient is more than round-off (an attention key's
    # bias has none in exact arithmetic: softmax ignores a shift). Adam's
    # first steps are about lr sign(g), so an element whose gradient is
    # near 0 flips with the rounding of g: the median leaf's gap is held
    # tight, the worst leaf's loosely.
    norms = {n: float(g.norm()) for n, g in want["first_grads"].items()}
    med = float(np.median(list(norms.values())))
    w0 = {n: w for n, w in case["weights"].items() if norms[n] > 1e-3 * med}
    change = _leaf_gaps({n: params[n].detach() - w0[n] for n in w0},
                        {n: want["params"][n] - w0[n] for n in w0})
    assert np.median(list(change.values())) < 1e-3
    assert max(change.values()) < 0.1
    ema = _leaf_gaps({n: ema[n] - w0[n] for n in w0},
                     {n: want["ema"][n] - w0[n] for n in w0})
    assert np.median(list(ema.values())) < 1e-3


def test_bf16_reference_is_outside_the_limits(case):
    """The same step with the reference's convs and dense layers in bf16
    misses the tolerances above."""
    _, first, _, _ = _program(case, 1)
    low, _ = ref.train_steps({"config": CFG}, SEED, case["strips"],
                             case["raws"][:1], "cpu",
                             quant=lambda t: t.to(torch.bfloat16).float(),
                             made=case["weights"], keep=True)
    assert max(_leaf_gaps(first, low["first_grads"]).values()) > 1e-3


def test_draws_repeat_and_equal_the_reference(case):
    raw = _tensors(case["raws"][0])
    runs = []
    for _ in range(2):
        gen = torch.Generator().manual_seed(stream_seed(SEED, 1))
        batch, span = step_lib.prepare_rows(raw, PREP, gen)
        runs.append((batch["svbrdf"],) + step_lib.diffusion_draws(
            span, 32, 32, gen, "cpu"))
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    gen = torch.Generator().manual_seed(stream_seed(SEED, 1))
    _, target = ref_maps.prepare(raw["svbrdf"], raw["partner_svbrdf"], 1, gen)
    t, eps = ref.draws((2, 9, 32, 32), 1000, gen)
    assert torch.equal(runs[0][1], t) and torch.equal(runs[0][2], eps)
    torch.testing.assert_close(runs[0][0], target, rtol=0, atol=1e-6)
    # The encoding is the reference's, and decode_head inverts it.
    x0 = codecs.encode_svbrdf(target)
    torch.testing.assert_close(x0.permute(0, 3, 1, 2), ref.encode(target))
    x9 = torch.rand(2, 4, 4, 9) * 1.8 - 0.9
    torch.testing.assert_close(codecs.encode_svbrdf(decode_head(x9)), x9,
                               rtol=0, atol=1e-5)


def test_ddim_matches_the_reference(case):
    model = build_model("diffusion", device="cpu", **SIZES)
    model.load_state_dict(case["weights"], strict=True)
    photos = torch.rand(2, 1, 32, 32, 3, generator=torch.Generator(
        ).manual_seed(8))
    got = ddpm_unet.ddim_sample(model, photos, ddpm_unet.alphas_cumprod(), 4,
                                torch.Generator().manual_seed(3))
    x_t = torch.randn((2, 9, 32, 32), generator=torch.Generator(
        ).manual_seed(3))
    want = ref.ddim(case["weights"], photos, CFG, 4, x_t)
    # Four forwards' f32 rounding through the sampler's divisions by
    # sqrt(abar_t) (measured 1e-6).
    assert _rel(got, want) < 1e-4
    # The estimator: 50 steps from seed 3, decoded as the single-view
    # head decodes (fifty forwards' rounding, measured 1e-6 on the maps).
    maps = SvbrdfEstimator(model).predict(photos[:, 0], seed=3)
    want = ref.ddim(case["weights"], photos, CFG, 50, x_t)
    want_maps = decode_head(want.clamp(-1, 1).permute(0, 2, 3, 1))
    np.testing.assert_allclose(maps, want_maps.numpy(), rtol=0, atol=1e-4)


def _rank_draws_and_step(raws, weights, group=None):
    """The rank's rows of the first step's draws and of a DP step's loss and
    leaves after two steps (module-level: the spawned ranks import it)."""
    step = _step(weights, group)
    rows = slice(None) if group is None else group.rows(2)
    out = {"losses": []}
    for k, raw in enumerate(raws[:2]):
        mine = {key: torch.from_numpy(v[rows]) for key, v in raw.items()}
        step.generator.manual_seed(stream_seed(SEED, k + 1))
        if k == 0:
            batch, span = step_lib.prepare_rows(mine, PREP, step.generator,
                                                group)
            out["draws"] = step_lib.diffusion_draws(span, 32, 32,
                                                    step.generator, "cpu")
            step.generator.manual_seed(stream_seed(SEED, k + 1))
        out["losses"].append(float(step(mine, step=k + 1)))
    out["leaves"] = {n: p.detach().clone()
                     for n, p in step.model.named_parameters()}
    out["ema"] = step.ema_state()
    return out


def test_data_parallel_rows_equal_world_one(case):
    one = _rank_draws_and_step(case["raws"], case["weights"])
    (ranks,) = bench_setup.rank_runs(
        2, [(_rank_draws_and_step, (case["raws"], case["weights"]), {})],
        "cpu", timeout=300)
    for r, got in enumerate(ranks):
        # The rank's rows of the global batch's draws, exactly.
        assert torch.equal(got["draws"][0], one["draws"][0][r:r + 1])
        assert torch.equal(got["draws"][1], one["draws"][1][r:r + 1])
        # The group's mean loss and replicas: world 1's step, the order of
        # the gradient reduction aside (f32 rounding; measured 1e-7).
        np.testing.assert_allclose(got["losses"], one["losses"], rtol=1e-5)
        gaps = _leaf_gaps(got["leaves"], one["leaves"])
        assert max(gaps.values()) < 1e-5
    for n in one["leaves"]:
        assert torch.equal(ranks[0]["leaves"][n], ranks[1]["leaves"][n])
        assert torch.equal(ranks[0]["ema"][n], ranks[1]["ema"][n])


def test_published_widths_count_the_reference_and_the_plan():
    model = build_model("diffusion", device="meta")
    n = sum(p.numel() for p in model.parameters())
    published = dict(ddpm_unet.PUBLISHED, batch_size=8)
    assert n == 113_690_505
    assert n == sum(int(np.prod(s)) for _, s, _ in ref.param_spec(published))
    assert n == ddpm_flops.parameter_count(published)
    # 499 GFLOP a sample's forward; a step of 8 about 12.0 TFLOP.
    assert round(ddpm_flops.forward_flops(published) / 1e9) == 499
    assert round(ddpm_flops.train_step_flops(published) / 1e12, 1) == 12.0


def _maps_only(directory, count):
    """`count` maps-only 32^2 strips: up to 8 seeded ones, then links."""
    corpus.write_strips(str(directory), min(count, 8), 32, 21)
    for n in range(8, count):
        (directory / f"link_{n:03d}.png").symlink_to(
            directory / f"strip_{n % 8:04d}.png")
    return str(directory)


def test_cli_trains_resumes_and_tests(tmp_path, monkeypatch):
    published = ddpm_unet.PUBLISHED
    monkeypatch.setattr(ddpm_unet, "PUBLISHED", {**published, **{
        k: v for k, v in SIZES.items() if k != "resolution"}})
    data = _maps_only(tmp_path / "maps", 101)
    model_dir = tmp_path / "model"
    argv = ["--mode", "train", "--input-dir", data, "--image-count", "0",
            "--image-size", "32", "--model-type", "diffusion",
            "--batch-size", "8", "--learning-rate", "2e-5",
            "--save-frequency", "1", "--validation-frequency", "1",
            "--model-dir", str(model_dir), "--gpu-id", "-1"]
    first = main_mod.main(argv + ["--epochs", "2", "--retrain"])
    # 100 training samples, batch 8: 13 steps an epoch; 1 held out.
    assert first.steps == 26 and first.validation_batches == 2
    assert isinstance(first.model, ddpm_unet.DDPMUNet)
    blob = torch.load(model_dir / "checkpoint.tar", weights_only=True)
    assert blob["model_type"] == "diffusion"
    assert list(blob["sizes"]["ch_mult"]) == [1, 2, 2]
    ema = blob["ema_state_dict"]
    assert set(ema) == set(dict(first.model.named_parameters()))
    # The EMA left the weights it started from (the CLI's seed-313 init).
    w0 = build_model("diffusion", device="cpu", seed=313,
                     **SIZES).state_dict()
    assert max(float((ema[n] - w0[n]).abs().max()) for n in w0) > 0
    # The resumed run takes the checkpoint's widths, not the published
    # ones, and goes on from its EMA.
    monkeypatch.setattr(ddpm_unet, "PUBLISHED", published)
    resumed = main_mod.main(argv + ["--epochs", "3"])
    # The first run saved epoch 1; the resumed one trains epochs 1 and 2.
    assert resumed.steps == 26
    assert resumed.model.sizes["ch"] == 32
    blob = torch.load(model_dir / "checkpoint.tar", weights_only=True)
    assert blob["epoch"] == 2
    ema2 = blob["ema_state_dict"]
    assert sum(float((ema2[n] - ema[n]).abs().sum()) for n in ema) > 0
    # Test mode writes a grid a sample, from the EMA by DDIM.
    tests = _maps_only(tmp_path / "test", 2)
    written = main_mod.main(["--mode", "test", "--input-dir", tests,
                             "--image-count", "0", "--image-size", "32",
                             "--model-dir", str(model_dir), "--gpu-id",
                             "-1"])
    assert len(written) == 2 and all(os.path.exists(p) for p in written)
    assert os.path.exists(os.path.join(os.path.dirname(written[0]),
                                       "metrics.json"))
    # The estimator restores the EMA and predicts by DDIM.
    est = SvbrdfEstimator.from_checkpoint(model_dir, device="cpu")
    assert isinstance(est.model, ddpm_unet.DDPMUNet) and est.iterative
    for n, p in est.model.named_parameters():
        assert torch.equal(p.detach(), ema2[n])
    maps = est.predict(np.full((1, 32, 32, 3), 0.3, np.float32))
    assert maps.shape == (1, 32, 32, 12) and np.isfinite(maps).all()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the step's CUDA graphs run only on "
                    "the card")
    return torch.device("cuda")


def test_graphed_step_matches_the_eager_step_on_the_card(case, cuda):
    """The step, whose forward and backward are captured as CUDA graphs
    at its first batch's shape, against the same step run eagerly, in f32
    with TF32 off: the same kernels in the same order, so the losses,
    leaves and EMA agree to round-off (the graph's cuDNN plans are chosen
    as the eager ones are). A forward hook registered before the first
    step fires once a step, and never in the capture; a batch of one row
    after the batches of two runs eagerly."""
    from svbrdf_tpu_torch.device import precision_scope

    weights = {k: v.to(cuda) for k, v in case["weights"].items()}
    runs = []
    with precision_scope(torch.float32):
        for graphed in (False, True):
            model = build_model("diffusion", device=cuda, **SIZES)
            model.load_state_dict(weights, strict=True)
            opt = step_lib.make_optimizer(model.parameters(), 2e-5,
                                          torch.float32,
                                          state_precision="bf16sr")
            step = step_lib.DiffusionTrainStep(
                model, opt, PREP, torch.Generator(device=cuda), seed=SEED)
            if not graphed:
                step.train_forward = model
            seen = []
            model.register_forward_hook(
                lambda m, a, out: seen.append(tuple(out.shape)))
            losses = []
            for k in range(STEPS + 1):
                raw = {n: v.to(cuda) for n, v in _tensors(
                    case["raws"][k % STEPS]).items()}
                if k == STEPS:
                    raw = {n: v[:1] for n, v in raw.items()}
                step.generator.manual_seed(stream_seed(SEED, k + 1))
                losses.append(float(step(raw, step=k + 1)))
            runs.append((losses, {n: p.detach().cpu() for n, p in
                                  model.named_parameters()},
                         {n: e.cpu() for n, e in step.ema_state().items()}))
            assert seen == [(2, 9, 32, 32)] * STEPS + [(1, 9, 32, 32)]
            assert (step.graph_shape == (2, 12, 32, 32)) == graphed
    (l0, p0, e0), (l1, p1, e1) = runs
    np.testing.assert_allclose(l1, l0, rtol=1e-6)
    assert max(_leaf_gaps(p1, p0).values()) < 1e-6
    assert max(_leaf_gaps(e1, e0).values()) < 1e-6
