"""MaterialGAN's generator and latent capture (models/stylegan2,
experiments/map_recovery.CaptureStep) against the benchmark's plain
reference (bench_gpu/reference/stylegan2.py: literal per-sample modulated
weights in grouped convolutions, upfirdn2d written out, its own Adam), on
seeded weights at a small size on the CPU: 32^2, channels capped at 32,
w 32, 4 mapping layers, 2 materials x 3 photos.

Tolerances: both sides compute in f32 on the CPU, in two forms of the
same arithmetic (the program scales the input by the style and the output
by the demodulation; the reference folds both into the weight), so they
differ by f32 rounding alone: sums of up to 288 products through 13
layers, about 1e-6 of the values (measured: 5e-7 on the maps, 5e-7 to
1e-6 on the gradients' and the updates' row gaps). Each limit leaves ten
times that and more; the same comparisons with the reference's conv and
dense inputs and weights rounded to bf16 read 3e-4 to 5e-2 (the loss,
the gradients, the updates), above every limit.
"""

import contextlib
import io

import numpy as np
import pytest
import torch

from bench_gpu.reference import maps as ref_maps
from bench_gpu.reference import stylegan2 as ref
from svbrdf_tpu_torch import losses
from svbrdf_tpu_torch.data import pipeline, strips, toy
from svbrdf_tpu_torch.examples import recover_maps
from svbrdf_tpu_torch.experiments import CaptureStep, recover_latent
from svbrdf_tpu_torch.models import build_model, stylegan2
from svbrdf_tpu_torch.ops import render

torch.set_num_threads(1)

SMALL = dict(resolution=32, w_dim=32, mapping_layers=4, max_channels=32,
             channel_base=32768)
CFG = dict(SMALL, learning_rate=0.02)
BATCH, PHOTOS = 2, 3


@pytest.fixture(scope="module")
def case():
    """The program loaded with the reference's seeded weights, W+ around
    w_avg, noise maps, and each material's photos and scenes."""
    weights = ref.make_weights(CFG, 5, "cpu")
    model = build_model("materialgan", device="cpu", **SMALL)
    model.load_state_dict(weights, strict=True)
    model.requires_grad_(False)
    gen = torch.Generator().manual_seed(1)
    wplus = (weights["w_avg"].expand(BATCH, model.num_ws, -1)
             + 0.3 * torch.randn(BATCH, model.num_ws, 32, generator=gen))
    noises = model.make_noises(BATCH, gen)
    materials = torch.rand(BATCH, 32, 32, 12, generator=gen)
    scenes = pipeline.generate_input_scenes(BATCH, PHOTOS, True,
                                            generator=gen)
    photos = pipeline.synthesize_inputs(materials, PHOTOS, True,
                                        generator=gen, scenes=scenes)
    return dict(weights=weights, model=model, wplus=wplus, noises=noises,
                scenes=scenes, photos=photos)


def _ref_scenes(scenes):
    return ref_maps.Scene(scenes.camera_pos, scenes.light_pos,
                          scenes.light_color)


def _rel(a, b):
    return float((a - b).norm() / b.norm())


def test_decoded_maps_match_the_reference(case):
    got = case["model"](case["wplus"], case["noises"])
    want = ref.generate(case["weights"], case["wplus"], case["noises"], CFG)
    assert got.shape == (BATCH, 32, 32, 12)
    # f32 rounding of two forms of the same sums (module docstring).
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    # The clamp takes some of the toRGB sum: both sides clamp the same.
    raw = case["model"].synthesis(case["wplus"], case["noises"])
    assert raw.shape == (BATCH, 9, 32, 32)


def test_mapping_and_w_avg(case):
    z = torch.randn(16, 32, generator=torch.Generator().manual_seed(2))
    # Dense layers alone: addmm against linear, the same products.
    torch.testing.assert_close(case["model"].map(z),
                               ref.mapping(case["weights"], z, CFG),
                               rtol=1e-5, atol=1e-6)
    # A built model's w_avg is the mean of 4096 mapped z: another 4096
    # give it to sampling error (w's spread about 1, so each mean is off
    # by about 1/64; 0.15 is five times the two means' distance).
    own = build_model("materialgan", device="cpu", seed=3, **SMALL)
    zs = torch.randn(stylegan2.W_AVG_SAMPLES, 32,
                     generator=torch.Generator().manual_seed(3))
    torch.testing.assert_close(own.w_avg, own.map(zs).mean(0), rtol=0,
                               atol=0.15)


def test_gradients_of_wplus_and_noise(case):
    model = case["model"]
    wplus = case["wplus"].clone().requires_grad_()
    noises = [n.clone().requires_grad_() for n in case["noises"]]
    maps = model(wplus, noises)
    renders = render.render(case["scenes"], maps[:, None])
    loss = losses.l1_loss(torch.log(renders + losses.EPSILON_RENDER),
                          torch.log(case["photos"] + losses.EPSILON_RENDER))
    loss.backward()

    rw = case["wplus"].clone().requires_grad_()
    rn = [n.clone().requires_grad_() for n in case["noises"]]
    with ref.tf32_off():
        ref_loss = ref.capture_loss(ref.generate(case["weights"], rw, rn,
                                                 CFG), case["photos"],
                                    _ref_scenes(case["scenes"]))
    ref_loss.backward()
    assert float(loss.detach()) == pytest.approx(float(ref_loss.detach()),
                                                 rel=1e-6)
    # Normwise, f32 rounding (module docstring): 1e-5 of the gradient.
    assert _rel(wplus.grad, rw.grad) < 1e-5
    for got, want in zip(noises, rn):
        assert _rel(got.grad, want.grad) < 1e-5
    # The frozen network takes no gradient.
    assert all(p.grad is None for p in model.parameters())


def _one_iteration(case) -> dict:
    """One CaptureStep call against the reference's: the benchmark's
    numbers (reference.stylegan2.gaps)."""
    step = CaptureStep(case["model"], case["photos"], case["scenes"],
                       case["wplus"], case["noises"],
                       learning_rate=CFG["learning_rate"])
    loss = float(step())
    assert step.steps == 1
    assert not any(p.requires_grad for p in case["model"].parameters())
    prog = {"losses": [loss],
            "wplus_grad": step.wplus.grad,
            "noise_grads": [n.grad for n in step.noises],
            "wplus_change": step.wplus.detach() - case["wplus"],
            "noise_changes": [n.detach() - n0 for n, n0 in
                              zip(step.noises, case["noises"])]}
    return ref.gaps(prog, ref.capture(
        case["weights"], CFG, case["photos"], _ref_scenes(case["scenes"]),
        case["wplus"], case["noises"], 1))


def test_one_capture_iteration(case):
    gaps = _one_iteration(case)
    # The benchmark's own numbers, at ten times f32 rounding and more.
    assert gaps["loss_gap"] < 2e-6
    assert gaps["wplus_grad_gap_median"] < 1e-5
    assert gaps["noise_grad_gap_median"] < 1e-5
    assert gaps["change_gap_median"] < 1e-5


def test_the_bf16_control_and_a_missing_demodulation_fail(case,
                                                           monkeypatch):
    """What the benchmark's limits are set between: the reference in bf16
    and the program without demodulation read far above f32 rounding."""
    def reference(quant=ref._identity):
        return ref.capture(case["weights"], CFG, case["photos"],
                           _ref_scenes(case["scenes"]), case["wplus"],
                           case["noises"], 1, quant)

    low = ref.gaps(reference(ref.bf16), reference())
    assert low["wplus_grad_gap_median"] > 1e-3
    monkeypatch.setattr(stylegan2, "demodulation",
                        lambda weight, styles: styles.new_ones(
                            styles.shape[0], weight.shape[0]))
    assert _one_iteration(case)["wplus_grad_gap_median"] > 0.1


@pytest.mark.parametrize("kernel,demodulate,up", [(3, True, False),
                                                  (3, True, True),
                                                  (1, False, False)])
def test_the_two_modulation_forms_agree(kernel, demodulate, up):
    """The program's shared-weight form (input times style, one conv,
    output times the demodulation) against the literal per-sample weights
    of a grouped conv."""
    gen = torch.Generator().manual_seed(kernel + 2 * up)
    conv = stylegan2.ModulatedConv(6, 5, kernel, 8, demodulate=demodulate,
                                   up=up)
    with torch.no_grad():
        for p in conv.parameters():
            p.copy_(torch.randn(p.shape, generator=gen))
    x = torch.randn(3, 6, 7, 7, generator=gen)
    w = torch.randn(3, 8, generator=gen)
    y, d = conv(x, w)
    got = y if d is None else y * d[:, :, None, None]
    styles = conv.affine(w)
    want = ref.modulated_conv(x, conv.weight, styles, demodulate, up)
    assert got.shape == want.shape == (3, 5) + ((14, 14) if up else (7, 7))
    # f32 rounding of 54-term sums in two orders.
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def _upfirdn_direct(x: np.ndarray, up: int, pad: tuple) -> np.ndarray:
    """upfirdn2d by its definition, in float64 loops: zero insertion,
    padding, and out[i, j] = sum_ab k[a, b] u[i + a, j + b] with the
    [1, 3, 3, 1] outer product / 64 * up^2 (symmetric: flipping is a
    no-op)."""
    k1 = np.array([1.0, 3.0, 3.0, 1.0])
    k = np.outer(k1, k1) / 64.0 * up * up
    c, h, w = x.shape
    u = np.zeros((c, h * up, w * up))
    u[:, ::up, ::up] = x
    u = np.pad(u, ((0, 0), (pad[0], pad[1]), (pad[0], pad[1])))
    oh, ow = u.shape[1] - 3, u.shape[2] - 3
    out = np.zeros((c, oh, ow))
    for i in range(oh):
        for j in range(ow):
            out[:, i, j] = (k * u[:, i:i + 4, j:j + 4]).sum((1, 2))
    return out


def test_fir_up_sampling_against_its_definition():
    gen = torch.Generator().manual_seed(7)
    fir = stylegan2.fir_kernel()
    assert float(fir.sum()) == pytest.approx(4.0)
    x = torch.randn(1, 2, 5, 5, generator=gen)
    # The skips' 2x up-sampling: up 2, pad (2, 1).
    want = _upfirdn_direct(x[0].double().numpy(), 2, (2, 1))
    np.testing.assert_allclose(stylegan2.upsample(x, fir)[0].numpy(), want,
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(
        ref.upfirdn2d(x, ref.fir("cpu"), 2, (2, 1))[0].numpy(), want,
        rtol=0, atol=1e-5)
    # The blur after a transposed conv: (2H + 1)^2 -> (2H)^2, pad (1, 1),
    # with the gain of 4 an up-sampling's FIR carries.
    y = torch.randn(1, 2, 11, 11, generator=gen)
    want = _upfirdn_direct(y[0].double().numpy(), 1, (1, 1)) * 4.0
    np.testing.assert_allclose(stylegan2.blur(y, fir)[0].numpy(), want,
                               rtol=0, atol=1e-5)


def test_the_published_widths():
    model = build_model("materialgan", device="cpu")
    assert model.num_ws == 14 and model.w_dim == 512
    assert sum(p.numel() for p in model.parameters()) == 30_052_044
    assert model.noise_sizes == [4] + [r for r in (8, 16, 32, 64, 128, 256)
                                       for _ in range(2)]
    assert [c.conv.weight.shape[0] for c in model.convs] == (
        [512] * 9 + [256, 256, 128, 128])
    assert [t.conv.weight.shape[:2] for t in model.to_rgbs] == [
        (9, c) for c in (512, 512, 512, 512, 512, 256, 128)]
    full = dict(resolution=256, w_dim=512, mapping_layers=8,
                max_channels=512, channel_base=32768)
    names = {n for n, _, _ in ref.param_spec(full)} | {"w_avg"}
    assert set(model.state_dict()) == names
    with pytest.raises(ValueError):
        build_model("materialgan", device="cpu", resolution=48)
    with pytest.raises(ValueError):
        build_model("materialgan", device="cpu", dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        build_model("single", device="cpu", resolution=32)


def test_recover_latent_lowers_the_loss(case):
    result = recover_latent(case["model"], case["photos"], case["scenes"],
                            steps=8, generator=torch.Generator())
    assert result.losses.shape == (8,)
    assert float(result.losses[-1]) < float(result.losses[0])
    assert result.svbrdf.shape == (BATCH, 32, 32, 12)
    # 2 log2(32) - 2 rows of W+.
    assert result.wplus.shape == (BATCH, 8, 32)


def test_the_example_captures_with_the_generator(tmp_path):
    with contextlib.redirect_stdout(io.StringIO()):
        (strip,) = toy.generate_toy_dataset(str(tmp_path / "toy"), 1, 0, 32,
                                            10, seed=3, device="cpu")
    out = str(tmp_path / "g.png")
    with contextlib.redirect_stdout(io.StringIO()) as printed:
        result = recover_maps.main([strip, "all", out, "3", "--generator",
                                    "materialgan", "--device", "cpu"])
    assert "loss" in printed.getvalue() and result.losses.shape == (3,)
    assert result.svbrdf.shape == (1, 32, 32, 12)
    assert strips.read_image_u8(out).shape == (64, 160, 3)
    with pytest.raises(SystemExit), \
            contextlib.redirect_stderr(io.StringIO()):
        recover_maps.main([strip, "diffuse", out, "--generator",
                           "materialgan", "--device", "cpu"])


def test_the_generator_needs_a_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model("materialgan", **SMALL)
