"""The path tracer's kernel layout, plain versions and hand-derived VJP
(svbrdf_tpu_torch/ops/pathtrace.py, csrc/pathtrace.cu) on the CPU.

The CUDA kernels run only on the card (tests/test_torch_card.py holds them
against the plain versions there); here the plain versions are held to the
code they were factored out of, bit for bit, and the VJP's line-for-line
transcription (`_sample_contrib_vjp_plain`) to autograd of
`_sample_contrib`: normwise rel 1e-10 in float64, 1e-5 in f32, on inputs
that put every clamp on both sides and at its tie. The kernels' algebra
(no colour channel in the sample loop, 1 - n.h without cancellation),
transcribed in f32 (`shade_transcribed`), is held to the plain versions by
the card's rules (bench_setup.pathtrace_agreement), and its two precision
devices are shown to be needed. Inputs are small (32^2, B=2, S=9, spp
(4, 2)) and made from numpy seeds.
"""

import numpy as np
import pytest
import torch

from svbrdf_tpu_torch.data import pipeline
from svbrdf_tpu_torch.ops import pathtrace as pt
from svbrdf_tpu_torch.scene import Scene
from svbrdf_tpu_torch.utils import bench_setup

torch.set_num_threads(1)

B, SIZE, S, SPP = 2, 32, 9, (4, 2)


def _svbrdf(seed, batch=B, size=SIZE):
    raw = bench_setup.synthetic_raw_batch(batch, size, 0, seed)["svbrdf"]
    return pipeline._decode_u8_svbrdf(torch.from_numpy(raw))


def _scene(rng, shape):
    """Camera and light above the patch, one colour per scene."""
    def pos(lo, hi):
        return torch.from_numpy(rng.uniform(lo, hi, shape + (3,)).astype(
            np.float32))

    return Scene(pos([-1.0, -1.0, 1.5], [1.0, 1.0, 3.0]),
                 pos([-1.0, -1.0, 1.0], [1.0, 1.0, 3.0]),
                 pos([5.0, 5.0, 5.0], [30.0, 30.0, 30.0]))


def _fields(scene):
    return scene.camera_pos, scene.light_pos, scene.light_color


def _samples(rng, spp, shape, size=SIZE):
    return pt.Samples(
        torch.from_numpy(rng.uniform(-0.5, 0.5, (spp,) + shape + (2,))
                         .astype(np.float32)),
        torch.from_numpy(rng.uniform(0.0, 1.0, shape + (size, size, 2))
                         .astype(np.float32)))


def _inputs(seed, dtype=torch.float32):
    """(scene (B, S, 3) fields, svbrdf (B, 1, H, W, 12), RenderSamples)."""
    rng = np.random.default_rng(seed)
    scene = _scene(rng, (B, S))
    # One scene of each item looks straight down on the patch's centre,
    # with the light beside the camera: the light quad occludes some rays.
    scene.camera_pos[:, 0] = torch.tensor([0.0, 0.0, 2.0])
    scene.light_pos[:, 0] = torch.tensor([0.1, 0.0, 1.5])
    samples = pt.RenderSamples(_samples(rng, SPP[0], (B, S)),
                               _samples(rng, SPP[1], (B, S)))
    return scene, _svbrdf(seed).to(dtype)[:, None], samples


# --- The code the plain versions were factored out of -----------------------


def _parent_shade(scene, svbrdf, offsets, shift):
    """_shade as it was: every sample into one buffer, then the occlusion."""
    geo = pt._geometry(scene, svbrdf)
    total = None
    for k in range(offsets.shape[0]):
        c = pt._sample_contrib(geo, offsets[k], shift)
        total = c if total is None else total + c
    return pt._occlude(geo, total / offsets.shape[0])


def _parent_backward(inputs, needs, offsets, shift, g):
    """_RenderMC.backward as it was: one sample's graph at a time."""
    leaves = [x.detach().requires_grad_(need)
              for x, need in zip(inputs, needs)]
    geo = pt._geometry(Scene(*leaves[1:]), leaves[0])
    radiance = torch.zeros_like(g, requires_grad=True)
    out = pt._occlude(geo, radiance)
    (d_radiance,) = torch.autograd.grad(out, radiance, g, retain_graph=True)
    d_sample = d_radiance / offsets.shape[0]
    fields = [f for f in pt._SAMPLED if getattr(geo, f).requires_grad]
    detached = geo._replace(**{f: getattr(geo, f).detach().requires_grad_()
                               for f in fields})
    sums = [None] * len(fields)
    for k in range(offsets.shape[0]):
        c = pt._sample_contrib(detached, offsets[k], shift)
        grads = torch.autograd.grad(
            c, [getattr(detached, f) for f in fields], d_sample)
        sums = [gk.float() if s is None else s + gk
                for s, gk in zip(sums, grads)]
    wanted = [x for x in leaves if x.requires_grad]
    return torch.autograd.grad(
        [out] + [getattr(geo, f) for f in fields], wanted,
        [g] + [s.to(getattr(geo, f).dtype) for s, f in zip(sums, fields)])


def _render_grads(scene, svbrdf, samples, needs, g):
    leaves = [x.detach().clone().requires_grad_(need)
              for x, need in zip((svbrdf, *_fields(scene)), needs)]
    out = pt.render_mc(Scene(*leaves[1:]), leaves[0], samples)
    out.backward(g)
    return out.detach(), [x.grad for x in leaves if x.requires_grad]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("scene_grads", [False, True])
def test_plain_versions_bit_identical_to_the_code_they_replace(
        dtype, scene_grads):
    """render_mc on the CPU (shade_plain and shade_vjp_plain in the
    kernels' layout) gives the render and every gradient of the code it was
    factored out of, to the bit: the maps' gradient alone (training), and
    the maps' with every scene field's."""
    scene, svbrdf, samples = _inputs(1, dtype)
    g = torch.from_numpy(np.random.default_rng(2).uniform(
        0.5, 1.5, (B, S, SIZE, SIZE, 3)).astype(np.float32))
    needs = (True,) + (scene_grads,) * 3
    out, grads = _render_grads(scene, svbrdf, samples, needs, g)
    ref = _parent_shade(scene, svbrdf, *samples.forward)
    ref_grads = _parent_backward(
        (svbrdf, *_fields(scene)), needs, *samples.backward, g)
    assert torch.equal(out, ref)
    assert len(grads) == len(ref_grads) == sum(needs)
    for mine, theirs in zip(grads, ref_grads):
        assert mine.dtype == theirs.dtype
        assert torch.equal(mine, theirs)


def test_shade_vjp_plain_sums_float64_in_float64():
    """A float64 render's backward sums its samples' gradients in float64
    (the code it replaced rounded the first sample's to f32)."""
    scene, svbrdf, samples = _inputs(3)
    scene = Scene(*(x.double() for x in _fields(scene)))
    svbrdf = svbrdf.double()
    offsets, shift = (x.double() for x in samples.backward)
    geo = pt._geometry(scene, svbrdf)
    layout = pt._layout(geo, pt._batch_shape(scene, svbrdf))
    d_sample = torch.from_numpy(np.random.default_rng(4).uniform(
        -1.0, 1.0, (B, S, SIZE, SIZE, 3)))
    sums = pt.shade_vjp_plain(*pt._flatten(geo, layout, offsets, shift),
                              d_sample)
    leaf = geo.normals.detach().requires_grad_()
    ref = None
    for k in range(offsets.shape[0]):
        c = pt._sample_contrib(geo._replace(normals=leaf), offsets[k], shift)
        (gk,) = torch.autograd.grad(c, leaf, d_sample)
        ref = gk if ref is None else ref + gk
    assert sums[0].dtype == torch.float64
    assert torch.equal(sums[0], ref)


@pytest.mark.parametrize("svbrdf_shape,scene_shape", [
    ((), ()),              # one scene, one SVBRDF
    ((1,), (4,)),          # renderer_compare: scenes under one SVBRDF
    ((3, 1), (3, 2)),      # the losses' (B, 1) maps under (B, S) scenes
    ((2, 3), (2, 1)),      # an SVBRDF per scene, scenes shared
    ((1, 3), (2, 3)),      # SVBRDFs shared across the leading dim
])
def test_layout_of_any_batch_shape(svbrdf_shape, scene_shape):
    """The kernels' (P, S) layout of a broadcast batch: the render and
    every gradient equal the same code on the unflattened geometry (the
    SVBRDF expanded where it broadcasts, its gradients summed back)."""
    rng = np.random.default_rng(5)
    size = 6
    batch = tuple(np.broadcast_shapes(svbrdf_shape, scene_shape))
    maps = _svbrdf(6, int(np.prod(svbrdf_shape)), size).reshape(
        svbrdf_shape + (size, size, 12))
    scene = _scene(rng, scene_shape)
    samples = pt.RenderSamples(_samples(rng, 3, batch, size),
                               _samples(rng, 2, batch, size))
    g = torch.from_numpy(rng.uniform(0.5, 1.5, batch + (size, size, 3))
                         .astype(np.float32))
    needs = (True,) * 4
    out, grads = _render_grads(scene, maps, samples, needs, g)
    ref = _parent_shade(scene, maps, *samples.forward)
    ref_grads = _parent_backward((maps, *_fields(scene)), needs, *samples.backward, g)
    torch.testing.assert_close(out, ref, rtol=1e-6, atol=0.0)
    for mine, theirs in zip(grads, ref_grads):
        assert mine.shape == theirs.shape
        torch.testing.assert_close(mine, theirs, rtol=1e-5,
                                   atol=1e-6 * float(theirs.abs().max()))


def _tie_geometry(dtype):
    """A geometry (B=2, S=4, 5 x 5) whose pixels put every clamp on both
    sides and at its tie: rough_blinn below, at and above 1e-4 and at 1,
    the centre's at 1e-4 (item 0) and 5e-5 (item 1) under a lobe that sees
    them (scene 2: camera and light straight above the centre, whose normal
    is (0, 0, 1), so n.h = n.wo = 1); grazing normals (n.wo below eps);
    cos_surf at 0 (the normal (1, 0, 0) where wi has no x); cos_light at 0
    (scene 1: a light in the patch's plane, facing -x, over its x = 0.5
    column); the Smith width a on both sides of 1.6."""
    size = 5
    rng = np.random.default_rng(7)
    scene = Scene(
        torch.tensor([[[0.0, 0.0, 2.0], [0.3, -0.4, 2.0], [0.0, 0.0, 2.0],
                       [-0.6, 0.1, 2.5]]] * 2),
        torch.tensor([[[0.0, 0.5, 2.0], [0.5, 0.0, 0.0], [0.0, 0.0, 1.5],
                       [0.2, 0.6, 1.1]]] * 2),
        torch.tensor([[[20.0, 15.0, 10.0]] * 4] * 2))
    sv = _svbrdf(8, 2, size)[:, None].clone()
    normals = torch.from_numpy(rng.normal(size=(2, 1, size, size, 3)))
    normals[..., 2] = normals[..., 2].abs() + 0.2
    normals[:, :, :, :2] = torch.tensor([0.999, 0.0, 0.0447])  # grazing
    normals[:, :, :, 2] = torch.tensor([1.0, 0.0, 0.0])  # cos_surf at 0
    normals[:, :, 2, 2] = torch.tensor([0.0, 0.0, 1.0])  # n.wo at 1
    sv[..., 0:3] = (normals / normals.norm(dim=-1, keepdim=True)).float()
    geo = pt._geometry(scene, sv.to(dtype))
    rough = torch.from_numpy(rng.uniform(1e-3, 0.6, (2, 1, size, size, 1)))
    rough[:, :, :4, 3, 0] = torch.tensor([5e-5, 1e-4, 1.0, 2e-4],
                                          dtype=torch.float64)
    rough[:, 0, 2, 2, 0] = torch.tensor([1e-4, 5e-5], dtype=torch.float64)
    return geo._replace(rough_blinn=rough.to(dtype)), size


def _tie_samples(size, dtype):
    """One sample: offset 0 and shift 0 at the centre (u = 0, so the
    sample point lies on the light's x = 0 line), random elsewhere."""
    rng = np.random.default_rng(9)
    offset = torch.zeros((2, 4, 2), dtype=dtype)
    shift = torch.from_numpy(rng.uniform(0.0, 1.0, (2, 4, size, size, 2)))
    shift[:, :, :, 2] = 0.0
    return offset, shift.to(dtype)


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10),
                                       (torch.float32, 1e-5)])
def test_sample_vjp_transcription_matches_autograd(dtype, tol):
    """_sample_contrib_vjp_plain (the kernels' VJP, line for line) against
    autograd of _sample_contrib on the same inputs in the same dtype, the
    value and all ten sampled fields' gradients, each normwise, on inputs
    that reach every clamp's both sides and its tie. (The f32 transcription
    takes 1 - n.h without cancellation and the cosines' dot products in
    float64, as the kernels do: its value lies within f32's conditioning
    of the f32 autograd's, not within 1e-5 of each of its values.)"""
    geo, size = _tie_geometry(dtype)
    geo = pt._Geometry(*(x.to(dtype) for x in geo))
    offset, shift = _tie_samples(size, dtype)
    g = torch.from_numpy(np.random.default_rng(11).uniform(
        -1.0, 1.5, (2, 4, size, size, 3))).to(dtype)

    leaves = geo._replace(**{f: getattr(geo, f).detach().requires_grad_()
                             for f in pt._SAMPLED})
    out = pt._sample_contrib(leaves, offset, shift)
    ref = torch.autograd.grad(out, [getattr(leaves, f) for f in pt._SAMPLED],
                              g)
    value, mine = pt._sample_contrib_vjp_plain(geo, offset, shift, g)
    assert value.dtype == dtype
    out = out.detach().double()
    assert float((value.double() - out).norm() / out.norm()) <= tol
    for name, r in zip(pt._SAMPLED, ref):
        m = mine[name]
        assert m.shape == r.shape, name
        err = float((m.double() - r.double()).norm() / r.double().norm())
        assert err <= tol, (name, err)
    # At the centre of item 0 rough_blinn sits on its lower clamp under a
    # lobe: its gradient there is half the one-sided derivative, not 0.
    r = dict(zip(pt._SAMPLED, ref))["rough_blinn"][0, 0, 2, 2, 0]
    assert float(r) != 0.0
    assert abs(float(mine["rough_blinn"][0, 0, 2, 2, 0] - r)) <= (
        tol * abs(float(r)))

    # The inputs reach what the docstring of _tie_geometry says.
    n, wo = geo.normals.double(), geo.wo.double()
    nv = (n * wo).sum(-1)
    rough = geo.rough_blinn.double()[..., 0]
    assert bool((nv == 1.0).any()) and bool((nv < 1e-4).any())
    assert bool((rough < 1e-4).any()) and bool((rough == 1.0).any())
    assert bool((rough == float(torch.tensor(1e-4, dtype=dtype))).any())
    r = torch.clamp(rough, 1e-4, 1.0)
    e = 2.0 / r - 2.0
    ct = torch.clamp(nv, 1e-4, 1.0)
    a = torch.sqrt(0.5 * e + 1.0) * ct / torch.sqrt(
        torch.clamp(1.0 - ct * ct, 1e-12, 1.0))
    assert bool((a < 1.6).any()) and bool((a > 1.6).any())
    cs, cl = _cosines(geo, offset, shift)
    assert bool((cs == 0.0).any()) and bool((cs > 0.0).any())
    assert bool((cs < 0.0).any())
    assert bool((cl == 0.0).any()) and bool((cl > 0.0).any())


def _cosines(geo, offset, shift):
    """The raw cos_surf and cos_light of a sample (before their clips)."""
    u = offset[..., None, None, :] + 0.5 + shift
    u = u - torch.floor(u) - 0.5
    q = (geo.light + u[..., 0:1] * pt.LIGHT_SIZE[0] * geo.t_l
         + u[..., 1:2] * pt.LIGHT_SIZE[1] * geo.b_l)
    rel = q - geo.coords
    wi = rel / torch.sqrt((rel * rel).sum(-1, keepdim=True))
    return (wi * geo.normals).sum(-1), (-wi * geo.n_l).sum(-1)


def test_bf16_pixel_terms_bit_equal_to_the_plain_ops():
    """The kernels' per-pixel terms of a bf16 SVBRDF, in f32 with explicit
    bf16 rounds (_pixel_terms), equal the plain code's bf16 ops."""
    rng = np.random.default_rng(12)
    rough = torch.from_numpy(np.concatenate([
        rng.uniform(0.0, 1.0, 4000), 10.0 ** rng.uniform(-6, 0, 4000),
        [0.0, 5e-5, 1e-4, 1.0, 1.5]]).astype(np.float32)).to(torch.bfloat16)
    spec = torch.from_numpy(rng.uniform(0.0, 1.0, rough.shape).astype(
        np.float32)).to(torch.bfloat16)
    r_lo, inv_r, e, dn, sq, oms = pt._pixel_terms(rough, spec)
    r = pt._clip(rough, 1e-4, 1.0)
    plain_e = 2.0 / r - 2.0
    plain = {"r_lo": torch.tensor(1e-4, dtype=torch.bfloat16),
             "inv_r": torch.reciprocal(r), "e": plain_e,
             "dn": (plain_e + 2.0) / (2.0 * pt._PI),
             "sq": torch.sqrt(0.5 * plain_e + 1.0), "oms": 1.0 - spec}
    for name, mine in zip(plain, (r_lo, inv_r, e, dn, sq, oms)):
        assert mine.dtype == torch.float32
        assert plain[name].dtype == torch.bfloat16
        assert torch.equal(mine, plain[name].float()), name


def test_cuda_wrappers_raise_on_cpu_tensors():
    scene, svbrdf, samples = _inputs(13)
    geo = pt._geometry(scene, svbrdf)
    layout = pt._layout(geo, pt._batch_shape(scene, svbrdf))
    flat = pt._flatten(geo, layout, *samples.forward)
    with pytest.raises(RuntimeError, match="need CUDA tensors"):
        pt.shade_cuda(*flat)
    d_sample = torch.zeros((B, S, SIZE, SIZE, 3))
    with pytest.raises(RuntimeError, match="need CUDA tensors"):
        pt.shade_vjp_cuda(*flat, d_sample)
    flat64 = [x.double() if x.dtype == torch.float32 else x for x in flat]
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        pt.shade_cuda(*flat64)
    with pytest.raises(ValueError, match="contiguous"):
        pt.shade_cuda(*flat[:12], flat[12].transpose(2, 3).contiguous()
                      .transpose(2, 3))


def test_a_cpu_render_launches_no_kernel():
    """On the CPU the plain versions run and both counters stay at 0."""
    for wrapper in pt.CUDA_WRAPPERS.values():
        wrapper.launches = 0
        wrapper.launches_by_dtype = dict.fromkeys(pt.FIELD_DTYPES, 0)
    scene, svbrdf, samples = _inputs(14)
    _render_grads(scene, svbrdf, samples, (True,) * 4,
                  torch.ones((B, S, SIZE, SIZE, 3)))
    counts = bench_setup.launch_counts()
    assert {k: v for k, v in counts.items() if k.startswith("pathtrace")} \
        == {"pathtrace_shade": 0, "pathtrace_shade_bf16": 0,
            "pathtrace_shade_vjp": 0, "pathtrace_shade_vjp_bf16": 0}
    assert set(pt.CUDA_WRAPPERS) == set(pt.PLAIN_VERSIONS)


def _flat(scene, svbrdf, samples):
    geo = pt._geometry(scene, svbrdf)
    return pt._flatten(geo, pt._layout(geo, pt._batch_shape(scene, svbrdf)),
                       *samples)


def test_float64_reference_rounds_where_the_svbrdf_rounds():
    """shade_float64 (the kernels' arithmetic in float64 after the
    per-pixel terms): on float64 inputs it is the plain version's float64
    render and VJP; on a bf16 SVBRDF it keeps the bf16 per-pixel terms, so
    it lies near the bf16 plain version, which the float64 plain version on
    the upcast maps does not."""
    scene, svbrdf, samples = _inputs(15)
    d_sample = torch.from_numpy(np.random.default_rng(16).uniform(
        -1.0, 1.0, (B, S, SIZE, SIZE, 3)))
    scene64 = Scene(*(x.double() for x in _fields(scene)))
    flat64 = _flat(scene64, svbrdf.double(),
                   [x.double() for x in samples.backward])
    torch.testing.assert_close(pt.shade_float64(*flat64),
                               pt.shade_plain(*flat64), rtol=1e-10, atol=0.0)
    for mine, ref in zip(pt.shade_float64(*flat64, d_sample=d_sample),
                         pt.shade_vjp_plain(*flat64, d_sample)):
        assert float((mine - ref).norm() / ref.norm()) <= 1e-10

    bf16 = svbrdf.to(torch.bfloat16)
    plain = pt.shade_plain(*_flat(scene, bf16, samples.forward)).double()
    ref = pt.shade_float64(*_flat(scene, bf16, samples.forward))
    upcast = pt.shade_plain(*_flat(scene64, bf16.double(),
                                   [x.double() for x in samples.forward]))
    near = float((plain - ref).norm() / ref.norm())
    assert near <= 1e-4
    assert float((upcast - ref).norm() / ref.norm()) >= 100 * near


# --- The kernels' algebra, transcribed in f32 -------------------------------


def _transcribed_f32(*inputs, scene_grads=False):
    """shade_transcribed in f32, called as the kernels' wrappers are: the
    13 inputs, then d_sample for the VJP."""
    d_sample = inputs[13] if len(inputs) > 13 else None
    return pt.shade_transcribed(*inputs[:13], d_sample=d_sample,
                                scene_grads=scene_grads, work=torch.float32)


def _agreement_of_transcription(monkeypatch, case, scene_grads=False):
    """bench_setup.pathtrace_agreement with the kernels' launches replaced
    by their f32 transcription (the render's and the VJP's)."""
    refs = bench_setup.pathtrace_references(case, scene_grads)
    monkeypatch.setattr(pt, "shade", _transcribed_f32)
    monkeypatch.setattr(pt, "shade_vjp_cuda", _transcribed_f32)
    return bench_setup.pathtrace_agreement(case, refs, scene_grads)


@pytest.mark.parametrize("dtype,scene_grads", [
    (torch.float32, False), (torch.bfloat16, False), (torch.float32, True)])
def test_channel_free_algebra_in_f32_passes_the_kernels_rules(
        monkeypatch, dtype, scene_grads):
    """The kernels' arithmetic (the channel-free sample loop: four scalar
    sums, the channels applied once a pixel and scene) transcribed in f32
    against the plain versions on a small case, by hold_pathtrace_kernels's
    rules: renders by hold_render (within rel 1e-5 of the plain version or
    within 4x the allowance of float64), each VJP sum as close to float64
    as the plain version (2x + 1e-5)."""
    case = bench_setup.pathtrace_case(2, 32, 32, (16, 8), dtype=dtype,
                                      device="cpu")
    out = _agreement_of_transcription(monkeypatch, case, scene_grads)
    assert out["passes"], out
    assert out["render"]["max_dist_over_allowed"] <= 0.5


def test_a_bf16_render_keeps_the_rounding_of_one_minus_specular(
        monkeypatch):
    """delta = (1 - specular) - bf16(1 - specular) stays in the diffuse
    term: without it the f32 transcription's bf16 render moves beyond
    hold_render's tolerance of the plain bf16 version and float64."""
    case = bench_setup.pathtrace_case(2, 32, 32, (16, 8),
                                      dtype=torch.bfloat16, device="cpu")
    refs = bench_setup.pathtrace_references(case)
    scenes, svbrdf, samples = case["scenes"], case["svbrdf"], case["samples"]

    def render():
        return pt._shade(scenes, svbrdf, *samples.forward,
                         estimator=_transcribed_f32)

    bench_setup.hold_render(render(), refs["plain"], refs["float64"],
                            refs["cond"])
    monkeypatch.setattr(pt, "_delta", lambda sp, oms: torch.zeros_like(oms))
    dropped = render()
    with pytest.raises(RuntimeError, match="path-traced renders"):
        bench_setup.hold_render(dropped, refs["plain"], refs["float64"],
                                refs["cond"])


def _half_vectors(normals, angles, rng):
    """For each normal an unnormalized half vector at each angle from it:
    n rotated by the angle about a random axis perpendicular to n, scaled
    by a length in [1, 2] (|wi + wo|), in float64."""
    n = normals / normals.norm(dim=-1, keepdim=True)
    axis = torch.linalg.cross(n, torch.from_numpy(rng.normal(
        size=n.shape)))
    axis = axis / axis.norm(dim=-1, keepdim=True)
    t = angles[:, None, None]
    h = n * torch.cos(t) + torch.linalg.cross(axis, n) * torch.sin(t)
    return h * torch.from_numpy(rng.uniform(1.0, 2.0, h.shape[:-1] + (1,)))


@pytest.mark.parametrize("normal_dtype", [torch.float32, torch.bfloat16])
def test_one_minus_nh_keeps_its_relative_error(normal_dtype):
    """_one_minus_nh (the kernels' one_minus_nh) in f32 against float64 on
    unit and near-unit normals (normalized, then rounded to f32 or bf16)
    at angles from 1e-4 rad to 1 rad: relative error within 1e-6, so the
    Blinn lobe nh^e at e = 2e4 within 1e-4 wherever it counts (e (1 -
    n.h) <= 80). 1 minus the f32 n.h is an ulp of 1 off, and misses that
    bound at e = 2e4."""
    rng = np.random.default_rng(21)
    normals = torch.from_numpy(rng.normal(size=(64, 3)))
    normals[:, 2] = normals[:, 2].abs()
    normals = (normals / normals.norm(dim=-1, keepdim=True)).to(
        normal_dtype).double()
    angles = torch.from_numpy(np.geomspace(1e-4, 1.0, 41))
    hr = _half_vectors(normals, angles, rng).float()
    n = normals.float().expand(hr.shape)
    rh = torch.rsqrt(pt.dot(hr, hr))
    nlen, x0 = pt._norm_terms(n, torch.float32)
    x = pt._one_minus_nh(n, nlen, x0, hr, rh)[..., 0].double()
    hr64, n64 = hr.double(), normals.expand(hr.shape)
    h64 = hr64 / hr64.norm(dim=-1, keepdim=True)
    exact = 1.0 - pt.dot(n64, h64)[..., 0]
    # Relative to the two terms' magnitudes |1 - |n|| + |n| (1 - cos): a
    # bf16 normal longer than 1 makes them cancel for any arithmetic.
    length = n64.norm(dim=-1)
    scale = (1.0 - length).abs() + length * (1.0 - pt.dot(
        n64 / length[..., None], h64)[..., 0])
    assert float(((x - exact).abs() / scale).max()) <= 1e-6
    e = 2e4
    counts = e * exact <= 80.0
    lobe_err = e * (x - exact).abs()
    assert float(lobe_err[counts].max()) <= 1e-4
    naive = 1.0 - pt.dot(n, hr * rh)[..., 0].double()
    assert float((e * (naive - exact).abs())[counts].max()) > 1e-4
