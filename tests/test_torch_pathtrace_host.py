"""The path tracer's CUDA kernels' device code (csrc/pathtrace.cu), built for
the host with g++ (svbrdf_tpu_torch/utils/host_pathtrace.py), held on the
CPU to the plain versions by the card's rules
(bench_setup.pathtrace_agreement). The host build rounds as the card's does
but for the MUFU approximations, expf and the order of the block sums; the
card holds the kernels themselves (tests/test_torch_card.py). Small cases
(B=2, 16^2, spp 16 / 8) made from seeds.
"""

import shutil

import pytest
import torch

from svbrdf_tpu_torch.ops import pathtrace as pt
from svbrdf_tpu_torch.utils import bench_setup, host_pathtrace

torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="the host build of the kernels "
                                       "needs g++")


@pytest.fixture(scope="module")
def lib():
    return host_pathtrace.build()


@pytest.mark.parametrize("dtype,scene_grads", [
    (torch.float32, False), (torch.bfloat16, False), (torch.float32, True)])
def test_host_build_passes_the_kernels_rules(lib, dtype, scene_grads):
    """The kernels' own code, f32 or bf16 SVBRDF, with and without scene
    gradients: renders by hold_render, each VJP sum as close to float64 as
    the plain version (2x + 1e-5)."""
    out = host_pathtrace.agreement(lib, 2, 16, dtype, scene_grads)
    assert out["passes"], out
    assert out["render"]["max_dist_over_allowed"] <= 0.5


def _moved_case(seed=0):
    """A pathtrace_case whose sample offsets are moved by whole numbers
    from -3 to 3 (far outside the samplers' [-0.5, 0.5)): the plain
    version wraps u = offset + 0.5 + shift by its floor whatever its
    range."""
    case = bench_setup.pathtrace_case(2, 16, 16, (16, 8), seed=seed,
                                      device="cpu")
    g = torch.Generator().manual_seed(seed + 7)
    samples = pt.RenderSamples(*(
        pt.Samples(s.offsets + torch.randint(-3, 4, s.offsets.shape,
                                             generator=g).float(), s.shift)
        for s in case["samples"]))
    scenes, svbrdf = case["scenes"], case["svbrdf"]
    geo = pt._geometry(scenes, svbrdf)
    layout = pt._layout(geo, pt._batch_shape(scenes, svbrdf))
    return dict(case, samples=samples,
                flat=pt._flatten(geo, layout, *samples.forward),
                flat_bwd=pt._flatten(geo, layout, *samples.backward))


def _transcribed_f32(*inputs, scene_grads=False):
    d_sample = inputs[13] if len(inputs) > 13 else None
    return pt.shade_transcribed(*inputs[:13], d_sample=d_sample,
                                scene_grads=scene_grads, work=torch.float32)


@pytest.mark.parametrize("route", ["host_build", "transcription"])
def test_offsets_outside_the_samplers_range_wrap_as_the_plain_version(
        monkeypatch, lib, route):
    """The kernels (and their f32 transcription) wrap each sample's u by
    its floor as the plain version does, so offsets moved by whole numbers
    still pass the card's rules, the scene gradients' included; a wrap
    decided as u >= 1 would put these samples off the light."""
    case = _moved_case()
    assert float(case["samples"].forward.offsets.abs().max()) > 2.0
    refs = bench_setup.pathtrace_references(case, scene_grads=True)
    if route == "host_build":
        with host_pathtrace.routed(lib):
            out = bench_setup.pathtrace_agreement(case, refs, True)
    else:
        monkeypatch.setattr(pt, "shade", _transcribed_f32)
        monkeypatch.setattr(pt, "shade_vjp_cuda", _transcribed_f32)
        out = bench_setup.pathtrace_agreement(case, refs, True)
    assert out["passes"], out


def test_host_source_refuses_a_source_it_cannot_translate():
    """The host build names the line of the source it cannot find: a
    changed launch boundary or a changed inline-PTX line is an error, not
    a silently different build."""
    text = host_pathtrace.SOURCE.read_text()
    with pytest.raises(ValueError, match="shade_shared_bytes"):
        host_pathtrace.host_source(text.replace(
            "size_t shade_shared_bytes(int spp)", "size_t smem(int spp)"))
    with pytest.raises(ValueError, match="rcp.approx"):
        host_pathtrace.host_source(text.replace("rcp.approx.ftz.f32",
                                                "rcp.approx.f32"))
    with pytest.raises(ValueError, match="naive_one_minus_nh"):
        host_pathtrace.apply_variant("", "naive_one_minus_nh")


@pytest.mark.parametrize("variant", sorted(host_pathtrace.VARIANTS))
def test_each_variant_is_one_edit_of_the_kernels(variant):
    """Each named variant changes the source at one place and still
    translates for the host."""
    text = host_pathtrace.SOURCE.read_text()
    edited = host_pathtrace.apply_variant(text, variant)
    assert edited != text
    old, new = host_pathtrace.VARIANTS[variant]
    assert edited.replace(new, old) == text
    assert "extern \"C\"" in host_pathtrace.host_source(edited)
