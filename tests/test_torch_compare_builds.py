"""The build comparison tool's parsers (ptxas's and cuobjdump's output, as
the CUDA 12.8 toolkit prints them) and the loss inputs it and chip_smoke.py
share, on the CPU. The tool itself needs a card and nvcc."""

import torch

from svbrdf_tpu_torch.utils import compare_builds
from svbrdf_tpu_torch.utils.bench_setup import loss_inputs

torch.set_num_threads(1)

PTXAS = """\
ptxas info    : Compiling entry function '_ZN46_GLOBAL__N__593e2bb0_13_mixed_loss_cu_5433b71217mixed_loss_kernelILb0EEEvPKfS2_S2_PfS3_iiiiiff' for 'sm_90a'
ptxas info    : Function properties for _ZN46_GLOBAL__N__593e2bb0_13_mixed_loss_cu_5433b71217mixed_loss_kernelILb0EEEvPKfS2_S2_PfS3_iiiiiff
    0 bytes stack frame, 12 bytes spill stores, 24 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers, 32 bytes smem
ptxas info    : Compiling entry function '_ZN46_GLOBAL__N__593e2bb0_13_mixed_loss_cu_5433b71217mixed_loss_kernelILb1EEEvPKfS2_S2_PfS3_iiiiiff' for 'sm_90a'
ptxas info    : Function properties for _ZN46_GLOBAL__N__593e2bb0_13_mixed_loss_cu_5433b71217mixed_loss_kernelILb1EEEvPKfS2_S2_PfS3_iiiiiff
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 79 registers, used 1 barriers, 32 bytes smem
"""

SASS = """\
\tcode for sm_90a
\t\tFunction : _ZN50_GLOBAL__N__42a2314e_17_rendering_loss_cu_f412259921rendering_loss_kernelILb1ELb0EEEvPKfS2_S2_PfS3_S3_iiiiif
\t.headerflags\t@"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   MUFU.RCP R5, R4 ;
        /*0020*/               @P0 BRA `(.L_x_1) ;
        /*0030*/                   FFMA R6, R5, R4, -1 ;
        /*0040*/              @!P1 CALL.REL.NOINC `($__internal_0) ;
        /*0050*/                   FADD.FTZ R7, R6, R6 ;
        /*0060*/                   LDS R8, [R2] ;
        /*0070*/                   MUFU.RSQ R9, R8 ;
\t\t..........
\t\tFunction : _ZN50_GLOBAL__N__42a2314e_17_rendering_loss_cu_f412259921rendering_loss_kernelILb0ELb0EEEvPKfS2_S2_PfS3_S3_iiiiif
        /*0000*/                   FMUL R1, R2, R3 ;
        /*0010*/                   EXIT ;
"""


def test_ptxas_lines_per_kernel():
    assert compare_builds.ptxas_lines(PTXAS) == {
        "mixed_fwd": {"spill_stores": 12, "spill_loads": 24,
                      "registers": 64},
        "mixed_fwdgrad": {"spill_stores": 0, "spill_loads": 0,
                          "registers": 79}}


def test_parse_sass_counts_each_kernel():
    assert compare_builds.parse_sass(SASS) == {
        "render_fwdgrad": {"total": 8, "MUFU.RCP": 1, "BRA": 1, "FFMA": 1,
                           "CALL": 1, "FADD": 1, "LDS": 1, "MUFU.RSQ": 1},
        "render_fwd": {"total": 2, "FMUL": 1}}


def test_loss_inputs_on_cpu():
    """The kernels' inputs at a small size: (B, 12, H, W) planes with
    normals of unit length up to their 8-bit quantization (each component
    within 1/255, so the length within 1e-2) and maps in [0, 1], pred
    unlike gt, and 3 + 6 scenes per item packed as (B, S, 9)."""
    pred, gt, scenes9 = loss_inputs(2, 16, 9, device="cpu")
    assert pred.shape == gt.shape == (2, 12, 16, 16)
    assert scenes9.shape == (2, 9, 9)
    for planes in (pred, gt):
        assert planes.dtype == torch.float32 and planes.is_contiguous()
        norms = planes[:, 0:3].norm(dim=1)
        assert float((norms - 1.0).abs().max()) < 1e-2
        assert float(planes[:, 3:].min()) >= 0.0
        assert float(planes[:, 3:].max()) <= 1.0
    assert not torch.equal(pred, gt)


def test_kernel_tables_name_the_same_kernels():
    """Every kernel has a C entry, a wrapper and a plain version, and its
    float arguments are the ones its wrapper passes: the normalizers for
    the mixed kernels, none for the rendering value, 1/count otherwise."""
    from svbrdf_tpu_torch.ops import render_fused as rf

    assert (set(rf._ENTRIES) == set(rf.CUDA_WRAPPERS)
            == set(rf.PLAIN_VERSIONS))
    pred, _, scenes9 = loss_inputs(2, 16, 9, device="cpu")
    count = 2 * 9 * 16 * 16 * 3
    for name, (_, _, _, n_floats) in rf._ENTRIES.items():
        floats = rf.kernel_floats(name, pred, scenes9)
        assert len(floats) == n_floats
    assert rf.kernel_floats("mixed_fwdgrad", pred, scenes9) == \
        rf._normalizers(2, 9, 16, 16, 0, 0.1)
    assert rf.kernel_floats("render_fwdgrad", pred, scenes9) == (1 / count,)
