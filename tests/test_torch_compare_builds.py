"""The build comparison tool's parsers (ptxas's and cuobjdump's output, as
the CUDA 12.8 toolkit prints them) and the loss inputs it and chip_smoke.py
share, on the CPU. The tool itself needs a card and nvcc."""

import pytest
import torch

from svbrdf_tpu_torch.utils import compare_builds
from svbrdf_tpu_torch.utils.bench_setup import loss_inputs, loss_inputs_near

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


@pytest.mark.parametrize("mangled, kernel", [
    ("_ZN46_GLOBAL__N__593e2bb0_13_mixed_loss_cu_5433b71220mixed_fwdgrad_"
     "kernelEPKfS1_S1_PfS2_iiiiiff", "mixed_fwdgrad"),
    ("_ZN6svbrdf17value_loss_kernelILb1EEEvPKfS2_S2_Pfiiiiiff", "mixed_fwd"),
    ("_ZN50_GLOBAL__N__42a2314e_17_rendering_loss_cu_f412259924rendering_"
     "fwdgrad_kernelILb0EEEvPKfS2_S2_PfS3_S3_iiiiif", "render_fwdgrad"),
    ("_ZN6svbrdf17value_loss_kernelILb0EEEvPKfS2_S2_Pfiiiiiff", "render_fwd"),
    ("_ZN50_GLOBAL__N__42a2314e_17_rendering_loss_cu_f412259924rendering_"
     "fwdgrad_kernelILb1EEEvPKfS2_S2_PfS3_S3_iiiiif", "render_fwdgrad_both"),
])
def test_current_kernel_names(mangled, kernel):
    """The kernels of the sources at 3b4bfd6 (one gradient kernel per loss,
    the two value-only kernels one template, f32 planes only) are found by
    their names in cuobjdump's and ptxas's output, as the older trees' are
    above."""
    sass = f"\t\tFunction : {mangled}\n        /*0000*/    FMUL R1, R2, R3 ;\n"
    assert compare_builds.parse_sass(sass) == {
        kernel: {"total": 1, "FMUL": 1}}
    ptxas = (f"ptxas info    : Compiling entry function '{mangled}' for "
             "'sm_90a'\nptxas info    : Used 61 registers, used 1 barriers\n")
    assert compare_builds.ptxas_lines(ptxas) == {kernel: {"registers": 61}}


@pytest.mark.parametrize("mangled, kernel", [
    ("_ZN46_GLOBAL__N__593e2bb0_13_mixed_loss_cu_5433b71220mixed_fwdgrad_"
     "kernelIfEEvPKT_S3_PKfPfPS1_iiiiiff", "mixed_fwdgrad"),
    ("_ZN46_GLOBAL__N__593e2bb0_13_mixed_loss_cu_5433b71220mixed_fwdgrad_"
     "kernelI13__nv_bfloat16EEvPKT_S4_PKfPfPS2_iiiiiff", "mixed_fwdgrad_bf16"),
    ("_ZN6svbrdf17value_loss_kernelILb1EfEEvPKT0_S3_PKfPfiiiiiff",
     "mixed_fwd"),
    ("_ZN6svbrdf17value_loss_kernelILb0E13__nv_bfloat16EEvPKT0_S4_PKfPfiiiiiff",
     "render_fwd_bf16"),
    ("_ZN50_GLOBAL__N__42a2314e_17_rendering_loss_cu_f412259924rendering_"
     "fwdgrad_kernelIfEEvPKT_S3_PKfPfPS1_iiiiif", "render_fwdgrad"),
    ("_ZN50_GLOBAL__N__42a2314e_17_rendering_loss_cu_f412259924rendering_"
     "fwdgrad_kernelI13__nv_bfloat16EEvPKT_S4_PKfPfPS2_iiiiif",
     "render_fwdgrad_bf16"),
    ("_ZN50_GLOBAL__N__42a2314e_17_rendering_loss_cu_f412259921rendering_"
     "both_kernelIfEEvPKT_S3_PKfPfPS1_S6_iiiiif", "render_fwdgrad_both"),
    ("_ZN50_GLOBAL__N__42a2314e_17_rendering_loss_cu_f412259921rendering_"
     "both_kernelI13__nv_bfloat16EEvPKT_S4_PKfPfPS2_S7_iiiiif",
     "render_fwdgrad_both_bf16"),
])
def test_kernel_names_by_plane_type(mangled, kernel):
    """Each kernel of the current sources has an instance for float and one
    for __nv_bfloat16 planes; the second is reported as <kernel>_bf16, and
    the kernel with both gradients under its own name."""
    sass = f"\t\tFunction : {mangled}\n        /*0000*/    FMUL R1, R2, R3 ;\n"
    assert compare_builds.parse_sass(sass) == {
        kernel: {"total": 1, "FMUL": 1}}


def test_loss_inputs_on_cpu():
    """The kernels' inputs at a small size: (B, 12, H, W) planes with
    normals of unit length up to their 8-bit quantization (each component
    within 1/255, so the length within 1e-2) and maps in [0, 1], pred
    unlike gt, and 3 + 6 scenes per item packed as (B, S, 9); with
    dtype=bf16 the same planes rounded to bf16, the scenes f32."""
    bf16 = loss_inputs(2, 16, 9, device="cpu", dtype=torch.bfloat16)
    pred, gt, scenes9 = loss_inputs(2, 16, 9, device="cpu")
    assert bf16[0].dtype == bf16[1].dtype == torch.bfloat16
    assert torch.equal(bf16[0], pred.bfloat16())
    assert torch.equal(bf16[1], gt.bfloat16())
    assert torch.equal(bf16[2], scenes9)
    assert pred.shape == gt.shape == (2, 12, 16, 16)
    assert scenes9.shape == (2, 9, 9)
    for planes in (pred, gt):
        assert planes.dtype == torch.float32 and planes.is_contiguous()
        norms = planes[:, 0:3].norm(dim=1)
        assert float((norms - 1.0).abs().max()) < 1e-2
        assert float(planes[:, 3:].min()) >= 0.0
        assert float(planes[:, 3:].max()) <= 1.0
    assert not torch.equal(pred, gt)


def test_loss_inputs_near_on_cpu():
    """pred near gt: gt and the scenes those of loss_inputs, pred's normals
    of unit length, its maps in [0, 1] and within sigma-sized noise of gt's
    (6 sigma, or the normal's renormalization: gt's normals are unit only
    up to their 8-bit quantization), and the same tensors for the same
    seed."""
    pred, gt, scenes9 = loss_inputs_near(2, 16, 9, sigma=1e-3, device="cpu")
    _, gt_far, scenes_far = loss_inputs(2, 16, 9, device="cpu")
    assert pred.shape == gt.shape == (2, 12, 16, 16)
    assert pred.dtype == torch.float32 and pred.is_contiguous()
    assert torch.equal(gt, gt_far) and torch.equal(scenes9, scenes_far)
    norms = pred[:, 0:3].norm(dim=1)
    assert float((norms - 1.0).abs().max()) < 1e-6
    assert float(pred[:, 3:].min()) >= 0.0
    assert float(pred[:, 3:].max()) <= 1.0
    diff = (pred - gt).abs()
    assert float(diff[:, 3:].max()) <= 6e-3
    assert float(diff[:, :3].max()) <= 2e-2
    assert float(diff.mean()) < 2e-3 and not torch.equal(pred, gt)
    again = loss_inputs_near(2, 16, 9, sigma=1e-3, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(again, (pred, gt, scenes9)))
    other = loss_inputs_near(2, 16, 9, sigma=1e-3, seed=1, device="cpu")
    assert not torch.equal(other[0], pred)
    bf16 = loss_inputs_near(2, 16, 9, sigma=1e-3, device="cpu",
                            dtype=torch.bfloat16)
    assert torch.equal(bf16[0], pred.bfloat16())
    assert torch.equal(bf16[1], gt.bfloat16())


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


LOOP_SASS = """\
\t\tFunction : _ZN12_GLOBAL__N_114sr_adam_kernelENS_5TableEPKx
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/               @P0 BRA `(.L_x_3) ;
.L_x_1:
        /*0020*/                   LDG.E.EF.128 R4, desc[UR4][R2.64] ;
        /*0030*/                   LDG.E.EF.128 R8, desc[UR4][R6.64] ;
        /*0040*/                   FCHK P1, R4, R5 ;
        /*0050*/              @!P1 BRA `(.L_x_2) ;
.L_x_4:
        /*0060*/                   STG.E.EF.128 desc[UR4][R2.64], R4 ;
        /*0070*/                   IMAD R1, R2, 0x9e3779b9, RZ ;
        /*0080*/               @P2 BRA `(.L_x_1) ;
.L_x_3:
        /*0090*/                   EXIT ;
.L_x_2:
        /*00a0*/                   CALL.REL.NOINC `($__internal_0) ;
        /*00b0*/                   BRA `(.L_x_4) ;
\t\tFunction : _ZN46_GLOBAL__N__593e2bb0_13_mixed_loss_cu_5433b71220mixed_fwdgrad_kernelEPKfS1_S1_PfS2_iiiiiff
        /*0000*/                   LDG.E.128 R4, desc[UR4][R2.64] ;
        /*0010*/                   BRA 0x0 ;
"""


@pytest.mark.parametrize("kernel, loops", [
    # The vector loop (.L_x_1 to its closing branch) and the division's
    # slow-path return (a backward branch from past EXIT), smallest first.
    ("sr_adam", [{"first": 0x60, "last": 0xb0, "instructions": 6,
                  "ldg128": 0, "stg128": 1},
                 {"first": 0x20, "last": 0x80, "instructions": 7,
                  "ldg128": 2, "stg128": 1}]),
    # Branch targets as addresses.
    ("mixed_fwdgrad", [{"first": 0, "last": 0x10, "instructions": 2,
                        "ldg128": 1, "stg128": 0}]),
])
def test_sass_loops(kernel, loops):
    assert compare_builds.sass_loops(LOOP_SASS, kernel) == loops


@pytest.mark.parametrize("registers, blocks", [
    # 70 registers: 2304 a warp, 18432 a block of 256 threads: 3 an SM.
    (70, 3), (64, 4), (32, 8), (128, 2), (255, 1)])
def test_blocks_by_registers(registers, blocks):
    assert compare_builds.blocks_by_registers(registers) == blocks


SR_PTXAS = """\
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_121sr_adam_bf16mu_kernelENS_5TableEPKx' for 'sm_90a'
ptxas info    : Used 72 registers, used 0 barriers, 10288 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_114sr_adam_kernelENS_5TableEPKx' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 70 registers, used 0 barriers, 10288 bytes cmem[0]
"""


def test_sr_adam_code_reads_both_kernels():
    """The update's kernel and the 'bf16' state mode's are told apart (the
    second's name holds sr_adam_ but not sr_adam_kernel): each gets its
    own registers, blocks per SM, SASS total and loops."""
    sass = LOOP_SASS.split("\t\tFunction : _ZN46")[0]
    both = sass + sass.replace("14sr_adam_kernel", "21sr_adam_bf16mu_kernel")
    code = compare_builds.sr_adam_code(both, SR_PTXAS)
    assert set(code) == {"sr_adam", "sr_adam_bf16mu"}
    assert code["sr_adam"]["registers"] == 70
    assert code["sr_adam"]["blocks_per_sm"] == 3
    assert code["sr_adam_bf16mu"]["registers"] == 72
    assert code["sr_adam"]["sass_total"] == 12
    assert code["sr_adam"]["loops"] == {}  # no loop of 4/3 or 8/6 vectors
    assert compare_builds.sr_adam_code(sass, "")["sr_adam"]["registers"] \
        is None


@pytest.mark.parametrize("mangled, kernel", [
    ("_ZN45_GLOBAL__N__4ad17bb0_12_pathtrace_cu_53d63c4612shade_kernelIfEEv"
     "PKT_S3_S3_S3_S3_PKfS5_S5_S5_S5_S5_S5_S5_Pfiiiifff", "pathtrace_shade"),
    ("_ZN45_GLOBAL__N__4ad17bb0_12_pathtrace_cu_53d63c4612shade_kernelI13__"
     "nv_bfloat16EEvPKT_S4_S4_S4_S4_PKfS6_S6_S6_S6_S6_S6_S6_Pfiiiifff",
     "pathtrace_shade_bf16"),
    ("_ZN45_GLOBAL__N__4ad17bb0_12_pathtrace_cu_53d63c4616shade_vjp_kernelIf"
     "Lb0EEEvPKT_S3_S3_S3_S3_PKfS5_S5_S5_S5_S5_S5_S5_S5_PfS6_S6_S6_S6_S6_"
     "iiiifff", "pathtrace_shade_vjp"),
    ("_ZN45_GLOBAL__N__4ad17bb0_12_pathtrace_cu_53d63c4616shade_vjp_kernelI"
     "13__nv_bfloat16Lb0EEEvPKT_S4_S4_S4_S4_PKfS6_S6_S6_S6_S6_S6_S6_S6_PfS7_"
     "S7_S7_S7_S7_iiiifff", "pathtrace_shade_vjp_bf16"),
    ("_ZN45_GLOBAL__N__4ad17bb0_12_pathtrace_cu_53d63c4616shade_vjp_kernelIf"
     "Lb1EEEvPKT_S3_S3_S3_S3_PKfS5_S5_S5_S5_S5_S5_S5_S5_PfS6_S6_S6_S6_S6_"
     "iiiifff", "pathtrace_shade_vjp_scene"),
    ("_ZN45_GLOBAL__N__4ad17bb0_12_pathtrace_cu_53d63c4616shade_vjp_kernelI"
     "13__nv_bfloat16Lb1EEEvPKT_S4_S4_S4_S4_PKfS6_S6_S6_S6_S6_S6_S6_S6_PfS7_"
     "S7_S7_S7_S7_iiiifff", "pathtrace_shade_vjp_scene_bf16"),
])
def test_pathtrace_kernel_names(mangled, kernel):
    """The path tracer's six instances (as nvcc 12.8 mangles them) are
    found by name in cuobjdump's and ptxas's output."""
    sass = f"\t\tFunction : {mangled}\n        /*0000*/    FMUL R1, R2, R3 ;\n"
    assert compare_builds.parse_sass(sass) == {
        kernel: {"total": 1, "FMUL": 1}}
    ptxas = (f"ptxas info    : Compiling entry function '{mangled}' for "
             "'sm_90a'\nptxas info    : Used 64 registers, used 1 barriers\n")
    assert compare_builds.ptxas_lines(ptxas) == {kernel: {"registers": 64}}


def test_a_tree_without_the_path_tracer_is_skipped(tmp_path):
    """A csrc/ tree from before the path tracer's kernels builds the other
    sources only, and reports no path tracer code."""
    for source in ("mixed_loss", "rendering_loss", "sr_adam"):
        (tmp_path / f"{source}.cu").write_text("")
    assert compare_builds.tree_sources(tmp_path) == (
        "mixed_loss", "rendering_loss", "sr_adam")
    assert compare_builds.pathtrace_code(tmp_path, "") is None
    (tmp_path / "pathtrace.cu").write_text("")
    assert compare_builds.tree_sources(tmp_path)[-1] == "pathtrace"



PATHTRACE_SASS = """\
\t\tFunction : _ZN45_GLOBAL__N__4ad17bb0_12_pathtrace_cu_53d63c4612shade_kernelIfEEvPKT_S3_S3_S3_S3_PKfS5_S5_S5_S5_S5_S5_S5_Pfiiiifff
        /*0000*/                   DADD R4, R2, R6 ;
        /*0010*/                   F2F.F32.F64 R8, R4 ;
.L_x_1:
        /*0020*/                   MUFU.RSQ R9, R8 ;
        /*0030*/                   DFMA R4, R2, R6, R4 ;
        /*0040*/                   FFMA R10, R9, R9, R8 ;
        /*0050*/                   FMNMX R11, R10, RZ, !PT ;
        /*0060*/                   STL [R1], R11 ;
        /*0070*/                   MUFU.RCP64H R5, R3 ;
        /*0080*/                   LDL R12, [R1] ;
        /*0090*/               @P0 BRA `(.L_x_1) ;
        /*00a0*/                   DMUL R4, R2, R6 ;
        /*00b0*/                   EXIT ;
"""


def test_op_classes_of_a_kernel_and_its_loops():
    """The path tracer's SASS classes: double-precision arithmetic (DADD,
    DMUL, DFMA and the 64H MUFU seeds; not the conversions), FP32 (FFMA,
    FMNMX), every MUFU op and the spill traffic, over the kernel and over
    its loop that holds a special-function op."""
    mix = compare_builds.parse_sass(PATHTRACE_SASS)["pathtrace_shade"]
    assert mix["F2F"] == 1 and mix["MUFU.RCP64H"] == 1
    assert compare_builds.op_classes(mix) == {
        "fp64": 4, "fp32": 2, "mufu": 2, "local": 2, "total": 12}
    assert compare_builds.loop_classes(PATHTRACE_SASS, "pathtrace_shade") \
        == [{"first": 0x20, "last": 0x90, "fp64": 2, "fp32": 2, "mufu": 2,
             "local": 2, "total": 8}]
    assert compare_builds.op_classes({}) == {
        "fp64": 0, "fp32": 0, "mufu": 0, "local": 0, "total": 0}


def test_pathtrace_library_code_reads_each_instance(monkeypatch, tmp_path):
    """A built libpathtrace's instances from one disassembly of it
    (sass_text, here its stand-in): each instance's op classes and loops
    from its SASS, ptxas's registers where the log has them, blocks per SM
    from the library's queries at the path's shapes."""
    queried = []

    class Query:
        def __init__(self, name):
            self.name = name

        def __call__(self, *args):
            queried.append((self.name, args))
            return 4

    class Library:
        def __getattr__(self, name):
            return Query(name)

    disassembled = []
    monkeypatch.setattr(compare_builds.ctypes, "CDLL",
                        lambda path: Library())
    monkeypatch.setattr(compare_builds, "sass_text",
                        lambda lib: disassembled.append(lib)
                        or PATHTRACE_SASS)
    ptxas = ("ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__4ad"
             "17bb0_12_pathtrace_cu_53d63c4612shade_kernelIfEEvPKT_S3_S3_S3"
             "_S3_PKfS5_S5_S5_S5_S5_S5_S5_Pfiiiifff' for 'sm_90a'\n"
             "ptxas info    : Used 62 registers, used 1 barriers\n")
    lib = tmp_path / "libpathtrace.so"
    code = compare_builds.pathtrace_library_code(lib, ptxas)
    assert disassembled == [lib]
    assert sorted(code) == sorted(
        k + s for k in compare_builds.PATHTRACE_BLOCKS for s in ("", "_bf16"))
    shade = code["pathtrace_shade"]
    assert shade["ptxas"] == {"registers": 62}
    assert shade["classes"]["fp64"] == 4 and shade["classes"]["local"] == 2
    assert [loop["mufu"] for loop in shade["loops"]] == [2]
    assert shade["blocks_per_sm"] == 4
    assert code["pathtrace_shade_vjp_bf16"]["sass"] is None
    assert ("svbrdf_pathtrace_shade_vjp_bf16_blocks_per_sm", (9, 8, 0)) \
        in queried
