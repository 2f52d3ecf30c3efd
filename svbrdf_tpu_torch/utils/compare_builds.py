"""Build the loss kernels of several csrc/ trees side by side and time them
in one process on one card.

    python3 -m svbrdf_tpu_torch.utils.compare_builds [--out FILE] NAME=DIR ...

Each DIR holds a copy of svbrdf_tpu_torch/csrc/ (an older commit's, made
with `git archive COMMIT svbrdf_tpu_torch/csrc | tar -x -C DIR
--strip-components=2`, or a variant of the current one) with the same C
interface: the launch entries of ops/render_fused._ENTRIES and
svbrdf_<source>_threads. The package's own csrc/ is always compared, as
"csrc". For every tree, the three sources are built with the package's
nvcc flags (ops/_build.NVCC_FLAGS) into DIR/_build, one nvcc per source,
all started together. For the SR-Adam kernel (sr_adam.cu) of each tree,
and its 'bf16' state mode's kernel where the tree has one, it reports the
ptxas registers and spills, the SASS total, the SASS instructions per
element of its all-bf16 and all-f32 vector loops and the blocks of 256
threads that fit one SM by those registers (sr_adam_code). For the path
tracer's kernels (pathtrace.cu), in every tree that has the source, it
reports each of the six instances' ptxas registers and spills, SASS mix,
the FP64, FP32, MUFU and local-memory instructions of the whole kernel and
of its loops (op_classes, loop_classes) and blocks per SM at the path's
shapes (S=9 scenes, spp 16 forward and 8 backward; pathtrace_code); each
tree's kernels, through the package's wrappers, against the plain
versions and float64 on bench_setup.PATHTRACE_CASES by
hold_pathtrace_kernels's rules, reported and not raised
(pathtrace_agreement); and each instance's device time at full width
(pathtrace_times). A tree without the source is said to lack it and
skipped. For each of the five loss kernels, and for each one's
bf16 instantiation where the tree has one (reported as <kernel>_bf16, on
the same inputs cast to bf16), it reports:
  - ptxas registers and spill bytes;
  - the SASS instruction mix (cuobjdump -sass): FP32 adds, multiplies and
    FMAs, each MUFU op, branches and calls (the division and square-root
    slow paths are calls), shared and local memory loads and stores;
  - blocks per SM, where the tree exports <symbol>_blocks_per_sm;
  - loss rel and max |gradient error| / max |gradient| against the
    package's plain versions on the same inputs (bench_setup.loss_inputs),
    loss rel on inputs near convergence (bench_setup.loss_inputs_near),
    and whether pred = gt gives exactly 0. Printed, not held: an older tree
    may compute the same function with other roundings;
  - device time at the main path's shapes (B=8, 256^2, S=9): 10
    back-to-back launches between CUDA events, median of 20
    (kernel_ms), in ROUNDS rounds that alternate the order of the trees;
    the median of the rounds and every round.
Prints one JSON object last; --out also writes it to FILE. Needs a CUDA
device and the CUDA toolkit.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

SOURCES = ("mixed_loss", "rendering_loss")
SR_SOURCE = "sr_adam"
PT_SOURCE = "pathtrace"
# A part of each kernel's mangled name in the SASS: the current sources'
# (each instance for float or __nv_bfloat16 planes), then those of the trees
# whose kernels took f32 planes only: 3b4bfd6 (rendering_fwdgrad_kernel
# with the target's gradient as its switch), then the template instances of
# the trees before the value-only kernels had a template of their own
# (2c5e8e1 and older).
SASS_NAMES = {
    "mixed_fwdgrad": ("mixed_fwdgrad_kernel", "mixed_loss_kernelILb1E"),
    "mixed_fwd": ("value_loss_kernelILb1E", "mixed_loss_kernelILb0E"),
    "render_fwdgrad": ("rendering_fwdgrad_kernelIf",
                       "rendering_fwdgrad_kernelI13__nv_bfloat16",
                       "rendering_fwdgrad_kernelILb0E",
                       "rendering_loss_kernelILb1ELb0E"),
    "render_fwd": ("value_loss_kernelILb0E",
                   "rendering_loss_kernelILb0ELb0E"),
    "render_fwdgrad_both": ("rendering_both_kernel",
                            "rendering_fwdgrad_kernelILb1E",
                            "rendering_loss_kernelILb1ELb1E"),
    # csrc/sr_adam.cu's kernels: the update, and the 'bf16' state mode's.
    "sr_adam": ("sr_adam_kernel",),
    "sr_adam_bf16mu": ("sr_adam_bf16mu_kernel",),
    # csrc/pathtrace.cu's: the VJP with scene gradients first (its mangled
    # name also holds the training instance's prefix).
    "pathtrace_shade_vjp_scene": ("16shade_vjp_kernelIfLb1E",
                                  "16shade_vjp_kernelI13__nv_bfloat16Lb1E"),
    "pathtrace_shade_vjp": ("16shade_vjp_kernelI",),
    "pathtrace_shade": ("12shade_kernelI",),
}
# The path tracer's instances whose blocks per SM are queried, by the C
# entry's name and its arguments at the path's shapes (S=9, spp 16 / 8).
PATHTRACE_BLOCKS = {
    "pathtrace_shade": ("svbrdf_pathtrace_shade", (16,)),
    "pathtrace_shade_vjp": ("svbrdf_pathtrace_shade_vjp", (9, 8, 0)),
    "pathtrace_shade_vjp_scene": ("svbrdf_pathtrace_shade_vjp", (9, 8, 1)),
}
# The SR-Adam kernel's vector loops by their 16-byte loads and stores a pass
# (8 elements): every tensor bf16 (one each), every tensor f32 (two each).
SR_ADAM_LOOPS = {"bf16": (4, 3), "f32": (8, 6)}
SR_ADAM_THREADS = 256
BF16_MANGLED = "__nv_bfloat16"
SASS_OPS = ("FADD", "FMUL", "FFMA", "FMNMX", "FSETP", "FSEL", "FRND",
            "DADD", "DMUL", "DFMA", "F2F", "MUFU.RCP", "MUFU.RSQ",
            "MUFU.LG2", "MUFU.EX2", "MUFU.SQRT", "MUFU.RCP64H",
            "MUFU.RSQ64H", "BRA", "CALL", "LDS", "STS", "LDL", "STL")
# The classes of SASS_OPS that op_classes sums: double-precision arithmetic
# (the 64H MUFU ops are the double reciprocal and reciprocal square root's
# seeds), single-precision arithmetic, compares and selects, every
# special-function op, local-memory (spill) traffic.
OP_CLASSES = {
    "fp64": ("DADD", "DMUL", "DFMA", "MUFU.RCP64H", "MUFU.RSQ64H"),
    "fp32": ("FADD", "FMUL", "FFMA", "FMNMX", "FSETP", "FSEL", "FRND"),
    "mufu": tuple(op for op in SASS_OPS if op.startswith("MUFU")),
    "local": ("LDL", "STL"),
}
ROUNDS = 3
# The path tracer's instances timed in every tree at the path's full width
# (B=8, S=9, 256^2, spp 16 forward and 8 backward): (kernel, SVBRDF dtype
# name, scene gradients).
PATHTRACE_TIMED = {
    "pathtrace_shade": ("pathtrace_shade", "float32", False),
    "pathtrace_shade_bf16": ("pathtrace_shade", "bfloat16", False),
    "pathtrace_shade_vjp": ("pathtrace_shade_vjp", "float32", False),
    "pathtrace_shade_vjp_bf16": ("pathtrace_shade_vjp", "bfloat16", False),
    "pathtrace_shade_vjp_scene": ("pathtrace_shade_vjp", "float32", True),
    "pathtrace_shade_vjp_scene_bf16": ("pathtrace_shade_vjp", "bfloat16",
                                       True),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def tree_sources(csrc: Path) -> tuple:
    """The sources a tree is built from: the loss kernels', SR-Adam's and,
    where the tree has it, the path tracer's."""
    own = (PT_SOURCE,) if (csrc / f"{PT_SOURCE}.cu").exists() else ()
    return SOURCES + (SR_SOURCE,) + own


def build(trees: dict) -> dict:
    """Compile every tree's sources at once; {tree: ptxas text}."""
    from svbrdf_tpu_torch.ops import _build

    nvcc = _build._nvcc()
    procs = []
    start = time.perf_counter()
    for name, csrc in trees.items():
        out = csrc / "_build"
        out.mkdir(exist_ok=True)
        for source in tree_sources(csrc):
            cmd = [nvcc, *_build.NVCC_FLAGS, "-o",
                   str(out / f"lib{source}.so"), str(csrc / f"{source}.cu")]
            procs.append((name, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
    logs = {}
    for name, proc in procs:
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for tree {name}:\n{text}")
        logs[name] = logs.get(name, "") + text
    log(f"built {len(procs)} libraries in {time.perf_counter() - start:.1f} s")
    return logs


def kernel_key(name: str, dtype) -> str:
    """How kernel `name`'s instance for planes of `dtype` is reported:
    `name`, or `name`_bf16."""
    from svbrdf_tpu_torch.ops import render_fused as rf

    return name + rf.PLANE_DTYPES[dtype]


def _kernel_of(mangled: str):
    for kernel, patterns in SASS_NAMES.items():
        if any(pattern in mangled for pattern in patterns):
            return kernel + ("_bf16" if BF16_MANGLED in mangled else "")
    return None


def ptxas_lines(text: str) -> dict:
    """{kernel: {"registers": n, "spill_stores": b, "spill_loads": b}}."""
    out, current = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            current = _kernel_of(m.group(1))
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out.setdefault(current, {}).update(
                spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.setdefault(current, {})["registers"] = int(m.group(1))
    return out


def sass_text(lib: Path) -> str:
    """cuobjdump -sass of a built library (cuobjdump beside nvcc)."""
    from svbrdf_tpu_torch.ops import _build

    cuobjdump = str(Path(_build._nvcc()).with_name("cuobjdump"))
    return subprocess.run([cuobjdump, "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout


def sass_mix(lib: Path) -> dict:
    """{kernel: {op: count, "total": n}} of a library (cuobjdump -sass)."""
    return parse_sass(sass_text(lib))


_INSTRUCTION = re.compile(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                          r"([A-Z][A-Z0-9_.]*)(.*)")


def parse_sass(text: str) -> dict:
    """{kernel: {op: count, "total": n}} from cuobjdump -sass output: every
    instruction counts in the total, the SASS_OPS by name (MUFU by its
    function, the others without their modifiers)."""
    out, current = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            current = _kernel_of(m.group(1))
            if current:
                out[current] = {"total": 0}
            continue
        m = _INSTRUCTION.match(line)
        if m and current:
            key = _op_key(m.group(2))
            counts = out[current]
            counts["total"] += 1
            if key in SASS_OPS:
                counts[key] = counts.get(key, 0) + 1
    return out


def _op_key(op: str) -> str:
    """How an instruction is counted: MUFU by its function, the others
    without their modifiers."""
    return op if op.startswith("MUFU") else op.split(".")[0]


def op_classes(mix: dict) -> dict:
    """{class: count} of OP_CLASSES in a SASS mix (parse_sass's counts for
    one kernel or one loop), and the total."""
    out = {name: sum(mix.get(op, 0) for op in ops)
           for name, ops in OP_CLASSES.items()}
    out["total"] = mix.get("total", 0)
    return out


def sass_loops(text: str, kernel: str) -> list:
    """The loops of kernel `kernel`'s SASS (cuobjdump -sass output): for
    each backward branch, the static instructions from its target to it,
    {"first": address, "last": address, "instructions": n, "ldg128": n,
    "stg128": n} (16-byte global loads and stores), innermost first. Branch
    targets may be labels (.L_x_N, as CUDA 12 prints them) or addresses."""
    instructions, labels = _instructions(text, kernel)
    loops = []
    for address, op, rest in instructions:
        if op.split(".")[0] != "BRA":
            continue
        m = (re.search(r"`\((\.L_x_\d+)\)", rest)
             or re.search(r"\b0x([0-9a-f]+)\b", rest))
        if m is None:
            continue
        target = (labels.get(m.group(1)) if m.group(1).startswith(".L")
                  else int(m.group(1), 16))
        if target is None or target > address:
            continue
        body = [o for a, o, _ in instructions if target <= a <= address]
        loops.append({"first": target, "last": address,
                      "instructions": len(body),
                      "ldg128": sum(o.startswith("LDG") and ".128" in o
                                    for o in body),
                      "stg128": sum(o.startswith("STG") and ".128" in o
                                    for o in body)})
    return sorted(loops, key=lambda loop: loop["instructions"])


def _instructions(text: str, kernel: str) -> tuple:
    """([(address, op, operands)], {label: address}) of kernel `kernel`'s
    SASS in cuobjdump -sass output."""
    instructions, labels, pending, current = [], {}, [], None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            current = _kernel_of(m.group(1))
            continue
        if current != kernel:
            continue
        m = re.match(r"\s*(\.L_x_\d+):", line)
        if m:
            pending.append(m.group(1))
            continue
        m = _INSTRUCTION.match(line)
        if m:
            address = int(m.group(1), 16)
            labels.update((label, address) for label in pending)
            pending = []
            instructions.append((address, m.group(2), m.group(3)))
    return instructions, labels


def loop_classes(text: str, kernel: str) -> list:
    """For each loop of kernel `kernel` (sass_loops, innermost first) that
    holds a special-function op (the path tracer's sample loop, and the
    VJP's loop over scenes around it), its address range and op_classes of
    its static instructions."""
    instructions, _ = _instructions(text, kernel)
    out = []
    for loop in sass_loops(text, kernel):
        mix = {"total": 0}
        for address, op, _ in instructions:
            if loop["first"] <= address <= loop["last"]:
                key = _op_key(op)
                mix["total"] += 1
                if key in SASS_OPS:
                    mix[key] = mix.get(key, 0) + 1
        classes = op_classes(mix)
        if classes["mufu"]:
            out.append({"first": loop["first"], "last": loop["last"],
                        **classes})
    return out


def blocks_by_registers(registers: int, threads: int = SR_ADAM_THREADS
                        ) -> int:
    """Blocks of `threads` threads that fit one SM of compute capability
    9.0 by registers alone (a kernel without shared memory): each warp's
    registers allocated in units of 256, 64K registers, 2048 threads and
    32 blocks an SM."""
    per_warp = -(-registers * 32 // 256) * 256
    per_block = per_warp * (threads // 32)
    return min(65536 // per_block, 2048 // threads, 32)


def sr_adam_code(sass: str, ptxas: str) -> dict:
    """{kernel: {"registers", "spill_stores", "spill_loads", "sass_total",
    "blocks_per_sm", "loops": {kind: loop + per_element}}} for each SR-Adam
    kernel in a library's SASS text (cuobjdump -sass) and its ptxas log
    (registers None where the log has none). A loop of SR_ADAM_LOOPS is
    the smallest with its 16-byte loads and stores; its instructions, the
    division's slow-path calls inside it included, over its 8 elements are
    its instructions per element."""
    regs, totals, out = ptxas_lines(ptxas), parse_sass(sass), {}
    for kernel in ("sr_adam", "sr_adam_bf16mu"):
        if kernel not in totals:
            continue
        entry = {"registers": None, **regs.get(kernel, {}),
                 "sass_total": totals[kernel]["total"], "loops": {}}
        if entry["registers"] is not None:
            entry["blocks_per_sm"] = blocks_by_registers(entry["registers"])
        loops = sass_loops(sass, kernel)
        for kind, (ldg, stg) in SR_ADAM_LOOPS.items():
            found = [loop for loop in loops
                     if (loop["ldg128"], loop["stg128"]) == (ldg, stg)]
            if found:
                entry["loops"][kind] = dict(
                    found[0], per_element=found[0]["instructions"] / 8)
        out[kernel] = entry
    return out


def pathtrace_code(csrc: Path, ptxas: str):
    """pathtrace_library_code of a built tree, or None for a tree without
    pathtrace.cu."""
    if PT_SOURCE not in tree_sources(csrc):
        return None
    return pathtrace_library_code(csrc / "_build" / f"lib{PT_SOURCE}.so",
                                  ptxas)


def pathtrace_library_code(lib_path: Path, ptxas: str) -> dict:
    """{instance: {"ptxas", "sass", "classes", "loops", "blocks_per_sm"}}
    of the path tracer's kernels in a built libpathtrace (each kernel's
    f32 instance under its name, the bf16 one as <name>_bf16; "ptxas" and
    "sass" None where the log or the SASS lacks the instance) and ptxas's
    log of its build."""
    lib = ctypes.CDLL(str(lib_path))
    sass = sass_text(lib_path)
    regs, mix, out = ptxas_lines(ptxas), parse_sass(sass), {}
    for kernel, (entry, args) in PATHTRACE_BLOCKS.items():
        for suffix in ("", "_bf16"):
            query = getattr(lib, f"{entry}{suffix}_blocks_per_sm")
            query.argtypes = [ctypes.c_int] * len(args)
            query.restype = ctypes.c_int
            name = kernel + suffix
            out[name] = {"ptxas": regs.get(name), "sass": mix.get(name),
                         "classes": op_classes(mix.get(name, {})),
                         "loops": loop_classes(sass, name),
                         "blocks_per_sm": query(*args)}
    return out


@contextlib.contextmanager
def pathtrace_library(lib):
    """Route ops/pathtrace's CUDA wrappers to the kernels of `lib` (a
    tree's loaded libpathtrace.so) inside the block, and back after it."""
    from svbrdf_tpu_torch.ops import pathtrace as pt

    threads = lib.svbrdf_pathtrace_threads
    threads.argtypes = []
    threads.restype = ctypes.c_int
    saved = dict(pt._FUNCS), pt.threads_per_block
    pt._FUNCS.clear()
    pt._FUNCS.update({(name, dtype): pt._bind(lib, name, dtype)
                      for name in pt._ENTRIES for dtype in pt.FIELD_DTYPES})
    pt.threads_per_block = threads
    try:
        yield
    finally:
        pt._FUNCS.clear()
        pt._FUNCS.update(saved[0])
        pt.threads_per_block = saved[1]


def pathtrace_agreement(libs: dict) -> dict:
    """{tree: {case: agreement}}: each tree's path tracer kernels on every
    bench_setup.PATHTRACE_CASES case against the package's plain versions
    and float64 (bench_setup.pathtrace_agreement, hold_pathtrace_kernels's
    rules, reported and not raised: an older tree or a variant may fail
    them), the references computed once a case."""
    import torch

    from svbrdf_tpu_torch.utils import bench_setup

    out = {name: {} for name in libs}
    for label, (batch, height, width, spp, dtype, scene_grads) in \
            bench_setup.PATHTRACE_CASES.items():
        case = bench_setup.pathtrace_case(batch, height, width, spp,
                                          dtype=dtype)
        refs = bench_setup.pathtrace_references(case, scene_grads)
        for name, lib in libs.items():
            with pathtrace_library(lib):
                out[name][label] = bench_setup.pathtrace_agreement(
                    case, refs, scene_grads)
            log(f"{name} pathtrace {label}: {json.dumps(out[name][label])}")
        del case, refs
        torch.cuda.empty_cache()
    return out


def cuda_ms(fn, runs: int = 20, warmup: int = 3) -> float:
    """Median of `runs` CUDA-event timings of fn() after `warmup` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def kernel_ms(name: str, inputs, kernel=None, reps: int = 10,
              runs: int = 20) -> float:
    """Device time of one raw launch of loss kernel `name` on `inputs`
    (bench_setup.loss_inputs on the card): the median over `runs` of `reps`
    back-to-back launches between two CUDA events, divided by reps. A launch
    queued before the start event keeps the card busy while the host queues
    the rest, so the events time the kernels alone (no wrapper sum of the
    partials, no host gaps). `kernel` is as for render_fused._launch."""
    import torch

    from svbrdf_tpu_torch.ops import render_fused as rf

    pred_t, _, scenes9 = inputs
    floats = rf.kernel_floats(name, pred_t, scenes9)

    def launch():
        rf._launch(name, *inputs, 0, 0, floats, kernel)

    for _ in range(3):
        launch()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        launch()
        start.record()
        for _ in range(reps):
            launch()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / reps)
    return statistics.median(times)


def pathtrace_times(libs: dict) -> dict:
    """{tree: {instance: {"ms", "ms_rounds"}}}: each PATHTRACE_TIMED
    instance of each tree through the package's wrappers at full width
    (bench_setup.pathtrace_case), the median of 20 CUDA-event timings
    (cuda_ms), in ROUNDS rounds that alternate the order of
    the trees; the median of the rounds."""
    import torch

    from svbrdf_tpu_torch.ops import pathtrace as pt
    from svbrdf_tpu_torch.utils import bench_setup

    cases = {dtype: bench_setup.pathtrace_case(8, 256, 256, (16, 8),
                                               dtype=getattr(torch, dtype))
             for dtype in ("float32", "bfloat16")}

    def call(kernel, dtype, scene_grads):
        case = cases[dtype]
        if kernel == "pathtrace_shade":
            return lambda: pt.shade_cuda(*case["flat"])
        return lambda: pt.shade_vjp_cuda(*case["flat_bwd"], case["d_sample"],
                                         scene_grads=scene_grads)

    names = list(libs)
    rounds = {name: {k: [] for k in PATHTRACE_TIMED} for name in names}
    for r in range(ROUNDS):
        for name in (names if r % 2 == 0 else names[::-1]):
            with pathtrace_library(libs[name]):
                for instance, spec in PATHTRACE_TIMED.items():
                    rounds[name][instance].append(
                        cuda_ms(call(*spec)))
    return {name: {k: {"ms": statistics.median(v), "ms_rounds": v}
                   for k, v in per.items()} for name, per in rounds.items()}


class Tree:
    """The kernels of one built tree, bound as render_fused binds the
    package's own: {(name, plane dtype): (C entry, threads)} for every
    entry the tree exports (an older tree has no bf16 entries)."""

    def __init__(self, csrc: Path):
        from svbrdf_tpu_torch.ops import render_fused as rf

        libs = {s: ctypes.CDLL(str(csrc / "_build" / f"lib{s}.so"))
                for s in SOURCES}
        self.kernels, self.per_sm = {}, {}
        for name, (source, _, _, _) in rf._ENTRIES.items():
            for dtype in rf.PLANE_DTYPES:
                symbol = rf.symbol(name, dtype)
                if not hasattr(libs[source], symbol):
                    continue
                self.kernels[name, dtype] = rf._bind(libs[source], name,
                                                     dtype)
                # An older tree may not export the occupancy query.
                per_sm = getattr(libs[source], f"{symbol}_blocks_per_sm",
                                 None)
                if per_sm is not None:
                    per_sm.argtypes = [ctypes.c_int]
                    per_sm.restype = ctypes.c_int
                self.per_sm[name, dtype] = per_sm

    def blocks_per_sm(self, key, n_scenes: int):
        per_sm = self.per_sm[key]
        return None if per_sm is None else per_sm(n_scenes)

    def launch(self, key, pred, gt, scenes9):
        """(partials, output planes...) of one launch of kernel key = (name,
        dtype) on a whole image (pred and gt of that dtype)."""
        from svbrdf_tpu_torch.ops import render_fused as rf

        name = key[0]
        return rf._launch(name, pred, gt, scenes9, 0, 0,
                          rf.kernel_floats(name, pred, scenes9),
                          self.kernels[key])


def _loss_rel(tree: Tree, key, inputs) -> tuple:
    """(loss rel against the plain version, kernel outputs, plain
    outputs) of one launch."""
    from svbrdf_tpu_torch.ops import render_fused as rf

    import torch

    name = key[0]
    pred, gt, scenes9 = inputs
    partials, *planes = tree.launch(key, pred, gt, scenes9)
    ref = rf.PLAIN_VERSIONS[name](pred, gt, scenes9)
    ref = ref if isinstance(ref, tuple) else (ref,)
    # The loss from the partials, as the kernel's wrapper takes it.
    loss = float(torch.sum(partials))
    if not name.startswith("mixed"):
        loss /= rf._rendering_count(pred, scenes9, 0)
    return abs(loss - float(ref[0])) / abs(float(ref[0])), planes, ref[1:]


def against_plain(tree: Tree, key, inputs, near) -> dict:
    import torch

    rel, planes, ref_planes = _loss_rel(tree, key, inputs)
    errs = [float((g.float() - r.float()).abs().max() / r.float().abs().max())
            for g, r in zip(planes, ref_planes)]
    _, gt, scenes9 = inputs
    zero = tree.launch(key, gt.clone(), gt, scenes9)
    return {"loss_rel": rel, "loss_rel_near": _loss_rel(tree, key, near)[0],
            "grad_err_ratio": max(errs) if errs else None,
            "zero_for_equal": all(int(torch.count_nonzero(z)) == 0
                                  for z in zero)}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("trees", nargs="*", metavar="NAME=DIR")
    parser.add_argument("--out", default="")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        sys.exit("compare_builds: needs a CUDA device")
    from svbrdf_tpu_torch.ops import _build, render_fused as rf
    from svbrdf_tpu_torch.utils.bench_setup import (loss_inputs,
                                                    loss_inputs_near)

    trees = {}
    for item in args.trees:
        name, _, path = item.partition("=")
        if not path or name == "csrc":
            sys.exit(f"compare_builds: expected NAME=DIR (NAME not csrc), "
                     f"got {item!r}")
        trees[name] = Path(path).resolve()
    # The package's own sources build in a copy under the package's build
    # directory, beside its libraries.
    own = _build.BUILD_DIR / "compare_builds_csrc"
    shutil.rmtree(own, ignore_errors=True)
    shutil.copytree(_build.CSRC, own)
    trees["csrc"] = own

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    result = {"card": card, "torch": torch.__version__, "trees": {}}
    logs = build(trees)
    # Far and near inputs per plane dtype; the bf16 ones are the f32 ones
    # rounded.
    inputs = {dtype: (loss_inputs(8, 256, 9, dtype=dtype),
                      loss_inputs_near(8, 256, 9, dtype=dtype))
              for dtype in rf.PLANE_DTYPES}
    built = {}
    for name, csrc in trees.items():
        sass = sass_text(csrc / "_build" / f"lib{SR_SOURCE}.so")
        result.setdefault("sr_adam", {})[name] = sr_adam_code(sass,
                                                              logs[name])
        log(f"{name} sr_adam: {json.dumps(result['sr_adam'][name])}")
        code = pathtrace_code(csrc, logs[name])
        result.setdefault("pathtrace", {})[name] = code
        log(f"{name} pathtrace: " + (json.dumps(code) if code is not None
                                     else "no pathtrace.cu in this tree, "
                                     "skipped"))
        regs = ptxas_lines(logs[name])
        mix = {}
        for source in SOURCES:
            mix.update(sass_mix(csrc / "_build" / f"lib{source}.so"))
        built[name] = Tree(csrc)
        per_kernel = {}
        for key in built[name].kernels:
            k = kernel_key(*key)
            per_kernel[k] = {
                "ptxas": regs.get(k), "sass": mix.get(k),
                "blocks_per_sm": built[name].blocks_per_sm(key, 9),
                **against_plain(built[name], key, *inputs[key[1]])}
            log(f"{name} {k}: {json.dumps(per_kernel[k])}")
        result["trees"][name] = per_kernel
    libs = {name: ctypes.CDLL(str(csrc / "_build" / f"lib{PT_SOURCE}.so"))
            for name, csrc in trees.items()
            if PT_SOURCE in tree_sources(csrc)}
    result["pathtrace_agreement"] = pathtrace_agreement(libs)
    for name, per in pathtrace_times(libs).items():
        for instance, times in per.items():
            result["pathtrace"][name][instance].update(times)
        log(f"{name} pathtrace ms: " + ", ".join(
            f"{k} {v['ms']:.4f}" for k, v in per.items()))
    names = list(trees)
    rounds = {name: {key: [] for key in built[name].kernels}
              for name in names}
    for r in range(ROUNDS):
        for name in (names if r % 2 == 0 else names[::-1]):
            for key, kernel in built[name].kernels.items():
                rounds[name][key].append(
                    kernel_ms(key[0], inputs[key[1]][0], kernel))
    for name in names:
        for key, times in rounds[name].items():
            entry = result["trees"][name][kernel_key(*key)]
            entry["ms"] = statistics.median(times)
            entry["ms_rounds"] = times
        log(f"{name} ms: " + ", ".join(
            f"{k} {v['ms']:.4f}" for k, v in result["trees"][name].items()))
    text = json.dumps(result)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)


if __name__ == "__main__":
    main()
