"""Build the loss kernels of several csrc/ trees side by side and time them
in one process on one card.

    python3 -m svbrdf_tpu_torch.utils.compare_builds [--out FILE] NAME=DIR ...

Each DIR holds a copy of svbrdf_tpu_torch/csrc/ (an older commit's, made
with `git archive COMMIT svbrdf_tpu_torch/csrc | tar -x -C DIR
--strip-components=2`, or a variant of the current one) with the same C
interface: the launch entries of ops/render_fused._ENTRIES and
svbrdf_<source>_threads. The package's own csrc/ is always compared, as
"csrc". For every tree, both sources are built with the package's nvcc
flags (ops/_build.NVCC_FLAGS) into DIR/_build, one nvcc per source, all
started together, and for each of the five kernels it reports:
  - ptxas registers and spill bytes;
  - the SASS instruction mix (cuobjdump -sass): FP32 adds, multiplies and
    FMAs, each MUFU op, branches and calls (the division and square-root
    slow paths are calls), shared and local memory loads and stores;
  - blocks per SM, where the tree exports <symbol>_blocks_per_sm;
  - loss rel and max |gradient error| / max |gradient| against the
    package's plain versions on the same inputs, and whether pred = gt
    gives exactly 0. Printed, not held: an older tree may compute the same
    function with other roundings;
  - device time at the main path's shapes (B=8, 256^2, S=9): 10
    back-to-back launches between CUDA events, median of 20
    (bench_setup.kernel_ms), in ROUNDS rounds that alternate the order of the trees; the median of the rounds
    and every round.
Prints one JSON object last; --out also writes it to FILE. Needs a CUDA
device and the CUDA toolkit.
"""

from __future__ import annotations

import argparse
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
# The mangled name of each kernel's template instance in the SASS.
SASS_NAMES = {
    "mixed_fwdgrad": "mixed_loss_kernelILb1E",
    "mixed_fwd": "mixed_loss_kernelILb0E",
    "render_fwdgrad": "rendering_loss_kernelILb1ELb0E",
    "render_fwd": "rendering_loss_kernelILb0ELb0E",
    "render_fwdgrad_both": "rendering_loss_kernelILb1ELb1E",
}
SASS_OPS = ("FADD", "FMUL", "FFMA", "MUFU.RCP", "MUFU.RSQ", "MUFU.LG2",
            "MUFU.EX2", "MUFU.SQRT", "BRA", "CALL", "LDS", "STS", "LDL",
            "STL")
ROUNDS = 3


def log(msg: str) -> None:
    print(msg, flush=True)


def build(trees: dict) -> dict:
    """Compile every tree's sources at once; {tree: ptxas text}."""
    from svbrdf_tpu_torch.ops import _build

    nvcc = _build._nvcc()
    procs = []
    start = time.perf_counter()
    for name, csrc in trees.items():
        out = csrc / "_build"
        out.mkdir(exist_ok=True)
        for source in SOURCES:
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


def _kernel_of(mangled: str):
    for kernel, pattern in SASS_NAMES.items():
        if pattern in mangled:
            return kernel
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


def sass_mix(lib: Path) -> dict:
    """{kernel: {op: count, "total": n}} of a library (cuobjdump -sass)."""
    from svbrdf_tpu_torch.ops import _build

    cuobjdump = str(Path(_build._nvcc()).with_name("cuobjdump"))
    return parse_sass(subprocess.run(
        [cuobjdump, "-sass", str(lib)], check=True, capture_output=True,
        text=True).stdout)


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
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                     r"([A-Z][A-Z0-9_.]*)", line)
        if m and current:
            op = m.group(1)
            key = op if op.startswith("MUFU") else op.split(".")[0]
            counts = out[current]
            counts["total"] += 1
            if key in SASS_OPS:
                counts[key] = counts.get(key, 0) + 1
    return out


class Tree:
    """The five kernels of one built tree, bound as render_fused binds the
    package's own."""

    def __init__(self, csrc: Path):
        from svbrdf_tpu_torch.ops import render_fused as rf

        libs = {s: ctypes.CDLL(str(csrc / "_build" / f"lib{s}.so"))
                for s in SOURCES}
        self.kernels, self.per_sm = {}, {}
        for name, (source, symbol, _, _) in rf._ENTRIES.items():
            self.kernels[name] = rf._bind(libs[source], name)
            # An older tree may not export the occupancy query.
            per_sm = getattr(libs[source], f"{symbol}_blocks_per_sm", None)
            if per_sm is not None:
                per_sm.argtypes = [ctypes.c_int]
                per_sm.restype = ctypes.c_int
            self.per_sm[name] = per_sm

    def blocks_per_sm(self, name: str, n_scenes: int):
        per_sm = self.per_sm[name]
        return None if per_sm is None else per_sm(n_scenes)

    def launch(self, name, pred, gt, scenes9):
        """(partials, output planes...) of one launch on a whole image."""
        from svbrdf_tpu_torch.ops import render_fused as rf

        return rf._launch(name, pred, gt, scenes9, 0, 0,
                          rf.kernel_floats(name, pred, scenes9),
                          self.kernels[name])


def against_plain(tree: Tree, name: str, inputs) -> dict:
    from svbrdf_tpu_torch.ops import render_fused as rf

    import torch

    pred, gt, scenes9 = inputs
    partials, *planes = tree.launch(name, pred, gt, scenes9)
    ref = rf.PLAIN_VERSIONS[name](pred, gt, scenes9)
    ref = ref if isinstance(ref, tuple) else (ref,)
    # The loss from the partials, as the kernel's wrapper takes it.
    loss = float(torch.sum(partials))
    if not name.startswith("mixed"):
        loss /= rf._rendering_count(pred, scenes9, 0)
    errs = [float((g - r).abs().max() / r.abs().max())
            for g, r in zip(planes, ref[1:])]
    zero = tree.launch(name, gt.clone(), gt, scenes9)
    return {"loss_rel": abs(loss - float(ref[0])) / abs(float(ref[0])),
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
    from svbrdf_tpu_torch.utils.bench_setup import kernel_ms, loss_inputs

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
    inputs = loss_inputs(8, 256, 9)
    built = {}
    for name, csrc in trees.items():
        regs = ptxas_lines(logs[name])
        mix = {}
        for source in SOURCES:
            mix.update(sass_mix(csrc / "_build" / f"lib{source}.so"))
        built[name] = Tree(csrc)
        per_kernel = {}
        for kernel in rf._ENTRIES:
            per_kernel[kernel] = {
                "ptxas": regs.get(kernel), "sass": mix.get(kernel),
                "blocks_per_sm": built[name].blocks_per_sm(kernel, 9),
                **against_plain(built[name], kernel, inputs)}
            log(f"{name} {kernel}: {json.dumps(per_kernel[kernel])}")
        result["trees"][name] = per_kernel
    names = list(trees)
    rounds = {name: {k: [] for k in rf._ENTRIES} for name in names}
    for r in range(ROUNDS):
        for name in (names if r % 2 == 0 else names[::-1]):
            for kernel in rf._ENTRIES:
                rounds[name][kernel].append(
                    kernel_ms(kernel, inputs, built[name].kernels[kernel]))
    for name in names:
        for kernel, times in rounds[name].items():
            entry = result["trees"][name][kernel]
            entry["ms"] = statistics.median(times)
            entry["ms_rounds"] = times
        log(f"{name} ms: " + ", ".join(
            f"{k} {result['trees'][name][k]['ms']:.4f}" for k in rf._ENTRIES))
    text = json.dumps(result)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)


if __name__ == "__main__":
    main()
