"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each source in csrc/ exposes a plain C interface, so it compiles in seconds
without PyTorch's headers. Libraries go into svbrdf_tpu_torch/_build/ (not
committed), named after a hash of the source, every header in csrc/ and
the flags, so an edited source or shared header is rebuilt and a stale
library is never loaded. Nothing is built when the package is imported:
the first call that needs a kernel builds it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("mixed_loss", "rendering_loss", "sr_adam", "pathtrace",
           "norm_merge", "styled_tail")

# No --use_fast_math and -fmad=false, for the gradient kernels: they are
# bit-exact against their plain torch versions, which needs IEEE logf and
# reciprocals and no FMA contraction (with contraction the pred and gt
# sides of a loss rounded otherwise; see the note in csrc/mixed_loss.cu).
# The value-only kernels choose their own roundings in the source
# (approximate rsqrt and reciprocal as inline PTX, FMAs written as fmaf,
# which -fmad=false leaves fused; csrc/value_shading.cuh), so the flags
# stay per file and no kernel of the two files changes the other's.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LOADED = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or at /usr/local/cuda/bin; "
                           "the CUDA kernels are built on the machine with "
                           "the card")
    return path


def library_path(name: str, csrc: Path = CSRC) -> Path:
    """Where the library of csrc/<name>.cu lives: named after a hash of the
    source, of every csrc/*.cuh (a source may include any of them) and of
    the flags."""
    h = hashlib.sha256((csrc / f"{name}.cu").read_bytes())
    for header in sorted(csrc.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict:
    """Compile every named source that has no up-to-date library, with one
    nvcc process per source, all started together.

    Returns {name: {"seconds": wall time, "log": compiler output}} for the
    sources compiled by this call. Raises after every process has ended if
    any of them failed.
    """
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    start = time.perf_counter()
    for name in todo:
        out = library_path(name)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    report, failed = {}, []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        report[name] = {"seconds": time.perf_counter() - start, "log": log}
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu "
                          f"(exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built first if needed."""
    if name not in _LOADED:
        build([name])
        _LOADED[name] = ctypes.CDLL(str(library_path(name)))
    return _LOADED[name]


def host_build(text: str, flags, stem: str) -> ctypes.CDLL:
    """C++ source `text` compiled for the host with g++ and `flags` into
    BUILD_DIR (lib<stem>-<hash of the text and flags>.so, once for each)
    and loaded: the host emulations of the kernels (utils/host_*.py)."""
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the host build needs it")
    digest = hashlib.sha256((text + " ".join(flags)).encode()).hexdigest()
    out = BUILD_DIR / f"lib{stem}-{digest[:16]}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        src = out.with_name(f"{out.stem}.{os.getpid()}.cpp")
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        src.write_text(text)
        try:
            subprocess.run([cxx, *flags, "-o", str(tmp), str(src)],
                           check=True, capture_output=True, text=True)
        finally:
            src.unlink()
        os.replace(tmp, out)
    return ctypes.CDLL(str(out))
