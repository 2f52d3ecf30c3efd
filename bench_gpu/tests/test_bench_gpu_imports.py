"""No module of the harness loads JAX or the JAX package, and the
reference loads nothing of the program."""

import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]

_BLOCK = """
import importlib.abc, sys
BLOCKED = {"jax", "jaxlib", "flax", "optax", "svbrdf_tpu"}
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".", 1)[0] in BLOCKED:
            raise ImportError(f"blocked: {name}")
sys.meta_path.insert(0, Block())
sys.path.insert(0, %r)
"""


def _run(body: str) -> str:
    out = subprocess.run([sys.executable, "-c", _BLOCK % str(ROOT) + body],
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_every_harness_module_imports_with_jax_blocked():
    modules = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts)
        for p in (ROOT / "bench_gpu").rglob("*.py")
        if "tests" not in p.parts and "metrics" not in p.parts
        and p.name != "__init__.py")
    body = "import importlib\n" + "".join(
        f"importlib.import_module({m!r})\n" for m in modules)
    # The metric readers and the program's entries the drivers call.
    body += """
from bench_gpu import core
for name in [m["name"] for m in core.load_benchmark()["per_layer"]]:
    core.metric_reader(name)
import svbrdf_tpu_torch.estimator, svbrdf_tpu_torch.losses
import svbrdf_tpu_torch.parallel.step, svbrdf_tpu_torch.data.dataset
import svbrdf_tpu_torch.models, svbrdf_tpu_torch.device
print(sorted(m for m in sys.modules if m.split(".", 1)[0] in BLOCKED))
"""
    assert _run(body).strip().endswith("[]")


def test_the_reference_loads_nothing_of_the_program():
    body = """
import importlib, pkgutil
import bench_gpu.reference as ref
for m in pkgutil.iter_modules(ref.__path__):
    importlib.import_module("bench_gpu.reference." + m.name)
print(sorted(m for m in sys.modules
             if m.split(".", 1)[0] == "svbrdf_tpu_torch"))
"""
    assert _run(body).strip().endswith("[]")


def test_the_forbidden_names_are_compared_whole():
    from bench_gpu import core

    saved = dict(sys.modules)
    try:
        sys.modules["svbrdf_tpu_torch_like"] = sys
        assert "svbrdf_tpu_torch_like" not in core.forbidden_modules()
        sys.modules["svbrdf_tpu.ops"] = sys
        assert "svbrdf_tpu.ops" in core.forbidden_modules()
    finally:
        sys.modules.clear()
        sys.modules.update(saved)
