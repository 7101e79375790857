"""No run loads JAX, Flax or the JAX package, and the reference loads nothing of the
program: each module's top-level name (the part before the first dot) is compared whole, so
the port (``mega_minecraft_tpu_torch``) is not taken for the JAX package
(``mega_minecraft_tpu``)."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

from mmbench import run

REFERENCE = Path(__file__).resolve().parents[1] / "reference"
ROOT = REFERENCE.parents[1]
PROGRAM = ("jax", "jaxlib", "flax", "mega_minecraft_tpu", "mega_minecraft_tpu_torch")


def test_names_are_compared_whole(monkeypatch):
    for name in ("mega_minecraft_tpu_torch", "mega_minecraft_tpu_torch.render.tracer", "jaxtyping",
                 "flaxen"):
        monkeypatch.setitem(sys.modules, name, sys)
    found = run.forbidden_modules()
    assert "mega_minecraft_tpu_torch" not in found and "jaxtyping" not in found and "flaxen" not in found
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    monkeypatch.setitem(sys.modules, "mega_minecraft_tpu.terrain", sys)
    assert {"jax", "mega_minecraft_tpu"} <= set(run.forbidden_modules())


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_the_reference_imports_nothing_of_the_program():
    files = sorted(REFERENCE.rglob("*.py"))
    assert len(files) > 20
    for f in files:
        for mod in _imports(f):
            assert mod.split(".")[0] not in PROGRAM, f"{f} imports {mod}"
    code = ("import importlib, pkgutil, sys, mmbench.reference as r\n"
            "for m in pkgutil.walk_packages(r.__path__, 'mmbench.reference.'):\n"
            "    importlib.import_module(m.name)\n"
            "print(sorted({k.split('.')[0] for k in sys.modules} & set(%r)))" % (PROGRAM,))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]", out.stdout + out.stderr


def test_a_run_loads_neither_jax_nor_the_jax_package():
    """A run of the harness (a tiny pre-generation cell on the CPU, the port's plain
    versions), then the same check the harness makes before it prints its result."""
    code = """
import torch
from mmbench import run
from mmbench.tests.rehearse_cpu import tiny_pregen
wl = tiny_pregen()
run.measure(wl, False)
wl.release()
assert all(v <= lim for _, v, lim in wl.check())
import sys
print(run.forbidden_modules(), 'mega_minecraft_tpu_torch' in {k.split('.')[0] for k in sys.modules})
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[] True"
