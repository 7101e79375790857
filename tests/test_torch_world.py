"""The port's own data modules (``mega_minecraft_tpu_torch/world``) vs the JAX package's.

The port imports nothing of ``mega_minecraft_tpu``; it keeps copies of the numpy-only
``world/{blocks,biomes,features_data,block_uvs}.py`` and of the numpy tables of
``render/materials.py``.  These tests hold every public table, enum member and scalar
constant of the copies equal to the originals (tolerance: none, the values are equal),
and check in a fresh interpreter that importing the whole port pulls in neither ``jax``
nor any module of the JAX package.
"""

from __future__ import annotations

import enum
import importlib
import pkgutil
import subprocess
import sys
import types

import numpy as np
import pytest

import mega_minecraft_tpu_torch

MODULES = ["blocks", "biomes", "features_data", "block_uvs"]


def _public(mod):
    return {k: v for k, v in vars(mod).items()
            if not k.startswith("_") and not isinstance(v, types.ModuleType)
            and not (callable(v) and not isinstance(v, type))}


def _same(a, b) -> bool:
    if isinstance(a, type) and issubclass(a, enum.Enum):
        return (isinstance(b, type) and issubclass(b, enum.Enum)
                and [(m.name, m.value) for m in a] == [(m.name, m.value) for m in b])
    if isinstance(a, enum.Enum):
        return isinstance(b, enum.Enum) and (a.name, a.value) == (b.name, b.value)
    if isinstance(a, np.ndarray):
        return isinstance(b, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape \
            and np.array_equal(a, b)
    if isinstance(a, dict):
        return isinstance(b, dict) and list(a.keys()) == list(b.keys()) \
            and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, type):  # a class other than an enum (dataclass, NamedTuple)
        return isinstance(b, type) and a.__name__ == b.__name__
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("name", MODULES)
def test_world_copy_equals_reference(name):
    ref = _public(importlib.import_module(f"mega_minecraft_tpu.world.{name}"))
    got = _public(importlib.import_module(f"mega_minecraft_tpu_torch.world.{name}"))
    assert sorted(got) == sorted(ref)
    assert len(ref) > 5 or name == "block_uvs"
    differing = [k for k in ref if not _same(ref[k], got[k])]
    assert not differing, differing


def test_material_tables_equal_reference():
    """The render material tables (palette, packed props, the procedural atlas and the
    face / variant texel tables, alpha flags) equal the JAX package's."""
    ref = _public(importlib.import_module("mega_minecraft_tpu.render.materials"))
    got = _public(importlib.import_module("mega_minecraft_tpu_torch.render.materials"))
    assert sorted(got) == sorted(ref)
    assert {"BLOCK_PROPS", "TEX_DIFF_PACKED", "TEX_EMIS_PACKED", "TEX_NORM_PACKED",
            "ALPHA_TESTED", "ALPHA_T_FRAC", "MAT_IOR"} <= set(ref)
    differing = [k for k in ref if not _same(ref[k], got[k])]
    assert not differing, differing


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    names = [m.name for m in pkgutil.walk_packages(mega_minecraft_tpu_torch.__path__,
                                                   "mega_minecraft_tpu_torch.")]
    assert "mega_minecraft_tpu_torch.terrain.features_sdf" in names
    assert "mega_minecraft_tpu_torch.render.tracer" in names
    code = (
        "import importlib, sys\n"
        f"for n in {['mega_minecraft_tpu_torch'] + names!r}:\n"
        "    importlib.import_module(n)\n"
        "bad = [k for k in sys.modules if k == 'jax' or k.startswith('jax.')\n"
        "       or k == 'mega_minecraft_tpu' or k.startswith('mega_minecraft_tpu.')]\n"
        "assert not bad, bad\n"
        "print('clean', len(sys.modules))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("clean")
