"""Build ``csrc/*.cu`` with nvcc into one shared library and load it with ctypes.

The library has a plain C interface (no PyTorch headers), so one nvcc call over the
four kernel files takes seconds.  It is built at first use into
``build/mmt_kernels/`` at the checkout root, and rebuilt when the hash of the sources,
the generated id header or the flags changes.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

from mega_minecraft_tpu.world import biomes as bio
from mega_minecraft_tpu.world.blocks import Block

from .. import tables

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "mmt_kernels"
LIB_NAME = "libmmt_kernels.so"

#: sm_90a, no fused multiply-add contraction, IEEE div/sqrt (no fast math): the
#: hashes' Dekker products are only exact without FMA, and the reference goldens
#: were built with -ffp-contract=off
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
#: C entry points: name -> argtypes (all return a cudaError_t as int)
SIGNATURES = {
    # pos, B, noise_w, out hf, out w, stream
    "mmt_heightfield": [_P, _I, _P, _P, _P, _P],
    # hf_halo, w_halo, pos_halo, ncx, ncz, bmw, thickness, amplitude, scale, dirs,
    # out layers, out hf_in, out w_in, out pos_in, stream
    "mmt_layers": [_P, _P, _P, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P],
    # hf, w, pos, B, cave_noise_w, scratch carved, out starts, ends, bottom, top, stream
    "mmt_caves": [_P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P],
    # hf, w, layers, starts, ends, pos, B, grass, mat_block, cave_noise_w, out blocks, stream
    "mmt_fill": [_P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P],
}


def ids_header() -> str:
    """C #defines for every block / biome / cave-biome id and scalar constant, made
    from the numpy modules so the kernels and the plain versions share one source."""
    lines = ["// generated by mega_minecraft_tpu_torch/kernels/_build.py; do not edit", "#pragma once"]
    lines += [f"#define BLOCK_{b.name} {int(b)}" for b in Block]
    lines += [f"#define BIOME_{b.name} {int(b)}" for b in bio.Biome]
    lines += [f"#define CAVE_{b.name} {int(b)}" for b in bio.CaveBiome]
    for name in (
        "NUM_BIOMES", "NUM_OCEAN_BIOMES", "NUM_OCEAN_AND_BEACH_BIOMES", "NUM_CAVE_BIOMES",
        "NUM_MATERIALS", "NUM_STRATIFIED_MATERIALS", "NUM_FORWARD_MATERIALS",
        "SEA_LEVEL", "LAVA_LEVEL", "MAX_CAVE_LAYERS_PER_COLUMN",
    ):
        lines.append(f"#define {name} {int(getattr(bio, name))}")
    for name in (
        "Y_SIZE", "CARVE_Y_MAX", "CAVE_BIOME_Y_MAX",
        "SEED_BOTTOM_BIOME", "SEED_TOP_BIOME", "SEED_FILL_CAVE_BIOME",
    ):
        lines.append(f"#define {name} {int(getattr(tables, name))}")
    lines.append(f"#define OVERALL_BIOME_SCALE {float(bio.OVERALL_BIOME_SCALE)!r}")
    return "\n".join(lines) + "\n"


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(ids_header().encode())
    for p in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def build(verbose: bool = False) -> tuple[Path, float, bool]:
    """Build the library if its stamp does not match the sources.

    Returns (library path, seconds spent, whether nvcc ran)."""
    t0 = time.perf_counter()
    digest = source_hash()
    lib = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / "stamp"
    if lib.exists() and stamp.exists() and stamp.read_text() == digest:
        return lib, time.perf_counter() - t0, False
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    (BUILD_DIR / "mmt_ids.h").write_text(ids_header())
    with tempfile.NamedTemporaryFile(dir=BUILD_DIR, suffix=".so", delete=False) as tmp:
        tmp_path = Path(tmp.name)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC), "-I", str(BUILD_DIR)]
    if verbose:
        cmd += ["-Xptxas", "-v"]
    cmd += ["-o", str(tmp_path), *map(str, _sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp_path.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    if verbose:
        print(proc.stdout + proc.stderr)
    os.replace(tmp_path, lib)  # atomic: a concurrent loader never sees a partial file
    stamp.write_text(digest)
    return lib, time.perf_counter() - t0, True


_LIB = None


def load() -> ctypes.CDLL:
    """The kernel library, built if needed, with every entry point's argtypes set."""
    global _LIB
    if _LIB is None:
        path, _, _ = build()
        lib = ctypes.CDLL(str(path))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB
