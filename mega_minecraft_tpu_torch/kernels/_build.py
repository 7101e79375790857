"""Build ``csrc/*.cu`` with nvcc into one shared library and load it with ctypes.

The library has a plain C interface (no PyTorch headers).  Every source is compiled to
an object by its own nvcc process, all started together, and the objects are linked
into one library.  It is built at first use into ``build/mmt_kernels/`` at the checkout
root, and rebuilt when the hash of the sources, the generated headers or the flags
changes.  Nothing here runs at import time.
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

import numpy as np

from ..world import biomes as bio
from ..world.blocks import RENDER_SOLID, Block

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
    "-Xcompiler", "-fPIC",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
#: C entry points: name -> argtypes (all return a cudaError_t as int)
SIGNATURES = {
    # pos, B, noise_w, out hf, out w, stream
    "mmt_heightfield": [_P, _I, _P, _P, _P, _P],
    # hf_halo, w_halo, pos_halo, ncx, ncz, bmw, thickness, amplitude, scale, dirs, fix,
    # out layers, out hf_in, out w_in, out pos_in, stream
    "mmt_layers": [_P, _P, _P, _I, _I, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P],
    # d_layers (in/out), d_hf, d_w, nslots, slots, pos, B, bmw, thickness, amplitude, scale,
    # dirs, fix, stream
    "mmt_layers_slots": [_P] * 6 + [_I] + [_P] * 5 + [_I, _P],
    # grid_in (or null), layers (in/out, or null), hf, gslots, fix_all, tan_repose, dirs,
    # out grid, scratch tmp, scratch acc, flags, out iters, stream
    "mmt_erosion": [_P] * 4 + [_I] + [_P] * 8,
    # hf, w, pos, B, cave_noise_w, scratch carved, out starts, ends, bottom, top, stream
    "mmt_caves": [_P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P],
    # hf, w, layers, starts, ends, pos, B, grass, mat_block, cave_noise_w, out blocks, stream
    "mmt_fill": [_P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P],
    # hf, w, layers, starts, ends, bottom_biome, top_biome, pos, B, out surface_feature,
    # surface_y, surface_replace, cave_feature, cave_y, cave_height, cave_replace, stream
    "mmt_placements": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P],
    # the 7 grids of mmt_placements, pos, B, out surface feature, x, y, z, replace, count,
    # out cave feature, x, y, z, replace, height, count, stream
    "mmt_compact_placements": [_P] * 8 + [_I] + [_P] * 13 + [_P],
    # surface x, y, z, cave x, y, z, B, out surface streams, out cave streams, stream
    "mmt_feature_streams": [_P] * 6 + [_I, _P, _P, _P],
    # blocks, surface feature, x, y, z, replace, count, streams, cave feature, x, y, z,
    # replace, height, count, streams, pos, ncx, ncz, out blocks, stream
    "mmt_features": [_P] * 17 + [_I, _I, _P, _P],
    # the 16 list arguments of mmt_features, nslots, pos, B, cull, out blocks, stream
    "mmt_features_slots": [_P] * 18 + [_I, _I, _P, _P],
    # blocks, hf, w, starts, ends, bottom_biome, pos, B, out blocks, stream
    "mmt_decorators": [_P] * 7 + [_I, _P, _P],
    # vol, alpha tables, Z, X, Y, out flat, scratch a, b, mask, top, sky, stream
    "mmt_scene_fields": [_P, _P, _I, _I, _I] + [_P] * 7,
    # &TraceArgs, stream
    "mmt_trace": [_P, _P],
    # &RenderArgs, stream
    "mmt_render_sample": [_P, _P],
    # old colour, albedo, normal, new colour, albedo, normal, count, fid, mult, out x3, stream
    "mmt_accumulate": [_P] * 6 + [ctypes.c_longlong, ctypes.c_float, ctypes.c_float] + [_P] * 4,
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


def _c_array(name: str, a, ctype: str | None = None) -> str:
    """A numpy array as a ``static __device__ const`` C array (f32 values are written
    with enough digits to round back to the same f32)."""
    a = np.asarray(a)
    if ctype is None:
        ctype = "float" if a.dtype.kind == "f" else "int"
    if ctype == "float":
        vals = [repr(float(np.float32(v))) + "f" for v in a.reshape(-1)]
    elif ctype == "uint32_t":
        vals = [f"{int(v)}u" for v in a.reshape(-1)]
    else:
        vals = [str(int(v)) for v in a.reshape(-1)]
    dims = "".join(f"[{n}]" for n in a.shape)
    return f"static __device__ const {ctype} {name}{dims} = {{{', '.join(vals)}}};"


def feature_tables_header() -> str:
    """C tables of the feature half (K5-K8): feature ids, height bounds, the placement gen
    tables, seeds, caps, gather offsets, the application windows and the decorator gens,
    made from the same numpy tables and module constants the plain versions read."""
    from ..terrain import decorators, feature_placement as fp, features, features_sdf as sdf
    from ..world import features_data as fd
    from ..world.blocks import NUM_NON_SOLID_BLOCKS

    lines = ["// generated by mega_minecraft_tpu_torch/kernels/_build.py; do not edit", "#pragma once"]
    lines += [f"#define FEAT_{f.name} {int(f)}" for f in fd.Feature]
    lines += [f"#define CAVEFEAT_{f.name} {int(f)}" for f in fd.CaveFeature]
    defines = {
        "NUM_FEATURES": fd.NUM_FEATURES, "NUM_CAVE_FEATURES": fd.NUM_CAVE_FEATURES,
        "NUM_NON_SOLID_BLOCKS": NUM_NON_SOLID_BLOCKS,
        "SEED_COLUMN": fp.SEED_COLUMN, "SEED_SURFACE_POS": fp.SEED_SURFACE_POS,
        "SEED_CAVE_BOTTOM_F": fp.SEED_CAVE_BOTTOM_F, "SEED_CAVE_BOTTOM_L": fp.SEED_CAVE_BOTTOM_L,
        "SEED_CAVE_TOP_F": fp.SEED_CAVE_TOP_F, "SEED_CAVE_TOP_L": fp.SEED_CAVE_TOP_L,
        "CHUNK_FEATURE_CAP": fp.CHUNK_FEATURE_CAP, "CHUNK_CAVE_FEATURE_CAP": fp.CHUNK_CAVE_FEATURE_CAP,
        "MAX_GATHERED_FEATURES": fp.MAX_GATHERED_FEATURES,
        "MAX_GATHERED_CAVE_FEATURES": fp.MAX_GATHERED_CAVE_FEATURES,
        "NUM_GATHER_OFFSETS": len(fp.GATHER_OFFSETS),
        "SEED_SURFACE_FEATURE_RNG": sdf.SEED_SURFACE_FEATURE_RNG,
        "SEED_SURFACE_BLOCK_RNG": sdf.SEED_SURFACE_BLOCK_RNG,
        "SEED_CAVE_FEATURE_RNG": sdf.SEED_CAVE_FEATURE_RNG,
        "SEED_CAVE_BLOCK_RNG": sdf.SEED_CAVE_BLOCK_RNG,
        "STREAM_LEN": sdf.STREAM_LEN,
        "SEED_DECORATORS": decorators.SEED_DECORATORS,
        "MAX_APPLY_LAYERS": decorators.MAX_APPLY_LAYERS,
        "SG_MAX_GENS": fd.FEATURE_GEN_TABLE["max_gens"],
        "SG_MAX_TOP_LAYERS": fd.FEATURE_GEN_TABLE["top_layer_mat"].shape[-1],
        "CG_MAX_GENS": fd.CAVE_FEATURE_GEN_TABLE["max_gens"],
    }
    lines += [f"#define {k} {int(v)}" for k, v in defines.items()]
    lines.append(_c_array("FEATURE_HEIGHT_BOUNDS", fd.FEATURE_HEIGHT_BOUNDS))
    lines.append(_c_array("CAVE_FEATURE_HEIGHT_BOUNDS", fd.CAVE_FEATURE_HEIGHT_BOUNDS))
    for prefix, table in (("SG", fd.FEATURE_GEN_TABLE), ("CG", fd.CAVE_FEATURE_GEN_TABLE)):
        for k, v in table.items():
            if isinstance(v, np.ndarray):
                lines.append(_c_array(f"{prefix}_{k.upper()}", v))
    lines.append(_c_array("GATHER_OFFSETS", fp.GATHER_OFFSETS))
    lines.append(_c_array("SURFACE_WINDOW", features.window_half_widths(cave=False)))
    lines.append(_c_array("CAVE_WINDOW", features.window_half_widths(cave=True)))
    lines.append(_c_array("DIR_VECS_2D", bio.DIR_VECS_2D))
    dec = tables.decorator_tables()
    lines.append(f"#define DEC_MAX_UNDER {dec['DEC_UNDER'].shape[1]}")
    lines.append(f"#define DEC_MAX_REPLACE {dec['DEC_REPLACE'].shape[1]}")
    lines += [_c_array(k, v) for k, v in dec.items()]
    return "\n".join(lines) + "\n"


def render_tables_header() -> str:
    """C tables of the render path (K10-K11): the scene encoding's constants, the solid
    table, the packed block properties and the material-class scalars, made from the
    numpy modules the plain versions read.  The alpha-flag and transparent-fraction
    tables and the texel tables go to the kernels as device tensors."""
    from ..render import brickmap, materials
    from ..world.blocks import X_SHAPED_HI, X_SHAPED_LO

    lines = ["// generated by mega_minecraft_tpu_torch/kernels/_build.py; do not edit", "#pragma once"]
    defines = {"EMPTY_BASE": brickmap.EMPTY_BASE, "DIST_CAP": brickmap.DIST_CAP,
               "SKY_R": brickmap.SKY_R, "MACRO_SCALE": brickmap.MACRO_SCALE,
               "X_SHAPED_LO": X_SHAPED_LO, "X_SHAPED_HI": X_SHAPED_HI}
    lines += [f"#define {k} {int(v)}" for k, v in defines.items()]
    lines.append(_c_array("RENDER_SOLID_TAB", np.asarray(RENDER_SOLID, np.uint8), "uint8_t"))
    lines.append(_c_array("BLOCK_PROPS_TAB", materials.BLOCK_PROPS, "uint32_t"))
    lines.append(_c_array("MAT_SPECULAR_TAB", np.asarray(materials.MAT_SPECULAR, np.uint8), "uint8_t"))
    lines.append(_c_array("MAT_WAVY_TAB", np.asarray(materials.MAT_WAVY, np.uint8), "uint8_t"))
    lines.append(_c_array("MAT_ROUGHNESS_TAB", materials.MAT_ROUGHNESS))
    lines.append(_c_array("MAT_IOR_TAB", materials.MAT_IOR))
    return "\n".join(lines) + "\n"


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(ids_header().encode())
    h.update(feature_tables_header().encode())
    h.update(render_tables_header().encode())
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
    (BUILD_DIR / "mmt_feature_tables.h").write_text(feature_tables_header())
    (BUILD_DIR / "mmt_render_tables.h").write_text(render_tables_header())
    nvcc = nvcc_path()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        # one nvcc per source, all started together
        jobs = []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-I", str(BUILD_DIR), "-c"]
            if verbose:
                cmd += ["-Xptxas", "-v"]
            cmd += ["-o", str(obj), str(src)]
            jobs.append((src, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                    stderr=subprocess.PIPE, text=True)))
        failed = []
        for src, _, proc in jobs:
            out, err = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{src.name} ({proc.returncode}):\n{out}\n{err}")
            elif verbose:
                print(f"-- {src.name}: {time.perf_counter() - t0:.1f} s\n{out}{err}")
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        tmp_lib = Path(tmp) / LIB_NAME
        link = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o", str(tmp_lib),
             *(str(obj) for _, obj, _ in jobs)], capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stdout}\n{link.stderr}")
        os.replace(tmp_lib, lib)  # atomic: a concurrent loader never sees a partial file
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
