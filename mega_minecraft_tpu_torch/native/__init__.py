"""Native (C++) host components of the port, loaded with ctypes: ``sched`` (the streaming
scheduler's core) and, here, the mesher's face scan (``mesher.cpp``, the analogue of
Chunk::createVBOs' host loop) with a block histogram.

Port of ``mega_minecraft_tpu/native/__init__.py``.  The mesher is compiled with g++ at
first use into ``build/native/`` at the checkout root (rebuilt when the source is newer
than the library), never at import and never beside the source.  It is host code, not a
device kernel: when it cannot be built, ``extract_faces`` returns None and
``render/meshing.py`` scans with numpy, and ``block_histogram`` counts with numpy;
``available()`` says which path runs.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "mesher.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
LIB = BUILD_DIR / "libmesher.so"

_lib = None
_tried = False


def _build() -> None:
    """Compile the mesher unless an up-to-date library exists."""
    if LIB.exists() and LIB.stat().st_mtime >= SRC.stat().st_mtime:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = LIB.with_suffix(f".{os.getpid()}.tmp")
    subprocess.run(["g++", "-O3", "-shared", "-fPIC", str(SRC), "-o", str(tmp)],
                   check=True, capture_output=True, text=True)
    os.replace(tmp, LIB)  # atomic: a concurrent loader never sees a partial file


def _load():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        _build()
        lib = ctypes.CDLL(str(LIB))
    except (OSError, subprocess.CalledProcessError):
        return None
    lib.count_faces.restype = ctypes.c_int64
    lib.count_faces.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.emit_faces.restype = ctypes.c_int64
    lib.emit_faces.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int64]
    lib.block_histogram.restype = None
    lib.block_histogram.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
    _lib = lib
    return _lib


def available() -> bool:
    """Whether the native mesher is built and loaded (else the numpy paths run)."""
    return _load() is not None


def _padded_volume(blocks, neighbors):
    pad = np.zeros((18, 18, 384), np.uint8)
    pad[1:17, 1:17] = blocks
    halo = np.zeros(4, np.uint8)  # +z +x -z -x
    nb = neighbors.get((0, 1))
    if nb is not None:
        pad[17, 1:17] = np.asarray(nb)[0, :]
        halo[0] = 1
    nb = neighbors.get((1, 0))
    if nb is not None:
        pad[1:17, 17] = np.asarray(nb)[:, 0]
        halo[1] = 1
    nb = neighbors.get((0, -1))
    if nb is not None:
        pad[0, 1:17] = np.asarray(nb)[15, :]
        halo[2] = 1
    nb = neighbors.get((-1, 0))
    if nb is not None:
        pad[1:17, 0] = np.asarray(nb)[:, 15]
        halo[3] = 1
    return np.ascontiguousarray(pad), halo


def extract_faces(blocks, neighbors):
    """Visible non-X-shaped faces of one chunk: (positions [N, 3] i32 local (x, y, z),
    dirs [N] u8, block ids [N] u8), in the scan order z, x, y, direction; or None when
    the native mesher is not available."""
    lib = _load()
    if lib is None:
        return None
    from ..world.blocks import TRANSPARENCY

    pad, halo = _padded_volume(np.asarray(blocks, np.uint8), neighbors)
    trans = np.ascontiguousarray(TRANSPARENCY)
    n = lib.count_faces(pad.ctypes.data, trans.ctypes.data, halo.ctypes.data)
    pos = np.empty((n, 3), np.int32)
    dirs = np.empty(n, np.uint8)
    blks = np.empty(n, np.uint8)
    m = lib.emit_faces(pad.ctypes.data, trans.ctypes.data, halo.ctypes.data,
                       pos.ctypes.data, dirs.ctypes.data, blks.ctypes.data, n)
    if m != n:
        raise RuntimeError(f"the native mesher emitted {m} faces after counting {n}")
    return pos, dirs, blks


def block_histogram(blocks):
    """u8 block ids of any shape -> [256] i64 counts (native, else numpy)."""
    lib = _load()
    b = np.ascontiguousarray(np.asarray(blocks, np.uint8).reshape(-1))
    if lib is None:
        return np.bincount(b, minlength=256).astype(np.int64)
    out = np.zeros(256, np.int64)
    lib.block_histogram(b.ctypes.data, b.size, out.ctypes.data)
    return out
