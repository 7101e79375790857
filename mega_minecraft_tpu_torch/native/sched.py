"""ctypes binding of the native streaming-scheduler core (``scheduler.cpp``).

The C++ core owns the chunk table, state machine, queues, action-time budget and zone
logic; each ``tick`` returns a flat int32 plan of per-stage batches with every
neighbour-slot table resolved.  The core is compiled with g++ at first use into
``build/native/`` at the checkout root (rebuilt when the source is newer than the
library), never at import.  ``available()`` says whether it could be built;
``terrain.scheduler.make_scheduler(native=None)`` takes the pure-Python core when not.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "scheduler.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
LIB = BUILD_DIR / "libscheduler.so"

# stage ids in the plan stream (must match scheduler.cpp)
ST_HEIGHTFIELD = 0
ST_GATHER_HEIGHTFIELD = 1
ST_LAYERS = 2
ST_EROSION = 3
ST_CAVES = 4
ST_FEATURE_PLACEMENTS = 5
ST_GATHER_FEATURES = 6
ST_FILL = 7
ST_VBOS = 8

PLAN_CAP = 65536  # int32s; a frame's plan is far below this (16-chunk batches)
_EVICT_CAP = 8192

_lib = None
_error: str | None = None


def _build() -> None:
    """Compile the core unless an up-to-date library exists."""
    if LIB.exists() and LIB.stat().st_mtime >= SRC.stat().st_mtime:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = LIB.with_suffix(f".{os.getpid()}.tmp")
    subprocess.run(["g++", "-O2", "-std=c++17", "-shared", "-fPIC", str(SRC), "-o", str(tmp)],
                   check=True, capture_output=True, text=True)
    os.replace(tmp, LIB)  # atomic: a concurrent loader never sees a partial file


def load() -> ctypes.CDLL:
    """The core's library, built if needed; raises if it cannot be built."""
    global _lib, _error
    if _lib is not None:
        return _lib
    try:
        _build()
    except (OSError, subprocess.CalledProcessError) as e:
        detail = getattr(e, "stderr", "") or str(e)
        _error = f"cannot build the native scheduler core with g++: {detail}"
        raise RuntimeError(_error) from e
    lib = ctypes.CDLL(str(LIB))
    lib.sched_create.restype = ctypes.c_void_p
    lib.sched_create.argtypes = [ctypes.c_int] * 3
    lib.sched_free.argtypes = [ctypes.c_void_p]
    lib.sched_set_player_chunk.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    lib.sched_tick.restype = ctypes.c_int64
    lib.sched_tick.argtypes = [ctypes.c_void_p, ctypes.c_double, ctypes.c_void_p, ctypes.c_int64]
    lib.sched_destroy_far_vbos.restype = ctypes.c_int
    lib.sched_destroy_far_vbos.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                                           ctypes.c_int]
    for f in (lib.sched_state_at, lib.sched_slot_of):
        f.restype = ctypes.c_int
        f.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    for f in (lib.sched_queues_busy, lib.sched_drawable_count):
        f.restype = ctypes.c_int
        f.argtypes = [ctypes.c_void_p]
    lib.sched_force_update.argtypes = [ctypes.c_void_p]
    lib.sched_snapshot.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 4
    _lib = lib
    return lib


def available() -> bool:
    """Whether the core builds and loads here (a failed build is not retried)."""
    if _lib is None and _error is None:
        try:
            load()
        except RuntimeError:
            pass
    return _lib is not None


class NativeSchedulerCore:
    """Handle of one C++ scheduler core."""

    def __init__(self, capacity: int, radius: int | None, skip_erosion: bool):
        self._lib = load()
        self.capacity = capacity
        self._h = ctypes.c_void_p(
            self._lib.sched_create(capacity, -1 if radius is None else radius, int(skip_erosion)))
        self._plan = np.empty(PLAN_CAP, np.int32)
        self._ex = np.empty(_EVICT_CAP, np.int32)
        self._ez = np.empty(_EVICT_CAP, np.int32)

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.sched_free(h)
            self._h = None

    def set_player_chunk(self, cx: int, cz: int):
        self._lib.sched_set_player_chunk(self._h, cx, cz)

    def tick(self, dt: float) -> np.ndarray:
        n = self._lib.sched_tick(self._h, dt, self._plan.ctypes.data, ctypes.c_int64(PLAN_CAP))
        if n < 0:
            raise RuntimeError("scheduler plan buffer overflow")
        return self._plan[:n]

    def destroy_far_vbos(self) -> list:
        """The (cx, cz) of the drawable chunks that dropped back to FILLED."""
        n = self._lib.sched_destroy_far_vbos(self._h, self._ex.ctypes.data, self._ez.ctypes.data,
                                             _EVICT_CAP)
        return [(int(self._ex[i]), int(self._ez[i])) for i in range(min(n, _EVICT_CAP))]

    def state_at(self, cx: int, cz: int) -> int:
        return self._lib.sched_state_at(self._h, cx, cz)

    def slot_of(self, cx: int, cz: int) -> int:
        return self._lib.sched_slot_of(self._h, cx, cz)

    def queues_busy(self) -> bool:
        return bool(self._lib.sched_queues_busy(self._h))

    def drawable_count(self) -> int:
        return self._lib.sched_drawable_count(self._h)

    def force_update(self):
        self._lib.sched_force_update(self._h)

    def snapshot(self):
        """(state u8[C], cx i32[C], cz i32[C], in_use u8[C]) copies."""
        c = self.capacity
        st = np.empty(c, np.uint8)
        cx = np.empty(c, np.int32)
        cz = np.empty(c, np.int32)
        iu = np.empty(c, np.uint8)
        self._lib.sched_snapshot(self._h, st.ctypes.data, cx.ctypes.data, cz.ctypes.data,
                                 iu.ctypes.data)
        return st, cx, cz, iu
