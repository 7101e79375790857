"""Launch wrappers of the hand-written CUDA kernels (K1-K9, K2s, K7s and K7's stream
pre-kernel; the render path's K10 scene fields, K11t trace, K11 render_sample and K12
accumulate; the engine's frame path: K10u update_chunks, K13 reproject, K13s
static_blend, K14 atrous_denoise, K15 upscale2x and K16 present; K17 render_debug; the
sharded programs' K2h dp_layers and K9b erosion_band).

Each wrapper checks device, dtype, shape and contiguity of its inputs, allocates its
outputs with ``torch.empty``, launches on the current CUDA stream, raises if the C
entry point returns a non-zero ``cudaError_t``, and adds one to its launch count.
The library is built and loaded at the first launch (``_build.load``), never at
import.  The stage modules (``terrain/*.py``) call these for CUDA tensors and their
plain versions for CPU tensors.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import numpy as np
import torch

from ..world import biomes as bio

from ..tables import CARVE_Y_MAX, LUSH_TABLE_CELLS, Y_SIZE, load_tables
from . import _build

#: launches per kernel since the last reset (plain integers, read by chip_smoke.py)
LAUNCHES = {"heightfield": 0, "layers": 0, "caves": 0, "fill": 0, "placements": 0,
            "compact_placements": 0, "feature_streams": 0, "features": 0, "decorators": 0,
            "erosion": 0, "layers_slots": 0, "features_slots": 0, "scene_fields": 0,
            "trace": 0, "render_sample": 0, "accumulate": 0, "update_chunks": 0,
            "reproject": 0, "static_blend": 0, "atrous_denoise": 0, "upscale2x": 0, "present": 0,
            "render_debug": 0, "dp_layers": 0, "erosion_band": 0}

N_BIOMES = bio.NUM_BIOMES
N_MAT = bio.NUM_MATERIALS
N_LAYERS = bio.MAX_CAVE_LAYERS_PER_COLUMN
#: widths of the per-chunk placement lists (feature_placement.CHUNK_*_CAP) and the
#: draws per placement stream (features_sdf.STREAM_LEN)
SURFACE_CAP = 256
CAVE_CAP = 1024
STREAM_LEN = 64
SURFACE_FIELDS = ("feature", "x", "y", "z", "replace")
CAVE_FIELDS = ("feature", "x", "y", "z", "replace", "height")
#: K5's outputs / K6's inputs, in the order the C entry points take them
_GRID_KEYS = ("surface_feature", "surface_y", "surface_replace", "cave_feature", "cave_y",
              "cave_height", "cave_replace")


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_counts() -> dict:
    return dict(LAUNCHES)


def require_cpu(t: torch.Tensor) -> None:
    """The plain versions serve CPU tensors only; any other device raises."""
    if t.device.type != "cpu":
        raise ValueError(f"no kernel or plain path for device {t.device}")


def _check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _on(dev: torch.device):
    """The context of a launch on ``dev``: a device switch only when ``dev`` is not the
    current device (the switch costs microseconds of host time a call)."""
    return contextlib.nullcontext() if dev.index == torch.cuda.current_device() else torch.cuda.device(dev)


def _launch(name: str, fn, *args) -> None:
    # the current stream's raw handle (torch.cuda.current_stream() builds a Stream object)
    err = fn(*args, torch._C._cuda_getCurrentRawStream(torch.cuda.current_device()))
    if err != 0:
        raise RuntimeError(f"kernel {name} failed to launch: cudaError_t {err}")
    LAUNCHES[name] += 1


def _p(t: torch.Tensor) -> int:
    return t.data_ptr()


def heightfield(chunk_pos):
    """K1: [B, 2] i32 -> (heightfield [B, 16, 16] f32, weights [B, 24, 16, 16] f32)."""
    dev = chunk_pos.device
    B = chunk_pos.shape[0]
    _check(chunk_pos, "chunk_pos", torch.int32, (B, 2), dev)
    tb = load_tables(dev)
    hf = torch.empty((B, 16, 16), dtype=torch.float32, device=dev)
    w = torch.empty((B, N_BIOMES, 16, 16), dtype=torch.float32, device=dev)
    if B:
        with torch.cuda.device(dev):
            _launch("heightfield", _build.load().mmt_heightfield,
                    _p(chunk_pos), B, _p(tb.biome_noise_weights), _p(hf), _p(w))
    return hf, w


def dp_layers(chunk_pos):
    """K2h: [B, 2] i32 -> (heightfield [B, 16, 16], weights [B, 24, 16, 16], layers
    [B, 20, 16, 16] with the backward fix), each chunk's 18x18 heightfield window recomputed
    from noise (two launches, one count)."""
    dev = chunk_pos.device
    B = chunk_pos.shape[0]
    _check(chunk_pos, "chunk_pos", torch.int32, (B, 2), dev)
    tb = load_tables(dev)
    h18 = torch.empty((B, 18, 18), dtype=torch.float32, device=dev)
    hf = torch.empty((B, 16, 16), dtype=torch.float32, device=dev)
    w = torch.empty((B, N_BIOMES, 16, 16), dtype=torch.float32, device=dev)
    ls = torch.empty((B, N_MAT, 16, 16), dtype=torch.float32, device=dev)
    if B:
        with torch.cuda.device(dev):
            lib = _build.load()
            stream = torch.cuda.current_stream().cuda_stream
            for part, err in (
                ("heightfield window", lib.mmt_heightfield_window(
                    _p(chunk_pos), B, _p(tb.biome_noise_weights), _p(h18), _p(hf), _p(w), stream)),
                ("layers", lib.mmt_layers_window(
                    _p(h18), _p(w), _p(chunk_pos), B, _p(tb.biome_material_weights),
                    _p(tb.material_thickness), _p(tb.material_amplitude_or_tan_repose),
                    _p(tb.material_scale_or_max_slope), _p(tb.dir_vecs_2d), _p(ls), stream)),
            ):
                if err != 0:
                    raise RuntimeError(f"kernel dp_layers ({part}) failed to launch: cudaError_t {err}")
        LAUNCHES["dp_layers"] += 1
    return hf, w, ls


def layers(hf_halo, w_halo, pos_halo, ncx: int, ncz: int, fix_backward: bool = True):
    """K2: halo'd heightfield / weights / origins of a (ncz+2) x (ncx+2) grid ->
    dict(layers [B,20,16,16] (fixed if ``fix_backward``), heightfield, biome_weights,
    chunk_pos) of the B = ncz*ncx inner chunks (the 18x18 gather is folded into the
    kernel)."""
    dev = hf_halo.device
    H = (ncz + 2) * (ncx + 2)
    B = ncz * ncx
    _check(hf_halo, "hf_halo", torch.float32, (H, 16, 16), dev)
    _check(w_halo, "w_halo", torch.float32, (H, N_BIOMES, 16, 16), dev)
    _check(pos_halo, "pos_halo", torch.int32, (H, 2), dev)
    tb = load_tables(dev)
    out = {
        "layers": torch.empty((B, N_MAT, 16, 16), dtype=torch.float32, device=dev),
        "heightfield": torch.empty((B, 16, 16), dtype=torch.float32, device=dev),
        "biome_weights": torch.empty((B, N_BIOMES, 16, 16), dtype=torch.float32, device=dev),
        "chunk_pos": torch.empty((B, 2), dtype=torch.int32, device=dev),
    }
    if B:
        with torch.cuda.device(dev):
            _launch("layers", _build.load().mmt_layers,
                    _p(hf_halo), _p(w_halo), _p(pos_halo), ncx, ncz,
                    _p(tb.biome_material_weights), _p(tb.material_thickness),
                    _p(tb.material_amplitude_or_tan_repose), _p(tb.material_scale_or_max_slope),
                    _p(tb.dir_vecs_2d), int(fix_backward), _p(out["layers"]),
                    _p(out["heightfield"]), _p(out["biome_weights"]), _p(out["chunk_pos"]))
    return out


def layers_slots(d_layers, d_hf, d_w, nslots, slots, pos, fix_backward: bool):
    """K2s: the layers of the batch's B chunks written into the slot table ``d_layers``
    [C, 20, 16, 16] in place, from ``d_hf`` [C, 16, 16] through ``nslots`` [B, 3, 3] i32,
    ``d_w`` [C, 24, 16, 16] at ``slots`` [B] i32 and origins ``pos`` [B, 2] i32."""
    dev = d_layers.device
    C, B = d_layers.shape[0], slots.shape[0]
    _check(d_layers, "d_layers", torch.float32, (C, N_MAT, 16, 16), dev)
    _check(d_hf, "d_hf", torch.float32, (C, 16, 16), dev)
    _check(d_w, "d_w", torch.float32, (C, N_BIOMES, 16, 16), dev)
    _check(nslots, "nslots", torch.int32, (B, 3, 3), dev)
    _check(slots, "slots", torch.int32, (B,), dev)
    _check(pos, "pos", torch.int32, (B, 2), dev)
    tb = load_tables(dev)
    if B:
        with torch.cuda.device(dev):
            _launch("layers_slots", _build.load().mmt_layers_slots,
                    _p(d_layers), _p(d_hf), _p(d_w), _p(nslots), _p(slots), _p(pos), B,
                    _p(tb.biome_material_weights), _p(tb.material_thickness),
                    _p(tb.material_amplitude_or_tan_repose), _p(tb.material_scale_or_max_slope),
                    _p(tb.dir_vecs_2d), int(fix_backward))
    return d_layers


GRID_BLOCKS = 384
N_ERODED = bio.NUM_ERODED_MATERIALS


def _erosion(dev, grid_in, layers, heightfield, gslots, fix_all):
    tb = load_tables(dev)
    out = torch.empty((N_ERODED + 1, GRID_BLOCKS, GRID_BLOCKS), dtype=torch.float32, device=dev)
    scratch = torch.empty((3, GRID_BLOCKS, GRID_BLOCKS), dtype=torch.float32, device=dev)
    ints = torch.empty((4 + N_ERODED,), dtype=torch.int32, device=dev)  # flags, iterations
    ptr = lambda t: None if t is None else _p(t)  # noqa: E731
    with torch.cuda.device(dev):
        _launch("erosion", _build.load().mmt_erosion,
                ptr(grid_in), ptr(layers), ptr(heightfield), ptr(gslots), int(fix_all),
                _p(tb.material_amplitude_or_tan_repose), _p(tb.dir_vecs_2d), _p(out),
                _p(scratch[0]), _p(scratch[1]), _p(ints), _p(ints[4:]))
    return out, ints[4:]


def erode_zone(grid):
    """K9 on a gathered [9, 384, 384] f32 grid -> (eroded grid, [8] i32 sweeps per layer,
    top layer first; both on the device, nothing read back)."""
    _check(grid, "grid", torch.float32, (N_ERODED + 1, GRID_BLOCKS, GRID_BLOCKS), grid.device)
    return _erosion(grid.device, grid, None, None, None, False)


def erode_zone_slots(layers, heightfield, gslots, fix_all: bool):
    """K9 over a slot table, in place: the zone grid of ``gslots`` [24, 24] i32 read from
    ``layers`` [N, 20, 16, 16] (unfixed) and ``heightfield`` [N, 16, 16], the eroded core
    written back and the backward fix applied to the core (or all 576 chunks with
    ``fix_all``).  Returns the [8] i32 sweeps per layer (on the device)."""
    dev = layers.device
    N = layers.shape[0]
    _check(layers, "layers", torch.float32, (N, N_MAT, 16, 16), dev)
    _check(heightfield, "heightfield", torch.float32, (N, 16, 16), dev)
    _check(gslots, "gslots", torch.int32, (24, 24), dev)
    return _erosion(dev, None, layers, heightfield, gslots, fix_all)[1]


def erosion_band(start, end, acc_in, acc_out, dst, top_edge: bool, bottom_edge: bool, rel: int,
                 flags, k: int) -> None:
    """K9b: one sweep of eroded layer ``rel`` on a row band, in place.  ``start``, ``end``,
    ``acc_in`` (the layer's first sweep; else None), ``acc_out`` and ``dst`` are
    [rows + 2, 384] f32 with a halo row above and below the band; ``dst`` and ``acc_out``
    get the band's rows; ``flags`` [2] i32: sweep ``k`` sets ``flags[k & 1]`` if a column
    changed and clears ``flags[(k + 1) & 1]``."""
    dev = start.device
    shape = (start.shape[0], GRID_BLOCKS)
    rows = shape[0] - 2
    if rows < 1:
        raise ValueError(f"start: shape {tuple(start.shape)}, expected [rows + 2, {GRID_BLOCKS}]")
    for name, t in (("start", start), ("end", end), ("acc_out", acc_out), ("dst", dst)) + (
            (("acc_in", acc_in),) if acc_in is not None else ()):
        _check(t, name, torch.float32, shape, dev)
    _check(flags, "flags", torch.int32, (2,), dev)
    if not 0 <= rel < N_ERODED:
        raise ValueError(f"rel {rel} outside [0, {N_ERODED})")
    tb = load_tables(dev)
    with torch.cuda.device(dev):
        _launch("erosion_band", _build.load().mmt_erosion_band,
                _p(start), _p(end), None if acc_in is None else _p(acc_in), _p(acc_out), _p(dst),
                rows, int(top_edge), int(bottom_edge), rel,
                _p(tb.material_amplitude_or_tan_repose), _p(tb.dir_vecs_2d), _p(flags), int(k))


#: the most cells K3's shared-memory table may be given: 3 floats a cell within the 48 KB a
#: block gets without opting in to more
MAX_TABLE_CELLS = 4000


def caves(heightfield, biome_weights, chunk_pos, table_cells: int, stats=None, want_carved: bool = False):
    """K3: -> dict of [B, 16, 16, 32] i32 starts / ends / bottom_biome / top_biome (and with
    ``want_carved`` the carve band, [B, 16, 16, 144] bool).  ``table_cells``: the capacity of
    the carve test's cell table (terrain/caves.py CELL_TABLE_CAP; 0 takes every tile to the
    direct path).  ``stats``: None, or a [2] i32 tensor on the device that the launch adds
    to: [tiles that took the direct path, the largest cell box (cells) a tile saw]."""
    dev = heightfield.device
    B = heightfield.shape[0]
    _check(heightfield, "heightfield", torch.float32, (B, 16, 16), dev)
    _check(biome_weights, "biome_weights", torch.float32, (B, N_BIOMES, 16, 16), dev)
    _check(chunk_pos, "chunk_pos", torch.int32, (B, 2), dev)
    if not 0 <= table_cells <= MAX_TABLE_CELLS:
        raise ValueError(f"table_cells {table_cells} outside [0, {MAX_TABLE_CELLS}]")
    if stats is not None:
        _check(stats, "stats", torch.int32, (2,), dev)
    tb = load_tables(dev)
    carved = torch.empty((B, 256, CARVE_Y_MAX), dtype=torch.uint8, device=dev)
    out = {
        k: torch.empty((B, 16, 16, N_LAYERS), dtype=torch.int32, device=dev)
        for k in ("starts", "ends", "bottom_biome", "top_biome")
    }
    if B:
        with torch.cuda.device(dev):
            _launch("caves", _build.load().mmt_caves,
                    _p(heightfield), _p(biome_weights), _p(chunk_pos), B,
                    _p(tb.cave_biome_noise_weights), int(table_cells), None if stats is None else _p(stats),
                    _p(carved),
                    _p(out["starts"]), _p(out["ends"]), _p(out["bottom_biome"]),
                    _p(out["top_biome"]))
    if want_carved:
        out["carved"] = carved.view(B, 16, 16, CARVE_Y_MAX).bool()
    return out


def fill(heightfield, biome_weights, layers, cave_starts, cave_ends, chunk_pos, table_cells: int,
         stats=None):
    """K4: -> blocks [B, 16, 16, 384] u8 ([z, x, y]).  ``table_cells``: the capacity of the lush
    caves' cell table (tables.LUSH_TABLE_CELLS at most; 0 takes every tile with lush work to the
    direct path).  ``stats``: None, or a [4] i32 tensor on the device that the launch adds to:
    [blocks queued for the cave biome, lush blocks, the largest cell box (cells) a tile saw,
    tiles that took the direct path]."""
    dev = heightfield.device
    B = heightfield.shape[0]
    _check(heightfield, "heightfield", torch.float32, (B, 16, 16), dev)
    _check(biome_weights, "biome_weights", torch.float32, (B, N_BIOMES, 16, 16), dev)
    _check(layers, "layers", torch.float32, (B, N_MAT, 16, 16), dev)
    _check(cave_starts, "cave_starts", torch.int32, (B, 16, 16, N_LAYERS), dev)
    _check(cave_ends, "cave_ends", torch.int32, (B, 16, 16, N_LAYERS), dev)
    _check(chunk_pos, "chunk_pos", torch.int32, (B, 2), dev)
    if not 0 <= table_cells <= LUSH_TABLE_CELLS:
        raise ValueError(f"table_cells {table_cells} outside [0, {LUSH_TABLE_CELLS}]")
    if stats is not None:
        _check(stats, "stats", torch.int32, (4,), dev)
    tb = load_tables(dev)
    blocks = torch.empty((B, 16, 16, Y_SIZE), dtype=torch.uint8, device=dev)
    if B:
        with torch.cuda.device(dev):
            _launch("fill", _build.load().mmt_fill,
                    _p(heightfield), _p(biome_weights), _p(layers), _p(cave_starts),
                    _p(cave_ends), _p(chunk_pos), B, _p(tb.grass_blocks),
                    _p(tb.material_block), _p(tb.cave_biome_noise_weights), int(table_cells),
                    None if stats is None else _p(stats), _p(blocks))
    return blocks


def placements(heightfield, biome_weights, layers, cave_starts, cave_ends, cave_bottom_biome,
               cave_top_biome, chunk_pos):
    """K5: -> dict of dense placement grids: surface_feature / surface_y [B,16,16] i32,
    surface_replace bool, cave_feature / cave_replace [B,16,16,32,2] i32 / bool, cave_y /
    cave_height [B,16,16,32] i32.  The four cave inputs are read as 16-byte words: their base
    must be 16-byte aligned (else ValueError)."""
    dev = heightfield.device
    B = heightfield.shape[0]
    _check(heightfield, "heightfield", torch.float32, (B, 16, 16), dev)
    _check(biome_weights, "biome_weights", torch.float32, (B, N_BIOMES, 16, 16), dev)
    _check(layers, "layers", torch.float32, (B, N_MAT, 16, 16), dev)
    for name, t in (("cave_starts", cave_starts), ("cave_ends", cave_ends),
                    ("cave_bottom_biome", cave_bottom_biome), ("cave_top_biome", cave_top_biome)):
        _check(t, name, torch.int32, (B, 16, 16, N_LAYERS), dev)
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: base not 16-byte aligned")
    _check(chunk_pos, "chunk_pos", torch.int32, (B, 2), dev)

    def e(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=dev)

    out = {
        "surface_feature": e((B, 16, 16), torch.int32),
        "surface_y": e((B, 16, 16), torch.int32),
        "surface_replace": e((B, 16, 16), torch.bool),
        "cave_feature": e((B, 16, 16, N_LAYERS, 2), torch.int32),
        "cave_y": e((B, 16, 16, N_LAYERS), torch.int32),
        "cave_height": e((B, 16, 16, N_LAYERS), torch.int32),
        "cave_replace": e((B, 16, 16, N_LAYERS, 2), torch.bool),
    }
    if B:
        with torch.cuda.device(dev):
            _launch("placements", _build.load().mmt_placements,
                    _p(heightfield), _p(biome_weights), _p(layers), _p(cave_starts), _p(cave_ends),
                    _p(cave_bottom_biome), _p(cave_top_biome), _p(chunk_pos), B,
                    *(_p(out[k]) for k in _GRID_KEYS))
    return out


def _check_grids(pl, B, dev):
    for k in _GRID_KEYS:
        shape = (B, 16, 16) + ((N_LAYERS,) if k.startswith("cave") else ()) \
            + ((2,) if k in ("cave_feature", "cave_replace") else ())
        _check(pl[k], k, torch.bool if k.endswith("replace") else torch.int32, shape, dev)


def compact_placements(pl, chunk_pos):
    """K6: dense grids -> {"surface", "cave"} dicts of [B, 256] / [B, 1024] i32 lists
    (feature, x, y, z, replace(, height)) + [B] i32 ``count`` (the uncapped number)."""
    dev = chunk_pos.device
    B = chunk_pos.shape[0]
    _check(chunk_pos, "chunk_pos", torch.int32, (B, 2), dev)
    _check_grids(pl, B, dev)
    surface = {k: torch.empty((B, SURFACE_CAP), dtype=torch.int32, device=dev) for k in SURFACE_FIELDS}
    cave = {k: torch.empty((B, CAVE_CAP), dtype=torch.int32, device=dev) for k in CAVE_FIELDS}
    surface["count"] = torch.empty((B,), dtype=torch.int32, device=dev)
    cave["count"] = torch.empty((B,), dtype=torch.int32, device=dev)
    if B:
        with torch.cuda.device(dev):
            _launch("compact_placements", _build.load().mmt_compact_placements,
                    *(_p(pl[k]) for k in _GRID_KEYS), _p(chunk_pos), B,
                    *(_p(surface[k]) for k in (*SURFACE_FIELDS, "count")),
                    *(_p(cave[k]) for k in (*CAVE_FIELDS, "count")))
    return {"surface": surface, "cave": cave}


def _check_lists(lists, fields, cap, B, dev, name):
    for k in fields:
        _check(lists[k], f"{name}.{k}", torch.int32, (B, cap), dev)
    _check(lists["count"], f"{name}.count", torch.int32, (B,), dev)


def feature_streams(surface_lists, cave_lists, out=None, rows=None):
    """K7's pre-kernel: the 64-draw stream of every VALID list entry (slot < min(count, K) of
    each chunk and kind, the entries K7 / K7s can read) -> (surface [B, 256, 64] f32, cave
    [B, 1024, 64] f32).  The rows past the valid ones are left unwritten (``torch.empty`` when
    ``out`` is None).  ``out=(s, c)``, [C, 256, 64] / [C, 1024, 64] f32, takes the rows in
    place: row b of the batch goes to ``out[rows[b]]`` (``rows`` [B] i32, each in [0, C); a
    row outside is skipped), or to ``out[b]`` without ``rows``; returns ``out``."""
    dev = surface_lists["x"].device
    B = surface_lists["x"].shape[0]
    _check_lists(surface_lists, "xyz", SURFACE_CAP, B, dev, "surface")
    _check_lists(cave_lists, "xyz", CAVE_CAP, B, dev, "cave")
    if out is None:
        if rows is not None:
            raise ValueError("rows without out")
        out = (torch.empty((B, SURFACE_CAP, STREAM_LEN), dtype=torch.float32, device=dev),
               torch.empty((B, CAVE_CAP, STREAM_LEN), dtype=torch.float32, device=dev))
    s_out, c_out = out
    C = s_out.shape[0]
    _check(s_out, "out surface", torch.float32, (C, SURFACE_CAP, STREAM_LEN), dev)
    _check(c_out, "out cave", torch.float32, (C, CAVE_CAP, STREAM_LEN), dev)
    if rows is None:
        if C != B:
            raise ValueError(f"out holds {C} rows for a batch of {B}: pass rows")
    else:
        _check(rows, "rows", torch.int32, (B,), dev)
    if B:
        with torch.cuda.device(dev):
            _launch("feature_streams", _build.load().mmt_feature_streams,
                    *(_p(surface_lists[k]) for k in (*"xyz", "count")),
                    *(_p(cave_lists[k]) for k in (*"xyz", "count")),
                    None if rows is None else _p(rows), B, C, _p(s_out), _p(c_out))
    return s_out, c_out


#: the gather caps (feature_placement.MAX_GATHERED_*): the length of a chunk's culled list
SURFACE_GATHER_CAP = bio.MAX_GATHERED_FEATURES_PER_CHUNK
CAVE_GATHER_CAP = bio.MAX_GATHERED_CAVE_FEATURES_PER_CHUNK
#: int32 words of a culled list entry (csrc/features.cu Candidate: x, y, z, the entry's row in
#: the streams, feature, replace, height, pad)
CANDIDATE_WORDS = 8


def _culled_scratch(B, dev):
    """The pre-pass's per-chunk lists ([B, cap, 8] i32 for each kind) and counts ([B, 2] i32)."""
    return (torch.empty((B, SURFACE_GATHER_CAP, CANDIDATE_WORDS), dtype=torch.int32, device=dev),
            torch.empty((B, CAVE_GATHER_CAP, CANDIDATE_WORDS), dtype=torch.int32, device=dev),
            torch.empty((B, 2), dtype=torch.int32, device=dev))


def _culled_lists(cand_s, cand_c, counts):
    """{"surface", "cave"}: (lists [B, cap, 8] i32, the first counts[b] of chunk b's entries
    valid; counts [B] i32)."""
    return {"surface": (cand_s, counts[:, 0]), "cave": (cand_c, counts[:, 1])}


def features(blocks, surface_lists, cave_lists, surface_streams, cave_streams, chunk_pos,
             ncx: int, ncz: int, want_lists: bool = False):
    """K7: blocks [B,16,16,384] u8 of an ncx x ncz area (B = ncz*ncx row-major) with the
    placement lists applied -> new blocks tensor (and with ``want_lists`` the pre-pass's
    culled lists, ``_culled_lists``).  Two launches, one count: the per-chunk cull, then the
    column pass.

    The lists are K6's: [B, 256] / [B, 1024] i32 with the valid entries first and a true
    [B] ``count``; the kernel reads the first min(count, width) entries of a list."""
    dev = blocks.device
    B = ncx * ncz
    _check(blocks, "blocks", torch.uint8, (B, 16, 16, Y_SIZE), dev)
    _check_lists(surface_lists, SURFACE_FIELDS, SURFACE_CAP, B, dev, "surface")
    _check_lists(cave_lists, CAVE_FIELDS, CAVE_CAP, B, dev, "cave")
    _check(surface_streams, "surface_streams", torch.float32, (B, SURFACE_CAP, STREAM_LEN), dev)
    _check(cave_streams, "cave_streams", torch.float32, (B, CAVE_CAP, STREAM_LEN), dev)
    _check(chunk_pos, "chunk_pos", torch.int32, (B, 2), dev)
    out = torch.empty_like(blocks)
    scratch = _culled_scratch(B, dev)
    if B:
        with torch.cuda.device(dev):
            _launch("features", _build.load().mmt_features, _p(blocks),
                    *(_p(surface_lists[k]) for k in (*SURFACE_FIELDS, "count")), _p(surface_streams),
                    *(_p(cave_lists[k]) for k in (*CAVE_FIELDS, "count")), _p(cave_streams),
                    _p(chunk_pos), ncx, ncz, *(_p(t) for t in scratch), _p(out))
    return (out, _culled_lists(*scratch)) if want_lists else out


def features_slots(blocks, d_sf, d_cf, d_sstream, d_cstream, nslots, chunk_pos, cull: bool = True,
                   want_lists: bool = False):
    """K7s: blocks [B,16,16,384] u8 of the batch's chunks with their gathered placement
    lists applied -> new blocks tensor (and with ``want_lists`` the pre-pass's culled lists).
    Chunk b gathers the lists of the slots ``nslots[b]`` ([B, 49] i32, GATHER_OFFSETS order)
    from the slot table: ``d_sf`` / ``d_cf`` dicts of [C, 256] / [C, 1024] i32 fields and [C]
    true ``count``, ``d_sstream`` / ``d_cstream`` [C, K, 64] f32.  ``cull=False`` keeps and
    evaluates every visible gathered entry for every voxel (no window test): the JAX
    program's semantics, for checking."""
    dev = blocks.device
    B, C = blocks.shape[0], d_sf["feature"].shape[0]
    _check(blocks, "blocks", torch.uint8, (B, 16, 16, Y_SIZE), dev)
    _check_lists(d_sf, SURFACE_FIELDS, SURFACE_CAP, C, dev, "surface")
    _check_lists(d_cf, CAVE_FIELDS, CAVE_CAP, C, dev, "cave")
    _check(d_sstream, "d_sstream", torch.float32, (C, SURFACE_CAP, STREAM_LEN), dev)
    _check(d_cstream, "d_cstream", torch.float32, (C, CAVE_CAP, STREAM_LEN), dev)
    _check(nslots, "nslots", torch.int32, (B, 49), dev)
    _check(chunk_pos, "chunk_pos", torch.int32, (B, 2), dev)
    out = torch.empty_like(blocks)
    scratch = _culled_scratch(B, dev)
    if B:
        with torch.cuda.device(dev):
            _launch("features_slots", _build.load().mmt_features_slots, _p(blocks),
                    *(_p(d_sf[k]) for k in (*SURFACE_FIELDS, "count")), _p(d_sstream),
                    *(_p(d_cf[k]) for k in (*CAVE_FIELDS, "count")), _p(d_cstream),
                    _p(nslots), _p(chunk_pos), B, int(cull), *(_p(t) for t in scratch), _p(out))
    return (out, _culled_lists(*scratch)) if want_lists else out


def decorators(blocks, heightfield, biome_weights, cave_starts, cave_ends, cave_bottom_biome,
               chunk_pos):
    """K8: blocks [B,16,16,384] u8 -> new blocks tensor with the decorators placed."""
    dev = blocks.device
    B = blocks.shape[0]
    _check(blocks, "blocks", torch.uint8, (B, 16, 16, Y_SIZE), dev)
    _check(heightfield, "heightfield", torch.float32, (B, 16, 16), dev)
    _check(biome_weights, "biome_weights", torch.float32, (B, N_BIOMES, 16, 16), dev)
    for name, t in (("cave_starts", cave_starts), ("cave_ends", cave_ends),
                    ("cave_bottom_biome", cave_bottom_biome)):
        _check(t, name, torch.int32, (B, 16, 16, N_LAYERS), dev)
    _check(chunk_pos, "chunk_pos", torch.int32, (B, 2), dev)
    out = torch.empty_like(blocks)
    if B:
        with torch.cuda.device(dev):
            _launch("decorators", _build.load().mmt_decorators,
                    _p(blocks), _p(heightfield), _p(biome_weights), _p(cave_starts), _p(cave_ends),
                    _p(cave_bottom_biome), _p(chunk_pos), B, _p(out))
    return out


# ---------------------------------------------------------------------------------------
# the render path (csrc/brickmap.cu, csrc/tracer.cu, csrc/accumulate.cu)
# ---------------------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _alpha_tables(dev, flags: bytes, frac: bytes) -> torch.Tensor:
    """[2, 256] u8 on ``dev``: the alpha flag and the transparent-texel fraction by block id."""
    a = np.zeros((2, 256), np.uint8)
    a[0, :len(flags)] = np.frombuffer(flags, np.uint8)
    a[1, :len(frac)] = np.frombuffer(frac, np.uint8)
    return torch.from_numpy(a).to(dev)


def _scene_dims(Z: int, X: int, Y: int) -> None:
    if Z % 4 or X % 4 or Y % 16 or Y > 512:
        raise ValueError(f"scene dims {(Z, X, Y)}: Z and X must be multiples of 4, Y of 16 and at most 512")


def _aligned(t: torch.Tensor, name: str, to: int) -> None:
    if t.data_ptr() % to:
        raise ValueError(f"{name}: data not aligned to {to} bytes")


def scene_fields(vol):
    """K10: [Z, X, Y] u8 block ids (Z, X multiples of 4, Y of 16 and at most 512) -> flat
    i32 fine ++ macro words (one count per call; the entry point makes 7 launches,
    ``scene_launches()``).  The alpha-flag and transparent-fraction tables are read from
    ``render.brickmap`` at each call, as the plain version reads them, and copied to the
    card once per content.  Scratch: two state buffers, 8 bytes a voxel of each level."""
    from ..render import brickmap

    dev = vol.device
    Z, X, Y = vol.shape
    _check(vol, "vol", torch.uint8, (Z, X, Y), dev)
    _scene_dims(Z, X, Y)
    if vol.data_ptr() % 16:  # the kernels read four ids a load
        vol = vol.clone()
    n = Z * X * Y
    flat = torch.empty((n + n // 64,), dtype=torch.int32, device=dev)
    state = torch.empty((2 * (n + n // 64),), dtype=torch.int32, device=dev)
    cols = torch.empty((2 * (Z * X + Z * X // 16),), dtype=torch.int32, device=dev)
    alpha = _alpha_tables(dev, np.asarray(brickmap.ALPHA_TESTED, np.uint8).tobytes(),
                          np.asarray(brickmap.ALPHA_T_FRAC, np.uint8).tobytes())
    if n:
        with torch.cuda.device(dev):
            _launch("scene_fields", _build.load().mmt_scene_fields, _p(vol), _p(alpha), Z, X, Y, _p(flat),
                    _p(state), _p(cols))
    return flat


def scene_launches() -> int:
    """The kernel launches that the last K10 or K10u call made on the card."""
    return int(_build.load().mmt_scene_launches())


def update_chunks(scene, d_blocks, slots, mask, gz: int, gx: int, z0: int, x0: int) -> None:
    """K10u: the gz x gx chunks ``slots`` (host ints, row-major; air where ``mask`` is
    false) of the slot table ``d_blocks`` [C, 16, 16, 384] u8 written into ``scene`` at
    volume offset (z0, x0) (multiples of 4), its window re-swept and its macro level
    recomputed, in place (7 launches, one count).  The slots go to the kernel by value:
    nothing is copied to the card.

    Precondition: the scene's macro level is the one computed from its fine level, as
    every writer of a scene leaves it (``empty_scene``, ``build_scene``, ``update_chunks``,
    ``tables.scene_from_numpy`` of a JAX ``Scene``).  The kernel takes a macro cell's
    solidity outside the region from its old macro word (low byte 0: solid) and reads the
    fine level only in the window; the plain version recomputes it from the whole fine
    level, so the two agree exactly under this precondition."""
    from ..render import brickmap

    dev = scene.flat.device
    Z, X, Y = scene.dims
    _check(scene.flat, "scene.flat", torch.int32, (Z * X * Y + Z * X * Y // 64,), dev)
    _check(d_blocks, "d_blocks", torch.uint8, (d_blocks.shape[0], 16, 16, Y), dev)
    _scene_dims(Z, X, Y)
    _aligned(scene.flat, "scene.flat", 16)
    _aligned(d_blocks, "d_blocks", 4)
    if z0 % 4 or x0 % 4:
        raise ValueError(f"region offset ({z0}, {x0}): must be multiples of 4 (whole macro cells)")
    n_reg = gz * gx
    if n_reg > brickmap.MAX_REGION_CHUNKS:
        raise ValueError(f"region of {n_reg} chunks: at most {brickmap.MAX_REGION_CHUNKS}")
    slots, mask = np.asarray(slots).reshape(-1), np.asarray(mask, bool).reshape(-1)
    if ((slots[mask] < 0) | (slots[mask] >= d_blocks.shape[0])).any():
        raise ValueError(f"slots {slots.tolist()} outside the slot table of {d_blocks.shape[0]}")
    zlo, xlo, wz, wx = brickmap.update_window(scene.dims, gz, gx, z0, x0)
    n_w, n_m = wz * wx * Y, Z * X * Y // 64
    state = torch.empty((2 * (n_w + n_m),), dtype=torch.int32, device=dev)
    cols = torch.empty((2 * (wz * wx + Z * X // 16),), dtype=torch.int32, device=dev)
    alpha = _alpha_tables(dev, np.asarray(brickmap.ALPHA_TESTED, np.uint8).tobytes(),
                          np.asarray(brickmap.ALPHA_T_FRAC, np.uint8).tobytes())
    c_slots = (ctypes.c_int * max(n_reg, 1))(*np.where(mask, slots, -1).tolist())
    with torch.cuda.device(dev):
        _launch("update_chunks", _build.load().mmt_update_chunks, _p(scene.flat), _p(d_blocks), c_slots,
                gz, gx, z0, x0, zlo, xlo, wz, wx, _p(alpha), Z, X, Y, _p(state), _p(cols))


class _SceneArgs(ctypes.Structure):
    _fields_ = [("flat", ctypes.c_void_p), ("tex_diff", ctypes.c_void_p), ("zdim", ctypes.c_int),
                ("xdim", ctypes.c_int), ("ydim", ctypes.c_int), ("o0", ctypes.c_float),
                ("o1", ctypes.c_float), ("o2", ctypes.c_float)]


class _TraceArgs(ctypes.Structure):
    _fields_ = [("sc", _SceneArgs)] + [(k, ctypes.c_void_p) for k in (
        "ox", "oy", "oz", "dx", "dy", "dz", "medium", "active", "seed")] + [
        ("n", ctypes.c_int), ("max_steps", ctypes.c_int), ("use_macro", ctypes.c_int)] + [
        (k, ctypes.c_void_p) for k in ("hit", "t", "block", "nx", "ny", "nz", "steps")]


class _RenderArgs(ctypes.Structure):
    _fields_ = [("sc", _SceneArgs), ("tex_emis", ctypes.c_void_p), ("tex_norm", ctypes.c_void_p),
                ("params", ctypes.c_void_p)] + [(k, ctypes.c_int) for k in (
                    "height", "width", "row0", "col0", "full_height", "full_width")] + [
        ("frame_id", ctypes.c_uint32)] + [(k, ctypes.c_int) for k in (
            "exact", "max_ray_depth", "max_loop_iters", "max_steps", "bounce_steps", "shadow_steps",
            "mapped_normals")] + [("fog_scatter", ctypes.c_float)] + [
        (k, ctypes.c_void_p) for k in ("color", "albedo", "normal", "depth", "steps", "ws", "pass_steps")]


def _scene_args(scene) -> _SceneArgs:
    from ..render.materials import kernel_tables

    dev = scene.flat.device
    z, x, y = scene.dims
    _check(scene.flat, "scene.flat", torch.int32, (z * x * y + z * x * y // 64,), dev)
    tex = kernel_tables(dev)["tex_diff"]
    return _SceneArgs(_p(scene.flat), _p(tex), z, x, y, *(float(v) for v in scene.origin))


def _launch_struct(name: str, fn, args) -> None:
    err = fn(ctypes.byref(args), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"kernel {name} failed to launch: cudaError_t {err}")
    LAUNCHES[name] += 1


def trace(scene, ox, oy, oz, dx, dy, dz, medium, max_steps: int, active=None, want_steps=False,
          alpha: str = "exact", seed=None, use_macro: bool = True):
    """K11t: the DDA of N rays (any one shape) through ``scene`` -> TraceResult (and
    i32 steps with ``want_steps``); ``seed`` (int64 holding u32, or int32 bits) with
    alpha="stochastic"."""
    from ..render.tracer import TraceResult

    dev = scene.flat.device
    shape = ox.shape
    rays = (ox, oy, oz, dx, dy, dz)
    for name, v in zip(("ox", "oy", "oz", "dx", "dy", "dz"), rays):
        _check(v, name, torch.float32, shape, dev)
    _check(medium, "medium", torch.uint8, shape, dev)
    if active is not None:
        _check(active, "active", torch.bool, shape, dev)
    sd = None
    if alpha == "stochastic":
        if seed is None or seed.device != dev or tuple(seed.shape) != tuple(shape):
            raise ValueError("alpha='stochastic' needs a per-ray seed on the scene's device")
        sd = (seed.to(torch.int64) & 0xFFFFFFFF).to(torch.int64)
        sd = torch.where(sd >= 2 ** 31, sd - 2 ** 32, sd).to(torch.int32).contiguous()
    elif alpha != "exact":
        raise ValueError(f"alpha must be 'exact' or 'stochastic', not {alpha!r}")
    n = ox.numel()
    e = lambda dt: torch.empty(shape, dtype=dt, device=dev)  # noqa: E731
    hit, t, block = e(torch.bool), e(torch.float32), e(torch.uint8)
    nx, ny, nz = e(torch.float32), e(torch.float32), e(torch.float32)
    steps = e(torch.int32) if want_steps else None
    ptr = lambda v: None if v is None else _p(v)  # noqa: E731
    args = _TraceArgs(_scene_args(scene), *(_p(v) for v in rays), _p(medium), ptr(active),
                      ptr(sd), n, int(max_steps), int(use_macro), _p(hit), _p(t), _p(block), _p(nx),
                      _p(ny), _p(nz), ptr(steps))
    if n:
        with torch.cuda.device(dev):
            _launch_struct("trace", _build.load().mmt_trace, args)
    res = TraceResult(hit, t, block, nx, ny, nz)
    return (res, steps) if want_steps else res


def _param_vec(dev, cam, params) -> torch.Tensor:
    """The camera and sky parameters as the one f32 vector the tracer kernels read
    (``csrc/trace.cuh`` frame_sky / camera_ray)."""
    vec = [(cam.position, 3), (cam.forward, 3), (cam.right, 3), (cam.up, 3), (cam.pixel_length, 2),
           (params.sun_dir, 3), (params.moon_dir, 3), (params.stars_rot, 9), (params.time, 1)]
    for t, n in vec:
        if t.device != dev or t.dtype != torch.float32 or t.numel() != n:
            raise ValueError(f"camera / sky parameter: {t.dtype} {tuple(t.shape)} on {t.device}, "
                             f"expected {n} f32 on {dev}")
    return torch.cat([t.reshape(-1) for t, _ in vec]).contiguous()


def render_sample(scene, cam, params, height: int, width: int, frame_id: int, row0: int,
                  full_height: int, col0: int, full_width: int, exact: bool, want_steps: bool,
                  pass_steps=None):
    """K11: one 1-spp sample of a tile -> (color, albedo, normal [H, W, 3] f32, depth
    [H, W] f32, steps [H, W, 4] i32 or None).  One count per call; a launch a bounce
    (``render_launches()``: pass 0 over the tile, then one a later bounce over the live
    paths, whose queues and counters live in a workspace of this call).  ``pass_steps``: an
    i32 [MAX_LOOP_ITERS, H * W, 3] tensor on the scene's device or None; row (k, i) gets
    (pixel, radiance DDA steps, shadow DDA steps) of pass k's lane i (pass 0: i is the
    pixel; later passes: the queue slot), rows no lane took keep their values."""
    from ..render import tracer
    from ..render.materials import kernel_tables

    dev = scene.flat.device
    pvec = _param_vec(dev, cam, params)
    if not (0 <= row0 and row0 + height <= full_height and 0 <= col0 and col0 + width <= full_width):
        raise ValueError("the tile must lie inside the frame")
    loops = tracer.MAX_LOOP_ITERS
    if pass_steps is not None:
        _check(pass_steps, "pass_steps", torch.int32, (loops, height * width, 3), dev)
    tabs = kernel_tables(dev)
    e = lambda *shape, dt=torch.float32: torch.empty(shape, dtype=dt, device=dev)  # noqa: E731
    color, albedo, normal, depth = e(height, width, 3), e(height, width, 3), e(height, width, 3), e(height, width)
    steps = e(height, width, 4, dt=torch.int32) if want_steps else None
    lib = _build.load() if height and width else None
    ws = e(lib.mmt_render_workspace_words(height, width, loops), dt=torch.int32) if lib else None
    ptr = lambda v: None if v is None else _p(v)  # noqa: E731
    args = _RenderArgs(_scene_args(scene), _p(tabs["tex_emis"]), _p(tabs["tex_norm"]), _p(pvec),
                       height, width, row0, col0, full_height, full_width,
                       int(frame_id) & 0xFFFFFFFF, int(exact), tracer.MAX_RAY_DEPTH, loops,
                       tracer.MAX_TRACE_STEPS, tracer.BOUNCE_TRACE_STEPS,
                       tracer.SHADOW_TRACE_STEPS, int(tracer.MAPPED_NORMALS),
                       float(tracer.FOG_SCATTER), _p(color), _p(albedo), _p(normal), _p(depth),
                       ptr(steps), ptr(ws), ptr(pass_steps))
    if lib is not None:
        with torch.cuda.device(dev):
            _launch_struct("render_sample", lib.mmt_render_sample, args)
    return color, albedo, normal, depth, steps


def render_launches() -> int:
    """The kernel launches that the last K11 call made on the card."""
    return int(_build.load().mmt_render_launches())


def accumulate(c_old, a_old, n_old, color, albedo, normal, frame_id: int):
    """K12: the running average of three [H, W, 3] f32 buffers -> three new buffers."""
    from ..render.tracer import accumulate_weights

    dev = color.device
    shape = tuple(color.shape)
    if len(shape) != 3 or shape[2] != 3:
        raise ValueError(f"color: shape {shape}, expected [H, W, 3]")
    for name, t in (("fbs.color", c_old), ("fbs.albedo", a_old), ("fbs.normal", n_old),
                    ("color", color), ("albedo", albedo), ("normal", normal)):
        _check(t, name, torch.float32, shape, dev)
    fid, mult = accumulate_weights(frame_id)
    outs = [torch.empty(shape, dtype=torch.float32, device=dev) for _ in range(3)]
    if color.numel():
        with torch.cuda.device(dev):
            _launch("accumulate", _build.load().mmt_accumulate, _p(c_old), _p(a_old), _p(n_old),
                    _p(color), _p(albedo), _p(normal), color.numel(), fid, mult, *(_p(o) for o in outs))
    return outs


class _DebugArgs(ctypes.Structure):
    _fields_ = [("sc", _SceneArgs), ("params", ctypes.c_void_p)] + [
        (k, ctypes.c_int) for k in ("height", "width", "max_steps", "tint_cell")] + [
        (k, ctypes.c_void_p) for k in ("img", "bright", "tmp", "out", "steps")]


def render_debug(scene, cam, params, height: int, width: int, tint_cell: int, want_steps: bool = False):
    """K17: the debug renderer's frame -> ([H, W, 3] f32 linear HDR, [H, W] i32 DDA steps
    of each pixel's traces or None).  ``tint_cell``: 0, 16 (chunk) or 192 (zone).  One
    count per call; eleven launches (the shading, then ten blur passes)."""
    from ..render.tracer import MAX_TRACE_STEPS

    dev = scene.flat.device
    if tint_cell not in (0, 16, 192):
        raise ValueError(f"tint_cell must be 0, 16 or 192, not {tint_cell}")
    pvec = _param_vec(dev, cam, params)
    bufs = torch.empty((3, height, width, 3), dtype=torch.float32, device=dev)
    out = torch.empty((height, width, 3), dtype=torch.float32, device=dev)
    steps = torch.empty((height, width), dtype=torch.int32, device=dev) if want_steps else None
    args = _DebugArgs(_scene_args(scene), _p(pvec), height, width, MAX_TRACE_STEPS, int(tint_cell), _p(bufs[0]),
                      _p(bufs[1]), _p(bufs[2]), _p(out), None if steps is None else _p(steps))
    if height and width:
        with torch.cuda.device(dev):
            _launch_struct("render_debug", _build.load().mmt_render_debug, args)
    return out, steps


# ---------------------------------------------------------------------------------------
# the engine's frame path (csrc/reproject.cu, csrc/denoise.cu, csrc/present.cu)
# ---------------------------------------------------------------------------------------


def _check_history(fbs, c, a, n, d):
    dev = d.device
    H, W = d.shape
    for name, t in (("fbs.color", fbs.color), ("fbs.albedo", fbs.albedo), ("fbs.normal", fbs.normal),
                    ("color", c), ("albedo", a), ("normal", n)):
        _check(t, name, torch.float32, (H, W, 3), dev)
    for name, t in (("fbs.depth", fbs.depth), ("fbs.nsamp", fbs.nsamp), ("depth", d)):
        _check(t, name, torch.float32, (H, W), dev)
    e = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)  # noqa: E731
    return dev, H, W, (e(H, W, 3), e(H, W, 3), e(H, W, 3), e(H, W), e(H, W))


def reproject(fbs, cam_prev, cam, c, a, n, d):
    """K13: the sample (c, a, n [H, W, 3], d [H, W] f32) blended into the history ``fbs``
    reprojected from ``cam_prev`` to ``cam`` -> (colour, albedo, normal, depth, nsamp),
    new buffers."""
    dev, H, W, outs = _check_history(fbs, c, a, n, d)
    for cm in (cam_prev, cam):
        for t, k in zip(cm, (3, 3, 3, 3, 2)):
            if t.device != dev or t.dtype != torch.float32 or t.numel() != k:
                raise ValueError(f"camera: {t.dtype} {tuple(t.shape)} on {t.device}, expected {k} f32 on {dev}")
    cams = torch.cat([t.reshape(-1) for t in (*cam_prev, *cam)])
    if H * W:
        with torch.cuda.device(dev):
            _launch("reproject", _build.load().mmt_reproject, *(_p(t) for t in fbs[:5]), _p(c), _p(a), _p(n),
                    _p(d), _p(cams), H, W, *(_p(o) for o in outs))
    return outs


def static_blend(fbs, c, a, n, d):
    """K13s: the sample blended into the history of a static camera (shortened to 3 where
    the first-hit distance moved) -> (colour, albedo, normal, depth, nsamp), new buffers."""
    dev, H, W, outs = _check_history(fbs, c, a, n, d)
    if H * W:
        with torch.cuda.device(dev):
            _launch("static_blend", _build.load().mmt_static_blend, *(_p(t) for t in fbs[:5]), _p(c), _p(a),
                    _p(n), _p(d), H * W, *(_p(o) for o in outs))
    return outs


def atrous_denoise(color, albedo, normal, nsamp, iterations: int, sigma_color: float, sigma_albedo: float,
                   sigma_normal: float):
    """K14: ``iterations`` à-trous passes over [H, W, 3] f32 colour with its albedo and
    normal guides (and [H, W] f32 ``nsamp`` or None) -> denoised colour.  One count per
    call; one launch per iteration."""
    from ..render.denoise import sigma_terms

    dev = color.device
    H, W = color.shape[0], color.shape[1]
    for name, t in (("color", color), ("albedo", albedo), ("normal", normal)):
        _check(t, name, torch.float32, (H, W, 3), dev)
    if nsamp is not None:
        _check(nsamp, "nsamp", torch.float32, (H, W), dev)
    if iterations < 1:
        return color.clone()
    inv_sc2, sa2, sn2 = sigma_terms(sigma_color, sigma_albedo, sigma_normal)
    bufs = torch.empty((2, H, W, 3), dtype=torch.float32, device=dev)
    if H * W:
        with torch.cuda.device(dev):
            _launch("atrous_denoise", _build.load().mmt_atrous_denoise, _p(color), _p(albedo), _p(normal),
                    None if nsamp is None else _p(nsamp), iterations, inv_sc2,
                    float(np.float32(sigma_color ** 2)), sa2, sn2, H, W, _p(bufs))
    return bufs[(iterations - 1) % 2]


def upscale2x(img):
    """K15: bilinear 2x upscale, [H, W, 3] f32 -> [2H, 2W, 3] f32."""
    dev = img.device
    H, W = img.shape[0], img.shape[1]
    _check(img, "img", torch.float32, (H, W, 3), dev)
    out = torch.empty((2 * H, 2 * W, 3), dtype=torch.float32, device=dev)
    if H * W:
        with _on(dev):
            _launch("upscale2x", _build.load().mmt_upscale2x, _p(img), H, W, _p(out))
    return out


def present(hdr):
    """K16: ACES tonemap and gamma, [H, W, 3] f32 -> [H, W, 3] u8."""
    dev = hdr.device
    _check(hdr, "hdr", torch.float32, (hdr.shape[0], hdr.shape[1], 3), dev)
    out = torch.empty(hdr.shape, dtype=torch.uint8, device=dev)
    if hdr.numel():
        with torch.cuda.device(dev):
            _launch("present", _build.load().mmt_present, _p(hdr), hdr.numel(), _p(out))
    return out
