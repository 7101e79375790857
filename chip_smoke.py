#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``mega_minecraft_tpu_torch``) once on one GPU.

Usage (from the root of a checkout, on a machine with one CUDA GPU):

    python3 chip_smoke.py [--ptxas]

Phases, each of which raises (non-zero exit) on failure:
  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the kernels from ``mega_minecraft_tpu_torch/csrc`` with nvcc (one process per
     source, started together);
  3. hold each kernel K1-K8 (and K7's stream pre-kernel) against its plain PyTorch
     version on the card, on the 5 golden chunks plus 2 seeded ones (K7: each chunk as
     a 1x1 area); K3 here and wherever it is checked below runs twice, on its cell table
     (``terrain/caves.py`` ``CELL_TABLE_CAP`` cells) and with a table of 0 cells, so that
     every tile takes its direct path, each bit for bit on the four cave arrays and the
     carve band, with the tiles that took the direct path and the largest cell box printed;
     K4 likewise here and wherever it is checked below, on its lush-cave cell table
     (``tables.LUSH_TABLE_CELLS``) and with a table of 0 cells, with its stats printed (blocks
     queued for the cave biome, lush blocks, largest cell box, tiles on the direct path), also
     on three far chunks (the last past |x| = 671,088,640, its clay cells past 2^24); K7's
     pre-pass lists (each chunk's culled gathered entries) against ``features.cull_area_plain``
     wherever K7 is checked, with the candidate counts printed (visible entries, survivors);
     and K7 on synthetic lists that overflow K6's list, the gather cap and cross-chunk priority;
     K5 here and wherever it is checked below bit for bit, also on the far chunks; K7's stream
     pre-kernel (K7a) here and wherever it is checked below into NaN-filled
     outputs: its valid rows (slot < min(count, K)) bit for bit against ``draw_streams_plain``,
     every other row still NaN, and K7 / K7s then run on those rows;
  4. hold K1-K3 against ``tests/golden/golden_chunks.npz`` and the featured 7x7 areas
     around the four chunks of ``tests/golden/golden_blockgrid.npz`` against its
     ``pre_*`` (fill + features) and ``post_*`` (after decorators) centre chunks, at
     tests/test_golden.py's gates;
  5. generate the FEATURED 5x5 bench area (the main path) through
     ``pipeline.generate_area_fused(..., features=True)`` with the launch counts reset
     just before and read just after (exactly one launch per kernel); hold each kernel
     at the 5x5 shapes, and every output of the 5x5 run, against the plain versions on
     the same inputs; the featureless 5x5 run likewise, which must equal the middle of
     the featureless 33x33 run bit for bit; then the featured 33x33 area, whose middle
     5x5 chunks must equal those of a featured 11x11 run (both see full 49-chunk
     neighbourhoods), and bedrock at y = 0 in every column; K3, K4, K5, K7a and K7 (its blocks
     and its pre-pass lists) against their plain versions at the 5x5 and the 33x33 shapes, and
     the 33x33 slice's lists against K6's plain version on K5's plain grids;
  6. time the slices, the feature half and every kernel (and its plain version at the
     5x5 shapes) warm with CUDA events, K3's, K4's, K5's, K7a's and K7's
     device time under torch.profiler, and compute every kernel's bound (K4's also with every
     lush block hashing its cells); K5's walk replayed (``k5_work``): draws and position tests a
     column, and the test sites a warp runs;
  7. hold K9 (zone erosion) against its plain version bit for bit, with the same sweep
     counts, and against ``tests/golden/golden_erosion.npz`` at tests/test_golden.py's
     gate; generate the eroded featured 24x24 area through ``pipeline.generate_area(...,
     erode=True)`` with the launch counts reset around it, hold K9 on its grid and its
     layers against the plain chain, and time K9 per zone;
  8. drain ``scheduler.make_scheduler(1024, radius=8, skip_erosion=True, native=True)``
     with the counts reset around it (one launch per kernel per stage dispatch): every
     filled chunk must equal the featured area path in every field; K5 on the first and
     largest placement batch read from the slot table; K7a rerun over every placement batch
     into NaN-filled slot tables through its rows, equal to the drain's own rows (written in
     place) and the plain streams; K2s and K7s (on the NaN-filled tables) against their plain
     versions on their stage's first and largest batch; K7s's window cull against none on
     every filled chunk, and with K8 against the drain's blocks;
  9. drain the reference workload, ``make_scheduler(radius=None, skip_erosion=False,
     native=True)`` (the radius-40 spiral, 1,089 drawable chunks), with the counts reset
     around it; replay its first zone erosion through the plain versions; K3 against its
     plain version on its largest caves batch, K4, K7s and K7s's pre-pass lists on its largest
     fill batch; time K2s and K7s at its largest batches against their plain versions (K7s's
     device time too); drain it again with the
     ``StageTimer`` and once more under ``torch.profiler`` for the device's busy share (and
     K5's and K7a's device seconds);
 10. the render path's main run, as bench_render.py drives it, with the counts reset just
     before and read just after: ``brickmap.build_scene`` of the 10x10 bench scene (four
     featured 5x5 areas tiled as tools/scenelib.py tiles them) (K10), ``tracer.trace`` of
     its 1080p primary rays (K11t), one ``render_sample`` + ``accumulate`` and eight
     ``render_accumulate`` (K11, K12); K10 against its plain version bit for bit on that
     scene, on a 36x20x384 cut of it (dims that are multiples of 4 but not of the prep's
     4x4-column groups' 16) and on the 33x33 featured area at chunk (-16, -16), its device
     launches a call (``kernels.scene_launches()``) at most 20;
 11. K11t on the 1080p primary rays (every output equal); K11 on the whole 1080p frame 3
     of both scenes by day (sun_time 1.0), and of the 10x10 scene at night (sun_time 4.0,
     sun below the horizon) and with ``exact=True``, and on a 997x135 tile at row 271,
     column 13 of that frame (sizes that fit no CTA tile) of both scenes by day (counts,
     colour, albedo, normal and depth equal); the
     alpha-cutout code under the hand-set atlas of tests/test_torch_cuda.py (K10 bit for
     bit; K11t exact and stochastic on the primary rays and on rays aimed at flagged
     voxels; K11 on the 1080p frame of a camera aimed at one, in both trace modes); K12
     bit for bit, and one K11 and one K12 launch per ``render_accumulate``;
 12. ms/frame and Mpaths/s of eight accumulated frames at 1080p and 540p on both scenes;
     at each, from K11's per-pass counts (``kernels.render_sample(..., pass_steps=)``) the
     live paths each pass takes and the SIMT efficiency of the DDA steps under the bounce
     loop over 1x32-pixel rows and over 8x4-pixel tiles and under the wavefront (each pass
     too), and K11's device spans by launch (torch.profiler) beside
     ``kernels.render_launches()``; K10 per scene, every render kernel against its plain
     version, and the step counts per pixel (primary, bounce, shadow rays; mean, p99, max)
     from K11's counts output;
 13. the engine's frame kernels against their plain versions, bit for bit: K10u
     (``brickmap.update_chunks``) on the featured 33x33 scene (a 3x3 bucket rewritten with
     one chunk air, a bucket removed, the corner bucket with its window clamped; its device
     launches a call at most 20), K13 and
     K13s after a moved and a static camera at 960x540, K14 with and without nsamp, K15 to
     1920x1080 (also within 1e-6 of ``F.interpolate``) and at 1x1, 5x3 and 9x7, K16 at
     1920x1080; each timed (plain, kernel, kernel, plain) with its bound, K15's library
     call timed; K15's and ``F.interpolate``'s calls beside their device time;
 14. the reference fly-through (bench_flythrough.py:27-36: 1920x1080 upscaled from
     960x540, view_chunks 33, the radius-40 spiral with erosion, denoise, reprojection)
     through ``app.engine.Engine``: the drain, then with the counts reset around them the
     upload (121 K10u buckets), 30 ticks 2 blocks forward (one K11 and one K13 / K13s
     each) and one present (one K14, K15, K16), timed; the presented [1080, 1920, 3] u8
     frame equal to the plain denoise -> upscale -> present chain on the same buffers; the
     same run on a second engine under torch.profiler for the idle share and the device
     time by stage, its upload's buckets recorded and replayed through
     ``update_chunks_plain`` from the empty scene: the scene after the whole upload equal
     bit for bit;
 15. K17 (``render_debug``) with the counts reset around one call (one K17 launch, nothing
     else), then against ``render_debug_plain`` bit for bit at 1920x1080, DDA step counts
     equal, on phase 10's 10x10 scene and camera and on the featured 33x33 scene (day
     with no tint, the chunk and the zone tint; night), and on the 10x10 scene with
     glowstone at voxels the camera sees (its bright pass, printed, not empty); timed
     warm (kernel and plain in turns, the 33x33 frame, the library's bloom: 10 x
     ``F.pad(circular)`` + ``F.conv2d``) with its bound; its device time split between the
     shading and the blur launches under torch.profiler;
 16. the entry points: ``generate_demo.main(["--device", "cuda", "--render", ...])`` at its
     defaults (5x5 chunks, 640x360, 8 samples) with the counts reset around it (K10 1, K11
     8, K12 8, K14 1, K16 1), its PPM decoded to 640x360x3; ``viewer.routed_tick`` on
     phase 14's second engine under a scripted input (w + shift held, the arrows, the
     events p [ ] k f), the presented frame through ``encode_png`` and back equal; the
     mesher on the 5x5 area's chunk (0, 0), ``native.available()`` printed, the native
     face scan's mesh equal to the numpy scan's;
 17. the sharded programs of ``parallel/sharding.py`` on meshes that repeat the card
     (``Mesh([cuda:0] * n)``; and on a mesh of every card when there are several), each
     main run with the counts reset around it: ``dp_generate`` of the 1,024 chunks of a
     32x32 area at chunk (-16, -16) over 1 and 4 shards (one K2h and one K4 a shard; the
     blocks equal to K4 with no caves on the area path's K1 / K2 outputs, K2h's outputs
     equal to those bit for bit and to its plain version on the 1,024 and the 256 chunks);
     ``erode_zone_sharded`` over 1, 2, 4 and 8 shards on both ``golden_erosion.npz`` grids
     and the eroded 24x24 area's grid (equal to K9 bit for bit, same sweep counts, shards x
     sweeps K9b launches), K9b against its plain version on one band; ``sharded_render``
     of the 1080p frame over 4 and 8 bands on the 10x10 and 33x33 scenes (equal to the
     whole-frame K11 bit for bit, one K11 a band); then times: K2h at 16, 256 and 1,024
     chunks and K9b alone, each a call between CUDA events and its launches' device time
     under torch.profiler, ``dp_generate`` chunks/s, the sharded zone beside K9 and the
     sharded frame beside the whole-frame K11 (the virtual shards measure the cost of the
     split: extra launches, halo copies, one host sync a sweep, not any scaling).
On the card, kernel and plain version run the same libm, so integer outputs must be
equal; float outputs are held to max |diff| <= 1e-3 with >= 99.9% within 1e-5 (the frame
path's kernels: equal).
The second-to-last line is the kernels' JSON record (launch counts of the featured 5x5
run for the area kernels, of the reference drain for K9, K2s and K7s, of the render run
for K10-K12, of the fly-through's upload, ticks and present for K10u and K13-K16 and of
one ``render_debug`` for K17; max
|diff| over all checks; times and bounds at the 5x5 shapes, of K9 on the eroded area's
grid, of K2s and K7s at the reference drain's largest batches, of K10-K12 on the 10x10
bench scene at 1080p, of K10u per 33x33 bucket, of K13-K16 at the fly-through's
shapes, of K17 on the 10x10 scene at 1080p by day, of K2h (and its plain version) on 256
chunks, the shard of the 4-shard ``dp_generate`` that gives its launches, and of K9b on a
96-row band (launches: the 4-shard erosion of the 24x24 area's grid; its ``ms`` is a
wrapper call between CUDA events, host-bound, the device time printed beside it); library times: K2s's gather as one indexing call, K12's three
``torch.lerp``, K15's ``F.interpolate``, K17's bloom as pad + conv2d), the last the
device record.
``--ptxas`` also prints each kernel's registers / spills (nvcc -Xptxas -v).

A kernel's bound is the least time the card could take for the same work: the larger of
the bytes it must move (each input read once, each output written once; of the
placement lists only the valid entries) over 3.35 TB/s and its f32 operations over
67 TFLOP/s (the H100 SXM's published rates).  Operations are what the function needs on
this run's data, with the unit costs below (how many biomes have weight, how many blocks
reach the cave-biome noise, which voxels lie in a placement's window and height bounds
and pass its terrain test, how many distinct Worley cells a chunk's carve tests read: K3
counts each one's three hashes once a chunk, not 81 a block), not what a kernel's design
spends; they are estimates good to a few tens of percent.  The render kernels: K10 the u8 volume read and the words
written, and the doubling rounds' operations per voxel (the function is that transform);
K11t and K11 the rays' or frame's inputs and outputs plus the field words their DDA steps
read (at most the field), and the steps this frame's rays took (K11's counts output) times
the cost of a step, plus a bounce's shading per radiance ray and the cloud march per
first-hit ray that looks up; K12 three buffers read twice and written once; K10u the
window's words read and written, the region's blocks, the old macro words read and the
new ones written, and K10's operations per window voxel and macro cell; K13 / K13s 32 floats a pixel (history and sample read, new history written); K14
its colour read and written per iteration and the guides once, and ~45 operations per tap
(25 taps, 4 iterations); K15 and K16 their input and output once; K17 its frame written
once and the field words its DDA steps read, and 140 operations per DDA step taken (the
steps the plain version counts on the same rays) plus 60 a ray (a primary and eight fog
rays a pixel, a shadow ray a hit), ~500 a pixel of fog and shading, 150 a hit, 500 a
miss's sky, the cloud march of the misses that look up and 54 a pixel per blur pass (ten).
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "golden" / "golden_chunks.npz"
GOLDEN_CHUNKS = [(0, 0), (592, -368), (-1024, 2048), (4096, 4096), (-160, -160)]
#: K4's far chunks (blocks), the last past |x| = 671,088,640 (lush clay cells past 2^24)
FAR_CHUNKS = [(1048576, -1048576), (-2000000, 3000000), (671089664, -671092736)]
SEED = 20261016

KERNELS = {  # name -> (source, the JAX program it replaces)
    "heightfield": ("mega_minecraft_tpu_torch/csrc/heightfield.cu",
                    "mega_minecraft_tpu/terrain/heightfield.py:299"),
    "layers": ("mega_minecraft_tpu_torch/csrc/layers.cu",
               "mega_minecraft_tpu/terrain/layers.py:60"),
    "caves": ("mega_minecraft_tpu_torch/csrc/caves.cu",
              "mega_minecraft_tpu/terrain/caves.py:175"),
    "fill": ("mega_minecraft_tpu_torch/csrc/fill.cu",
             "mega_minecraft_tpu/terrain/fill.py:283"),
    "placements": ("mega_minecraft_tpu_torch/csrc/placements.cu",
                   "mega_minecraft_tpu/terrain/feature_placement.py:92"),
    "compact_placements": ("mega_minecraft_tpu_torch/csrc/placements.cu",
                           "mega_minecraft_tpu/terrain/feature_placement.py:256"),
    "feature_streams": ("mega_minecraft_tpu_torch/csrc/features.cu",
                        "mega_minecraft_tpu/terrain/features_sdf.py:1014"),
    "features": ("mega_minecraft_tpu_torch/csrc/features.cu",
                 "mega_minecraft_tpu/terrain/features.py:173"),
    "decorators": ("mega_minecraft_tpu_torch/csrc/decorators.cu",
                   "mega_minecraft_tpu/terrain/decorators.py:53"),
    "erosion": ("mega_minecraft_tpu_torch/csrc/erosion.cu",
                "mega_minecraft_tpu/terrain/erosion.py:59"),
    "layers_slots": ("mega_minecraft_tpu_torch/csrc/layers.cu",
                     "mega_minecraft_tpu/terrain/scheduler.py:97"),
    "features_slots": ("mega_minecraft_tpu_torch/csrc/features.cu",
                       "mega_minecraft_tpu/terrain/features.py:471"),
    "scene_fields": ("mega_minecraft_tpu_torch/csrc/brickmap.cu",
                     "mega_minecraft_tpu/render/brickmap.py:289"),
    "trace": ("mega_minecraft_tpu_torch/csrc/tracer.cu", "mega_minecraft_tpu/render/tracer.py:104"),
    "render_sample": ("mega_minecraft_tpu_torch/csrc/tracer.cu",
                      "mega_minecraft_tpu/render/tracer.py:1259"),
    "accumulate": ("mega_minecraft_tpu_torch/csrc/accumulate.cu",
                   "mega_minecraft_tpu/render/tracer.py:1584"),
    "update_chunks": ("mega_minecraft_tpu_torch/csrc/brickmap.cu",
                      "mega_minecraft_tpu/render/brickmap.py:325"),
    "reproject": ("mega_minecraft_tpu_torch/csrc/reproject.cu",
                  "mega_minecraft_tpu/render/reproject.py:47"),
    "static_blend": ("mega_minecraft_tpu_torch/csrc/reproject.cu",
                     "mega_minecraft_tpu/render/reproject.py:158"),
    "atrous_denoise": ("mega_minecraft_tpu_torch/csrc/denoise.cu",
                       "mega_minecraft_tpu/render/denoise.py:32"),
    "upscale2x": ("mega_minecraft_tpu_torch/csrc/present.cu",
                  "mega_minecraft_tpu/render/denoise.py:112"),
    "present": ("mega_minecraft_tpu_torch/csrc/present.cu",
                "mega_minecraft_tpu/render/tonemap.py:22"),
    "render_debug": ("mega_minecraft_tpu_torch/csrc/debug.cu",
                     "mega_minecraft_tpu/render/debug_renderer.py:58"),
    "dp_layers": ("mega_minecraft_tpu_torch/csrc/layers.cu",
                  "mega_minecraft_tpu/parallel/sharding.py:58"),
    "erosion_band": ("mega_minecraft_tpu_torch/csrc/erosion.cu",
                     "mega_minecraft_tpu/parallel/sharding.py:124"),
}
#: the sharded programs' own kernels (phase 17); they also run K4 and K11
SHARD_KERNELS = ("dp_layers", "erosion_band")
#: the engine's frame path (Engine.tick -> Engine.present)
FRAME_KERNELS = ("update_chunks", "reproject", "static_blend", "atrous_denoise", "upscale2x", "present")
#: the render path's kernels (build_scene, trace, render_sample, accumulate)
RENDER_KERNELS = ("scene_fields", "trace", "render_sample", "accumulate")
#: the area path's kernels (generate_area_fused(..., features=True)); the featureless slice
AREA_KERNELS = ("heightfield", "layers", "caves", "fill", "placements", "compact_placements",
                "feature_streams", "features", "decorators")
GEN_KERNELS = ("heightfield", "layers", "caves", "fill")
#: the streaming path's kernels (make_scheduler(...).drain()); erosion only with it on
STREAM_KERNELS = ("heightfield", "layers_slots", "erosion", "caves", "placements",
                  "compact_placements", "feature_streams", "fill", "features_slots", "decorators")
#: per scheduler dispatch, the kernels it launches once each
DISPATCH_KERNELS = {
    "dispatch_heightfield": ("heightfield",), "dispatch_layers": ("layers_slots",),
    "dispatch_erosion": ("erosion",), "dispatch_caves": ("caves",),
    "dispatch_feature_placements": ("placements", "compact_placements", "feature_streams"),
    "dispatch_fill": ("fill", "features_slots", "decorators"),
}
EROSION_GOLDEN = ROOT / "tests" / "golden" / "golden_erosion.npz"

#: block-grid golden gates (tests/test_golden.py:254-255)
BLOCKGRID = ROOT / "tests" / "golden" / "golden_blockgrid.npz"
BLOCKGRID_GATES = {(0, 0): 0.9999, (592, -368): 0.9999, (4096, 4096): 0.9993, (-160, -160): 0.998}

# -- the card's published rates (H100 SXM) and unit costs in f32 operations, counted off
# csrc/mmt_math.cuh (each add, multiply, divide, floor, compare-select is one)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
SINHASH = 455  # sin_cr: 4 two_prod (17), 7 two_sum (6), 9 ds_mul (27), 7 ds_add (14), ~40 more
SIMPLEX2 = 155
SIMPLEX3 = 400
WORLEY2 = 9 * (2 * (SINHASH + 4) + 12)
WORLEY3 = 27 * (3 * (SINHASH + 6) + 15)


def fbm2_ops(octaves):
    return octaves * (SIMPLEX2 + 5)


def fbm3_ops(octaves):
    return octaves * (SIMPLEX3 + 7)


CAVE_BIOME = 3 * fbm3_ops(3) + 4 * fbm2_ops(3) + 2 * SIMPLEX3 + 130
#: per-biome height formula (heightfield.cu biome_height), as (simplex2 count, worley2 count)
HEIGHT_FORMULA = {"ARCHIPELAGO": (9, 0), "SAVANNA": (16, 2), "MESA": (15, 1), "SPARSE_DESERT": (6, 1),
                  "TIANZI_MOUNTAINS": (9, 2), "CRYSTALS": (6, 1), "MOUNTAINS": (15, 0),
                  "LUSH_BIRCH_FOREST": (6, 0), "JUNGLE": (6, 0)}  # every other biome: (5, 0)
#: rough f32 operations of one SDF evaluation by feature id (features_sdf.cuh)
SDF_OPS_SURFACE = {1: 6, 2: 900, 3: 10, 4: 900, 5: 400, 6: 12000, 7: 3000, 8: 120, 9: 40, 10: 60,
                   11: 700, 12: 400, 13: 80, 14: 20, 15: 30, 16: 1500, 17: 1200, 18: 1200, 19: 900,
                   20: 120}
SDF_OPS_CAVE = {1: 4, 2: 4, 3: 20, 4: 250, 5: 40, 6: 40, 7: 60, 8: 250, 9: 1700}
# K7's own list walk (a diagnostic, not part of its bound): per column and visible list
# entry the rank search, loads and window compares; per voxel and entry whose window holds
# its column the loads and bounds compares
WINDOW_TEST_OPS = 12
LIST_WALK_OPS = 8


def nbytes(*tensors):
    total = 0
    for t in tensors:
        if isinstance(t, dict):
            total += nbytes(*t.values())
        else:
            total += t.numel() * t.element_size()
    return total


def bound(n_bytes, n_ops):
    """(bound_ms, bound_by) from the bytes a kernel must move and its f32 operations."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


class SmokeFailure(AssertionError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def close_stats(got, want):
    d = (got.double() - want.double()).abs()
    return float(d.max()), float((d <= 1e-5).double().mean())


def check_close(name, got, want):
    """Heightfield / weights / layers tolerance: max |diff| <= 1e-3 and >= 99.9% of
    values within 1e-5 (f32 noise chains; pow / sin go through each platform's libm)."""
    check(got.shape == want.shape, f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite values")
    mx, frac = close_stats(got, want)
    print(f"  {name}: max |diff| {mx:.3g}, within 1e-5: {frac:.6f}")
    check(mx <= 1e-3 and frac >= 0.999, f"{name}: max {mx} / frac {frac} outside 1e-3 / 0.999")
    return mx


def check_equal(name, got, want):
    """Integer outputs (block ids, cave layers, origins) must be equal."""
    check(got.shape == want.shape, f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    check(got.dtype == want.dtype, f"{name}: dtype {got.dtype} != {want.dtype}")
    n_diff = int((got != want).sum())
    mx = float((got.long() - want.long()).abs().max()) if got.numel() else 0.0
    print(f"  {name}: {n_diff} of {got.numel()} differ, max |diff| {mx:g}")
    check(n_diff == 0, f"{name}: {n_diff} values differ from the plain version")
    return mx


def check_area(n, out, bedrock):
    """Shape, dtype, finiteness and bedrock at y = 0 of an n x n area's outputs."""
    b = out["blocks"]
    check(tuple(b.shape) == (n * n, 16, 16, 384) and b.dtype == torch.uint8, f"{n}x{n} blocks shape")
    for k in ("heightfield", "biome_weights", "layers"):
        check(bool(torch.isfinite(out[k]).all()), f"{n}x{n} {k} not finite")
    check(bool((b[..., 0] == bedrock).all()), f"{n}x{n}: a column lacks bedrock at y=0")


def halo_positions(ox, oz, device):
    """[9, 2] i32 origins of the 3x3 chunks around world-block origin (ox, oz)."""
    pos = [[ox + 16 * dx, oz + 16 * dz] for dz in (-1, 0, 1) for dx in (-1, 0, 1)]
    return torch.tensor(pos, dtype=torch.int32, device=device)


def cuda_ms(fn, reps):
    fn()  # warm
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def check_dict_equal(prefix, got, want):
    """Every tensor of a (nested) dict of integer / bool outputs equal; max |diff|."""
    check(sorted(got) == sorted(want), f"{prefix}: keys {sorted(got)} != {sorted(want)}")
    mx = 0.0
    for k in want:
        if isinstance(want[k], dict):
            mx = max(mx, check_dict_equal(f"{prefix} {k}", got[k], want[k]))
        else:
            mx = max(mx, check_equal(f"{prefix} {k}", got[k], want[k]))
    return mx


def check_k5(tag, args5, want):
    """K5 against the plain version's grids ``want``, bit for bit; 0.0 (the max |diff|) or a
    failure."""
    from mega_minecraft_tpu_torch import kernels

    got = kernels.placements(*args5)
    check(sorted(got) == sorted(want), f"{tag} K5: keys {sorted(got)} != {sorted(want)}")
    diff = {k: int((got[k] != want[k]).sum()) for k in want}
    n = sum(v.numel() for v in want.values())
    print(f"  {tag} K5: {sum(diff.values())} of {n} values differ")
    check(not any(diff.values()), f"{tag} K5: values differ from the plain version {diff}")
    return 0.0


def k5_work(args5):
    """K5's walk replayed from its plain version's control flow (``generate_placements_plain``):
    per column its draws and its position tests (``is_feature_pos``, two sin-hashes, run only
    where every cheaper condition holds), and per warp of 32 columns the distinct (layer, slot,
    gen) sites at which any lane draws or tests.  The layer, slot and gen loops are the same for
    every lane, so a warp runs a site's test once for all its lanes: those sites are its work.
    Returns {"draws", "tests": [B * 256], "warp_draws", "warp_tests": [B * 8], "placed": the
    features placed (the plain version's count, a check of the replay)}."""
    from mega_minecraft_tpu_torch.ops import hashes
    from mega_minecraft_tpu_torch.terrain import feature_placement as fp
    from mega_minecraft_tpu_torch.terrain.fill import random_biome
    from mega_minecraft_tpu_torch.terrain.heightfield import column_world_coords
    from mega_minecraft_tpu_torch.world import biomes as bio, features_data as fd

    hf, w, ls, starts, ends, bottom, top_biome, pos = args5
    dev, B = hf.device, hf.shape[0]
    wx, wz = column_world_coords(pos)
    ground = hf.to(torch.int32)
    state = hashes.seed_3(wx, wz, fp.SEED_COLUMN)
    work = {k: torch.zeros(B * (256 if k in ("draws", "tests") else 8), dtype=torch.int32, device=dev)
            for k in ("draws", "tests", "warp_draws", "warp_tests")}
    placed_n = 0

    def site(drawn, tested):
        for k, m in (("draws", drawn), ("tests", tested)):
            m = m.reshape(-1)
            work[k] += m.to(torch.int32)
            work["warp_" + k] += m.reshape(-1, 32).any(1).to(torch.int32)

    ct = fp._table(fd.CAVE_FEATURE_GEN_TABLE, dev)
    broken = torch.zeros_like(ground, dtype=torch.bool)
    surface_is_cave = torch.zeros_like(broken)
    for li in range(fp.MAX_LAYERS):
        start, end = starts[..., li], ends[..., li]
        stop_here = (start == 384) | (ground <= start)
        active = ~broken & ~stop_here
        for top in (False, True):
            layer_ok = active & (end != 384) if top else active
            biome = (top_biome if top else bottom)[..., li].long()
            lava_y = end if top else start + 1
            placed = torch.zeros_like(broken)
            for g in range(fd.CAVE_FEATURE_GEN_TABLE["max_gens"]):
                in_loop = layer_ok & ~placed & (g < ct["count"][biome])
                r, state = fp._masked_u01(state, in_loop)
                feat = ct["feature"][:, g][biome]
                cheap = (in_loop & (r < ct["chance"][:, g][biome]) & (ct["from_ceiling"][:, g][biome] == top)
                         & (ct["in_lava"][:, g][biome] | (lava_y > bio.LAVA_LEVEL))
                         & (end - start >= ct["min_height"][:, g][biome]))
                seed = feat * (fp.SEED_CAVE_TOP_F if top else fp.SEED_CAVE_BOTTOM_F) + li * (
                    fp.SEED_CAVE_TOP_L if top else fp.SEED_CAVE_BOTTOM_L)
                ok = cheap & fp.is_feature_pos(wx, wz, ct["cell"][:, g][biome], ct["padding"][:, g][biome], seed)
                site(in_loop, cheap)
                placed = placed | ok
            placed_n += int(placed.sum())
        surface_here = active & (ground > start) & (ground <= end)
        surface_is_cave = surface_is_cave | surface_here
        broken = broken | stop_here | surface_here
    st = fp._table(fd.FEATURE_GEN_TABLE, dev)
    do_surface = ~surface_is_cave
    site(do_surface, torch.zeros_like(do_surface))
    r_biome, state = fp._masked_u01(state, do_surface)
    biome = random_biome(w.permute(0, 2, 3, 1), r_biome).long()
    layer_starts = ls.permute(0, 2, 3, 1)
    placed = torch.zeros_like(broken)
    for g in range(fd.FEATURE_GEN_TABLE["max_gens"]):
        in_loop = do_surface & ~placed & (g < st["count"][biome])
        r, state = fp._masked_u01(state, in_loop)
        ntl = st["n_top_layers"][:, g][biome]
        can_place = ntl == 0
        for t in range(st["top_layer_mat"].shape[-1]):
            mat = st["top_layer_mat"][:, g, t][biome].long()
            l_start = torch.gather(layer_starts, -1, mat[..., None])[..., 0]
            l_end = torch.gather(layer_starts, -1, (mat + 1).clamp(max=layer_starts.shape[-1] - 1)[..., None])[..., 0]
            can_place = can_place | ((t < ntl) & (l_start <= hf) & (l_end >= hf)
                                     & (torch.minimum(l_end, hf) - l_start >= st["top_layer_min"][:, g, t][biome]))
        cheap = in_loop & (r < st["chance"][:, g][biome]) & can_place
        feat = st["feature"][:, g][biome]
        ok = cheap & fp.is_feature_pos(wx, wz, st["cell"][:, g][biome], st["padding"][:, g][biome],
                                       feat * fp.SEED_SURFACE_POS)
        site(in_loop, cheap)
        placed = placed | ok
    return {**work, "placed": placed_n + int(placed.sum())}


def print_k5_work(n, args5, grids):
    """``k5_work`` at an n x n area, checked against K5's grids, summed up in one line."""
    wk = k5_work(args5)
    check(wk["placed"] == int((grids["cave_feature"] > 0).sum()) + int((grids["surface_feature"] > 0).sum()),
          f"K5's replayed walk at {n}x{n} places {wk['placed']} features, the grids hold another count")
    d, t, wd, wt = (wk[k].double() for k in ("draws", "tests", "warp_draws", "warp_tests"))
    lane_mean = t.reshape(-1, 32).mean(1)
    # a warp's tests alone, two sin-hashes each, every add and multiply on its own (-fmad=false)
    test_ms = float(wt.sum()) * 32 * 2 * SINHASH / (F32_OPS_PER_S / 2) * 1e3
    print(f"    K5's walk at {n}x{n} ({wk['placed']} placed): a column {float(d.mean()):.2f} draws (max "
          f"{int(d.max())}), {float(t.mean()):.2f} position tests (max {int(t.max())}); a warp draws at "
          f"{float(wd.mean()):.1f} sites and tests at {float(wt.mean()):.1f} (max {int(wt.max())}), "
          f"{float(wt.sum() / lane_mean.sum()):.1f}x its lanes' mean: {float(t.sum() / (32 * wt.sum())):.1%} of "
          f"the test lanes busy; those tests alone at the card's f32 rate without FMA {test_ms:.4f} ms")


def valid_rows(lists, K):
    """[B, K] bool: the valid entries of a list (slot < min(count, K)), the rows K7a writes."""
    n = torch.clamp(lists["count"], max=K)
    return torch.arange(K, device=n.device)[None, :] < n[:, None]


def check_streams(tag, got, want, lists):
    """K7a's rows written into NaN-filled outputs (``got``) against ``draw_streams_plain``'s
    (``want``): the valid rows bit for bit, every other row still NaN.  Returns the max |diff|."""
    mx = 0.0
    for kind in ("surface", "cave"):
        g, w = got[kind == "cave"], want[kind == "cave"]
        valid = valid_rows(lists[kind], g.shape[1])
        same = torch.equal(g[valid].view(torch.int32), w[valid].view(torch.int32))
        d = float((g[valid] - w[valid]).abs().max()) if bool(valid.any()) else 0.0
        untouched = bool(torch.isnan(g[~valid]).all())
        print(f"  {tag} streams {kind}: {int(valid.sum())} valid rows of {valid.numel()}, max |diff| {d:g}, "
              f"the other rows {'untouched' if untouched else 'WRITTEN'}")
        check(same, f"{tag} streams {kind}: valid rows differ from the plain version by {d}")
        check(untouched, f"{tag} streams {kind}: a row past the valid ones was written")
        mx = max(mx, d)
    return mx


def nan_streams(lists):
    """K7a into NaN-filled [B, K, 64] outputs."""
    from mega_minecraft_tpu_torch import kernels

    n = lists["surface"]["x"].shape[0]
    out = tuple(torch.full((n, K, kernels.STREAM_LEN), float("nan"), device=lists["surface"]["x"].device)
                for K in (kernels.SURFACE_CAP, kernels.CAVE_CAP))
    return kernels.feature_streams(lists["surface"], lists["cave"], out=out)


def distinct_cells(cells, active):
    """[B, N, 3] i64 Worley cells, [B, N] bool -> [B] i64: the distinct cells that the 27-cell
    searches (each a cell and its +-1 ring) of each chunk's active entries read."""
    act = active[..., None]
    lo = torch.where(act, cells, cells.amax(dim=1, keepdim=True)).amin(dim=1, keepdim=True)
    hi = torch.where(act, cells, lo).amax(dim=1, keepdim=True)
    rel = torch.where(act, cells - lo + 1, 0)
    ex, ey, ez = (int(e) for e in (hi - lo + 3).amax(dim=(0, 1)))
    occ = torch.zeros((cells.shape[0], ex * ey * ez), dtype=torch.float32, device=cells.device)
    occ.scatter_reduce_(1, (rel[..., 0] * ey + rel[..., 1]) * ez + rel[..., 2], active.float(), "amax")
    ring = torch.nn.functional.max_pool3d(occ.view(-1, 1, ex, ey, ez), 3, stride=1, padding=1)
    return ring.flatten(1).sum(dim=1).to(torch.int64)


def carve_work(biome_weights, chunk_pos, step=256):
    """(active blocks, distinct Worley cells, the same cells had every block been active) of
    the chunks' carve tests, by the plain noise of ``terrain/caves.py``: the blocks whose
    threshold exceeds 0.04, which alone need the domain warp and the Worley search, and the
    cells those searches read, summed over the chunks (each chunk's once)."""
    from mega_minecraft_tpu_torch.terrain import caves

    n_active = n_cells = n_cells_all = 0
    for i in range(0, chunk_pos.shape[0], step):
        w, pos = biome_weights[i : i + step], chunk_pos[i : i + step]
        coords = caves.band_coords(pos)
        thr = caves.carve_threshold(*coords, caves.ocean_beach_weight(w)[..., None])
        active = (thr > 0.04).reshape(pos.shape[0], -1)
        cells = torch.stack([torch.floor(c) for c in caves.carve_warp(*coords)], dim=-1)
        cells = cells.to(torch.int64).reshape(pos.shape[0], -1, 3)
        n_active += int(active.sum())
        n_cells += int(distinct_cells(cells, active).sum())
        n_cells_all += int(distinct_cells(cells, torch.ones_like(active)).sum())
    return n_active, n_cells, n_cells_all


def lush_work(base_blocks, chunk_pos, step=256):
    """(lush blocks, distinct Worley cells) of the chunks' lush caves' clay tests, by the plain
    noise of ``terrain/fill.py``: the blocks below y = 192 that the clay test made clay or moss,
    and the cells their 27-cell F1 searches read, summed over the chunks (each chunk's once)."""
    from mega_minecraft_tpu_torch.terrain import fill
    from mega_minecraft_tpu_torch.terrain.heightfield import column_world_coords
    from mega_minecraft_tpu_torch.world.blocks import Block

    n_lush = n_cells = 0
    wyf = torch.arange(192, dtype=torch.float32, device=chunk_pos.device)
    for i in range(0, chunk_pos.shape[0], step):
        low = base_blocks[i : i + step, ..., :192]
        lush = ((low == int(Block.CLAY)) | (low == int(Block.MOSS))).reshape(low.shape[0], -1)
        wx, wz = column_world_coords(chunk_pos[i : i + step])
        pts = fill.lush_clay_point(wx.to(torch.float32)[..., None], wyf, wz.to(torch.float32)[..., None])
        cells = torch.stack([torch.floor(c) for c in pts], dim=-1)
        n_lush += int(lush.sum())
        n_cells += int(distinct_cells(cells.to(torch.int64).reshape(low.shape[0], -1, 3), lush).sum())
    return n_lush, n_cells


def check_k3(tag, hf, w, pos, step=256):
    """K3 on its cell table (``terrain/caves.py`` ``CELL_TABLE_CAP`` cells) and with every tile
    on the direct path (capacity 0), each bit for bit against the plain version on the same
    inputs (run ``step`` chunks at a time): the four cave arrays and the carve band.  Prints
    the tiles (CTAs) that took the direct path and the largest cell box of each run; returns
    the max |diff|."""
    from mega_minecraft_tpu_torch import kernels
    from mega_minecraft_tpu_torch.terrain import caves

    B = pos.shape[0]
    parts = [(hf[i : i + step], w[i : i + step], pos[i : i + step]) for i in range(0, B, step)]
    want = [caves.generate_caves_plain(*a) for a in parts]
    want = {k: torch.cat([d[k] for d in want]) for k in want[0]}
    band = torch.cat([caves.carve_band_plain(a[1], a[2]) for a in parts])
    mx = 0.0
    for cap in (caves.CELL_TABLE_CAP, 0):
        stats = torch.zeros(2, dtype=torch.int32, device=pos.device)
        got = kernels.caves(hf, w, pos, cap, stats, want_carved=True)
        direct, largest = stats.tolist()
        print(f"  K3 {tag}, a table of {cap} cells: {direct} of {B * 144} tiles took the direct path; "
              f"largest cell box {largest} cells; {int(band.sum())} blocks carved")
        mx = max(mx, check_equal(f"K3 {tag} carve band (table {cap})", got.pop("carved"), band))
        for k in want:
            mx = max(mx, check_equal(f"K3 {tag} {k} (table {cap})", got[k], want[k]))
        check(cap > 0 or direct > 0, f"K3 {tag}: no tile took the direct path with no table")
        check(cap == 0 or direct == 0, f"K3 {tag}: {direct} tiles took the direct path with the table")
    return mx


def fill_k(*args, **kw):
    """K4 (``kernels.fill``) on its lush-cave cell table (``tables.LUSH_TABLE_CELLS`` cells)."""
    from mega_minecraft_tpu_torch import kernels
    from mega_minecraft_tpu_torch.tables import LUSH_TABLE_CELLS

    return kernels.fill(*args, LUSH_TABLE_CELLS, **kw)


def check_k4(tag, hf, w, ls, starts, ends, pos, step=256):
    """K4 on its lush-cave cell table and with every tile on the direct path (capacity 0),
    each bit for bit against the plain version on the same inputs (run ``step`` chunks at a
    time).  Prints both runs' stats (blocks queued for the cave biome, lush blocks, largest
    cell box, tiles on the direct path); fails if a tile took the direct path with the table.
    Returns the max |diff|."""
    from mega_minecraft_tpu_torch import kernels
    from mega_minecraft_tpu_torch.tables import FILL_TILE_COLS, LUSH_TABLE_CELLS
    from mega_minecraft_tpu_torch.terrain import fill

    B = pos.shape[0]
    want = torch.cat([fill.fill_chunks_plain(hf[i : i + step], w[i : i + step], ls[i : i + step],
                                             starts[i : i + step], ends[i : i + step], pos[i : i + step])
                      for i in range(0, B, step)])
    mx = 0.0
    for cap in (LUSH_TABLE_CELLS, 0):
        stats = torch.zeros(4, dtype=torch.int32, device=pos.device)
        got = kernels.fill(hf, w, ls, starts, ends, pos, cap, stats)
        queued, lush, largest, direct = stats.tolist()
        print(f"  K4 {tag}, a table of {cap} cells: {queued} of {B * 98304} blocks queued for the cave "
              f"biome ({queued / (B * 98304):.4f}), {lush} lush ({lush / (B * 98304):.5f}); largest cell box "
              f"{largest} cells; {direct} of {B * 256 // FILL_TILE_COLS} tiles took the direct path")
        mx = max(mx, check_equal(f"K4 {tag} (table {cap})", got, want))
        check(cap == 0 or direct == 0, f"K4 {tag}: {direct} tiles took the direct path with the table")
        check(cap > 0 or (direct > 0) == (lush > 0), f"K4 {tag}: {direct} direct tiles with no table, {lush} lush")
    return mx


def check_k7_lists(tag, got_lists, want_of, n_chunks):
    """The pre-pass's culled lists (``kernels.features(..., want_lists=True)`` / ``features_slots``)
    against their plain version, bit for bit (lengths, and each chunk's entries up to its
    length); ``want_of(kind, cull)`` gives the plain (lists, lengths).  Prints the candidate
    counts: the visible gathered entries and the survivors, per chunk.  Returns max |diff|."""
    mx = 0.0
    for kind in ("surface", "cave"):
        k_lists, k_len = got_lists[kind]
        p_lists, p_len = want_of(kind, True)
        mx = max(mx, check_equal(f"{tag} K7 pre-pass {kind} lengths", k_len.cpu(), p_len))
        keep = torch.arange(p_lists.shape[1])[None, :] < p_len[:, None]
        mx = max(mx, check_equal(f"{tag} K7 pre-pass {kind} entries", k_lists.cpu()[keep][:, :7],
                                 p_lists[keep][:, :7]))
        visible = want_of(kind, False)[1]
        print(f"  {tag} K7 {kind} candidates: {int(visible.sum())} visible gathered entries "
              f"({float(visible.double().mean()):.1f} a chunk, max {int(visible.max())}), "
              f"{int(p_len.sum())} survive the cull ({float(p_len.double().mean()):.1f} a chunk, max "
              f"{int(p_len.max())}) over {n_chunks} chunks")
    return mx


def op_counts(n, pos_halo, w_halo, out, lists, names):
    """(bytes, f32 operations) each kernel needs for the n x n area of this run."""
    from mega_minecraft_tpu_torch.kernels import CAVE_FIELDS, STREAM_LEN, SURFACE_FIELDS
    from mega_minecraft_tpu_torch.terrain import features
    from mega_minecraft_tpu_torch.world import biomes as bio
    from mega_minecraft_tpu_torch.world.blocks import Block

    B, H = n * n, (n + 2) * (n + 2)
    cols = B * 256
    cv = out["caves"]
    res = {}
    # K1: biome noise (11 simplex2), 24 weights, then one height formula per biome with weight
    per_biome = (w_halo > 0).sum(dim=(0, 2, 3)).tolist()
    k1 = H * 256 * (11 * SIMPLEX2 + 150 + 24 * 6)
    for b in bio.Biome:
        s2, w2 = HEIGHT_FORMULA.get(b.name, (5, 0))
        k1 += per_biome[int(b)] * (s2 * (SIMPLEX2 + 5) + w2 * WORLEY2 + 3)
    res["heightfield"] = (nbytes(pos_halo) + H * 256 * 4 * 25, k1)
    # K2: 24 -> 20 contraction, 11 five-octave fBm, 8 slope-limited layers
    in2 = H * 256 * 4 * 25 + nbytes(pos_halo)
    out2 = nbytes(out["layers"], out["heightfield"], out["biome_weights"], out["chunk_pos"])
    res["layers"] = (in2 + out2, cols * (960 + 11 * fbm2_ops(5) + 400))
    # K3: per block below y = 144 the carve test's threshold; where it exceeds 0.04 (this
    # run's active blocks) the domain warp and the Worley search, whose 27 cells' jitters
    # (three sin-hashes each) depend on the integer cell alone: the function needs each
    # distinct cell's once a chunk, so the count takes the 81 hashes out of the search and
    # adds three for each distinct cell that a chunk's active blocks read; the ravine per
    # column; the cave biome at the valid layer edges of this run
    threshold = 2 * fbm3_ops(4) + 40
    warp_search = 3 * fbm3_ops(5) + WORLEY3 - 81 * SINHASH + 27 * 10
    carve_before = threshold + warp_search + 81 * SINHASH
    ravine = 16 * (SIMPLEX2 + 5) + WORLEY2 + 500
    edges = int((cv["starts"] != 384).sum()) + int((cv["ends"] != 384).sum())
    n_active, n_cells, n_cells_all = carve_work(out["biome_weights"], out["chunk_pos"])
    rest = cols * ravine + edges * CAVE_BIOME
    res["caves"] = (nbytes(out["heightfield"], out["biome_weights"], out["chunk_pos"], cv),
                    cols * 144 * threshold + n_active * warp_search + n_cells * 3 * SINHASH + rest)
    before = bound(res["caves"][0], cols * 144 * carve_before + rest)
    uniform = bound(res["caves"][0], cols * 144 * (threshold + warp_search) + n_cells_all * 3 * SINHASH + rest)
    print(f"    K3's bound: {n_active} of {cols * 144} blocks active ({n_active / (cols * 144):.4f}), "
          f"{n_cells} distinct Worley cells over {B} chunks ({n_cells / B:.1f} a chunk); a block "
          f"{threshold} operations, an active one {warp_search} more: {bound(*res['caves'])[0]:.4g} ms; "
          f"every block active ({n_cells_all} cells) {uniform[0]:.4g} ms; every block hashing its 81 sins "
          f"{before[0]:.4g} ms by {before[1]}")
    # K4: per block the biome pick, the cave scan and the cascade; the cave-biome noise only
    # for this run's solid stone-like blocks below y = 192 (counted from the featureless
    # blocks: the stone family and what the cave biomes turn it into); 7 fields per column
    fam = [Block.STONE, Block.DEEPSLATE, Block.BLACKSTONE, Block.COBBLESTONE,
           Block.COBBLED_DEEPSLATE, Block.QUARTZ, Block.CLAY, Block.MOSS, Block.WARPED_DEEPSLATE,
           Block.WARPED_BLACKSTONE, Block.AMBER_DEEPSLATE, Block.AMBER_BLACKSTONE]
    low = out["base_blocks"][..., :192]
    stone_like = int(torch.isin(low, torch.tensor([int(b) for b in fam], dtype=low.dtype,
                                            device=low.device)).sum())
    # the lush blocks' clay test: the warp and the Worley F1, whose 27 cells' jitters depend on the
    # integer cell alone: three hashes for each distinct cell that a chunk's lush blocks read, not
    # 81 a block (as K3's bound counts its carve search)
    lush, lush_cells = lush_work(out["base_blocks"], out["chunk_pos"])
    clay = SIMPLEX3 + 3 * fbm3_ops(3) + WORLEY3 - 81 * SINHASH
    k4 = B * 98304 * 490 + cols * 7 * fbm2_ops(3) + stone_like * CAVE_BIOME + lush * clay \
        + lush_cells * 3 * SINHASH
    res["fill"] = (nbytes(out["heightfield"], out["biome_weights"], out["layers"], cv["starts"],
                          cv["ends"], out["chunk_pos"], out["base_blocks"]), k4)
    k4_before = bound(res["fill"][0], k4 - lush_cells * 3 * SINHASH + lush * 81 * SINHASH)
    print(f"    K4's bound: {stone_like} stone-like blocks below y = 192 ({stone_like / (B * 98304):.4f}), {lush} "
          f"lush ({lush / (B * 98304):.5f}) reading {lush_cells} distinct Worley cells "
          f"({lush_cells / B:.1f} a chunk): {bound(*res['fill'])[0]:.4g} ms; every lush block hashing its 81 "
          f"sins {k4_before[0]:.4g} ms by {k4_before[1]}")
    # K5: the layer walk and biome pick per column, two sin-hashes per placed feature
    placed = int(lists["surface"]["count"].sum()) + int(lists["cave"]["count"].sum())
    grids = nbytes(out["placement_grids"])  # K5's outputs, K6's inputs
    res["placements"] = (nbytes(out["heightfield"], out["biome_weights"], out["layers"], cv,
                                out["chunk_pos"]) + grids, cols * 840 + placed * 2 * SINHASH)
    res["compact_placements"] = (grids + nbytes(lists, out["chunk_pos"]), cols * 65 * 4)
    # the stream pre-kernel and K7 need only the valid list entries (the first
    # min(count, list width) of each chunk), whatever the kernels' design touches
    valid = {kind: torch.minimum(lists[kind]["count"], torch.tensor(
        lists[kind]["feature"].shape[1], device=lists[kind]["count"].device)) for kind in lists}
    n_valid = {kind: int(v.sum()) for kind, v in valid.items()}
    n_entries = n_valid["surface"] + n_valid["cave"]
    counts_b = nbytes(lists["surface"]["count"], lists["cave"]["count"])
    stream_b = n_entries * STREAM_LEN * 4
    # streams: x, y, z read and 64 f32 draws written per valid entry; ~4 operations a draw
    res["feature_streams"] = (n_entries * 3 * 4 + counts_b + stream_b, n_entries * STREAM_LEN * 4)
    # K7: the blocks read and written once, the valid entries' fields and streams read once;
    # one SDF evaluation (per-type cost table) for every voxel that lies in a valid
    # placement's XZ window and height bounds and whose terrain block passes the placement's
    # test (AIR, or any block where it replaces).  Evaluations behind an earlier placement's
    # hit are still counted (overlaps are rare).  The kernel's walk over its gathered lists is
    # its own design's cost: printed below, not part of the bound.
    area = (out["base_blocks"].reshape(n, n, 16, 16, 384).permute(0, 2, 1, 3, 4)
            .reshape(n * 16, n * 16, 384))
    air_below = torch.zeros((n * 16, n * 16, 385), dtype=torch.int16, device=area.device)
    air_below[..., 1:] = torch.cumsum((area == int(Block.AIR)).to(torch.int16), -1, dtype=torch.int16)
    air_below = air_below.cpu().numpy()  # [z, x, y]: AIR blocks of the column below y
    vis = 0
    tot = (valid["surface"] + valid["cave"]).reshape(n, n).cpu()
    for vz in range(n):
        for vx in range(n):
            vis += int(tot[max(vz - 3, 0) : vz + 4, max(vx - 3, 0) : vx + 4].sum())
    sdf_ops = walk_ops = sdf_voxels = 0
    ox, oz = (int(v) for v in out["chunk_pos"][0])
    for kind, table, cave in (("surface", SDF_OPS_SURFACE, False), ("cave", SDF_OPS_CAVE, True)):
        L = {k: v.cpu().numpy() for k, v in lists[kind].items()}
        half = features.window_half_widths(cave)
        bounds_t = (features.fd.CAVE_FEATURE_HEIGHT_BOUNDS if cave else features.fd.FEATURE_HEIGHT_BOUNDS)
        for b, k in zip(*(L["feature"] > 0).nonzero()):
            f = int(L["feature"][b, k])
            px, py, pz = (int(L[c][b, k]) for c in "xyz")
            h = int(L["height"][b, k]) if cave else 0
            x0, x1 = max(px - ox - int(half[f, 0]), 0), min(px - ox + int(half[f, 1]), n * 16 - 1)
            z0, z1 = max(pz - oz - int(half[f, 0]), 0), min(pz - oz + int(half[f, 1]), n * 16 - 1)
            y0, y1 = max(py + int(bounds_t[f, 0]), 0), min(py + h + int(bounds_t[f, 1]), 383)
            if x0 > x1 or z0 > z1 or y0 > y1:
                continue
            walk_ops += (x1 - x0 + 1) * (z1 - z0 + 1) * 384 * LIST_WALK_OPS
            if int(L["replace"][b, k]):
                voxels = (x1 - x0 + 1) * (z1 - z0 + 1) * (y1 - y0 + 1)
            else:
                win = air_below[z0 : z1 + 1, x0 : x1 + 1]
                voxels = int((win[..., y1 + 1].astype(np.int64) - win[..., y0]).sum())
            sdf_voxels += voxels
            sdf_ops += voxels * table[f]
    walk_ops += vis * 256 * WINDOW_TEST_OPS
    print(f"    K7 at {n}x{n}: {n_entries} valid list entries, {sdf_voxels} SDF evaluations needed "
          f"= {sdf_ops:.4g} operations (the bound's); the kernel's own list walk, not in the "
          f"bound: {walk_ops:.4g} operations")
    fields_b = n_valid["surface"] * len(SURFACE_FIELDS) * 4 + n_valid["cave"] * len(CAVE_FIELDS) * 4
    res["features"] = (2 * B * 98304 + fields_b + counts_b + stream_b + nbytes(out["chunk_pos"]),
                       sdf_ops)
    res["decorators"] = (2 * B * 98304 + nbytes(out["heightfield"], out["biome_weights"],
                                                cv["starts"], cv["ends"], cv["bottom_biome"],
                                                out["chunk_pos"]), cols * 400)
    return {k: res[k] for k in names}


class DispatchLog:
    """Wraps the scheduler module's stage dispatchers: each call is logged with its
    arguments (numpy slot tables) and then runs as before."""

    def __init__(self, sched_mod, hooks=None):
        self.mod, self.calls, self.saved = sched_mod, [], {}
        for name in DISPATCH_KERNELS:
            orig = getattr(sched_mod, name)
            self.saved[name] = orig
            hook = (hooks or {}).get(name)

            def fn(t, *args, _name=name, _orig=orig, _hook=hook, **kw):
                self.calls.append((_name, args, kw))
                if _hook is not None:
                    _hook(t, *args, **kw)
                return _orig(t, *args, **kw)

            setattr(sched_mod, name, fn)

    def restore(self):
        for name, fn in self.saved.items():
            setattr(self.mod, name, fn)

    def count(self, name):
        return sum(1 for c in self.calls if c[0] == name)

    def first(self, name):
        return next(c for c in self.calls if c[0] == name)


def first_and_largest(log, name):
    """(("first", call), ("largest", call)) of the logged dispatches of one stage."""
    calls = [c for c in log.calls if c[0] == name]
    return (("first", calls[0]), ("largest", max(calls, key=lambda c: len(c[1][0]))))


def stream_phase(dev, stamp, err, smi):
    """The radius-8 drain without erosion: filled chunks vs the area path; K5 on the first and
    largest placement batch; K7a rerun into NaN-filled slot tables against the drain's rows and
    the plain streams; K2s and K7s (on those tables) vs their plain versions on their stage's
    first and largest batch; K7s's window cull vs none on every filled chunk."""
    from mega_minecraft_tpu_torch import kernels
    from mega_minecraft_tpu_torch.terrain import feature_placement as fp, features, layers, pipeline
    from mega_minecraft_tpu_torch.terrain import scheduler as sched

    stamp("phase 8: make_scheduler(1024, radius=8, skip_erosion=True, native=True).drain()")
    log = DispatchLog(sched)
    try:
        s = sched.make_scheduler(1024, 8, skip_erosion=True, native=True, device=dev)
        check(isinstance(s, sched.NativeTerrainScheduler), "native=True did not give the native core")
        s.set_player_pos(0.0, 0.0)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        frames = s.drain()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = kernels.launch_counts()
    finally:
        log.restore()
    t = s.t
    n_disp = {name: log.count(name) for name in DISPATCH_KERNELS}
    print(f"  {frames} frames in {secs:.3f} s, {s.drawable_count()} drawable; dispatches {n_disp}; "
          f"launches {launches}")
    check_stream_launches("radius-8 drain", log, launches, erosion_on=False)

    # every filled chunk (|d| <= 4) vs the featured area path over all its sources (|d| <= 7)
    area = pipeline.generate_area_fused(pipeline.chunk_positions(-8, -8, 17, 17, device=dev), 15, 15,
                                        features=True)
    cells = [(dx, dz) for dz in range(-4, 5) for dx in range(-4, 5)]
    for p_ in cells:
        check(s.state_at(p_) >= int(sched.ChunkState.FILLED), f"chunk {p_} is not filled")
    slots = torch.tensor([s.slot_for(p_) for p_ in cells], device=dev)
    idx = torch.tensor([(dz + 7) * 15 + dx + 7 for dx, dz in cells], device=dev)
    pairs = [("heightfield", t.d_heightfield, area["heightfield"]),
             ("biome_weights", t.d_weights, area["biome_weights"]),
             ("layers", t.d_layers, area["layers"]),
             ("cave starts", t.d_cave_starts, area["caves"]["starts"].to(torch.int16)),
             ("cave ends", t.d_cave_ends, area["caves"]["ends"].to(torch.int16)),
             ("cave bottom", t.d_cave_bottom, area["caves"]["bottom_biome"].to(torch.uint8)),
             ("cave top", t.d_cave_top, area["caves"]["top_biome"].to(torch.uint8)),
             ("blocks", t.d_blocks, area["blocks"])]
    pairs += [(f"surface {k}", v, area["placements"]["surface"][k]) for k, v in t.d_sf.items()]
    pairs += [(f"cave {k}", v, area["placements"]["cave"][k]) for k, v in t.d_cf.items()]
    print(f"  the {len(cells)} filled chunks vs the same chunks of the featured 15x15 area:")
    for name, got, want in pairs:
        check_equal(f"drain {name}", got[slots], want[idx])

    # K5 on the first and the largest placement batch, its inputs read from the slot table as
    # the dispatch reads them (int16 / uint8 rows to int32)
    for tag, (_, (sl_np, pos_np), _) in first_and_largest(log, "dispatch_feature_placements"):
        sl, pos = t.upload(sl_np, pos_np)
        rows = sl.long()
        args5 = (t.d_heightfield[rows], t.d_weights[rows], t.d_layers[rows],
                 *sched._cave_rows(t, rows, ("starts", "ends", "bottom", "top")), pos)
        err["placements"] = max(err["placements"], check_k5(
            f"the drain's {tag} placement batch ({len(sl_np)} chunks)", args5, fp.generate_placements_plain(*args5)))
    # K7a again over every placement batch, into NaN-filled slot tables through its batch's rows:
    # the valid rows equal the drain's own (written in place) and the plain streams, the others
    # stay NaN; K7s below runs on these tables
    nan_s, nan_c = torch.full_like(t.d_sstream, float("nan")), torch.full_like(t.d_cstream, float("nan"))
    for _, (sl_np, pos_np), _ in (c for c in log.calls if c[0] == "dispatch_feature_placements"):
        sl, _ = t.upload(sl_np, pos_np)
        rows = sl.long()
        kernels.feature_streams({k: v[rows] for k, v in t.d_sf.items()}, {k: v[rows] for k, v in t.d_cf.items()},
                                out=(nan_s, nan_c), rows=sl)
    lists_t = {"surface": t.d_sf, "cave": t.d_cf}
    err["feature_streams"] = max(err["feature_streams"], check_streams(
        "the drain's slot table", (nan_s, nan_c), features.draw_streams_plain(t.d_sf, t.d_cf), lists_t))
    for kind, table, mine in (("surface", t.d_sstream, nan_s), ("cave", t.d_cstream, nan_c)):
        valid = valid_rows(lists_t[kind], table.shape[1])
        check(torch.equal(table[valid].view(torch.int32), mine[valid].view(torch.int32)),
              f"the drain's {kind} stream rows differ from K7a's rerun")
    print("  the drain's stream rows (written in place by dispatch_feature_placements) equal the rerun's")

    # K2s and K7s vs their plain versions on the first batch of their stage and on the
    # largest one (timed on the reference workload's largest batches, phase 9)
    err["layers_slots"] = 0.0
    for tag, (_, (sl_np, pos_np, nsl_np), kw) in first_and_largest(log, "dispatch_layers"):
        sl, pos, nsl = t.upload(sl_np, pos_np, nsl_np)
        fix = kw["fix_backward"]
        k_out = kernels.layers_slots(t.d_layers.clone(), t.d_heightfield, t.d_weights, nsl, sl, pos, fix)
        p_out = layers.layers_slots_plain(t.d_layers.clone(), t.d_heightfield, t.d_weights, nsl, sl,
                                          pos, fix)
        rows = sl.long()
        err["layers_slots"] = max(err["layers_slots"], check_close(
            f"K2s on the {tag} layers batch ({len(sl_np)} chunks)", k_out[rows], p_out[rows]))
        check(torch.equal(k_out[rows], t.d_layers[rows]), "K2s: the slot table differs from a rerun")

    # K7s vs its plain version (the JAX semantics, no window), on the NaN-filled stream tables
    stamp("phase 8b: K7s vs the plain per-chunk application on the first and the largest fill batch")
    err["features_slots"] = 0.0
    for tag, (_, (sl_np, pos_np, nb_np), _) in first_and_largest(log, "dispatch_fill"):
        sl, pos, nsl = t.upload(sl_np, pos_np, nb_np)
        rows = sl.long()
        hf, w, ls = t.d_heightfield[rows], t.d_weights[rows], t.d_layers[rows]
        cs, ce, cb = (getattr(t, f"d_cave_{n}")[rows].to(torch.int32) for n in ("starts", "ends", "bottom"))
        base = fill_k(hf, w, ls, cs, ce, pos)
        got = kernels.features_slots(base, t.d_sf, t.d_cf, nan_s, nan_c, nsl, pos)
        want = features.apply_features_slots_plain(base, t.d_sf, t.d_cf, nsl, pos)
        n_feat = int((want != base).sum())
        err["features_slots"] = max(err["features_slots"], check_equal(
            f"K7s on the {tag} fill batch ({len(sl_np)} chunks, {n_feat} feature blocks)", got, want))
        check(n_feat > 0, f"the {tag} fill batch holds no feature block")
        check(torch.equal(kernels.decorators(got, hf, w, cs, ce, cb, pos), t.d_blocks[rows]),
              f"K7s + K8 on the {tag} fill batch differ from the drain's blocks")

    # the window cull against none, on every chunk the drain filled; with K8, the drain's blocks
    n_chunks = n_diff = n_drain = 0
    cull_ms = nocull_ms = 0.0
    for _, (sl_np, pos_np, nb_np), _ in (c for c in log.calls if c[0] == "dispatch_fill"):
        sl, pos, nsl = t.upload(sl_np, pos_np, nb_np)
        rows = sl.long()
        cs, ce, cb = (getattr(t, f"d_cave_{n}")[rows].to(torch.int32) for n in ("starts", "ends", "bottom"))
        hf, w = t.d_heightfield[rows], t.d_weights[rows]
        base = fill_k(hf, w, t.d_layers[rows], cs, ce, pos)
        a = kernels.features_slots(base, t.d_sf, t.d_cf, nan_s, nan_c, nsl, pos)
        b = kernels.features_slots(base, t.d_sf, t.d_cf, nan_s, nan_c, nsl, pos, cull=False)
        n_chunks += len(sl_np)
        n_diff += int((a != b).sum())
        n_drain += int((kernels.decorators(a, hf, w, cs, ce, cb, pos) != t.d_blocks[rows]).sum())
        cull_ms += cuda_ms(lambda: kernels.features_slots(base, t.d_sf, t.d_cf, t.d_sstream,
                                                          t.d_cstream, nsl, pos), 2)
        nocull_ms += cuda_ms(lambda: kernels.features_slots(base, t.d_sf, t.d_cf, t.d_sstream,
                                                            t.d_cstream, nsl, pos, cull=False), 1)
    print(f"  K7s with its window cull vs without, every filled chunk ({n_chunks}): {n_diff} voxels "
          f"differ; {cull_ms:.3f} ms with the cull, {nocull_ms:.3f} ms without, summed over the "
          f"fill batches")
    check(n_diff == 0, "K7s's window cull changes the blocks")
    print(f"  K7s on the NaN-filled stream tables + K8 vs the drain's blocks, every filled chunk: {n_drain} "
          f"voxels differ")
    check(n_drain == 0, "K7s on K7a's valid rows alone differs from the drain")
    del s, t, area, nan_s, nan_c


def time_stream_kernels(dev, t, log, err, times, bounds, smi):
    """K2s and K7s at the largest batch of their stage in a drain, each against its plain
    version on the same inputs, timed, with its bound."""
    from mega_minecraft_tpu_torch import kernels
    from mega_minecraft_tpu_torch.terrain import features, layers

    _, (_, (sl_np, pos_np, nsl_np), kw) = first_and_largest(log, "dispatch_layers")[1]
    sl, pos, nsl = t.upload(sl_np, pos_np, nsl_np)
    fix, B, rows = kw["fix_backward"], len(sl_np), sl.long()
    scratch = t.d_layers.clone()
    k_out = kernels.layers_slots(scratch, t.d_heightfield, t.d_weights, nsl, sl, pos, fix)[rows]
    p_out = layers.layers_slots_plain(scratch, t.d_heightfield, t.d_weights, nsl, sl, pos, fix)[rows]
    err["layers_slots"] = max(err["layers_slots"], check_close(
        f"K2s on the drain's largest layers batch ({B} chunks)", k_out, p_out))
    ms = cuda_ms(lambda: kernels.layers_slots(scratch, t.d_heightfield, t.d_weights, nsl, sl, pos, fix),
                 50)
    plain_ms = cuda_ms(lambda: layers.layers_slots_plain(scratch, t.d_heightfield, t.d_weights, nsl,
                                                         sl, pos, fix), 3)
    # the one indexing call that computes gather_heightfields_batch for the batch
    zz = torch.arange(18, device=dev)[:, None] + 15
    xx = torch.arange(18, device=dev)[None, :] + 15
    flat = (nsl.long().reshape(B, 9)[:, (zz // 16) * 3 + xx // 16] * 256 + (zz % 16) * 16 + xx % 16)
    hf_flat = t.d_heightfield.reshape(-1)
    check(torch.equal(hf_flat[flat], t.d_heightfield[nsl.long()].reshape(B, 3, 3, 16, 16)
                      .permute(0, 1, 3, 2, 4).reshape(B, 48, 48)[:, 15:33, 15:33]),
          "the indexing gather differs from gather_heightfields_batch")
    gather_ms = cuda_ms(lambda: hf_flat[flat], 50)
    times["layers_slots"] = (ms, plain_ms)
    times[("library", "layers_slots")] = gather_ms
    bounds["layers_slots"] = bound(B * (18 * 18 * 4 + 24 * 256 * 4 + 8 + 40) + B * 20 * 256 * 4,
                                   B * 256 * (960 + 11 * fbm2_ops(5) + 400))
    print(f"  K2s on {smi}: {ms:.4f} ms for {B} chunks, plain {plain_ms:.3f} ms, bound "
          f"{bounds['layers_slots'][0]:.4g} ms by {bounds['layers_slots'][1]}; the gather as one "
          f"indexing call (gather_heightfields_batch's library time): {gather_ms:.4f} ms")

    _, (_, (sl_np, pos_np), _) = first_and_largest(log, "dispatch_caves")[1]
    sl, pos = t.upload(sl_np, pos_np)
    rows = sl.long()
    err["caves"] = max(err["caves"], check_k3(f"on the drain's largest caves batch ({len(sl_np)} chunks)",
                                              t.d_heightfield[rows], t.d_weights[rows], pos))

    _, (_, (sl_np, pos_np, nb_np), _) = first_and_largest(log, "dispatch_fill")[1]
    sl, pos, nsl = t.upload(sl_np, pos_np, nb_np)
    rows = sl.long()
    hf, w, ls = t.d_heightfield[rows], t.d_weights[rows], t.d_layers[rows]
    cs, ce, cb = (getattr(t, f"d_cave_{n}")[rows].to(torch.int32) for n in ("starts", "ends", "bottom"))
    err["fill"] = max(err["fill"], check_k4(f"on the drain's largest fill batch ({len(sl_np)} chunks)",
                                            hf, w, ls, cs, ce, pos))
    base = fill_k(hf, w, ls, cs, ce, pos)
    got, got_lists = kernels.features_slots(base, t.d_sf, t.d_cf, t.d_sstream, t.d_cstream, nsl, pos,
                                            want_lists=True)
    err["features_slots"] = max(err["features_slots"], check_k7_lists(
        f"the drain's largest fill batch ({len(sl_np)} chunks)", got_lists,
        lambda kind, cull: features.cull_slots_plain(t.d_sf if kind == "surface" else t.d_cf, nsl, pos,
                                                     kind == "cave", cull), len(sl_np)))
    t1 = time.perf_counter()
    want = features.apply_features_slots_plain(base, t.d_sf, t.d_cf, nsl, pos)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t1
    n_feat = int((want != base).sum())
    err["features_slots"] = max(err["features_slots"], check_equal(
        f"K7s on the drain's largest fill batch ({len(sl_np)} chunks, {n_feat} feature blocks)", got,
        want))
    check(torch.equal(kernels.decorators(got, hf, w, cs, ce, cb, pos), t.d_blocks[rows]),
          "K7s + K8 on the drain's largest fill batch differ from the drain's blocks")
    ms = cuda_ms(lambda: kernels.features_slots(base, t.d_sf, t.d_cf, t.d_sstream, t.d_cstream, nsl,
                                                pos), 20)
    dev_ms = device_ms(lambda: kernels.features_slots(base, t.d_sf, t.d_cf, t.d_sstream, t.d_cstream, nsl, pos),
                       {"cull_kernel": 1, "features_kernel": 1}, 20)
    print(f"  K7s on the device: {fmt_ms(dev_ms)} (cull, columns: {dev_ms[0]})")
    times["features_slots"] = (ms, plain_s * 1e3)
    bounds["features_slots"] = bound(*k7s_counts(t, nsl, pos, base))
    print(f"  K7s on {smi}: {ms:.4f} ms for {len(sl_np)} chunks, plain {plain_s * 1e3:.1f} ms, bound "
          f"{bounds['features_slots'][0]:.4g} ms by {bounds['features_slots'][1]}")


def reference_phase(dev, stamp, err, times, bounds, smi):
    """The reference workload: the radius-40 spiral with erosion, drained twice (clean,
    then with the StageTimer); one recorded zone erosion replayed through the plain
    versions.  Returns the launch counts of the clean drain."""
    from mega_minecraft_tpu_torch import kernels
    from mega_minecraft_tpu_torch.terrain import erosion, scheduler as sched
    from mega_minecraft_tpu_torch.utils.profiling import StageTimer

    stamp("phase 9: the reference workload, make_scheduler(radius=None, skip_erosion=False, "
          "native=True).drain()")
    replay = {}

    def keep_first_zone(t, gslots_np):
        if not replay:
            rows = torch.as_tensor(gslots_np.reshape(-1), device=dev).long()
            replay.update(gslots=gslots_np, rows=rows, layers=t.d_layers[rows].clone(),
                          hf=t.d_heightfield[rows].clone())

    log = DispatchLog(sched, hooks={"dispatch_erosion": keep_first_zone})
    try:
        s = sched.make_scheduler(radius=None, skip_erosion=False, native=True, device=dev)
        s.set_player_pos(0.0, 0.0)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        frames = s.drain()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = kernels.launch_counts()
    finally:
        log.restore()
    state = s.core.snapshot()[0]
    filled = int((state >= int(sched.ChunkState.FILLED)).sum())
    zones = log.count("dispatch_erosion")
    print(f"  {frames} frames in {secs:.3f} s on {smi} ({frames / secs:.1f} frames/s): "
          f"{s.drawable_count()} drawable chunks, {filled} filled, {zones} zones eroded, "
          f"{len(log.calls)} dispatches; launches {launches}")
    check_stream_launches("radius-40 drain", log, launches, erosion_on=True)
    check(s.drawable_count() == 1089, f"{s.drawable_count()} drawable chunks, not 1,089")
    # the first zone's erosion replayed through the plain versions
    half = 6
    local = torch.arange(576, dtype=torch.int32, device=dev).reshape(24, 24)
    want = erosion.erode_zone_slots_plain(replay["layers"].clone(), replay["hf"], local)
    core = local[half:half + 12, half:half + 12].reshape(-1).long()
    got = s.t.d_layers[replay["rows"][core]]
    n_diff = int((got.view(torch.int32) != want[core].view(torch.int32)).sum())
    print(f"  the first zone eroded (grid corner slot {int(replay['gslots'][0, 0])}) replayed through "
          f"the plain erosion and fix: {n_diff} of {got.numel()} core layer values differ")
    check(n_diff == 0, "the slot table's eroded core differs from the plain replay")
    moved = float((got[:, 12:] != replay["layers"][core][:, 12:]).double().mean())
    print(f"  {moved:.4f} of the core's eroded layer starts moved")
    check(moved > 0.01, "the replayed zone's erosion changed almost nothing")
    time_stream_kernels(dev, s.t, log, err, times, bounds, smi)
    del s
    torch.cuda.empty_cache()

    s = sched.make_scheduler(radius=None, skip_erosion=False, native=True, device=dev)
    s.timer = StageTimer(dev)
    s.set_player_pos(0.0, 0.0)
    t0 = time.perf_counter()
    frames2 = s.drain()
    secs2 = time.perf_counter() - t0
    rep = s.timer.report()
    print(f"  again with the StageTimer (synchronising each stage): {frames2} frames in {secs2:.3f} s; "
          f"per stage (s, calls): " + ", ".join(f"{k} {v['seconds']:.4f} / {v['calls']}"
                                               for k, v in rep.items()))
    check(frames2 == frames and s.drawable_count() == 1089, "the timed drain differs")
    del s
    torch.cuda.empty_cache()

    # the device's busy time in a third drain, traced by torch.profiler: the union of the
    # kernels' and copies' spans on the card, against the clean drain's wall time
    s = sched.make_scheduler(radius=None, skip_erosion=False, native=True, device=dev)
    s.set_player_pos(0.0, 0.0)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        s.drain()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if spans:
        busy, reach, by_name = 0.0, float("-inf"), {}
        for a, b, name in spans:
            busy += max(0.0, b - max(a, reach))
            reach = max(reach, b)
            by_name[name[:60]] = by_name.get(name[:60], 0.0) + (b - a)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        print(f"  traced drain: {len(spans)} device events, device busy {busy / 1e6:.4f} s of the "
              f"clean drain's {secs:.4f} s, idle share {1 - busy / 1e6 / secs:.1%}; by name (s): "
              + ", ".join(f"{k} {v / 1e6:.4f}" for k, v in top))
        for label, pattern in (("K5", r"\bplacements_kernel\b"), ("K7a", r"\bfeature_streams_kernel\b")):
            sel = [b - a for a, b, name in spans if re.search(pattern, name)]
            print(f"  traced drain, {label}: {len(sel)} device events, {sum(sel) / 1e6:.4f} s")
    else:
        print("  traced drain: the profiler recorded no device events; device busy: not measured")
    del s, prof
    torch.cuda.empty_cache()
    return launches


def check_stream_launches(tag, log, launches, erosion_on):
    """One launch of each of a dispatch's kernels per dispatch; no area-path kernel."""
    for name, ks in DISPATCH_KERNELS.items():
        n = log.count(name)
        check((n > 0) == (erosion_on or name != "dispatch_erosion"), f"{tag}: {n} {name} calls")
        for k in ks:
            check(launches[k] == n, f"{tag}: kernel {k} launched {launches[k]} times for {n} {name}")
    for k in ("layers", "features"):
        check(launches[k] == 0, f"{tag}: the area kernel {k} launched {launches[k]} times")


def k7s_counts(t, nslots, pos, base_blocks):
    """(bytes, f32 operations) K7s needs for one fill batch: the blocks read and written
    once, the visible gathered entries' fields and streams read once; one SDF evaluation
    per voxel of the chunk in a visible entry's window and height bounds whose terrain
    block passes its test (as K7's bound counts them)."""
    from mega_minecraft_tpu_torch.kernels import CAVE_FIELDS, STREAM_LEN, SURFACE_FIELDS
    from mega_minecraft_tpu_torch.terrain import feature_placement as fp, features
    from mega_minecraft_tpu_torch.world.blocks import Block

    nsl = nslots.cpu().numpy()
    P = pos.cpu().numpy()
    B = nsl.shape[0]
    air = torch.zeros((B, 16, 16, 385), dtype=torch.int16, device=base_blocks.device)
    air[..., 1:] = torch.cumsum((base_blocks == int(Block.AIR)).to(torch.int16), -1, dtype=torch.int16)
    air = air.cpu().numpy()
    rows = torch.as_tensor(np.unique(nsl), device=base_blocks.device).long()
    row_of = {int(r): i for i, r in enumerate(rows.tolist())}
    ops = n_vis = 0
    fields_b = 0
    for kind, d, table, cave, cap, K in (
            ("surface", t.d_sf, SDF_OPS_SURFACE, False, fp.MAX_GATHERED_FEATURES, 256),
            ("cave", t.d_cf, SDF_OPS_CAVE, True, fp.MAX_GATHERED_CAVE_FEATURES, 1024)):
        L = {k: v[rows].cpu().numpy() for k, v in d.items()}
        half = features.window_half_widths(cave)
        bnd = features.fd.CAVE_FEATURE_HEIGHT_BOUNDS if cave else features.fd.FEATURE_HEIGHT_BOUNDS
        nf = len(CAVE_FIELDS if cave else SURFACE_FIELDS)
        for b in range(B):
            ox, oz = int(P[b, 0]), int(P[b, 1])
            gathered = 0
            for r in range(49):
                i = row_of[int(nsl[b, r])]
                n = min(int(L["count"][i]), K, max(cap - gathered, 0))
                gathered += min(int(L["count"][i]), K)
                n_vis += n
                fields_b += n * (nf * 4 + STREAM_LEN * 4)
                for k in range(n):
                    f = int(L["feature"][i, k])
                    px, py, pz = (int(L[c][i, k]) for c in "xyz")
                    h = int(L["height"][i, k]) if cave else 0
                    x0, x1 = max(px - ox - int(half[f, 0]), 0), min(px - ox + int(half[f, 1]), 15)
                    z0, z1 = max(pz - oz - int(half[f, 0]), 0), min(pz - oz + int(half[f, 1]), 15)
                    y0, y1 = max(py + int(bnd[f, 0]), 0), min(py + h + int(bnd[f, 1]), 383)
                    if x0 > x1 or z0 > z1 or y0 > y1:
                        continue
                    if int(L["replace"][i, k]):
                        vox = (x1 - x0 + 1) * (z1 - z0 + 1) * (y1 - y0 + 1)
                    else:
                        win = air[b, z0 : z1 + 1, x0 : x1 + 1]
                        vox = int((win[..., y1 + 1].astype(np.int64) - win[..., y0]).sum())
                    ops += vox * table[f]
    n_bytes = 2 * B * 98304 + fields_b + nbytes(nslots, pos) + B * 49 * 2 * 4
    print(f"    K7s on the batch: {B} chunks, {n_vis} visible gathered entries, {ops:.4g} SDF "
          f"operations needed")
    return n_bytes, ops


def erosion_phase(dev, stamp, err, times, bounds, smi):
    """K9 vs its plain version and the reference's eroded grids; the eroded 24x24 area."""
    from mega_minecraft_tpu_torch import kernels
    from mega_minecraft_tpu_torch.terrain import erosion, pipeline
    from mega_minecraft_tpu_torch.world.blocks import Block

    stamp("phase 7: K9 zone erosion vs the plain version and tests/golden/golden_erosion.npz")
    ge = np.load(EROSION_GOLDEN)
    err["erosion"] = 0.0
    sweeps_of = {}
    for key in ("0_0", "400_-560"):
        grid = torch.as_tensor(ge[f"input_{key}"], device=dev)
        got, iters = kernels.erode_zone(grid)
        sweeps = []
        want = erosion.erode_zone_plain(grid, sweeps)
        n_diff = int((got.view(torch.int32) != want.view(torch.int32)).sum())
        print(f"  K9 {key}: {n_diff} of {got.numel()} values differ from the plain version (bits); "
              f"sweeps per layer, top first: kernel {iters.tolist()}, plain {sweeps}")
        check(n_diff == 0, f"K9 {key}: {n_diff} values differ from the plain version")
        check(iters.tolist() == sweeps, f"K9 {key}: sweep counts {iters.tolist()} != {sweeps}")
        moved = float(((want[:8] - grid[:8]).abs() > 1e-6).double().mean())
        check(moved > 0.01, f"K9 {key}: erosion moved only {moved:.4f} of the starts")
        ref = torch.as_tensor(ge[f"eroded_{key}"], device=dev)
        d = float((got[:8] - ref[:8]).abs().max())
        print(f"  K9 {key} vs eroded_{key}: max |diff| {d:g} (gate 2e-3), heightfield equal: "
              f"{bool(torch.equal(got[8], ref[8]))}; {moved:.4f} of the starts moved")
        check(d <= 2e-3 and torch.equal(got[8], ref[8]), f"K9 {key}: outside the golden gate")
        sweeps_of[key] = sweeps

    stamp("phase 7b: generate_area(0, 0, 24, 24, erode=True, features=True)")
    kernels.reset_launch_counts()
    area = pipeline.generate_area(0, 0, 24, 24, erode=True, features=True, device=dev)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    print(f"  launch counts of the eroded featured 24x24 run: {launches}")
    for name in KERNELS:
        want = int(name in AREA_KERNELS or name == "erosion")
        check(launches[name] == want, f"kernel {name}: {launches[name]} launches in the eroded run")
    b = area["blocks"]
    check(tuple(b.shape) == (24, 24, 16, 16, 384) and bool(torch.isfinite(area["layers"]).all()),
          "eroded area: shape or non-finite layers")
    check(bool((b[..., 0] == int(Block.BEDROCK)).all()), "eroded area: a column lacks bedrock")
    # K9 on the area's own gathered grid, and the area's layers vs the plain stage chain
    pos_h = pipeline.chunk_positions(-1, -1, 26, 26, device=dev)
    hf_h, w_h = kernels.heightfield(pos_h)
    st = kernels.layers(hf_h, w_h, pos_h, 24, 24, fix_backward=False)
    grid = erosion.gather_zone_layers(st["layers"].reshape(24, 24, 20, 16, 16),
                                      st["heightfield"].reshape(24, 24, 16, 16)).contiguous()
    got, iters = kernels.erode_zone(grid)
    sweeps = []
    want = erosion.erode_zone_plain(grid, sweeps)
    n_diff = int((got.view(torch.int32) != want.view(torch.int32)).sum())
    print(f"  K9 on the area's gathered grid: {n_diff} values differ from the plain version; "
          f"sweeps {iters.tolist()} (plain {sweeps})")
    check(n_diff == 0 and iters.tolist() == sweeps, "K9 on the area's grid differs from the plain version")
    gs = torch.arange(576, dtype=torch.int32, device=dev).reshape(24, 24)
    want_l = erosion.erode_zone_slots_plain(st["layers"].clone(), st["heightfield"], gs, fix_all=True)
    n_diff = int((area["layers"].view(torch.int32) != want_l.view(torch.int32)).sum())
    print(f"  eroded area layers vs K2 (no fix) -> plain erosion + write-back + fix: {n_diff} differ")
    check(n_diff == 0, "the eroded area's layers differ from the plain stage chain")
    fixed = kernels.layers(hf_h, w_h, pos_h, 24, 24)["layers"].reshape(24, 24, 20, 16, 16)
    el = area["layers"].reshape(24, 24, 20, 16, 16)
    core = torch.zeros((24, 24), dtype=torch.bool, device=dev)
    core[6:18, 6:18] = True
    check(torch.equal(el[~core], fixed[~core]), "erosion changed a chunk outside the zone's core")
    moved = float((el[core] != fixed[core]).double().mean())
    print(f"  outside the core the layers equal the uneroded area's; {moved:.4f} of the core's differ")
    check(moved > 0.01, "erosion changed almost nothing in the core")

    reps = 20
    ms = cuda_ms(lambda: kernels.erode_zone(grid), reps)
    ms_slots = cuda_ms(lambda: kernels.erode_zone_slots(st["layers"].clone(), st["heightfield"], gs,
                                                        True), reps)
    plain_ms = cuda_ms(lambda: erosion.erode_zone_plain(grid), 2)
    area_ms = cuda_ms(lambda: pipeline.generate_area(0, 0, 24, 24, erode=True, features=True,
                                                     device=dev), 3)
    # the kernel's own sweep counter, read after the timed runs
    for key, sweeps_k in sweeps_of.items():
        _, iters = kernels.erode_zone(torch.as_tensor(ge[f"input_{key}"], device=dev))
        print(f"  K9 sweeps on {key} after the timed runs: {iters.tolist()} = {sum(iters.tolist())}")
        check(iters.tolist() == sweeps_k, f"K9 {key}: sweep counts changed")
    total = sum(sweeps)
    ncol = 384 * 384
    b9 = bound(2 * 9 * ncol * 4, total * ncol * 40)  # the grid read and written once
    print(f"  K9 on {smi}: {ms:.3f} ms per zone on the area's grid ({total} dependent sweeps, "
          f"{ms / total * 1e3:.1f} us each), {ms_slots:.3f} ms through the slot table with the "
          f"write-back (cloned layers included); plain {plain_ms:.3f} ms; bound {b9[0]:.4g} ms by "
          f"{b9[1]}; golden sweeps {sweeps_of}; eroded featured 24x24 area {area_ms:.3f} ms = "
          f"{576 / (area_ms / 1e3):.1f} chunks/s")
    times["erosion"] = (ms, plain_ms)
    bounds["erosion"] = b9



# -- the render path (phases 10-12) ---------------------------------------------------------
#: f32 operations of one DDA step (the loop body of csrc/tracer.cu trace_ray: position and
#: voxel, the word's decode, the cell exit, the crossed quads, the skips), one ray's setup,
#: one bounce's shading (texel, variant hash 455, BSDF sample, the ten draws, the NEE sample
#: and the sky without clouds, roulette) and the cloud march of a first-hit ray with
#: dy >= 0.04 (12 samples of 5 Perlin stacks)
DDA_STEP_OPS = 140
DDA_RAY_OPS = 60
SHADE_OPS = 1000
CLOUD_OPS = 8400
#: K10 per fine voxel: 6 doubling rounds, each with 6 shifted mins, an add and a min for
#: the 3-D distance and 4 shifted mins (horizontal only), an add and a min for each of
#: the three clearances; the seeds and the encoding (the macro level adds 1/64 of it).
#: These are integer min / add; the bound prices them at the f32 rate (67 TFLOP/s), the
#: only non-tensor rate in the published table
K10_VOXEL_OPS = 6 * (8 + 3 * 6) + 30
RENDER_FRAMES = 8  # accumulated frames per timed run, as bench_render.py runs them
K11_TRACED_CALLS = 4  # K11 calls under torch.profiler for its spans by launch


def bench_blocks(dev):
    """The 10x10 bench scene's chunks: four featured 5x5 areas tiled as tools/scenelib.py
    tiles them (chunks [-5, 5)), and the highest heightfield value."""
    from mega_minecraft_tpu_torch.terrain import pipeline

    rows, hmax = [], 0.0
    for tz in range(2):
        row = []
        for tx in range(2):
            cx0, cz0 = -5 + 5 * tx, -5 + 5 * tz
            out = pipeline.generate_area_fused(
                pipeline.chunk_positions(cx0 - 1, cz0 - 1, 7, 7, device=dev), 5, 5, features=True)
            row.append(out["blocks"].reshape(5, 5, 16, 16, 384))
            hmax = max(hmax, float(out["heightfield"].max()))
        rows.append(torch.cat(row, dim=1))
    return torch.cat(rows, dim=0), hmax


#: K10's and K10u's launches a call by kernel (device_ms)
K10_LAUNCHES = {"scene_prep_kernel": 1, "scene_round_kernel": 5, "scene_encode_kernel": 1}
K10U_LAUNCHES = {"update_prep_kernel": 1, "scene_round_kernel": 5, "scene_encode_kernel": 1}


def k10_counts(vol, flat):
    n = vol.numel()
    return vol.numel() + flat.numel() * 4, n * K10_VOXEL_OPS * 65 / 64


def k11t_counts(n_rays, steps, scene):
    words = min(int(steps.sum()), scene.flat.numel())
    return n_rays * (25 + 18) + words * 4, int(steps.sum()) * DDA_STEP_OPS + n_rays * DDA_RAY_OPS


def k11_counts(stats, scene):
    """stats: the [H, W, 4] counts of a render_sample(want_steps=True) and the primary dy."""
    st, dy = stats
    steps = int(st[..., :3].sum())
    rays = int(st[..., 3].sum())
    clouds = int((dy >= 0.04).sum())
    n_px = st.shape[0] * st.shape[1]
    words = min(steps, scene.flat.numel())
    return (n_px * 10 * 4 + words * 4,
            steps * DDA_STEP_OPS + rays * (2 * DDA_RAY_OPS + SHADE_OPS) + clouds * CLOUD_OPS)


def step_stats(name, st):
    out = []
    for k, label in enumerate(("primary", "bounce", "shadow", "radiance rays")):
        v = st[..., k].reshape(-1).double()
        out.append(f"{label} mean {float(v.mean()):.3f} p99 {float(torch.quantile(v[::7], 0.99)):.0f} "
                   f"max {int(v.max())}")
    print(f"  {name} per pixel: " + "; ".join(out))


def check_k11(name, scene, cam, params, exact, tile=None):
    """K11 against its plain version on the whole 1080p frame 3, or on ``tile`` (height,
    width, row0, col0) of it.  Counts equal, and colour, albedo, normal and depth equal:
    the kernel runs the plain version's arithmetic on the card's libm.  Returns the max
    |diff|."""
    from mega_minecraft_tpu_torch.render import tracer

    h, w, row0, col0 = tile or (1080, 1920, 0, 0)
    where = dict(row0=row0, full_height=1080, col0=col0, full_width=1920, exact=exact)
    k = tracer.render_sample(scene, cam, params, h, w, 3, want_depth=True, want_steps=True, **where)
    p = tracer.render_sample_plain(scene, cam, params, h, w, 3, **where)
    check_equal(f"{name} counts", k[4], p[4])
    msg, e = [], 0.0
    for field, g, want in zip(("color", "albedo", "normal", "depth"), k, p):
        check(bool(torch.isfinite(g).all()), f"{name} {field} not finite")
        d = (g.double() - want.double()).abs()
        mx, n_diff = float(d.max()), int((g != want).sum())
        msg.append(f"{field} max {mx:.3g} ({n_diff} values differ)")
        check(n_diff == 0, f"{name} {field}: {n_diff} values differ from the plain version, max {mx}")
        e = max(e, mx)
    print(f"  {name}: " + "; ".join(msg))
    return e


def k11_pass_stats(scene, cam, params, h, w):
    """K11's DDA steps by pass from its ``pass_steps`` output (frame 3): the live paths each
    pass takes, and the SIMT efficiency of the DDA steps (the steps over the sum, over warps
    and over each pass's radiance and shadow DDA, of 32 lanes times the warp's most steps)
    under three mappings: the bounce loop in every lane over 1x32-pixel rows and over
    8x4-pixel tiles, and the wavefront (pass 0 over the tiles, each later pass over 32
    consecutive queue slots, as a warp takes them)."""
    from mega_minecraft_tpu_torch import kernels
    from mega_minecraft_tpu_torch.render import tracer

    dev = scene.flat.device
    loops = tracer.MAX_LOOP_ITERS
    rec = torch.full((loops, h * w, 3), -1, dtype=torch.int32, device=dev)
    kernels.render_sample(scene, cam, params, h, w, 3, 0, h, 0, w, False, False, pass_steps=rec)
    by_px = torch.zeros((loops, 2, h * w), dtype=torch.float64, device=dev)  # radiance, shadow by pixel
    live = []
    for k in range(loops):
        m = rec[k, :, 0] >= 0
        live.append(int(m.sum()))
        px = rec[k, m, 0].long()
        by_px[k, 0, px] = rec[k, m, 1].double()
        by_px[k, 1, px] = rec[k, m, 2].double()
    total = float(by_px.sum())

    def warps(rows, cols):  # [n_warps, 32] pixel indices of a mapping, -1 past the frame
        yy = torch.arange(-(-h // rows) * rows, device=dev).view(-1, rows, 1, 1)
        xx = torch.arange(-(-w // cols) * cols, device=dev).view(1, 1, -1, cols)
        idx = torch.where((yy < h) & (xx < w), yy * w + xx, -1)
        return idx.permute(0, 2, 1, 3).reshape(-1, rows * cols)

    def cost(vals, groups):  # vals [h * w]; sum over warps of 32 x the most steps
        g = torch.where(groups >= 0, vals[groups.clamp(min=0)], torch.zeros((), dtype=vals.dtype, device=dev))
        return 32.0 * float(g.amax(1).sum())

    rows, tiles = warps(1, 32), warps(4, 8)
    eff = {}
    for tag, groups in (("rows 1x32", rows), ("tiles 8x4", tiles)):
        eff[tag] = total / max(1.0, sum(cost(by_px[k, j], groups) for k in range(loops) for j in range(2)))
    per_pass, wave = [], 0.0
    for k in range(loops):
        if k == 0:
            c = cost(by_px[0, 0], tiles) + cost(by_px[0, 1], tiles)
        else:
            n = live[k]
            slots = torch.zeros((-(-n // 32) * 32, 2), dtype=torch.float64, device=dev)
            slots[:n] = rec[k, :n, 1:].double()
            c = 32.0 * float(slots.view(-1, 32, 2).amax(1).sum())
        wave += c
        per_pass.append(float(by_px[k].sum()) / max(1.0, c))
    eff["wavefront"] = total / max(1.0, wave)
    return live, eff, per_pass


def launch_spans(fn, calls):
    """[(kernel, ms)] of ``calls`` warm calls of ``fn`` under torch.profiler, in launch order."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    evs = sorted((e.time_range.start, e.name, (e.time_range.end - e.time_range.start) / 1e3)
                 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)
    return [(name.split("(")[0][-28:], ms) for _, name, ms in evs]


def alpha_cutout_checks(scene0, blocks, rays, med, params):
    """The alpha-cutout code, which the procedural atlas never reaches, under the hand-set
    atlas of tests/test_torch_cuda.py (leaves, X-shaped flora, stone, grass block and
    smooth sandstone half transparent), on the bench scene (``scene0``: built without
    cutouts from ``blocks``): K10's flag and fraction bits; K11t exact and stochastic on
    its 1080p primary rays and on 262,144 rays aimed at flagged voxels; K11 exact and not
    on the whole 1080p frame of a camera aimed at a flagged voxel.  Returns the max |diff|."""
    from mega_minecraft_tpu_torch.render import brickmap, tracer

    sys.path.insert(0, str(ROOT / "tests"))
    from test_torch_cuda import aimed_player, cutout_atlas, flagged_surface_voxels, rays_at

    dev = blocks.device
    with cutout_atlas():
        scene = brickmap.build_scene(blocks, -5, -5)
        e = check_equal("cutout K10 10x10 flat", scene.flat, brickmap.build_fields_plain(
            brickmap.scene_volume(blocks)))
        targets = flagged_surface_voxels(scene, 262144)
        aimed = rays_at(targets, dev)
        for tag, rs, m in (("1080p primary", rays, med), ("aimed", aimed, med.new_zeros(len(targets)))):
            base = tracer.trace(scene0, *rs, m)
            seed = (torch.arange(m.numel(), dtype=torch.int64, device=dev) * 2654435761 % 2 ** 32).view(m.shape)
            for alpha in ("exact", "stochastic"):
                sd = seed if alpha == "stochastic" else None
                got, gst = tracer.trace(scene, *rs, m, want_steps=True, alpha=alpha, seed=sd)
                want, wst = tracer.trace_plain(scene, *rs, m, want_steps=True, alpha=alpha, seed=sd)
                for k in got._fields:
                    n_diff = int((getattr(got, k) != getattr(want, k)).sum())
                    check(n_diff == 0, f"cutout K11t {tag} {alpha} {k}: {n_diff} values differ")
                check_equal(f"cutout K11t {tag} {alpha} steps", gst, wst)
                moved = int((got.t != base.t).sum())
                print(f"  cutout K11t {tag} {alpha}: every output equal; {int(got.hit.sum())} hits, "
                      f"{int(gst.sum())} steps; t moved by the cutouts on {moved} of {m.numel()} rays")
                check(moved > 0, f"cutout K11t {tag} {alpha}: the cutouts changed no ray")
        cam = aimed_player(targets).camera_params(1920, 1080, device=dev)
        for exact in (True, False):
            e = max(e, check_k11(f"cutout K11 exact={exact} aimed camera 1920x1080", scene, cam, params,
                                 exact))
            d0 = tracer.render_sample(scene0, cam, params, 1080, 1920, 3, want_depth=True, exact=exact)[3]
            d1 = tracer.render_sample(scene, cam, params, 1080, 1920, 3, want_depth=True, exact=exact)[3]
            share = float((d0 != d1).double().mean())
            print(f"  cutout K11 exact={exact}: depth moved by the cutouts on {share:.4f} of the pixels")
            check(share > 0.01, f"cutout K11 exact={exact}: the cutouts are not in view")
    return e


def render_phases(dev, stamp, err, smi):
    """Phases 10-12.  Returns (launches, times, bounds) of the render kernels, and the
    10x10 and 33x33 scenes with the 1080p camera and the day and night skies (phase 15)."""
    from mega_minecraft_tpu_torch import kernels
    from mega_minecraft_tpu_torch.render import brickmap, camera, sky, tracer
    from mega_minecraft_tpu_torch.terrain import pipeline

    stamp("phase 10: the render main path on the 10x10 bench scene at 1080p (counts reset "
          "around it), and K10 on the 10x10 and 33x33 scenes")
    blocks10, hmax = bench_blocks(dev)
    player = camera.Player(pos=np.array([0.0, hmax + 16.0, -60.0], np.float32), theta=0.05, phi=-0.22)
    H, W = 1080, 1920
    cam = player.camera_params(W, H, device=dev)
    day = sky.sky_params(1.0, 0.0, device=dev)
    med = torch.zeros((H, W), dtype=torch.uint8, device=dev)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    scene10 = brickmap.build_scene(blocks10, -5, -5)
    rays, _ = tracer.primary_rays(cam, H, W, 0)
    prim = tracer.trace(scene10, *rays, med)
    fbs = tracer.init_framebuffers(H, W, device=dev)
    c, a, n = tracer.render_sample(scene10, cam, day, H, W, 0)
    fbs = tracer.accumulate(fbs, c, a, n, 0)
    for fid in range(1, RENDER_FRAMES + 1):
        fbs = tracer.render_accumulate(fbs, scene10, cam, day, H, W, fid)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    scene_launches = {"scene_fields": kernels.scene_launches()}  # the run's one K10 call
    want = {"scene_fields": 1, "trace": 1, "render_sample": RENDER_FRAMES + 1,
            "accumulate": RENDER_FRAMES + 1}
    print(f"  launch counts of the render main path: {launches}")
    for name, count in launches.items():
        check(count == want.get(name, 0), f"kernel {name}: {count} launches in the render run, "
              f"not {want.get(name, 0)}")
    for name, t in zip(("color", "albedo", "normal"), fbs[:3]):
        check(tuple(t.shape) == (H, W, 3) and bool(torch.isfinite(t).all()), f"1080p {name} not finite")
    check(float(fbs.color.min()) >= 0.0 and float(fbs.albedo.min()) >= 0.0, "negative colour")
    nlen = fbs.normal.norm(dim=-1)
    hit_share = float(prim.hit.double().mean())
    check(0.05 < hit_share < 0.999, f"primary rays hit {hit_share:.3f} of the frame")
    print(f"  after {RENDER_FRAMES + 1} frames: mean colour {fbs.color.mean(dim=(0, 1)).tolist()}, "
          f"albedo {fbs.albedo.mean(dim=(0, 1)).tolist()}, |normal| mean {float(nlen.mean()):.4f}; "
          f"primary rays hit {hit_share:.4f} of the frame")

    vol10 = brickmap.scene_volume(blocks10)
    plain10 = brickmap.build_fields_plain(vol10)
    err["scene_fields"] = check_equal("K10 10x10 flat (fine ++ macro)", scene10.flat, plain10)
    del plain10
    print(f"  K10's device launches a call: {scene_launches['scene_fields']}")
    check(scene_launches["scene_fields"] <= 20, "K10 makes more than 20 launches a call")
    # a cut whose dims are multiples of 4 but not of the prep's 4x4-column groups' 16
    cut = vol10[60:96, 70:90].contiguous()
    err["scene_fields"] = max(err["scene_fields"], check_equal(
        "K10 36x20x384 cut of the 10x10 scene", kernels.scene_fields(cut), brickmap.build_fields_plain(cut)))
    area33 = pipeline.generate_area(-16, -16, 33, 33, features=True, device=dev)
    blocks33 = area33["blocks"]
    del area33
    scene33 = brickmap.build_scene(blocks33, -16, -16)
    vol33 = brickmap.scene_volume(blocks33)
    err["scene_fields"] = max(err["scene_fields"], check_equal(
        "K10 33x33 flat (fine ++ macro)", scene33.flat, brickmap.build_fields_plain(vol33)))
    torch.cuda.empty_cache()

    stamp("phase 11: K11t, K11 (day, night, exact, alpha cutout) and K12 against their plain versions")
    got, gst = tracer.trace(scene10, *rays, med, want_steps=True)
    want_t, wst = tracer.trace_plain(scene10, *rays, med, want_steps=True)
    e11t = max(check_equal(f"K11t 1080p primary {k}", getattr(got, k), getattr(want_t, k))
               for k in ("hit", "block"))
    for k in ("nx", "ny", "nz", "t"):
        g, w = getattr(got, k), getattr(want_t, k)
        n_diff, mx = int((g != w).sum()), float((g.double() - w.double()).abs().max())
        print(f"  K11t 1080p primary {k}: {n_diff} of {g.numel()} differ, max |diff| {mx:g}")
        check(n_diff == 0, f"K11t {k}: {n_diff} values differ from the plain version")
        e11t = max(e11t, mx)
    check_equal("K11t steps", gst, wst)
    err["trace"] = e11t
    night = sky.sky_params(4.0, 0.0, device=dev)  # sun y = -0.758: below the horizon
    e11 = 0.0
    for tag, scene, params, exact in (("10x10 day", scene10, day, False), ("33x33 day", scene33, day, False),
                                      ("10x10 night (sun_time 4.0)", scene10, night, False),
                                      ("10x10 day exact", scene10, day, True)):
        e11 = max(e11, check_k11(f"K11 {tag} 1920x1080", scene, cam, params, exact))
    for tag, scene in (("10x10", scene10), ("33x33", scene33)):  # a tile whose sizes fit no CTA tile
        e11 = max(e11, check_k11(f"K11 {tag} day 997x135 tile at row 271, column 13 of the 1080p frame",
                                 scene, cam, day, False, tile=(135, 997, 271, 13)))
    e11 = max(e11, alpha_cutout_checks(scene10, blocks10, rays, med, day))
    err["render_sample"] = e11
    c, a, n = tracer.render_sample(scene10, cam, day, H, W, 3)
    k12 = tracer.accumulate(fbs, c, a, n, 3)
    p12 = tracer.accumulate_plain(fbs, c, a, n, 3)
    err["accumulate"] = max(check_equal(f"K12 {name}", g.view(torch.int32), w.view(torch.int32))
                            for name, g, w in zip(("color", "albedo", "normal"), k12, p12))
    kernels.reset_launch_counts()
    tracer.render_accumulate(fbs, scene10, cam, day, H, W, 9)
    torch.cuda.synchronize()
    one = kernels.launch_counts()
    check(one["render_sample"] == 1 and one["accumulate"] == 1 and sum(one.values()) == 2,
          f"render_accumulate launched {one}")
    print("  one render_accumulate: 1 K11 and 1 K12 launch, nothing else")

    stamp("phase 12: timing (warm, CUDA events)")
    times, bounds = {}, {}
    for tag, scene in (("10x10", scene10), ("33x33", scene33)):
        for h, w in ((1080, 1920), (540, 960)):
            cam_hw = player.camera_params(w, h, device=dev)
            fb = tracer.init_framebuffers(h, w, device=dev)
            fb = tracer.render_accumulate(fb, scene, cam_hw, day, h, w, 0)
            torch.cuda.synchronize()
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            for fid in range(1, RENDER_FRAMES + 1):
                fb = tracer.render_accumulate(fb, scene, cam_hw, day, h, w, fid)
            e1.record()
            torch.cuda.synchronize()
            ms = e0.elapsed_time(e1) / RENDER_FRAMES
            times[("frame", tag, h)] = ms
            print(f"  {tag} {w}x{h} on {smi}: {ms:.3f} ms/frame = {h * w / ms / 1e3:.3f} Mpaths/s "
                  f"({RENDER_FRAMES} accumulated frames)")
            live, eff, per_pass = k11_pass_stats(scene, cam_hw, day, h, w)
            print(f"  K11 {tag} {w}x{h} frame 3: live paths by pass {live}; SIMT efficiency of the DDA "
                  "steps: " + ", ".join(f"{k} {v:.4f}" for k, v in eff.items())
                  + "; wavefront by pass " + ", ".join(f"{v:.4f}" for v in per_pass))
            spans = launch_spans(lambda: tracer.render_sample(scene, cam_hw, day, h, w, 3), K11_TRACED_CALLS)
            n_k11 = kernels.render_launches()
            k11_spans = [(name, t) for name, t in spans if "render_" in name]
            print(f"  K11 {tag} {w}x{h} device spans of the last of {K11_TRACED_CALLS} calls (torch.profiler, "
                  "ms): " + ", ".join(f"{name} {t:.4f}" for name, t in k11_spans[-n_k11:])
                  + f"; kernels.render_launches() {n_k11}; K11 kernels traced {len(k11_spans)}")
            # the profiler may drop a trace's first launches, never more than a call's
            check((K11_TRACED_CALLS - 1) * n_k11 <= len(k11_spans) <= K11_TRACED_CALLS * n_k11,
                  f"render_launches() {n_k11}, {len(k11_spans)} K11 kernels traced in {K11_TRACED_CALLS} calls")
        dy = tracer.primary_rays(cam, 1080, 1920, 3)[0][4]
        _, _, _, st = tracer.render_sample(scene, cam, day, 1080, 1920, 3, want_steps=True)
        step_stats(f"{tag} 1080p frame 3", st)
        bounds[("render_sample", tag)] = bound(*k11_counts((st, dy), scene))
        vol = vol10 if tag == "10x10" else vol33
        k10_ms = cuda_ms(lambda: kernels.scene_fields(vol), 3)
        times[("scene_fields", tag)] = k10_ms
        bounds[("scene_fields", tag)] = bound(*k10_counts(vol, scene.flat))
        k10_dev = fmt_ms(device_ms(lambda: kernels.scene_fields(vol), K10_LAUNCHES, 5))
        print(f"  K10 {tag} on {smi}: {k10_ms:.3f} ms (device {k10_dev}), bound "
              f"{bounds[('scene_fields', tag)][0]:.4g} ms by {bounds[('scene_fields', tag)][1]}")
    p10 = cuda_ms(lambda: brickmap.build_fields_plain(vol10), 1)
    k11t = cuda_ms(lambda: tracer.trace(scene10, *rays, med), 5)
    p11t = cuda_ms(lambda: tracer.trace_plain(scene10, *rays, med), 1)
    k11 = cuda_ms(lambda: tracer.render_sample(scene10, cam, day, H, W, 3), 3)
    p11 = cuda_ms(lambda: tracer.render_sample_plain(scene10, cam, day, H, W, 3), 1)
    k12 = cuda_ms(lambda: tracer.accumulate(fbs, c, a, n, 3), 20)
    p12 = cuda_ms(lambda: tracer.accumulate_plain(fbs, c, a, n, 3), 5)
    # the library's running average: one torch.lerp a buffer (old + (new - old) / (fid + 1))
    mult = tracer.accumulate_weights(3)[1]
    times[("library", "accumulate")] = cuda_ms(
        lambda: [torch.lerp(o, x, mult) for o, x in zip(fbs[:3], (c, a, n))], 20)
    b11t = bound(*k11t_counts(H * W, gst, scene10))
    b12 = bound(9 * c.numel() * 4, 3 * c.numel() * 3)
    times.update({"scene_fields": (times[("scene_fields", "10x10")], p10), "trace": (k11t, p11t),
                  "render_sample": (k11, p11), "accumulate": (k12, p12)})
    bounds.update({"scene_fields": bounds[("scene_fields", "10x10")], "trace": b11t,
                   "render_sample": bounds[("render_sample", "10x10")], "accumulate": b12})
    print(f"  kernels on the 10x10 scene at 1080p on {smi}:")
    for name in RENDER_KERNELS:
        (k_ms, pl_ms), (b_ms, b_by) = times[name], bounds[name]
        print(f"    {name:14s} kernel {k_ms:.3f} ms, bound {b_ms:.4g} ms by {b_by} ({b_ms / k_ms:.1%} "
              f"of it), plain {pl_ms:.3f} ms ({pl_ms / k_ms:.1f}x), launches {launches[name]}")
    b33 = bounds[("render_sample", "33x33")]
    print(f"  K11 33x33 1080p bound {b33[0]:.4g} ms by {b33[1]}; frame {times[('frame', '33x33', 1080)]:.3f} ms")
    print(f"  K12's library yardstick, three torch.lerp calls on the same buffers: "
          f"{times[('library', 'accumulate')]:.4f} ms")
    del vol33, blocks33
    torch.cuda.empty_cache()
    scenes = {"scene10": scene10, "scene33": scene33, "blocks10": blocks10, "cam": cam, "day": day, "night": night}
    return launches, times, bounds, scenes


# -- the engine's frame path (phases 13-14) -------------------------------------------------
#: f32 operations of one à-trous tap (three squared distances, the exponent's two divisions
#: and subtractions, expf ~10, the weighted sums)
ATROUS_TAP_OPS = 45
FLY_FRAMES = 30  # ticks of the timed fly-through, as bench_flythrough.py times them
#: device kernels of the fly-through by stage, for the profiler's split
STAGE_OF_KERNEL = (("update_prep_kernel", "K10u"), ("scene_round_kernel", "K10u"), ("scene_encode_kernel", "K10u"),
                   ("render_sample_kernel", "K11"), ("render_bounce_kernel", "K11"), ("reproject_kernel", "K13"),
                   ("static_blend_kernel", "K13"), ("atrous_kernel", "present"),
                   ("upscale2x_kernel", "present"), ("present_kernel", "present"))


def k10u_counts(dims, gz, gx, n_w):
    """(bytes, operations) of one K10u: the window's words read and written, the region's
    blocks read, the old macro words read (their solidity outside the region) and the new
    ones written; K10's operations per window voxel and per macro cell.  The solidity of
    the macro cells outside the region is the old macro words', not a read of the whole fine
    field: the scene's macro level is the one computed from its fine level."""
    z, x, y = dims
    n_m = z * x * y // 64
    return 8 * n_w + gz * gx * 16 * 16 * y + 8 * n_m, (n_w + n_m) * K10_VOXEL_OPS


def frame_kernel_phase(dev, stamp, err, smi):
    """Phase 13: K10u, K13, K13s, K14, K15 and K16 against their plain versions on the card,
    timed, with their bounds.  Returns (times, bounds, library)."""
    from mega_minecraft_tpu_torch import kernels
    from mega_minecraft_tpu_torch.render import brickmap, camera, denoise, reproject, sky, tonemap, tracer
    from mega_minecraft_tpu_torch.terrain import pipeline

    stamp("phase 13: K10u (featured 33x33 scene: a bucket, a removal, an edge bucket), K13, K13s, K14, K15 "
          "and K16 (960x540 / 1920x1080, moved camera) against their plain versions")
    times, bounds, library = {}, {}, {}
    area33 = pipeline.generate_area(-16, -16, 33, 33, features=True, device=dev)
    # the camera over the chunks [-2, 2) around the origin, as the 10x10 bench camera
    blocks33, hmax = area33["blocks"], float(area33["heightfield"].view(33, 33, 16, 16)[14:18, 14:18].max())
    del area33
    scene = brickmap.build_scene(blocks33, -16, -16)
    slot_table = blocks33.reshape(33 * 33, 16, 16, 384)
    e10u = 0.0
    # (tag, bucket row, bucket column, the bucket whose slots are written there, mask)
    one_air = [True] * 4 + [False] + [True] * 4
    cases = (("bucket (4, 5) rewritten from bucket (2, 7), one chunk air", 4, 5, 2, 7, one_air),
             ("bucket (6, 6) removed (all air)", 6, 6, 6, 6, [False] * 9),
             ("edge bucket (10, 10), clamped window", 10, 10, 1, 1, [True] * 9))
    for tag, bz, bx, sz, sx, mask in cases:
        slots = [(sz * 3 + dz) * 33 + sx * 3 + dx for dz in range(3) for dx in range(3)]
        z0, x0 = bz * 48, bx * 48
        want = brickmap.update_chunks_plain(scene, slot_table, slots, mask, 3, 3, z0, x0)
        before = scene.flat.clone()
        kernels.reset_launch_counts()
        scene = brickmap.update_chunks(scene, slot_table, slots, mask, 3, 3, z0, x0)
        torch.cuda.synchronize()
        check(kernels.launch_counts()["update_chunks"] == 1, "update_chunks: not one K10u launch")
        moved = int((scene.flat != before).sum())
        e10u = max(e10u, check_equal(f"K10u {tag} ({moved} words changed)", scene.flat, want))
        check(moved > 10000, f"K10u {tag}: the update changed {moved} words")
    err["update_chunks"] = e10u
    n_launch = kernels.scene_launches()
    print(f"  K10u's device launches a call: {n_launch}")
    check(n_launch <= 20, "K10u makes more than 20 launches a call")
    slots = [(2 * 3 + dz) * 33 + 7 * 3 + dx for dz in range(3) for dx in range(3)]
    args = (slot_table, slots, [True] * 9, 3, 3, 4 * 48, 5 * 48)
    k_ms = cuda_ms(lambda: brickmap.update_chunks(scene, *args), 10)
    p_ms = cuda_ms(lambda: brickmap.update_chunks_plain(scene, *args), 2)
    zlo, xlo, wz, wx = brickmap.update_window(scene.dims, 3, 3, 4 * 48, 5 * 48)
    times["update_chunks"] = (k_ms, p_ms)
    bounds["update_chunks"] = bound(*k10u_counts(scene.dims, 3, 3, wz * wx * 384))
    k_dev = fmt_ms(device_ms(lambda: brickmap.update_chunks(scene, *args), K10U_LAUNCHES, 10))
    print(f"  K10u on {smi}: {k_ms:.4f} ms a 3x3 bucket ({wz}x{wx}x384 window; device {k_dev}), plain "
          f"{p_ms:.3f} ms, bound {bounds['update_chunks'][0]:.4g} ms by {bounds['update_chunks'][1]}")

    h, w = 540, 960
    player = camera.Player(pos=np.array([0.0, hmax + 16.0, -60.0], np.float32), theta=0.05, phi=-0.22)
    moved_player = camera.Player(pos=player.pos + np.array([0.6, 0.3, 2.0], np.float32), theta=0.08, phi=-0.21)
    params = sky.sky_params(1.0, 0.0, device=dev)
    cam0, cam1 = player.camera_params(w, h, device=dev), moved_player.camera_params(w, h, device=dev)
    fbs = tracer.init_framebuffers(h, w, device=dev, temporal=True)
    for fid in range(3):
        fbs = reproject.render_accumulate_static(fbs, scene, cam0, params, h, w, fid)
    c, a, n, d = tracer.render_sample(scene, cam1, params, h, w, 3, want_depth=True)
    got = reproject.accumulate_temporal(fbs, cam0, cam1, c, a, n, d)
    want = reproject.temporal_blend(fbs, cam0, cam1, c, a, n, d)
    err["reproject"] = max(check_equal(f"K13 960x540 {k}", x.view(torch.int32), y.view(torch.int32))
                           for k, x, y in zip(got._fields, got, want))
    kept = float((got.nsamp > 1.0).double().mean())
    print(f"  K13: the history survived the move on {kept:.4f} of the pixels")
    check(0.2 < kept < 1.0, f"K13: history kept on {kept} of the pixels")
    got_s = reproject.accumulate_static(fbs, c, a, n, d)
    want_s = reproject.static_blend(fbs, c, a, n, d)
    err["static_blend"] = max(check_equal(f"K13s 960x540 {k}", x.view(torch.int32), y.view(torch.int32))
                              for k, x, y in zip(got_s._fields, got_s, want_s))
    fbs = got
    den = denoise.atrous_denoise(fbs.color, fbs.albedo, fbs.normal, nsamp=fbs.nsamp)
    err["atrous_denoise"] = check_equal("K14 960x540 (nsamp)", den.view(torch.int32), denoise.atrous_denoise_plain(
        fbs.color, fbs.albedo, fbs.normal, nsamp=fbs.nsamp).view(torch.int32))
    den0 = denoise.atrous_denoise(fbs.color, fbs.albedo, fbs.normal)
    err["atrous_denoise"] = max(err["atrous_denoise"], check_equal(
        "K14 960x540 (fixed sigma)", den0.view(torch.int32),
        denoise.atrous_denoise_plain(fbs.color, fbs.albedo, fbs.normal).view(torch.int32)))
    up = denoise.upscale2x(den)
    err["upscale2x"] = check_equal("K15 960x540 -> 1920x1080", up.view(torch.int32),
                                   denoise.upscale2x_plain(den).view(torch.int32))
    interp = lambda: torch.nn.functional.interpolate(  # noqa: E731
        den.permute(2, 0, 1)[None], scale_factor=2, mode="bilinear", align_corners=False)
    lib = interp()[0].permute(1, 2, 0)
    rel = float(((up - lib).abs() / lib.abs().clamp(min=1e-30)).max())
    print(f"  K15 against F.interpolate(bilinear, align_corners=False): max relative |diff| {rel:.3g}")
    check(rel <= 1e-6, f"K15 differs from torch's bilinear upscale by {rel}")
    for hh, ww in ((1, 1), (3, 5), (7, 9)):
        small = den[:hh, :ww].contiguous()
        err["upscale2x"] = max(err["upscale2x"], check_equal(
            f"K15 {ww}x{hh} -> {2 * ww}x{2 * hh}", denoise.upscale2x(small).view(torch.int32),
            denoise.upscale2x_plain(small).view(torch.int32)))
    img = tonemap.present(up)
    err["present"] = check_equal("K16 1920x1080", img, tonemap.present_plain(up))
    check(tuple(img.shape) == (1080, 1920, 3) and float(img.float().std()) > 5.0, "K16: a flat frame")

    px = h * w
    calls = {
        "reproject": (lambda: reproject.accumulate_temporal(fbs, cam0, cam1, c, a, n, d),
                      lambda: reproject.temporal_blend(fbs, cam0, cam1, c, a, n, d), bound(px * 32 * 4, 0)),
        "static_blend": (lambda: reproject.accumulate_static(fbs, c, a, n, d),
                         lambda: reproject.static_blend(fbs, c, a, n, d), bound(px * 32 * 4, 0)),
        "atrous_denoise": (lambda: denoise.atrous_denoise(fbs.color, fbs.albedo, fbs.normal, nsamp=fbs.nsamp),
                           lambda: denoise.atrous_denoise_plain(fbs.color, fbs.albedo, fbs.normal,
                                                                nsamp=fbs.nsamp),
                           bound(px * 4 * (4 * 6 + 7), px * (4 * 25 * ATROUS_TAP_OPS + 4 * 3))),
        "upscale2x": (lambda: denoise.upscale2x(den), lambda: denoise.upscale2x_plain(den),
                      bound(px * 3 * 4 * 5, 4 * px * 3 * 3)),
        "present": (lambda: tonemap.present(up), lambda: tonemap.present_plain(up),
                    bound(4 * px * 3 * 5, 4 * px * 3 * 20)),
    }
    for name, (kern, plain, bnd) in calls.items():
        p1, k1, k2, p2 = cuda_ms(plain, 2), cuda_ms(kern, 50), cuda_ms(kern, 50), cuda_ms(plain, 2)
        times[name], bounds[name] = ((k1 + k2) / 2, (p1 + p2) / 2), bnd
        print(f"    {name:15s} kernel {times[name][0]:.4f} ms, bound {bnd[0]:.4g} ms by {bnd[1]} "
              f"({bnd[0] / times[name][0]:.1%} of it), plain {times[name][1]:.3f} ms on {smi}")
    library["upscale2x"] = cuda_ms(interp, 50)
    print(f"    upscale2x's library call F.interpolate: {library['upscale2x']:.4f} ms")
    # a call's host and device time: the device time of its launch under torch.profiler
    for tag, fn, launch in (("K15", lambda: denoise.upscale2x(den), "upscale2x_kernel"),
                            ("F.interpolate", interp, "upsample_bilinear2d")):
        call = [cuda_ms(fn, 200) for _ in range(2)]
        print(f"    {tag} at 960x540 -> 1920x1080: a call {call[0]:.4f} / {call[1]:.4f} ms (CUDA events), "
              f"device {fmt_ms(device_ms(fn, {launch: 1}, 200))}")
    del scene, blocks33, slot_table
    torch.cuda.empty_cache()
    return times, bounds, library


def flythrough_phase(dev, stamp, smi):
    """Phase 14: the reference fly-through (bench_flythrough.py:27-36): the drain, then with
    the counts reset around them the upload, 30 ticks 2 blocks forward and one present,
    timed; the presented frame against the plain present chain on the same buffers; the
    same run again on a second engine with the 30 ticks and the present under
    torch.profiler, for the device's idle share and the split by stage.  Returns the launch
    counts of the upload, the 30 ticks and the present, and the second engine (phase 16)."""
    from mega_minecraft_tpu_torch import kernels
    from mega_minecraft_tpu_torch.app.engine import Engine, EngineConfig
    from mega_minecraft_tpu_torch.render import brickmap, denoise, tonemap

    stamp("phase 14: the reference fly-through: Engine(1920x1080, upscaled from 960x540, view_chunks=33, "
          "gen_radius=None, erosion, denoise, reprojection)")
    cfg = EngineConfig(width=1920, height=1080, view_chunks=33, gen_radius=None, skip_erosion=False,
                       use_denoising=True, use_upscaling=True, use_reprojection=True, native_scheduler=True,
                       device="cuda")
    eng = Engine(cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    frames = eng.scheduler.drain()
    torch.cuda.synchronize()
    drain_s = time.perf_counter() - t0
    n_new = len(eng.scheduler.newly_filled)
    sched_s = [0.0]
    tick = eng.scheduler.tick

    def timed_tick(dt):
        t = time.perf_counter()
        tick(dt)
        sched_s[0] += time.perf_counter() - t

    eng.scheduler.tick = timed_tick
    # the main path's run: the upload of the drained world, then the 30 ticks and the present
    # (the scene window stays put, so the flight streams chunks outside it: its K10u
    # launches are the upload's)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    eng._upload_new_chunks()
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    buckets = kernels.launch_counts()["update_chunks"]
    print(f"  initial drain {frames} frames in {drain_s:.4f} s, {eng.drawable_chunks()} drawable; upload of "
          f"{n_new} chunks in {buckets} K10u buckets: {upload_s:.4f} s, on {smi}")
    check(eng.drawable_chunks() == 1089 and buckets == 121, "the drain or the upload is not the reference's")
    t0 = time.perf_counter()
    for _ in range(FLY_FRAMES):
        eng.tick(1.0 / 30.0, move=(0.0, 0.0, 2.0))
    img = eng.present()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    ms = wall / FLY_FRAMES * 1e3
    print(f"  {FLY_FRAMES} ticks + present: {ms:.3f} ms/frame ({wall:.4f} s), scheduler tick host time "
          f"{sched_s[0] / FLY_FRAMES * 1e3:.3f} ms/frame; mean nsamp {float(eng.fbs.nsamp.mean()):.2f}; "
          f"launches {launches}")
    check(launches["render_sample"] == FLY_FRAMES, f"{launches['render_sample']} K11 launches")
    check(launches["reproject"] + launches["static_blend"] == FLY_FRAMES, "not one K13 / K13s per tick")
    check(launches["static_blend"] == 1, "the first tick after the upload is not static (K13s)")
    check(launches["update_chunks"] >= buckets, "K10u launches")
    for name in ("atrous_denoise", "upscale2x", "present"):
        check(launches[name] == 1, f"{name}: {launches[name]} launches in one present")
    check(launches["accumulate"] == 0 and launches["scene_fields"] == 0, "K12 or K10 ran in the fly-through")
    check(img.shape == (1080, 1920, 3) and img.dtype == np.uint8, f"presented frame {img.shape} {img.dtype}")
    fbs = eng.fbs
    plain = tonemap.present_plain(denoise.upscale2x_plain(denoise.atrous_denoise_plain(
        fbs.color, fbs.albedo, fbs.normal, nsamp=fbs.nsamp))).cpu().numpy()
    n_diff = int((img != plain).sum())
    print(f"  the presented frame against the plain denoise -> upscale -> present chain: {n_diff} of "
          f"{img.size} channels differ; mean {img.mean():.2f}, std {img.std():.2f}")
    check(n_diff == 0, "the presented frame differs from the plain chain")
    check(img.std() > 5.0, "the presented frame is flat")

    eng.scheduler.tick = tick
    del eng
    torch.cuda.empty_cache()
    # the same 30 frames of a second engine, traced: the drain and the upload untraced; the
    # upload's buckets recorded and replayed through the plain version from the empty scene
    eng = Engine(cfg)
    eng.scheduler.drain()
    calls, update = [], brickmap.update_chunks

    def recorded(scene, *args):
        calls.append(args)
        return update(scene, *args)

    brickmap.update_chunks = recorded
    try:
        eng._upload_new_chunks()
    finally:
        brickmap.update_chunks = update
    replay = brickmap.empty_scene(eng.scene.dims[0], *eng.window_origin, device=eng.device)
    for args in calls:
        replay.flat.copy_(brickmap.update_chunks_plain(replay, *args))
    n_diff = int((replay.flat != eng.scene.flat).sum())
    print(f"  a second engine's upload ({len(calls)} K10u buckets) replayed through update_chunks_plain from "
          f"the empty scene: {n_diff} of {replay.flat.numel()} words differ")
    check(len(calls) == 121 and n_diff == 0, "the uploaded scene differs from the plain replay of its buckets")
    del replay
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(FLY_FRAMES):
            eng.tick(1.0 / 30.0, move=(0.0, 0.0, 2.0))
        traced_img = eng.present()
        traced_wall = time.perf_counter() - t0
    check(np.array_equal(traced_img, img), "the traced fly-through presents another frame")
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if spans:
        busy, reach, by_stage = 0.0, float("-inf"), {}
        for a, b, name in spans:
            busy += max(0.0, b - max(a, reach))
            reach = max(reach, b)
            stage = next((st for k, st in STAGE_OF_KERNEL if k in name), None)
            if stage is None:
                stage = "copies" if "emcpy" in name or "emset" in name else "generation and other"
            by_stage[stage] = by_stage.get(stage, 0.0) + (b - a)
        print(f"  the same {FLY_FRAMES} frames traced ({traced_wall * 1e3:.3f} ms under the profiler, the same "
              f"frame presented): {len(spans)} device events, device busy {busy / 1e3:.3f} ms of the clean run's "
              f"{wall * 1e3:.3f} ms, idle share {1 - busy / 1e3 / (wall * 1e3):.1%}; device ms per frame by "
              "stage: " + ", ".join(f"{k} {v / 1e3 / FLY_FRAMES:.4f}"
                                    for k, v in sorted(by_stage.items(), key=lambda kv: -kv[1])))
    else:
        print("  traced fly-through: the profiler recorded no device events; idle share: not measured")
    del prof
    return launches, eng


# -- the debug renderer and the entry points (phases 15-16) ------------------------------
#: f32 operations of K17 per pixel besides its DDA steps: the camera ray, eight fog
#: samples (position, expf, the in-scatter sum), the fog amount and its horizon sky
#: (sky_color without clouds or stars), the blend and the bright pass; per hit the
#: material, the tint's three sin hashes and the Lambert terms; per miss the sky with
#: stars (plus the cloud march, CLOUD_OPS, where dy >= 0.04); per pixel and blur pass 9
#: taps of 3 channels, a multiply and an add each
DEBUG_FRAME = (1080, 1920)  # K17's frame (height, width)
DEMO_FRAME = (360, 640)  # generate_demo --render's default frame
DEBUG_PIXEL_OPS = 500
DEBUG_HIT_OPS = 150
DEBUG_SKY_OPS = 500
BLUR_PASS_OPS = 2 * 9 * 3


def glow_scene(scene10, blocks10, cam, dev):
    """The 10x10 bench scene with glowstone at the voxels that the 1080p camera's primary
    rays hit in a grid of 16x16-pixel patches (one in four across and down): emissive
    blocks in view, which the debug renderer lights past its bloom threshold."""
    from mega_minecraft_tpu_torch.render import brickmap, camera, tracer
    from mega_minecraft_tpu_torch.world.blocks import Block

    H, W = DEBUG_FRAME
    z = torch.zeros((H, W), dtype=torch.float32, device=dev)
    d = camera.pixel_rays(cam, W, H, (z, z))
    o = [cam.position[k].expand(H, W).contiguous() for k in range(3)]
    res = tracer.trace(scene10, *o, *d, torch.zeros((H, W), dtype=torch.uint8, device=dev))
    iy, ix = torch.meshgrid(torch.arange(H, device=dev), torch.arange(W, device=dev), indexing="ij")
    cell = max(1, H // 64)  # 16 pixels at 1080p
    pick = res.hit & ((ix // cell) % 4 == 0) & ((iy // cell) % 4 == 0)
    n = (res.nx, res.ny, res.nz)
    v = [torch.floor(o[k] + d[k] * res.t - n[k] * 0.5)[pick].long() - scene10.origin[k] for k in range(3)]
    vol = brickmap.scene_volume(blocks10).clone()
    vol[v[2], v[0], v[1]] = int(Block.GLOWSTONE)
    cz, cx = blocks10.shape[:2]
    chunks = vol.reshape(cz, 16, cx, 16, vol.shape[2]).permute(0, 2, 1, 3, 4).contiguous()
    return brickmap.build_scene(chunks, -5, -5), int(pick.sum())


def k17_counts(scene, cam, dev, steps, H, W):
    """(bytes, operations) of one K17 frame: the frame written once and the field words
    its DDA steps read (at most the field); the steps' and rays' operations (the primary
    and eight fog rays a pixel, the shadow ray of each hit), the per-pixel, per-hit and
    per-miss arithmetic, the cloud march of the misses that look up, the ten blur passes."""
    from mega_minecraft_tpu_torch.render import camera, tracer

    z = torch.zeros((H, W), dtype=torch.float32, device=dev)
    d = camera.pixel_rays(cam, W, H, (z, z))
    o = [cam.position[k].expand(H, W).contiguous() for k in range(3)]
    res = tracer.trace(scene, *o, *d, torch.zeros((H, W), dtype=torch.uint8, device=dev))
    hits = int(res.hit.sum())
    clouds = int((~res.hit & (d[1] >= 0.04)).sum())
    n_px, n_steps = H * W, int(steps.sum())
    rays = 9 * n_px + hits
    ops = (n_steps * DDA_STEP_OPS + rays * DDA_RAY_OPS + n_px * (DEBUG_PIXEL_OPS + 10 * BLUR_PASS_OPS)
           + hits * DEBUG_HIT_OPS + (n_px - hits) * DEBUG_SKY_OPS + clouds * CLOUD_OPS)
    return n_px * 3 * 4 + min(n_steps, scene.flat.numel()) * 4 + 30 * 4, ops, hits, clouds


def library_bloom(bright):
    """The bloom half as PyTorch calls: per stride 1-16 a horizontal and a vertical
    ``F.pad(mode="circular")`` + depthwise ``F.conv2d`` with the 9-tap weights, on
    [1, 3, H, W] (the yardstick of the Library column; the port never calls it)."""
    import torch.nn.functional as F

    from mega_minecraft_tpu_torch.render import debug_renderer as dr

    w = dr.BLOOM_WEIGHTS
    taps = torch.tensor([w[4], w[3], w[2], w[1], w[0], w[1], w[2], w[3], w[4]], dtype=torch.float32,
                        device=bright.device)
    kh = taps.view(1, 1, 1, 9).expand(3, 1, 1, 9).contiguous()
    kv = taps.view(1, 1, 9, 1).expand(3, 1, 9, 1).contiguous()
    x = bright
    for p in range(dr.BLOOM_PASSES):
        s = 1 << p
        x = F.conv2d(F.pad(x, (4 * s, 4 * s, 0, 0), mode="circular"), kh, dilation=(1, s), groups=3)
        x = F.conv2d(F.pad(x, (0, 0, 4 * s, 4 * s), mode="circular"), kv, dilation=(s, 1), groups=3)
    return x


def debug_phase(dev, stamp, err, smi, sc):
    """Phase 15: K17 against render_debug_plain bit for bit at 1920x1080 (with the same
    DDA step counts) on the 10x10 bench scene and the featured 33x33 scene, by day with
    no tint, the chunk and the zone tint, and at night, and on the 10x10 scene with
    glowstone in view (the bright pass not empty); one launch count for one call; timed
    warm with CUDA events (kernel, plain version, and the library's bloom); the split of
    the kernel's device time between its shading and its blur launches (torch.profiler).
    Returns ((launches, (ms, plain ms), (bound ms, by)), library ms)."""
    from mega_minecraft_tpu_torch import kernels
    from mega_minecraft_tpu_torch.render import debug_renderer as dr

    sys.path.insert(0, str(ROOT / "tests"))
    from test_torch_cuda import bright_pass_recorder

    stamp("phase 15: K17 (render_debug) against its plain version at 1920x1080: both scenes, day with "
          "every tint, night, and glowstone in view")
    H, W = DEBUG_FRAME
    cam, day, night = sc["cam"], sc["day"], sc["night"]
    scene_glow, n_glow = glow_scene(sc["scene10"], sc["blocks10"], cam, dev)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    frame = dr.render_debug(sc["scene10"], cam, day, H, W)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    print(f"  launch counts of one render_debug: {launches}")
    for name, count in launches.items():
        check(count == int(name == "render_debug"), f"kernel {name}: {count} launches in one render_debug")
    check(tuple(frame.shape) == (H, W, 3) and bool(torch.isfinite(frame).all()) and float(frame.min()) >= 0.0,
          "the debug frame is not finite and non-negative")
    cases = [(f"{tag} {sky_name} tint={tint}", scene, params, tint)
             for tag, scene in (("10x10", sc["scene10"]), ("33x33", sc["scene33"]))
             for sky_name, params, tints in (("day", day, ("none", "chunk", "zone")), ("night", night, ("none",)))
             for tint in tints]
    cases.append((f"10x10 glowstone ({n_glow} pixels' voxels) day tint=none", scene_glow, day, "none"))
    e, steps = 0.0, {}
    for tag, scene, params, tint in cases:
        got, gst = kernels.render_debug(scene, cam, params, H, W, dr.TINT_CELLS[tint], want_steps=True)
        with bright_pass_recorder() as bright:
            want, wst = dr.render_debug_plain(scene, cam, params, H, W, tint, want_steps=True)
        check(bool(torch.isfinite(got).all()), f"K17 {tag}: non-finite values")
        n_diff = int((got.view(torch.int32) != want.view(torch.int32)).sum())
        mx = float((got.double() - want.double()).abs().max())
        n_bright = int(bright[0].sum())
        print(f"  K17 {tag}: {n_diff} of {got.numel()} values differ (max |diff| {mx:g}); DDA steps equal: "
              f"{torch.equal(gst, wst)}, {int(wst.sum())} in all, {float(wst.double().mean()):.2f} a pixel; "
              f"bright pass {n_bright} pixels; mean {got.mean(dim=(0, 1)).tolist()}")
        check(n_diff == 0, f"K17 {tag}: {n_diff} values differ from the plain version")
        check(torch.equal(gst, wst), f"K17 {tag}: DDA step counts differ from the plain version")
        if tag == "10x10 day tint=none":
            check(torch.equal(frame, got), "K17: the counted render_debug call differs from the compared launch")
        if "glowstone" in tag:
            check(n_bright > 0, f"K17 {tag}: the bright pass is empty")
            bright_img = torch.where(bright[0][..., None], want, 0.0)
        e = max(e, mx)
        steps[tag] = wst
    err["render_debug"] = e

    tag10 = "10x10 day tint=none"
    k_ms, p_ms = [], []
    for _ in range(2):  # turns: plain, kernel, kernel, plain
        p_ms.append(cuda_ms(lambda: dr.render_debug_plain(sc["scene10"], cam, day, H, W), 1))
        k_ms.append(cuda_ms(lambda: dr.render_debug(sc["scene10"], cam, day, H, W), 10))
    k33 = cuda_ms(lambda: dr.render_debug(sc["scene33"], cam, day, H, W), 10)
    x = bright_img.permute(2, 0, 1)[None].contiguous()
    lib = library_bloom(x)[0].permute(1, 2, 0)
    blur = bright_img
    for p in range(dr.BLOOM_PASSES):
        blur = dr._gauss_blur(blur, 1 << p)
    rel = float((lib - blur).abs().max() / blur.abs().max())
    check(rel <= 1e-5, f"the library bloom differs from the plain blur by {rel} of its largest value")
    lib_ms = cuda_ms(lambda: library_bloom(x), 10)
    nb, ops, hits, clouds = k17_counts(sc["scene10"], cam, dev, steps[tag10], H, W)
    b_ms, b_by = bound(nb, ops)
    b33 = bound(*k17_counts(sc["scene33"], cam, dev, steps["33x33 day tint=none"], H, W)[:2])
    kernel_ms, plain_ms = sum(k_ms) / 2, sum(p_ms) / 2
    print(f"  K17 on {smi}, {W}x{H} day: 10x10 {k_ms[0]:.3f} / {k_ms[1]:.3f} ms (plain {p_ms[0]:.1f} / "
          f"{p_ms[1]:.1f} ms), bound {b_ms:.4g} ms by {b_by} ({b_ms / kernel_ms:.1%} of it; {hits} hits, "
          f"{clouds} cloud marches, {ops:.4g} operations, {nb} bytes); 33x33 {k33:.3f} ms, bound "
          f"{b33[0]:.4g} ms by {b33[1]}; the library's bloom (10 x F.pad + F.conv2d) {lib_ms:.4f} ms, within "
          f"{rel:.2g} of the largest value of the plain blur")

    reps = 6
    split, kept = device_ms(lambda: dr.render_debug(sc["scene10"], cam, day, H, W),
                            {"debug_shade_kernel": 1, "blur_kernel": 10}, reps)
    if split is not None:
        print(f"  K17's device ms a frame by launch (torch.profiler over {reps} 10x10 day frames, the means "
              f"of the launches it kept, {kept}+ a kernel): shading {split['debug_shade_kernel']:.4f}, bloom "
              f"(10 blur launches) {split['blur_kernel']:.4f}")
    else:
        print(f"  K17 traced: the profiler kept {kept} launches of a kernel over {reps} frames; the split: "
              "not measured")
    del scene_glow
    return (launches["render_debug"], (kernel_ms, plain_ms), (b_ms, b_by)), lib_ms


def decode_png(data):
    """[H, W, 3] u8 of an RGB8 PNG with filter-0 scanlines (what viewer.encode_png writes)."""
    import struct
    import zlib

    check(data[:8] == b"\x89PNG\r\n\x1a\n", "not a PNG")
    pos, idat, size = 8, b"", None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            size = struct.unpack(">II", body[:8])
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    w, h = size
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    check(not rows[:, 0].any(), "a scanline filter other than 0")
    return rows[:, 1:].reshape(h, w, 3)


def entry_points_phase(dev, stamp, smi, eng):
    """Phase 16: ``generate_demo.main(["--device", "cuda", "--render", ...])`` at its
    defaults (5x5 chunks, 640x360, 8 samples) with the counts reset around it (K10 1,
    K11 8, K12 8, K14 1, K16 1) and its file decoded; the viewer's ``routed_tick`` on phase
    14's engine under a scripted input (held w + shift, the arrows, the events p [ ] k f),
    then ``encode_png`` of the presented frame decoded again and held equal to it; the
    mesher on the middle chunk of the demo's 5x5 area, native against numpy."""
    from mega_minecraft_tpu_torch import kernels, native
    from mega_minecraft_tpu_torch.app import generate_demo, viewer
    from mega_minecraft_tpu_torch.render import meshing
    from mega_minecraft_tpu_torch.terrain import pipeline

    stamp("phase 16: the entry points: generate_demo --render on the card, the viewer's routed tick on the "
          "fly-through's engine, the mesher")
    path = ROOT / "build" / "chip_smoke" / "demo.ppm"
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    rc = generate_demo.main(["--device", "cuda", "--render", str(path)])
    torch.cuda.synchronize()
    demo_s = time.perf_counter() - t0
    launches = kernels.launch_counts()
    print(f"  generate_demo --render: rc {rc} in {demo_s:.3f} s on {smi}; launches {launches}")
    check(rc == 0, f"generate_demo returned {rc}")
    for name, want in (("scene_fields", 1), ("render_sample", 8), ("accumulate", 8), ("atrous_denoise", 1),
                       ("present", 1)):
        check(launches[name] == want, f"generate_demo --render: {launches[name]} {name} launches, not {want}")
    data = path.read_bytes()
    h, w = DEMO_FRAME
    head = b"P6\n%d %d\n255\n" % (w, h)
    check(data[:len(head)] == head and len(data) == len(head) + w * h * 3,
          f"{path.name}: not a {w}x{h} binary PPM ({data[:16]!r}, {len(data)} bytes)")
    img = np.frombuffer(data[len(head):], np.uint8).reshape(h, w, 3)
    print(f"  {path.name}: {w}x{h}x3, min / max / mean {img.min()} / {img.max()} / {img.mean():.3f}")
    check(img.std() > 5.0, "the demo's frame is flat")

    state, logs = viewer.InputState(), []
    script = [{"held": ["w", "shift"]}, {"held": ["w", "shift"]}, {"held": ["arrowleft", "arrowup"]},
              {"held": ["arrowright", "arrowdown"], "dtheta": 0.05}, {"held": [], "events": ["p", "[", "]", "k", "f"]}]
    pos0, theta0 = eng.player.pos.copy(), eng.player.theta
    paused0, freecam0, sun0 = eng.time_paused, eng.freecam, eng.sun_time
    dt = 1.0 / 30.0
    kernels.reset_launch_counts()
    for msg in script:
        state.update(msg)
        viewer.routed_tick(eng, state, dt, log=logs.append)
    frame = eng.present()
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    moved = float(eng.player.pos[2] - pos0[2])
    print(f"  viewer.routed_tick x {len(script)}: moved {moved:.4f} blocks along z, theta {theta0:.3f} -> "
          f"{eng.player.theta:.3f}, paused {paused0} -> {eng.time_paused}, freecam {freecam0} -> "
          f"{eng.freecam}, sun_time {sun0:.4f} -> {eng.sun_time:.4f}; log {logs}; launches {launches}")
    check(abs(moved - 2 * 10.0 * 8.0 * dt) < 1e-3, f"w + shift moved the player {moved} blocks")
    check(abs(eng.player.theta - (theta0 + 0.05)) < 1e-6, "the arrows and the mouse did not rotate as routed")
    check(eng.time_paused != paused0 and eng.freecam != freecam0, "the p / f events were not routed")
    check(any("player position" in str(m) for m in logs), "the k event logged no position")
    check(launches["render_sample"] == len(script), f"{launches['render_sample']} K11 launches in "
          f"{len(script)} routed ticks")
    png = viewer.encode_png(frame)
    back = decode_png(png)
    check(back.shape == frame.shape and np.array_equal(back, frame), "encode_png does not round-trip")
    print(f"  encode_png of the {frame.shape[1]}x{frame.shape[0]} presented frame: {len(png)} bytes, decoded "
          f"equal; mean {frame.mean():.2f}")

    area = pipeline.generate_area(-2, -2, 5, 5, device=dev)["blocks"].cpu().numpy()
    blocks = area[2, 2]
    nbs = {(1, 0): area[2, 3], (-1, 0): area[2, 1], (0, 1): area[3, 2], (0, -1): area[1, 2]}
    have_native = native.available()
    t0 = time.perf_counter()
    mesh = meshing.mesh_chunk(blocks, nbs, (0, 0))
    mesh_s = time.perf_counter() - t0
    faces = native.extract_faces(blocks, nbs)
    extract = native.extract_faces
    try:
        native.extract_faces = lambda b, n: None
        plain = meshing.mesh_chunk(blocks, nbs, (0, 0))
    finally:
        native.extract_faces = extract

    def rows(m):
        k = len(m["positions"]) // 4 * 4
        r = np.concatenate([m["positions"][:k].reshape(-1, 12), m["normals"][:k].reshape(-1, 12),
                            m["uvs"][:k].reshape(-1, 8), m["mats"][:k].reshape(-1, 4).astype(np.float32)], axis=1)
        return r[np.lexsort(r.T[::-1])]

    same = all(len(mesh[k]) == len(plain[k]) for k in mesh) and np.array_equal(rows(mesh), rows(plain))
    n_faces = len(mesh["indices"]) // 6
    print(f"  mesher on chunk (0, 0) of the 5x5 area: native available {have_native} "
          f"({None if faces is None else len(faces[1])} faces from the native scan), {n_faces} quads, "
          f"{len(mesh['positions'])} vertices in {mesh_s:.3f} s; native path equal to the numpy path: {same}")
    check(n_faces > 0 and same, "the mesher's native and numpy paths differ")


# -- the sharded programs (phase 17) ----------------------------------------------------------
SHARD_COUNTS = (1, 2, 4, 8)  # virtual shards of the erosion mesh (the card repeated)
DP_AREA = (-16, -16, 32, 32)  # dp_generate's chunks: a 32x32 area at chunk (-16, -16)
K9B_OPS = 40  # f32 operations of one column's sweep (8 neighbours, max, min, the sums)
SHARD_FRAME = (1080, 1920)  # sharded_render's frame (height, width)
K2H_LAUNCHES = {"heightfield_window_kernel": 1, "layers_window_kernel": 1}  # K2h's launches a call


def device_ms(fn, launches, reps):
    """Device time of one call of ``fn`` by kernel, under torch.profiler over ``reps`` calls.
    ``launches`` maps a kernel's name (a part of it) to its launches a call; its time a call
    is the mean span of the launches the profiler kept (it drops a trace's first ones) times
    that count.  Returns ({name: ms}, or None when a kernel kept fewer than half its
    launches; the fewest launches a kernel kept)."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    spans = {k: [] for k in launches}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            for k in spans:
                if k in ev.name:
                    spans[k].append(ev.time_range.end - ev.time_range.start)
    fewest = min(len(v) for v in spans.values())
    if any(2 * len(spans[k]) < max(1, reps * n) for k, n in launches.items()):
        return None, fewest
    return {k: sum(v) / len(v) * launches[k] / 1e3 for k, v in spans.items()}, fewest


def fmt_ms(measured):
    """A call's device time, all its kernels, from ``device_ms``."""
    ms, n = measured
    return f"not measured ({n} launches kept)" if ms is None else f"{sum(ms.values()):.4f} ms, {n}+ launches kept"


def k2h_counts(pos, w, ls):
    """(bytes, operations) of K2h on ``pos``: the positions read and the outputs written
    once; K1's operations per column (from the inner weights) times 324 / 256 for the
    window, plus K2's per column."""
    from mega_minecraft_tpu_torch.world import biomes as bio

    cols = pos.shape[0] * 256
    per_biome = (w > 0).sum(dim=(0, 2, 3)).tolist()
    k1 = cols * (11 * SIMPLEX2 + 150 + 24 * 6)
    for b in bio.Biome:
        s2, w2 = HEIGHT_FORMULA.get(b.name, (5, 0))
        k1 += per_biome[int(b)] * (s2 * (SIMPLEX2 + 5) + w2 * WORLEY2 + 3)
    return nbytes(pos) + cols * 4 * (1 + 24 + 20), k1 * 324 / 256 + cols * (960 + 11 * fbm2_ops(5) + 400)


def sharded_phase(dev, stamp, err, smi, sc):
    """Phase 17: the sharded programs of ``parallel/sharding.py`` on meshes that repeat the
    card (``Mesh([cuda:0] * n)``: every shard's kernels, halo copies and flag reads run for
    real; the split's cost, not any scaling), and on a mesh of every card when there are
    several.  Each program's main run has the counts reset around it.  Returns
    (launches, times, bounds) of K2h and K9b."""
    from mega_minecraft_tpu_torch import kernels
    from mega_minecraft_tpu_torch.parallel import sharding
    from mega_minecraft_tpu_torch.render import tracer
    from mega_minecraft_tpu_torch.terrain import erosion, pipeline
    from mega_minecraft_tpu_torch.world.blocks import Block

    def only(launches, want, tag):
        for name, count in launches.items():
            check(count == want.get(name, 0), f"{tag}: kernel {name} launched {count} times, "
                  f"not {want.get(name, 0)}")

    meshes = {n: sharding.Mesh([dev] * n) for n in SHARD_COUNTS}
    launches, times, bounds = {}, {}, {}

    stamp("phase 17: the sharded programs: dp_generate over 1 and 4 shards (1,024 chunks), "
          "erode_zone_sharded over 1, 2, 4, 8 shards, sharded_render at 1080p over 4 and 8")
    # -- data-parallel generation
    pos = pipeline.chunk_positions(*DP_AREA, device=dev)
    area = pipeline.generate_area_fused(pipeline.chunk_positions(DP_AREA[0] - 1, DP_AREA[1] - 1,
                                                                 DP_AREA[2] + 2, DP_AREA[3] + 2,
                                                                 device=dev), DP_AREA[2], DP_AREA[3])
    check(torch.equal(area["chunk_pos"], pos), "the area path's chunk order differs")
    empty = torch.full((pos.shape[0], 16, 16, 32), 384, dtype=torch.int32, device=dev)
    want_blocks = fill_k(area["heightfield"], area["biome_weights"], area["layers"], empty, empty, pos)
    for n in (1, 4):
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        blocks = sharding.dp_generate(meshes[n], pos)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        only(counts, {"dp_layers": n, "fill": n}, f"dp_generate over {n}")
        if n == 4:
            launches["dp_layers"] = counts["dp_layers"]
        check_equal(f"dp_generate over {n} shards: blocks vs K4 with no caves on the area path's "
                    "K1 / K2 outputs", blocks, want_blocks)
    hf, w, ls = kernels.dp_layers(pos)
    for name, got, key in (("hf", hf, "heightfield"), ("weights", w, "biome_weights"), ("layers", ls, "layers")):
        n_diff = int((got.view(torch.int32) != area[key].view(torch.int32)).sum())
        print(f"  K2h {name} over 1,024 chunks vs the area path's: {n_diff} of {got.numel()} differ (bits)")
        check(n_diff == 0, f"K2h {name} differs from the area path's")
    # K2h against its plain version at the main path's shapes: the 1,024 chunks of one shard,
    # and the 256 of a shard of four (the first 256, equal to the same chunks of the 1,024)
    b4 = pos[:256].contiguous()
    k256 = kernels.dp_layers(b4)
    err["dp_layers"] = max(check_close(f"K2h {k} (1,024 chunks) vs plain", g, wnt)
                           for k, g, wnt in zip(("hf", "weights", "layers"), (hf, w, ls),
                                                sharding.gen_stage_layers_plain(pos)))
    for name, got, want in zip(("hf", "weights", "layers"), k256, (hf, w, ls)):
        check_equal(f"K2h {name} on 256 chunks vs the same chunks of the 1,024-chunk launch",
                    got.view(torch.int32), want[:256].view(torch.int32))
    check(bool((want_blocks[..., 0] == int(Block.BEDROCK)).all()), "dp blocks: a column lacks bedrock")
    print(f"  dp blocks: {float((want_blocks == int(Block.AIR)).double().mean()):.4f} air, bedrock at "
          "y = 0 in every column")

    # -- row-banded erosion
    ge = np.load(EROSION_GOLDEN)
    pos_h = pipeline.chunk_positions(-1, -1, 26, 26, device=dev)
    hf_h, w_h = kernels.heightfield(pos_h)
    st = kernels.layers(hf_h, w_h, pos_h, 24, 24, fix_backward=False)
    grids = {key: torch.as_tensor(ge[f"input_{key}"], device=dev) for key in ("0_0", "400_-560")}
    grids["area"] = erosion.gather_zone_layers(st["layers"].reshape(24, 24, 20, 16, 16),
                                               st["heightfield"].reshape(24, 24, 16, 16)).contiguous()
    extra = {}
    if torch.cuda.device_count() > 1:
        extra[f"{torch.cuda.device_count()} cards"] = sharding.make_mesh()
    err["erosion_band"] = 0.0
    for key, grid in grids.items():
        want, iters = kernels.erode_zone(grid)
        iters = iters.tolist()
        for tag, mesh in [(f"{n} x cuda:0", meshes[n]) for n in SHARD_COUNTS] + list(extra.items()):
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            sweeps = []
            got = sharding.erode_zone_sharded(mesh, grid, sweeps)
            torch.cuda.synchronize()
            counts = kernels.launch_counts()
            only(counts, {"erosion_band": mesh.size * sum(sweeps)}, f"erode_zone_sharded {key} {tag}")
            if key == "area" and mesh is meshes[4]:
                launches["erosion_band"] = counts["erosion_band"]
            n_diff = int((got.view(torch.int32) != want.view(torch.int32)).sum())
            check(got.device == mesh.devices[0] and n_diff == 0 and sweeps == iters,
                  f"erode_zone_sharded {key} over {tag}: {n_diff} values differ from K9, sweeps "
                  f"{sweeps} vs {iters}")
        print(f"  erode_zone_sharded {key} over {list(SHARD_COUNTS)} x cuda:0"
              f"{' and ' + ', '.join(extra) if extra else ''}: equal to K9 bit for bit, sweeps "
              f"{iters} ({sum(iters)})")
    # K9b against its plain version on one inner band of 96 rows (rows 96-191 of the area
    # grid, layer 7 and its end), a first sweep with sums and a later one
    g = grids["area"]
    rows = 96
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    acc_in = (torch.rand((rows + 2, 384), generator=gen) * 2.0).to(dev)
    bufs = {"start": g[7, rows - 1:2 * rows + 1].contiguous(), "end": g[8, rows - 1:2 * rows + 1].contiguous()}
    for first in (True, False):
        outs = []
        for fn in (kernels.erosion_band, sharding.erosion_band_plain):
            acc_out = acc_in.clone() if not first else torch.zeros_like(acc_in)
            dst = torch.zeros_like(acc_in)
            flags = torch.tensor([0, 5], dtype=torch.int32, device=dev)
            fn(bufs["start"], bufs["end"], acc_in if first else None, acc_out, dst, False, False, 7, flags, 0)
            outs.append((dst[1:rows + 1], acc_out[1:rows + 1], flags))
        for name, a, b in zip(("layer", "sums", "flags"), *outs):
            n_diff = int((a.view(torch.int32) != b.view(torch.int32)).sum())
            check(n_diff == 0, f"K9b {'first' if first else 'later'} sweep {name}: {n_diff} differ from plain")
        moved = int((outs[0][0] != bufs["start"][1:rows + 1]).sum())
        print(f"  K9b {'first' if first else 'later'} sweep on rows 96-191 vs plain: layer, sums and flags "
              f"equal (bits); {moved} columns moved, flags {outs[0][2].tolist()}")
        check(moved > 0, "K9b moved no column: the check compares nothing")

    # -- row-banded rendering
    cam, day = sc["cam"], sc["day"]
    H, W = SHARD_FRAME
    for tag, scene in (("10x10", sc["scene10"]), ("33x33", sc["scene33"])):
        whole = tracer.render_sample(scene, cam, day, H, W, 3)
        for n in (4, 8):
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            got = sharding.sharded_render(meshes[n], scene, cam, day, H, W, 3)
            torch.cuda.synchronize()
            only(kernels.launch_counts(), {"render_sample": n}, f"sharded_render {tag} over {n}")
            for name, a, b in zip(("color", "albedo", "normal"), got, whole):
                n_diff = int((a.view(torch.int32) != b.view(torch.int32)).sum())
                check(n_diff == 0, f"sharded_render {tag} over {n}: {name}: {n_diff} values differ")
        print(f"  sharded_render {tag} 1920x1080 over 4 and 8 bands: color, albedo, normal equal to the "
              f"whole frame (bits), one K11 launch a band")
    del whole, got

    # -- times (warm, CUDA events; the erosion and dp times include their host syncs)
    print(f"  times on {smi}:")
    for tag, p_ in (("16", pos[:16].contiguous()), ("256 (a shard of 4)", b4), ("1,024", pos)):
        k_ms = cuda_ms(lambda: kernels.dp_layers(p_), 20)
        dev_ms = device_ms(lambda: kernels.dp_layers(p_), K2H_LAUNCHES, 20)
        hf_, w_, ls_ = kernels.dp_layers(p_)
        b_ms, b_by = bound(*k2h_counts(p_, w_, ls_))
        print(f"    K2h {tag} chunks: {k_ms:.4f} ms a call (device {fmt_ms(dev_ms)}), bound {b_ms:.4g} ms "
              f"by {b_by} ({b_ms / k_ms:.1%} of it)")
        if p_ is b4:
            times["dp_layers"] = (k_ms, cuda_ms(lambda: sharding.gen_stage_layers_plain(b4), 1))
            bounds["dp_layers"] = (b_ms, b_by)
    k1_ms = cuda_ms(lambda: kernels.heightfield(pos), 20)
    print(f"    (K1 alone on the same 1,024 chunks: {k1_ms:.4f} ms; K2h plain on 256 chunks "
          f"{times['dp_layers'][1]:.3f} ms)")
    for n in (1, 4):
        ms = cuda_ms(lambda: sharding.dp_generate(meshes[n], pos), 5)
        print(f"    dp_generate 1,024 chunks over {n} shard(s): {ms:.3f} ms = {1024 / (ms / 1e3):.1f} chunks/s")
    later = dict(start=bufs["start"], end=bufs["end"], acc_in=None, acc_out=torch.zeros_like(acc_in),
                 dst=torch.zeros_like(acc_in), top_edge=False, bottom_edge=False, rel=7,
                 flags=torch.zeros(2, dtype=torch.int32, device=dev), k=1)
    first_args = dict(later, acc_in=acc_in)
    kb_ms = cuda_ms(lambda: kernels.erosion_band(**later), 50)
    kf_ms = cuda_ms(lambda: kernels.erosion_band(**first_args), 50)
    kb_dev = device_ms(lambda: kernels.erosion_band(**later), {"erosion_band_kernel": 1}, 50)
    kf_dev = device_ms(lambda: kernels.erosion_band(**first_args), {"erosion_band_kernel": 1}, 50)
    pb_ms = cuda_ms(lambda: sharding.erosion_band_plain(**later), 5)
    col = rows * 384
    times["erosion_band"] = (kb_ms, pb_ms)
    bounds["erosion_band"] = bound(5 * col * 4, col * K9B_OPS)
    bf = bound(7 * col * 4, col * (K9B_OPS + 18))
    print(f"    K9b one later sweep of a 96-row band: {kb_ms:.4f} ms a call (device {fmt_ms(kb_dev)}), bound "
          f"{bounds['erosion_band'][0]:.4g} ms by {bounds['erosion_band'][1]}; first sweep {kf_ms:.4f} ms "
          f"(device {fmt_ms(kf_dev)}; bound {bf[0]:.4g} by {bf[1]}); plain {pb_ms:.3f} ms")
    for key in ("area", "400_-560"):
        grid = grids[key]
        k9 = cuda_ms(lambda: kernels.erode_zone(grid), 20)
        parts = []
        for n in SHARD_COUNTS:
            parts.append(f"{n}: {cuda_ms(lambda: sharding.erode_zone_sharded(meshes[n], grid), 5):.3f}")
        print(f"    zone {key}: K9 {k9:.4f} ms; erode_zone_sharded ms per zone by shards, "
              + ", ".join(parts))
    for tag, scene in (("10x10", sc["scene10"]), ("33x33", sc["scene33"])):
        k11 = cuda_ms(lambda: tracer.render_sample(scene, cam, day, H, W, 3), 5)
        parts = [f"{n} bands {cuda_ms(lambda: sharding.sharded_render(meshes[n], scene, cam, day, H, W, 3), 5):.3f}"
                 for n in (4, 8)]
        print(f"    1080p frame {tag}: whole-frame K11 {k11:.3f} ms; sharded_render " + ", ".join(parts) + " ms")
    return launches, times, bounds


def main(argv):
    p = argparse.ArgumentParser(description="Drive the PyTorch/CUDA port once on one GPU.")
    p.add_argument("--ptxas", action="store_true", help="print nvcc -Xptxas -v output")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is false: chip_smoke needs a CUDA GPU")

    from mega_minecraft_tpu_torch import kernels
    from mega_minecraft_tpu_torch.app.generate_demo import FEATURE_BLOCKS, histogram_lines
    from mega_minecraft_tpu_torch.kernels import _build
    from mega_minecraft_tpu_torch.terrain import (caves, decorators, feature_placement as fp,
                                                  features, fill, gather, heightfield, layers,
                                                  pipeline)

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    def stamp(msg):
        print(f"[{time.perf_counter() - t_start:6.1f} s] {msg}", flush=True)

    # -- 1. device --------------------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")

    # -- 2. build -----------------------------------------------------------------------
    _, build_s, built = _build.build(verbose=args.ptxas)
    _build.load()
    stamp(f"phase 2: kernels built in {build_s:.1f} s (nvcc ran: {built})")

    rng = np.random.default_rng(SEED)
    seeded = [tuple(int(v) * 16 for v in rng.integers(-4096, 4096, 2)) for _ in range(2)]
    origins = GOLDEN_CHUNKS + seeded
    err = {}

    def stage_checks(tag, hf_in, w_in, ls_in, cv_p, pos_in, bl_p, areas):
        """K5-K8 and the stream pre-kernel against their plain versions on one batch of
        chunks; ``areas`` lists (first chunk, ncx, ncz) of the areas K7 is applied over.
        Updates ``err``; returns the plain chain's (lists, featured blocks, final blocks)."""
        args5 = (hf_in, w_in, ls_in, cv_p["starts"], cv_p["ends"], cv_p["bottom_biome"],
                 cv_p["top_biome"], pos_in)
        pl_p = fp.generate_placements_plain(*args5)
        e5 = check_k5(tag, args5, pl_p)
        lists_p = fp.compact_placements_plain(pl_p, pos_in)
        e6 = check_dict_equal(f"{tag} K6", kernels.compact_placements(pl_p, pos_in), lists_p)
        print(f"  {tag} placements per chunk: surface {lists_p['surface']['count'].tolist()}, "
              f"cave {lists_p['cave']['count'].tolist()}")
        # K7a into NaN-filled rows: its valid rows against the plain streams, and K7 below on
        # K7a's own rows, so that a row K7a skips and a consumer read would show
        st_k = nan_streams(lists_p)
        es = check_streams(tag, st_k, features.draw_streams_plain(lists_p["surface"], lists_p["cave"]), lists_p)
        feat_p, e7 = [], 0.0
        for i0, ncx, ncz in areas:
            nb = ncx * ncz
            sub = {kind: {k: v[i0 : i0 + nb].contiguous() for k, v in d.items()}
                   for kind, d in lists_p.items()}
            a = (bl_p[i0 : i0 + nb].contiguous(), sub["surface"], sub["cave"])
            pos_a = pos_in[i0 : i0 + nb].contiguous()
            want = features.apply_features_area_plain(*a, pos_a, ncx, ncz)
            got, got_lists = kernels.features(*a, st_k[0][i0 : i0 + nb].contiguous(),
                                              st_k[1][i0 : i0 + nb].contiguous(), pos_a, ncx, ncz,
                                              want_lists=True)
            n_feat = int((want != a[0]).sum())
            e7 = max(e7, check_equal(f"{tag} K7 area@{i0} ({n_feat} feature blocks)", got, want),
                     check_k7_lists(f"{tag} area@{i0}", got_lists,
                                    lambda kind, cull: features.cull_area_plain(
                                        sub[kind], pos_a, ncx, ncz, kind == "cave", cull), nb))
            feat_p.append(want)
        feat_p = torch.cat(feat_p)
        args8 = (feat_p, hf_in, w_in, cv_p["starts"], cv_p["ends"], cv_p["bottom_biome"], pos_in)
        dec_p = decorators.place_decorators_batch_plain(*args8)
        n_dec = int((dec_p != feat_p).sum())
        e8 = check_equal(f"{tag} K8 ({n_dec} decorator blocks)", kernels.decorators(*args8), dec_p)
        for k, v in (("placements", e5), ("compact_placements", e6), ("feature_streams", es),
                     ("features", e7), ("decorators", e8)):
            err[k] = max(err.get(k, 0.0), v)
        return lists_p, feat_p, dec_p

    # -- 3. kernels vs their plain versions, same inputs ---------------------------------
    stamp(f"phase 3: kernels vs plain versions on {origins}")
    pos7 = torch.tensor(origins, dtype=torch.int32, device=dev)
    hf_k, w_k = kernels.heightfield(pos7)
    hf_p, w_p = heightfield.generate_heightfield_plain(pos7)
    err["heightfield"] = max(check_close("K1 heightfield", hf_k, hf_p),
                             check_close("K1 weights", w_k, w_p))

    st_k, st_p = [], []
    for ox, oz in origins:
        ph = halo_positions(ox, oz, dev)
        hf_h, w_h = heightfield.generate_heightfield_plain(ph)
        st_k.append(kernels.layers(hf_h, w_h, ph, 1, 1))
        st_p.append(layers.layers_from_halo_plain(hf_h, w_h, ph, 1, 1))
    cat = lambda sts, k: torch.cat([s[k] for s in sts])  # noqa: E731
    err["layers"] = check_close("K2 layers", cat(st_k, "layers"), cat(st_p, "layers"))
    for k in ("heightfield", "biome_weights", "chunk_pos"):
        check(torch.equal(cat(st_k, k), cat(st_p, k)), f"K2 {k}: gather differs")
    hf_in, w_in, pos_in, ls_in = (cat(st_p, k) for k in ("heightfield", "biome_weights", "chunk_pos", "layers"))

    cv_p = caves.generate_caves_plain(hf_in, w_in, pos_in)
    err["caves"] = check_k3("on the golden and seeded chunks", hf_in, w_in, pos_in)

    bl_p = fill.fill_chunks_plain(hf_in, w_in, ls_in, cv_p["starts"], cv_p["ends"], pos_in)
    err["fill"] = check_k4("on the golden and seeded chunks", hf_in, w_in, ls_in, cv_p["starts"],
                           cv_p["ends"], pos_in)
    # K4 at far chunks, the last one's lush clay cells past 2^24 (their floats round)
    st_f = []
    for ox, oz in FAR_CHUNKS:
        ph = halo_positions(ox, oz, dev)
        st_f.append(layers.layers_from_halo_plain(*heightfield.generate_heightfield_plain(ph), ph, 1, 1))
    hf_f, w_f, ls_f, pos_f = (cat(st_f, k) for k in ("heightfield", "biome_weights", "layers", "chunk_pos"))
    cv_f = caves.generate_caves_plain(hf_f, w_f, pos_f)
    err["fill"] = max(err["fill"], check_k4(f"on the far chunks {FAR_CHUNKS}", hf_f, w_f, ls_f, cv_f["starts"],
                                            cv_f["ends"], pos_f))
    args5_f = (hf_f, w_f, ls_f, cv_f["starts"], cv_f["ends"], cv_f["bottom_biome"], cv_f["top_biome"], pos_f)
    err["placements"] = check_k5("far chunks", args5_f, fp.generate_placements_plain(*args5_f))

    stage_checks("7 chunks", hf_in, w_in, ls_in, cv_p, pos_in, bl_p,
                 [(i, 1, 1) for i in range(len(origins))])

    # the caps, which real terrain never reaches: a dense synthetic grid that overflows
    # K6's 1,024-entry cave list, and K7 on a 3x1 strip of stone chunks whose first chunk
    # claims the whole 2,048-entry gather of its own consumer
    print("  synthetic: K6 list overflow, K7 gather cap and cross-chunk priority")
    g = torch.Generator(device="cpu").manual_seed(SEED)
    r = lambda lo, hi, *shape: torch.randint(lo, hi, shape, generator=g, dtype=torch.int32)  # noqa: E731
    coin = lambda p_, *shape: torch.rand(shape, generator=g) < p_  # noqa: E731
    dense = {
        "surface_feature": r(0, 3, 2, 16, 16), "surface_y": r(60, 200, 2, 16, 16),
        "surface_replace": coin(0.5, 2, 16, 16),
        "cave_feature": r(1, 10, 2, 16, 16, 32, 2) * coin(0.12, 2, 16, 16, 32, 2),
        "cave_y": r(1, 140, 2, 16, 16, 32), "cave_height": r(1, 40, 2, 16, 16, 32),
        "cave_replace": coin(0.5, 2, 16, 16, 32, 2),
    }
    dense = {k: v.to(dev) for k, v in dense.items()}
    pos2 = torch.tensor([[32, -48], [-4096, 160]], dtype=torch.int32, device=dev)
    want = fp.compact_placements_plain(dense, pos2)
    check(int(want["cave"]["count"].min()) > fp.CHUNK_CAVE_FEATURE_CAP, "the dense grid does not overflow")
    err["compact_placements"] = max(err["compact_placements"], check_dict_equal(
        "synthetic K6", kernels.compact_placements(dense, pos2), want))

    F, C, Bk = features.fd.Feature, features.fd.CaveFeature, fill.Block
    strip = torch.zeros((3, 16, 16, 384), dtype=torch.uint8, device=dev)
    strip[..., :146] = int(Bk.STONE)
    strip[..., 60:91] = int(Bk.AIR)  # a cave layer
    pos3 = torch.tensor([[0, 0], [16, 0], [32, 0]], dtype=torch.int32, device=dev)

    def synthetic_lists(surface_rows, cave_rows, surface_count=None):
        out = {}
        for kind, rows, fields, cap in (("surface", surface_rows, kernels.SURFACE_FIELDS, 256),
                                        ("cave", cave_rows, kernels.CAVE_FIELDS, 1024)):
            d = {k: torch.zeros((3, cap), dtype=torch.int32) for k in fields}
            for b, entries in enumerate(rows):
                for slot, row in enumerate(entries):
                    for k, v in zip(fields, row):
                        d[k][b, slot] = int(v)
            d["count"] = (d["feature"] > 0).sum(-1).to(torch.int32)
            out[kind] = {k: v.to(dev) for k, v in d.items()}
        if surface_count is not None:
            out["surface"]["count"] = torch.tensor(surface_count, dtype=torch.int32, device=dev)
        return out

    surface_rows = [[(F.KELP, 14, 100, 8, 1), (F.SPHERE, 15, 102, 8, 1), (F.SPHERE, 8, 144, 8, 0)],
                    [(F.KELP, 16, 100, 8, 1), (F.SPHERE, 17, 200, 8, 0), (F.PINE_TREE, 30, 146, 3, 0)],
                    [(F.SPHERE, 33, 200, 8, 0)]]
    cave_rows = [[(C.TEST_GLOWSTONE_PILLAR, 8, 60, 8, 0, 30), (C.STORMLIGHT_SPHERE, 15, 61, 12, 1, 29)],
                 [(C.CAVE_VINE, 20, 61, 5, 0, 29)], [(C.AMBER_FUNGUS, 35, 61, 9, 0, 29)]]
    for tag, count in (("free", None), ("capped", [fp.MAX_GATHERED_FEATURES, 3, 1])):
        sl = synthetic_lists(surface_rows, cave_rows, count)
        want = features.apply_features_area_plain(strip, sl["surface"], sl["cave"], pos3, 3, 1)
        got = features.apply_features_area(strip, sl["surface"], sl["cave"], pos3, 3, 1)
        err["features"] = max(err["features"], check_equal(f"synthetic K7 {tag}", got, want))
        # x = 14 (chunk 0) lies in the sphere chunk 1 lists at x = 17: visible unless chunk 0's
        # own count fills its gather
        seen = int(got[0, 8, 14, 200]) == int(Bk.GRAVEL)
        check(seen == (count is None), f"synthetic K7 {tag}: the neighbour's sphere is "
              f"{'visible' if seen else 'hidden'} in chunk 0")
        check(int(got[1, 8, 1, 200]) == int(Bk.GRAVEL), f"synthetic K7 {tag}: chunk 1 lost its own sphere")

    # -- 4. goldens at test_golden.py's gates ---------------------------------------------
    stamp("phase 4: K1-K3 vs tests/golden/golden_chunks.npz")
    g = np.load(GOLDEN)
    gpos = torch.tensor(GOLDEN_CHUNKS, dtype=torch.int32, device=dev)
    hf_g, w_g = kernels.heightfield(gpos)
    for i, (cx, cz) in enumerate(GOLDEN_CHUNKS):
        dw = (w_g[i].cpu().numpy() - g[f"weights_{cx}_{cz}"]).__abs__()
        check((dw <= 2e-3).mean() > 0.95 and dw.max() < 0.02, f"K1 weights golden ({cx},{cz})")
        dh = np.abs(hf_g[i].cpu().numpy() - g[f"hf18_{cx}_{cz}"][1:17, 1:17])
        check(np.median(dh) < 0.05 and (dh < 1.0).mean() > 0.98, f"K1 height golden ({cx},{cz})")

        hf18 = torch.as_tensor(g[f"hf18_{cx}_{cz}"], device=dev)
        full = torch.zeros((48, 48), dtype=torch.float32, device=dev)
        full[15:33, 15:33] = hf18
        hf_h = gather.split_chunk_grid(full, 3, 3).reshape(9, 16, 16).contiguous()
        w_h = torch.zeros((9, 24, 16, 16), dtype=torch.float32, device=dev)
        w_h[4] = torch.as_tensor(g[f"weights_{cx}_{cz}"], device=dev)
        got = kernels.layers(hf_h, w_h, halo_positions(cx, cz, dev), 1, 1)["layers"][0]
        ref = torch.as_tensor(g[f"layers_{cx}_{cz}"], device=dev)
        ref = layers.fix_backward_stratified(ref[None])[0]
        max_h = g[f"hf18_{cx}_{cz}"][1:17, 1:17]
        live = np.ones(ref.shape, dtype=bool)  # forward entries the reference wrote
        over = np.zeros(max_h.shape, dtype=bool)
        raw = g[f"layers_{cx}_{cz}"]
        for j in range(1, 10):
            over |= raw[j - 1] > max_h
            live[j] = ~over
        dl = np.abs(got.cpu().numpy() - ref.cpu().numpy())[live]
        check(np.median(dl) < 0.05 and (dl < 1.0).mean() > 0.98, f"K2 layers golden ({cx},{cz})")

        cvg = kernels.caves(hf18[None, 1:17, 1:17].contiguous(), w_h[4:5].contiguous(),
                            gpos[i : i + 1].contiguous(), caves.CELL_TABLE_CAP)
        s_ok = (cvg["starts"][0].cpu().numpy() == g[f"cavestarts_{cx}_{cz}"])
        e_ok = (cvg["ends"][0].cpu().numpy() == g[f"caveends_{cx}_{cz}"])
        check(s_ok.mean() > 0.95 and e_ok.mean() > 0.95, f"K3 cave layers golden ({cx},{cz})")
        msg = f"  ({cx},{cz}): K1 w {(dw <= 2e-3).mean():.4f} h-median {np.median(dh):.2g}; "
        msg += f"K2 median {np.median(dl):.2g}; K3 starts {s_ok.mean():.4f} ends {e_ok.mean():.4f}"
        if i < 2:
            m = s_ok & (g[f"cavestarts_{cx}_{cz}"] != 384)
            agree = (cvg["bottom_biome"][0].cpu().numpy()[m] == g[f"cavebottom_{cx}_{cz}"][m]).mean()
            check(m.sum() == 0 or agree > 0.97, f"K3 cave biomes golden ({cx},{cz})")
            msg += f" biomes {agree:.4f}"
        print(msg)

    stamp("phase 4b: featured 7x7 areas vs tests/golden/golden_blockgrid.npz (pre_ / post_)")
    gb = np.load(BLOCKGRID)
    for (cx, cz), gate in BLOCKGRID_GATES.items():
        area = pipeline.generate_area(cx // 16 - 3, cz // 16 - 3, 7, 7, features=True, device=dev)
        # the same area before decorators: the featureless slice with the run's lists applied
        base = pipeline.generate_area_fused(
            pipeline.chunk_positions(cx // 16 - 4, cz // 16 - 4, 9, 9, device=dev), 7, 7)
        lists = area["placements"]
        pre = features.apply_features_area(base["blocks"], lists["surface"], lists["cave"],
                                           base["chunk_pos"], 7, 7)
        cvb = base["caves"]
        again = decorators.place_decorators_batch(
            pre, base["heightfield"], base["biome_weights"], cvb["starts"], cvb["ends"],
            cvb["bottom_biome"], base["chunk_pos"])
        check(torch.equal(again.reshape(7, 7, 16, 16, 384), area["blocks"]),
              f"({cx},{cz}): the stages chained by hand differ from generate_area")
        got_pre = pre.reshape(7, 7, 16, 16, 384)[3, 3].cpu().numpy()
        got_post = area["blocks"][3, 3].cpu().numpy()
        a_pre = float((got_pre == gb[f"pre_{cx}_{cz}"]).mean())
        a_post = float((got_post == gb[f"post_{cx}_{cz}"]).mean())
        n_feat = int((got_pre != base["blocks"].reshape(7, 7, 16, 16, 384)[3, 3].cpu().numpy()).sum())
        print(f"  ({cx},{cz}): pre {a_pre:.6f} post {a_post:.6f} (gate {gate}); "
              f"{n_feat} feature and {int((got_post != got_pre).sum())} decorator blocks in the chunk")
        check(a_pre >= gate, f"block grid before decorators ({cx},{cz}): {a_pre} < {gate}")
        check(a_post >= gate, f"block grid after decorators ({cx},{cz}): {a_post} < {gate}")

    # -- 5. the slice through the pipeline's entry point -----------------------------------
    stamp("phase 5: the featured 5x5 bench area through pipeline.generate_area_fused")
    pos5 = pipeline.chunk_positions(-1, -1, 7, 7, device=dev)  # bench.py's 5x5 + halo
    kernels.reset_launch_counts()
    out5 = pipeline.generate_area_fused(pos5, 5, 5, features=True)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    print(f"  launch counts of the featured 5x5 run: {launches}")
    for name in KERNELS:
        want = int(name in AREA_KERNELS)
        check(launches[name] == want, f"kernel {name}: {launches[name]} launches in the 5x5 run, not {want}")
    check_area(5, out5, int(fill.Block.BEDROCK))

    kernels.reset_launch_counts()
    base5 = pipeline.generate_area_fused(pos5, 5, 5)
    torch.cuda.synchronize()
    launches_base = kernels.launch_counts()
    for name in KERNELS:
        want = 1 if name in GEN_KERNELS else 0
        check(launches_base[name] == want, f"kernel {name}: {launches_base[name]} launches in the "
              f"featureless 5x5 run, not {want}")
    check_area(5, base5, int(fill.Block.BEDROCK))

    print("  each kernel at the 5x5 shapes vs its plain version, same inputs:")
    hf_p, w_p = heightfield.generate_heightfield_plain(pos5)
    hf_k, w_k = kernels.heightfield(pos5)
    err["heightfield"] = max(err["heightfield"], check_close("K1 heightfield", hf_k, hf_p),
                             check_close("K1 weights", w_k, w_p))
    st_p = layers.layers_from_halo_plain(hf_p, w_p, pos5, 5, 5)
    st_k = kernels.layers(hf_p, w_p, pos5, 5, 5)
    err["layers"] = max(err["layers"], check_close("K2 layers", st_k["layers"], st_p["layers"]),
                        *(check_equal(f"K2 {k}", st_k[k], st_p[k])
                          for k in ("heightfield", "biome_weights", "chunk_pos")))
    in3 = (st_p["heightfield"], st_p["biome_weights"], st_p["chunk_pos"])
    cv_p = caves.generate_caves_plain(*in3)
    err["caves"] = max(err["caves"], check_k3("at the 5x5 shapes", *in3))
    in4 = (*in3[:2], st_p["layers"], cv_p["starts"], cv_p["ends"], in3[2])
    plain5 = fill.fill_chunks_plain(*in4)
    err["fill"] = max(err["fill"], check_k4("at the 5x5 shapes", *in4))
    lists_p, feat_p, dec_p = stage_checks("5x5", in3[0], in3[1], st_p["layers"], cv_p, in3[2],
                                          plain5, [(0, 5, 5)])

    print("  every output of the 5x5 runs vs the plain chain:")
    for k in ("heightfield", "biome_weights", "layers"):
        check_close(k, out5[k], st_p[k])
    check_equal("chunk_pos", out5["chunk_pos"], st_p["chunk_pos"])
    for k in cv_p:
        check_equal(f"caves {k}", out5["caves"][k], cv_p[k])
    check_equal("featureless blocks", base5["blocks"], plain5)
    check_dict_equal("placements", out5["placements"], lists_p)
    check_equal("featured blocks", out5["blocks"], dec_p)
    n_feat, n_dec = int((feat_p != plain5).sum()), int((dec_p != feat_p).sum())
    check(n_feat > 0 and n_dec > 0, "the featured 5x5 area holds no feature or no decorator block")
    print(f"  5x5 block histogram (top 14), then its {n_feat} feature and {n_dec} decorator blocks:")
    print("\n".join(histogram_lines(out5["blocks"])))
    print("\n".join(histogram_lines(out5["blocks"], only=FEATURE_BLOCKS)))

    stamp("phase 5b: the 33x33 area (the reference's initial drain), featureless and featured")
    pos33 = pipeline.chunk_positions(-17, -17, 35, 35, device=dev)
    kernels.reset_launch_counts()
    base33 = pipeline.generate_area_fused(pos33, 33, 33)
    torch.cuda.synchronize()
    check_area(33, base33, int(fill.Block.BEDROCK))
    inner = base33["blocks"].reshape(33, 33, 16, 16, 384)[16:21, 16:21]
    check(torch.equal(inner, base5["blocks"].reshape(5, 5, 16, 16, 384)),
          "featureless 5x5 chunks differ from the same chunks of the 33x33 run")
    print("  featureless 5x5 == 33x33[16:21, 16:21] bit for bit")
    kernels.reset_launch_counts()
    out33 = pipeline.generate_area_fused(pos33, 33, 33, features=True)
    torch.cuda.synchronize()
    launches33 = kernels.launch_counts()
    print(f"  launch counts of the featured 33x33 run: {launches33}")
    for name in KERNELS:
        want = int(name in AREA_KERNELS)
        check(launches33[name] == want, f"kernel {name}: {launches33[name]} launches in the 33x33 run, "
              f"not {want}")
    check_area(33, out33, int(fill.Block.BEDROCK))
    # a featured 5x5 area lacks the placements of chunks beyond its edge, so the featured
    # cross-size check compares two areas that both hold every inner chunk's 49 sources
    out11 = pipeline.generate_area_fused(pipeline.chunk_positions(-4, -4, 13, 13, device=dev), 11, 11,
                                         features=True)
    mid33 = out33["blocks"].reshape(33, 33, 16, 16, 384)[16:21, 16:21]
    mid11 = out11["blocks"].reshape(11, 11, 16, 16, 384)[3:8, 3:8]
    check(torch.equal(out11["chunk_pos"].reshape(11, 11, 2)[3:8, 3:8],
                      out33["chunk_pos"].reshape(33, 33, 2)[16:21, 16:21]), "11x11 / 33x33 origins")
    check(torch.equal(mid33, mid11), "featured 33x33[16:21, 16:21] differs from 11x11[3:8, 3:8]")
    n_edge = int((mid33 != out5["blocks"].reshape(5, 5, 16, 16, 384)).sum())
    print(f"  featured 33x33[16:21, 16:21] == 11x11[3:8, 3:8] bit for bit ({n_edge} voxels of it "
          f"differ from the 5x5 run, which lacks its neighbours' placements); "
          f"33x33 placements: {int(out33['placements']['surface']['count'].sum())} surface, "
          f"{int(out33['placements']['cave']['count'].sum())} cave "
          f"(max per chunk {int(out33['placements']['surface']['count'].max())} / "
          f"{int(out33['placements']['cave']['count'].max())})")
    del out11, mid11, mid33, inner
    err["caves"] = max(err["caves"], check_k3("at the 33x33 shapes", out33["heightfield"],
                                              out33["biome_weights"], out33["chunk_pos"]))
    cv33, pos33_in = out33["caves"], out33["chunk_pos"]
    err["fill"] = max(err["fill"], check_k4("at the 33x33 shapes", out33["heightfield"], out33["biome_weights"],
                                            out33["layers"], cv33["starts"], cv33["ends"], pos33_in))
    # K5 at the 33x33 shapes, and the slice's lists against K6's plain version on the plain grids
    args5_33 = (out33["heightfield"], out33["biome_weights"], out33["layers"], cv33["starts"], cv33["ends"],
                cv33["bottom_biome"], cv33["top_biome"], pos33_in)
    pl33 = fp.generate_placements_plain(*args5_33)
    err["placements"] = max(err["placements"], check_k5("33x33", args5_33, pl33))
    lists33 = out33["placements"]
    check_dict_equal("33x33 lists vs plain K6 of plain K5", lists33, fp.compact_placements_plain(pl33, pos33_in))
    del pl33
    # K7a into NaN-filled rows against the plain streams; K7 on those rows: its pre-pass lists and
    # its blocks against the plain versions
    st33 = nan_streams(lists33)
    err["feature_streams"] = max(err["feature_streams"], check_streams(
        "33x33", st33, features.draw_streams_plain(lists33["surface"], lists33["cave"]), lists33))
    got33, lists33_k = kernels.features(base33["blocks"], lists33["surface"], lists33["cave"], *st33,
                                        pos33_in, 33, 33, want_lists=True)
    err["features"] = max(err["features"], check_k7_lists(
        "33x33", lists33_k, lambda kind, cull: features.cull_area_plain(lists33[kind], pos33_in, 33, 33,
                                                                       kind == "cave", cull), 33 * 33))
    want33 = features.apply_features_area_plain(base33["blocks"], lists33["surface"], lists33["cave"],
                                                pos33_in, 33, 33)
    err["features"] = max(err["features"], check_equal(
        f"K7 at the 33x33 shapes ({int((want33 != base33['blocks']).sum())} feature blocks)", got33, want33))
    del got33, lists33_k, want33, st33

    # -- 6. timing (warm, CUDA events) ----------------------------------------------------
    stamp("phase 6: timing")
    times, bounds = {}, {}
    for n, pos, out in ((5, pos5, out5), (33, pos33, out33)):
        hf, w = kernels.heightfield(pos)
        st = kernels.layers(hf, w, pos, n, n)
        cv = kernels.caves(st["heightfield"], st["biome_weights"], st["chunk_pos"], caves.CELL_TABLE_CAP)
        args_fill = (st["heightfield"], st["biome_weights"], st["layers"], cv["starts"],
                     cv["ends"], st["chunk_pos"])
        base_blocks = fill_k(*args_fill)
        args5 = (*args_fill[:3], cv["starts"], cv["ends"], cv["bottom_biome"], cv["top_biome"],
                 st["chunk_pos"])
        grids = kernels.placements(*args5)
        lists = kernels.compact_placements(grids, st["chunk_pos"])
        streams = kernels.feature_streams(lists["surface"], lists["cave"])
        args7 = (base_blocks, lists["surface"], lists["cave"], *streams, st["chunk_pos"], n, n)
        featured = kernels.features(*args7)
        args8 = (featured, st["heightfield"], st["biome_weights"], cv["starts"], cv["ends"],
                 cv["bottom_biome"], st["chunk_pos"])
        calls = {
            "heightfield": (lambda: kernels.heightfield(pos),
                            lambda: heightfield.generate_heightfield_plain(pos)),
            "layers": (lambda: kernels.layers(hf, w, pos, n, n),
                       lambda: layers.layers_from_halo_plain(hf, w, pos, n, n)),
            "caves": (lambda: kernels.caves(*args_fill[:2], args_fill[5], caves.CELL_TABLE_CAP),
                      lambda: caves.generate_caves_plain(*args_fill[:2], args_fill[5])),
            "fill": (lambda: fill_k(*args_fill),
                     lambda: fill.fill_chunks_plain(*args_fill)),
            "placements": (lambda: kernels.placements(*args5),
                           lambda: fp.generate_placements_plain(*args5)),
            "compact_placements": (lambda: kernels.compact_placements(grids, st["chunk_pos"]),
                                   lambda: fp.compact_placements_plain(grids, st["chunk_pos"])),
            "feature_streams": (lambda: kernels.feature_streams(lists["surface"], lists["cave"]),
                                lambda: features.draw_streams_plain(lists["surface"], lists["cave"])),
            "features": (lambda: kernels.features(*args7),
                         lambda: features.apply_features_area_plain(*args7[:3], st["chunk_pos"], n, n)),
            "decorators": (lambda: kernels.decorators(*args8),
                           lambda: decorators.place_decorators_batch_plain(*args8)),
        }
        reps = 20 if n == 5 else 3
        for name, (kern, plain) in calls.items():
            if n == 5:  # turns: plain, kernel, kernel, plain
                plain_reps = 1 if name == "features" else 2
                p1 = cuda_ms(plain, plain_reps)
                k1 = cuda_ms(kern, reps)
                k2 = cuda_ms(kern, reps)
                p2 = cuda_ms(plain, plain_reps)
                times[(name, n)] = ((k1 + k2) / 2, (p1 + p2) / 2)
            else:
                times[(name, n)] = (cuda_ms(kern, reps), None)
        base_ms = cuda_ms(lambda: pipeline.generate_area_fused(pos, n, n), reps)
        full_ms = cuda_ms(lambda: pipeline.generate_area_fused(pos, n, n, features=True), reps)
        half_ms = cuda_ms(lambda: pipeline.feature_half(base_blocks, *args_fill[:3], cv,
                                                        st["chunk_pos"], n, n), reps)
        times[("slice", n)] = (full_ms, None)
        k3_dev = device_ms(calls["caves"][0], {"carve_kernel": 1, "column_kernel": 1}, max(reps, 10))
        k4_dev = device_ms(calls["fill"][0], {"fill_kernel": 1}, max(reps, 10))
        k7_dev = device_ms(calls["features"][0], {"cull_kernel": 1, "features_kernel": 1}, max(reps, 10))
        k5_dev = device_ms(calls["placements"][0], {"placements_kernel": 1}, max(reps, 10))
        k7a_dev = device_ms(calls["feature_streams"][0], {"feature_streams_kernel": 1}, max(reps, 10))
        counted = {"base_blocks": base_blocks, "caves": cv, "placement_grids": grids, **st}
        bounds[n] = {k: bound(*v) for k, v in
                     op_counts(n, pos, w, counted, lists, AREA_KERNELS).items()}
        print(f"  {n}x{n} ({n * n} chunks) on {smi}: featured slice {full_ms:.3f} ms = "
              f"{n * n / (full_ms / 1e3):.1f} chunks/s; featureless slice {base_ms:.3f} ms = "
              f"{n * n / (base_ms / 1e3):.1f} chunks/s; feature half {half_ms:.3f} ms "
              f"({half_ms / full_ms:.1%} of the featured slice)")
        print(f"    caves (K3) on the device: {fmt_ms(k3_dev)} (carve, column: {k3_dev[0]})")
        print(f"    fill (K4) on the device: {fmt_ms(k4_dev)}; features (K7) on the device: {fmt_ms(k7_dev)} "
              f"(cull, columns: {k7_dev[0]})")
        print_k5_work(n, args5, grids)
        for label, name, dv in (("placements (K5)", "placements", k5_dev), ("feature_streams (K7a)",
                                                                           "feature_streams", k7a_dev)):
            share = f", {bounds[n][name][0] / sum(dv[0].values()):.2%} of the bound on the device" if dv[0] else ""
            print(f"    {label}: a call {times[(name, n)][0]:.4f} ms, on the device {fmt_ms(dv)}{share}")
        for name in AREA_KERNELS:
            k, pl_ms = times[(name, n)]
            b_ms, b_by = bounds[n][name]
            plain_s = f", plain {pl_ms:.3f} ms ({pl_ms / k:.1f}x)" if pl_ms is not None else ""
            print(f"    {name:18s} kernel {k:.3f} ms, bound {b_ms:.4g} ms by {b_by} "
                  f"({b_ms / k:.1%} of it){plain_s}")

    # -- 7-9. erosion, the streaming path, the reference workload ------------------------
    stream_times, stream_bounds = {}, {}
    erosion_phase(dev, stamp, err, stream_times, stream_bounds, smi)
    stream_phase(dev, stamp, err, smi)
    stream_launches = reference_phase(dev, stamp, err, stream_times, stream_bounds, smi)

    # -- 10-12. the render path --------------------------------------------------------------
    render_launches, render_times, render_bounds, render_scenes = render_phases(dev, stamp, err, smi)

    # -- 13-14. the engine's frame path ------------------------------------------------------
    frame_times, frame_bounds, library = frame_kernel_phase(dev, stamp, err, smi)
    library["layers_slots"] = stream_times.pop(("library", "layers_slots"))
    library["accumulate"] = render_times.pop(("library", "accumulate"))
    frame_launches, engine = flythrough_phase(dev, stamp, smi)

    # -- 15. the debug renderer; 16. the entry points ---------------------------------------
    debug_row, library["render_debug"] = debug_phase(dev, stamp, err, smi, render_scenes)
    entry_points_phase(dev, stamp, smi, engine)
    del engine
    torch.cuda.empty_cache()

    # -- 17. the sharded programs ---------------------------------------------------------------
    shard_launches, shard_times, shard_bounds = sharded_phase(dev, stamp, err, smi, render_scenes)
    del render_scenes
    torch.cuda.empty_cache()

    # launches: the area kernels' from the featured 5x5 run, the streaming kernels' from the
    # reference workload's drain; times and bounds at the shapes of those paths
    def row(name):
        if name in AREA_KERNELS:
            return (launches[name], times[(name, 5)], bounds[5][name])
        if name in RENDER_KERNELS:
            return (render_launches[name], render_times[name], render_bounds[name])
        if name in FRAME_KERNELS:
            return (frame_launches[name], frame_times[name], frame_bounds[name])
        if name == "render_debug":
            return debug_row
        if name in SHARD_KERNELS:
            return (shard_launches[name], shard_times[name], shard_bounds[name])
        return (stream_launches[name], stream_times[name], stream_bounds[name])

    report = {"kernels": []}
    for name, (src, rep) in KERNELS.items():
        n_launch, (ms, plain_ms), (b_ms, b_by) = row(name)
        report["kernels"].append({
            "name": name, "route": "cuda", "source": src, "replaces": rep, "launches": n_launch,
            "max_abs_err": err[name], "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": library.get(name)})
    bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
           or m == "mega_minecraft_tpu" or m.startswith("mega_minecraft_tpu.")]
    check(not bad, f"jax or the JAX package was imported: {bad[:5]}")
    stamp("done")
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))


def fail(msg):
    """Report a failure on both streams, flushed, before the non-zero exit: a run whose
    standard error is lost still ends its standard output with the cause."""
    line = f"chip_smoke: FAILED: {msg}"
    print(line, flush=True)
    print(line, file=sys.stderr, flush=True)
    sys.exit(1)


if __name__ == "__main__":
    try:
        main(sys.argv[1:])
    except SmokeFailure as e:
        fail(e)
    except Exception:  # noqa: BLE001 - any other error is a failure too, with its traceback
        fail(traceback.format_exc())
