"""What a kernel's inputs require, in bytes and f32 operations, and the least time the card
could take for it: a frozen copy of the arithmetic of ``chip_smoke.py`` (``op_counts``,
``carve_work``, ``lush_work``, ``distinct_cells``, ``k11_counts`` and their unit costs),
computed with the benchmark's own plain reference, so that a later change to the program
cannot move the count.

The need is what these inputs require, never what a kernel's design spends: each input byte
read once and each output byte written once; operations at the unit costs below (counted
off ``csrc/mmt_math.cuh``: each add, multiply, divide, floor and compare-select is one) times
what the run's data needs (which blocks reach the carve test's Worley search, how many
distinct Worley cells a chunk's searches read, which voxels lie in a placement's window and
pass its terrain test, how many DDA steps a frame's rays take).  The counts are estimates
good to a few tens of percent.  A share of the roofline is the bound over the measured
device time; it cannot pass 100% unless the count is too high or the time leaves work out.
"""

from __future__ import annotations

import numpy as np
import torch

from .reference.terrain import caves, features, fill
from .reference.terrain.heightfield import column_world_coords
from .reference.world import biomes as bio
from .reference.world.blocks import Block

#: the published rates of one H100 SXM (NVIDIA's data sheet): HBM3 bytes/s, f32 outside the
#: tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

SINHASH = 455
SIMPLEX2 = 155
SIMPLEX3 = 400
WORLEY2 = 9 * (2 * (SINHASH + 4) + 12)
WORLEY3 = 27 * (3 * (SINHASH + 6) + 15)


def fbm2_ops(octaves):
    return octaves * (SIMPLEX2 + 5)


def fbm3_ops(octaves):
    return octaves * (SIMPLEX3 + 7)


CAVE_BIOME = 3 * fbm3_ops(3) + 4 * fbm2_ops(3) + 2 * SIMPLEX3 + 130
#: rough f32 operations of one SDF evaluation by feature id (features_sdf.cuh)
SDF_OPS_SURFACE = {1: 6, 2: 900, 3: 10, 4: 900, 5: 400, 6: 12000, 7: 3000, 8: 120, 9: 40, 10: 60,
                   11: 700, 12: 400, 13: 80, 14: 20, 15: 30, 16: 1500, 17: 1200, 18: 1200, 19: 900,
                   20: 120}
SDF_OPS_CAVE = {1: 4, 2: 4, 3: 20, 4: 250, 5: 40, 6: 40, 7: 60, 8: 250, 9: 1700}
#: K11: a DDA step, a ray's set-up, a bounce's shading, the cloud march of a ray looking up
DDA_STEP_OPS = 140
DDA_RAY_OPS = 60
SHADE_OPS = 1000
CLOUD_OPS = 8400
#: the words of one placement list entry of each kind (surface: feature, x, y, z, replace;
#: cave: also height) and the f32 draws of its stream
SURFACE_FIELDS, CAVE_FIELDS, STREAM_LEN = 5, 6, 64


def nbytes(*tensors):
    total = 0
    for t in tensors:
        if isinstance(t, dict):
            total += nbytes(*t.values())
        else:
            total += t.numel() * t.element_size()
    return total


def bound_ms(n_bytes, n_ops) -> float:
    """The least time the card could take: the larger of the bytes over the HBM rate and the
    operations over the f32 rate, in ms."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S) * 1e3


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


def carve_work(biome_weights, chunk_pos, step=64):
    """(active blocks, distinct Worley cells) of the chunks' carve tests: the blocks whose
    threshold exceeds 0.04, which alone need the domain warp and the Worley search, and the
    cells those searches read, each chunk's once."""
    n_active = n_cells = 0
    for i in range(0, chunk_pos.shape[0], step):
        w, pos = biome_weights[i : i + step], chunk_pos[i : i + step]
        coords = caves.band_coords(pos)
        thr = caves.carve_threshold(*coords, caves.ocean_beach_weight(w)[..., None])
        active = (thr > 0.04).reshape(pos.shape[0], -1)
        cells = torch.stack([torch.floor(c) for c in caves.carve_warp(*coords)], dim=-1)
        cells = cells.to(torch.int64).reshape(pos.shape[0], -1, 3)
        n_active += int(active.sum())
        n_cells += int(distinct_cells(cells, active).sum())
    return n_active, n_cells


def lush_work(base_blocks, chunk_pos, step=64):
    """(lush blocks, distinct Worley cells) of the lush caves' clay tests: the blocks below
    y = 192 that the clay test made clay or moss, and the cells their searches read."""
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


def k3_need(out):
    """K3 (caves) on an area's outputs: per block below y = 144 the carve threshold, the warp
    and the Worley search (without its hashes) where it exceeds 0.04, three hashes per
    distinct cell a chunk's active blocks read, the ravine per column, the cave biome at the
    valid layer edges."""
    cols = out["chunk_pos"].shape[0] * 256
    cv = out["caves"]
    threshold = 2 * fbm3_ops(4) + 40
    warp_search = 3 * fbm3_ops(5) + WORLEY3 - 81 * SINHASH + 27 * 10
    ravine = 16 * (SIMPLEX2 + 5) + WORLEY2 + 500
    edges = int((cv["starts"] != 384).sum()) + int((cv["ends"] != 384).sum())
    n_active, n_cells = carve_work(out["biome_weights"], out["chunk_pos"])
    ops = (cols * 144 * threshold + n_active * warp_search + n_cells * 3 * SINHASH + cols * ravine
           + edges * CAVE_BIOME)
    return nbytes(out["heightfield"], out["biome_weights"], out["chunk_pos"], cv), ops


#: the stone family and what the cave biomes turn it into: the blocks that need the cave-biome
#: noise in K4
STONE_LIKE = (Block.STONE, Block.DEEPSLATE, Block.BLACKSTONE, Block.COBBLESTONE,
              Block.COBBLED_DEEPSLATE, Block.QUARTZ, Block.CLAY, Block.MOSS, Block.WARPED_DEEPSLATE,
              Block.WARPED_BLACKSTONE, Block.AMBER_DEEPSLATE, Block.AMBER_BLACKSTONE)


def k4_need(out, base_blocks):
    """K4 (fill): per block the biome pick, the cave scan and the cascade; the cave-biome
    noise for the solid stone-like blocks below y = 192 of the featureless blocks; the lush
    blocks' clay test, three hashes per distinct cell; 7 fBm fields per column."""
    B = out["chunk_pos"].shape[0]
    cols = B * 256
    cv = out["caves"]
    low = base_blocks[..., :192]
    stone_like = int(torch.isin(low, torch.tensor([int(b) for b in STONE_LIKE], dtype=low.dtype,
                                                  device=low.device)).sum())
    lush, lush_cells = lush_work(base_blocks, out["chunk_pos"])
    clay = SIMPLEX3 + 3 * fbm3_ops(3) + WORLEY3 - 81 * SINHASH
    ops = (B * 98304 * 490 + cols * 7 * fbm2_ops(3) + stone_like * CAVE_BIOME + lush * clay
           + lush_cells * 3 * SINHASH)
    n_bytes = nbytes(out["heightfield"], out["biome_weights"], out["layers"], cv["starts"], cv["ends"],
                     out["chunk_pos"], base_blocks)
    return n_bytes, ops


def k7_need(out, base_blocks, n: int):
    """K7 (feature application, its cull and its columns) on an n x n area: the blocks read
    and written once, the valid list entries' fields and streams read once, and one SDF
    evaluation (per-type cost) for every voxel in a valid placement's XZ window and height
    bounds whose featureless block passes the placement's test (AIR, or any where it
    replaces)."""
    lists = out["placements"]
    dev = base_blocks.device
    valid = {kind: torch.minimum(lists[kind]["count"], torch.tensor(lists[kind]["feature"].shape[1],
                                                                     device=lists[kind]["count"].device))
             for kind in lists}
    n_valid = {kind: int(v.sum()) for kind, v in valid.items()}
    area = base_blocks.reshape(n, n, 16, 16, 384).permute(0, 2, 1, 3, 4).reshape(n * 16, n * 16, 384)
    air_below = torch.zeros((n * 16, n * 16, 385), dtype=torch.int16, device=dev)
    air_below[..., 1:] = torch.cumsum((area == int(Block.AIR)).to(torch.int16), -1, dtype=torch.int16)
    air_below = air_below.cpu().numpy()  # [z, x, y]: AIR blocks of the column below y
    sdf_ops = 0
    ox, oz = (int(v) for v in out["chunk_pos"][0])
    for kind, table, cave in (("surface", SDF_OPS_SURFACE, False), ("cave", SDF_OPS_CAVE, True)):
        L = {k: v.cpu().numpy() for k, v in lists[kind].items()}
        half = features.window_half_widths(cave)
        bounds_t = features.fd.CAVE_FEATURE_HEIGHT_BOUNDS if cave else features.fd.FEATURE_HEIGHT_BOUNDS
        K = L["feature"].shape[1]
        slot_ok = np.arange(K)[None, :] < np.minimum(L["count"], K)[:, None]
        for b, k in zip(*((L["feature"] > 0) & slot_ok).nonzero()):
            f = int(L["feature"][b, k])
            px, py, pz = (int(L[c][b, k]) for c in "xyz")
            h = int(L["height"][b, k]) if cave else 0
            x0, x1 = max(px - ox - int(half[f, 0]), 0), min(px - ox + int(half[f, 1]), n * 16 - 1)
            z0, z1 = max(pz - oz - int(half[f, 0]), 0), min(pz - oz + int(half[f, 1]), n * 16 - 1)
            y0, y1 = max(py + int(bounds_t[f, 0]), 0), min(py + h + int(bounds_t[f, 1]), 383)
            if x0 > x1 or z0 > z1 or y0 > y1:
                continue
            if int(L["replace"][b, k]):
                voxels = (x1 - x0 + 1) * (z1 - z0 + 1) * (y1 - y0 + 1)
            else:
                win = air_below[z0 : z1 + 1, x0 : x1 + 1]
                voxels = int((win[..., y1 + 1].astype(np.int64) - win[..., y0]).sum())
            sdf_ops += voxels * table[f]
    counts_b = nbytes(lists["surface"]["count"], lists["cave"]["count"])
    fields_b = (n_valid["surface"] * SURFACE_FIELDS + n_valid["cave"] * CAVE_FIELDS) * 4
    stream_b = (n_valid["surface"] + n_valid["cave"]) * STREAM_LEN * 4
    return 2 * n * n * 98304 + fields_b + counts_b + stream_b + nbytes(out["chunk_pos"]), sdf_ops


def k11_need(steps, dy, scene_words: int):
    """K11 (the 1-spp sample) of one frame: the frame's ten output floats a pixel and the
    field words its DDA steps read (at most the field), and per DDA step, radiance ray,
    shading and looking-up primary ray their unit costs.  ``steps``: [H, W, 4] DDA counts
    (primary, bounce, shadow, radiance rays) of the plain tracer on the same frame; ``dy``:
    the primary rays' direction y."""
    n_steps = int(steps[..., :3].sum())
    rays = int(steps[..., 3].sum())
    clouds = int((dy >= 0.04).sum())
    n_px = steps.shape[0] * steps.shape[1]
    words = min(n_steps, scene_words)
    return (n_px * 10 * 4 + words * 4,
            n_steps * DDA_STEP_OPS + rays * (2 * DDA_RAY_OPS + SHADE_OPS) + clouds * CLOUD_OPS)
