"""Stage 5b: apply the placement lists to an area's or a chunk's blocks (kernels K7, K7s).

Port of ``mega_minecraft_tpu/terrain/features.py``.  Per voxel the winner
is the first placement, in the voxel's own chunk's 49-chunk spiral order and then list
slot, whose SDF hits, whose y lies within the type's height bounds and whose terrain
block is AIR or replaceable; surface placements win over cave ones; both test the
terrain block.  A consumer chunk sees a placement only while its index in that
consumer's gathered list (true counts of the earlier spiral sources + slot) is below
the reference's gather cap (2,048 surface / 4,096 cave).

``apply_features_area`` dispatches on the device: CUDA tensors go to K7 in
``csrc/features.cu`` (after its pre-kernel there made each placement's 64-draw stream; a
per-chunk pass first culls each chunk's gathered list to the entries whose window meets the
chunk, ``cull_area_plain`` / ``cull_slots_plain`` being its plain version), CPU tensors to the
plain version, a Python loop over placements that evaluates each over its window and keeps
the minimum (spiral rank, slot) key per voxel.

Both versions evaluate a placement only inside the same per-type XZ window: the JAX
program's window for the type (its radius table rounded up to its 16-block window
grid), centred on the placement and cut at the area's edge.

The streaming scheduler applies features per chunk (``apply_features_chunk`` /
``apply_features_batch``, JAX ``features.py:91,461,471``): a chunk's gathered lists
(``feature_placement.gather_from_neighborhood``: valid entries of its 49 neighbours'
stored lists in spiral order, cut at the gather cap) are applied in list order, first
hit wins.  The plain version follows the JAX program: every gathered entry is evaluated
over the whole chunk (its rows within the entry's height bounds), with no XZ window.
``apply_features_slots`` is that stage over the slot table: K7s on CUDA (the gather
folded in through a [B, 49] slot table, the streams read from the slot table), the
gather plus the plain per-chunk application on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import hashes
from ..tables import Y_SIZE
from ..world import biomes as bio
from ..world import features_data as fd
from ..world.blocks import Block
from . import features_sdf as sdf
from .feature_placement import GATHER_OFFSETS

I32 = torch.int32
AIR = int(Block.AIR)
#: words of a culled list entry (K7's pre-pass layout)
CANDIDATE_WORDS = 8

#: XZ half-extent of each surface feature's geometry in blocks (measured extent + margin)
SURFACE_XZ_RADIUS = {
    int(fd.Feature.SPHERE): 7,
    int(fd.Feature.CORAL): 9,
    int(fd.Feature.KELP): 3,
    int(fd.Feature.ICEBERG): 39,
    int(fd.Feature.ACACIA_TREE): 10,
    int(fd.Feature.REDWOOD_TREE): 14,
    int(fd.Feature.CYPRESS_TREE): 12,
    int(fd.Feature.BIRCH_TREE): 6,
    int(fd.Feature.PINE_TREE): 5,
    int(fd.Feature.PINE_SHRUB): 4,
    int(fd.Feature.RAFFLESIA): 9,
    int(fd.Feature.LARGE_JUNGLE_TREE): 11,
    int(fd.Feature.SMALL_JUNGLE_TREE): 7,
    int(fd.Feature.TINY_JUNGLE_TREE): 3,
    int(fd.Feature.MEDIUM_PURPLE_MUSHROOM): 4,
    int(fd.Feature.PURPLE_MUSHROOM): 47,
    int(fd.Feature.MEDIUM_CRYSTAL): 13,
    int(fd.Feature.CRYSTAL): 25,
    int(fd.Feature.PALM_TREE): 16,
    int(fd.Feature.CACTUS): 4,
}

#: (xz_radius, y anchor) of each cave feature; the anchor only shaped the JAX program's
#: y window and is kept so the table can be held equal to the reference's
CAVE_WINDOWS = {
    int(fd.CaveFeature.TEST_GLOWSTONE_PILLAR): (3, "full"),
    int(fd.CaveFeature.TEST_SHROOMLIGHT_PILLAR): (3, "full"),
    int(fd.CaveFeature.CAVE_VINE): (3, "full"),
    int(fd.CaveFeature.GLOWSTONE_CLUSTER): (8, "ceil"),
    int(fd.CaveFeature.STORMLIGHT_SPHERE): (10, "floor"),
    int(fd.CaveFeature.CEILING_STORMLIGHT_SPHERE): (10, "ceil"),
    int(fd.CaveFeature.CRYSTAL_PILLAR): (7, "full"),
    int(fd.CaveFeature.WARPED_FUNGUS): (6, "floor"),
    int(fd.CaveFeature.AMBER_FUNGUS): (5, "floor"),
}

#: spiral rank of a source chunk at chunk offset (dx, dz) from the consumer, [dz+3][dx+3]
RANK_OF_OFFSET = np.full((7, 7), -1, np.int32)
for _r, (_dx, _dz) in enumerate(GATHER_OFFSETS):
    RANK_OF_OFFSET[_dz + 3, _dx + 3] = _r


def window_half_widths(cave: bool) -> np.ndarray:
    """[n_types, 2] i32 (below, above): a placement of the type is evaluated at XZ
    offsets -below .. +above.  The width is 2r + 2 rounded up to a multiple of 16, the
    offsets those of the JAX program's window before any shift at the area's edge."""
    n_types = fd.NUM_CAVE_FEATURES if cave else fd.NUM_FEATURES
    out = np.zeros((n_types, 2), np.int32)
    for f in range(n_types):
        r = CAVE_WINDOWS.get(f, (15, "full"))[0] if cave else SURFACE_XZ_RADIUS.get(f, 31)
        width = -(-(2 * r + 2) // 16) * 16
        out[f] = (width // 2 - 1, width // 2)
    return out


def gather_prefix(counts: np.ndarray, ncx: int, ncz: int) -> np.ndarray:
    """[B, 49] exclusive prefix over each consumer chunk's spiral of the true placement
    counts of the sources inside the area: the gathered index of (source rank r, slot k)
    is prefix[consumer, r] + k."""
    B = ncx * ncz
    mat = np.zeros((B, len(GATHER_OFFSETS)), np.int64)
    for cb in range(B):
        vz, vx = divmod(cb, ncx)
        for r, (ox, oz) in enumerate(GATHER_OFFSETS):
            sx, sz = vx + int(ox), vz + int(oz)
            if 0 <= sx < ncx and 0 <= sz < ncz:
                mat[cb, r] = counts[sz * ncx + sx]
    return np.cumsum(mat, axis=1) - mat


def apply_placements_area_plain(area_blocks, lists, origin_xz, ncx: int, ncz: int, cave: bool):
    """Plain application of every chunk's source list over the area volume.

    area_blocks [ncz*16, ncx*16, 384] u8; lists: dict of [B, K] i32 and the [B] true
    (uncapped) ``count``;
    origin_xz [2] i32.  Returns (area with the winning feature blocks, placed mask)."""
    dev = area_blocks.device
    nz, nx = ncz * 16, ncx * 16
    feats = lists["feature"].cpu().numpy()
    B, K = feats.shape
    assert B == ncx * ncz
    host = {k: lists[k].cpu().numpy() for k in lists if k not in ("feature", "count")}
    prefix = gather_prefix(lists["count"].cpu().numpy(), ncx, ncz)
    ox, oz = (int(v) for v in origin_xz.cpu())

    gather_cap = bio.MAX_GATHERED_CAVE_FEATURES_PER_CHUNK if cave else bio.MAX_GATHERED_FEATURES_PER_CHUNK
    bounds = fd.CAVE_FEATURE_HEIGHT_BOUNDS if cave else fd.FEATURE_HEIGHT_BOUNDS
    fns = sdf.CAVE_FEATURE_FNS if cave else sdf.SURFACE_FEATURE_FNS
    feat_seed = sdf.SEED_CAVE_FEATURE_RNG if cave else sdf.SEED_SURFACE_FEATURE_RNG
    block_seed = sdf.SEED_CAVE_BLOCK_RNG if cave else sdf.SEED_SURFACE_BLOCK_RNG
    half = window_half_widths(cave)

    INF = 1 << 40
    best_key = torch.full((nz, nx, Y_SIZE), INF, dtype=torch.int64, device=dev)
    best_block = torch.zeros((nz, nx, Y_SIZE), dtype=I32, device=dev)

    def i32(v):
        return torch.tensor(int(v), dtype=I32, device=dev)

    for sb, k in zip(*np.nonzero(feats > 0)):
        fid = int(feats[sb, k])
        fn = fns.get(fid)
        if fn is None:
            continue
        px, py, pz = (int(host[c][sb, k]) for c in "xyz")
        layer_h = int(host["height"][sb, k]) if cave else 0
        z0, z1 = max(pz - oz - half[fid, 0], 0), min(pz - oz + half[fid, 1], nz - 1)
        x0, x1 = max(px - ox - half[fid, 0], 0), min(px - ox + half[fid, 1], nx - 1)
        y0, y1 = max(py + int(bounds[fid, 0]), 0), min(py + layer_h + int(bounds[fid, 1]), Y_SIZE - 1)
        if z0 > z1 or x0 > x1 or y0 > y1:
            continue

        # per-column priority key: spiral rank of the source in the column's own chunk
        sz_, sx_ = divmod(int(sb), ncx)
        czc = np.arange(z0, z1 + 1) // 16
        cxc = np.arange(x0, x1 + 1) // 16
        ddz = (sz_ - czc)[:, None] + np.zeros_like(cxc)[None, :]
        ddx = (sx_ - cxc)[None, :] + np.zeros_like(czc)[:, None]
        near = (np.abs(ddz) <= 3) & (np.abs(ddx) <= 3)
        rank = RANK_OF_OFFSET[np.clip(ddz, -3, 3) + 3, np.clip(ddx, -3, 3) + 3]
        consumer = czc[:, None] * ncx + cxc[None, :]
        visible = near & (prefix[consumer, np.maximum(rank, 0)] + k < gather_cap)
        if not visible.any():
            continue
        key = torch.as_tensor(np.where(visible, rank.astype(np.int64) * K + k, INF), device=dev)

        shape = (z1 - z0 + 1, x1 - x0 + 1, y1 - y0 + 1)
        wz = (oz + torch.arange(z0, z1 + 1, dtype=I32, device=dev))[:, None, None].expand(shape)
        wx = (ox + torch.arange(x0, x1 + 1, dtype=I32, device=dev))[None, :, None].expand(shape)
        wy = torch.arange(y0, y1 + 1, dtype=I32, device=dev)[None, None, :].expand(shape)
        brng = hashes.seed_4(wx, wy, wz, block_seed)
        stream = sdf.draw_stream(i32(px), i32(py), i32(pz), feat_seed)
        extra = {"fy_pos": i32(py), "fpos": (i32(px), i32(py), i32(pz)), "layer_height": i32(layer_h)}
        hit, fblock, _ = fn(stream, wx - px, wy - py, wz - pz, wx, wy, wz, brng, extra)

        win = (slice(z0, z1 + 1), slice(x0, x1 + 1), slice(y0, y1 + 1))
        ok = hit
        if not int(host["replace"][sb, k]):
            ok = ok & (area_blocks[win] == AIR)
        take = ok & (key[:, :, None] < best_key[win])
        best_key[win] = torch.where(take, key[:, :, None], best_key[win])
        best_block[win] = torch.where(take, fblock, best_block[win])

    placed = best_key != INF
    return torch.where(placed, best_block.to(torch.uint8), area_blocks), placed


def _cull_plain(L, src, cnt, chunk_pos, cave: bool, cull: bool):
    """Plain version of K7's / K7s's pre-pass for one kind.  L: dict of [S, K] numpy fields;
    src / cnt [B, 49]: each spiral rank's source row (any value where cnt is 0) and the count
    its gathered index runs on.  Returns (lists [B, cap, 8] i32, zero past each chunk's
    length; lengths [B] i32): every visible gathered entry whose window meets the chunk's
    16 x 16 columns (every visible entry without ``cull``), in gathered order."""
    cap = bio.MAX_GATHERED_CAVE_FEATURES_PER_CHUNK if cave else bio.MAX_GATHERED_FEATURES_PER_CHUNK
    n_types = fd.NUM_CAVE_FEATURES if cave else fd.NUM_FEATURES
    half = window_half_widths(cave)
    K = L["feature"].shape[1]
    B = src.shape[0]
    out = np.zeros((B, cap, CANDIDATE_WORDS), np.int32)
    lengths = np.zeros(B, np.int32)
    gathered = np.cumsum(cnt, axis=1) - cnt  # the gathered index of each rank's first entry
    visible = np.clip(np.minimum(np.minimum(cnt, K), cap - gathered), 0, None)
    for b in range(B):
        rows = np.concatenate([src[b, r] * K + np.arange(visible[b, r]) for r in range(src.shape[1])])
        rows = rows.astype(np.int64)
        feat = L["feature"].reshape(-1)[rows]
        x, z = L["x"].reshape(-1)[rows], L["z"].reshape(-1)[rows]
        keep = (feat > 0) & (feat < n_types)
        if cull:
            f = np.where(keep, feat, 0)
            x0, z0 = (int(v) for v in chunk_pos[b])
            keep &= (x0 - x <= half[f, 1]) & (x0 + 15 - x >= -half[f, 0])
            keep &= (z0 - z <= half[f, 1]) & (z0 + 15 - z >= -half[f, 0])
        rows = rows[keep]
        n = len(rows)
        height = L["height"].reshape(-1)[rows] if cave else np.zeros(n, np.int32)
        for w, v in enumerate((L["x"].reshape(-1)[rows], L["y"].reshape(-1)[rows], L["z"].reshape(-1)[rows],
                               rows, L["feature"].reshape(-1)[rows], L["replace"].reshape(-1)[rows], height)):
            out[b, :n, w] = v
        lengths[b] = n
    return torch.from_numpy(out), torch.from_numpy(lengths)


def cull_area_plain(lists, chunk_pos, ncx: int, ncz: int, cave: bool, cull: bool = True):
    """Plain version of K7's pre-pass for one kind over an ncx x ncz area: each consumer
    chunk's gathered list (its sources inside the area in spiral order, ranked by their true
    counts, cut at the gather cap), culled to the entries whose window meets the chunk.
    lists: K6's dict of [B, K] i32 and [B] ``count``; chunk_pos [B, 2].  Returns CPU tensors
    (lists [B, cap, 8] i32, lengths [B] i32), ``_cull_plain``'s."""
    B = ncx * ncz
    L = {k: v.cpu().numpy() for k, v in lists.items() if k != "count"}
    count = lists["count"].cpu().numpy()
    src = np.zeros((B, len(GATHER_OFFSETS)), np.int64)
    cnt = np.zeros((B, len(GATHER_OFFSETS)), np.int64)
    for cb in range(B):
        vz, vx = divmod(cb, ncx)
        for r, (ox, oz) in enumerate(GATHER_OFFSETS):
            sx, sz = vx + int(ox), vz + int(oz)
            if 0 <= sx < ncx and 0 <= sz < ncz:
                src[cb, r] = sz * ncx + sx
                cnt[cb, r] = count[src[cb, r]]
    return _cull_plain(L, src, cnt, chunk_pos.cpu().numpy(), cave, cull)


def cull_slots_plain(d_lists, nslots, chunk_pos, cave: bool, cull: bool = True):
    """Plain version of K7s's pre-pass for one kind: chunk b's sources are the slot table's
    rows ``nslots[b]`` ([B, 49]), ranked by min(count, K), the valid entries their lists hold.
    d_lists: dict of [C, K] i32 and [C] ``count``.  Returns (lists [B, cap, 8] i32, lengths [B])."""
    L = {k: v.cpu().numpy() for k, v in d_lists.items() if k != "count"}
    src = nslots.cpu().numpy().astype(np.int64)
    cnt = np.minimum(d_lists["count"].cpu().numpy()[src], L["feature"].shape[1])
    return _cull_plain(L, src, cnt, chunk_pos.cpu().numpy(), cave, cull)


def _culled_to_list(culled, n: int, cave: bool):
    """The first ``n`` entries of one chunk's culled list ([cap, 8] i32) as a placement list
    (dict of [n] i32: feature, x, y, z, replace (, height)) for ``apply_placements_plain``."""
    out = {"feature": culled[:n, 4], "x": culled[:n, 0], "y": culled[:n, 1], "z": culled[:n, 2],
           "replace": culled[:n, 5]}
    if cave:
        out["height"] = culled[:n, 6]
    return {k: v.contiguous() for k, v in out.items()}


def apply_culled_plain(blocks, surface, cave, chunk_pos):
    """Each chunk's blocks [B, 16, 16, 384] u8 with its culled lists applied by the per-chunk
    plain application (every entry over the whole chunk, first hit wins): surface and cave are
    (lists [B, cap, 8], lengths [B]) of the pre-pass."""
    return torch.stack([
        apply_features_chunk_plain(
            blocks[b], _culled_to_list(surface[0][b], int(surface[1][b]), False),
            _culled_to_list(cave[0][b], int(cave[1][b]), True), chunk_pos[b].cpu())
        for b in range(blocks.shape[0])])


def apply_features_area_plain(blocks, surface_lists, cave_lists, chunk_pos, ncx: int, ncz: int):
    """Plain area-level feature application -> [B, 16, 16, 384] u8 (B = ncz*ncx
    row-major).  Surface placements take priority; cave placements test the terrain
    block and claim only voxels no surface feature took."""
    B = blocks.shape[0]
    area = (
        blocks.reshape(ncz, ncx, 16, 16, Y_SIZE)
        .permute(0, 2, 1, 3, 4)
        .reshape(ncz * 16, ncx * 16, Y_SIZE)
    )
    origin = chunk_pos[0]
    area_s, placed_s = apply_placements_area_plain(area, surface_lists, origin, ncx, ncz, cave=False)
    area_c, placed_c = apply_placements_area_plain(area, cave_lists, origin, ncx, ncz, cave=True)
    out = torch.where(placed_s, area_s, torch.where(placed_c, area_c, area))
    return (
        out.reshape(ncz, 16, ncx, 16, Y_SIZE)
        .permute(0, 2, 1, 3, 4)
        .reshape(B, 16, 16, Y_SIZE)
        .contiguous()
    )


def draw_streams_plain(surface_lists, cave_lists):
    """(surface [B, K, 64], cave [B, K, 64]) f32: the 64-draw stream of every list entry
    (valid or not)."""
    return (
        sdf.draw_stream(surface_lists["x"], surface_lists["y"], surface_lists["z"],
                        sdf.SEED_SURFACE_FEATURE_RNG),
        sdf.draw_stream(cave_lists["x"], cave_lists["y"], cave_lists["z"],
                        sdf.SEED_CAVE_FEATURE_RNG),
    )


def apply_features_area(blocks, surface_lists, cave_lists, chunk_pos, ncx: int, ncz: int):
    """Area-level feature application: K7 on CUDA, the plain version on the CPU."""
    return apply_features_area_plain(blocks, surface_lists, cave_lists, chunk_pos, ncx, ncz)


def apply_placements_plain(blocks, placements, chunk_pos1, cave: bool):
    """Plain application of one gathered list to one chunk, in list order up to its first
    empty entry: blocks [16, 16, 384] u8, placements dict of [K] i32, chunk_pos1 [2] i32.
    Returns (blocks, placed mask)."""
    dev = blocks.device
    feats = placements["feature"].cpu().numpy()
    host = {k: placements[k].cpu().numpy() for k in placements if k != "feature"}
    ox, oz = (int(v) for v in chunk_pos1.cpu())
    bounds = fd.CAVE_FEATURE_HEIGHT_BOUNDS if cave else fd.FEATURE_HEIGHT_BOUNDS
    fns = sdf.CAVE_FEATURE_FNS if cave else sdf.SURFACE_FEATURE_FNS
    feat_seed = sdf.SEED_CAVE_FEATURE_RNG if cave else sdf.SEED_SURFACE_FEATURE_RNG
    block_seed = sdf.SEED_CAVE_BLOCK_RNG if cave else sdf.SEED_SURFACE_BLOCK_RNG
    out = blocks.to(I32)
    placed = torch.zeros(blocks.shape, dtype=torch.bool, device=dev)
    lx = torch.arange(16, dtype=I32, device=dev)

    def i32(v):
        return torch.tensor(int(v), dtype=I32, device=dev)

    n = int(np.argmin(feats != 0)) if (feats == 0).any() else len(feats)
    # the entries' 64-draw streams, drawn for all of them at once (elementwise)
    streams = sdf.draw_stream(*(placements[c][:n] for c in "xyz"), feat_seed)
    for i in range(n):
        fid = int(feats[i])
        fn = fns.get(fid)
        if fn is None:
            continue
        px, py, pz = (int(host[c][i]) for c in "xyz")
        layer_h = int(host["height"][i]) if cave else 0
        # outside [lo, hi] the placement is no candidate: evaluate only those rows
        y0 = max(py + int(bounds[fid, 0]), 0)
        y1 = min(py + layer_h + int(bounds[fid, 1]), Y_SIZE - 1)
        if y0 > y1:
            continue
        shape = (16, 16, y1 - y0 + 1)
        wz = (oz + lx)[:, None, None].expand(shape)
        wx = (ox + lx)[None, :, None].expand(shape)
        wy = torch.arange(y0, y1 + 1, dtype=I32, device=dev)[None, None, :].expand(shape)
        brng = hashes.seed_4(wx, wy, wz, block_seed)
        extra = {"fy_pos": i32(py), "fpos": (i32(px), i32(py), i32(pz)), "layer_height": i32(layer_h)}
        hit, fblock, _ = fn(streams[i], wx - px, wy - py, wz - pz, wx, wy, wz, brng, extra)
        win = (slice(None), slice(None), slice(y0, y1 + 1))
        cand = hit & ~placed[win]
        if not int(host["replace"][i]):
            cand = cand & (blocks[win] == AIR)
        out[win] = torch.where(cand, fblock, out[win])
        placed[win] = placed[win] | cand
    return out.to(torch.uint8), placed


def apply_features_chunk_plain(blocks, surface_list, cave_list, chunk_pos1):
    """Plain per-chunk feature application: surface placements take priority; cave
    placements test the terrain block and claim only voxels no surface placement took."""
    blocks_s, placed_s = apply_placements_plain(blocks, surface_list, chunk_pos1, cave=False)
    blocks_c, placed_c = apply_placements_plain(blocks, cave_list, chunk_pos1, cave=True)
    return torch.where(placed_s, blocks_s, torch.where(placed_c, blocks_c, blocks))


def apply_features_batch_plain(blocks, surface_lists, cave_lists, chunk_pos):
    """``apply_features_chunk_plain`` over a leading chunk axis: blocks [B, 16, 16, 384]
    u8, gathered lists dict of [B, cap], chunk_pos [B, 2]."""
    return torch.stack([
        apply_features_chunk_plain(blocks[b], {k: v[b] for k, v in surface_lists.items()},
                                   {k: v[b] for k, v in cave_lists.items()}, chunk_pos[b])
        for b in range(blocks.shape[0])])


def apply_features_slots_plain(blocks, d_sf, d_cf, nslots, chunk_pos):
    """Plain version of K7s: for each chunk b, the 49-chunk gather of the slot table's
    lists through ``nslots`` [B, 49] (``GATHER_OFFSETS`` order), then the per-chunk
    application to blocks [B, 16, 16, 384] u8."""
    from .feature_placement import (MAX_GATHERED_CAVE_FEATURES, MAX_GATHERED_FEATURES,
                                    gather_from_neighborhood_batch)

    idx = nslots.reshape(-1).long()
    B = nslots.shape[0]
    rows = lambda d: {k: v[idx].reshape(B, nslots.shape[1], *v.shape[1:]) for k, v in d.items()}  # noqa: E731
    surf = gather_from_neighborhood_batch(rows(d_sf), MAX_GATHERED_FEATURES)
    cave = gather_from_neighborhood_batch(rows(d_cf), MAX_GATHERED_CAVE_FEATURES)
    return apply_features_batch_plain(blocks, surf, cave, chunk_pos)


def apply_features_slots(blocks, d_sf, d_cf, d_sstream, d_cstream, nslots, chunk_pos):
    """The scheduler's feature step over the slot table: K7s on CUDA (lists, true counts
    and per-entry streams read from the slot table, ``d_sstream`` / ``d_cstream``
    [capacity, K, 64] f32), the plain version on the CPU (streams unused).  Returns new
    blocks [B, 16, 16, 384] u8."""
    return apply_features_slots_plain(blocks, d_sf, d_cf, nslots, chunk_pos)
