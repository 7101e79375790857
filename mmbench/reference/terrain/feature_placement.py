"""Stage 4b: feature placement, which features spawn where (kernels K5 and K6).

Port of ``mega_minecraft_tpu/terrain/feature_placement.py:49-326``.  ``generate_placements``
fills dense per-column grids (one surface pick and up to 32 cave layers x {floor,
ceiling} per column) from one sequential minstd stream per column whose state advances
only where the reference's control flow would draw.  ``compact_placements`` turns the
grids into capped per-chunk lists in the reference's order.  Both dispatch on the
tensor's device: CUDA tensors go to ``csrc/placements.cu``, CPU tensors to the plain
versions below.  ``gather_from_neighborhood(_batch)`` is the streaming scheduler's
49-chunk list gather (plain only: on the kernel path it is folded into K7s,
``csrc/features.cu``).

The plain versions keep the JAX program's masked whole-grid form, but read the gen
tables with indexed lookups (``table[biome]``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import hashes
from ..ops.hashes import div
from ..world import biomes as bio
from ..world import features_data as fd
from .fill import random_biome
from .heightfield import column_world_coords

I32 = torch.int32
F32 = torch.float32

SEED_COLUMN = 329828101
SEED_SURFACE_POS = 518721
SEED_CAVE_BOTTOM_F = 98239
SEED_CAVE_BOTTOM_L = 191702
SEED_CAVE_TOP_F = 58321
SEED_CAVE_TOP_L = 871503

MAX_LAYERS = bio.MAX_CAVE_LAYERS_PER_COLUMN

#: per-chunk compacted capacity (the reference's per-chunk lists are unbounded; a
#: count above the cap would show as a block-grid mismatch)
CHUNK_FEATURE_CAP = 256
CHUNK_CAVE_FEATURE_CAP = 1024

MAX_GATHERED_FEATURES = bio.MAX_GATHERED_FEATURES_PER_CHUNK
MAX_GATHERED_CAVE_FEATURES = bio.MAX_GATHERED_CAVE_FEATURES_PER_CHUNK

#: 49-chunk gather offsets (dx, dz) in the reference's spiral order
GATHER_OFFSETS = np.array(
    [
        (0, 0), (0, 1), (1, 1), (1, 0), (1, -1), (0, -1), (-1, -1),
        (-1, 0), (-1, 1), (2, 0), (2, 1), (2, 2), (1, 2), (0, 2),
        (-1, 2), (-2, 2), (-2, 1), (-2, 0), (-2, -1), (-2, -2),
        (-1, -2), (0, -2), (1, -2), (2, -2), (2, -1),
        (-3, -3), (-2, -3), (-1, -3), (0, -3), (1, -3), (2, -3), (3, -3),
        (3, -2), (3, -1), (3, 0), (3, 1), (3, 2), (3, 3),
        (2, 3), (1, 3), (0, 3), (-1, 3), (-2, 3), (-3, 3),
        (-3, 2), (-3, 1), (-3, 0), (-3, -1), (-3, -2),
    ],
    np.int32,
)


def is_feature_pos(wx, wz, cell, padding, seed):
    """isFeaturePos: is (wx, wz) the jittered point of its grid cell?

    All arguments are i32 tensors (broadcastable).  The seed enters the hash as f32,
    converted after the integer arithmetic that made it."""
    cellf = cell.to(F32)
    gx = torch.floor(div(wx.to(F32), cellf)) * cellf
    gz = torch.floor(div(wz.to(F32), cellf)) * cellf
    rx, rz = hashes.rand2_from3(gx, gz, seed.to(F32))
    internal = (cell - 2 * padding).to(F32)
    px = gx.to(I32) + padding + torch.floor(rx * internal).to(I32)
    pz = gz.to(I32) + padding + torch.floor(rz * internal).to(I32)
    return (wx == px) & (wz == pz)


def _masked_u01(state, mask):
    """Draw from the stream and advance it only where ``mask`` holds."""
    v, nxt = hashes.lcg_u01(state)
    return v, torch.where(mask, nxt, state)


def _table(table: dict, dev):
    """The gen table's arrays as tensors on ``dev`` (bool stays bool)."""
    return {k: torch.as_tensor(np.ascontiguousarray(v), device=dev)
            for k, v in table.items() if isinstance(v, np.ndarray)}


def generate_placements_plain(heightfield, biome_weights, layers, cave_starts, cave_ends,
                              cave_bottom_biome, cave_top_biome, chunk_pos):
    """Plain placement pass -> dict of dense per-column grids:
    surface_feature [B,16,16] i32 (0 = none), surface_y i32, surface_replace bool,
    cave_feature [B,16,16,32,2] i32 (slot 0 floor, 1 ceiling), cave_y, cave_height
    [B,16,16,32] i32, cave_replace [B,16,16,32,2] bool."""
    B = heightfield.shape[0]
    dev = heightfield.device
    wx, wz = column_world_coords(chunk_pos)
    ground = heightfield.to(I32)  # (int)height, truncating
    state = hashes.seed_3(wx, wz, SEED_COLUMN)

    ct = _table(fd.CAVE_FEATURE_GEN_TABLE, dev)
    n_cave_gens = fd.CAVE_FEATURE_GEN_TABLE["max_gens"]
    shape = (B, 16, 16)
    broken = torch.zeros(shape, dtype=torch.bool, device=dev)
    surface_is_cave = torch.zeros(shape, dtype=torch.bool, device=dev)
    out_cave_feature = torch.zeros((B, 16, 16, MAX_LAYERS, 2), dtype=I32, device=dev)
    out_cave_replace = torch.zeros((B, 16, 16, MAX_LAYERS, 2), dtype=torch.bool, device=dev)

    for li in range(MAX_LAYERS):
        start = cave_starts[..., li]
        end = cave_ends[..., li]
        layer_h = end - start
        stop_here = (start == 384) | (ground <= start)
        active = ~broken & ~stop_here
        for top in (False, True):
            # ceiling features only when the layer has a ceiling
            layer_ok = active & (end != 384) if top else active
            biome = (cave_top_biome if top else cave_bottom_biome)[..., li].long()
            f_seed = SEED_CAVE_TOP_F if top else SEED_CAVE_BOTTOM_F
            l_seed = SEED_CAVE_TOP_L if top else SEED_CAVE_BOTTOM_L
            lava_y = end if top else start + 1
            placed = torch.zeros(shape, dtype=torch.bool, device=dev)
            slot = 1 if top else 0
            for g in range(n_cave_gens):
                in_loop = layer_ok & ~placed & (g < ct["count"][biome])
                r, state = _masked_u01(state, in_loop)
                feat = ct["feature"][:, g][biome]
                lava_ok = ct["in_lava"][:, g][biome] | (lava_y > bio.LAVA_LEVEL)
                ok = (
                    in_loop
                    & (r < ct["chance"][:, g][biome])
                    & (ct["from_ceiling"][:, g][biome] == top)
                    & lava_ok
                    & (layer_h >= ct["min_height"][:, g][biome])
                )
                pos_seed = feat * f_seed + li * l_seed
                ok = ok & is_feature_pos(
                    wx, wz, ct["cell"][:, g][biome], ct["padding"][:, g][biome], pos_seed
                )
                out_cave_feature[..., li, slot] = torch.where(
                    ok, feat, out_cave_feature[..., li, slot])
                out_cave_replace[..., li, slot] = torch.where(
                    ok, ct["can_replace"][:, g][biome], out_cave_replace[..., li, slot])
                placed = placed | ok
        surface_here = active & (ground > start) & (ground <= end)
        surface_is_cave = surface_is_cave | surface_here
        broken = broken | stop_here | surface_here

    # ---- surface features ----
    st = _table(fd.FEATURE_GEN_TABLE, dev)
    n_gens = fd.FEATURE_GEN_TABLE["max_gens"]
    max_tl = st["top_layer_mat"].shape[-1]
    do_surface = ~surface_is_cave
    r_biome, state = _masked_u01(state, do_surface)
    biome = random_biome(biome_weights.permute(0, 2, 3, 1), r_biome).long()
    layer_starts = layers.permute(0, 2, 3, 1)  # [B,16,16,20]
    n_mat = layer_starts.shape[-1]
    height = heightfield

    surface_feature = torch.zeros(shape, dtype=I32, device=dev)
    surface_replace = torch.zeros(shape, dtype=torch.bool, device=dev)
    placed = torch.zeros(shape, dtype=torch.bool, device=dev)
    for g in range(n_gens):
        in_loop = do_surface & ~placed & (g < st["count"][biome])
        r, state = _masked_u01(state, in_loop)
        chance_ok = r < st["chance"][:, g][biome]
        # possibleTopLayers: one of the listed materials must be the top layer, thick enough
        ntl = st["n_top_layers"][:, g][biome]
        can_place = ntl == 0
        for t in range(max_tl):
            mat = st["top_layer_mat"][:, g, t][biome].long()
            l_start = torch.gather(layer_starts, -1, mat[..., None])[..., 0]
            l_end = torch.gather(layer_starts, -1, (mat + 1).clamp(max=n_mat - 1)[..., None])[..., 0]
            tl_ok = (
                (l_start <= height)
                & (l_end >= height)
                & (torch.minimum(l_end, height) - l_start >= st["top_layer_min"][:, g, t][biome])
            )
            can_place = can_place | ((t < ntl) & tl_ok)
        feat = st["feature"][:, g][biome]
        ok = (
            in_loop
            & chance_ok
            & can_place
            & is_feature_pos(wx, wz, st["cell"][:, g][biome], st["padding"][:, g][biome],
                             feat * SEED_SURFACE_POS)
        )
        surface_feature = torch.where(ok, feat, surface_feature)
        surface_replace = torch.where(ok, st["can_replace"][:, g][biome], surface_replace)
        placed = placed | ok

    return {
        "surface_feature": surface_feature,
        "surface_y": ground + 1,
        "surface_replace": surface_replace,
        "cave_feature": out_cave_feature,
        "cave_y": cave_starts + 1,
        "cave_height": cave_ends - cave_starts,
        "cave_replace": out_cave_replace,
    }


def _compact(valid, cap: int, fields: dict) -> dict:
    """Stable partition of [B, N] candidates, valid ones first, cut to ``cap``; past
    the valid entries 'feature' is 0.  'count' is the true (uncapped) number."""
    n = valid.shape[1]
    order = torch.arange(n, dtype=torch.int64, device=valid.device)
    key = torch.where(valid, order, 2**30)
    idx = torch.argsort(key, dim=-1, stable=True)[:, :cap]
    out = {k: torch.gather(v, 1, idx) for k, v in fields.items()}
    out["feature"] = torch.where(torch.gather(valid, 1, idx), out["feature"], 0)
    out["count"] = valid.sum(-1).to(I32)
    return out


def compact_placements_plain(pl, chunk_pos):
    """Dense grids -> {"surface", "cave"} dicts of [B, CAP] i32 lists (feature, x, y, z,
    replace(, height)) + [B] count, in the reference's order: columns z-major, cave
    layers bottom to top, the floor slot before the ceiling slot."""
    B = pl["surface_feature"].shape[0]
    wx, wz = column_world_coords(chunk_pos)
    sf = pl["surface_feature"].reshape(B, 256)
    surface = _compact(sf > 0, CHUNK_FEATURE_CAP, {
        "feature": sf,
        "x": wx.reshape(B, 256),
        "y": pl["surface_y"].reshape(B, 256),
        "z": wz.reshape(B, 256),
        "replace": pl["surface_replace"].reshape(B, 256).to(I32),
    })
    full = pl["cave_feature"].shape
    cf = pl["cave_feature"].reshape(B, -1)
    cave = _compact(cf > 0, CHUNK_CAVE_FEATURE_CAP, {
        "feature": cf,
        "x": wx[..., None, None].expand(full).reshape(B, -1),
        "y": pl["cave_y"][..., None].expand(full).reshape(B, -1),
        "z": wz[..., None, None].expand(full).reshape(B, -1),
        "height": pl["cave_height"][..., None].expand(full).reshape(B, -1),
        "replace": pl["cave_replace"].reshape(B, -1).to(I32),
    })
    return {"surface": surface, "cave": cave}


def generate_placements(heightfield, biome_weights, layers, cave_starts, cave_ends,
                        cave_bottom_biome, cave_top_biome, chunk_pos):
    """Placement grids: K5 on CUDA, the plain version on the CPU."""
    args = (heightfield, biome_weights, layers, cave_starts, cave_ends,
            cave_bottom_biome, cave_top_biome, chunk_pos)
    return generate_placements_plain(*args)


def compact_placements(pl, chunk_pos):
    """Per-chunk placement lists: K6 on CUDA, the plain version on the CPU."""
    return compact_placements_plain(pl, chunk_pos)


def gather_from_neighborhood(per_chunk_lists, cap: int):
    """Concatenate 49 per-chunk lists (dict of [49, K]) in ``GATHER_OFFSETS`` order and
    keep the first ``cap`` valid entries (feature > 0), in that order: the reference's
    gather cap.  A ``count`` entry is ignored: only the valid entries the lists hold are
    ranked.  Returns dict of [cap]; past the valid entries 'feature' is 0."""
    one = gather_from_neighborhood_batch({k: v[None] for k, v in per_chunk_lists.items()}, cap)
    return {k: v[0] for k, v in one.items()}


def gather_from_neighborhood_batch(per_chunk_lists, cap: int):
    """Batched 49-chunk gather: dict of [B, 49, K] -> dict of [B, cap]."""
    flat = {k: v.reshape(v.shape[0], -1) for k, v in per_chunk_lists.items() if k != "count"}
    out = _compact(flat["feature"] > 0, cap, flat)
    del out["count"]
    return out
