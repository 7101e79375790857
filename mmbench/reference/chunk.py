"""The plain reference of generated chunks, from their world coordinates alone.

Both functions take a k x k cluster of adjacent chunks: the cluster's feature sources are
shared, so k x k chunks cost little more than one.

``area_chunks``: the cluster at (ix0, iz0) of an n x n area generated as
``generate_area_fused(..., features=True)`` generates it (no erosion): only placements of
chunks inside the area exist, so the reference generates the sub-area of the cluster's
feature sources (7 x 7 around each chunk) that lies inside the area (with its one-chunk halo
for the layers), and applies the features of the cluster's chunks alone, by the
gathered-list semantics of the area path (a source ranked by its true count).

``streamed_chunks``: a cluster of the streaming scheduler's slot table, whose layers come
from zone erosion.  The reference recomputes the heightfield, the biome weights and the caves
of the cluster's (k + 6) x (k + 6) sources from their coordinates, takes their eroded layers
as given, and applies the features by the slot path's semantics (a source ranked by
min(count, K)).

``precision="bf16"`` rounds the heightfield and the biome weights to bfloat16 right after
they are computed: the control of the comparison (the nearest precision below float32).
"""

from __future__ import annotations

import numpy as np
import torch

from .terrain import caves, decorators, feature_placement as fp, features, fill, heightfield, layers
from .terrain.feature_placement import GATHER_OFFSETS

#: chunks from a consumer to its farthest feature source (the 7 x 7 gather)
REACH = 3


def positions(cx0: int, cz0: int, ncx: int, ncz: int, device) -> torch.Tensor:
    """[ncz*ncx, 2] i32 world-block origins of the chunks at chunk (cx0, cz0)+, row-major."""
    iz, ix = np.meshgrid(np.arange(ncz), np.arange(ncx), indexing="ij")
    pos = np.stack([(cx0 + ix) * 16, (cz0 + iz) * 16], axis=-1).reshape(-1, 2)
    return torch.as_tensor(pos.astype(np.int32), device=device)


def _round(t, precision: str):
    if precision == "f32":
        return t
    if precision == "bf16":
        return t.to(torch.bfloat16).to(torch.float32)
    raise ValueError(f"unknown precision {precision!r}")


def _heightfield(pos, precision):
    hf, w = heightfield.generate_heightfield_plain(pos)
    return _round(hf, precision), _round(w, precision)


def _finish(rows, list_rows, hf, w, ls, cv, pos, surf, cave):
    """The blocks of the chunks ``rows`` (indices of the per-chunk inputs), their culled
    feature lists the rows ``list_rows`` of ``surf`` and ``cave``: fill, features,
    decorators."""
    dev = hf.device
    r = torch.as_tensor(rows, device=dev)
    lr = torch.as_tensor(list_rows)
    hf, w, ls, pos = (t.index_select(0, r) for t in (hf, w, ls, pos))
    cv = {k: v.index_select(0, r) for k, v in cv.items()}
    base = fill.fill_chunks_plain(hf, w, ls, cv["starts"], cv["ends"], pos)
    # the culled lists go to the blocks' device: there the SDF evaluation of a list entry is
    # the one the kernels hold to (with the entries on the host, torch's mixed-device
    # arithmetic moves some voxels at a feature's boundary)
    blocks = features.apply_culled_plain(base, (surf[0][lr].to(dev), surf[1][lr]),
                                         (cave[0][lr].to(dev), cave[1][lr]), pos)
    return decorators.place_decorators_batch_plain(blocks, hf, w, cv["starts"], cv["ends"],
                                                   cv["bottom_biome"], pos)


def _lists(hf, w, ls, cv, pos):
    pl = fp.generate_placements_plain(hf, w, ls, cv["starts"], cv["ends"], cv["bottom_biome"],
                                      cv["top_biome"], pos)
    return fp.compact_placements_plain(pl, pos)


def sub_area(n: int, ix0: int, iz0: int, k: int):
    """(x0, x1, z0, z1), inclusive: the feature sources inside an n x n area of the k x k
    cluster of chunks at (ix0, iz0)."""
    return (max(ix0 - REACH, 0), min(ix0 + k - 1 + REACH, n - 1),
            max(iz0 - REACH, 0), min(iz0 + k - 1 + REACH, n - 1))


def area_chunks(area_cx: int, area_cz: int, n: int, ix0: int, iz0: int, k: int, device,
                precision: str = "f32"):
    """The k x k cluster of chunks at (ix0, iz0) of the featured n x n area at chunk
    (area_cx, area_cz) (the cluster inside the area).  Returns the cluster's blocks
    [k * k, 16, 16, 384] u8, row-major, and the heightfield, biome weights and layers of the
    sub-area (``sub_area``), row-major, with its bounds."""
    x0, x1, z0, z1 = sub_area(n, ix0, iz0, k)
    ncx, ncz = x1 - x0 + 1, z1 - z0 + 1
    pos_halo = positions(area_cx + x0 - 1, area_cz + z0 - 1, ncx + 2, ncz + 2, device)
    hf_h, w_h = _heightfield(pos_halo, precision)
    st = layers.layers_from_halo_plain(hf_h, w_h, pos_halo, ncx, ncz, fix_backward=True)
    hf, w, ls, pos = st["heightfield"], st["biome_weights"], st["layers"], st["chunk_pos"]
    cv = caves.generate_caves_plain(hf, w, pos)
    lists = _lists(hf, w, ls, cv, pos)
    surf = features.cull_area_plain(lists["surface"], pos, ncx, ncz, cave=False)
    cave = features.cull_area_plain(lists["cave"], pos, ncx, ncz, cave=True)
    rows = [(iz0 + dz - z0) * ncx + (ix0 + dx - x0) for dz in range(k) for dx in range(k)]
    return {"blocks": _finish(rows, rows, hf, w, ls, cv, pos, surf, cave), "heightfield": hf,
            "biome_weights": w, "layers": ls, "bounds": (x0, x1, z0, z1)}


def source_rows(side: int, dx: int, dz: int) -> np.ndarray:
    """[49] row-major indices, in a grid ``side`` chunks wide whose consumers start ``REACH``
    chunks in from its corner, of the sources of consumer (dx, dz), in gather (spiral)
    order."""
    return np.array([(oz + REACH + dz) * side + (ox + REACH + dx) for ox, oz in GATHER_OFFSETS],
                    np.int64)


def streamed_chunks(cx0: int, cz0: int, k: int, eroded_layers, device, precision: str = "f32"):
    """The k x k cluster of chunks at chunk (cx0, cz0) of the streaming world.
    ``eroded_layers`` [(k + 6)^2, 20, 16, 16] f32: the layers of its sources, row-major from
    chunk (cx0 - 3, cz0 - 3).  Returns the blocks [k * k, 16, 16, 384] u8, row-major, and the
    sources' heightfield, biome weights and cave arrays."""
    side = k + 2 * REACH
    pos = positions(cx0 - REACH, cz0 - REACH, side, side, device)
    hf, w = _heightfield(pos, precision)
    ls = eroded_layers.to(device)
    cv = caves.generate_caves_plain(hf, w, pos)
    lists = _lists(hf, w, ls, cv, pos)
    consumers = [(dz + REACH) * side + dx + REACH for dz in range(k) for dx in range(k)]
    nslots = torch.as_tensor(np.stack([source_rows(side, dx, dz) for dz in range(k) for dx in range(k)]))
    cpos = pos[torch.as_tensor(consumers, device=pos.device)]
    surf = features.cull_slots_plain(lists["surface"], nslots, cpos, cave=False)
    cave = features.cull_slots_plain(lists["cave"], nslots, cpos, cave=True)
    blocks = _finish(consumers, list(range(k * k)), hf, w, ls, cv, pos, surf, cave)
    return {"blocks": blocks, "heightfield": hf, "biome_weights": w, "caves": cv}
