"""Pipeline: heightfield -> layers -> caves -> fill, and with ``features=True`` feature
placement -> SDF features -> decorators, over a chunk area.

Port of ``mega_minecraft_tpu/terrain/pipeline.py`` (``generate_area_fused`` with its
two halves, and ``generate_area``, whose ``erode=True`` erodes a 24x24-chunk area as
one zone grid between layers and caves).  Every stage dispatches on the device of
``pos_halo``: on CUDA the area is a chain of kernel launches (K1, K2, with erosion K9,
then K3, K4, and with features K5-K8 and the stream pre-kernel) with no host round trip
between them; on the CPU it runs the plain versions.
"""

from __future__ import annotations

import numpy as np
import torch

from . import caves as caves_mod
from . import decorators, erosion, feature_placement, features as features_mod, fill, heightfield
from . import layers


def feature_half(blocks, hf, w, ls, cv, pos, ncx: int, ncz: int):
    """Placements -> per-chunk lists -> area-level SDF features -> decorators
    (``_fused_feature_half``).  Returns (blocks, placement lists)."""
    pl = feature_placement.generate_placements(
        hf, w, ls, cv["starts"], cv["ends"], cv["bottom_biome"], cv["top_biome"], pos)
    lists = feature_placement.compact_placements(pl, pos)
    blocks = features_mod.apply_features_area(blocks, lists["surface"], lists["cave"], pos, ncx, ncz)
    blocks = decorators.place_decorators_batch(
        blocks, hf, w, cv["starts"], cv["ends"], cv["bottom_biome"], pos)
    return blocks, lists


def generate_area_fused(pos_halo, ncx: int, ncz: int, features: bool = False):
    """The per-chunk pipeline for an ``ncx x ncz`` area (no erosion).

    Args:
      pos_halo: [(ncz+2)*(ncx+2), 2] i32 world-block chunk origins, row-major with the
        1-chunk halo included, on the device to run on.
      features: also place SDF features and decorators.  Only placements generated
        inside the area exist, so features of chunks beyond its edge are missing.
    Returns dict of tensors for the ncx*ncz inner chunks: blocks [B,16,16,384] u8,
    heightfield, biome_weights, layers, caves (dict), chunk_pos, and with features
    ``placements`` (the per-chunk lists).
    """
    return _area(pos_halo, ncx, ncz, features, erode=False)


def _area(pos_halo, ncx: int, ncz: int, features: bool, erode: bool):
    hf, w = heightfield.generate_heightfield(pos_halo)
    # with erosion the backward-stratified fix waits until after it (it reads layer 12)
    st = layers.layers_from_halo(hf, w, pos_halo, ncx, ncz, fix_backward=not erode)
    if erode:
        # the whole area is the zone grid: slot table = row-major chunk index; eroded
        # in place, then the fix over all 576 chunks
        gslots = torch.arange(ncx * ncz, dtype=torch.int32, device=hf.device).reshape(ncz, ncx)
        erosion.erode_zone_slots(st["layers"], st["heightfield"], gslots, fix_all=True)
    cv = caves_mod.generate_caves(st["heightfield"], st["biome_weights"], st["chunk_pos"])
    blocks = fill.fill_chunks(
        st["heightfield"], st["biome_weights"], st["layers"], cv["starts"], cv["ends"],
        st["chunk_pos"],
    )
    out = {
        "blocks": blocks,
        "heightfield": st["heightfield"],
        "biome_weights": st["biome_weights"],
        "layers": st["layers"],
        "caves": cv,
        "chunk_pos": st["chunk_pos"],
    }
    if features:
        out["blocks"], out["placements"] = feature_half(
            blocks, st["heightfield"], st["biome_weights"], st["layers"], cv, st["chunk_pos"],
            ncx, ncz)
    return out


def chunk_positions(cx0: int, cz0: int, ncx: int, ncz: int, device) -> torch.Tensor:
    """[ncz*ncx, 2] i32 world-block origins of the chunks at chunk coords (cx0, cz0)+,
    row-major (x fastest)."""
    iz, ix = np.meshgrid(np.arange(ncz), np.arange(ncx), indexing="ij")
    pos = np.stack([(cx0 + ix) * 16, (cz0 + iz) * 16], axis=-1).reshape(-1, 2)
    return torch.as_tensor(pos.astype(np.int32), device=device)


def generate_area(cx0: int, cz0: int, ncx: int, ncz: int, erode: bool = False,
                  features: bool = False, *, device):
    """Generate the ``ncx x ncz``-chunk area at chunk coords (cx0, cz0) on ``device``.
    ``erode`` erodes the area as one zone grid (its 12x12 core), which needs a
    24x24-chunk area.

    Returns the dict of ``generate_area_fused`` with blocks shaped [ncz, ncx, 16, 16, 384]
    (with ``features`` also ``placements``, as the JAX function returns them).
    """
    if erode and (ncx, ncz) != (erosion.GRID_CHUNKS, erosion.GRID_CHUNKS):
        raise ValueError("erode=True requires a 24x24-chunk area (one full zone grid)")
    pos_halo = chunk_positions(cx0 - 1, cz0 - 1, ncx + 2, ncz + 2, device=device)
    out = _area(pos_halo, ncx, ncz, features, erode)
    out["blocks"] = out["blocks"].reshape(ncz, ncx, 16, 16, 384)
    return out
