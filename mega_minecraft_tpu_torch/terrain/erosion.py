"""Stage 3: zone erosion, the slope method over a 24x24-chunk grid (kernel K9).

Port of ``mega_minecraft_tpu/terrain/erosion.py``.  A zone's 12x12 core chunks plus a
6-chunk ring are gathered into a [9, 384, 384] grid: the start heights of the 8 eroded
layers (materials GRAVEL..SNOW) and the heightfield.  Top layer first, each layer is
relaxed by synchronous Jacobi sweeps: a column's start rises to
``max(neighbour start - tan(angle of repose) * distance)``, clamped to the layer's end,
wherever its 3x3 neighbourhood holds any positive thickness, until a sweep changes
nothing.  The first sweep of a layer reads the starts and ends plus the per-column sum
of every earlier rise (``accum``); later sweeps read the raw layer.  There is no cap on
the sweeps.  The eroded core is written back into the chunks' layers.

``erode_zone`` / ``erode_zone_slots`` dispatch on the device: CUDA tensors go to K9 in
``csrc/erosion.cu`` (one cooperative launch per zone, the loop and its convergence flag
on the device); CPU tensors to the plain versions below, which repeat the JAX program
operation by operation (bit for bit).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from ..world import biomes as bio
from .layers import fix_backward_stratified

SQRT_2 = np.float32(1.41421356237309504880)

ZONE_SIZE = 12  # chunks per zone side
GRID_CHUNKS = ZONE_SIZE * 2  # 24x24-chunk gathered grid incl. the 6-chunk ring
GRID_BLOCKS = GRID_CHUNKS * 16  # 384
CORE_LO = (ZONE_SIZE // 2) * 16  # 96: start of the written-back core
CORE_HI = CORE_LO + ZONE_SIZE * 16  # 288
N_ERODED = bio.NUM_ERODED_MATERIALS  # 8
N_STRAT = bio.NUM_STRATIFIED_MATERIALS  # 12


def repose_offsets() -> np.ndarray:
    """[8 layers, 8 directions] f32: tan(angle of repose) * distance, the f32 product
    the JAX program subtracts (distance 1 or sqrt(2) by direction parity)."""
    out = np.zeros((N_ERODED, len(bio.DIR_VECS_2D)), np.float32)
    for rel in range(N_ERODED):
        tan = np.float32(float(bio.MATERIAL_AMPLITUDE_OR_TAN_REPOSE[N_STRAT + rel]))
        for i in range(len(bio.DIR_VECS_2D)):
            out[rel, i] = tan * (SQRT_2 if i % 2 == 1 else np.float32(1.0))
    return out


def _shift_edge_clamp(a, dx: int, dz: int, rows=None, halo: int = 0):
    """a[z, x] read at (z + dz, x + dx) for the rows z of ``a`` less ``halo`` rows above and
    below: x clamped to the grid's edge, z to ``rows`` = (lo, hi) (default: those rows, the
    grid's edge replicated); lo = -1 or hi = their count reads a halo row."""
    nz = a.shape[0] - 2 * halo
    lo, hi = (0, nz - 1) if rows is None else rows
    iz = (torch.arange(nz, device=a.device) + dz).clamp(lo, hi) + halo
    ix = (torch.arange(a.shape[1], device=a.device) + dx).clamp(0, a.shape[1] - 1)
    return a.index_select(0, iz).index_select(1, ix)


def _relax_once(start, end, offsets, rows=None, halo: int = 0):
    """One Jacobi sweep -> (start where written else new start, written mask, changed) of
    the rows of ``start`` / ``end`` less ``halo`` rows above and below, which only
    neighbours read (a row band's halo; ``rows`` as in ``_shift_edge_clamp``)."""
    s = start[halo:start.shape[0] - halo]
    e = end[halo:end.shape[0] - halo]
    new_start = s
    max_thickness = e - s
    for i, (dx, dz) in enumerate(bio.DIR_VECS_2D):
        nb_start = _shift_edge_clamp(start, int(dx), int(dz), rows, halo)
        nb_end = _shift_edge_clamp(end, int(dx), int(dz), rows, halo)
        new_start = torch.maximum(new_start, nb_start - offsets[i])
        max_thickness = torch.maximum(max_thickness, nb_end - nb_start)
    new_start = torch.minimum(new_start, e)
    wrote = max_thickness > 0.0
    changed = wrote & (new_start != s)
    return torch.where(wrote, new_start, s), wrote, changed


def erode_zone_plain(gathered_layers, iterations: list | None = None):
    """Plain erosion of one gathered grid: [9, 384, 384] f32 -> eroded copy (slot 8,
    the heightfield, unchanged).  Appends each layer's sweep count, top layer first, to
    ``iterations`` when given."""
    g = gathered_layers.clone()
    offs = torch.as_tensor(repose_offsets(), device=g.device)
    accum = torch.zeros((GRID_BLOCKS, GRID_BLOCKS), dtype=torch.float32, device=g.device)
    zero = torch.zeros((), dtype=torch.float32, device=g.device)
    for rel in range(N_ERODED - 1, -1, -1):
        start = g[rel] + accum
        end = g[rel + 1] + accum
        new_start, wrote, changed = _relax_once(start, end, offs[rel])
        accum = accum + torch.where(changed, new_start - start, zero)
        # written columns take the accum-included value, the others keep the raw one
        layer = torch.where(wrote, new_start, g[rel])
        sweeps = 1
        while bool(changed.any()):
            s = layer
            new_start, wrote, changed = _relax_once(s, g[rel + 1], offs[rel])
            accum = accum + torch.where(changed, new_start - s, zero)
            layer = torch.where(wrote, new_start, layer)
            sweeps += 1
        g[rel] = layer
        if iterations is not None:
            iterations.append(sweeps)
    return g


def gather_zone_layers(layers_grid, heightfield_grid):
    """[24, 24, 20, 16, 16] per-chunk layers ([cz, cx, l, z, x]) and [24, 24, 16, 16]
    heightfields -> the [9, 384, 384] gathered grid."""
    eroded = layers_grid[:, :, N_STRAT:].permute(2, 0, 3, 1, 4).reshape(N_ERODED, GRID_BLOCKS,
                                                                        GRID_BLOCKS)
    hf = heightfield_grid.permute(0, 2, 1, 3).reshape(1, GRID_BLOCKS, GRID_BLOCKS)
    return torch.cat([eroded, hf], dim=0)


def scatter_zone_layers(layers_grid_core, eroded):
    """Write the eroded starts back into the core chunks' layers: [12, 12, 20, 16, 16]
    and [9, 384, 384] -> updated [12, 12, 20, 16, 16] copy."""
    core = eroded[:N_ERODED, CORE_LO:CORE_HI, CORE_LO:CORE_HI]
    core = core.reshape(N_ERODED, ZONE_SIZE, 16, ZONE_SIZE, 16).permute(1, 3, 0, 2, 4)
    out = layers_grid_core.clone()
    out[:, :, N_STRAT:] = core
    return out


def erode_zone_slots_plain(layers, heightfield, gslots, fix_all: bool = False,
                           iterations: list | None = None):
    """Plain zone erosion over a slot table, in place: ``layers`` [N, 20, 16, 16] f32
    (backward-stratified slots unfixed) and ``heightfield`` [N, 16, 16] f32 read through
    ``gslots`` [24, 24] (the zone's chunks, [cz, cx]); the eroded 12x12 core is written
    back and ``fix_backward_stratified`` applied to the core chunks, or with ``fix_all``
    to all 576 chunks of the grid.  Returns ``layers``."""
    flat = gslots.reshape(-1).long()
    lg = layers[flat].reshape(GRID_CHUNKS, GRID_CHUNKS, *layers.shape[1:])
    hg = heightfield[flat].reshape(GRID_CHUNKS, GRID_CHUNKS, 16, 16)
    eroded = erode_zone_plain(gather_zone_layers(lg, hg), iterations)
    half = ZONE_SIZE // 2
    core = scatter_zone_layers(lg[half:half + ZONE_SIZE, half:half + ZONE_SIZE], eroded)
    lg[half:half + ZONE_SIZE, half:half + ZONE_SIZE] = core
    if fix_all:
        layers[flat] = fix_backward_stratified(lg.reshape(-1, *layers.shape[1:]))
    else:
        core_slots = gslots[half:half + ZONE_SIZE, half:half + ZONE_SIZE].reshape(-1).long()
        layers[core_slots] = fix_backward_stratified(core.reshape(-1, *layers.shape[1:]))
    return layers


def erode_zone(gathered_layers):
    """Erosion of one gathered [9, 384, 384] grid: K9 on CUDA, the plain version on the
    CPU.  Returns the eroded grid."""
    if gathered_layers.is_cuda:
        return kernels.erode_zone(gathered_layers)[0]
    kernels.require_cpu(gathered_layers)
    return erode_zone_plain(gathered_layers)


def erode_zone_slots(layers, heightfield, gslots, fix_all: bool = False):
    """Zone erosion over a slot table, in place (see ``erode_zone_slots_plain``): one
    launch of K9 on CUDA (gather, sweeps, write-back and fix), the plain version on the
    CPU.  Returns ``layers``."""
    if layers.is_cuda:
        kernels.erode_zone_slots(layers, heightfield, gslots, fix_all)
        return layers
    kernels.require_cpu(layers)
    return erode_zone_slots_plain(layers, heightfield, gslots, fix_all)
