"""Halo gathers: per-chunk arrays -> halo'd arrays (plain version).

Port of ``mega_minecraft_tpu/terrain/gather.py:15-36`` and the 18x18 halo slice of
``pipeline.py:58-66``.  On the kernel path these gathers are folded into kernels K2 and
K2s (``csrc/layers.cu`` reads the heightfields by index arithmetic, over an area's halo
grid or through the scheduler's 3x3 slot table).
"""

from __future__ import annotations

import torch


def assemble_chunk_grid(per_chunk):
    """[CZ, CX, 16, 16] per-chunk arrays ([z, x] within chunk) -> [CZ*16, CX*16]."""
    cz, cx = per_chunk.shape[0], per_chunk.shape[1]
    return per_chunk.permute(0, 2, 1, 3).reshape(cz * 16, cx * 16)


def split_chunk_grid(grid, cz: int, cx: int):
    """Inverse of assemble_chunk_grid."""
    return grid.reshape(cz, 16, cx, 16).permute(0, 2, 1, 3)


def inner_indices(ncx: int, ncz: int, device) -> torch.Tensor:
    """Row-major halo-grid indices of the ncz x ncx inner chunks."""
    hx = ncx + 2
    iz = torch.arange(ncz, device=device)[:, None]
    ix = torch.arange(ncx, device=device)[None, :]
    return ((iz + 1) * hx + ix + 1).reshape(-1)


def gather_halo_heightfields(hf_halo, ncx: int, ncz: int):
    """[(ncz+2)(ncx+2), 16, 16] halo'd heightfields -> [ncz*ncx, 18, 18] windows
    (each inner chunk plus a 1-block ring from its neighbours)."""
    full = assemble_chunk_grid(hf_halo.reshape(ncz + 2, ncx + 2, 16, 16))
    # windows start at block (16 * i + 15) on each axis: [ncz, ncx, 18 (z), 18 (x)]
    wins = full[15:, 15:].unfold(0, 18, 16).unfold(1, 18, 16)
    return wins.reshape(ncz * ncx, 18, 18).contiguous()


def gather_heightfield_3x3(hf_3x3):
    """[3, 3, 16, 16] neighbourhood ([cz, cx, z, x]) -> [18, 18] window: the centre chunk
    and a 1-block ring from its neighbours."""
    return assemble_chunk_grid(hf_3x3)[15:33, 15:33]


def gather_heightfields_batch(hf_neighborhoods):
    """[B, 3, 3, 16, 16] -> [B, 18, 18]."""
    B = hf_neighborhoods.shape[0]
    full = hf_neighborhoods.permute(0, 1, 3, 2, 4).reshape(B, 48, 48)
    return full[:, 15:33, 15:33].contiguous()
