"""Stage 4: caves + cave biomes (kernel K3).

Port of ``mega_minecraft_tpu/terrain/caves.py:51-254``.  ``generate_caves`` dispatches
on the device: CUDA tensors go to ``csrc/caves.cu`` (the 3-D carve test below
``CARVE_Y_MAX`` in tiles of 256 blocks, whose Worley cells are hashed once a tile into a
shared-memory table of ``CELL_TABLE_CAP`` cells, then one CTA per 32 columns for the
per-column terms, each column's flips in ascending y and the cave biomes at the layer
edges); CPU tensors go to the plain version, which compacts flips with a sort as JAX does.
"""

from __future__ import annotations

import torch

from ..world import biomes as bio

from ..ops import hashes
from ..ops.hashes import div
from ..ops.noise import (
    fbm2,
    fbm2_from2,
    fbm3,
    fbm3_from3,
    simplex3,
    smoothstep,
    special_cave_noise,
    worley2,
)
from ..tables import CARVE_Y_MAX, SEED_BOTTOM_BIOME, SEED_TOP_BIOME, Y_SIZE
from .heightfield import column_world_coords

MAX_LAYERS = bio.MAX_CAVE_LAYERS_PER_COLUMN  # 32
#: cells of K3's shared-memory table of Worley jitters (3 floats a cell): the cell box of a
#: tile's warped carve points with the +-1 ring.  A chunk's whole box, which holds any of
#: its tiles' boxes, holds at most 96 cells (4 x 6 x 4) at the chunks that
#: tests/test_torch_caves.py measures; a tile whose box is larger takes the kernel's direct
#: path, which hashes every cell it reads.
CELL_TABLE_CAP = 128


def band_coords(chunk_pos):
    """[B, 2] -> the f32 world coordinates of the blocks below ``CARVE_Y_MAX``, broadcastable:
    wx [B, 16, 16, 1], wy [144], wz [B, 16, 16, 1]."""
    wx, wz = column_world_coords(chunk_pos)
    wyf = torch.arange(CARVE_Y_MAX, dtype=torch.float32, device=chunk_pos.device)
    return wx.to(torch.float32)[..., None], wyf, wz.to(torch.float32)[..., None]


def carve_threshold(wxf, wyf, wzf, ocean_beach_weight):
    """The threshold of the 3-D 'carved' term (caves.py:51-70): where it is <= 0.04 no
    block is carved, whatever the Worley noise."""
    nx = wxf * 0.0050
    ny = wyf * 0.0050
    nz = wzf * 0.0050
    top_ratio = smoothstep(142.0, 95.0, wyf + ocean_beach_weight * 50.0)
    bottom_ratio = smoothstep(5.0, 20.0, wyf)
    thr = 0.24 + 0.12 * fbm3(nx * 4.0, ny * 4.0, nz * 4.0, octaves=4)
    huge = smoothstep(0.2, 0.4, fbm3(nx * 0.07, ny * 0.07, nz * 0.07, octaves=4))
    thr = thr * (1.0 + 1.4 * huge)
    return thr * top_ratio * (0.3 + 0.7 * bottom_ratio)


def carve_warp(wxf, wyf, wzf):
    """The domain-warped point at which the carve test's Worley search centres (caves.py:
    57-59): three tensors, in Worley cells."""
    nx = wxf * 0.0050
    ny = wyf * 0.0050
    nz = wzf * 0.0050
    ox, oy, oz = fbm3_from3(nx * 0.8, ny * 0.8, nz * 0.8, octaves=5)
    return nx + ox * 1.8, ny * 1.6 + oy * 1.8, nz + oz * 1.8


def _carved(wxf, wyf, wzf, ocean_beach_weight):
    """The 3-D 'carved' term of the cave test (caves.py:51-70)."""
    cave_noise = special_cave_noise(*carve_warp(wxf, wyf, wzf))
    thr = carve_threshold(wxf, wyf, wzf, ocean_beach_weight)
    return (thr > 0.04) & (cave_noise < thr)


def _ravine_min_y(wxf, wzf, ocean_beach_weight):
    """Per-column ravine threshold (caves.py:73-98): +1e9 where there is no ravine."""
    rx = wxf * 0.0015
    rz = wzf * 0.0015
    wofx, wofz = fbm2_from2(rx * 10.0, rz * 10.0, octaves=4)
    rav = worley2(rx + 0.03 * wofx, rz + 0.03 * wofz, want_color=True)
    rav_worley = rav["f1"]
    rav_thr = 0.12 * (1.0 - ocean_beach_weight)
    in_rav_cell = rav_worley < rav_thr

    rav_top = 120.0 + 24.0 * rav["color"][0]
    rav_ratio = 1.0 - div(rav_worley, rav_thr)
    rav_depth = 60.0 + 26.0 * fbm2(rx * 8.0 + 8391.32, rz * 8.0 + 4821.39, octaves=4)
    rav_depth = rav_depth * smoothstep(0.0, 0.3, rav_ratio)
    wave_off = 4.0 * fbm2(rx * 3.0 + 5129.32, rz * 3.0 + 1392.49, octaves=4)
    wave = smoothstep(0.4, 0.6, torch.sin((rx + rz) * 15.0 + wave_off))
    rav_depth = rav_depth * wave
    ok = in_rav_cell & (rav_depth > 0.0001)
    return torch.where(ok, rav_top - rav_depth, 1e9)


def ocean_beach_weight(biome_weights):
    """[B, 24, 16, 16] -> [B, 16, 16]: sum of the ocean + beach biome weights, in order."""
    acc = biome_weights[:, 0]
    for b in range(1, bio.NUM_OCEAN_AND_BEACH_BIOMES):
        acc = acc + biome_weights[:, b]
    return acc


def cave_biome_noise(wxf, wyf, wzf, max_height):
    """getCaveBiomeNoise (caves.py:128-159) -> [..., 4] (none, shallow, warped, rocky)."""
    ox, oy, oz = fbm3_from3(wxf * 0.0470, wyf * 0.0470, wzf * 0.0470, octaves=3)
    px = wxf + ox * 30.0
    py = wyf + oy * 24.0
    pz = wzf + oz * 30.0
    n2x = px * 0.2
    n2z = pz * 0.2
    top_h = float(bio.SEA_LEVEL) + 0.15 * (max_height - float(bio.SEA_LEVEL))

    none_start = top_h - 19.0 + 23.0 * fbm2(n2x, n2z, octaves=3)
    none_end = none_start - 5.0 + 3.0 * fbm2(n2x + 3821.34, n2z + 4920.32, octaves=3)
    shallow_start = top_h - 72.0 + 18.0 * fbm2(n2x + -4921.34, n2z + 8402.13, octaves=3)
    shallow_end = shallow_start - 10.0 + 7.0 * fbm2(n2x + 9411.32, n2z + -3921.34, octaves=3)

    none = smoothstep(none_end, none_start, py)
    shallow = smoothstep(shallow_end, shallow_start, py)

    def single(scale, offx, offy, offz, thr):
        s = simplex3(px * scale + offx, py * scale + offy, pz * scale + offz)
        return smoothstep(-thr, thr, s)

    warped = single(0.0030, 5821.32, 4920.12, 7931.59, 0.05)
    rocky = single(0.0022, -9193.23, -6813.39, -2171.23, 0.05)
    return torch.stack([none, shallow, warped, rocky], dim=-1)


def cave_biome_weights_from_noise(noise4):
    """[..., 4] -> [..., 5]: per cave biome, the product of its used channels in order."""
    cols = []
    for cb in range(bio.NUM_CAVE_BIOMES):
        w = None
        for c, kind in enumerate(bio.CAVE_BIOME_NOISE_WEIGHTS[cb]):
            if kind == 0:
                continue
            term = noise4[..., c] if kind == 1 else 1.0 - noise4[..., c]
            w = term if w is None else w * term
        cols.append(torch.ones_like(noise4[..., 0]) if w is None else w)
    return torch.stack(cols, dim=-1)


def get_cave_biome(wx, wy, wz, max_height, seed: int):
    """getCaveBiome: weighted pick of a cave biome by one seeded u01 draw.
    wx / wy / wz: i32 tensors; max_height: f32 (broadcastable)."""
    weights = cave_biome_weights_from_noise(
        cave_biome_noise(wx.to(torch.float32), wy.to(torch.float32), wz.to(torch.float32), max_height)
    )
    rand, _ = hashes.lcg_u01(hashes.seed_4(wx, wy, wz, seed))
    running = torch.zeros_like(rand)
    out = torch.full_like(wx, int(bio.CaveBiome.NONE), dtype=torch.int32)
    picked = torch.zeros_like(rand, dtype=torch.bool)
    for cb in range(bio.NUM_CAVE_BIOMES):
        running = running + weights[..., cb]
        cond = (rand - running) <= 0.0
        out = torch.where(cond & ~picked, cb, out)
        picked = picked | cond
    return out.to(torch.int32)


def carve_band_plain(biome_weights, chunk_pos):
    """The 3-D carve test of every block below ``CARVE_Y_MAX``: [B, 24, 16, 16], [B, 2] ->
    [B, 16, 16, 144] bool (K3's carve band)."""
    return _carved(*band_coords(chunk_pos), ocean_beach_weight(biome_weights)[..., None])


def generate_caves_plain(heightfield, biome_weights, chunk_pos):
    """Plain stage 4: [B,16,16], [B,24,16,16], [B,2] -> dict of [B,16,16,32] i32
    starts (384 = none), ends (384 = open to sky), bottom_biome, top_biome."""
    B = heightfield.shape[0]
    dev = heightfield.device
    wx, wz = column_world_coords(chunk_pos)
    wy = torch.arange(Y_SIZE, dtype=torch.int32, device=dev)
    wyf = wy.to(torch.float32)
    obw = ocean_beach_weight(biome_weights)

    carved_band = carve_band_plain(biome_weights, chunk_pos)
    carved = torch.zeros((B, 16, 16, Y_SIZE), dtype=torch.bool, device=dev)
    carved[..., :CARVE_Y_MAX] = carved_band
    above_surface = wyf > torch.clamp_min(torch.floor(heightfield[..., None]), float(bio.SEA_LEVEL))
    rav_min_y = _ravine_min_y(wx.to(torch.float32), wz.to(torch.float32), obw)
    ravine = wyf > rav_min_y[..., None]
    cave = (above_surface | carved | ravine) & (wy != 0)

    filled = ~cave
    next_filled = torch.cat([filled[..., 1:], torch.zeros_like(filled[..., :1])], dim=-1)
    flips = filled != next_filled

    keys = torch.where(flips, wy, 9999)
    sorted_keys = torch.sort(keys, dim=-1).values[..., : 2 * MAX_LAYERS]
    starts = torch.clamp_max(sorted_keys[..., 0::2], Y_SIZE).to(torch.int32).contiguous()
    ends = torch.clamp_max(sorted_keys[..., 1::2], Y_SIZE).to(torch.int32).contiguous()

    max_h = heightfield[..., None]
    wxl = wx[..., None].expand(B, 16, 16, MAX_LAYERS)
    wzl = wz[..., None].expand(B, 16, 16, MAX_LAYERS)
    bottom = get_cave_biome(wxl, starts, wzl, max_h, SEED_BOTTOM_BIOME)
    bottom = torch.where(starts != Y_SIZE, bottom, 0)
    top = get_cave_biome(wxl, ends + 1, wzl, max_h, SEED_TOP_BIOME)
    top = torch.where(ends != Y_SIZE, top, int(bio.CaveBiome.NONE))
    return {
        "starts": starts,
        "ends": ends,
        "bottom_biome": bottom.to(torch.int32).contiguous(),
        "top_biome": top.to(torch.int32).contiguous(),
    }


def generate_caves(heightfield, biome_weights, chunk_pos):
    """Stage 4: K3 on CUDA, the plain version on the CPU."""
    return generate_caves_plain(heightfield, biome_weights, chunk_pos)
