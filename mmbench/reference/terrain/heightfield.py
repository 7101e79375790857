"""Stage 1: heightfield + surface biome weights (kernel K1).

Port of ``mega_minecraft_tpu/terrain/heightfield.py:46-331``.  ``generate_heightfield``
dispatches on the device of ``chunk_pos``: a CUDA tensor goes to the hand-written
kernel ``csrc/heightfield.cu``, a CPU tensor to the plain version below, which
evaluates all 24 biome heights for every column and sums the ones with weight > 0
(the kernel evaluates only those: the skipped terms are +0).
"""

from __future__ import annotations

import torch

from ..world import biomes as bio
from ..world.biomes import Biome

from ..ops.noise import fbm2, fbm2_from2, simplex2, simplex2_from2, smoothstep, worley2


def biome_noise(wx, wz):
    """[...] world x/z (f32) -> [..., 6] (ocean, beach, rocky, magic, temperature, moisture)."""
    ox, oz = fbm2_from2(wx * 0.0150, wz * 0.0150, octaves=3)
    px = (wx + ox * 20.0) * bio.OVERALL_BIOME_SCALE
    pz = (wz + oz * 20.0) * bio.OVERALL_BIOME_SCALE

    def single(scale, off_x, off_z, thr):
        s = simplex2(px * scale + off_x, pz * scale + off_z)
        return smoothstep(-thr, thr, s)

    ocean_noise = simplex2(px * 0.0007 + 2853.49, pz * 0.0007 + -9481.42)
    ocean = smoothstep(0.01, -0.02, ocean_noise)
    beach = smoothstep(-0.15, -0.05, ocean_noise)
    rocky = single(0.0015, -8102.35, -7620.23, 0.08)
    magic = single(0.0030, 5612.35, 9182.49, 0.07)
    temperature = single(0.0012, -4021.34, -8720.12, 0.06)
    moisture = single(0.0050, 1835.32, 3019.39, 0.12)
    return torch.stack([ocean, beach, rocky, magic, temperature, moisture], dim=-1)


def biome_weights_from_noise(noise6):
    """[..., 6] -> [..., 24]: per biome, the product of its used channels in channel
    order (1: n, 2: 1 - n), 1 when it uses none."""
    cols = []
    for b in range(bio.NUM_BIOMES):
        w = None
        for c, kind in enumerate(bio.BIOME_NOISE_WEIGHTS[b]):
            if kind == 0:
                continue
            term = noise6[..., c] if kind == 1 else 1.0 - noise6[..., c]
            w = term if w is None else w * term
        cols.append(torch.ones_like(noise6[..., 0]) if w is None else w)
    return torch.stack(cols, dim=-1)


# Per-biome height formulas (heightfield.py:99-258), in HEIGHT_FNS order.


def _h_coral_reef(x, z):
    return 107.0 + 16.0 * fbm2(x * 0.0065, z * 0.0065)


def _h_archipelago(x, z):
    island = (fbm2(x * 0.0055, z * 0.0055, octaves=4) + 1.0) * 0.5
    island = torch.pow(island, 2.4)
    island = smoothstep(1.0, 0.0, island)
    base = 107.0 + 24.0 * fbm2(x * 0.0060, z * 0.0060)
    return base + 22.0 * island


def _h_warm_ocean(x, z):
    return 93.0 + 18.0 * fbm2(x * 0.0055, z * 0.0055)


def _h_icebergs(x, z):
    return 66.0 + 18.0 * fbm2(x * 0.0060, z * 0.0060)


def _h_cool_ocean(x, z):
    return 80.0 + 22.0 * fbm2(x * 0.0065, z * 0.0065)


def _h_rocky_beach(x, z):
    return 134.0 + 8.0 * fbm2(x * 0.0070, z * 0.0070)


def _h_tropical_beach(x, z):
    return 129.5 + 6.0 * fbm2(x * 0.0045, z * 0.0045)


def _h_beach(x, z):
    return 132.0 + 5.0 * fbm2(x * 0.0055, z * 0.0055)


def _h_savanna(x, z):
    ox, oz = fbm2_from2(x * 0.0040, z * 0.0040, octaves=5)
    nx = x + ox * 100.0
    nz = z + oz * 100.0
    p1 = worley2(nx * 0.0070, nz * 0.0070)["f1"]
    p1 = smoothstep(0.30, 0.20, p1) * (1.0 + 0.3 * simplex2(nx * 0.0100, nz * 0.0100))
    p2 = worley2((nx + -3910.12) * 0.0045, (nz + -9012.34) * 0.0045)["f1"]
    p2 = smoothstep(0.16, 0.08, p2) * (1.0 + 0.2 * simplex2(nx * 0.0130, nz * 0.0130))
    plateau = p1 * 14.0 + p2 * 9.0
    return 136.0 + 9.0 * fbm2(x * 0.0080, z * 0.0080, octaves=4) + plateau


def _h_mesa(x, z):
    x = x * 0.7
    z = z * 0.7
    ox, oz = fbm2_from2(x * 0.0050, z * 0.0050, octaves=5)
    ox = ox * 300.0
    oz = oz * 300.0
    river = worley2((x + ox) * 0.0030, (z + oz) * 0.0030, want_edge=True)["edge"]
    base = 122.0 + 10.0 * smoothstep(0.00, 0.05, river)
    base = base + (
        37.5 + 5.0 * fbm2((x + 0.02 * ox) * 0.0300, (z + 0.02 * oz) * 0.0300, octaves=4)
    ) * smoothstep(0.07, 0.22, river)
    return base + 6.0 * simplex2(x * 0.0250, z * 0.0250)


def _h_frozen_wasteland(x, z):
    return 136.0 + 16.0 * fbm2(x * 0.0035, z * 0.0035)


def _h_redwood_forest(x, z):
    return 134.0 + 8.0 * fbm2(x * 0.0120, z * 0.0120)


def _h_shreks_swamp(x, z):
    return 130.0 + 12.0 * fbm2(x * 0.0080, z * 0.0080)


def _h_sparse_desert(x, z):
    ox, oz = simplex2_from2(x * 0.0080, z * 0.0080)
    f1 = worley2((x + ox * 20.0) * 0.0160, (z + oz * 20.0) * 0.0160)["f1"]
    dunes = torch.pow(f1, 2.0) * 18.0
    return 132.0 + 4.0 * fbm2(x * 0.0070, z * 0.0070, octaves=4) + dunes


def _h_lush_birch_forest(x, z):
    hills = (simplex2(x * 0.0012, z * 0.0012) + 0.8) * 20.0
    return 135.0 + 8.0 * fbm2(x * 0.0090, z * 0.0090) + hills


def _h_tianzi_mountains(x, z):
    ox, oz = simplex2_from2(x * 0.0800, z * 0.0800)
    nx = (x + ox * 3.0) * 0.0150
    nz = (z + oz * 3.0) * 0.0150
    w1 = smoothstep(0.45, 0.35, worley2(nx, nz)["f1"]) * 1.2
    w2 = smoothstep(
        0.45, 0.35, worley2(nx * 1.4 + 4292.12, nz * 1.4 + 9183.27)["f1"]
    ) * 0.6
    mountains = (w1 + w2) * (54.0 + 7.0 * fbm2(nx * 1.7, nz * 1.7, octaves=3))
    hills = 16.0 * simplex2(x * 0.0150, z * 0.0150)
    return 128.0 + hills + 9.0 * fbm2(x * 0.0070, z * 0.0070, octaves=3) + mountains


def _h_jungle(x, z):
    hills = (simplex2(x * 0.0030, z * 0.0030) + 0.5) * 25.0
    return 139.0 + 8.0 * fbm2(x * 0.0120, z * 0.0120) + hills


def _h_red_desert(x, z):
    return 137.0 + 13.0 * fbm2(x * 0.0075, z * 0.0075)


def _h_purple_mushrooms(x, z):
    return 136.0 + 9.0 * fbm2(x * 0.0140, z * 0.0140)


def _h_crystals(x, z):
    base_noise = simplex2(x * 0.0030, z * 0.0030)
    w = worley2(x * 0.0700, z * 0.0700, want_color=True, want_edge=True)
    towers = smoothstep(0.10, 0.15, w["edge"])
    towers = towers * (0.4 + 1.2 * w["color"][0])
    height = 60.0 * towers * smoothstep(0.70, 0.74, base_noise)
    height = height + 18.0 * smoothstep(0.35, 0.8, base_noise)
    return 137.0 + 8.0 * fbm2(x * 0.0200, z * 0.0200) + height


def _h_oasis(x, z):
    return 132.0 + 9.0 * fbm2(x * 0.0120, z * 0.0120)


def _h_desert(x, z):
    return 136.0 + 6.0 * fbm2(x * 0.0110, z * 0.0110)


def _h_plains(x, z):
    return 144.0 + 8.0 * fbm2(x * 0.0080, z * 0.0080)


def _h_mountains(x, z):
    n = torch.pow(torch.abs(fbm2(x * 0.0035, z * 0.0035)) + 0.05, 2.0)
    n = n + ((fbm2(x * 0.0050, z * 0.0050) - 0.5) * 2.0) * 0.05
    return 165.0 + 140.0 * (n - 0.15) + n * (20.0 * fbm2(x * 0.0350, z * 0.0350))


HEIGHT_FNS = {
    Biome.CORAL_REEF: _h_coral_reef,
    Biome.ARCHIPELAGO: _h_archipelago,
    Biome.WARM_OCEAN: _h_warm_ocean,
    Biome.ICEBERGS: _h_icebergs,
    Biome.COOL_OCEAN: _h_cool_ocean,
    Biome.ROCKY_BEACH: _h_rocky_beach,
    Biome.TROPICAL_BEACH: _h_tropical_beach,
    Biome.BEACH: _h_beach,
    Biome.SAVANNA: _h_savanna,
    Biome.MESA: _h_mesa,
    Biome.FROZEN_WASTELAND: _h_frozen_wasteland,
    Biome.REDWOOD_FOREST: _h_redwood_forest,
    Biome.SHREKS_SWAMP: _h_shreks_swamp,
    Biome.SPARSE_DESERT: _h_sparse_desert,
    Biome.LUSH_BIRCH_FOREST: _h_lush_birch_forest,
    Biome.TIANZI_MOUNTAINS: _h_tianzi_mountains,
    Biome.JUNGLE: _h_jungle,
    Biome.RED_DESERT: _h_red_desert,
    Biome.PURPLE_MUSHROOMS: _h_purple_mushrooms,
    Biome.CRYSTALS: _h_crystals,
    Biome.OASIS: _h_oasis,
    Biome.DESERT: _h_desert,
    Biome.PLAINS: _h_plains,
    Biome.MOUNTAINS: _h_mountains,
}


def column_world_coords(chunk_pos):
    """[B, 2] i32 chunk origins -> wx, wz [B, 16, 16] i32 (layout [B, z, x])."""
    lx = torch.arange(16, dtype=torch.int32, device=chunk_pos.device)
    wx = chunk_pos[:, 0, None, None] + lx[None, None, :]
    wz = chunk_pos[:, 1, None, None] + lx[None, :, None]
    return wx.expand(-1, 16, 16), wz.expand(-1, 16, 16)


def generate_heightfield_plain(chunk_pos):
    """Plain version: [B, 2] i32 -> (heightfield [B, 16, 16], weights [B, 24, 16, 16])."""
    wx, wz = column_world_coords(chunk_pos)
    wx = wx.to(torch.float32)
    wz = wz.to(torch.float32)
    weights = biome_weights_from_noise(biome_noise(wx, wz))  # [B, 16, 16, 24]
    height = torch.zeros_like(wx)
    for biome, fn in HEIGHT_FNS.items():
        w = weights[..., int(biome)]
        height = height + torch.where(w > 0.0, w * fn(wx, wz), 0.0)
    return height, weights.permute(0, 3, 1, 2).contiguous()


def generate_heightfield(chunk_pos):
    """Stage 1 for [B, 2] i32 chunk origins: K1 on CUDA, the plain version on the CPU.
    (The JAX function's debug ``biome_override`` is not ported: no caller uses it.)"""
    return generate_heightfield_plain(chunk_pos)
