"""Stage 5: chunk fill, a u8 block id for every block of [B, 16, 16, 384] (kernel K4).

Port of ``mega_minecraft_tpu/terrain/fill.py:48-410``.  ``fill_chunks`` dispatches on
the device: CUDA tensors go to ``csrc/fill.cu`` (a CTA a tile of ``FILL_TILE_COLS`` columns:
every block's cascade, then the cave-biome and lush clay work packed into full warps, the clay
test's Worley cells hashed once a tile into a table of ``LUSH_TABLE_CELLS``); CPU tensors go to
the plain version below, which is the JAX program's priority cascade of masked selects,
evaluated on the whole volume.
"""

from __future__ import annotations

import torch

from ..world import biomes as bio
from ..world.blocks import Block

from ..ops import hashes
from ..ops.hashes import div
from ..ops.noise import fbm2, fbm3_from3, simplex2, simplex3, worley3
from ..tables import CAVE_BIOME_Y_MAX, LUSH_TABLE_CELLS, SEED_FILL_CAVE_BIOME, Y_SIZE
from .caves import get_cave_biome
from .heightfield import column_world_coords

SEA_LEVEL = bio.SEA_LEVEL
LAVA_LEVEL = bio.LAVA_LEVEL

_B = Block
U8 = torch.uint8


def random_biome(biome_weights_last, rand):
    """getRandomBiome (fill.py:48-57): the first biome whose running weight sum reaches
    ``rand``, PLAINS when none does.  biome_weights_last [..., 24] f32 (broadcastable
    against rand[..., None]); rand [...] f32 -> i32 biome ids shaped like rand.  The
    running sum is added biome by biome, as the kernels add it."""
    running = torch.zeros_like(rand)
    biome = torch.full(rand.shape, int(bio.Biome.PLAINS), dtype=torch.int32, device=rand.device)
    picked = torch.zeros_like(rand, dtype=torch.bool)
    for b in range(bio.NUM_BIOMES):
        running = running + biome_weights_last[..., b]
        cond = (rand - running) <= 0.0
        biome = torch.where(cond & ~picked, b, biome)
        picked = picked | cond
    return biome


def _cave_depths(starts, ends, y):
    """Per-block cave-layer scan (fill.py:60-91).

    starts / ends: [..., 1, 32] i32; y: [..., Y, 1] i32 -> (in_cave, bottom, top) [..., Y]."""
    valid = starts != Y_SIZE
    contain = valid & (starts < y) & (y <= ends)
    in_cave = contain.any(-1)
    c_start = torch.where(contain, starts, -1).amax(-1)
    c_end = torch.where(contain, ends, -1).amax(-1)
    above = valid & (starts >= y)
    has_above = above.any(-1)
    above_min = torch.where(above, starts, 9999).amin(-1)
    below = valid & (ends < y)
    has_below = below.any(-1)
    below_max = torch.where(below, ends, -9999).amax(-1)
    yq = y[..., 0]
    bottom = torch.where(
        in_cave, c_start - yq, torch.where(has_above, above_min - yq, -Y_SIZE)
    )
    top = torch.where(
        in_cave, yq - (c_end + 1), torch.where(has_below, yq - (below_max + 1), -Y_SIZE)
    )
    return in_cave, bottom, top


def _u8(value, like):
    return torch.tensor(int(value), dtype=U8, device=like.device)


def _sel(mask, value, block):
    """where(mask, value, block) in u8 (value: block id or u8 tensor)."""
    if not isinstance(value, torch.Tensor):
        value = _u8(value, block)
    return torch.where(mask, value, block)


def _biome_postprocess(block, rand_biome, wx, wyf, wz, is_top):
    """Biome post-process (fill.py:111-221); wx / wz [..., 1] f32, the rest [..., Y]."""
    def biome_is(b):
        return rand_biome == int(b)

    wy_ge_sea = wyf >= float(SEA_LEVEL)

    sea = torch.full_like(wx, float(SEA_LEVEL))
    dirt_h = (sea + 1.5) + 1.7 * fbm2(wx * 0.0065, wz * 0.0065, octaves=3)
    arch = biome_is(bio.Biome.ARCHIPELAGO) & wy_ge_sea & (block != _B.WATER) & (wyf > dirt_h)
    top_or_dirt = torch.where(is_top, _u8(_B.GRASS_BLOCK, block), _u8(_B.DIRT, block))
    block = _sel(arch, top_or_dirt, block)

    trop = (
        biome_is(bio.Biome.TROPICAL_BEACH) & is_top
        & (block != _B.SMOOTH_SAND) & (block != _B.WATER)
    )
    block = _sel(trop, _B.SMOOTH_SAND, block)
    beach = biome_is(bio.Biome.BEACH) & is_top & (block != _B.SAND) & (block != _B.WATER)
    block = _sel(beach, _B.SAND, block)

    tsh = 108.0 + 12.0 * fbm2(wx * 0.0040, wz * 0.0040, octaves=3)
    sample_h = wyf + 3.0 * simplex3(
        (wx * 0.0100).expand_as(wyf), (wz * 0.0100).expand_as(wyf), wyf * 0.0300
    ) - tsh
    sample_h = sample_h - torch.floor(div(sample_h, 32.0)) * 32.0
    terr = torch.full_like(block, int(_B.TERRACOTTA))
    for lim, blk in reversed(
        [(5.0, _B.TERRACOTTA), (8.0, _B.ORANGE_TERRACOTTA), (12.0, _B.RED_TERRACOTTA),
         (14.0, _B.WHITE_TERRACOTTA), (20.0, _B.TERRACOTTA), (21.0, _B.ORANGE_TERRACOTTA),
         (26.0, _B.YELLOW_TERRACOTTA), (29.0, _B.PURPLE_TERRACOTTA)]
    ):
        terr = _sel(sample_h < lim, blk, terr)
    mesa = (
        biome_is(bio.Biome.MESA) & (wyf >= 90.0) & (block != _B.WATER) & (wyf >= tsh)
        & ~((block == _B.CLAY) & (wyf < tsh + 20.0))
    )
    block = _sel(mesa, terr, block)

    frozen = biome_is(bio.Biome.FROZEN_WASTELAND) & (block == _B.WATER)
    block = _sel(frozen, _B.PACKED_ICE, block)

    mud_end = (sea + 0.8) + 1.1 * simplex2(wx * 0.0300, wz * 0.0300)
    swamp = (
        biome_is(bio.Biome.SHREKS_SWAMP) & (wyf >= 100.0)
        & ((block == _B.DIRT) | (block == _B.JUNGLE_GRASS_BLOCK)) & (wyf < mud_end)
    )
    block = _sel(swamp, _B.MUD, block)

    ssh = 112.0 + 16.0 * fbm2(wx * 0.0200, wz * 0.0200, octaves=3)
    tianzi = (
        biome_is(bio.Biome.TIANZI_MOUNTAINS) & (wyf >= 90.0) & (block != _B.WATER)
        & (block != _B.DIRT) & (block != _B.GRASS_BLOCK) & (wyf >= ssh)
    )
    block = _sel(tianzi, _B.SMOOTH_SANDSTONE, block)

    myc_rand = hashes.rand1_from2(wx + 913213.0, wz + 85941.0)
    crys = biome_is(bio.Biome.CRYSTALS) & is_top & (block != _B.QUARTZ) & (myc_rand < 0.1)
    block = _sel(crys, _B.MYCELIUM, block)

    snow_h = 202.0 + 5.0 * fbm2(wx * 0.0500, wz * 0.0500, octaves=3)
    mount = biome_is(bio.Biome.MOUNTAINS) & (wyf >= 190.0) & (wyf >= snow_h)
    return _sel(mount, _B.SNOW, block)


def lush_clay_point(wxf, wyf, wzf):
    """The point of a lush cave's clay test (fill.py:263-265): a near block of a lush cave is
    clay where the Worley F1 there is below 0.25, else moss.  f32 world coordinates -> (px,
    py, pz) in Worley cells."""
    nx = wxf * 0.025
    ny = wyf * 0.025
    nz = wzf * 0.025
    ny2 = ny + 192031.9821
    ox, oy, oz = fbm3_from3(nx * 0.4, ny2 * 0.4, nz * 0.4, octaves=3)
    return nx + ox * 2.0, ny2 + oy * 2.0, nz + oz * 2.0


def _cave_biome_postprocess(block, cave_biome, wx, wyf, wz, bottom_depth, top_depth):
    """caveBiomeBlockPostProcess (fill.py:224-280); wx / wz [..., 1] f32."""
    wxy = wx.expand_as(wyf)
    wzy = wz.expand_as(wyf)

    def cb_is(b):
        return cave_biome == int(b)

    is_top = bottom_depth == 0
    stone_like = (block == _B.STONE) | (block == _B.DEEPSLATE) | (block == _B.BLACKSTONE)

    qn = simplex3((wxy + wyf) * 0.05, (wzy + 5819323.0) * 0.05, ((wxy + wzy) * 2.0) * 0.05)
    cc = cb_is(bio.CaveBiome.CRYSTAL_CAVES) & stone_like
    quartz = cc & (qn < -0.25)
    cobble_rand = hashes.rand1_from3(wxy, wyf, wzy)
    cobble_stone = cc & ~quartz & (block == _B.STONE) & (cobble_rand < 0.5)
    cobble_deep = cc & ~quartz & (block == _B.DEEPSLATE) & (cobble_rand < 0.4)
    block = _sel(quartz, _B.QUARTZ, block)
    block = _sel(cobble_stone, _B.COBBLESTONE, block)
    block = _sel(cobble_deep, _B.COBBLED_DEEPSLATE, block)

    thr = 1.5 + 4.5 * simplex3(wxy * 0.025, wyf * 0.025, wzy * 0.025)
    bd = bottom_depth.to(torch.float32)
    td = top_depth.to(torch.float32)
    near = ((bd >= 0.0) & (bd <= thr)) | ((td >= 0.0) & (td <= thr))
    clay_n = worley3(*lush_clay_point(wxy, wyf, wzy))["f1"]
    lush = cb_is(bio.CaveBiome.LUSH_CAVES) & stone_like & near
    clay_or_moss = torch.where(clay_n < 0.25, _u8(_B.CLAY, block), _u8(_B.MOSS, block))
    block = _sel(lush, clay_or_moss, block)

    for cb, deep, blackst in (
        (bio.CaveBiome.WARPED_FOREST, _B.WARPED_DEEPSLATE, _B.WARPED_BLACKSTONE),
        (bio.CaveBiome.AMBER_FOREST, _B.AMBER_DEEPSLATE, _B.AMBER_BLACKSTONE),
    ):
        m = cb_is(cb) & is_top
        block = _sel(m & (block == _B.DEEPSLATE), deep, block)
        block = _sel(m & (block == _B.BLACKSTONE), blackst, block)
    return block


def fill_chunks_plain(heightfield, biome_weights, layers, cave_starts, cave_ends, chunk_pos):
    """Plain stage 5 -> blocks [B, 16, 16, 384] u8 ([z, x, y])."""
    B = heightfield.shape[0]
    dev = heightfield.device
    wx, wz = (c[..., None] for c in column_world_coords(chunk_pos))
    wy = torch.arange(Y_SIZE, dtype=torch.int32, device=dev).expand(B, 16, 16, Y_SIZE)
    wyf = wy.to(torch.float32)
    hf = heightfield[..., None]
    wxf = wx.to(torch.float32)
    wzf = wz.to(torch.float32)

    # per-block seeded draw picks the random biome
    u, _ = hashes.lcg_u01(hashes.seed_3(wx.expand_as(wy), wy, wz.expand_as(wy)))
    rand_biome = random_biome(biome_weights.permute(0, 2, 3, 1)[:, :, :, None, :], u)
    grass_tab = torch.as_tensor(bio.GRASS_BLOCKS, device=dev).to(U8)
    grass = grass_tab[rand_biome.long()]

    is_ocean = (biome_weights[:, : bio.NUM_OCEAN_BIOMES] > 0.0).any(1)[..., None]
    in_cave, bottom_d, top_d = _cave_depths(
        cave_starts[..., None, :], cave_ends[..., None, :], wy[..., None]
    )
    above_ground = wyf > hf
    is_top = wyf >= hf - 1.0

    # first material layer containing y wins; forward materials only below the
    # backward-stratified base
    n_fwd = bio.NUM_FORWARD_MATERIALS
    mat_block = bio.MATERIAL_BLOCK
    fwd_ok = wyf < layers[:, n_fwd, :, :, None]
    body = torch.full(wy.shape, int(mat_block[0]), dtype=U8, device=dev)
    found = torch.zeros_like(wy, dtype=torch.bool)
    for m in range(bio.NUM_MATERIALS):
        start = layers[:, m, :, :, None]
        end = layers[:, m + 1, :, :, None] if m + 1 < bio.NUM_MATERIALS else hf
        cond = (start <= wyf) & (wyf < end)
        if m < n_fwd:
            cond = cond & fwd_ok
        take = cond & ~found
        body = _sel(take, int(mat_block[m]), body)
        found = found | take
    body = torch.where((body == _B.DIRT) & is_top, grass, body)

    quartz_start = 140.0 + 15.0 * fbm2(wxf * 0.0080, wzf * 0.0080, octaves=3)
    pre_hit = (rand_biome == int(bio.Biome.CRYSTALS)) & (hf > 176.0) & (wyf > quartz_start)
    body = _sel(pre_hit, _B.QUARTZ, body)

    # priority cascade (reverse of the reference's early returns)
    cave_air = torch.where(wy <= LAVA_LEVEL, _u8(_B.LAVA, wy), _u8(_B.AIR, wy))
    is_water_zone = above_ground & (wy <= SEA_LEVEL)
    cave_mask = in_cave & ~(is_water_zone & is_ocean) & ~(above_ground & (wy > SEA_LEVEL))
    water_mask = is_water_zone & ~(in_cave & ~is_ocean)
    bedrock_mask = wy == 0
    air_mask = above_ground & (wy > SEA_LEVEL)
    solid_mask = ~above_ground & ~cave_mask & ~bedrock_mask

    block = _sel(cave_mask, cave_air, body)
    block = _sel(water_mask, _B.WATER, block)
    block = _sel(air_mask, _B.AIR, block)
    block = _sel(bedrock_mask, _B.BEDROCK, block)

    post_mask = (solid_mask | water_mask) & ~cave_mask
    post = _biome_postprocess(block, rand_biome, wxf, wyf, wzf, is_top)
    block = torch.where(post_mask, post, block)

    yb = CAVE_BIOME_Y_MAX
    cave_biome = get_cave_biome(
        wx.expand(B, 16, 16, yb), wy[..., :yb], wz.expand(B, 16, 16, yb), hf,
        SEED_FILL_CAVE_BIOME,
    )
    cave_post = _cave_biome_postprocess(
        block[..., :yb], cave_biome, wxf, wyf[..., :yb], wzf, bottom_d[..., :yb], top_d[..., :yb]
    )
    band = torch.where((solid_mask & ~pre_hit)[..., :yb], cave_post, block[..., :yb])
    return torch.cat([band, block[..., yb:]], dim=-1).contiguous()


def fill_chunks(heightfield, biome_weights, layers, cave_starts, cave_ends, chunk_pos):
    """Stage 5: K4 on CUDA, the plain version on the CPU."""
    return fill_chunks_plain(heightfield, biome_weights, layers, cave_starts, cave_ends, chunk_pos)
