"""Block database: IDs, atlas UVs, transparency, render material classes.

Port copy (numpy only) of mega_minecraft_tpu/world: the equivalent of the reference block/material DB (reference behavior:
the reference source, src/terrain/block.{hpp,cpp} — 135 block IDs, per-block 16x16-atlas UVs
with optional random rotation/flip, 4 transparency classes; render material classes
assigned at meshing time, the reference source, src/terrain/chunk.cu:1797-1828).

Everything here is exported as numpy arrays (device-upload-ready constant tables) so the
fill / meshing / tracer kernels can index them with plain gathers.
"""

from __future__ import annotations

import enum

import numpy as np


class Block(enum.IntEnum):
    AIR = 0
    WATER = enum.auto()
    LAVA = enum.auto()
    CAVE_VINES_MAIN = enum.auto()
    CAVE_VINES_GLOW_MAIN = enum.auto()
    CAVE_VINES_END = enum.auto()
    CAVE_VINES_GLOW_END = enum.auto()
    GRASS = enum.auto()
    JUNGLE_GRASS = enum.auto()
    SAVANNA_GRASS = enum.auto()
    WARPED_MUSHROOM = enum.auto()
    WARPED_ROOTS = enum.auto()
    NETHER_SPROUTS = enum.auto()
    INFECTED_MUSHROOM = enum.auto()
    AMBER_ROOTS = enum.auto()
    DANDELION = enum.auto()
    POPPY = enum.auto()
    PITCHER_BOTTOM = enum.auto()
    PITCHER_TOP = enum.auto()
    CORNFLOWER = enum.auto()
    BLUE_ORCHID = enum.auto()
    ALLIUM = enum.auto()
    RED_TULIP = enum.auto()
    ORANGE_TULIP = enum.auto()
    WHITE_TULIP = enum.auto()
    PINK_TULIP = enum.auto()
    LILAC_BOTTOM = enum.auto()
    LILAC_TOP = enum.auto()
    PEONY_BOTTOM = enum.auto()
    PEONY_TOP = enum.auto()
    OXEYE_DAISY = enum.auto()
    LILY_OF_THE_VALLEY = enum.auto()
    JUNGLE_FERN = enum.auto()
    SMALL_MAGENTA_CRYSTAL = enum.auto()
    SMALL_CYAN_CRYSTAL = enum.auto()
    SMALL_GREEN_CRYSTAL = enum.auto()
    SMALL_PURPLE_MUSHROOM = enum.auto()
    DEAD_BUSH = enum.auto()
    HANGING_SMALL_MAGENTA_CRYSTAL = enum.auto()
    HANGING_SMALL_CYAN_CRYSTAL = enum.auto()
    HANGING_SMALL_GREEN_CRYSTAL = enum.auto()
    TALL_GRASS_BOTTOM = enum.auto()
    TALL_GRASS_TOP = enum.auto()
    TALL_JUNGLE_GRASS_BOTTOM = enum.auto()
    TALL_JUNGLE_GRASS_TOP = enum.auto()
    TORCHFLOWER = enum.auto()
    BRAIN_CORAL = enum.auto()
    BUBBLE_CORAL = enum.auto()
    FIRE_CORAL = enum.auto()
    HORN_CORAL = enum.auto()
    TUBE_CORAL = enum.auto()
    SEAGRASS = enum.auto()
    TALL_SEAGRASS_BOTTOM = enum.auto()
    TALL_SEAGRASS_TOP = enum.auto()
    KELP_MAIN = enum.auto()
    KELP_END = enum.auto()
    BEDROCK = enum.auto()
    STONE = enum.auto()
    DIRT = enum.auto()
    GRASS_BLOCK = enum.auto()
    SAND = enum.auto()
    GRAVEL = enum.auto()
    MYCELIUM = enum.auto()
    SNOW = enum.auto()
    SNOWY_GRASS_BLOCK = enum.auto()
    MUSHROOM_STEM = enum.auto()
    MUSHROOM_UNDERSIDE = enum.auto()
    PURPLE_MUSHROOM_CAP = enum.auto()
    MARBLE = enum.auto()
    ANDESITE = enum.auto()
    CALCITE = enum.auto()
    BLACKSTONE = enum.auto()
    TUFF = enum.auto()
    DEEPSLATE = enum.auto()
    GRANITE = enum.auto()
    SLATE = enum.auto()
    SANDSTONE = enum.auto()
    CLAY = enum.auto()
    RED_SAND = enum.auto()
    RED_SANDSTONE = enum.auto()
    MUD = enum.auto()
    JUNGLE_GRASS_BLOCK = enum.auto()
    RAFFLESIA_PETAL = enum.auto()
    RAFFLESIA_CENTER = enum.auto()
    RAFFLESIA_SPIKES = enum.auto()
    RAFFLESIA_STEM = enum.auto()
    JUNGLE_WOOD = enum.auto()
    JUNGLE_LEAVES_PLAIN = enum.auto()
    JUNGLE_LEAVES_FRUITS = enum.auto()
    CACTUS = enum.auto()
    PALM_WOOD = enum.auto()
    PALM_LEAVES = enum.auto()
    MAGENTA_CRYSTAL = enum.auto()
    CYAN_CRYSTAL = enum.auto()
    GREEN_CRYSTAL = enum.auto()
    SMOOTH_SAND = enum.auto()
    TERRACOTTA = enum.auto()
    YELLOW_TERRACOTTA = enum.auto()
    ORANGE_TERRACOTTA = enum.auto()
    PURPLE_TERRACOTTA = enum.auto()
    RED_TERRACOTTA = enum.auto()
    WHITE_TERRACOTTA = enum.auto()
    QUARTZ = enum.auto()
    ICE = enum.auto()
    PACKED_ICE = enum.auto()
    BLUE_ICE = enum.auto()
    SAVANNA_GRASS_BLOCK = enum.auto()
    BIRCH_WOOD = enum.auto()
    BIRCH_LEAVES = enum.auto()
    YELLOW_BIRCH_LEAVES = enum.auto()
    ORANGE_BIRCH_LEAVES = enum.auto()
    ACACIA_WOOD = enum.auto()
    ACACIA_LEAVES = enum.auto()
    SMOOTH_SANDSTONE = enum.auto()
    PINE_WOOD = enum.auto()
    PINE_LEAVES_1 = enum.auto()
    PINE_LEAVES_2 = enum.auto()
    REDWOOD_WOOD = enum.auto()
    REDWOOD_LEAVES = enum.auto()
    CYPRESS_WOOD = enum.auto()
    CYPRESS_LEAVES = enum.auto()
    GLOWSTONE = enum.auto()
    SHROOMLIGHT = enum.auto()
    WARPED_DEEPSLATE = enum.auto()
    WARPED_BLACKSTONE = enum.auto()
    MOSS = enum.auto()
    AMBER_DEEPSLATE = enum.auto()
    AMBER_BLACKSTONE = enum.auto()
    WARPED_STEM = enum.auto()
    WARPED_WART = enum.auto()
    AMBER_STEM = enum.auto()
    AMBER_WART = enum.auto()
    COBBLESTONE = enum.auto()
    COBBLED_DEEPSLATE = enum.auto()
    BRAIN_CORAL_BLOCK = enum.auto()
    BUBBLE_CORAL_BLOCK = enum.auto()
    FIRE_CORAL_BLOCK = enum.auto()
    HORN_CORAL_BLOCK = enum.auto()
    TUBE_CORAL_BLOCK = enum.auto()
    SEA_LANTERN = enum.auto()


NUM_BLOCKS = int(Block.SEA_LANTERN) + 1
NUM_NON_SOLID_BLOCKS = int(Block.KELP_END) + 1  # block.hpp:154


class Transparency(enum.IntEnum):
    OPAQUE = 0
    SEMI_TRANSPARENT = 1  # e.g. leaves (alpha cutout)
    TRANSPARENT = 2  # e.g. water, crystal
    X_SHAPED = 3  # crossed quads (flora)


class Mat(enum.IntEnum):
    """Render material class (reference Mats, structs.hpp / chunk.cu:1797-1828)."""

    DIFFUSE = 0
    WATER = 1
    CRYSTAL = 2
    SMOOTH_MICRO = 3
    MICRO = 4
    ROUGH_MICRO = 5


# ---------------------------------------------------------------------------
# Block data table.  Each entry: uv tiles (side, top, bottom) into the 16x16 atlas,
# per-face random-rotation / random-flip bits, transparency class.
# Encoded compactly; expanded to numpy arrays below.
# ---------------------------------------------------------------------------

B = Block
T = Transparency

# (block, side_uv, top_uv, bottom_uv, rot(side,top,bottom), flip(side,top,bottom), trans)
_X = T.X_SHAPED
_S = T.SEMI_TRANSPARENT
_T = T.TRANSPARENT
_NONE3 = (False, False, False)
_ALL3 = (True, True, True)
_TB = (False, True, True)  # top+bottom only


def _e(block, side, top=None, bottom=None, rot=_NONE3, flip=_NONE3, trans=T.OPAQUE):
    top = side if top is None else top
    bottom = top if bottom is None else bottom
    return (block, side, top, bottom, rot, flip, trans)


_TABLE = [
    _e(B.AIR, (0, 0), trans=_T),
    _e(B.WATER, (15, 15), trans=_T),
    _e(B.LAVA, (14, 15)),
    _e(B.CAVE_VINES_MAIN, (2, 7), trans=_X),
    _e(B.CAVE_VINES_GLOW_MAIN, (3, 7), trans=_X),
    _e(B.CAVE_VINES_END, (4, 7), trans=_X),
    _e(B.CAVE_VINES_GLOW_END, (5, 7), trans=_X),
    _e(B.GRASS, (8, 7), trans=_X),
    _e(B.JUNGLE_GRASS, (9, 7), trans=_X),
    _e(B.SAVANNA_GRASS, (10, 7), trans=_X),
    _e(B.WARPED_MUSHROOM, (9, 5), trans=_X),
    _e(B.WARPED_ROOTS, (13, 5), trans=_X),
    _e(B.NETHER_SPROUTS, (1, 6), trans=_X),
    _e(B.INFECTED_MUSHROOM, (10, 5), trans=_X),
    _e(B.AMBER_ROOTS, (4, 6), trans=_X),
    _e(B.DANDELION, (11, 7), trans=_X),
    _e(B.POPPY, (12, 7), trans=_X),
    _e(B.PITCHER_BOTTOM, (13, 7), trans=_X),
    _e(B.PITCHER_TOP, (13, 8), trans=_X),
    _e(B.CORNFLOWER, (14, 7), trans=_X),
    _e(B.BLUE_ORCHID, (15, 7), trans=_X),
    _e(B.ALLIUM, (0, 8), trans=_X),
    _e(B.RED_TULIP, (1, 8), trans=_X),
    _e(B.ORANGE_TULIP, (2, 8), trans=_X),
    _e(B.WHITE_TULIP, (3, 8), trans=_X),
    _e(B.PINK_TULIP, (4, 8), trans=_X),
    _e(B.LILAC_BOTTOM, (5, 8), trans=_X),
    _e(B.LILAC_TOP, (5, 9), trans=_X),
    _e(B.PEONY_BOTTOM, (6, 8), trans=_X),
    _e(B.PEONY_TOP, (6, 9), trans=_X),
    _e(B.OXEYE_DAISY, (7, 8), trans=_X),
    _e(B.LILY_OF_THE_VALLEY, (8, 8), trans=_X),
    _e(B.JUNGLE_FERN, (9, 8), trans=_X),
    _e(B.SMALL_MAGENTA_CRYSTAL, (10, 8), trans=_X),
    _e(B.SMALL_CYAN_CRYSTAL, (11, 8), trans=_X),
    _e(B.SMALL_GREEN_CRYSTAL, (12, 8), trans=_X),
    _e(B.SMALL_PURPLE_MUSHROOM, (14, 8), trans=_X),
    _e(B.DEAD_BUSH, (15, 8), trans=_X),
    _e(B.HANGING_SMALL_MAGENTA_CRYSTAL, (0, 9), trans=_X),
    _e(B.HANGING_SMALL_CYAN_CRYSTAL, (1, 9), trans=_X),
    _e(B.HANGING_SMALL_GREEN_CRYSTAL, (2, 9), trans=_X),
    _e(B.TALL_GRASS_BOTTOM, (3, 9), trans=_X),
    _e(B.TALL_GRASS_TOP, (3, 10), trans=_X),
    _e(B.TALL_JUNGLE_GRASS_BOTTOM, (4, 9), trans=_X),
    _e(B.TALL_JUNGLE_GRASS_TOP, (4, 10), trans=_X),
    _e(B.TORCHFLOWER, (7, 9), trans=_X),
    _e(B.BRAIN_CORAL, (8, 9), trans=_X),
    _e(B.BUBBLE_CORAL, (9, 9), trans=_X),
    _e(B.FIRE_CORAL, (10, 9), trans=_X),
    _e(B.HORN_CORAL, (11, 9), trans=_X),
    _e(B.TUBE_CORAL, (12, 9), trans=_X),
    _e(B.SEAGRASS, (13, 9), trans=_X),
    _e(B.TALL_SEAGRASS_BOTTOM, (14, 9), trans=_X),
    _e(B.TALL_SEAGRASS_TOP, (14, 10), trans=_X),
    _e(B.KELP_MAIN, (15, 9), trans=_X),
    _e(B.KELP_END, (15, 10), trans=_X),
    _e(B.BEDROCK, (0, 5)),
    _e(B.STONE, (3, 0), flip=_ALL3),
    _e(B.DIRT, (0, 0), rot=_ALL3),
    _e(B.GRASS_BLOCK, (1, 0), (2, 0), (0, 0), rot=_TB),
    _e(B.SAND, (4, 0), rot=_ALL3),
    _e(B.GRAVEL, (5, 0), rot=_ALL3),
    _e(B.MYCELIUM, (6, 0), (7, 0), (0, 0), rot=_TB),
    _e(B.SNOW, (8, 0)),
    _e(B.SNOWY_GRASS_BLOCK, (9, 0), (8, 0), (0, 0), rot=_TB),
    _e(B.MUSHROOM_STEM, (10, 0)),
    _e(B.MUSHROOM_UNDERSIDE, (11, 0), flip=_ALL3),
    _e(B.PURPLE_MUSHROOM_CAP, (12, 0)),
    _e(B.MARBLE, (13, 0), rot=_ALL3),
    _e(B.ANDESITE, (14, 0)),
    _e(B.CALCITE, (15, 0)),
    _e(B.BLACKSTONE, (0, 1), (1, 1)),
    _e(B.TUFF, (2, 1)),
    _e(B.DEEPSLATE, (3, 1), (4, 1), flip=_TB),
    _e(B.GRANITE, (5, 1), rot=_ALL3),
    _e(B.SLATE, (6, 1)),
    _e(B.SANDSTONE, (7, 1), (8, 1), (9, 1)),
    _e(B.CLAY, (10, 1)),
    _e(B.RED_SAND, (11, 1), rot=_ALL3),
    _e(B.RED_SANDSTONE, (12, 1), (13, 1), (14, 1)),
    _e(B.MUD, (15, 1)),
    _e(B.JUNGLE_GRASS_BLOCK, (0, 2), (1, 2), (0, 0), rot=_TB),
    _e(B.RAFFLESIA_PETAL, (2, 2)),
    _e(B.RAFFLESIA_CENTER, (3, 2)),
    _e(B.RAFFLESIA_SPIKES, (4, 2)),
    _e(B.RAFFLESIA_STEM, (5, 2)),
    _e(B.JUNGLE_WOOD, (8, 2)),
    _e(B.JUNGLE_LEAVES_PLAIN, (6, 2), trans=_S),
    _e(B.JUNGLE_LEAVES_FRUITS, (7, 2), trans=_S),
    _e(B.CACTUS, (10, 2)),
    _e(B.PALM_WOOD, (11, 2)),
    _e(B.PALM_LEAVES, (13, 2), trans=_S),
    _e(B.MAGENTA_CRYSTAL, (0, 3), trans=_T),
    _e(B.CYAN_CRYSTAL, (1, 3), trans=_T),
    _e(B.GREEN_CRYSTAL, (2, 3), trans=_T),
    _e(B.SMOOTH_SAND, (3, 3)),
    _e(B.TERRACOTTA, (4, 3)),
    _e(B.YELLOW_TERRACOTTA, (5, 3)),
    _e(B.ORANGE_TERRACOTTA, (6, 3)),
    _e(B.PURPLE_TERRACOTTA, (7, 3)),
    _e(B.RED_TERRACOTTA, (8, 3)),
    _e(B.WHITE_TERRACOTTA, (9, 3)),
    _e(B.QUARTZ, (10, 3)),
    _e(B.ICE, (11, 3), trans=_T),
    _e(B.PACKED_ICE, (12, 3)),
    _e(B.BLUE_ICE, (13, 3)),
    _e(B.SAVANNA_GRASS_BLOCK, (14, 2), (15, 2), (0, 0), rot=_TB),
    _e(B.BIRCH_WOOD, (14, 3)),
    _e(B.BIRCH_LEAVES, (0, 4), trans=_S),
    _e(B.YELLOW_BIRCH_LEAVES, (1, 4), trans=_S),
    _e(B.ORANGE_BIRCH_LEAVES, (2, 4), trans=_S),
    _e(B.ACACIA_WOOD, (3, 4)),
    _e(B.ACACIA_LEAVES, (5, 4), trans=_S),
    _e(B.SMOOTH_SANDSTONE, (8, 1)),
    _e(B.PINE_WOOD, (6, 4)),
    _e(B.PINE_LEAVES_1, (8, 4), trans=_S),
    _e(B.PINE_LEAVES_2, (9, 4), trans=_S),
    _e(B.REDWOOD_WOOD, (10, 4)),
    _e(B.REDWOOD_LEAVES, (12, 4), trans=_S),
    _e(B.CYPRESS_WOOD, (13, 4)),
    _e(B.CYPRESS_LEAVES, (15, 4), trans=_S),
    _e(B.GLOWSTONE, (1, 5)),
    _e(B.SHROOMLIGHT, (2, 5)),
    _e(B.WARPED_DEEPSLATE, (4, 5), (3, 5), (4, 1), rot=(False, True, False), flip=(False, False, True)),
    _e(B.WARPED_BLACKSTONE, (5, 5), (3, 5), (1, 1), rot=(False, True, False)),
    _e(B.MOSS, (13, 6)),
    _e(B.AMBER_DEEPSLATE, (7, 5), (6, 5), (4, 1), rot=(False, True, False), flip=(False, False, True)),
    _e(B.AMBER_BLACKSTONE, (8, 5), (6, 5), (1, 1), rot=(False, True, False)),
    _e(B.WARPED_STEM, (11, 5), (12, 5)),
    _e(B.WARPED_WART, (0, 6)),
    _e(B.AMBER_STEM, (2, 6), (3, 6)),
    _e(B.AMBER_WART, (7, 6)),
    _e(B.COBBLESTONE, (6, 7)),
    _e(B.COBBLED_DEEPSLATE, (7, 7)),
    _e(B.BRAIN_CORAL_BLOCK, (8, 10)),
    _e(B.BUBBLE_CORAL_BLOCK, (9, 10)),
    _e(B.FIRE_CORAL_BLOCK, (10, 10)),
    _e(B.HORN_CORAL_BLOCK, (11, 10)),
    _e(B.TUBE_CORAL_BLOCK, (12, 10)),
    _e(B.SEA_LANTERN, (0, 10)),
]

assert len(_TABLE) == NUM_BLOCKS, (len(_TABLE), NUM_BLOCKS)
assert all(int(row[0]) == i for i, row in enumerate(_TABLE))

# Expanded numpy constant tables --------------------------------------------------

#: [NUM_BLOCKS, 3(face: side,top,bottom), 2(u,v)] int32 atlas tile coords
UV_TILES = np.array([[r[1], r[2], r[3]] for r in _TABLE], dtype=np.int32)
#: [NUM_BLOCKS, 3] bool — per-face random rotation / flip bits
RAND_ROT = np.array([r[4] for r in _TABLE], dtype=bool)
RAND_FLIP = np.array([r[5] for r in _TABLE], dtype=bool)
#: [NUM_BLOCKS] uint8 transparency class
TRANSPARENCY = np.array([int(r[6]) for r in _TABLE], dtype=np.uint8)

# Render material class per block (chunk.cu:1797-1828)
MATERIAL = np.full(NUM_BLOCKS, int(Mat.DIFFUSE), dtype=np.uint8)
MATERIAL[int(B.WATER)] = int(Mat.WATER)
for _b in (B.CYAN_CRYSTAL, B.GREEN_CRYSTAL, B.MAGENTA_CRYSTAL):
    MATERIAL[int(_b)] = int(Mat.CRYSTAL)
for _b in (B.MARBLE, B.QUARTZ, B.ICE, B.PACKED_ICE, B.BLUE_ICE):
    MATERIAL[int(_b)] = int(Mat.SMOOTH_MICRO)
for _b in (B.SNOW, B.SNOWY_GRASS_BLOCK):
    MATERIAL[int(_b)] = int(Mat.MICRO)
for _b in (B.SAND, B.GRAVEL):
    MATERIAL[int(_b)] = int(Mat.ROUGH_MICRO)

# Emissive strength per block (reference: emissive atlas texture; indirect light x100,
# basic_shaders.cu).  Values are emission scale factors applied to the block color.
EMISSION = np.zeros(NUM_BLOCKS, dtype=np.float32)
for _b, _s in [
    (B.LAVA, 8.0),
    (B.GLOWSTONE, 6.0),
    (B.SHROOMLIGHT, 5.0),
    (B.SEA_LANTERN, 5.0),
    (B.CAVE_VINES_GLOW_MAIN, 2.0),
    (B.CAVE_VINES_GLOW_END, 2.0),
    (B.MAGENTA_CRYSTAL, 1.5),
    (B.CYAN_CRYSTAL, 1.5),
    (B.GREEN_CRYSTAL, 1.5),
    (B.SMALL_MAGENTA_CRYSTAL, 1.0),
    (B.SMALL_CYAN_CRYSTAL, 1.0),
    (B.SMALL_GREEN_CRYSTAL, 1.0),
    (B.HANGING_SMALL_MAGENTA_CRYSTAL, 1.0),
    (B.HANGING_SMALL_CYAN_CRYSTAL, 1.0),
    (B.HANGING_SMALL_GREEN_CRYSTAL, 1.0),
    (B.TORCHFLOWER, 1.0),
    (B.WARPED_MUSHROOM, 0.5),
    (B.INFECTED_MUSHROOM, 0.5),
]:
    EMISSION[int(_b)] = _s

#: blocks the DDA tracer treats as fully solid occupancy (everything >= BEDROCK plus
#: water/lava; flora/X-shaped handled as cutout hits).
SOLID = np.ones(NUM_BLOCKS, dtype=bool)
SOLID[int(B.AIR)] = False
for _i in range(int(B.CAVE_VINES_MAIN), NUM_NON_SOLID_BLOCKS):
    SOLID[_i] = False  # X-shaped flora: not solid for occupancy (alpha-cutout geometry)

#: contiguous id range of X-shaped flora (block.hpp:154 non-solid range): detected in
#: the tracer's DDA by two integer compares, no table gather
X_SHAPED_LO = int(B.CAVE_VINES_MAIN)
X_SHAPED_HI = NUM_NON_SOLID_BLOCKS  # exclusive

#: occupancy for the RENDERER's distance field: X-shaped flora stop the DDA so their
#: crossed quads can be intersected analytically (the reference draws them as crossed
#: cutout quads hit via anyhit, chunk.cu:1901-1935 + basic_shaders.cu:1046-1068)
RENDER_SOLID = SOLID.copy()
RENDER_SOLID[X_SHAPED_LO:X_SHAPED_HI] = True
