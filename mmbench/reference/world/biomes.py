"""Biome database: 24 surface biomes, 5 cave biomes, 20 materials, weight tables.

Port copy (numpy only) of mega_minecraft_tpu/world: the equivalent of the reference biome DB (reference behavior:
the reference source, src/terrain/biome.hpp + biomeFuncs.hpp:725-1256).  The reference uploads
these tables to CUDA ``__constant__`` memory; here they are numpy constant arrays used
by the plain versions and uploaded as tensors for the kernels (tables.py).
"""

from __future__ import annotations

import enum
import math

import numpy as np

from .blocks import Block

SEA_LEVEL = 128  # biome.hpp:10
LAVA_LEVEL = 8  # biome.hpp:11
MAX_CAVE_LAYERS_PER_COLUMN = 32  # biome.hpp:6
MAX_GATHERED_FEATURES_PER_CHUNK = 2048  # biome.hpp:7
MAX_GATHERED_CAVE_FEATURES_PER_CHUNK = 4096  # biome.hpp:8


class Biome(enum.IntEnum):
    CORAL_REEF = 0
    ARCHIPELAGO = enum.auto()
    WARM_OCEAN = enum.auto()
    ICEBERGS = enum.auto()
    COOL_OCEAN = enum.auto()
    ROCKY_BEACH = enum.auto()
    TROPICAL_BEACH = enum.auto()
    BEACH = enum.auto()
    SAVANNA = enum.auto()
    MESA = enum.auto()
    FROZEN_WASTELAND = enum.auto()
    REDWOOD_FOREST = enum.auto()
    SHREKS_SWAMP = enum.auto()
    SPARSE_DESERT = enum.auto()
    LUSH_BIRCH_FOREST = enum.auto()
    TIANZI_MOUNTAINS = enum.auto()
    JUNGLE = enum.auto()
    RED_DESERT = enum.auto()
    PURPLE_MUSHROOMS = enum.auto()
    CRYSTALS = enum.auto()
    OASIS = enum.auto()
    DESERT = enum.auto()
    PLAINS = enum.auto()
    MOUNTAINS = enum.auto()


NUM_BIOMES = int(Biome.MOUNTAINS) + 1
NUM_OCEAN_BIOMES = int(Biome.COOL_OCEAN) + 1
NUM_OCEAN_AND_BEACH_BIOMES = int(Biome.BEACH) + 1


class CaveBiome(enum.IntEnum):
    NONE = 0
    CRYSTAL_CAVES = enum.auto()
    LUSH_CAVES = enum.auto()
    WARPED_FOREST = enum.auto()
    AMBER_FOREST = enum.auto()


NUM_CAVE_BIOMES = int(CaveBiome.AMBER_FOREST) + 1


class Material(enum.IntEnum):
    # stratified (forward)
    BLACKSTONE = 0
    DEEPSLATE = enum.auto()
    SLATE = enum.auto()
    STONE = enum.auto()
    TUFF = enum.auto()
    CALCITE = enum.auto()
    GRANITE = enum.auto()
    TERRACOTTA = enum.auto()
    MARBLE = enum.auto()
    ANDESITE = enum.auto()
    # stratified, placed backwards
    RED_SANDSTONE = enum.auto()
    SANDSTONE = enum.auto()
    # eroded
    GRAVEL = enum.auto()
    CLAY = enum.auto()
    MUD = enum.auto()
    DIRT = enum.auto()
    RED_SAND = enum.auto()
    SAND = enum.auto()
    SMOOTH_SAND = enum.auto()
    SNOW = enum.auto()


NUM_MATERIALS = int(Material.SNOW) + 1  # 20
NUM_STRATIFIED_MATERIALS = int(Material.SANDSTONE) + 1  # 12
NUM_FORWARD_MATERIALS = int(Material.ANDESITE) + 1  # 10
NUM_ERODED_MATERIALS = NUM_MATERIALS - NUM_STRATIFIED_MATERIALS  # 8

# ---------------------------------------------------------------------------
# Biome noise-weight tables (biomeFuncs.hpp:733-779).
# Channels: ocean, beach, rocky, magic, temperature, moisture.
# 0 = ignore, 1 = positive (×noise), 2 = negative (×(1−noise)).
# ---------------------------------------------------------------------------

_I, _P, _N = 0, 1, 2

BIOME_NOISE_WEIGHTS = np.zeros((NUM_BIOMES, 6), dtype=np.int32)


def _bw(biome, *types):
    BIOME_NOISE_WEIGHTS[int(biome)] = types


_bw(Biome.CORAL_REEF, _P, _N, _P, _P, _I, _I)
_bw(Biome.ARCHIPELAGO, _P, _N, _P, _N, _I, _I)
_bw(Biome.WARM_OCEAN, _P, _N, _N, _I, _P, _I)
_bw(Biome.ICEBERGS, _P, _N, _N, _P, _N, _I)
_bw(Biome.COOL_OCEAN, _P, _N, _N, _N, _N, _I)
_bw(Biome.ROCKY_BEACH, _P, _P, _P, _I, _I, _I)
_bw(Biome.TROPICAL_BEACH, _P, _P, _N, _I, _P, _I)
_bw(Biome.BEACH, _P, _P, _N, _I, _N, _I)
_bw(Biome.SAVANNA, _N, _I, _P, _P, _P, _P)
_bw(Biome.MESA, _N, _I, _P, _P, _P, _N)
_bw(Biome.FROZEN_WASTELAND, _N, _I, _P, _P, _N, _P)
_bw(Biome.REDWOOD_FOREST, _N, _I, _P, _P, _N, _N)
_bw(Biome.SHREKS_SWAMP, _N, _I, _P, _N, _P, _P)
_bw(Biome.SPARSE_DESERT, _N, _I, _P, _N, _P, _N)
_bw(Biome.LUSH_BIRCH_FOREST, _N, _I, _P, _N, _N, _P)
_bw(Biome.TIANZI_MOUNTAINS, _N, _I, _P, _N, _N, _N)
_bw(Biome.JUNGLE, _N, _I, _N, _P, _P, _P)
_bw(Biome.RED_DESERT, _N, _I, _N, _P, _P, _N)
_bw(Biome.PURPLE_MUSHROOMS, _N, _I, _N, _P, _N, _P)
_bw(Biome.CRYSTALS, _N, _I, _N, _P, _N, _N)
_bw(Biome.OASIS, _N, _I, _N, _N, _P, _P)
_bw(Biome.DESERT, _N, _I, _N, _N, _P, _N)
_bw(Biome.PLAINS, _N, _I, _N, _N, _N, _P)
_bw(Biome.MOUNTAINS, _N, _I, _N, _N, _N, _N)

# Cave biome channels: none, shallow, warped, rocky (biomeFuncs.hpp:767-779)
CAVE_BIOME_NOISE_WEIGHTS = np.zeros((NUM_CAVE_BIOMES, 4), dtype=np.int32)


def _cbw(biome, *types):
    CAVE_BIOME_NOISE_WEIGHTS[int(biome)] = types


_cbw(CaveBiome.NONE, _P, _I, _I, _I)
_cbw(CaveBiome.CRYSTAL_CAVES, _N, _P, _I, _P)
_cbw(CaveBiome.LUSH_CAVES, _N, _P, _I, _N)
_cbw(CaveBiome.WARPED_FOREST, _I, _N, _P, _I)
_cbw(CaveBiome.AMBER_FOREST, _I, _N, _N, _I)

OVERALL_BIOME_SCALE = 0.32  # biomeFuncs.hpp:104
OVERALL_CAVE_BIOME_SCALE = 1.0  # biomeFuncs.hpp:106

# ---------------------------------------------------------------------------
# Grass-block overrides (biomeFuncs.hpp:786-804): biome -> block placed instead of DIRT
# on the top block.  Default is DIRT.
# ---------------------------------------------------------------------------

GRASS_BLOCKS = np.full(NUM_BIOMES, int(Block.DIRT), dtype=np.int32)
for _biome, _block in [
    (Biome.TROPICAL_BEACH, Block.JUNGLE_GRASS_BLOCK),
    (Biome.SAVANNA, Block.SAVANNA_GRASS_BLOCK),
    (Biome.FROZEN_WASTELAND, Block.SNOWY_GRASS_BLOCK),
    (Biome.REDWOOD_FOREST, Block.GRASS_BLOCK),
    (Biome.SHREKS_SWAMP, Block.JUNGLE_GRASS_BLOCK),
    (Biome.LUSH_BIRCH_FOREST, Block.GRASS_BLOCK),
    (Biome.TIANZI_MOUNTAINS, Block.GRASS_BLOCK),
    (Biome.JUNGLE, Block.JUNGLE_GRASS_BLOCK),
    (Biome.PURPLE_MUSHROOMS, Block.MYCELIUM),
    (Biome.OASIS, Block.JUNGLE_GRASS_BLOCK),
    (Biome.PLAINS, Block.GRASS_BLOCK),
    (Biome.MOUNTAINS, Block.GRASS_BLOCK),
]:
    GRASS_BLOCKS[int(_biome)] = int(_block)

# ---------------------------------------------------------------------------
# Material infos (biomeFuncs.hpp:806-850).
# Forward/backward stratified: (block, thickness, noiseAmplitude, noiseScale)
# Eroded: (block, thickness, tan(angleOfRepose), maxSlope)
# ---------------------------------------------------------------------------

_MATERIAL_ROWS = {
    Material.BLACKSTONE: (Block.BLACKSTONE, 32.0, 32.0, 0.0030),
    Material.DEEPSLATE: (Block.DEEPSLATE, 66.0, 20.0, 0.0045),
    Material.SLATE: (Block.SLATE, 6.0, 24.0, 0.0062),
    Material.STONE: (Block.STONE, 40.0, 30.0, 0.0050),
    Material.TUFF: (Block.TUFF, 24.0, 42.0, 0.0060),
    Material.CALCITE: (Block.CALCITE, 20.0, 30.0, 0.0040),
    Material.GRANITE: (Block.GRANITE, 18.0, 36.0, 0.0034),
    Material.TERRACOTTA: (Block.TERRACOTTA, 32.0, 16.0, 0.0020),
    Material.MARBLE: (Block.MARBLE, 28.0, 56.0, 0.0050),
    Material.ANDESITE: (Block.ANDESITE, 24.0, 48.0, 0.0030),
    Material.RED_SANDSTONE: (Block.RED_SANDSTONE, 3.0, 2.0, 0.0035),
    Material.SANDSTONE: (Block.SANDSTONE, 3.5, 1.5, 0.0025),
    # eroded: (block, thickness, angleOfRepose°(→tan below), maxSlope)
    Material.GRAVEL: (Block.GRAVEL, 2.5, 55.0, 1.8),
    Material.CLAY: (Block.CLAY, 2.7, 40.0, 1.8),
    Material.MUD: (Block.MUD, 2.3, 45.0, 1.6),
    Material.DIRT: (Block.DIRT, 4.2, 40.0, 1.2),
    Material.RED_SAND: (Block.RED_SAND, 3.5, 30.0, 1.5),
    Material.SAND: (Block.SAND, 3.8, 35.0, 1.4),
    Material.SMOOTH_SAND: (Block.SMOOTH_SAND, 4.5, 65.0, 4.0),
    Material.SNOW: (Block.SNOW, 2.5, 45.0, 1.5),
}

MATERIAL_BLOCK = np.zeros(NUM_MATERIALS, dtype=np.int32)
MATERIAL_THICKNESS = np.zeros(NUM_MATERIALS, dtype=np.float32)
#: noise amplitude (stratified) or tan(angle of repose) (eroded)
MATERIAL_AMPLITUDE_OR_TAN_REPOSE = np.zeros(NUM_MATERIALS, dtype=np.float32)
#: noise scale (stratified) or max slope (eroded)
MATERIAL_SCALE_OR_MAX_SLOPE = np.zeros(NUM_MATERIALS, dtype=np.float32)

for _m, (_blk, _th, _amp, _sc) in _MATERIAL_ROWS.items():
    _i = int(_m)
    MATERIAL_BLOCK[_i] = int(_blk)
    MATERIAL_THICKNESS[_i] = _th
    if _i >= NUM_STRATIFIED_MATERIALS:
        # reference converts degrees -> tan at init with f32 tanf (biomeFuncs.hpp:843-847)
        _amp = math.tan(math.radians(np.float32(_amp)))
    MATERIAL_AMPLITUDE_OR_TAN_REPOSE[_i] = np.float32(_amp)
    MATERIAL_SCALE_OR_MAX_SLOPE[_i] = _sc

# ---------------------------------------------------------------------------
# Biome × material weight matrix (biomeFuncs.hpp:856-963).  Defaults to 1 with a set of
# zeroed materials per biome, then per-biome overrides.
# ---------------------------------------------------------------------------

BIOME_MATERIAL_WEIGHTS = np.ones((NUM_BIOMES, NUM_MATERIALS), dtype=np.float32)
for _m in (
    Material.TERRACOTTA,
    Material.RED_SANDSTONE,
    Material.SANDSTONE,
    Material.GRAVEL,
    Material.CLAY,
    Material.MUD,
    Material.RED_SAND,
    Material.SAND,
    Material.SMOOTH_SAND,
    Material.SNOW,
):
    BIOME_MATERIAL_WEIGHTS[:, int(_m)] = 0.0


def _bmw(biome, material, weight):
    BIOME_MATERIAL_WEIGHTS[int(biome), int(material)] = weight


_bmw(Biome.CORAL_REEF, Material.DIRT, 0.0)
_bmw(Biome.CORAL_REEF, Material.SAND, 0.7)
_bmw(Biome.CORAL_REEF, Material.SMOOTH_SAND, 0.8)
_bmw(Biome.ARCHIPELAGO, Material.GRAVEL, 0.3)
_bmw(Biome.ARCHIPELAGO, Material.DIRT, 0.0)
_bmw(Biome.ARCHIPELAGO, Material.SAND, 0.8)
_bmw(Biome.WARM_OCEAN, Material.DIRT, 0.0)
_bmw(Biome.WARM_OCEAN, Material.SAND, 0.7)
_bmw(Biome.ICEBERGS, Material.GRAVEL, 0.5)
_bmw(Biome.ICEBERGS, Material.DIRT, 0.0)
_bmw(Biome.COOL_OCEAN, Material.GRAVEL, 0.5)
_bmw(Biome.COOL_OCEAN, Material.DIRT, 0.0)
_bmw(Biome.ROCKY_BEACH, Material.DIRT, 0.0)
_bmw(Biome.ROCKY_BEACH, Material.GRAVEL, 1.0)
_bmw(Biome.TROPICAL_BEACH, Material.DIRT, 0.0)
_bmw(Biome.TROPICAL_BEACH, Material.SMOOTH_SAND, 1.0)
_bmw(Biome.BEACH, Material.DIRT, 0.0)
_bmw(Biome.BEACH, Material.SAND, 1.0)
_bmw(Biome.SAVANNA, Material.STONE, 0.6)
_bmw(Biome.SAVANNA, Material.TUFF, 0.15)
_bmw(Biome.SAVANNA, Material.CALCITE, 0.0)
_bmw(Biome.SAVANNA, Material.GRANITE, 0.2)
_bmw(Biome.SAVANNA, Material.TERRACOTTA, 3.2)
_bmw(Biome.SAVANNA, Material.MARBLE, 0.0)
_bmw(Biome.MESA, Material.CLAY, 0.8)
_bmw(Biome.MESA, Material.DIRT, 0.0)
_bmw(Biome.FROZEN_WASTELAND, Material.GRANITE, 0.0)
_bmw(Biome.FROZEN_WASTELAND, Material.DIRT, 0.6)
_bmw(Biome.FROZEN_WASTELAND, Material.SNOW, 1.1)
_bmw(Biome.SHREKS_SWAMP, Material.CLAY, 1.7)
_bmw(Biome.SHREKS_SWAMP, Material.MUD, 2.2)
_bmw(Biome.SHREKS_SWAMP, Material.DIRT, 0.6)
_bmw(Biome.SPARSE_DESERT, Material.MARBLE, 2.0)
_bmw(Biome.SPARSE_DESERT, Material.ANDESITE, 0.5)
_bmw(Biome.SPARSE_DESERT, Material.DIRT, 0.0)
_bmw(Biome.SPARSE_DESERT, Material.SMOOTH_SAND, 1.4)
_bmw(Biome.TIANZI_MOUNTAINS, Material.SANDSTONE, 1.0)
_bmw(Biome.JUNGLE, Material.CLAY, 1.0)
_bmw(Biome.JUNGLE, Material.MUD, 1.0)
_bmw(Biome.JUNGLE, Material.DIRT, 0.5)
_bmw(Biome.RED_DESERT, Material.RED_SANDSTONE, 1.0)
_bmw(Biome.RED_DESERT, Material.DIRT, 0.0)
_bmw(Biome.RED_DESERT, Material.RED_SAND, 1.0)
_bmw(Biome.PURPLE_MUSHROOMS, Material.GRAVEL, 0.4)
_bmw(Biome.CRYSTALS, Material.CALCITE, 0.3)
_bmw(Biome.CRYSTALS, Material.GRAVEL, 0.15)
_bmw(Biome.CRYSTALS, Material.CLAY, 0.2)
_bmw(Biome.CRYSTALS, Material.DIRT, 0.0)
_bmw(Biome.OASIS, Material.SANDSTONE, 1.0)
_bmw(Biome.OASIS, Material.CLAY, 0.4)
_bmw(Biome.OASIS, Material.DIRT, 0.6)
_bmw(Biome.OASIS, Material.SAND, 0.4)
_bmw(Biome.DESERT, Material.SANDSTONE, 1.0)
_bmw(Biome.DESERT, Material.DIRT, 0.0)
_bmw(Biome.DESERT, Material.SAND, 1.0)
_bmw(Biome.MOUNTAINS, Material.GRAVEL, 1.0)

# 8-neighborhood direction vectors, N→NW clockwise (enums.hpp:32-41); odd indices are
# diagonals (slope distance ×√2).
DIR_VECS_2D = np.array(
    [[0, 1], [1, 1], [1, 0], [1, -1], [0, -1], [-1, -1], [-1, 0], [-1, 1]],
    dtype=np.int32,
)

SQRT_2 = 1.4142135623730951
