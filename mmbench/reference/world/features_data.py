"""Feature / cave-feature / decorator generation tables.

Port copy (numpy only) of mega_minecraft_tpu/world: the equivalent of the reference's feature DB (reference behavior:
the reference source, src/terrain/biome.hpp:119-297 structs and
biomeFuncs.hpp:969-1256 per-biome gen lists + height bounds).  Exported as numpy
constant arrays for the device-side placement pass (terrain/feature_placement.py).
"""

from __future__ import annotations

import enum

import numpy as np

from .biomes import Biome, CaveBiome, Material, NUM_BIOMES, NUM_CAVE_BIOMES
from .blocks import Block


class Feature(enum.IntEnum):
    NONE = 0
    SPHERE = enum.auto()
    CORAL = enum.auto()
    KELP = enum.auto()
    ICEBERG = enum.auto()
    ACACIA_TREE = enum.auto()
    REDWOOD_TREE = enum.auto()
    CYPRESS_TREE = enum.auto()
    BIRCH_TREE = enum.auto()
    PINE_TREE = enum.auto()
    PINE_SHRUB = enum.auto()
    RAFFLESIA = enum.auto()
    LARGE_JUNGLE_TREE = enum.auto()
    SMALL_JUNGLE_TREE = enum.auto()
    TINY_JUNGLE_TREE = enum.auto()
    MEDIUM_PURPLE_MUSHROOM = enum.auto()
    PURPLE_MUSHROOM = enum.auto()
    MEDIUM_CRYSTAL = enum.auto()
    CRYSTAL = enum.auto()
    PALM_TREE = enum.auto()
    CACTUS = enum.auto()


NUM_FEATURES = int(Feature.CACTUS) + 1


class CaveFeature(enum.IntEnum):
    NONE = 0
    TEST_GLOWSTONE_PILLAR = enum.auto()
    TEST_SHROOMLIGHT_PILLAR = enum.auto()
    CAVE_VINE = enum.auto()
    GLOWSTONE_CLUSTER = enum.auto()
    STORMLIGHT_SPHERE = enum.auto()
    CEILING_STORMLIGHT_SPHERE = enum.auto()
    CRYSTAL_PILLAR = enum.auto()
    WARPED_FUNGUS = enum.auto()
    AMBER_FUNGUS = enum.auto()


NUM_CAVE_FEATURES = int(CaveFeature.AMBER_FUNGUS) + 1

# Feature height bounds: actual bounds = pos.y + (lo, hi) (biomeFuncs.hpp:1042-1074)
FEATURE_HEIGHT_BOUNDS = np.zeros((NUM_FEATURES, 2), np.int32)
for _f, _lo, _hi in [
    (Feature.NONE, 0, 0),
    (Feature.SPHERE, -6, 6),
    (Feature.CORAL, -3, 12),
    (Feature.KELP, 0, 20),
    (Feature.ICEBERG, 0, 110),
    (Feature.ACACIA_TREE, 0, 15),
    (Feature.REDWOOD_TREE, -5, 75),
    (Feature.CYPRESS_TREE, -3, 50),
    (Feature.BIRCH_TREE, 0, 30),
    (Feature.PINE_TREE, 0, 15),
    (Feature.PINE_SHRUB, 0, 8),
    (Feature.RAFFLESIA, 0, 10),
    (Feature.TINY_JUNGLE_TREE, 0, 5),
    (Feature.SMALL_JUNGLE_TREE, 0, 17),
    (Feature.LARGE_JUNGLE_TREE, 0, 38),
    (Feature.MEDIUM_PURPLE_MUSHROOM, 0, 6),
    (Feature.PURPLE_MUSHROOM, 0, 120),
    (Feature.MEDIUM_CRYSTAL, -3, 32),
    (Feature.CRYSTAL, -6, 64),
    (Feature.PALM_TREE, 0, 28),
    (Feature.CACTUS, 0, 15),
]:
    FEATURE_HEIGHT_BOUNDS[int(_f)] = (_lo, _hi)

# Cave feature bounds: actual = (pos.y + lo, pos.y + layerHeight + hi)
# (biomeFuncs.hpp:1185-1223)
CAVE_FEATURE_HEIGHT_BOUNDS = np.zeros((NUM_CAVE_FEATURES, 2), np.int32)
for _f, _lo, _hi in [
    (CaveFeature.NONE, 0, 0),
    (CaveFeature.TEST_GLOWSTONE_PILLAR, -3, 3),
    (CaveFeature.TEST_SHROOMLIGHT_PILLAR, -3, 3),
    (CaveFeature.CAVE_VINE, 0, 0),
    (CaveFeature.GLOWSTONE_CLUSTER, 0, 6),
    (CaveFeature.STORMLIGHT_SPHERE, -12, 12),
    (CaveFeature.CEILING_STORMLIGHT_SPHERE, -12, 12),
    (CaveFeature.CRYSTAL_PILLAR, -8, 8),
    (CaveFeature.WARPED_FUNGUS, -2, 3),
    (CaveFeature.AMBER_FUNGUS, -2, 5),
]:
    CAVE_FEATURE_HEIGHT_BOUNDS[int(_f)] = (_lo, _hi)

# ---------------------------------------------------------------------------
# Per-biome surface FeatureGen lists (biomeFuncs.hpp:974-1040).
# Row: (feature, gridCellSize, gridCellPadding, chancePerGridCell,
#       canReplaceBlocks, possibleTopLayers [(material, minThickness), ...])
# ---------------------------------------------------------------------------

_F = Feature
_M = Material

BIOME_FEATURE_GENS: dict = {int(b): [] for b in Biome}
BIOME_FEATURE_GENS[int(Biome.CORAL_REEF)] = [
    (_F.CORAL, 5, 0, 0.65, True, [(_M.SMOOTH_SAND, 0.3), (_M.SAND, 0.3)]),
    (_F.KELP, 8, 0, 0.50, True, [(_M.SMOOTH_SAND, 0.3), (_M.SAND, 0.3)]),
]
BIOME_FEATURE_GENS[int(Biome.ICEBERGS)] = [(_F.ICEBERG, 112, 6, 0.70, True, [])]
BIOME_FEATURE_GENS[int(Biome.TROPICAL_BEACH)] = [
    (_F.PALM_TREE, 48, 3, 0.35, True, [(_M.SMOOTH_SAND, 0.3)])
]
BIOME_FEATURE_GENS[int(Biome.SAVANNA)] = [
    (_F.ACACIA_TREE, 36, 4, 0.3, True, [(_M.DIRT, 0.5)])
]
BIOME_FEATURE_GENS[int(Biome.REDWOOD_FOREST)] = [
    (_F.REDWOOD_TREE, 16, 2, 0.70, True, [(_M.DIRT, 0.5)])
]
BIOME_FEATURE_GENS[int(Biome.SHREKS_SWAMP)] = [
    (_F.CYPRESS_TREE, 18, 3, 0.6, True, [(_M.DIRT, 0.5), (_M.MUD, 0.5)]),
    (_F.BIRCH_TREE, 16, 2, 0.15, True, [(_M.DIRT, 0.4)]),
]
BIOME_FEATURE_GENS[int(Biome.LUSH_BIRCH_FOREST)] = [
    (_F.BIRCH_TREE, 9, 2, 0.7, True, [(_M.DIRT, 0.5)])
]
BIOME_FEATURE_GENS[int(Biome.TIANZI_MOUNTAINS)] = [
    (_F.PINE_TREE, 7, 1, 0.80, False, []),
    (_F.PINE_SHRUB, 6, 1, 0.80, False, []),
]
BIOME_FEATURE_GENS[int(Biome.JUNGLE)] = [
    (_F.RAFFLESIA, 54, 6, 0.50, True, [(_M.DIRT, 0.5)]),
    (_F.LARGE_JUNGLE_TREE, 28, 3, 0.70, True, [(_M.DIRT, 0.5)]),
    (_F.SMALL_JUNGLE_TREE, 10, 2, 0.82, True, [(_M.DIRT, 0.5)]),
    (_F.TINY_JUNGLE_TREE, 6, 1, 0.28, True, [(_M.DIRT, 0.5)]),
]
BIOME_FEATURE_GENS[int(Biome.RED_DESERT)] = [
    (_F.PALM_TREE, 40, 3, 0.20, True, [(_M.RED_SAND, 0.3)]),
    (_F.CACTUS, 16, 2, 0.20, True, [(_M.RED_SAND, 0.5)]),
]
BIOME_FEATURE_GENS[int(Biome.PURPLE_MUSHROOMS)] = [
    (_F.MEDIUM_PURPLE_MUSHROOM, 10, 2, 0.50, True, [(_M.DIRT, 0.3)]),
    (_F.PURPLE_MUSHROOM, 11, 3, 0.45, True, [(_M.DIRT, 0.5)]),
]
BIOME_FEATURE_GENS[int(Biome.CRYSTALS)] = [
    (_F.MEDIUM_CRYSTAL, 28, 6, 0.9, True, []),
    (_F.CRYSTAL, 52, 10, 0.8, True, []),
]
BIOME_FEATURE_GENS[int(Biome.OASIS)] = [
    (_F.PALM_TREE, 24, 3, 0.35, True, [(_M.SAND, 0.3)]),
    (_F.CACTUS, 16, 2, 0.40, True, [(_M.SAND, 0.5)]),
]
BIOME_FEATURE_GENS[int(Biome.DESERT)] = [
    (_F.PALM_TREE, 64, 3, 0.30, True, [(_M.SAND, 0.3)]),
    (_F.CACTUS, 16, 2, 0.70, True, [(_M.SAND, 0.5)]),
]

# ---------------------------------------------------------------------------
# Per-cave-biome CaveFeatureGen lists (biomeFuncs.hpp:1188-1208).
# Row: (feature, gridCellSize, gridCellPadding, chancePerGridCell, minLayerHeight,
#       canReplaceBlocks, generatesFromCeiling, canGenerateInLava)
# ---------------------------------------------------------------------------

_CF = CaveFeature

CAVE_FEATURE_GENS: dict = {int(b): [] for b in CaveBiome}
CAVE_FEATURE_GENS[int(CaveBiome.CRYSTAL_CAVES)] = [
    (_CF.STORMLIGHT_SPHERE, 32, 4, 0.80, 4, True, False, False),
    (_CF.CEILING_STORMLIGHT_SPHERE, 32, 4, 0.80, 4, True, True, False),
    (_CF.CRYSTAL_PILLAR, 28, 5, 0.60, 10, False, True, False),
]
CAVE_FEATURE_GENS[int(CaveBiome.LUSH_CAVES)] = [
    (_CF.GLOWSTONE_CLUSTER, 24, 3, 0.60, 16, False, True, False),
    (_CF.CAVE_VINE, 4, 0, 0.40, 4, False, True, False),
]
CAVE_FEATURE_GENS[int(CaveBiome.WARPED_FOREST)] = [
    (_CF.GLOWSTONE_CLUSTER, 16, 3, 0.80, 16, False, True, False),
    (_CF.WARPED_FUNGUS, 7, 1, 0.75, 6, False, False, False),
]
CAVE_FEATURE_GENS[int(CaveBiome.AMBER_FOREST)] = [
    (_CF.GLOWSTONE_CLUSTER, 18, 3, 0.75, 16, False, True, False),
    (_CF.AMBER_FUNGUS, 5, 1, 0.60, 9, False, False, False),
]

# ---------------------------------------------------------------------------
# Decorator tables (biomeFuncs.hpp:1080-1253).
# Row: (decoratorBlock, chance, possibleUnderBlocks (empty = any solid),
#       possibleReplaceBlocks, secondDecoratorBlock, generatesFromCeiling)
# ---------------------------------------------------------------------------

_B = Block
_AIR = (int(_B.AIR),)
_WATER = (int(_B.WATER),)


def _d(block, chance, under, replace=_AIR, second=_B.AIR, ceiling=False):
    return (
        int(block),
        float(chance),
        tuple(int(b) for b in under),
        tuple(replace),
        int(second),
        bool(ceiling),
    )


_CORAL_BOTTOM = (_B.SAND, _B.SMOOTH_SAND)
_SMALL_CRYSTAL_BOTTOM = (_B.STONE, _B.TUFF, _B.CALCITE)

BIOME_DECORATOR_GENS: dict = {int(b): [] for b in Biome}
BIOME_DECORATOR_GENS[int(Biome.CORAL_REEF)] = [
    _d(_B.SEAGRASS, 0.200, _CORAL_BOTTOM, _WATER),
    _d(_B.TALL_SEAGRASS_BOTTOM, 0.040, _CORAL_BOTTOM, _WATER, _B.TALL_SEAGRASS_TOP),
    _d(_B.BRAIN_CORAL, 0.030, _CORAL_BOTTOM, _WATER, _B.WATER),
    _d(_B.BUBBLE_CORAL, 0.030, _CORAL_BOTTOM, _WATER, _B.WATER),
    _d(_B.FIRE_CORAL, 0.030, _CORAL_BOTTOM, _WATER, _B.WATER),
    _d(_B.HORN_CORAL, 0.030, _CORAL_BOTTOM, _WATER, _B.WATER),
    _d(_B.TUBE_CORAL, 0.030, _CORAL_BOTTOM, _WATER, _B.WATER),
]
BIOME_DECORATOR_GENS[int(Biome.ARCHIPELAGO)] = [
    _d(_B.GRASS, 0.200, (_B.GRASS_BLOCK,)),
    _d(_B.LILY_OF_THE_VALLEY, 0.025, (_B.GRASS_BLOCK,)),
]
BIOME_DECORATOR_GENS[int(Biome.TROPICAL_BEACH)] = [
    _d(_B.JUNGLE_GRASS, 0.1, (_B.JUNGLE_GRASS_BLOCK,)),
]
BIOME_DECORATOR_GENS[int(Biome.SAVANNA)] = [
    _d(_B.SAVANNA_GRASS, 0.1, (_B.SAVANNA_GRASS_BLOCK,)),
]
BIOME_DECORATOR_GENS[int(Biome.REDWOOD_FOREST)] = [
    _d(_B.GRASS, 0.200, (_B.GRASS_BLOCK,)),
    _d(_B.TALL_GRASS_BOTTOM, 0.080, (_B.GRASS_BLOCK,), _AIR, _B.TALL_GRASS_TOP),
    _d(_B.OXEYE_DAISY, 0.040, (_B.GRASS_BLOCK,)),
    _d(_B.LILY_OF_THE_VALLEY, 0.040, (_B.GRASS_BLOCK,)),
    _d(_B.PEONY_BOTTOM, 0.020, (_B.GRASS_BLOCK,), _AIR, _B.PEONY_TOP),
]
BIOME_DECORATOR_GENS[int(Biome.SHREKS_SWAMP)] = [
    _d(_B.JUNGLE_GRASS, 0.300, (_B.JUNGLE_GRASS_BLOCK,)),
    _d(_B.JUNGLE_FERN, 0.050, (_B.JUNGLE_GRASS_BLOCK,)),
    _d(_B.CORNFLOWER, 0.030, (_B.JUNGLE_GRASS_BLOCK,)),
    _d(_B.BLUE_ORCHID, 0.030, (_B.JUNGLE_GRASS_BLOCK,)),
    _d(_B.ALLIUM, 0.030, (_B.JUNGLE_GRASS_BLOCK,)),
]
BIOME_DECORATOR_GENS[int(Biome.LUSH_BIRCH_FOREST)] = [
    _d(_B.GRASS, 0.300, (_B.GRASS_BLOCK,)),
    _d(_B.PEONY_BOTTOM, 0.020, (_B.GRASS_BLOCK,), _AIR, _B.PEONY_TOP),
    _d(_B.LILAC_BOTTOM, 0.020, (_B.GRASS_BLOCK,), _AIR, _B.LILAC_TOP),
    _d(_B.DANDELION, 0.040, (_B.GRASS_BLOCK,)),
]
BIOME_DECORATOR_GENS[int(Biome.JUNGLE)] = [
    _d(_B.JUNGLE_GRASS, 0.400, (_B.JUNGLE_GRASS_BLOCK,)),
    _d(_B.TALL_JUNGLE_GRASS_BOTTOM, 0.200, (_B.JUNGLE_GRASS_BLOCK,), _AIR, _B.TALL_JUNGLE_GRASS_TOP),
    _d(_B.PITCHER_BOTTOM, 0.030, (_B.JUNGLE_GRASS_BLOCK,), _AIR, _B.PITCHER_TOP),
    _d(_B.JUNGLE_FERN, 0.120, (_B.JUNGLE_GRASS_BLOCK,)),
    _d(_B.BLUE_ORCHID, 0.040, (_B.JUNGLE_GRASS_BLOCK,)),
]
BIOME_DECORATOR_GENS[int(Biome.RED_DESERT)] = [
    _d(_B.DEAD_BUSH, 0.020, (_B.RED_SAND,)),
]
BIOME_DECORATOR_GENS[int(Biome.PURPLE_MUSHROOMS)] = [
    _d(_B.SMALL_PURPLE_MUSHROOM, 0.100, (_B.MYCELIUM,)),
    _d(_B.SMALL_MAGENTA_CRYSTAL, 0.005, _SMALL_CRYSTAL_BOTTOM),
    _d(_B.SMALL_CYAN_CRYSTAL, 0.005, _SMALL_CRYSTAL_BOTTOM),
    _d(_B.SMALL_GREEN_CRYSTAL, 0.005, _SMALL_CRYSTAL_BOTTOM),
]
BIOME_DECORATOR_GENS[int(Biome.CRYSTALS)] = [
    _d(_B.SMALL_PURPLE_MUSHROOM, 0.020, (_B.MYCELIUM,)),
    _d(_B.SMALL_MAGENTA_CRYSTAL, 0.025, _SMALL_CRYSTAL_BOTTOM),
    _d(_B.SMALL_CYAN_CRYSTAL, 0.025, _SMALL_CRYSTAL_BOTTOM),
    _d(_B.SMALL_GREEN_CRYSTAL, 0.025, _SMALL_CRYSTAL_BOTTOM),
]
BIOME_DECORATOR_GENS[int(Biome.OASIS)] = [
    _d(_B.JUNGLE_GRASS, 0.200, (_B.JUNGLE_GRASS_BLOCK,)),
    _d(_B.CORNFLOWER, 0.020, (_B.JUNGLE_GRASS_BLOCK,)),
]
BIOME_DECORATOR_GENS[int(Biome.DESERT)] = [
    _d(_B.DEAD_BUSH, 0.030, (_B.RED_SAND,)),
]
BIOME_DECORATOR_GENS[int(Biome.PLAINS)] = [
    _d(_B.GRASS, 0.200, (_B.GRASS_BLOCK,)),
    _d(_B.RED_TULIP, 0.010, (_B.GRASS_BLOCK,)),
    _d(_B.ORANGE_TULIP, 0.010, (_B.GRASS_BLOCK,)),
    _d(_B.WHITE_TULIP, 0.010, (_B.GRASS_BLOCK,)),
    _d(_B.PINK_TULIP, 0.010, (_B.GRASS_BLOCK,)),
    _d(_B.DANDELION, 0.030, (_B.GRASS_BLOCK,)),
    _d(_B.POPPY, 0.030, (_B.GRASS_BLOCK,)),
]
BIOME_DECORATOR_GENS[int(Biome.MOUNTAINS)] = [
    _d(_B.GRASS, 0.050, (_B.GRASS_BLOCK,)),
    _d(_B.LILY_OF_THE_VALLEY, 0.015, (_B.GRASS_BLOCK,)),
]

CAVE_DECORATOR_GENS: dict = {int(b): [] for b in CaveBiome}
CAVE_DECORATOR_GENS[int(CaveBiome.CRYSTAL_CAVES)] = [
    _d(_B.SMALL_MAGENTA_CRYSTAL, 0.015, ()),
    _d(_B.SMALL_CYAN_CRYSTAL, 0.015, ()),
    _d(_B.SMALL_GREEN_CRYSTAL, 0.015, ()),
    _d(_B.HANGING_SMALL_MAGENTA_CRYSTAL, 0.015, (), ceiling=True),
    _d(_B.HANGING_SMALL_CYAN_CRYSTAL, 0.015, (), ceiling=True),
    _d(_B.HANGING_SMALL_GREEN_CRYSTAL, 0.015, (), ceiling=True),
]
CAVE_DECORATOR_GENS[int(CaveBiome.LUSH_CAVES)] = [
    _d(_B.GRASS, 0.100, (_B.MOSS,)),
    _d(_B.TALL_GRASS_BOTTOM, 0.030, (_B.MOSS,), _AIR, _B.TALL_GRASS_TOP),
    _d(_B.TORCHFLOWER, 0.020, (_B.MOSS,)),
]
CAVE_DECORATOR_GENS[int(CaveBiome.WARPED_FOREST)] = [
    _d(_B.WARPED_MUSHROOM, 0.020, (_B.WARPED_DEEPSLATE, _B.WARPED_BLACKSTONE)),
    _d(_B.WARPED_ROOTS, 0.060, (_B.WARPED_DEEPSLATE, _B.WARPED_BLACKSTONE)),
    _d(_B.NETHER_SPROUTS, 0.040, (_B.WARPED_DEEPSLATE, _B.WARPED_BLACKSTONE)),
]
CAVE_DECORATOR_GENS[int(CaveBiome.AMBER_FOREST)] = [
    _d(_B.INFECTED_MUSHROOM, 0.020, (_B.AMBER_DEEPSLATE, _B.AMBER_BLACKSTONE)),
    _d(_B.AMBER_ROOTS, 0.060, (_B.AMBER_DEEPSLATE, _B.AMBER_BLACKSTONE)),
]

# ---------------------------------------------------------------------------
# Flattened device tables for the placement pass: all (biome, genIdx) rows.
# ---------------------------------------------------------------------------


def _flatten_feature_gens():
    """-> dict of arrays indexed by [biome, gen_slot] with a per-biome count."""
    max_gens = max(len(v) for v in BIOME_FEATURE_GENS.values())
    max_layers = 2  # largest possibleTopLayers list
    count = np.zeros(NUM_BIOMES, np.int32)
    feature = np.zeros((NUM_BIOMES, max_gens), np.int32)
    cell = np.zeros((NUM_BIOMES, max_gens), np.int32)
    padding = np.zeros((NUM_BIOMES, max_gens), np.int32)
    chance = np.zeros((NUM_BIOMES, max_gens), np.float32)
    can_replace = np.zeros((NUM_BIOMES, max_gens), bool)
    n_top_layers = np.zeros((NUM_BIOMES, max_gens), np.int32)
    top_layer_mat = np.zeros((NUM_BIOMES, max_gens, max_layers), np.int32)
    top_layer_min = np.zeros((NUM_BIOMES, max_gens, max_layers), np.float32)
    for b, gens in BIOME_FEATURE_GENS.items():
        count[b] = len(gens)
        for g, (f, cs, pad, ch, rep, tls) in enumerate(gens):
            feature[b, g] = int(f)
            cell[b, g] = cs
            padding[b, g] = pad
            chance[b, g] = ch
            can_replace[b, g] = rep
            n_top_layers[b, g] = len(tls)
            for i, (m, mt) in enumerate(tls):
                top_layer_mat[b, g, i] = int(m)
                top_layer_min[b, g, i] = mt
    return {
        "count": count,
        "feature": feature,
        "cell": cell,
        "padding": padding,
        "chance": chance,
        "can_replace": can_replace,
        "n_top_layers": n_top_layers,
        "top_layer_mat": top_layer_mat,
        "top_layer_min": top_layer_min,
        "max_gens": max_gens,
    }


def _flatten_cave_feature_gens():
    max_gens = max(len(v) for v in CAVE_FEATURE_GENS.values())
    count = np.zeros(NUM_CAVE_BIOMES, np.int32)
    feature = np.zeros((NUM_CAVE_BIOMES, max_gens), np.int32)
    cell = np.zeros((NUM_CAVE_BIOMES, max_gens), np.int32)
    padding = np.zeros((NUM_CAVE_BIOMES, max_gens), np.int32)
    chance = np.zeros((NUM_CAVE_BIOMES, max_gens), np.float32)
    min_height = np.zeros((NUM_CAVE_BIOMES, max_gens), np.int32)
    can_replace = np.zeros((NUM_CAVE_BIOMES, max_gens), bool)
    from_ceiling = np.zeros((NUM_CAVE_BIOMES, max_gens), bool)
    in_lava = np.zeros((NUM_CAVE_BIOMES, max_gens), bool)
    for b, gens in CAVE_FEATURE_GENS.items():
        count[b] = len(gens)
        for g, (f, cs, pad, ch, mh, rep, ceil, lava) in enumerate(gens):
            feature[b, g] = int(f)
            cell[b, g] = cs
            padding[b, g] = pad
            chance[b, g] = ch
            min_height[b, g] = mh
            can_replace[b, g] = rep
            from_ceiling[b, g] = ceil
            in_lava[b, g] = lava
    return {
        "count": count,
        "feature": feature,
        "cell": cell,
        "padding": padding,
        "chance": chance,
        "min_height": min_height,
        "can_replace": can_replace,
        "from_ceiling": from_ceiling,
        "in_lava": in_lava,
        "max_gens": max_gens,
    }


FEATURE_GEN_TABLE = _flatten_feature_gens()
CAVE_FEATURE_GEN_TABLE = _flatten_cave_feature_gens()
