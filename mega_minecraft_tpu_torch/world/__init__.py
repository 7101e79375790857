"""The port's own numpy data modules: block ids, biome / material tables, feature and
decorator generation tables.  Copies of ``mega_minecraft_tpu/world/{blocks,biomes,
features_data}.py``; ``tests/test_torch_world.py`` holds every table, enum member and
scalar constant equal to the reference's, so the copies cannot drift."""

from . import biomes, blocks, features_data  # noqa: F401
