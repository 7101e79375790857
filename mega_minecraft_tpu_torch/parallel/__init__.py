"""Multi-device programs over a 1-D device mesh: data-parallel generation, row-banded zone
erosion and row-banded rendering.  Port of ``mega_minecraft_tpu/parallel``."""
