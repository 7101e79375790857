"""Device copies of the biome / material tables ("the weights carried across").

The numpy tables of the port's ``world`` modules are the one source: the plain versions
read them directly, and the CUDA kernels receive them either as the tensors made here
or as constant arrays in the generated header (``kernels/_build.py``), so a table edit
reaches both paths.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from .world import biomes as bio
from .world import features_data as fd
from .world.blocks import Block

#: blocks per column
Y_SIZE = 384
#: carved caves cannot exist at or above this y (mega_minecraft_tpu/terrain/caves.py:44-48)
CARVE_Y_MAX = 144
#: the cave biome is CaveBiome.NONE at or above this y (terrain/fill.py:389-394)
CAVE_BIOME_Y_MAX = 192
#: seeds of the cave-biome draws at layer bottoms / tops (caves) and per block (fill)
SEED_BOTTOM_BIOME = 329271348
SEED_TOP_BIOME = 4982921
SEED_FILL_CAVE_BIOME = 190249401
#: columns of a tile of K4 (csrc/fill.cu): consecutive x of one z row of a chunk
FILL_TILE_COLS = 8
#: cells of K4's shared-memory table of Worley jitters for the lush caves' clay test: the cell
#: box of a tile's clay points (terrain/fill.py lush_clay_point) with the +-1 ring.  Over every
#: block below CAVE_BIOME_Y_MAX of a tile, a superset of its lush blocks, the box measures at
#: most 225 cells at the chunks tests/test_torch_fill_table.py measures, out to the int32 edge;
#: a tile whose box is larger takes the kernel's direct path, which hashes every cell it reads.
LUSH_TABLE_CELLS = 512


@dataclasses.dataclass(frozen=True)
class Tables:
    biome_noise_weights: torch.Tensor  # [24, 6] i32: 0 ignore, 1 positive, 2 negative
    biome_material_weights: torch.Tensor  # [24, 20] f32
    material_thickness: torch.Tensor  # [20] f32
    material_amplitude_or_tan_repose: torch.Tensor  # [20] f32
    material_scale_or_max_slope: torch.Tensor  # [20] f32
    material_block: torch.Tensor  # [20] i32 block ids
    grass_blocks: torch.Tensor  # [24] i32 block ids
    cave_biome_noise_weights: torch.Tensor  # [5, 4] i32
    dir_vecs_2d: torch.Tensor  # [8, 2] i32 (dx, dz), odd rows diagonal
    sea_level: int = bio.SEA_LEVEL
    lava_level: int = bio.LAVA_LEVEL
    max_cave_layers: int = bio.MAX_CAVE_LAYERS_PER_COLUMN

    @property
    def device(self) -> torch.device:
        return self.biome_material_weights.device


@functools.lru_cache(maxsize=None)
def load_tables(device) -> Tables:
    """The tables as contiguous tensors on ``device`` (cached: they are constants)."""
    device = torch.device(device)

    def t(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)

    return Tables(
        biome_noise_weights=t(bio.BIOME_NOISE_WEIGHTS, torch.int32),
        biome_material_weights=t(bio.BIOME_MATERIAL_WEIGHTS, torch.float32),
        material_thickness=t(bio.MATERIAL_THICKNESS, torch.float32),
        material_amplitude_or_tan_repose=t(bio.MATERIAL_AMPLITUDE_OR_TAN_REPOSE, torch.float32),
        material_scale_or_max_slope=t(bio.MATERIAL_SCALE_OR_MAX_SLOPE, torch.float32),
        material_block=t(bio.MATERIAL_BLOCK, torch.int32),
        grass_blocks=t(bio.GRASS_BLOCKS, torch.int32),
        cave_biome_noise_weights=t(bio.CAVE_BIOME_NOISE_WEIGHTS, torch.int32),
        dir_vecs_2d=t(bio.DIR_VECS_2D, torch.int32),
    )


def decorator_tables() -> dict:
    """The decorator gen lists of ``world.features_data`` flattened for the kernel:
    per (cave) biome a start and a count into one list of gens, each with its block,
    chance, second block, ceiling flag and padded under / replace block sets."""
    gens, out = [], {}
    for name, table, n in (("SURF", fd.BIOME_DECORATOR_GENS, bio.NUM_BIOMES),
                           ("CAVE", fd.CAVE_DECORATOR_GENS, bio.NUM_CAVE_BIOMES)):
        start = np.zeros(n, np.int32)
        count = np.zeros(n, np.int32)
        for b in range(n):
            start[b], count[b] = len(gens), len(table.get(b, []))
            gens += table.get(b, [])
        out[f"DEC_{name}_START"], out[f"DEC_{name}_COUNT"] = start, count
    max_under = max(len(g[2]) for g in gens)
    max_replace = max(len(g[3]) for g in gens)
    out["DEC_BLOCK"] = np.array([g[0] for g in gens], np.int32)
    out["DEC_CHANCE"] = np.array([g[1] for g in gens], np.float32)
    out["DEC_N_UNDER"] = np.array([len(g[2]) for g in gens], np.int32)
    out["DEC_UNDER"] = np.array([list(g[2]) + [-1] * (max_under - len(g[2])) for g in gens], np.int32)
    out["DEC_N_REPLACE"] = np.array([len(g[3]) for g in gens], np.int32)
    out["DEC_REPLACE"] = np.array(
        [list(g[3]) + [-1] * (max_replace - len(g[3])) for g in gens], np.int32)
    out["DEC_SECOND"] = np.array([g[4] for g in gens], np.int32)
    out["DEC_CEILING"] = np.array([int(g[5]) for g in gens], np.int32)
    assert int(Block.AIR) == 0  # a second block of AIR means "none"
    return out


#: port dtype of every array the JAX stages return (by key)
_STAGE_DTYPES = {
    "heightfield": torch.float32,
    "biome_weights": torch.float32,
    "layers": torch.float32,
    "starts": torch.int32,
    "ends": torch.int32,
    "bottom_biome": torch.int32,
    "top_biome": torch.int32,
    "chunk_pos": torch.int32,
    "pos_halo": torch.int32,
    "blocks": torch.uint8,
    # generate_placements' dense grids
    "surface_feature": torch.int32,
    "surface_y": torch.int32,
    "surface_replace": torch.bool,
    "cave_feature": torch.int32,
    "cave_y": torch.int32,
    "cave_height": torch.int32,
    "cave_replace": torch.bool,
    # compact_placements' lists ({"surface", "cave"} dicts)
    "feature": torch.int32,
    "x": torch.int32,
    "y": torch.int32,
    "z": torch.int32,
    "replace": torch.int32,
    "height": torch.int32,
    "count": torch.int32,
}


def from_jax_outputs(np_dict, device) -> dict:
    """JAX stage outputs (as numpy; nested dicts such as ``caves``, ``placements`` or
    the ``surface`` / ``cave`` lists allowed) -> port tensors.

    Lets a test feed each port stage exactly the JAX stage's inputs.  Unknown keys
    raise, so a renamed stage output cannot be converted with a wrong dtype."""
    out = {}
    for k, v in np_dict.items():
        if isinstance(v, dict):
            out[k] = from_jax_outputs(v, device)
            continue
        if k not in _STAGE_DTYPES:
            raise KeyError(f"no port dtype for stage output {k!r}")
        out[k] = torch.tensor(np.asarray(v), device=torch.device(device)).to(_STAGE_DTYPES[k])
    return out


def scene_from_numpy(flat, origin, dims, device):
    """A render Scene from host data (a JAX ``Scene``'s ``flat`` / ``origin`` / ``dims``)."""
    from .render.brickmap import Scene

    flat = torch.as_tensor(np.array(flat, dtype=np.int32), device=torch.device(device))
    return Scene(flat, [int(v) for v in np.asarray(origin).reshape(-1)], dims)


def _f32_tensors(arrays, device):
    return [torch.as_tensor(np.array(a, np.float32), device=torch.device(device)) for a in arrays]


def camera_from_numpy(cam, device):
    """Port CameraParams from a JAX ``CameraParams`` (or any 5 arrays in its order)."""
    from .render.camera import CameraParams

    return CameraParams(*_f32_tensors(cam, device))


def sky_from_numpy(params, device):
    """Port SkyParams from a JAX ``SkyParams`` (or any 4 arrays in its order)."""
    from .render.sky import SkyParams

    return SkyParams(*_f32_tensors(params, device))


def framebuffers_from_numpy(fbs, device):
    """Port FrameBuffers from a JAX ``FrameBuffers`` (or 3 or 5 arrays in its order; a
    None depth / nsamp stays None)."""
    from .render.tracer import FrameBuffers

    return FrameBuffers(*(None if a is None else _f32_tensors([a], device)[0] for a in fbs))
