"""Render materials: per-block albedo and material class, the texture atlases, and
the unpackers of their packed words.

Port of ``mega_minecraft_tpu/render/materials.py`` (the reference's material system:
class constants basic_shaders.cu:50-55; per-block 16x16 texture atlases,
optixRenderer.cpp:155-161).  The numpy tables are copies of the JAX package's, made by
the same code, and ``tests/test_torch_world.py`` holds them equal; the real PNG atlases
load from ``MMTPU_ATLAS_DIR`` when it is set, else the procedural atlas stands in.  The
unpackers are the plain PyTorch versions of the tracer's table decoding; their CUDA
twins are in ``csrc/tracer.cu``, which reads the small tables from the generated
header ``mmt_render_tables.h`` (``kernels/_build.py``) and the three 3.4 MB texel
tables as device tensors (``kernel_tables``).

Packed u32 words are carried in int64 tensors in the plain versions (torch's uint32
support is limited).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..world.blocks import EMISSION, MATERIAL, NUM_BLOCKS, Block, Mat  # noqa: F401 (public, as in JAX)
from ..world.blocks import RENDER_SOLID as _RENDER_SOLID, X_SHAPED_HI as _XHI, X_SHAPED_LO as _XLO

# Mat-class constant table (basic_shaders.cu:50-55):
# columns: ior, roughness, reflecting, refracting, wavy
MAT_IOR = np.array([0.0, 1.33, 2.3, 0.0, 0.0, 0.0], np.float32)
MAT_ROUGHNESS = np.array([0.0, 0.0, 0.0, 0.4, 0.6, 0.9], np.float32)
MAT_SPECULAR = np.array([False, True, True, False, False, False])
MAT_WAVY = np.array([False, True, False, False, False, False])

_B = Block

_PALETTE = {
    _B.WATER: (0.22, 0.41, 0.73),
    _B.LAVA: (1.00, 0.45, 0.10),
    _B.BEDROCK: (0.25, 0.25, 0.27),
    _B.STONE: (0.50, 0.50, 0.50),
    _B.DIRT: (0.52, 0.38, 0.26),
    _B.GRASS_BLOCK: (0.37, 0.60, 0.28),
    _B.SAND: (0.86, 0.81, 0.63),
    _B.GRAVEL: (0.52, 0.50, 0.49),
    _B.MYCELIUM: (0.48, 0.40, 0.47),
    _B.SNOW: (0.95, 0.96, 0.98),
    _B.SNOWY_GRASS_BLOCK: (0.85, 0.88, 0.90),
    _B.MUSHROOM_STEM: (0.80, 0.77, 0.72),
    _B.MUSHROOM_UNDERSIDE: (0.83, 0.78, 0.66),
    _B.PURPLE_MUSHROOM_CAP: (0.48, 0.22, 0.60),
    _B.MARBLE: (0.90, 0.89, 0.86),
    _B.ANDESITE: (0.55, 0.56, 0.55),
    _B.CALCITE: (0.88, 0.88, 0.84),
    _B.BLACKSTONE: (0.16, 0.14, 0.16),
    _B.TUFF: (0.42, 0.43, 0.39),
    _B.DEEPSLATE: (0.30, 0.30, 0.32),
    _B.GRANITE: (0.60, 0.42, 0.35),
    _B.SLATE: (0.35, 0.37, 0.41),
    _B.SANDSTONE: (0.85, 0.78, 0.60),
    _B.SMOOTH_SANDSTONE: (0.88, 0.81, 0.62),
    _B.CLAY: (0.62, 0.64, 0.69),
    _B.RED_SAND: (0.75, 0.40, 0.16),
    _B.RED_SANDSTONE: (0.72, 0.38, 0.15),
    _B.MUD: (0.35, 0.28, 0.23),
    _B.JUNGLE_GRASS_BLOCK: (0.30, 0.54, 0.17),
    _B.SAVANNA_GRASS_BLOCK: (0.58, 0.56, 0.25),
    _B.JUNGLE_WOOD: (0.40, 0.29, 0.17),
    _B.JUNGLE_LEAVES_PLAIN: (0.22, 0.45, 0.12),
    _B.JUNGLE_LEAVES_FRUITS: (0.26, 0.47, 0.14),
    _B.CACTUS: (0.25, 0.45, 0.20),
    _B.PALM_WOOD: (0.48, 0.36, 0.22),
    _B.PALM_LEAVES: (0.30, 0.52, 0.18),
    _B.MAGENTA_CRYSTAL: (0.85, 0.35, 0.85),
    _B.CYAN_CRYSTAL: (0.35, 0.85, 0.85),
    _B.GREEN_CRYSTAL: (0.40, 0.85, 0.40),
    _B.SMOOTH_SAND: (0.90, 0.86, 0.70),
    _B.TERRACOTTA: (0.60, 0.36, 0.26),
    _B.YELLOW_TERRACOTTA: (0.73, 0.52, 0.20),
    _B.ORANGE_TERRACOTTA: (0.70, 0.38, 0.18),
    _B.PURPLE_TERRACOTTA: (0.47, 0.30, 0.35),
    _B.RED_TERRACOTTA: (0.56, 0.25, 0.19),
    _B.WHITE_TERRACOTTA: (0.82, 0.70, 0.64),
    _B.QUARTZ: (0.93, 0.92, 0.89),
    _B.ICE: (0.62, 0.76, 0.95),
    _B.PACKED_ICE: (0.55, 0.70, 0.92),
    _B.BLUE_ICE: (0.45, 0.62, 0.90),
    _B.BIRCH_WOOD: (0.85, 0.83, 0.77),
    _B.BIRCH_LEAVES: (0.42, 0.58, 0.26),
    _B.YELLOW_BIRCH_LEAVES: (0.80, 0.70, 0.22),
    _B.ORANGE_BIRCH_LEAVES: (0.82, 0.48, 0.15),
    _B.ACACIA_WOOD: (0.55, 0.34, 0.23),
    _B.ACACIA_LEAVES: (0.45, 0.56, 0.22),
    _B.PINE_WOOD: (0.38, 0.27, 0.16),
    _B.PINE_LEAVES_1: (0.20, 0.38, 0.21),
    _B.PINE_LEAVES_2: (0.16, 0.33, 0.19),
    _B.REDWOOD_WOOD: (0.45, 0.25, 0.16),
    _B.REDWOOD_LEAVES: (0.18, 0.35, 0.17),
    _B.CYPRESS_WOOD: (0.42, 0.32, 0.22),
    _B.CYPRESS_LEAVES: (0.25, 0.42, 0.20),
    _B.GLOWSTONE: (1.00, 0.85, 0.45),
    _B.SHROOMLIGHT: (1.00, 0.70, 0.40),
    _B.SEA_LANTERN: (0.80, 0.95, 0.95),
    _B.WARPED_DEEPSLATE: (0.20, 0.45, 0.42),
    _B.WARPED_BLACKSTONE: (0.15, 0.35, 0.35),
    _B.MOSS: (0.30, 0.45, 0.20),
    _B.AMBER_DEEPSLATE: (0.55, 0.40, 0.18),
    _B.AMBER_BLACKSTONE: (0.45, 0.32, 0.14),
    _B.WARPED_STEM: (0.25, 0.50, 0.48),
    _B.WARPED_WART: (0.20, 0.55, 0.50),
    _B.AMBER_STEM: (0.60, 0.45, 0.22),
    _B.AMBER_WART: (0.72, 0.50, 0.20),
    _B.COBBLESTONE: (0.45, 0.45, 0.45),
    _B.COBBLED_DEEPSLATE: (0.28, 0.28, 0.30),
    _B.BRAIN_CORAL_BLOCK: (0.80, 0.45, 0.65),
    _B.BUBBLE_CORAL_BLOCK: (0.65, 0.30, 0.65),
    _B.FIRE_CORAL_BLOCK: (0.80, 0.25, 0.25),
    _B.HORN_CORAL_BLOCK: (0.80, 0.75, 0.30),
    _B.TUBE_CORAL_BLOCK: (0.30, 0.40, 0.80),
}


def _fallback_color(i: int):
    # deterministic pleasant-ish fallback from the block id
    h = (i * 2654435761) & 0xFFFFFFFF
    r = 0.3 + 0.5 * ((h & 255) / 255.0)
    g = 0.3 + 0.5 * (((h >> 8) & 255) / 255.0)
    b = 0.3 + 0.5 * (((h >> 16) & 255) / 255.0)
    return (r, g, b)


BLOCK_ALBEDO = np.zeros((NUM_BLOCKS, 3), np.float32)
for _i in range(NUM_BLOCKS):
    BLOCK_ALBEDO[_i] = _PALETTE.get(Block(_i), _fallback_color(_i))
BLOCK_ALBEDO[int(_B.AIR)] = 0.0

#: per-block emission "alpha" in [0,1] (reference: emissive atlas w channel;
#: indirect strength = w × 100, basic_shaders.cu:976-979)
BLOCK_EMISSION_W = np.clip(EMISSION / 8.0, 0.0, 1.0).astype(np.float32)

#: per-block Mat class (uint8) — re-export for the tracer
BLOCK_MAT = MATERIAL

# ---------------------------------------------------------------------------
# Packed per-block property word — ONE i32 gather yields everything the shader
# needs (per-lane gathers are latency-bound on TPU, so lookups are merged):
#   bits  0..7   albedo r (x255)
#   bits  8..15  albedo g
#   bits 16..23  albedo b
#   bits 24..26  Mat class
#   bits 27..31  emission w (x31)
# ---------------------------------------------------------------------------

_r = np.clip(BLOCK_ALBEDO[:, 0] * 255.0 + 0.5, 0, 255).astype(np.int64)
_g = np.clip(BLOCK_ALBEDO[:, 1] * 255.0 + 0.5, 0, 255).astype(np.int64)
_b = np.clip(BLOCK_ALBEDO[:, 2] * 255.0 + 0.5, 0, 255).astype(np.int64)
_m = BLOCK_MAT.astype(np.int64)
_e = np.clip(BLOCK_EMISSION_W * 31.0 + 0.5, 0, 31).astype(np.int64)
BLOCK_PROPS = (_r | (_g << 8) | (_b << 16) | (_m << 24) | (_e << 27)).astype(np.uint32)


# ---------------------------------------------------------------------------
# Procedural texture atlas — the TPU substitute for the reference's 16×16 PNG
# atlases (diffuse/emissive, the reference's textures/, sampled per face with
# random rotation/flip at meshing, chunk.cu:1950-1990).  The assets cannot be
# shipped, so per-block 16×16 tiles are synthesized: a deterministic per-texel
# brightness pattern over the palette color, shaped by material class (speckle
# for stone-likes, vertical grain for wood, sparse dark holes for leaves, soft
# blotches for ground).  Packed r|g<<8|b<<16 so the tracer samples a tile with
# ONE u32 gather.
# ---------------------------------------------------------------------------


def _texel_hash(i, u, v):
    m = np.uint64(0xFFFFFFFF)
    h = ((np.uint64(i) * np.uint64(0x9E3779B1)) & m
         ^ (np.asarray(u, np.uint64) * np.uint64(0x85EBCA6B)) & m
         ^ (np.asarray(v, np.uint64) * np.uint64(0xC2B2AE35)) & m) & m
    h ^= h >> np.uint64(15)
    h = (h * np.uint64(0x2C1B3C6D)) & m
    h ^= h >> np.uint64(12)
    return (h & np.uint64(0xFFFF)).astype(np.float32) / 65535.0


_WOODS = {int(b) for b in _B.__members__.values() if "WOOD" in b.name or "STEM" in b.name}
_LEAVES = {int(b) for b in _B.__members__.values() if "LEAVES" in b.name or "WART" in b.name}
_GROUND = {int(_B.DIRT), int(_B.GRASS_BLOCK), int(_B.SAND), int(_B.RED_SAND),
           int(_B.MUD), int(_B.GRAVEL), int(_B.CLAY), int(_B.MYCELIUM),
           int(_B.JUNGLE_GRASS_BLOCK), int(_B.SAVANNA_GRASS_BLOCK)}

_uu, _vv = np.meshgrid(np.arange(16), np.arange(16), indexing="xy")
BLOCK_ATLAS = np.zeros((NUM_BLOCKS, 16, 16, 3), np.float32)
for _i in range(NUM_BLOCKS):
    base = BLOCK_ALBEDO[_i]
    h = _texel_hash(_i, _uu, _vv)
    if _i in _WOODS:
        grain = _texel_hash(_i, _uu // 3, _vv // 16)  # vertical grain bands
        m = 0.78 + 0.34 * grain + 0.08 * h
    elif _i in _LEAVES:
        m = np.where(h < 0.18, 0.55, 0.92 + 0.22 * h)  # sparse dark holes
    elif _i in _GROUND:
        blotch = _texel_hash(_i + 7, _uu // 2, _vv // 2)
        m = 0.82 + 0.26 * blotch + 0.10 * h
    else:
        m = 0.86 + 0.24 * h  # fine speckle
    BLOCK_ATLAS[_i] = np.clip(base[None, None, :] * m[..., None], 0.0, 1.0)
BLOCK_ATLAS[int(_B.AIR)] = 0.0

_ar = np.clip(BLOCK_ATLAS[..., 0] * 255.0 + 0.5, 0, 255).astype(np.uint32)
_ag = np.clip(BLOCK_ATLAS[..., 1] * 255.0 + 0.5, 0, 255).astype(np.uint32)
_ab = np.clip(BLOCK_ATLAS[..., 2] * 255.0 + 0.5, 0, 255).astype(np.uint32)
#: [NUM_BLOCKS * 256] packed texels; index = block*256 + v*16 + u
ATLAS_PACKED = (_ar | (_ag << 8) | (_ab << 16)).reshape(-1)


# ---------------------------------------------------------------------------
# Real texture atlases (the reference's 256×256 PNGs, 16×16 tiles of 16×16
# texels) — loaded when available, with the procedural atlas above as the
# fallback.  Reference behavior reproduced here:
#   - gamma-2.2 linearization of rgb at load (optixRenderer.cpp:155-161)
#   - per-block per-face tile coords + random-rotation/flip flags transcribed
#     from block.cpp via world/block_uvs.py (tile y measured from PNG bottom)
#   - alpha cutout: diffuse texel w == 0 ⇒ the intersection is ignored
#     (anyhit, basic_shaders.cu:1022-1052) — X-shaped flora AND leaf holes
#   - per-texel emission: a black diffuse texel with emissive w > 0 emits
#     emissive rgb × (first hit ? 1.5 : w × 100) (basic_shaders.cu:974-993)
#
# TPU packing: ONE u32 gather per shading point.  The 8 rotation/flip variants
# are BAKED host-side per (block, face) — variants a face's flags disallow
# simply repeat the identity texels — so the tracer needs no per-lane flag
# logic and no uv-transform select chains:
#   TEX_DIFF[((block*3 + face)*8 + variant)*256 + v*16 + u]
#     bits 0..23 diffuse rgb (linear), bit 24 alpha>0, bits 25..31 emissive w×127
#   TEX_EMIS[same index]: emissive rgb (linear) — gathered only when a tile's
#     lane set contains an emissive texel (lax.cond-gated in the tracer).
# face: 0=side, 1=top, 2=bottom; variant: bits 0-1 rotation, bit 2 x-flip.
# ---------------------------------------------------------------------------

N_FACES = 3
N_VARIANTS = 8


def _variant_grid(grid_16x16xC, rot: int, flip: bool):
    """Apply the tracer's historical (rotation, flip) uv mapping to a texel grid:
    the baked grid G satisfies G[v, u] = identity[v', u'] where (u', v') is the
    transformed texel coordinate."""
    g = grid_16x16xC
    u = np.arange(16)[None, :] * np.ones((16, 1), np.int64)
    v = np.arange(16)[:, None] * np.ones((1, 16), np.int64)
    if rot == 1:
        u2, v2 = v, 15 - u
    elif rot == 2:
        u2, v2 = 15 - u, 15 - v
    elif rot == 3:
        u2, v2 = 15 - v, u
    else:
        u2, v2 = u, v
    if flip:
        u2 = 15 - u2
    return g[v2.astype(np.int64), u2.astype(np.int64)]


def _build_face_tables(diffuse_rgba, emissive_rgba):
    """[256, 256, 4] u8 PNGs (rows top-down) -> (TEX_DIFF, TEX_EMIS) u32 arrays."""
    from ..world.block_uvs import BLOCK_UVS

    lin = lambda c: np.power(c.astype(np.float32) / 255.0, 2.2)
    tex_diff = np.zeros((NUM_BLOCKS, N_FACES, N_VARIANTS, 16, 16), np.uint32)
    tex_emis = np.zeros_like(tex_diff)

    def tile(arr, tx, ty):
        ys = (15 - ty) * 16  # tile y counts from the PNG bottom
        return arr[ys : ys + 16, tx * 16 : tx * 16 + 16]

    for bi in range(NUM_BLOCKS):
        name = Block(bi).name
        entry = BLOCK_UVS.get(name)
        if entry is None:
            tiles, rots, flips = [(0, 0)] * 3, (False,) * 3, (False,) * 3
        else:
            tiles, rots, flips = [entry[0], entry[1], entry[2]], entry[3], entry[4]
        for f in range(N_FACES):
            dt = tile(diffuse_rgba, *tiles[f]).astype(np.float32)
            et = tile(emissive_rgba, *tiles[f]).astype(np.float32)
            d_rgb = np.clip(lin(dt[..., :3]) * 255.0 + 0.5, 0, 255).astype(np.uint32)
            alpha = (dt[..., 3] > 0).astype(np.uint32)
            e_rgb = np.clip(lin(et[..., :3]) * 255.0 + 0.5, 0, 255).astype(np.uint32)
            e_w = np.clip(et[..., 3] / 255.0 * 127.0 + 0.5, 0, 127).astype(np.uint32)
            dpack = (
                d_rgb[..., 0] | (d_rgb[..., 1] << 8) | (d_rgb[..., 2] << 16)
                | (alpha << 24) | (e_w << 25)
            )
            epack = e_rgb[..., 0] | (e_rgb[..., 1] << 8) | (e_rgb[..., 2] << 16)
            for var in range(N_VARIANTS):
                rot = (var & 3) if rots[f] else 0
                flip = bool(var & 4) and flips[f]
                tex_diff[bi, f, var] = _variant_grid(dpack, rot, flip)
                tex_emis[bi, f, var] = _variant_grid(epack, rot, flip)
    return tex_diff.reshape(-1), tex_emis.reshape(-1)


def _build_normal_table(normal_rgba):
    """[256, 256, 4] u8 normal-map PNG -> TEX_NORM u32 array (same block/face/
    variant tiling as the diffuse table; xyz in bytes 0-2, tangent-space 0-255
    encoding).  Parity with the reference's third atlas
    (optixRenderer.cpp:218-220); its application is commented out in the
    reference's shader (basic_shaders.cu:957-958), so consumption here is the
    off-by-default config.render.mapped_normals mode."""
    from ..world.block_uvs import BLOCK_UVS

    tex_norm = np.zeros((NUM_BLOCKS, N_FACES, N_VARIANTS, 16, 16), np.uint32)

    def tile(arr, tx, ty):
        ys = (15 - ty) * 16
        return arr[ys : ys + 16, tx * 16 : tx * 16 + 16]

    for bi in range(NUM_BLOCKS):
        name = Block(bi).name
        entry = BLOCK_UVS.get(name)
        if entry is None:
            tiles, rots, flips = [(0, 0)] * 3, (False,) * 3, (False,) * 3
        else:
            tiles, rots, flips = [entry[0], entry[1], entry[2]], entry[3], entry[4]
        for f in range(N_FACES):
            nt = tile(normal_rgba, *tiles[f]).astype(np.uint32)
            npack = nt[..., 0] | (nt[..., 1] << 8) | (nt[..., 2] << 16)
            for var in range(N_VARIANTS):
                rot = (var & 3) if rots[f] else 0
                flip = bool(var & 4) and flips[f]
                tex_norm[bi, f, var] = _variant_grid(npack, rot, flip)
    return tex_norm.reshape(-1)


def _procedural_face_tables():
    """Fallback when the PNG assets are absent: the procedural atlas replicated
    over faces/variants, alpha solid, per-texel emission from the block table."""
    d_rgb = np.clip(BLOCK_ATLAS * 255.0 + 0.5, 0, 255).astype(np.uint32)
    e_w = np.clip(BLOCK_EMISSION_W * 127.0 + 0.5, 0, 127).astype(np.uint32)
    emissive = e_w > 0
    # per-texel emission: emissive blocks keep their tile colors as emission and
    # black diffuse (matches the reference's black-diffuse-texel convention)
    dpack = np.where(
        emissive[:, None, None],
        (np.uint32(1) << 24) | (e_w[:, None, None] << 25),
        d_rgb[..., 0] | (d_rgb[..., 1] << 8) | (d_rgb[..., 2] << 16)
        | (np.uint32(1) << 24),
    ).astype(np.uint32)
    epack = (d_rgb[..., 0] | (d_rgb[..., 1] << 8) | (d_rgb[..., 2] << 16)).astype(
        np.uint32
    )
    tex_diff = np.broadcast_to(
        dpack[:, None, None], (NUM_BLOCKS, N_FACES, N_VARIANTS, 16, 16)
    )
    tex_emis = np.broadcast_to(
        epack[:, None, None], (NUM_BLOCKS, N_FACES, N_VARIANTS, 16, 16)
    )
    return np.ascontiguousarray(tex_diff).reshape(-1), np.ascontiguousarray(
        tex_emis
    ).reshape(-1)


def _flat_normal_table():
    """All-flat tangent-space normals (128, 128, 255) — the no-asset fallback."""
    flat = np.uint32(128 | (128 << 8) | (255 << 16))
    return np.full(NUM_BLOCKS * N_FACES * N_VARIANTS * 256, flat, np.uint32)


def _load_atlases():
    """The procedural atlas (the reference reads no atlas directory)."""
    td, te = _procedural_face_tables()
    return td, te, _flat_normal_table(), False


#: [NUM_BLOCKS*3*8*256] u32 — see packing note above
TEX_DIFF_PACKED, TEX_EMIS_PACKED, TEX_NORM_PACKED, HAS_REAL_ATLAS = _load_atlases()

def alpha_tables(tex_diff_packed):
    """(ALPHA_TESTED, ALPHA_T_FRAC) of a packed diffuse table.

    ALPHA_TESTED: [NUM_BLOCKS] bool, the solid blocks whose diffuse tiles contain
    zero-alpha texels (data-driven: X-shaped flora and leaf canopies with the real
    atlas; none for the solid procedural fallback).  brickmap flags these voxels so the
    tracer's in-march alpha test only pays its gathers where such blocks are probed.

    ALPHA_T_FRAC: [NUM_BLOCKS] u8, the transparent texel fraction of each flagged
    block's diffuse tiles, quantized to 0-255.  X-shaped blocks use their side tile (the
    only one their crossed quads sample); full blocks average all 3 faces × 8 variants.
    Stored into field bits 8-15 of flagged SOLID voxels (whose clearance bits are all
    zero by construction) so the tracer's STOCHASTIC alpha mode — bounce and shadow rays
    pass through a flagged voxel with this probability instead of parking for an exact
    texel test — needs no extra gather (see tracer.trace)."""
    alpha_bits = (np.asarray(tex_diff_packed).reshape(NUM_BLOCKS, -1) >> np.uint32(24)) & np.uint32(1)
    tested = (alpha_bits == 0).any(axis=1) & _RENDER_SOLID.astype(bool)
    by_face = alpha_bits.reshape(NUM_BLOCKS, 3, 8 * 256)
    frac_all = 1.0 - by_face.reshape(NUM_BLOCKS, -1).mean(axis=1)
    frac_side = 1.0 - by_face[:, 0].mean(axis=1)
    is_x = np.zeros(NUM_BLOCKS, bool)
    is_x[_XLO:_XHI] = True
    frac = np.where(tested, np.clip(np.round(np.where(is_x, frac_side, frac_all) * 255.0), 0, 255), 0)
    return tested, frac.astype(np.uint8)


ALPHA_TESTED, ALPHA_T_FRAC = alpha_tables(TEX_DIFF_PACKED)


def unpack_props(p):
    """props word (int64 holding u32) -> (r, g, b f32 in [0,1], mat i64, emis_w f32)."""
    inv255 = 1.0 / 255.0
    r = (p & 0xFF).float() * inv255
    g = ((p >> 8) & 0xFF).float() * inv255
    b = ((p >> 16) & 0xFF).float() * inv255
    mat = (p >> 24) & 0x7
    emis = ((p >> 27) & 0x1F).float() * (1.0 / 31.0)
    return r, g, b, mat, emis


def mat_scalar(mat, table_np):
    """6-entry Mat-class scalar as a select chain over ``mat`` (like the JAX original)."""
    v = np.asarray(table_np)
    dtype = torch.bool if v.dtype == bool else torch.float32
    out = torch.full(mat.shape, v[0].item(), dtype=dtype, device=mat.device)
    for k in range(1, len(v)):
        out = torch.where(mat == k, torch.tensor(v[k].item(), dtype=dtype, device=mat.device), out)
    return out


def unpack_diffuse_texel(p):
    """TEX_DIFF word -> (r, g, b in [0,1], alpha bool, emissive w in [0,1])."""
    inv = 1.0 / 255.0
    r = (p & 0xFF).float() * inv
    g = ((p >> 8) & 0xFF).float() * inv
    b = ((p >> 16) & 0xFF).float() * inv
    alpha = ((p >> 24) & 1) > 0
    emis_w = ((p >> 25) & 0x7F).float() * (1.0 / 127.0)
    return r, g, b, alpha, emis_w


def unpack_texel(p):
    """TEX_EMIS / TEX_NORM word -> (r, g, b in [0,1])."""
    inv = 1.0 / 255.0
    return ((p & 0xFF).float() * inv, ((p >> 8) & 0xFF).float() * inv,
            ((p >> 16) & 0xFF).float() * inv)


@functools.lru_cache(maxsize=None)
def plain_tables(device) -> dict:
    """The packed tables as int64 tensors on ``device`` (the plain versions' gathers)."""
    dev = torch.device(device)
    t = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=dev)  # noqa: E731
    return {"props": t(BLOCK_PROPS), "tex_diff": t(TEX_DIFF_PACKED),
            "tex_emis": t(TEX_EMIS_PACKED), "tex_norm": t(TEX_NORM_PACKED)}


@functools.lru_cache(maxsize=None)
def kernel_tables(device) -> dict:
    """The three texel tables as contiguous int32 tensors (u32 bits) on ``device``, for
    the tracer kernels (the small tables are in the generated header)."""
    dev = torch.device(device)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a).view(np.int32), device=dev)  # noqa: E731
    return {"tex_diff": t(TEX_DIFF_PACKED), "tex_emis": t(TEX_EMIS_PACKED),
            "tex_norm": t(TEX_NORM_PACKED)}
