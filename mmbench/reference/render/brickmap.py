"""Scene representation: the packed distance-field / block-id volume the tracer marches.

Port of ``mega_minecraft_tpu/render/brickmap.py:18-321`` (the reference's GAS/IAS
acceleration structures become one i32 volume, optixRenderer.cpp:223-426).  Each voxel
word holds the block id of a solid voxel, or for an empty one its capped 3-D L∞
distance to the nearest solid plus the directional clearances that let a ray skip
verified-empty space (bit layout below, unchanged).  A macro field at 1/4³ resolution
with the same encoding follows the fine field in ONE flat i32 buffer.

``build_scene`` makes the fields with K10 (``csrc/brickmap.cu``) for a CUDA input and
with the plain versions below (the JAX package's doubling rounds, in PyTorch) for a CPU
input.  ``update_chunks`` (brickmap.py:325,377 with the engine's ``_assemble_region``
folded in) writes a region of slot-table chunks into a scene and re-sweeps a window
around it, seeded from the old words: K10u (``mmt_update_chunks`` in the same source) on
the card, ``update_chunks_plain`` on the CPU.

Encoding (i32): bits 0-7 block id if solid, else EMPTY_BASE−1+distance; bits 8-13
up-clearance (horizontal L∞ distance to the nearest solid at or above y); bits 14-19
and 20-25 the slab-2 and slab-8 clearances (nearest solid with y′ ∈ [y−k, y]); bits
26-30 the skyline descent q = (y − highest solid top within L∞ radius 8) // 4; bit 31
and bits 8-15 of an alpha-flagged solid: the flag and its transparent-texel fraction.
"""

from __future__ import annotations

import numpy as np
import torch

from ..world.blocks import NUM_BLOCKS, RENDER_SOLID
from .materials import ALPHA_T_FRAC, ALPHA_TESTED

Y_SIZE = 384
DIST_CAP = 63
EMPTY_BASE = NUM_BLOCKS  # 140
SKY_R = 8  # skyline horizontal radius (blocks)
MACRO_SCALE = 4

I32 = torch.int32
I64 = torch.int64
#: the most chunks one ``update_chunks`` region holds on the card (K10u takes the slots by
#: value; the engine's buckets are 3x3)
MAX_REGION_CHUNKS = 16


class Scene:
    """Scene volume: ONE flat i32 buffer holding the fine field ([Z, X, Y], y fastest)
    followed by the macro field ([Z/4, X/4, Y/4]), the world origin (x, y, z) of voxel
    (z=0, x=0, y=0) as host integers, and the dims (zdim, xdim, ydim)."""

    def __init__(self, flat: torch.Tensor, origin, dims):
        self.flat = flat
        self.origin = tuple(int(v) for v in origin)
        self.dims = tuple(int(d) for d in dims)

    @property
    def device(self) -> torch.device:
        return self.flat.device

    @property
    def field(self) -> torch.Tensor:
        z, x, y = self.dims
        return self.flat[: z * x * y].view(z, x, y)

    @property
    def macro(self) -> torch.Tensor:
        z, x, y = self.dims
        S = MACRO_SCALE
        return self.flat[z * x * y:].view(z // S, x // S, y // S)


# ---------------------------------------------------------------------------
# plain versions (brickmap.py:130-277), whole-volume tensor code
# ---------------------------------------------------------------------------


def _shifted(d, s: int, axis: int, fill):
    pad = [0, 0] * d.dim()
    pad[2 * (d.dim() - 1 - axis)] = s
    pad[2 * (d.dim() - 1 - axis) + 1] = s
    p = torch.nn.functional.pad(d, pad, value=fill)
    n = d.shape[axis]
    return p.narrow(axis, 0, n), p.narrow(axis, 2 * s, n)


def _shift_min(d, s: int, axis: int, fill):
    lo, hi = _shifted(d, s, axis, fill)
    return torch.minimum(d, torch.minimum(lo, hi))


def _shift_max(d, s: int, axis: int, fill):
    lo, hi = _shifted(d, s, axis, fill)
    return torch.maximum(d, torch.maximum(lo, hi))


def chebyshev_distance(solid, cap: int = DIST_CAP, axes=(0, 1, 2), init=None):
    """Bounded L∞ distance-to-solid via doubling rounds ([Z, X, Y] bool -> i32);
    ``axes`` restricts the metric ((0, 1) = horizontal only); ``init`` seeds the
    non-solid voxels with a known upper bound (window updates: solids just outside the
    window stay accounted for)."""
    far = torch.full((), cap, dtype=I32, device=solid.device)
    if init is not None:
        far = torch.clamp(init.to(I32), max=cap)
    d = torch.where(solid, torch.zeros((), dtype=I32, device=solid.device), far)
    s = 1
    while s < cap:
        e = d
        for axis in axes:
            e = _shift_min(e, s, axis, cap)
        d = torch.minimum(d, e + s)
        s *= 2
    return torch.clamp(d, max=cap)


def _up_clearance(solid, cap: int = DIST_CAP, init=None):
    """Horizontal L∞ distance to the nearest solid at or above this y."""
    half = torch.flip(torch.cumsum(torch.flip(solid, (2,)).to(I32), dim=2), (2,)) > 0
    return chebyshev_distance(half, cap, axes=(0, 1), init=init)


def _slab_clearance(solid, k: int, cap: int = DIST_CAP, init=None):
    """Horizontal L∞ distance to the nearest solid with y′ ∈ [y−k, y]."""
    cs = torch.cumsum(solid.to(I32), dim=2)
    lag = torch.cat([torch.zeros(cs.shape[:2] + (k + 1,), dtype=cs.dtype, device=cs.device),
                     cs[:, :, : -(k + 1)]], dim=2)
    return chebyshev_distance((cs - lag) > 0, cap, axes=(0, 1), init=init)


def _dilate_max_2d(d, r: int, fill):
    """Grayscale dilation of a [Z, X] map by the L∞ ball of radius ``r``."""
    s, reach = 1, 0
    while reach < r:
        step = min(s, r - reach)
        for axis in (0, 1):
            d = _shift_max(d, step, axis, fill)
        reach += step
        s *= 2
    return d


def _skyline_descent(solid, r: int = SKY_R, init=None):
    """(y − max solid top within horizontal L∞ radius r) // 4, clipped to [0, 31]
    (and to ``init`` where given)."""
    ydim = solid.shape[2]
    yidx = torch.arange(ydim, dtype=I32, device=solid.device)
    top = torch.where(solid, yidx[None, None, :], torch.full((), -1, dtype=I32,
                                                              device=solid.device)).amax(dim=2)
    sky = _dilate_max_2d(top, r, -1)
    q = torch.div(torch.clamp(yidx[None, None, :] - sky[:, :, None], 0, 124), 4,
                  rounding_mode="floor")
    return q if init is None else torch.minimum(q, init.to(I32))


def _to_i32(word64):
    """An int64 holding u32 bits -> the same bits as int32."""
    return torch.where(word64 >= 2 ** 31, word64 - 2 ** 32, word64).to(I32)


def _clearance_bits(solid, cap: int = DIST_CAP, init_up=None, init_c2=None, init_c8=None,
                    init_q=None):
    up = torch.clamp(_up_clearance(solid, cap, init_up), 0, 63)
    c2 = torch.clamp(_slab_clearance(solid, 2, cap, init_c2), 0, 63)
    c8 = torch.clamp(_slab_clearance(solid, 8, cap, init_c8), 0, 63)
    q = _skyline_descent(solid, init=init_q)
    return (up.to(I64) << 8) | (c2.to(I64) << 14) | (c8.to(I64) << 20) | (q.to(I64) << 26)


def _encode(vol_i32, solid, cap: int = DIST_CAP, init_dist=None, init_up=None, init_c2=None,
            init_c8=None, init_q=None):
    """Packed fine words of a [Z, X, Y] volume of block ids and its solid mask (the
    ``init_*`` seeds as in ``chebyshev_distance``).  Non-solid voxels may hold any value
    up to 255 (a window's old empty codes): the alpha tables are read at solids only."""
    assert cap <= 63, "clearance fields are 6-bit"
    dist = chebyshev_distance(solid, cap, init=init_dist)
    low = torch.where(solid, vol_i32, (EMPTY_BASE - 1) + torch.clamp(dist, 1, 255 - EMPTY_BASE + 1))
    word = low.to(I64) | _clearance_bits(solid, cap, init_up, init_c2, init_c8, init_q)
    idx = torch.where(solid, vol_i32, torch.zeros_like(vol_i32)).long()
    flag = solid & torch.as_tensor(ALPHA_TESTED, device=solid.device)[idx]
    t_frac = torch.as_tensor(ALPHA_T_FRAC.astype(np.int64), device=solid.device)[idx]
    word = word | (flag.to(I64) << 31) | torch.where(flag, t_frac << 8, torch.zeros_like(t_frac))
    return _to_i32(word)


def _encode_macro(field):
    """Macro words from the encoded fine field: [Z, X, Y] -> [Z/4, X/4, Y/4] i32."""
    S = MACRO_SCALE
    zdim, xdim, ydim = field.shape
    assert zdim % S == 0 and xdim % S == 0 and ydim % S == 0
    low = field & 0xFF
    solid = (low > 0) & (low < EMPTY_BASE)
    msolid = solid.view(zdim // S, S, xdim // S, S, ydim // S, S).any(dim=5).any(dim=3).any(dim=1)
    dist = chebyshev_distance(msolid, DIST_CAP)
    mlow = torch.where(msolid, torch.zeros((), dtype=I32, device=field.device),
                       (EMPTY_BASE - 1) + torch.clamp(dist, 1, 63))
    return _to_i32(mlow.to(I64) | _clearance_bits(msolid))


def blocks_to_field(vol_u8):
    """Plain version: [Z, X, Y] u8 block ids -> packed i32 field."""
    vol = vol_u8.to(I32)
    solid = torch.as_tensor(RENDER_SOLID, device=vol.device)[vol.long()]
    return _encode(vol, solid)


def build_fields_plain(vol_u8) -> torch.Tensor:
    """Plain version of K10: [Z, X, Y] u8 -> flat i32 fine ++ macro."""
    field = blocks_to_field(vol_u8)
    return torch.cat([field.reshape(-1), _encode_macro(field).reshape(-1)])


def empty_field_word() -> int:
    """Packed word of a voxel of an all-air volume (every clearance at its cap)."""
    return int((EMPTY_BASE - 1 + DIST_CAP) | (DIST_CAP << 8) | (DIST_CAP << 14)
               | (DIST_CAP << 20) | (31 << 26))


def empty_scene(side_blocks: int, origin_chunk_x: int, origin_chunk_z: int,
                device="cuda") -> Scene:
    """An all-air streaming-window Scene (the empty word is the same at both levels)."""
    S = MACRO_SCALE
    n_fine = side_blocks * side_blocks * Y_SIZE
    flat = torch.full((n_fine + n_fine // (S * S * S),), empty_field_word(), dtype=I32,
                      device=torch.device(device))
    return Scene(flat, (origin_chunk_x * 16, 0, origin_chunk_z * 16),
                 (side_blocks, side_blocks, Y_SIZE))


def scene_volume(chunk_blocks) -> torch.Tensor:
    """[CZ, CX, 16, 16, 384] u8 ([cz, cx, z, x, y]) -> the [CZ*16, CX*16, 384] volume."""
    cz, cx = chunk_blocks.shape[0], chunk_blocks.shape[1]
    return chunk_blocks.permute(0, 2, 1, 3, 4).reshape(cz * 16, cx * 16, Y_SIZE).contiguous()


def build_scene(chunk_blocks, origin_chunk_x: int, origin_chunk_z: int, device="cuda") -> Scene:
    """Assemble a Scene from a dense chunk grid.

    chunk_blocks: [CZ, CX, 16, 16, 384] u8 ([cz, cx, z, x, y]), a tensor (its own
    device is used) or a numpy array (moved to ``device``).  A CUDA volume goes through
    K10, a CPU one through the plain version."""
    if not isinstance(chunk_blocks, torch.Tensor):
        chunk_blocks = torch.as_tensor(np.asarray(chunk_blocks), device=torch.device(device))
    vol = scene_volume(chunk_blocks)
    flat = build_fields_plain(vol)
    return Scene(flat, (origin_chunk_x * 16, 0, origin_chunk_z * 16), vol.shape)


# ---------------------------------------------------------------------------
# streamed scene updates (brickmap.py:325-391, engine.py:31-37)
# ---------------------------------------------------------------------------


def update_window(dims, gz: int, gx: int, z0: int, x0: int):
    """(zlo, xlo, wz, wx): the re-sweep window of a gz x gx-chunk region at volume offset
    (z0, x0): the region padded by DIST_CAP on each side, cut to the volume, its start
    clamped as ``dynamic_slice`` clamps it."""
    zdim, xdim, _ = dims
    wz = min(gz * 16 + 2 * DIST_CAP, zdim)
    wx = min(gx * 16 + 2 * DIST_CAP, xdim)
    zlo = min(max(z0 - DIST_CAP, 0), zdim - wz)
    xlo = min(max(x0 - DIST_CAP, 0), xdim - wx)
    return zlo, xlo, wz, wx


def _check_region(scene: Scene, slots, mask, gz: int, gx: int, z0: int, x0: int):
    slots = np.asarray(slots, np.int64).reshape(-1)
    mask = np.asarray(mask, bool).reshape(-1)
    if slots.shape != (gz * gx,) or mask.shape != (gz * gx,):
        raise ValueError(f"slots / mask: {slots.shape} / {mask.shape}, expected ({gz * gx},)")
    zdim, xdim, _ = scene.dims
    if not (0 <= z0 and z0 + gz * 16 <= zdim and 0 <= x0 and x0 + gx * 16 <= xdim):
        raise ValueError(f"region {gz}x{gx} chunks at ({z0}, {x0}) outside the {zdim}x{xdim} scene")
    return slots, mask


def update_chunks(scene: Scene, d_blocks, slots, mask, gz: int, gx: int, z0: int, x0: int) -> Scene:
    """Write the gz x gx chunks of the slot table ``d_blocks`` ([C, 16, 16, 384] u8,
    [z, x, y]) named by ``slots`` (row-major, ``gz * gx`` host integers) into the scene at
    volume offset (z0, x0), air where ``mask`` is false, and re-sweep the distance fields
    over the window around them; the macro field is recomputed whole.  The analogue of
    buildChunkAccel / destroyChunk.  The scene's buffer is updated in place and returned
    in a new Scene.  CUDA: K10u, which takes the macro solidity outside the region from the
    old macro words, so the scene's macro level must be its fine level's, as every writer of
    a scene leaves it (``kernels.update_chunks``); CPU: the plain version."""
    slots, mask = _check_region(scene, slots, mask, gz, gx, z0, x0)
    scene.flat.copy_(update_chunks_plain(scene, d_blocks, slots, mask, gz, gx, z0, x0))
    return Scene(scene.flat, scene.origin, scene.dims)


def assemble_region(d_blocks, slots, mask, gz: int, gx: int) -> torch.Tensor:
    """[gz*16, gx*16, 384] u8 block region from slot-table chunks; air where ``mask`` is
    false (engine.py:31 ``_assemble_region``)."""
    dev = d_blocks.device
    idx = torch.as_tensor(np.asarray(slots, np.int64), device=dev)
    keep = torch.as_tensor(np.asarray(mask, bool), device=dev)
    ch = torch.where(keep[:, None, None, None], d_blocks.index_select(0, idx),
                     torch.zeros((), dtype=d_blocks.dtype, device=dev))
    return ch.view(gz, gx, 16, 16, Y_SIZE).permute(0, 2, 1, 3, 4).reshape(gz * 16, gx * 16, Y_SIZE)


def update_chunks_plain(scene: Scene, d_blocks, slots, mask, gz: int, gx: int, z0: int,
                        x0: int) -> torch.Tensor:
    """Plain version of K10u: the scene's new flat buffer (the old one is not written)."""
    zdim, xdim, ydim = scene.dims
    n_fine = zdim * xdim * ydim
    field = scene.flat[:n_fine].view(zdim, xdim, ydim)
    region = assemble_region(d_blocks, slots, mask, gz, gx)
    dz, dx = gz * 16, gx * 16
    zlo, xlo, wz, wx = update_window(scene.dims, gz, gx, z0, x0)
    old = field[zlo:zlo + wz, xlo:xlo + wx]
    window = old & 0xFF
    # the old words' distances and clearances seed the re-sweep as upper bounds, so solids
    # just outside the window stay accounted for at its border
    seeds = {"dist": torch.clamp(window - (EMPTY_BASE - 1), min=1),
             "up": (old >> 8) & 0x3F, "c2": (old >> 14) & 0x3F, "c8": (old >> 20) & 0x3F,
             "q": (old >> 26) & 0x1F}
    rz, rx = z0 - zlo, x0 - xlo
    new_vals = region.to(I32)
    new_solid = torch.as_tensor(RENDER_SOLID, device=region.device)[region.long()]
    window = window.clone()
    window[rz:rz + dz, rx:rx + dx] = torch.where(new_solid, new_vals,
                                                 torch.full_like(new_vals, EMPTY_BASE))
    # inside the updated region the old bounds do not hold: reset them to the cap (the
    # skyline seed to 31)
    for k, v in seeds.items():
        v = v.clone()
        v[rz:rz + dz, rx:rx + dx] = 31 if k == "q" else DIST_CAP
        seeds[k] = v
    solid = (window > 0) & (window < EMPTY_BASE)
    words = _encode(window, solid, init_dist=seeds["dist"], init_up=seeds["up"],
                    init_c2=seeds["c2"], init_c8=seeds["c8"], init_q=seeds["q"])
    field = field.clone()
    field[zlo:zlo + wz, xlo:xlo + wx] = words
    return torch.cat([field.reshape(-1), _encode_macro(field).reshape(-1)])
