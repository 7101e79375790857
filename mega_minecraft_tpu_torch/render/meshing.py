"""Meshing: visible-face quad extraction (VBO-creation parity, for export/debug).

Port of ``mega_minecraft_tpu/render/meshing.py``, host code (numpy) as there: the
equivalent of the reference's mesher (its terrain/chunk.cu:1751-2021
``Chunk::createVBOs`` — per filled chunk with 4 filled neighbors, emits quads for
visible faces using the transparency rules, X-shaped crossed quads with jittered
position, per-face UVs from the 16×16 atlas with optional seeded random rotation/flip,
and a per-vertex material class).

The DDA path tracer renders voxels directly and never needs meshes — this module
exists for tooling parity: world export (OBJ), debug rasterization, and tests.  Face
visibility runs in the native C++ core (``mega_minecraft_tpu_torch.native``, built with
g++ into ``build/native/``) when available, with a vectorized numpy fallback;
vertex/UV emission is vectorized numpy (the seeded UV rotation/flip RNG is
reimplemented in uint32 numpy for bit parity with ops/hashes).
"""

from __future__ import annotations

import numpy as np

from ..world import blocks as bl
from ..world.blocks import Block, Transparency

# 6 face directions in the reference's order (enums.hpp:43-50)
DIR_VECS = np.array(
    [[0, 0, 1], [1, 0, 0], [0, 0, -1], [-1, 0, 0], [0, 1, 0], [0, -1, 0]], np.int32
)

# quad corner offsets per direction (chunk.cu:1768-1775)
DIRECTION_VERT_POSITIONS = np.array(
    [
        [[0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]],
        [[1, 0, 1], [1, 0, 0], [1, 1, 0], [1, 1, 1]],
        [[1, 0, 0], [0, 0, 0], [0, 1, 0], [1, 1, 0]],
        [[0, 0, 0], [0, 0, 1], [0, 1, 1], [0, 1, 0]],
        [[0, 1, 1], [1, 1, 1], [1, 1, 0], [0, 1, 0]],
        [[0, 0, 0], [1, 0, 0], [1, 0, 1], [0, 0, 1]],
    ],
    np.float32,
)

UV_OFFSETS = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.int32)

_X_OFF = 0.5 * np.sin(np.radians(45.0))
X_SHAPED_VERTS = np.array(
    [
        [_X_OFF, 0, _X_OFF], [-_X_OFF, 0, -_X_OFF], [-_X_OFF, 1, -_X_OFF], [_X_OFF, 1, _X_OFF],
        [-_X_OFF, 0, _X_OFF], [_X_OFF, 0, -_X_OFF], [_X_OFF, 1, -_X_OFF], [-_X_OFF, 1, _X_OFF],
    ],
    np.float32,
)

# ---------------------------------------------------------------------------
# numpy uint32 reimplementation of ops/hashes seeding + minstd draws (bit parity)
# ---------------------------------------------------------------------------

_U = np.uint32


def _np_hash(a):
    a = a.astype(_U)
    with np.errstate(over="ignore"):
        a = (a + _U(0x7ED55D16)) + (a << _U(12))
        a = (a ^ _U(0xC761C23C)) ^ (a >> _U(19))
        a = (a + _U(0x165667B1)) + (a << _U(5))
        a = (a + _U(0xD3A2646C)) ^ (a << _U(9))
        a = (a + _U(0xFD7046C5)) + (a << _U(3))
        a = (a ^ _U(0xB55A4F09)) ^ (a >> _U(16))
    return a


def _np_seed4(x, y, z, w):
    with np.errstate(over="ignore"):
        h = _np_hash(
            _U(1 << 31)
            | (x.astype(_U) << _U(22))
            | (y.astype(_U) << _U(11))
            | w.astype(_U)
        ) ^ _np_hash(z.astype(_U))
    s = h % _U(2147483647)
    return np.where(s == 0, _U(1), s)


def _np_lcg_next(state):
    q, r, a, m = _U(44488), _U(3399), _U(48271), _U(2147483647)
    hi = state // q
    lo = state % q
    with np.errstate(over="ignore"):
        t_pos = a * lo
        t_neg = r * hi
    return np.where(t_pos >= t_neg, t_pos - t_neg, t_pos + m - t_neg)


def _np_u04(state):
    state = _np_lcg_next(state)
    v = (state - _U(1)).astype(np.float32) / np.float32(2147483645.0) * np.float32(4.0)
    return v, state


def _np_rand2_from2(vx, vy):
    d0 = vx * np.float32(238.68) + vy * np.float32(491.28)
    d1 = vx * np.float32(654.37) + vy * np.float32(560.45)
    s = lambda d: np.float32(39021.426) * np.sin(d.astype(np.float32))
    f = lambda x: x - np.floor(x)
    return f(s(d0)), f(s(d1))


def _should_display(this_trans, nb_block):
    """Transparency rules (chunk.cu:1913-1927)."""
    nb_trans = bl.TRANSPARENCY[nb_block]
    opaque_like = (this_trans == int(Transparency.OPAQUE)) | (
        this_trans == int(Transparency.SEMI_TRANSPARENT)
    )
    disp_opaque = nb_trans != int(Transparency.OPAQUE)
    disp_transparent = (nb_block == int(Block.AIR)) | (
        nb_trans == int(Transparency.SEMI_TRANSPARENT)
    )
    return np.where(opaque_like, disp_opaque, disp_transparent)


def _numpy_faces(b, pad, has_nb):
    """Fallback face scan: returns (pos [N,3] i32, dirs [N] u8, blocks [N] u8)."""
    trans = bl.TRANSPARENCY[b]
    solid_any = b != int(Block.AIR)
    x_shaped = trans == int(Transparency.X_SHAPED)
    pos_l, dir_l, blk_l = [], [], []
    for dir_idx in range(6):
        d = DIR_VECS[dir_idx]
        dz, dx, dy = int(d[2]), int(d[0]), int(d[1])
        if dy == 0:
            nb = pad[1 + dz : 17 + dz, 1 + dx : 17 + dx, :]
            boundary_missing = np.zeros((16, 16, 384), bool)
            if dx == 1 and not has_nb[(1, 0)]:
                boundary_missing[:, 15, :] = True
            if dx == -1 and not has_nb[(-1, 0)]:
                boundary_missing[:, 0, :] = True
            if dz == 1 and not has_nb[(0, 1)]:
                boundary_missing[15, :, :] = True
            if dz == -1 and not has_nb[(0, -1)]:
                boundary_missing[0, :, :] = True
            disp = _should_display(trans, nb) & ~boundary_missing
        else:
            nb = np.empty_like(b)
            if dy == 1:
                nb[:, :, :383] = b[:, :, 1:]
                nb[:, :, 383] = int(Block.AIR)
            else:
                nb[:, :, 1:] = b[:, :, :383]
                nb[:, :, 0] = int(Block.AIR)
            disp = _should_display(trans, nb)
            # out-of-range vertical faces always emit (chunk.cu:1881)
            if dy == 1:
                disp[:, :, 383] = True
            else:
                disp[:, :, 0] = True
        disp = disp & solid_any & ~x_shaped
        zs, xs, ys = np.nonzero(disp)
        pos_l.append(np.stack([xs, ys, zs], axis=1).astype(np.int32))
        dir_l.append(np.full(len(zs), dir_idx, np.uint8))
        blk_l.append(b[zs, xs, ys])
    return (
        np.concatenate(pos_l),
        np.concatenate(dir_l),
        np.concatenate(blk_l),
    )


def mesh_chunk(blocks, neighbors, world_block_pos):
    """Mesh one chunk.

    Args:
      blocks: [16, 16, 384] u8 ([z, x, y]).
      neighbors: dict {(+1,0): east(+x), (-1,0): west, (0,+1): south(+z), (0,-1)} —
        4-neighbor block volumes (missing = boundary face culled like a null
        neighbor, chunk.cu:1904-1907).
      world_block_pos: (wx, wz) world block coords of chunk origin.

    Returns dict with 'positions' [V, 3] f32, 'normals' [V, 3], 'uvs' [V, 2],
    'mats' [V] u8, 'indices' [I] i32.
    """
    from .. import native

    b = np.asarray(blocks)
    wx0, wz0 = int(world_block_pos[0]), int(world_block_pos[1])

    pad = np.zeros((18, 18, 384), np.uint8)
    pad[1:17, 1:17] = b
    for (kx, kz), sl_dst, sl_src in [
        ((1, 0), (slice(1, 17), 17), (slice(None), 0)),
        ((-1, 0), (slice(1, 17), 0), (slice(None), 15)),
        ((0, 1), (17, slice(1, 17)), (0, slice(None))),
        ((0, -1), (0, slice(1, 17)), (15, slice(None))),
    ]:
        nb = neighbors.get((kx, kz))
        if nb is not None:
            pad[sl_dst] = np.asarray(nb)[sl_src]
    has_nb = {k: (neighbors.get(k) is not None) for k in [(1, 0), (-1, 0), (0, 1), (0, -1)]}

    faces = native.extract_faces(b, neighbors)
    if faces is None:
        faces = _numpy_faces(b, pad, has_nb)
    f_pos, f_dirs, f_blks = faces
    n = len(f_dirs)

    # --- vectorized vertex/UV emission ---
    f_blks_i = f_blks.astype(np.int32)
    uv_face = np.where(f_dirs == 4, 1, np.where(f_dirs == 5, 2, 0))
    uv0 = bl.UV_TILES[f_blks_i, uv_face]  # [N, 2]
    rot = bl.RAND_ROT[f_blks_i, uv_face]
    flip = bl.RAND_FLIP[f_blks_i, uv_face]
    uv_start = np.zeros(n, np.int32)
    flip_idx = np.full(n, -1, np.int32)
    need = rot | flip
    if need.any():
        wx = (f_pos[:, 0] + wx0).astype(np.int32)
        wy = f_pos[:, 1].astype(np.int32)
        wz = (f_pos[:, 2] + wz0).astype(np.int32)
        state = _np_seed4(wx[need], wy[need], wz[need], f_dirs[need].astype(np.int32))
        v1, state = _np_u04(state)
        v2, _ = _np_u04(state)
        # draws happen in order: rot (if set) then flip (chunk.cu:1957-1966)
        r_n = rot[need]
        fl_n = flip[need]
        uv_start[need] = np.where(r_n, v1.astype(np.int32), 0)
        flip_val = np.where(r_n, v2, v1).astype(np.int32)
        flip_idx[need] = np.where(fl_n, flip_val, -1)

    base = f_pos.astype(np.float32)  # (x, y, z)
    corners = DIRECTION_VERT_POSITIONS[f_dirs]  # [N, 4, 3] in (x, y, z) order
    positions = base[:, None, :] + corners
    normals = np.broadcast_to(DIR_VECS[f_dirs].astype(np.float32)[:, None, :], (n, 4, 3))
    j = np.arange(4)[None, :]
    off = UV_OFFSETS[(uv_start[:, None] + j) % 4].astype(np.int32)  # [N, 4, 2]
    do_fx = (flip_idx[:, None] != -1) & ((flip_idx[:, None] & 1) != 0)
    do_fy = (flip_idx[:, None] != -1) & ((flip_idx[:, None] & 2) != 0)
    off[..., 0] = np.where(do_fx, 1 - off[..., 0], off[..., 0])
    off[..., 1] = np.where(do_fy, 1 - off[..., 1], off[..., 1])
    uvs = (uv0[:, None, :] + off) * np.float32(0.0625)
    mats = np.broadcast_to(bl.MATERIAL[f_blks_i][:, None], (n, 4))
    base_idx = np.arange(n, dtype=np.int32)[:, None] * 4
    quad_idx = base_idx + np.array([[0, 1, 2, 0, 2, 3]], np.int32)

    positions = positions.reshape(-1, 3)
    normals = normals.reshape(-1, 3)
    uvs = uvs.reshape(-1, 2).astype(np.float32)
    mats = mats.reshape(-1).astype(np.uint8)
    indices = quad_idx.reshape(-1)

    # --- X-shaped flora: two crossed quads with seeded jitter (chunk.cu:1833-1872)
    trans = bl.TRANSPARENCY[b]
    zs, xs, ys = np.nonzero(trans == int(Transparency.X_SHAPED))
    if len(zs):
        m = len(zs)
        blk = b[zs, xs, ys].astype(np.int32)
        jx, jz = _np_rand2_from2(
            (xs + wx0).astype(np.float32), (zs + wz0).astype(np.float32)
        )
        bx = xs + 0.5 + 0.4 * (jx - 0.5)
        bz = zs + 0.5 + 0.4 * (jz - 0.5)
        basep = np.stack([bx, ys.astype(np.float32), bz], axis=1).astype(np.float32)
        xpos = (basep[:, None, :] + X_SHAPED_VERTS[None, :, :]).reshape(-1, 3)
        n1 = np.array([0.70710678, 0, -0.70710678], np.float32)
        n2 = np.array([0.70710678, 0, 0.70710678], np.float32)
        xnorm = np.tile(np.concatenate([np.tile(n1, (4, 1)), np.tile(n2, (4, 1))]), (m, 1))
        xuv0 = bl.UV_TILES[blk, 0]
        xuvs = ((xuv0[:, None, :] + UV_OFFSETS[None, np.arange(8) % 4]) * 0.0625).reshape(-1, 2)
        xmats = np.repeat(bl.MATERIAL[blk], 8)
        xi0 = len(positions) + np.arange(m, dtype=np.int32)[:, None] * 8
        xquads = np.concatenate(
            [xi0 + np.array([[0, 1, 2, 0, 2, 3]], np.int32), xi0 + np.array([[4, 5, 6, 4, 6, 7]], np.int32)],
            axis=1,
        )
        positions = np.concatenate([positions, xpos])
        normals = np.concatenate([normals, xnorm.astype(np.float32)])
        uvs = np.concatenate([uvs, xuvs.astype(np.float32)])
        mats = np.concatenate([mats, xmats.astype(np.uint8)])
        indices = np.concatenate([indices, xquads.reshape(-1)])

    return {
        "positions": positions.astype(np.float32),
        "normals": normals.astype(np.float32),
        "uvs": uvs,
        "mats": mats,
        "indices": indices.astype(np.int32),
    }


def export_obj(mesh, path: str):
    """Write a mesh dict to a Wavefront OBJ file."""
    with open(path, "w") as f:
        for p in mesh["positions"]:
            f.write(f"v {p[0]} {p[1]} {p[2]}\n")
        for nrm in mesh["normals"]:
            f.write(f"vn {nrm[0]} {nrm[1]} {nrm[2]}\n")
        for t in mesh["uvs"]:
            f.write(f"vt {t[0]} {t[1]}\n")
        idx = mesh["indices"].reshape(-1, 3)
        for a, b2, c in idx + 1:
            f.write(f"f {a}/{a}/{a} {b2}/{b2}/{b2} {c}/{c}/{c}\n")
