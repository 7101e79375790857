"""Feature SDF library, plain PyTorch: the per-block geometry tests of all feature types.

Port of ``mega_minecraft_tpu/terrain/features_sdf.py`` (20 surface feature functions, 9 cave
feature functions, the primitives they share, the registries and ``draw_stream``).  The CUDA
twin is ``csrc/features_sdf.cuh``.  The reference re-seeds its per-feature RNG from the
placement position for every (block, feature) evaluation, so the first 64 draws ("the
stream") are the same for every block of one placement; each feature function is vectorised
geometry over a block volume with scalar stream values.  Per-block randomness (leaf
variants, glow chances) draws from the threaded per-block state ``brng``.

Each feature function:
    fn(s [64] f32, fx, fy, fz (block - placement offsets, i32, all of one full shape),
       wx, wy, wz (world block coords, i32), brng (int64 holding the u32 state),
       extra {"fy_pos", "fpos", "layer_height"} of 0-d i32 tensors)
    -> (hit bool, block i32, brng)

Arithmetic is f32 and IEEE, one mode: every division goes through ``div`` (a tensor
divisor on the operand's device) and ``pow`` takes a tensor exponent, so that the CPU
and the CUDA run of this file call the same libm functions the kernel calls.
"""

from __future__ import annotations

import math

import torch

from ..ops import hashes
from ..ops.hashes import div
from ..ops.noise import fbm2, simplex2, simplex3, smoothstep, worley2
from ..world import biomes as bio
from ..world.blocks import Block
from ..world.features_data import CaveFeature, Feature

F32 = torch.float32
I32 = torch.int32

PI = math.pi
TWO_PI = 2 * math.pi
PI_OVER_TWO = math.pi / 2
#: cos(pi / 6) in f32, a constant in the kernel too (a compiler may fold cosf of a constant)
COS_PI_OVER_6 = 0.8660253882408142

_B = Block
SEA_LEVEL = bio.SEA_LEVEL


def _f(x):
    return x.to(F32) if isinstance(x, torch.Tensor) else float(x)


def _where_block(cond, a, b):
    """where() over block ids given as ints or i32 tensors -> i32."""
    dev = cond.device
    a = a if isinstance(a, torch.Tensor) else torch.tensor(int(a), dtype=I32, device=dev)
    b = b if isinstance(b, torch.Tensor) else torch.tensor(int(b), dtype=I32, device=dev)
    return torch.where(cond, a, b)


def _result(hit, block):
    return _where_block(hit, block, 0)


def _pow(x, e: float):
    return torch.pow(x, torch.full_like(x, e))


def _length2(x, z):
    return torch.sqrt(x * x + z * z)


def _length3(x, y, z):
    return torch.sqrt(x * x + y * y + z * z)


def _in_range(v, lo, hi):
    return (v >= lo) & (v <= hi)


def _line_params(px, py, pz, ax, ay, az, bx, by, bz):
    """calculateLineParams -> (ratio, dist, in01)."""
    vx, vy, vz = bx - ax, by - ay, bz - az
    wx_, wy_, wz_ = px - ax, py - ay, pz - az
    denom = vx * vx + vy * vy + vz * vz
    denom = torch.where(denom == 0, torch.full_like(denom, 1e-9), denom)
    ratio = div(wx_ * vx + wy_ * vy + wz_ * vz, denom)
    lx, ly, lz = vx * ratio, vy * ratio, vz * ratio
    dist = _length3(wx_ - lx, wy_ - ly, wz_ - lz)
    return ratio, dist, (ratio >= 0.0) & (ratio <= 1.0)


def _in_rasterized_line(fx, fy, fz, ax, ay, az, bx, by, bz):
    """isInRasterizedLine."""
    px, py, pz = _f(fx) + 0.5, _f(fy) + 0.5, _f(fz) + 0.5
    ratio, dist, in01 = _line_params(px, py, pz, ax, ay, az, bx, by, bz)
    mx = ax + (bx - ax) * ratio
    my = ay + (by - ay) * ratio
    mz = az + (bz - az) * ratio
    same_cell = (
        (fx == torch.floor(mx).to(I32))
        & (fy == torch.floor(my).to(I32))
        & (fz == torch.floor(mz).to(I32))
    )
    return in01 & (dist < 2.0) & same_cell


def _jungle_leaves(px, py, pz, max_h, min_r, max_r, rand):
    """jungleLeaves."""
    mult = 0.8 + 0.4 * rand
    ratio = div(py, max_h)
    radius = (max_r + (min_r - max_r) * ratio) * mult
    return _in_range(py, 0.0, max_h) & (_length2(px, pz) < radius)


def _de_casteljau(ctrl, spline_size: int):
    """deCasteljau over a list of (x, y, z) 0-d control points -> list of spline points."""
    out = []
    for i in range(spline_size):
        t = i / (spline_size - 1)
        pts = list(ctrl)
        while len(pts) > 1:
            pts = [
                tuple(a + (b - a) * t for a, b in zip(pts[j], pts[j + 1]))
                for j in range(len(pts) - 1)
            ]
        out.append(pts[0])
    return out


def _crystal_radius(ratio):
    cone_n = 1.0 / (1.0 - 0.8)
    return torch.where(ratio < 0.8, 0.8 + 0.25 * ratio, cone_n * (1.0 - ratio))


def _in_crystal(px, py, pz, ax, ay, az, bx, by, bz, radius_mult):
    """isInCrystal: 6-sided prism along a line."""
    ratio, dist, in01 = _line_params(px, py, pz, ax, ay, az, bx, by, bz)
    radius = _crystal_radius(torch.clamp(ratio, 0.0, 1.0)) * radius_mult
    lx, ly, lz = bx - ax, by - ay, bz - az
    qx = px - (ax + ratio * lx)
    qy = py - (ay + ratio * ly)
    qz = pz - (az + ratio * lz)
    qlen = _length3(qx, qy, qz)
    # axis = normalize(cross(line, (1, 0, 0)))
    cy_, cz_ = lz + 0.0 * qx, -ly + 0.0 * qx
    cl = torch.sqrt(cy_ * cy_ + cz_ * cz_)
    cl = torch.where(cl == 0, torch.full_like(cl, 1e-9), cl)
    qsafe = torch.where(qlen == 0, torch.full_like(qlen, 1e-9), qlen)
    dot = div(qy * cy_ + qz * cz_, qsafe * cl)
    ang = torch.acos(torch.clamp(dot, -1.0, 1.0))
    pos_angle = torch.where(qlen == 0, torch.zeros_like(ang), ang + TWO_PI)
    p = PI / 6.0
    f32_p = torch.tensor(p, dtype=F32).item()
    two_p = torch.tensor(2.0 * f32_p, dtype=F32).item()
    radius = div(radius * COS_PI_OVER_6, torch.cos(f32_p - torch.remainder(pos_angle, two_p)))
    return in01 & (dist < radius)


def _random_crystal_block(rand):
    cr = rand * 3.0
    return _where_block(cr < 1.0, _B.MAGENTA_CRYSTAL,
                        _where_block(cr < 2.0, _B.CYAN_CRYSTAL, _B.GREEN_CRYSTAL))


def _brng_draw(brng, mask):
    """One draw of the per-block state, advanced only where ``mask``."""
    v, nxt = hashes.lcg_u01(brng)
    return v, torch.where(mask, nxt, brng)


# ---------------------------------------------------------------------------
# Surface features
# ---------------------------------------------------------------------------


def _feat_sphere(s, fx, fy, fz, wx, wy, wz, brng, extra):
    dx, dy, dz = _f(fx), _f(fy), _f(fz)
    hit = dx * dx + dy * dy + dz * dz <= 25.0
    return hit, _result(hit, _B.GRAVEL), brng


def _feat_coral(s, fx, fy, fz, wx, wy, wz, brng, extra):
    fpy = extra["fy_pos"]
    px, py, pz = _f(fx), _f(fy), _f(fz)
    in_reef = (fpy <= SEA_LEVEL - 6) & (_length2(px, pz) <= 8.0)
    coral_rand = torch.floor(s[0] * 5.0).to(I32)

    r_brain = 2.8 + 1.4 * s[1] + 0.4 * simplex3(_f(wx) * 0.2, _f(wy) * 0.2, _f(wz) * 0.2)
    hit_brain = _length3(px, py * 1.15, pz) < r_brain
    r_bub = 2.2 + 1.7 * s[1] + 1.2 * simplex3(_f(wx) * 0.3, _f(wy) * 0.3, _f(wz) * 0.3)
    hit_bub = _length3(px, py * 1.25, pz) < r_bub
    # fire / horn: rasterized branch lines; draw order z, y, x
    zero = torch.zeros((), dtype=F32, device=fx.device)
    p1z = (s[1] * 2 - 1) * 2.5
    p1y = s[2] * 3.5
    p1x = (s[3] * 2 - 1) * 2.5
    hit_line = _in_rasterized_line(fx, fy, fz, zero, zero, zero, p1x, p1y, p1z)
    k = 4
    for _ in range(5):
        p2x = p1x + 4.0 * (s[k] * 2 - 1)
        p2y = p1y + 2.0 + 3.0 * s[k + 1]
        p2z = p1z + 4.0 * (s[k + 2] * 2 - 1)
        hit_line = hit_line | _in_rasterized_line(fx, fy, fz, p1x, p1y, p1z, p2x, p2y, p2z)
        k += 3
    # tube
    w = worley2(_f(wx) * 0.7, _f(wz) * 0.7, want_edge=True)
    h_tube = ((1.0 - w["f1"]) + w["edge"]) * 3.5
    h_tube = h_tube * smoothstep(3.7, 2.5, _length2(px, pz)) - 2.0
    hit_tube = _in_range(py, -1.0, h_tube)

    hit = torch.where(
        coral_rand == 0, hit_brain,
        torch.where(coral_rand == 1, hit_bub, torch.where(coral_rand <= 3, hit_line, hit_tube)),
    ) & in_reef
    block = _where_block(
        coral_rand == 0, _B.BRAIN_CORAL_BLOCK,
        _where_block(coral_rand == 1, _B.BUBBLE_CORAL_BLOCK,
        _where_block(coral_rand == 2, _B.FIRE_CORAL_BLOCK,
        _where_block(coral_rand == 3, _B.HORN_CORAL_BLOCK, _B.TUBE_CORAL_BLOCK))),
    )
    return hit, _result(hit, block), brng


def _feat_kelp(s, fx, fy, fz, wx, wy, wz, brng, extra):
    fpy = extra["fy_pos"]
    height = torch.floor(5.0 + 15.0 * s[0]).to(I32)
    height = torch.minimum(height, SEA_LEVEL - fpy - 1)
    on_column = (fx == 0) & (fz == 0) & _in_range(fy, 0, height)
    block = _where_block(fy == height, _B.KELP_END, _B.KELP_MAIN)
    return on_column, _result(on_column, block), brng


def _feat_iceberg(s, fx, fy, fz, wx, wy, wz, brng, extra):
    fpy = extra["fy_pos"]
    px, pz = _f(fx), _f(fz)
    py = _f(wy) - float(SEA_LEVEL)
    ok_pos = fpy <= SEA_LEVEL - 32
    hd = _length2(px, pz)
    radius = 20.0 + 12.0 * s[0]
    center_ratio = 1.0 - div(hd, radius)
    nx = _f(wx) * 0.0450
    nz = _f(wz) * 0.0450
    fb = fbm2(nx, nz, octaves=3)
    start_h = -6.0 - 34.0 * center_ratio + 14.0 * fb
    end_h = -4.0 + 20.0 * center_ratio + 8.0 * fb
    hit = ok_pos & (center_ratio <= 1.15) & (end_h >= start_h) & _in_range(py, start_h, end_h)
    packed_h = -2.2 + 5.6 * center_ratio + 1.2 * simplex2(nx * 0.8, nz * 0.8)
    block = _where_block(
        py < -4.0, _B.BLUE_ICE,
        _where_block(py > end_h - packed_h, _B.PACKED_ICE, _B.BLUE_ICE),
    )
    return hit, _result(hit, block), brng


def _feat_acacia(s, fx, fy, fz, wx, wy, wz, brng, extra):
    px, py, pz = _f(fx), _f(fy), _f(fz)
    in_bounds = torch.maximum(fx.abs(), fz.abs()) <= 15
    trunk_h = torch.floor(4.5 + 1.5 * s[0]).to(I32)
    trunk = (fx == 0) & (fz == 0) & _in_range(fy, 0, trunk_h)
    zero = torch.zeros((), dtype=F32, device=fx.device)

    angle = s[1] * TWO_PI
    bsy = trunk_h.to(F32)
    bex = torch.cos(angle) * (2.0 + 1.5 * s[2])
    bez = torch.sin(angle) * (2.0 + 1.5 * s[2])
    bey = bsy + 2.5 + 1.5 * s[3]
    branch1 = _in_rasterized_line(
        fx, fy, fz, zero, torch.floor(bsy), zero,
        torch.ceil(bex), torch.ceil(bey), torch.ceil(bez),
    )
    l1 = _jungle_leaves(px - bex, py - bey + 0.5, pz - bez, 2.0, 2.0, 4.0, 0.5 + 0.5 * s[4])

    second = s[5] < 0.5
    angle2 = angle + PI_OVER_TWO + s[6] * PI
    bs2y = trunk_h.to(F32) - 0.8 - 0.8 * s[7]
    be2x = torch.cos(angle2) * (1.5 + 1.0 * s[8])
    be2z = torch.sin(angle2) * (1.5 + 1.0 * s[8])
    be2y = bs2y + 2.0 + 1.0 * s[9]
    branch2 = second & _in_rasterized_line(
        fx, fy, fz, zero, torch.floor(bs2y), zero,
        torch.ceil(be2x), torch.ceil(be2y), torch.ceil(be2z),
    )
    l2 = second & _jungle_leaves(
        px - be2x, py - be2y + 0.5, pz - be2z, 2.001, 1.5, 3.5, 0.5 + 0.5 * s[10]
    )

    wood = (trunk | branch1 | branch2) & in_bounds
    leaves = (l1 | l2) & in_bounds & ~wood
    hit = wood | leaves
    return hit, _result(hit, _where_block(wood, _B.ACACIA_WOOD, _B.ACACIA_LEAVES)), brng


def _feat_redwood(s, fx, fy, fz, wx, wy, wz, brng, extra):
    fpos = extra["fpos"]
    scale = 0.6 + 0.3 * s[0]
    px, py, pz = _f(fx) * scale, _f(fy) * scale, _f(fz) * scale
    height = 27.0 + 13.0 * s[1]
    hd = _length2(px, pz)
    leaves_start = 10.0 + 4.0 * s[2]
    in_bounds = ~((py > height + 8.0) | (hd > 12.0) | ((py < leaves_start - 4.0) & (hd > 3.0)))

    trunk_ratio = div(py - (-4.0), height - (-4.0))
    sat = (trunk_ratio >= 0) & (trunk_ratio <= 1)
    trunk_r = div(2.0, trunk_ratio + 2.0) + div(0.08, _pow(trunk_ratio + 0.4, 3.0))
    trunk_r = trunk_r + 0.3 * simplex3(_f(wx) * 0.13, _f(wy) * 0.13, _f(wz) * 0.13) * smoothstep(
        0.6, 0.2, trunk_ratio)
    trunk = sat & (hd < trunk_r)

    leaves_end = height + 1.5 + 1.0 * s[3]
    in_leaf_band = _in_range(py, leaves_start, leaves_end)

    cell_base = (torch.floor(py * 0.5) * 2).to(I32)
    branch_seed = 593.23 * hashes.rand1_from3(_f(fpos[0]), _f(fpos[1]), _f(fpos[2]))
    leaves_seed = 412.39 * hashes.rand1_from1(branch_seed)
    leaves_simplex = 1.1 * simplex3(_f(wx) * 0.2, _f(wy) * 0.2, _f(wz) * 0.2)
    in_leaves = torch.zeros_like(fx, dtype=torch.bool)
    branch_hit = torch.zeros_like(fx, dtype=torch.bool)
    zero = torch.zeros_like(px)
    for dy in (-4, -2, 0, 2, 4):
        cell_h = (cell_base + dy).to(F32)
        hr = div(cell_h - leaves_start, leaves_end - leaves_start)
        hr = 1.1 - 0.5 * hr
        r0, r1, r2 = hashes.rand3_from2(cell_h, leaves_seed.expand_as(cell_h))
        ccx = (r0 - 0.5) * 7.5 * hr
        ccy = (r1 - 0.5) * 1.3 * hr
        ccz = (r2 - 0.5) * 7.5 * hr
        ccy = torch.minimum(ccy + cell_h, height + 0.8)
        bsy = ccy - 2.0 - 1.5 * hashes.rand1_from1(cell_h + branch_seed)
        ratio, dist, in01 = _line_params(px, py, pz, zero, bsy, zero, ccx, ccy, ccz)
        branch_hit = branch_hit | (in01 & (dist < 0.5))
        lx = px - ccx
        ly = (py - ccy) * 1.7
        lz = pz - ccz
        ld = _length3(lx, ly, lz)
        lr = (2.5 + 0.5 * hashes.rand1_from1(cell_h + leaves_seed) + leaves_simplex) * hr
        in_leaves = in_leaves | ((ld <= 5.0) & (ld < lr))

    wood = (trunk | (branch_hit & in_leaf_band)) & in_bounds
    leaves = in_leaves & in_leaf_band & in_bounds & ~wood
    hit = wood | leaves
    return hit, _result(hit, _where_block(wood, _B.REDWOOD_WOOD, _B.REDWOOD_LEAVES)), brng


def _feat_cypress(s, fx, fy, fz, wx, wy, wz, brng, extra):
    px, py, pz = _f(fx), _f(fy), _f(fz)
    trunk_h = 25.0 + 12.0 * s[0]
    td = _length2(px, pz)
    in_bounds = ~((py > trunk_h + 4.0) | (td > 12.0))

    ratio = div(py - (-2.0), trunk_h - (-2.0))
    sat = (ratio >= 0) & (ratio <= 1)
    trunk_r = 0.5 * div(1.3 + ratio, _pow(0.73 + ratio, 4.0)) + 0.5
    trunk_r = trunk_r * (1.0 + 0.3 * simplex3(_f(wx) * 0.15, _f(wy) * 0.15, _f(wz) * 0.15)
                         * smoothstep(0.55, 0.15, ratio))
    trunk = sat & (td < trunk_r)

    wood = trunk
    leaves = _jungle_leaves(px, py - trunk_h, pz, 2.0, 3.0, 4.5, s[1])
    n_branches_f = 6.0 + torch.floor(s[2] * 5.0)
    branch_h = trunk_h - 1.0
    angle = s[3] * TWO_PI
    droop = hashes.rand1_from2(_f(wx), _f(wz))
    fpx, fpy_, fpz = torch.floor(px).to(I32), torch.floor(py).to(I32), torch.floor(pz).to(I32)
    zero = torch.zeros_like(px)
    k = 4
    for i in range(10):
        live = float(i) < n_branches_f
        branch_h = branch_h - (1.0 + 3.6 * s[k])
        angle = angle + PI_OVER_TWO + s[k + 1] * PI
        blen = 4.0 + 1.5 * s[k + 2]
        bex = torch.cos(angle) * blen
        bez = torch.sin(angle) * blen
        bey = 2.2 + 1.2 * s[k + 3]
        shrink = 1.0 - 0.3 * div(branch_h, trunk_h)
        bex, bey, bez = bex * shrink, bey * shrink, bez * shrink
        bey = bey + branch_h
        in_line = _in_rasterized_line(fpx, fpy_, fpz, zero, branch_h + zero, zero,
                                      bex + zero, bey + zero, bez + zero)
        wood = wood | (live & in_line)
        lx = px - bex + 0.3
        ly = py - bey + 0.3
        lz = pz - bez + 0.3
        droop_mask = (droop < 0.2) & _in_range(ly, torch.clamp_min(droop * -10.0, -2.0), 0.0)
        ly = torch.where(droop_mask, torch.zeros_like(ly), ly)
        leaves = leaves | (live & _jungle_leaves(lx, ly, lz, 2.0, 2.5, 4.0, s[k + 4]))
        k += 5

    wood = wood & in_bounds
    leaves = leaves & in_bounds & ~wood
    hit = wood | leaves
    return hit, _result(hit, _where_block(wood, _B.CYPRESS_WOOD, _B.CYPRESS_LEAVES)), brng


def _feat_birch(s, fx, fy, fz, wx, wy, wz, brng, extra):
    px, py, pz = _f(fx), _f(fy), _f(fz)
    height = torch.floor(6.2 + 4.0 * s[0]).to(I32)
    tall = s[1] < 0.08
    height = torch.where(tall, (height.to(F32) * 1.9).to(I32), height)
    in_bounds = (torch.maximum(fx.abs(), fz.abs()) <= 8) & _in_range(fy, 0, height + 6)
    trunk = (fx == 0) & (fz == 0) & _in_range(fy, 0, height)

    mult = torch.where(tall, 1.5, 1.0)
    leaves_start = height.to(F32) - (3.0 - 2.2 * s[2]) * mult
    leaves_end = height.to(F32) + (4.2 + 1.2 * s[3]) * mult
    ratio = div(py - leaves_start, leaves_end - leaves_start)
    in_band = _in_range(ratio, 0.0, 1.0)
    x = _pow(torch.clamp(ratio, 0.0, 1.0), 0.8)
    radius = 5.0 * (0.5 * (x * x * x) - 1.5 * (x * x) + x) * (2.8 + 0.8 * s[4])
    leaves = in_band & (_length2(px, pz) <= radius)

    leaf_rand = s[5]
    leaf_block = _where_block(
        leaf_rand < 0.1, _B.YELLOW_BIRCH_LEAVES,
        _where_block(leaf_rand < 0.2, _B.ORANGE_BIRCH_LEAVES, _B.BIRCH_LEAVES),
    )
    wood = trunk & in_bounds
    leaves = leaves & in_bounds & ~wood
    hit = wood | leaves
    return hit, _result(hit, _where_block(wood, _B.BIRCH_WOOD, leaf_block)), brng


def _feat_pine(s, fx, fy, fz, wx, wy, wz, brng, extra):
    height = torch.floor(7.0 + 4.0 * s[0]).to(I32)
    in_bounds = (fy >= 0) & (fy <= height + 4) & (torch.maximum(fx.abs(), fz.abs()) <= 6)
    trunk = (fx == 0) & (fz == 0) & (fy <= height)
    py = _f(fy)
    leaves_start = height.to(F32) - 4.0 - 2.5 * s[1]
    leaves_end = height.to(F32) + 3.0
    ratio = div(py - leaves_start, leaves_end - leaves_start)
    radius = 3.0 + (1.0 - 3.0) * ratio
    leaves = _in_range(ratio, 0.0, 1.0) & (_length2(_f(fx), _f(fz)) < radius)
    leaf_block = _where_block(s[2] < 0.5, _B.PINE_LEAVES_1, _B.PINE_LEAVES_2)
    wood = trunk & in_bounds
    leaves = leaves & in_bounds & ~wood
    hit = wood | leaves
    return hit, _result(hit, _where_block(wood, _B.PINE_WOOD, leaf_block)), brng


def _feat_pine_shrub(s, fx, fy, fz, wx, wy, wz, brng, extra):
    height = torch.floor(2.0 + 2.0 * s[0]).to(I32)
    in_bounds = (fy >= 0) & (fy <= height + 4) & (torch.maximum(fx.abs(), fz.abs()) <= 6)
    trunk = (fx == 0) & (fz == 0) & (fy <= height)
    leaves = _jungle_leaves(_f(fx), _f(fy) - (height.to(F32) - 1.0), _f(fz), 2.5, 1.5, 2.5, s[1])
    leaf_block = _where_block(s[2] < 0.5, _B.PINE_LEAVES_1, _B.PINE_LEAVES_2)
    wood = trunk & in_bounds
    leaves = leaves & in_bounds & ~wood
    hit = wood | leaves
    return hit, _result(hit, _where_block(wood, _B.PINE_WOOD, leaf_block)), brng


def _feat_medium_purple_mushroom(s, fx, fy, fz, wx, wy, wz, brng, extra):
    manh = fx.abs() + fz.abs()
    in_bounds = manh <= 8
    height = torch.floor(1.5 + 2.3 * s[0]).to(I32)
    stem = (fx == 0) & (fz == 0) & _in_range(fy, 0, height)
    radius = torch.where(s[1] < 0.5, 1.8, 2.5)
    cap = (fy == height + 1) & (_length2(_f(fx), _f(fz)) < radius)
    wood = stem & in_bounds
    caph = cap & in_bounds & ~wood
    hit = wood | caph
    return hit, _result(hit, _where_block(wood, _B.MUSHROOM_STEM, _B.PURPLE_MUSHROOM_CAP)), brng


def _feat_purple_mushroom(s, fx, fy, fz, wx, wy, wz, brng, extra):
    universal = 1.0 + s[0] * 1.2
    px, py, pz = _f(fx) * universal, _f(fy) * universal, _f(fz) * universal
    half = s[1] < 0.2
    px = torch.where(half, px * 0.5, px)
    py = torch.where(half, py * 0.5, py)
    pz = torch.where(half, pz * 0.5, pz)
    height = 25.0 + s[2] * 30.0
    hd = _length2(px, pz)
    far_cap = _length3(px, py - height, pz) > 35.0
    in_bounds = ~((py < -1) | (py > height + 12.0) | ((hd > 8.0) & ((py < height - 12.0) | far_cap)))

    # 5 control points (draws 3..14, order z, y, x), spline of 7 points
    zero = torch.zeros((), dtype=F32, device=fx.device)
    ctrl = [(zero, zero, zero)]
    kk = 3
    for i in range(1, 5):
        scale = 0.6 if i == 4 else 1.0
        oz = (s[kk] * 2 - 1) * (6.0 * scale)
        oy = (s[kk + 1] * 2 - 1) * (2.0 * scale)
        ox = (s[kk + 2] * 2 - 1) * (6.0 * scale)
        ctrl.append((ox, height * (i / 4.0) + oy, oz))
        kk += 3
    spline = _de_casteljau(ctrl, 7)

    hit = torch.zeros_like(fx, dtype=torch.bool)
    block = torch.zeros_like(fx, dtype=I32)
    for i in range(7):
        ax, ay, az = spline[i]
        if i < 6:
            bx, by, bz = spline[i + 1]
            band = ~((py < ay - 3) | (py > by + 3))
        else:
            prevx, prevy, prevz = spline[5]
            dx_, dy_, dz_ = ax - prevx, ay - prevy, az - prevz
            n = torch.sqrt(dx_ * dx_ + dy_ * dy_ + dz_ * dz_)
            n = torch.where(n == 0, torch.full_like(n, 1e-9), n)
            ext = 3.0 + s[15] * 1.5
            bx, by, bz = ax + div(dx_, n) * ext, ay + div(dy_, n) * ext, az + div(dz_, n) * ext
            band = torch.ones_like(fx, dtype=torch.bool)
        ratio, dist, in01 = _line_params(px, py, pz, ax + 0 * px, ay + 0 * px, az + 0 * px,
                                         bx + 0 * px, by + 0 * px, bz + 0 * px)
        if i < 6:
            t = div(i + torch.clamp(ratio, 0.0, 1.0), 6.0)
            xq = t - 0.5
            radius = (4.0 * xq * xq + 1.5) * 1.2
            pot_block = torch.full_like(fx, int(_B.MUSHROOM_STEM), dtype=I32)
        else:
            # glm::mix does not clamp: height < 33 shrinks the cap below 0.8x
            radius = (7.0 * s[16] + 12.0) * (0.8 + 0.4 * div(height - 33.0, 40.0))
            underside = (dist < radius - 1.8) & (ratio < 0.5) & (universal < 1.4)
            pot_block = _where_block(underside, _B.MUSHROOM_UNDERSIDE, _B.PURPLE_MUSHROOM_CAP)
        seg_hit = in01 & (dist <= radius)
        if i < 6:
            seg_hit = seg_hit | ((ratio < 0) & (_length3(px - ax, py - ay, pz - az) < radius))
        if i < 5:
            seg_hit = seg_hit | ((ratio > 1) & (_length3(px - bx, py - by, pz - bz) < radius))
        seg_hit = seg_hit & band & ~hit
        block = torch.where(seg_hit, pot_block, block)
        hit = hit | seg_hit

    hit = hit & in_bounds
    return hit, _result(hit, block), brng


def _feat_rafflesia(s, fx, fy, fz, wx, wy, wz, brng, extra):
    px, py, pz = _f(fx), _f(fy), _f(fz)
    in_bounds = ~((py > 10.0) | (_length3(px, py, pz) > 15.0))
    px, py, pz = px * 0.8, py * 0.8, pz * 0.8
    cx, cy, cz = px, (py - 1.0) * 1.4, pz
    spikes = _length3(cx, cy, cz) - 1.0 < 0

    center_sdf = (_length3(cx, cy - 1.0, cz) - 2.0).abs() - 0.8
    hole = _length3(cx, cy - 1.8, cz) - 1.8
    center = torch.maximum(center_sdf, -hole) < 0
    center_block = _where_block(cy > 1.0, _B.RAFFLESIA_CENTER, _B.RAFFLESIA_STEM)

    petal_hit = torch.zeros_like(fx, dtype=torch.bool)
    start_angle = s[0] * TWO_PI
    for i in range(5):
        ang = start_angle + i * TWO_PI * 0.2
        st = torch.sin(-ang)
        ct = torch.cos(-ang)
        ppx = px * ct + pz * st
        ppy = py - 3.2
        ppz = -px * st + pz * ct
        ppy = ppy - float(i % 2) * 0.53
        ppy = ppy + torch.clamp(div((ppx - 3.0).abs() - 1.5, 1.5), 0.0, 1.0) * 1.3
        ppx = ppx - 3.8
        ppz = ppz * 1.2
        # sdCappedCylinder(p, r = 2.5, h = 0.5)
        dlx = _length2(ppx, ppz).abs() - 2.5
        dly = ppy.abs() - 0.5
        sd = torch.clamp_max(torch.maximum(dlx, dly), 0.0) + _length2(
            torch.clamp_min(dlx, 0.0), torch.clamp_min(dly, 0.0))
        petal_hit = petal_hit | (sd < 0)

    hit1 = spikes
    hit2 = center & ~hit1
    hit3 = petal_hit & ~hit1 & ~hit2
    hit = (hit1 | hit2 | hit3) & in_bounds
    block = _where_block(hit1, _B.RAFFLESIA_SPIKES,
                         _where_block(hit2, center_block, _B.RAFFLESIA_PETAL))
    return hit, _result(hit, block), brng


def _feat_large_jungle(s, fx, fy, fz, wx, wy, wz, brng, extra):
    px, py, pz = _f(fx), _f(fy), _f(fz)
    height = 18.0 + 10.0 * s[0]
    in_bounds = ~((py > height + 6.0) | (_length2(px, pz) > 15.0))
    trunk = _in_range(py, 0.0, height) & (fx >= 0) & (fx <= 1) & (fz >= 0) & (fz <= 1)

    qx = px - 0.5
    qz = pz - 0.5
    top_leaf = _jungle_leaves(qx, py - (height - 2.0), qz, 4.0, 4.0, 7.0, s[1])
    r_top, brng = _brng_draw(brng, top_leaf & in_bounds & ~trunk)
    top_block = _where_block(r_top < 0.5, _B.JUNGLE_LEAVES_FRUITS, _B.JUNGLE_LEAVES_PLAIN)

    num_branches = 0.5 + 2.5 * s[2]
    branch_h = height
    wood = trunk
    leaves = top_leaf
    leaf_block = top_block
    zero = torch.zeros_like(px)
    k = 3
    for i in range(3):
        live = float(i) < num_branches
        branch_h = branch_h - (8.0 + s[k] * 3.0) * div(height, 30.0)
        ang = TWO_PI * s[k + 1]
        bex = torch.cos(-ang) * (3.0 + 1.5 * s[k + 2])
        bez = torch.sin(-ang) * (3.0 + 1.5 * s[k + 2])
        bey = branch_h + 1.0 + 1.5 * s[k + 3]
        ratio, dist, in01 = _line_params(qx, py, qz, zero, branch_h + zero, zero,
                                         bex + zero, bey + zero, bez + zero)
        br = 1.2 - 0.4 * ratio
        wood = wood | (live & in01 & (dist < br))
        bl = _jungle_leaves(qx - bex, py - bey + 0.2, qz - bez, 2.0, 2.5, 3.5, s[k + 4])
        new_leaf = live & bl & ~leaves
        r_b, brng = _brng_draw(brng, new_leaf & in_bounds & ~wood)
        lb = _where_block(r_b < 0.25, _B.JUNGLE_LEAVES_FRUITS, _B.JUNGLE_LEAVES_PLAIN)
        leaf_block = torch.where(new_leaf, lb, leaf_block)
        leaves = leaves | new_leaf
        k += 5

    wood = wood & in_bounds
    leaves = leaves & in_bounds & ~wood
    hit = wood | leaves
    return hit, _result(hit, _where_block(wood, _B.JUNGLE_WOOD, leaf_block)), brng


def _feat_small_jungle(s, fx, fy, fz, wx, wy, wz, brng, extra):
    px, py, pz = _f(fx), _f(fy), _f(fz)
    height = 8.0 + 4.0 * s[0]
    max_dist = torch.where(py < height - 2.0, 2.0, 8.0)
    in_bounds = ~((py > height + 4.0) | (_length2(px, pz) > max_dist))
    trunk = _in_range(py, 0.0, height) & (fx == 0) & (fz == 0)
    leaves = _jungle_leaves(px, py - (height - 1.0), pz, 3.0, 2.0, 4.0, s[1])
    lv = leaves & in_bounds & ~trunk
    r, brng = _brng_draw(brng, lv)
    leaf_block = _where_block(r < 0.25, _B.JUNGLE_LEAVES_FRUITS, _B.JUNGLE_LEAVES_PLAIN)
    wood = trunk & in_bounds
    hit = wood | lv
    return hit, _result(hit, _where_block(wood, _B.JUNGLE_WOOD, leaf_block)), brng


def _feat_tiny_jungle(s, fx, fy, fz, wx, wy, wz, brng, extra):
    in_bounds = (fx + fy + fz) <= 8
    height = torch.floor(0.5 + 2.5 * s[0]).to(I32)
    trunk = (fx == 0) & (fz == 0) & _in_range(fy, 0, height)
    manh = fx.abs() + (fy - height).abs() + fz.abs()
    wood = trunk & in_bounds
    leaf = (manh == 1) & in_bounds & ~wood
    hit = wood | leaf
    return hit, _result(hit, _where_block(wood, _B.JUNGLE_WOOD, _B.JUNGLE_LEAVES_PLAIN)), brng


def _feat_cactus(s, fx, fy, fz, wx, wy, wz, brng, extra):
    in_bounds = (fx.abs() <= 5) & (fz.abs() <= 5)
    height = torch.floor(7.5 + s[0] * 6.0).to(I32)
    in_bounds = in_bounds & (_f(fy) <= height.to(F32) + 2.0)
    hit = (fx == 0) & (fz == 0) & _in_range(fy, 0, height)
    zero = torch.zeros((), dtype=I32, device=fx.device)
    k = 1
    for arm_idx in range(4):
        has_arm = s[k] < 0.35
        a_start = torch.floor(4.0 + s[k + 1] * (height.to(F32) - 10.0)).to(I32)
        a_len = torch.floor(2.0 + s[k + 2] * 1.0).to(I32)
        a_h = torch.floor(3.0 + s[k + 3] * 3.0).to(I32)
        a_h = torch.minimum(height - a_start - 1, a_h)
        dx, dz = (int(bio.DIR_VECS_2D[arm_idx * 2][0]), int(bio.DIR_VECS_2D[arm_idx * 2][1]))
        p2x, p2z = dx * a_len, dz * a_len
        seg1 = (
            _in_range(fx, torch.minimum(zero, p2x), torch.maximum(zero, p2x))
            & _in_range(fz, torch.minimum(zero, p2z), torch.maximum(zero, p2z))
            & (fy == a_start)
        )
        seg2 = (fx == p2x) & (fz == p2z) & _in_range(fy, a_start, a_start + a_h)
        hit = hit | (has_arm & (seg1 | seg2))
        k += 4
    hit = hit & in_bounds
    return hit, _result(hit, _B.CACTUS), brng


def _feat_palm(s, fx, fy, fz, wx, wy, wz, brng, extra):
    px, py, pz = _f(fx), _f(fy), _f(fz)
    in_bounds = ~((fy < -2) | (fy > 28) | ((fx.abs() + fz.abs()) > 24))

    # 4 control points random walk (draws 0..8, order z, y, x)
    zero = torch.zeros((), dtype=F32, device=fx.device)
    ctrl = [(zero, zero, zero)]
    cx = cy = cz = zero
    k = 0
    for i in range(1, 4):
        walk = 1.0 + (i / 4.0) * 5.0
        cz = cz + walk * (s[k] * 2 - 1)
        cy = cy + 3.0 + 5.0 * s[k + 1]
        cx = cx + walk * (s[k + 2] * 2 - 1)
        ctrl.append((cx, cy, cz))
        k += 3

    def lo(c):
        return torch.minimum(torch.minimum(zero, ctrl[1][c]), torch.minimum(ctrl[2][c], ctrl[3][c]))

    def hi(c):
        return torch.maximum(torch.maximum(zero, ctrl[1][c]), torch.maximum(ctrl[2][c], ctrl[3][c]))

    in_box = (
        (px >= lo(0) - 7) & (px <= hi(0) + 7)
        & (py >= lo(1) - 1) & (py <= hi(1) + 6)
        & (pz >= lo(2) - 7) & (pz <= hi(2) + 7)
    )

    spline = _de_casteljau(ctrl, 5)
    tx = torch.floor(spline[4][0]).to(I32)
    ty = torch.floor(spline[4][1]).to(I32)
    tz = torch.floor(spline[4][2]).to(I32)
    lx = fx - tx
    ly = fy - ty
    lz = fz - tz
    ld = _length2(_f(lx), _f(lz))
    ld = ld * (0.6 + 0.3 * torch.clamp((20.0 - ty.to(F32)) * 0.05, 0.0, 1.0) + 0.3 * s[9])
    on_spoke = (lx == 0) | (lz == 0) | (lx.abs() == lz.abs())
    leaf_h = torch.where(ld > 3.0, -1, 0)
    leaves = _in_range(ly, -1, 0) & (ld < 3.9) & on_spoke & (ly == leaf_h)

    wood = torch.zeros_like(fx, dtype=torch.bool)
    for i in range(4):
        ax, ay, az = spline[i]
        bx, by, bz = spline[i + 1]
        ddx, ddy, ddz = bx - ax, by - ay, bz - az
        n = torch.sqrt(ddx * ddx + ddy * ddy + ddz * ddz)
        n = torch.where(n == 0, torch.full_like(n, 1e-9), n)
        padx, pady, padz = div(ddx, n) * 0.5, div(ddy, n) * 0.5, div(ddz, n) * 0.5
        if i > 0:
            ax, ay, az = ax - padx, ay - pady, az - padz
        if i + 1 < 4:
            bx, by, bz = bx + padx, by + pady, bz + padz
        wood = wood | _in_rasterized_line(fx, fy, fz, ax + 0 * px, ay + 0 * px, az + 0 * px,
                                          bx + 0 * px, by + 0 * px, bz + 0 * px)

    leaves = leaves & in_box & in_bounds
    wood = wood & in_box & in_bounds & ~leaves
    hit = wood | leaves
    return hit, _result(hit, _where_block(leaves, _B.PALM_LEAVES, _B.PALM_WOOD)), brng


def _feat_crystal(s, fx, fy, fz, wx, wy, wz, brng, extra, medium: bool):
    fpy = extra["fy_pos"]
    ok = fpy <= 180
    scale = 0.55 + 0.4 * s[0]
    if medium:
        scale = scale * 2.0
    px = _f(fx) * scale
    py = (_f(fy) + 2.0) * scale
    pz = _f(fz) * scale
    in_bounds = torch.maximum(fx.abs(), fz.abs()) <= 25

    # draw order z, y, x
    cez = 12.0 * (s[1] * 2 - 1)
    cey = 18.0 + 8.0 * s[2]
    cex = 12.0 * (s[3] * 2 - 1)
    not_above = py <= cey + 2.0
    crystal_block = _random_crystal_block(s[4])

    zero = 0.0 * px
    hit = _in_crystal(px, py, pz, zero, zero, zero, cex + zero, cey + zero, cez + zero,
                      4.0 + 1.2 * s[5])

    qx, qy, qz = px * 0.8, py * 0.8, pz * 0.8
    nsc = 4.0 + 2.0 * s[6]
    ang = s[7] * TWO_PI
    k = 8
    for i in range(6):
        live = float(i) < nsc
        ang = ang + PI_OVER_TWO + PI * s[k]
        ex = torch.cos(ang) * (6.0 + 3.0 * s[k + 1])
        ez = torch.sin(ang) * (6.0 + 3.0 * s[k + 1])
        ey = 7.0 + 5.0 * s[k + 2]
        hit = hit | (live & _in_crystal(qx, qy, qz, zero, zero, zero, ex + zero, ey + zero,
                                        ez + zero, 1.5 + 1.5 * s[k + 3]))
        k += 4

    hit = hit & ok & in_bounds & not_above
    return hit, _result(hit, crystal_block), brng


# ---------------------------------------------------------------------------
# Cave features; extra["layer_height"] is the cave layer's height
# ---------------------------------------------------------------------------


def _cave_test_pillar(block):
    def fn(s, fx, fy, fz, wx, wy, wz, brng, extra):
        h = extra["layer_height"]
        hit = (fx == 0) & (fz == 0) & _in_range(fy, 0, h)
        return hit, _result(hit, block), brng

    return fn


def _cave_vine(s, fx, fy, fz, wx, wy, wz, brng, extra):
    h = extra["layer_height"]
    ty = fy - h  # floorTopPos.y
    height = torch.floor(3.0 + 12.0 * s[0]).to(I32)
    height = torch.minimum(height, h)
    on_col = (fx == 0) & (fz == 0) & _in_range(ty, -height, 0)
    r, brng = _brng_draw(brng, on_col)
    glowing = r < 0.2
    block = torch.where(
        ty == -height,
        _where_block(glowing, _B.CAVE_VINES_GLOW_END, _B.CAVE_VINES_END),
        _where_block(glowing, _B.CAVE_VINES_GLOW_MAIN, _B.CAVE_VINES_MAIN),
    )
    return on_col, _result(on_col, block), brng


def _cave_glowstone_cluster(s, fx, fy, fz, wx, wy, wz, brng, extra):
    h = extra["layer_height"]
    px, pz = _f(fx), _f(fz)
    tyf = (_f(fy) - h.to(F32)) * 1.35
    sc = 1.0 + 0.5 * s[0]
    tx, ty2, tz = px * sc, tyf * sc, pz * sc
    radius = _length3(tx, ty2, tz)
    xz_angle = torch.atan2(pz, px)
    max_r = 3.5 + 2.0 * simplex2(xz_angle * 1.5, _f(wy) * 1.5)
    hit = (radius <= 6.0) & (radius < max_r)
    return hit, _result(hit, _B.GLOWSTONE), brng


def _cave_stormlight(ceiling: bool):
    def fn(s, fx, fy, fz, wx, wy, wz, brng, extra):
        h = extra["layer_height"]
        radius = 3.5 + 4.0 * s[0]
        if ceiling:
            dist = _length3(_f(fx), _f(fy) - h.to(F32), _f(fz))
        else:
            dist = _length3(_f(fx), _f(fy), _f(fz))
        inside = dist <= radius
        light_chance = smoothstep(0.4, 0.2, div(dist, radius))
        r, brng = _brng_draw(brng, inside)
        block = torch.where(r < light_chance, int(_B.GLOWSTONE), _random_crystal_block(s[1]))
        return inside, _result(inside, block), brng

    return fn


def _cave_crystal_pillar(s, fx, fy, fz, wx, wy, wz, brng, extra):
    h = extra["layer_height"].to(F32)
    py = _f(fy)
    ty = py - h
    in_bounds = ~((py < -8.0) | (ty > 8.0))
    d2 = _length2(_f(fx), _f(fz))
    in_bounds = in_bounds & (d2 <= 7.0)
    hr = div(py, torch.where(h == 0, torch.full_like(h, 1e-9), h))
    dist = torch.where(hr < 0, _length3(_f(fx), py, _f(fz)),
                       torch.where(hr > 1, _length3(_f(fx), ty, _f(fz)), d2))
    hr = torch.clamp(hr, 0.0, 1.0)
    radius = hr - 0.5
    radius = 4.0 * (2.0 * radius * radius + 0.5)
    inside = in_bounds & (dist <= radius)
    ratio = div(dist, radius)
    block = torch.where(ratio < 0.4, int(_B.GLOWSTONE), _random_crystal_block(s[0]))
    return inside, _result(inside, block), brng


def _cave_warped_fungus(s, fx, fy, fz, wx, wy, wz, brng, extra):
    fpos = extra["fpos"]
    manh = fx.abs() + fz.abs()
    in_bounds = manh <= 6
    height = torch.floor(2.5 + 3.0 * s[0]).to(I32)
    in_bounds = in_bounds & ~((fy < -2) | (fy > height + 3))
    stem = (fx == 0) & (fz == 0) & _in_range(fy, 0, height)

    sh = fy - (height - 1)
    shroom_zone = _in_range(sh, 0, 1) & (manh == 1) & in_bounds & ~stem
    r, brng = _brng_draw(brng, shroom_zone)
    chance = torch.where(sh == 0, 0.2, 0.5)
    shroom = shroom_zone & (r < chance)

    cap_r = _length2(_f(fx), _f(fz))
    cap_ok = cap_r <= 3.7
    cap_end = height + 1 - div(cap_r, 2.5).to(I32)
    cap_start = cap_end.to(F32) - (
        4.2
        * simplex2((_f(wx) + _f(fpos[1])) * 3.0, (_f(wz) + _f(fpos[1])) * 3.0)
        * torch.clamp_min(cap_r - 2.3, 0.0)
    )
    cap = cap_ok & (_f(fy) >= torch.floor(cap_start)) & (fy <= cap_end) & in_bounds

    h1 = stem & in_bounds
    h2 = shroom & ~h1
    h3 = cap & ~h1 & ~h2
    hit = h1 | h2 | h3
    block = _where_block(h1, _B.WARPED_STEM, _where_block(h2, _B.SHROOMLIGHT, _B.WARPED_WART))
    return hit, _result(hit, block), brng


def _cave_amber_fungus(s, fx, fy, fz, wx, wy, wz, brng, extra):
    manh = fx.abs() + fz.abs()
    in_bounds = manh <= 4
    height = torch.floor(4.5 + 4.5 * s[0]).to(I32)
    in_bounds = in_bounds & ~((fy < -2) | (fy > height + 3))
    stem = (fx == 0) & (fz == 0) & _in_range(fy, 0, height)
    wart_top = (fx == 0) & (fz == 0) & (fy == height + 1)

    cap_start = height // 2
    cap_start = cap_start - torch.where(simplex2(_f(wx), _f(wz)) < 0, 1, 0).to(I32)
    in_cap = _in_range(fy, cap_start, height)
    cap_manh = torch.where((fy - cap_start) < (height // 4 + 1), 2, 1)
    on_ring = in_cap & (manh == cap_manh)
    # shroomlight on a jittered 2-grid; (worldBlockPos / 2) * 2 is C division, which
    # truncates toward zero for negative coordinates

    def tdiv2(v):
        return torch.div(v, 2, rounding_mode="trunc")

    gx = tdiv2(wx) * 2
    gy = tdiv2(wy) * 2
    gz = tdiv2(wz) * 2
    r0, r1, r2 = hashes.rand3_from3(_f(gx), _f(gy), _f(gz))
    sx = gx + torch.floor(r0 * 2.0).to(I32)
    sy = gy + torch.floor(r1 * 2.0).to(I32)
    sz = gz + torch.floor(r2 * 2.0).to(I32)
    at_grid = (wx == sx) & (wy == sy) & (wz == sz)
    r, brng = _brng_draw(brng, on_ring & at_grid & in_bounds)
    shroom = on_ring & at_grid & (r < 0.65)

    h1 = (stem | wart_top) & in_bounds
    h2 = on_ring & in_bounds & ~h1
    hit = h1 | h2
    block = _where_block(stem & in_bounds, _B.AMBER_STEM,
                         _where_block(shroom & h2, _B.SHROOMLIGHT, _B.AMBER_WART))
    return hit, _result(hit, block), brng


# ---------------------------------------------------------------------------
# registries
# ---------------------------------------------------------------------------

SURFACE_FEATURE_FNS = {
    int(Feature.SPHERE): _feat_sphere,
    int(Feature.CORAL): _feat_coral,
    int(Feature.KELP): _feat_kelp,
    int(Feature.ICEBERG): _feat_iceberg,
    int(Feature.ACACIA_TREE): _feat_acacia,
    int(Feature.REDWOOD_TREE): _feat_redwood,
    int(Feature.CYPRESS_TREE): _feat_cypress,
    int(Feature.BIRCH_TREE): _feat_birch,
    int(Feature.PINE_TREE): _feat_pine,
    int(Feature.PINE_SHRUB): _feat_pine_shrub,
    int(Feature.RAFFLESIA): _feat_rafflesia,
    int(Feature.LARGE_JUNGLE_TREE): _feat_large_jungle,
    int(Feature.SMALL_JUNGLE_TREE): _feat_small_jungle,
    int(Feature.TINY_JUNGLE_TREE): _feat_tiny_jungle,
    int(Feature.MEDIUM_PURPLE_MUSHROOM): _feat_medium_purple_mushroom,
    int(Feature.PURPLE_MUSHROOM): _feat_purple_mushroom,
    int(Feature.MEDIUM_CRYSTAL): lambda *a: _feat_crystal(*a, medium=True),
    int(Feature.CRYSTAL): lambda *a: _feat_crystal(*a, medium=False),
    int(Feature.PALM_TREE): _feat_palm,
    int(Feature.CACTUS): _feat_cactus,
}

CAVE_FEATURE_FNS = {
    int(CaveFeature.TEST_GLOWSTONE_PILLAR): _cave_test_pillar(_B.GLOWSTONE),
    int(CaveFeature.TEST_SHROOMLIGHT_PILLAR): _cave_test_pillar(_B.SHROOMLIGHT),
    int(CaveFeature.CAVE_VINE): _cave_vine,
    int(CaveFeature.GLOWSTONE_CLUSTER): _cave_glowstone_cluster,
    int(CaveFeature.STORMLIGHT_SPHERE): _cave_stormlight(False),
    int(CaveFeature.CEILING_STORMLIGHT_SPHERE): _cave_stormlight(True),
    int(CaveFeature.CRYSTAL_PILLAR): _cave_crystal_pillar,
    int(CaveFeature.WARPED_FUNGUS): _cave_warped_fungus,
    int(CaveFeature.AMBER_FUNGUS): _cave_amber_fungus,
}

SEED_SURFACE_FEATURE_RNG = 1293012
SEED_SURFACE_BLOCK_RNG = 57847812
SEED_CAVE_FEATURE_RNG = 398132
SEED_CAVE_BLOCK_RNG = 9322743

STREAM_LEN = 64


def draw_stream(fpos_x, fpos_y, fpos_z, seed: int):
    """First STREAM_LEN u01 draws of the per-placement feature RNG ([..., 64] f32)."""
    state = hashes.seed_4(fpos_x, fpos_y, fpos_z, seed)
    vals = []
    for _ in range(STREAM_LEN):
        v, state = hashes.lcg_u01(state)
        vals.append(v)
    return torch.stack(vals, dim=-1)
