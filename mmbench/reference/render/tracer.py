"""Voxel path tracer: the brick-skipping DDA and the reference's light transport.

Port of ``mega_minecraft_tpu/render/tracer.py`` (the reference's OptiX megakernel,
basic_shaders.cu:558-1090: jittered pinhole rays, up to 4 bounces with specular
bounces not counting depth, a NEE shadow ray per bounce to the sun or moon disk,
Russian roulette after depth 2, volumetric scatter events, water / crystal
reflect-refract with Schlick fresnel, GGX microfacets, emissive texels, running-average
accumulation keyed by frame id; TEA + LCG per-pixel RNG).

Entry points, each dispatching on the scene's (or tensors') device: CUDA launches the
hand-written kernel or raises, the CPU runs the plain version below:

- ``trace``: one DDA per ray (K11t, ``csrc/tracer.cu`` ``trace_kernel``);
- ``render_sample``: one 1-spp sample of a frame or tile (K11: ``render_sample_kernel``
  runs the first bounce over the frame, one thread a pixel, then ``render_bounce_kernel``
  one later bounce a launch over the compacted live paths);
- ``accumulate``: the running average (K12, ``csrc/accumulate.cu``);
- ``render_accumulate``: K11 then K12.

The plain versions keep JAX's whole-image lane form (``where`` over lanes, a loop while
any lane is alive) and its operation order, with two departures that the kernels share:
each lane has its own DDA step budget (JAX's step counter is global, which differs only
for a lane parked by exact alpha cutout, i.e. only with a real atlas), and the TPU
scheduling knobs (tiling, compaction, DDA unroll, plain-hash pinning) are gone: rays
and seeds are keyed by global pixel, so any tiling computes the same paths.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import load_config
from ..ops import hashes
from ..ops.hashes import div
from ..world.blocks import Block, X_SHAPED_HI, X_SHAPED_LO
from . import sky as sky_mod
from .brickmap import EMPTY_BASE, MACRO_SCALE, SKY_R, Scene
from .camera import pixel_rays
from .materials import (MAT_IOR, MAT_ROUGHNESS, MAT_SPECULAR, MAT_WAVY, mat_scalar,
                        plain_tables, unpack_diffuse_texel, unpack_props, unpack_texel)
from .sky import SkyParams, f, linearstep, smoothstep

F32 = torch.float32
I32 = torch.int32
I64 = torch.int64
U8 = torch.uint8

_RCFG = load_config().render
MAX_RAY_DEPTH = _RCFG.max_ray_depth
MAX_LOOP_ITERS = MAX_RAY_DEPTH + 3  # + specular extensions
MAX_TRACE_STEPS = _RCFG.max_trace_steps
BOUNCE_TRACE_STEPS = _RCFG.bounce_trace_steps
SHADOW_TRACE_STEPS = _RCFG.shadow_trace_steps
EXACT_TRACE = _RCFG.exact_trace
MAPPED_NORMALS = _RCFG.mapped_normals
FOG_SCATTER = _RCFG.fog_scatter
#: rays end once their horizontal travel saturates the fog (smoothstep(220, 300) -> 1)
FOG_FULL_DIST = 320.0
#: stored first-hit distances are clamped here (sky pixels park at the cap)
DEPTH_CAP = 1e6
AIR = int(Block.AIR)
#: salt of the shadow ray's stochastic-alpha seed
SHADOW_SALT = 0x5BD1E995


class TraceResult(NamedTuple):
    hit: torch.Tensor  # bool
    t: torch.Tensor  # f32, 1e20 on a miss
    block: torch.Tensor  # u8
    nx: torch.Tensor
    ny: torch.Tensor
    nz: torch.Tensor


def _full(like, v, dtype=F32):
    return torch.full_like(like, v, dtype=dtype)


def _inv(d):
    return torch.where(d.abs() < 1e-12, 1e12 * torch.sign(d) + 1e12 * (d == 0).to(F32),
                       div(_full(d, 1.0), d))


def _floor_i(v, hi):
    """clip(floor(v), 0, hi) as int64 (non-finite and huge values clipped first)."""
    fl = torch.nan_to_num(torch.clamp(torch.floor(v), -1.0, float(hi + 1)), 0.0)
    return torch.clamp(fl.to(I64), 0, hi)


def trace(scene: Scene, ox, oy, oz, dx, dy, dz, medium, max_steps: int = MAX_TRACE_STEPS,
          active=None, want_steps: bool = False, alpha: str = "exact", seed=None,
          use_macro: bool = True):
    """Distance-field DDA from (o, d) in world space (tracer.py:104-532).

    medium: u8 block id the ray travels through (AIR, WATER or a crystal); ``active``:
    optional bool mask, lanes outside it never march; ``alpha``: "exact" (park on an
    alpha-flagged voxel and test its texel) or "stochastic" (pass through it with the
    probability of its transparent-texel fraction, rolled from ``seed`` hashed with the
    voxel); ``want_steps`` also returns each lane's DDA step count (i32).  All rays
    tensors of one shape.  CUDA scene: K11t; CPU scene: the plain version."""
    if alpha not in ("exact", "stochastic"):
        raise ValueError(f"alpha must be 'exact' or 'stochastic', not {alpha!r}")
    if alpha == "stochastic" and seed is None:
        raise ValueError("alpha='stochastic' requires a per-lane seed")
    return trace_plain(scene, ox, oy, oz, dx, dy, dz, medium, max_steps, active, want_steps,
                       alpha, seed, use_macro)


def trace_plain(scene: Scene, ox, oy, oz, dx, dy, dz, medium, max_steps: int = MAX_TRACE_STEPS,
                active=None, want_steps: bool = False, alpha: str = "exact", seed=None,
                use_macro: bool = True):
    """Plain version of ``trace`` on any device (whole-lane tensor code)."""
    shape = ox.shape
    ox, oy, oz, dx, dy, dz = (v.reshape(-1).to(F32) for v in (ox, oy, oz, dx, dy, dz))
    medium = medium.reshape(-1)
    zdim, xdim, ydim = scene.dims
    MS = MACRO_SCALE
    xm, ym = xdim // MS, ydim // MS
    macro_off = zdim * xdim * ydim
    o0, o1, o2 = (float(np.float32(v)) for v in scene.origin)
    flat = scene.flat
    big = _full(ox, 3e38)

    idx_, idy_, idz_ = _inv(dx), _inv(dy), _inv(dz)
    tx0, tx1 = (o0 - ox) * idx_, (f(np.float32(o0) + np.float32(xdim)) - ox) * idx_
    ty0, ty1 = (o1 - oy) * idy_, (f(np.float32(o1) + np.float32(ydim)) - oy) * idy_
    tz0, tz1 = (o2 - oz) * idz_, (f(np.float32(o2) + np.float32(zdim)) - oz) * idz_
    t_in = torch.maximum(torch.maximum(torch.minimum(tx0, tx1), torch.minimum(ty0, ty1)),
                         torch.minimum(tz0, tz1))
    t_out = torch.minimum(torch.minimum(torch.maximum(tx0, tx1), torch.maximum(ty0, ty1)),
                          torch.maximum(tz0, tz1))
    t_start = torch.clamp(t_in, min=0.0) + 1e-4
    alive = (t_out > t_start) & (t_out > 0.0)
    if active is not None:
        alive = alive & active.reshape(-1)
    horiz = torch.sqrt(dx * dx + dz * dz)
    t_out = torch.minimum(t_out, t_start + div(_full(horiz, FOG_FULL_DIST),
                                               torch.clamp(horiz, min=1e-3)))

    med = medium.to(I64)
    is_air_medium = med == AIR
    ascending = dy >= 0.0
    h_inf = torch.clamp(torch.maximum(dx.abs(), dz.abs()), min=1e-6)
    one = _full(ox, 1.0)
    inv_h = div(one, h_inf)
    inv_dy_abs = div(one, torch.clamp(dy.abs(), min=1e-6))
    inv_maxc = div(one, torch.maximum(h_inf, dy.abs()))
    tex_diff = plain_tables(flat.device)["tex_diff"] if alpha == "exact" else None
    seed_i = None if seed is None else hashes.u32(seed.reshape(-1))

    t = torch.where(alive, t_start, _full(ox, 1e20))
    false = torch.zeros_like(alive)
    hit, hit_x, x_use_a, pending, coarse = false, false, false, false, false
    hit_block = torch.zeros_like(med)
    lane_steps = torch.zeros_like(med)

    def cell_exit(vx, vy, vz, csz_x, csz_y, csz_z, cellx, celly, cellz):
        bx = torch.where(dx > 0, cellx + o0 + csz_x, cellx + o0)
        by = torch.where(dy > 0, celly + o1 + csz_y, celly + o1)
        bz = torch.where(dz > 0, cellz + o2 + csz_z, cellz + o2)
        tex = torch.where(dx.abs() < 1e-12, big, (bx - ox) * idx_)
        tey = torch.where(dy.abs() < 1e-12, big, (by - oy) * idy_)
        tez = torch.where(dz.abs() < 1e-12, big, (bz - oz) * idz_)
        return torch.minimum(torch.minimum(tex, tey), tez)

    def quads(vx, vz, t, t_exit):
        cx0 = vx.to(F32) + o0
        cz0 = vz.to(F32) + o2
        den_a, den_b = dx - dz, dx + dz
        small_a, small_b = den_a.abs() < 1e-6, den_b.abs() < 1e-6
        t_a = div((cx0 - cz0) + (oz - ox), torch.where(small_a, one, den_a))
        t_b = div(((1.0 + cx0) + cz0) - (ox + oz), torch.where(small_b, one, den_b))
        ok_a = ~small_a & (t_a >= t) & (t_a <= t_exit)
        ok_b = ~small_b & (t_b >= t) & (t_b <= t_exit)
        return t_a, t_b, ok_a, ok_b

    def voxel(t):
        px, py, pz = ox + dx * t, oy + dy * t, oz + dz * t
        return (_floor_i(px - o0, xdim - 1), _floor_i(py - o1, ydim - 1),
                _floor_i(pz - o2, zdim - 1))

    def step(t, alive, hit, hit_block, hit_x, x_use_a, pending, coarse, lane_steps):
        run = alive & (lane_steps < max_steps)
        lane_steps = lane_steps + run.to(I64)
        vx, vy, vz = voxel(t)
        fine_idx = (vz * xdim + vx) * ydim + vy
        mac_idx = macro_off + (torch.div(vz, MS, rounding_mode="floor") * xm
                               + torch.div(vx, MS, rounding_mode="floor")) * ym \
            + torch.div(vy, MS, rounding_mode="floor")
        packed = flat[torch.where(coarse, mac_idx, fine_idx)].to(I64)
        packed = torch.where(packed < 0, packed + 2 ** 32, packed)  # u32 bits
        val = packed & 0xFF
        is_solid = val < EMPTY_BASE
        descend = coarse & is_solid
        nsol = (~is_solid).to(F32)
        up_b = ((packed >> 8) & 0x3F).to(F32) * nsol
        c2_b = ((packed >> 14) & 0x3F).to(F32) * nsol
        c8_b = ((packed >> 20) & 0x3F).to(F32) * nsol
        sky_q = ((packed >> 26) & 0x1F).to(F32) * nsol
        is_x = (val >= X_SHAPED_LO) & (val < X_SHAPED_HI)

        cs = lambda v: torch.where(coarse, torch.div(v, MS, rounding_mode="floor") * MS, v).to(F32)  # noqa: E731
        csz = torch.where(coarse, _full(ox, float(MS)), one)
        t_exit = cell_exit(vx, vy, vz, csz, csz, csz, cs(vx), cs(vy), cs(vz))
        candidate = run & ~coarse & torch.where(is_air_medium, is_solid, val != med)
        t_a, t_b, ok_a, ok_b = quads(vx, vz, t, t_exit)

        flagged = candidate & (packed >= 2 ** 31)
        if alpha == "stochastic":
            pend_new = false
            t_frac = ((packed >> 8) & 0xFF).to(F32) * f(1.0 / 255.0)
            m = 0xFFFFFFFF
            hsh = (((vx * 2654435761) & m) ^ (((vy * 2246822519) + (vz * 3266489917)) & m)) ^ seed_i
            r_a, _ = hashes.rnd(hsh)
            opaque_roll = ~flagged | (r_a >= t_frac)
        else:
            pend_new = flagged
            opaque_roll = ~false
        a_first = ok_a & (~ok_b | (t_a <= t_b))
        t_q = torch.where(a_first, t_a, t_b)
        new_hit = candidate & ~pend_new & torch.where(is_x, ok_a | ok_b, ~false) & opaque_roll
        new_x = new_hit & is_x
        hit_block = torch.where(new_hit & is_solid, val,
                                torch.where(new_hit, torch.zeros_like(val), hit_block))
        hit = hit | new_hit
        hit_x = hit_x | new_x
        x_use_a = torch.where(new_x, a_first, x_use_a)
        t = torch.where(new_x, t_q, t)
        pending = pending | pend_new
        alive = alive & ~new_hit & ~pend_new

        skip3d = (val.to(F32) - float(EMPTY_BASE)) * inv_maxc
        s_up = (up_b - 1.0) * inv_h
        s2 = torch.minimum((c2_b - 1.0) * inv_h, 2.0 * inv_dy_abs)
        s8 = torch.minimum((c8_b - 1.0) * inv_h, 8.0 * inv_dy_abs)
        s_sky = torch.minimum(float(SKY_R) * inv_h, (4.0 * sky_q - 1.0) * inv_dy_abs)
        skip_dir = torch.where(ascending, s_up, torch.maximum(torch.maximum(s2, s8), s_sky))
        scale = torch.where(coarse, _full(ox, float(MS)), one)
        skip = torch.where(is_air_medium, torch.maximum(skip3d, skip_dir), 0 * one) * scale
        t_next = torch.maximum(t + torch.clamp(skip, min=0.0), t_exit)
        t_next = torch.maximum(t_next, t) * f(np.float32(1.0) + np.float32(1e-5)) + 1e-4
        moving = run & alive & ~descend
        t = torch.where(moving, t_next, t)
        sat = torch.where(ascending, up_b >= 63.0, (c8_b >= 63.0) | (sky_q >= 8.0))
        if use_macro:
            coarse = torch.where(run, (coarse & ~descend) | (alive & ~coarse & is_air_medium & sat),
                                 coarse)
        alive = torch.where(run, alive & (t < t_out), alive)
        return t, alive, hit, hit_block, hit_x, x_use_a, pending, coarse, lane_steps

    def resolve(t, alive, hit, hit_block, hit_x, x_use_a, pending):
        vx, vy, vz = voxel(t)
        widx = torch.where(pending, (vz * xdim + vx) * ydim + vy, torch.zeros_like(vx))
        packed = flat[widx].to(I64) & 0xFF
        val = packed
        is_x = (val >= X_SHAPED_LO) & (val < X_SHAPED_HI)
        fx, fy, fz = vx.to(F32), vy.to(F32), vz.to(F32)
        t_exit = cell_exit(vx, vy, vz, one, one, one, fx, fy, fz)
        t_a, t_b, ok_a, ok_b = quads(vx, vz, t, t_exit)

        def texel_alpha(u, v, face_base, on):
            tu = torch.floor(torch.clamp(u - torch.floor(u), 0.0, 0.999) * 16.0).to(I64)
            tv = torch.floor(torch.clamp(v - torch.floor(v), 0.0, 0.999) * 16.0).to(I64)
            idx = torch.where(on, val * (3 * 8 * 256) + face_base + tv * 16 + tu, torch.zeros_like(tu))
            return ((tex_diff[idx] >> 24) & 1) > 0

        qa_y, qb_y = oy + dy * t_a, oy + dy * t_b
        qa_u, qa_v = ox + dx * t_a, 1.0 - (qa_y - torch.floor(qa_y))
        qb_u, qb_v = ox + dx * t_b, 1.0 - (qb_y - torch.floor(qb_y))
        exf = (((fx + (dx < 0).to(F32)) + o0) - ox) * idx_
        eyf = (((fy + (dy < 0).to(F32)) + o1) - oy) * idy_
        ezf = (((fz + (dz < 0).to(F32)) + o2) - oz) * idz_
        t_en = torch.maximum(torch.maximum(exf, eyf), ezf)
        on_yf = (eyf >= t_en) & (exf < t_en)
        on_xf = exf >= t_en
        face_b = torch.where(on_yf, torch.where(dy < 0, _full(val, 1 * 8 * 256, I64),
                                                _full(val, 2 * 8 * 256, I64)), torch.zeros_like(val))
        hxf, hyf, hzf = ox + dx * t_en, oy + dy * t_en, oz + dz * t_en
        fu = torch.where(on_yf, hxf, torch.where(on_xf, hzf, hxf))
        fv = torch.where(on_yf, hzf, 1.0 - (hyf - torch.floor(hyf)))
        a1 = texel_alpha(torch.where(is_x, qa_u, fu), torch.where(is_x, qa_v, fv),
                         torch.where(is_x, torch.zeros_like(face_b), face_b), pending)
        a2 = texel_alpha(qb_u, qb_v, torch.zeros_like(face_b), pending & is_x)
        ok_a, ok_b = ok_a & a1, ok_b & a2
        a_first = ok_a & (~ok_b | (t_a <= t_b))
        t_q = torch.where(a_first, t_a, t_b)
        res_hit = pending & torch.where(is_x, ok_a | ok_b, a1)
        hit = hit | res_hit
        hit_x = hit_x | (res_hit & is_x)
        x_use_a = torch.where(res_hit & is_x, a_first, x_use_a)
        hit_block = torch.where(res_hit, val, hit_block)
        t = torch.where(res_hit & is_x, t_q, t)
        revived = pending & ~res_hit
        t_next = torch.maximum(t, t_exit) * f(np.float32(1.0) + np.float32(1e-5)) + 1e-4
        t = torch.where(revived, t_next, t)
        alive = alive | (revived & (t < t_out))
        return t, alive, hit, hit_block, hit_x, x_use_a, false

    while True:
        while bool((alive & (lane_steps < max_steps)).any()):
            (t, alive, hit, hit_block, hit_x, x_use_a, pending, coarse,
             lane_steps) = step(t, alive, hit, hit_block, hit_x, x_use_a, pending, coarse,
                                lane_steps)
        if alpha == "stochastic" or not bool(pending.any()):
            break
        t, alive, hit, hit_block, hit_x, x_use_a, pending = resolve(
            t, alive, hit, hit_block, hit_x, x_use_a, pending)

    # hit voxel + entry-face normal
    vx = torch.floor((ox + dx * t) - o0)
    vy = torch.floor((oy + dy * t) - o1)
    vz = torch.floor((oz + dz * t) - o2)
    ex = (((vx + (dx < 0).to(F32)) + o0) - ox) * idx_
    ey = (((vy + (dy < 0).to(F32)) + o1) - oy) * idy_
    ez = (((vz + (dz < 0).to(F32)) + o2) - oz) * idz_
    t_entry = torch.maximum(torch.maximum(ex, ey), ez)
    zero = 0 * one
    nx = torch.where(ex >= t_entry, -torch.sign(dx), zero)
    ny = torch.where((ey >= t_entry) & (ex < t_entry), -torch.sign(dy), zero)
    nz = torch.where((ez >= t_entry) & (ex < t_entry) & (ey < t_entry), -torch.sign(dz), zero)
    inv_s2 = f(0.70710678)
    sd_a, sd_b = torch.sign(dx - dz), torch.sign(dx + dz)
    nx = torch.where(hit_x, torch.where(x_use_a, -sd_a * inv_s2, -sd_b * inv_s2), nx)
    ny = torch.where(hit_x, zero, ny)
    nz = torch.where(hit_x, torch.where(x_use_a, sd_a * inv_s2, -sd_b * inv_s2), nz)
    t_hit = torch.where(hit, torch.where(hit_x, t, torch.clamp(t_entry, min=0.0)), _full(ox, 1e20))
    exit_iface = (med != AIR) & (hit_block == AIR) & hit
    nx = torch.where(exit_iface, -nx, nx)
    ny = torch.where(exit_iface, -ny, ny)
    nz = torch.where(exit_iface, -nz, nz)
    res = TraceResult(hit.view(shape), t_hit.view(shape), hit_block.to(U8).view(shape),
                      nx.view(shape), ny.view(shape), nz.view(shape))
    if want_steps:
        return res, lane_steps.to(I32).view(shape)
    return res


# ---------------------------------------------------------------------------
# sampling helpers (tracer.py:542-659; basic_shaders.cu:113-168, 777-800)
# ---------------------------------------------------------------------------

SQRT_ONE_THIRD = 0.57735026918962576450914878050


def _rsqrt_floor(x):
    return div(torch.ones_like(x), torch.sqrt(torch.clamp(x, min=1e-12)))


def _perp_dirs(nx, ny, nz):
    ax = nx.abs() < f(SQRT_ONE_THIRD)
    ay = ny.abs() < f(SQRT_ONE_THIRD)
    one, zero = torch.ones_like(nx), torch.zeros_like(nx)
    ox = torch.where(ax, one, zero)
    oy = torch.where(~ax & ay, one, zero)
    oz = torch.where(~ax & ~ay, one, zero)
    p1x, p1y, p1z = ny * oz - nz * oy, nz * ox - nx * oz, nx * oy - ny * ox
    inv = _rsqrt_floor(p1x * p1x + p1y * p1y + p1z * p1z)
    p1x, p1y, p1z = p1x * inv, p1y * inv, p1z * inv
    p2x, p2y, p2z = ny * p1z - nz * p1y, nz * p1x - nx * p1z, nx * p1y - ny * p1x
    inv2 = _rsqrt_floor(p2x * p2x + p2y * p2y + p2z * p2z)
    return p1x, p1y, p1z, p2x * inv2, p2y * inv2, p2z * inv2


def _cosine_hemisphere(nx, ny, nz, s1, s2):
    up = torch.sqrt(s1)
    over = torch.sqrt(torch.clamp(1.0 - s1, min=0.0))
    around = s2 * f(2.0 * np.pi)
    p1x, p1y, p1z, p2x, p2y, p2z = _perp_dirs(nx, ny, nz)
    ca, sa = torch.cos(around) * over, torch.sin(around) * over
    return (up * nx + ca * p1x + sa * p2x, up * ny + ca * p1y + sa * p2y,
            up * nz + ca * p1z + sa * p2z)


def _sample_star(params: SkyParams, is_sun, scattering, s1, s2):
    """sampleStar (basic_shaders.cu:148-168): jittered direction within the disk."""
    nx, ny, nz = (torch.where(is_sun, params.sun_dir[k], params.moon_dir[k]) for k in range(3))
    radius = torch.where(is_sun, torch.full_like(s1, 0.1000), torch.full_like(s1, 0.0775))
    p1x, p1y, p1z, p2x, p2y, p2z = _perp_dirs(nx, ny, nz)
    around = s2 * f(2.0 * np.pi)
    c, s = torch.cos(around), torch.sin(around)
    ddx, ddy, ddz = c * p1x + s * p2x, c * p1y + s * p2y, c * p1z + s * p2z
    inv = _rsqrt_floor(ddx * ddx + ddy * ddy + ddz * ddz)
    rx = nx + s1 * radius * ddx * inv
    ry = ny + s1 * radius * ddy * inv
    rz = nz + s1 * radius * ddz * inv
    n = div(torch.ones_like(rx), torch.sqrt(rx * rx + ry * ry + rz * rz))
    return tuple(torch.where(scattering, a, b) for a, b in zip((nx, ny, nz), (rx * n, ry * n, rz * n)))


def _reflect(dx, dy, dz, nx, ny, nz):
    d = dx * nx + dy * ny + dz * nz
    return dx - 2.0 * d * nx, dy - 2.0 * d * ny, dz - 2.0 * d * nz


def _refract(dx, dy, dz, nx, ny, nz, eta):
    """GLSL-style refract (basic_shaders.cu:209-217); the 0 vector on TIR."""
    nd = nx * dx + ny * dy + nz * dz
    k = 1.0 - eta * eta * (1.0 - nd * nd)
    ok = k >= 0.0
    ks = torch.sqrt(torch.clamp(k, min=0.0))
    rx = eta * dx - (eta * nd + ks) * nx
    ry = eta * dy - (eta * nd + ks) * ny
    rz = eta * dz - (eta * nd + ks) * nz
    inv = _rsqrt_floor(rx * rx + ry * ry + rz * rz)
    zero = torch.zeros_like(rx)
    return (torch.where(ok, rx * inv, zero), torch.where(ok, ry * inv, zero),
            torch.where(ok, rz * inv, zero), ok)


def _schlick(dx, dy, dz, nx, ny, nz, ior):
    cos_t = (dx * nx + dy * ny + dz * nz).abs()
    r0 = div(1.0 - ior, 1.0 + ior)
    r0 = r0 * r0
    return r0 + (1.0 - r0) * torch.pow(1.0 - cos_t, 5.0)


def _ggx_sample(nx, ny, nz, rough, s1, s2):
    a = rough * rough
    phi = f(2.0 * np.pi) * s1
    cos_t = torch.sqrt(div(1.0 - s2, 1.0 + (a * a - 1.0) * s2))
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    p1x, p1y, p1z, p2x, p2y, p2z = _perp_dirs(nx, ny, nz)
    cp, sp = torch.cos(phi), torch.sin(phi)
    whx = cp * sin_t * p1x + sp * sin_t * p2x + cos_t * nx
    why = cp * sin_t * p1y + sp * sin_t * p2y + cos_t * ny
    whz = cp * sin_t * p1z + sp * sin_t * p2z + cos_t * nz
    inv = _rsqrt_floor(whx * whx + why * why + whz * whz)
    return whx * inv, why * inv, whz * inv


def _trowbridge_reitz_d(whx, why, whz, nx, ny, nz, rough):
    c = whx * nx + why * ny + whz * nz
    cos2 = c * c
    tan2 = div(1.0 - cos2, torch.clamp(cos2, min=1e-12))
    cos4 = cos2 * cos2
    e = div(torch.sqrt(tan2), rough * rough).abs()
    ope = 1.0 + e
    d = div(torch.ones_like(e), f(np.pi) * rough * rough * torch.clamp(cos4, min=1e-12) * (ope * ope))
    return torch.clamp(d, min=0.0)


def _wave_normal(px, py, pz, nx, ny, nz, time):
    """applyWaveNoise (basic_shaders.cu:766-777): fBm-perturbed water normal."""
    ax = (px + py) * 0.45
    az = pz + py
    at = time * 0.3
    perlin_x = sky_mod.fbm_p(ax, az, at.expand_as(ax), octaves=4)
    perlin_z = sky_mod.fbm_p(ax + 74159.21, az + 21982.43, (at + 18923.34).expand_as(ax), octaves=4)
    nx2 = nx + perlin_x * 0.3
    nz2 = nz + perlin_z * 0.3
    inv = _rsqrt_floor(nx2 * nx2 + ny * ny + nz2 * nz2)
    return nx2 * inv, ny * inv, nz2 * inv


# ---------------------------------------------------------------------------
# frame buffers and accumulation (tracer.py:667-686, 1584-1614)
# ---------------------------------------------------------------------------


class FrameBuffers(NamedTuple):
    color: torch.Tensor  # [H, W, 3] running average
    albedo: torch.Tensor
    normal: torch.Tensor
    #: the temporal history (``render/reproject.py``; None on the frame-id-weighted path)
    depth: torch.Tensor | None = None  # [H, W] first-hit distance
    nsamp: torch.Tensor | None = None  # [H, W] per-pixel history length


def init_framebuffers(height: int, width: int, device="cuda", temporal: bool = False) -> FrameBuffers:
    """Zeroed buffers; with ``temporal`` also depth = DEPTH_CAP and nsamp = 0."""
    dev = torch.device(device)
    z = lambda: torch.zeros((height, width, 3), dtype=F32, device=dev)  # noqa: E731
    if not temporal:
        return FrameBuffers(z(), z(), z())
    return FrameBuffers(z(), z(), z(), torch.full((height, width), DEPTH_CAP, dtype=F32, device=dev),
                        torch.zeros((height, width), dtype=F32, device=dev))


def accumulate_weights(frame_id: int):
    """(fid, 1 / (fid + 1)) as f32 values."""
    fid = np.float32(frame_id)
    return float(fid), float(np.float32(1.0) / (fid + np.float32(1.0)))


def accumulate(fbs: FrameBuffers, color, albedo, normal, frame_id: int) -> FrameBuffers:
    """Running-average accumulation keyed by frame id (raygen:697-709): K12 for CUDA
    tensors, the plain version for CPU ones.  Returns new buffers."""
    return accumulate_plain(fbs, color, albedo, normal, frame_id)


def accumulate_plain(fbs: FrameBuffers, color, albedo, normal, frame_id: int) -> FrameBuffers:
    fid, mult = accumulate_weights(frame_id)
    return FrameBuffers((color + fid * fbs.color) * mult, (albedo + fid * fbs.albedo) * mult,
                        (normal + fid * fbs.normal) * mult)


# ---------------------------------------------------------------------------
# one path-traced sample (tracer.py:691-1378)
# ---------------------------------------------------------------------------


def _check_params(scene: Scene, cam, params: SkyParams):
    dev = scene.device
    for name, t in (*zip(("position", "forward", "right", "up", "pixel_length"), cam),
                    *zip(("sun_dir", "moon_dir", "stars_rot", "time"), params)):
        if t.device != dev:
            raise ValueError(f"{name}: on {t.device}, the scene is on {dev}")


def render_sample(scene: Scene, cam, params: SkyParams, height: int, width: int, frame_id: int,
                  row0: int = 0, full_height: int | None = None, col0: int = 0,
                  full_width: int | None = None, want_depth: bool = False,
                  exact: bool | None = None, want_steps: bool = False):
    """One 1-spp path-traced sample of the ``height`` x ``width`` tile whose top-left
    global pixel is (``row0``, ``col0``) of a ``full_height`` x ``full_width`` frame
    (defaults: the whole frame).  Returns (color, albedo, normal) [height, width, 3] f32
    (not accumulated), with ``want_depth`` also the primary-hit distance [height, width]
    (DEPTH_CAP where the primary ray escaped), with ``want_steps`` also the path's counts
    [height, width, 4] i32: DDA steps of its primary, bounce and shadow rays, and the
    number of radiance rays it traced.  ``exact``: the
    exact-reference trace mode (default ``config.render.exact_trace``).  CUDA scene: K11;
    CPU scene: the plain version."""
    _check_params(scene, cam, params)
    exact = EXACT_TRACE if exact is None else bool(exact)
    full_height = height if full_height is None else full_height
    full_width = width if full_width is None else full_width
    out = render_sample_plain(scene, cam, params, height, width, frame_id, row0,
                              full_height, col0, full_width, exact)
    c, a, n, d, st = out
    return (c, a, n) + ((d,) if want_depth else ()) + ((st,) if want_steps else ())


def render_accumulate(fbs: FrameBuffers, scene: Scene, cam, params: SkyParams, height: int,
                      width: int, frame_id: int) -> FrameBuffers:
    """One sample and its accumulation: K11 then K12 on the card."""
    c, a, n = render_sample(scene, cam, params, height, width, frame_id)
    return accumulate(fbs, c, a, n, frame_id)


def primary_rays(cam, height: int, width: int, frame_id: int, row0: int = 0,
                 full_height: int | None = None, col0: int = 0, full_width: int | None = None):
    """The jittered primary rays of a tile, as the sample of frame ``frame_id`` draws them
    (tracer.py:1123-1141): (ox, oy, oz, dx, dy, dz) [height, width] f32, and the pixels'
    RNG states after the two jitter draws (int64 holding u32)."""
    full_height = height if full_height is None else full_height
    full_width = width if full_width is None else full_width
    dev = cam.forward.device
    ix = torch.arange(width, dtype=I64, device=dev)[None, :] + col0
    iy = torch.arange(height, dtype=I64, device=dev)[:, None] + row0
    seed = hashes.tea(iy * full_width + ix, torch.full_like(ix, frame_id), rounds=4)
    seed = seed.expand(height, width).contiguous()
    j1, seed = hashes.rnd(seed)
    j2, seed = hashes.rnd(seed)
    dx, dy, dz = pixel_rays(cam, width, height, (j1, j2), row0, full_height, col0, full_width)
    zeros = dx * 0.0
    return tuple(cam.position[k] + zeros for k in range(3)) + (dx, dy, dz), seed


def _init_state(cam, height, width, frame_id, row0, full_height, col0, full_width):
    (ox, oy, oz, dx, dy, dz), seed = primary_rays(cam, height, width, frame_id, row0, full_height,
                                                  col0, full_width)
    zeros = dx * 0.0
    f0 = lambda: (zeros, zeros, zeros)  # noqa: E731
    pos = (ox, oy, oz)
    return dict(depth=torch.zeros_like(zeros, dtype=I64), pos=pos, dir=(dx, dy, dz),
                medium=torch.zeros_like(zeros, dtype=U8), seed=seed,
                ray_color=(zeros + 1.0, zeros + 1.0, zeros + 1.0), pixel_color=f0(),
                albedo=f0(), normal=f0(), needs_first=torch.ones_like(zeros, dtype=torch.bool),
                done=torch.zeros_like(zeros, dtype=torch.bool),
                scattered=torch.zeros_like(zeros, dtype=torch.bool), scatter_pos=pos,
                scatter_factor=zeros + 1.0, fog_color=f0(), fog_factor=zeros)


def _active_of(s):
    return ~s["done"] & ~s["scattered"] & (s["depth"] < MAX_RAY_DEPTH)


def _bounce(scene, params, s, first: bool, exact: bool, tabs, sink):
    """One bounce over the lanes of ``s`` (tracer.py:714-1118): radiance DDA, shading,
    NEE shadow DDA, depth and Russian roulette.  Every lane draws its ten numbers."""
    active = _active_of(s)
    ox, oy, oz = s["pos"]
    ddx, ddy, ddz = s["dir"]
    seed = s["seed"]
    needs_first = s["needs_first"] if first else torch.zeros_like(s["needs_first"])
    zero = torch.zeros_like(ddx)
    sun_y = params.sun_dir[1]

    res, st = trace_plain(scene, ox, oy, oz, ddx, ddy, ddz, s["medium"],
                          max_steps=MAX_TRACE_STEPS if (first or exact) else BOUNCE_TRACE_STEPS,
                          active=active, want_steps=True,
                          alpha="exact" if (first or exact) else "stochastic",
                          seed=None if (first or exact) else seed)
    sink["steps_primary" if first else "steps_bounce"] += st.to(I64)
    sink["rays"] += active.to(I64)
    if first:
        sink["depth"] = torch.clamp(res.t, max=DEPTH_CAP)
    hit = res.hit & active
    miss = ~res.hit & active
    isx, isy, isz = ox + ddx * res.t, oy + ddy * res.t, oz + ddz * res.t

    if first:
        cov = sky_mod.cloud_coverage(s["pos"], ddx, ddy, ddz, params)
        (sky_r, sky_g, sky_b), _ = sky_mod.sky_color(ddx, ddy, ddz, params, origin=s["pos"],
                                                     first_hit=needs_first, coverage=cov)
        (fog_r, fog_g, fog_b), _ = sky_mod.sky_color(ddx, ddy, ddz, params, origin=s["pos"],
                                                     first_hit=needs_first, include_stars=False,
                                                     coverage=cov)
    else:
        (sky_r, sky_g, sky_b), _ = sky_mod.sky_color(ddx, ddy, ddz, params)

    pr, pg, pb = s["pixel_color"]
    rr, rg, rb = s["ray_color"]
    ar, ag, ab = s["albedo"]
    nr, ng, nb = s["normal"]
    fcr, fcg, fcb = s["fog_color"]
    fog_factor, scatter_factor = s["fog_factor"], s["scatter_factor"]
    scattered, scatter_pos, done, medium = s["scattered"], s["scatter_pos"], s["done"], s["medium"]

    r_scatter, seed = hashes.rnd(seed)

    # ---- miss (sky), basic_shaders.cu:727-748
    pr = pr + torch.where(miss, sky_r * rr, zero)
    pg = pg + torch.where(miss, sky_g * rg, zero)
    pb = pb + torch.where(miss, sky_b * rb, zero)
    if first:
        m_first = miss & needs_first
        ar, ag, ab = (torch.where(m_first, c, o) for c, o in ((sky_r, ar), (sky_g, ag), (sky_b, ab)))
        nr, ng, nb = (torch.where(m_first, -c, o) for c, o in ((ddx, nr), (ddy, ng), (ddz, nb)))
        sky_time = div(torch.log(torch.clamp(1.0 - r_scatter, min=1e-7)), FOG_SCATTER)
        scatter_pos = tuple(torch.where(m_first, o + d * sky_time, sp)
                            for o, d, sp in zip((ox, oy, oz), (ddx, ddy, ddz), scatter_pos))
        m_sf = smoothstep(0.0, 3.5, r_scatter)
        scattered = scattered | m_first
        scatter_factor = torch.where(m_first, m_sf, scatter_factor)
        fcr, fcg, fcb = (torch.where(m_first, c, o) for c, o in ((sky_r, fcr), (sky_g, fcg), (sky_b, fcb)))
        fog_factor = torch.where(m_first, 1.0 - m_sf, fog_factor)
        needs_first = needs_first & ~m_first
    done = done | miss

    # ---- hit
    blk = res.block.to(I64)
    exit_to_air = (medium != AIR) & (res.block == AIR)
    eff_blk = torch.where(exit_to_air, medium.to(I64), blk)
    col_r, col_g, col_b, mat, _emis_w = unpack_props(tabs["props"][eff_blk])
    is_spec = mat_scalar(mat, MAT_SPECULAR)
    rough = mat_scalar(mat, MAT_ROUGHNESS)
    ior = mat_scalar(mat, MAT_IOR)
    frac = lambda a: a - torch.floor(a)  # noqa: E731
    on_y = res.ny.abs() > 0.5
    on_x = res.nx.abs() > 0.5
    face = torch.where(on_y, torch.where(res.ny > 0, 1, 2), 0).to(I64)
    fu = torch.where(on_y, frac(isx), torch.where(on_x, frac(isz), frac(isx)))
    fv = torch.where(on_y, frac(isz), 1.0 - frac(isy))
    tu = _floor_i(fu * 16.0, 15)
    tv = _floor_i(fv * 16.0, 15)
    vxf = torch.floor(isx - res.nx * 0.5)
    vyf = torch.floor(isy - res.ny * 0.5)
    vzf = torch.floor(isz - res.nz * 0.5)
    hface = hashes.rand1_from3(vxf + res.nx, vyf + res.ny * 2.0, vzf + res.nz * 3.0)
    variant = _floor_i(hface * 8.0, 7)
    tex_idx = ((eff_blk * 3 + face) * 8 + variant) * 256 + tv * 16 + tu
    texel = tabs["tex_diff"][tex_idx]
    tr, tg, tb, _alpha, emis_w_tex = unpack_diffuse_texel(texel)
    col_r = torch.where(exit_to_air, col_r, tr)
    col_g = torch.where(exit_to_air, col_g, tg)
    col_b = torch.where(exit_to_air, col_b, tb)
    horiz = torch.sqrt(ddx * ddx + ddz * ddz) * res.t
    hit_fog_factor = smoothstep(220.0, 300.0, horiz)

    # ---- volumetric scatter event at the first hit (closesthit:868-880)
    if first:
        scatter_chance = (1.0 - torch.exp(FOG_SCATTER * res.t)) * smoothstep(0.55, 0.35, sun_y)
        h_scatter = hit & needs_first & (scatter_chance > r_scatter)
        ar, ag, ab = (torch.where(h_scatter, c, o) for c, o in ((col_r, ar), (col_g, ag), (col_b, ab)))
        nr, ng, nb = (torch.where(h_scatter, c, o) for c, o in ((res.nx, nr), (res.ny, ng), (res.nz, nb)))
        sc_t = div(torch.log(torch.clamp(1.0 - r_scatter, min=1e-7)), FOG_SCATTER)
        scatter_pos = tuple(torch.where(h_scatter, o + d * sc_t, sp)
                            for o, d, sp in zip((ox, oy, oz), (ddx, ddy, ddz), scatter_pos))
        scattered = scattered | h_scatter
        scatter_factor = torch.where(h_scatter, smoothstep(0.0, 3.5, 1.0 - r_scatter), scatter_factor)
        fcr, fcg, fcb = (torch.where(h_scatter, c, o) for c, o in ((fog_r, fcr), (fog_g, fcg), (fog_b, fcb)))
        fog_factor = torch.where(h_scatter, hit_fog_factor, fog_factor)
        needs_first = needs_first & ~h_scatter
        h_shade = hit & ~h_scatter
    else:
        h_shade = hit

    # ---- specular (water / crystal)
    nx, ny, nz = res.nx, res.ny, res.nz
    if MAPPED_NORMALS:
        tnx, tny, tnz = unpack_texel(tabs["tex_norm"][tex_idx])
        tnx, tny, tnz = tnx * 2.0 - 1.0, tny * 2.0 - 1.0, tnz * 2.0 - 1.0
        one, zr = torch.ones_like(nx), torch.zeros_like(nx)
        tx = torch.where(on_y | ~on_x, one, zr)
        tz = torch.where(~on_y & on_x, one, zr)
        by = torch.where(on_y, zr, -one)
        bz = torch.where(on_y, one, zr)
        pnx = tx * tnx + zr * tny + nx * tnz
        pny = by * tny + ny * tnz
        pnz = tz * tnx + bz * tny + nz * tnz
        inv_n = torch.rsqrt(torch.clamp(pnx * pnx + pny * pny + pnz * pnz, min=1e-12))
        blk_is_x = (res.block >= X_SHAPED_LO) & (res.block < X_SHAPED_HI)
        use_map = h_shade & ~exit_to_air & ~blk_is_x
        nx = torch.where(use_map, pnx * inv_n, nx)
        ny = torch.where(use_map, pny * inv_n, ny)
        nz = torch.where(use_map, pnz * inv_n, nz)
    wavy = mat_scalar(mat, MAT_WAVY) & h_shade
    if bool(wavy.any()):
        wnx, wny, wnz = _wave_normal(isx, isy, isz, nx, ny, nz, params.time)
        nx, ny, nz = torch.where(wavy, wnx, nx), torch.where(wavy, wny, ny), torch.where(wavy, wnz, nz)

    spec = h_shade & is_spec
    entering = ddx * nx + ddy * ny + ddz * nz
    r_spec, seed = hashes.rnd(seed)
    ent = entering < 0.0
    refr_e = r_spec < -entering
    fres_in = _schlick(ddx, ddy, ddz, nx, ny, nz, ior)
    rfx, rfy, rfz, _ = _refract(ddx, ddy, ddz, nx, ny, nz, div(torch.ones_like(ior), torch.clamp(ior, min=1e-6)))
    rlx, rly, rlz = _reflect(ddx, ddy, ddz, nx, ny, nz)
    sin_tt = ior * torch.sqrt(torch.clamp(1.0 - entering * entering, min=0.0))
    refr_x = r_spec < div(entering, torch.clamp(sin_tt, min=1.0))
    rfx2, rfy2, rfz2, _ = _refract(ddx, ddy, ddz, -nx, -ny, -nz, ior)
    rlx2, rly2, rlz2 = _reflect(ddx, ddy, ddz, -nx, -ny, -nz)
    fres_out = _schlick(ddx, ddy, ddz, -nx, -ny, -nz, ior)
    pick = lambda a, b, c, d: torch.where(ent, torch.where(refr_e, a, b), torch.where(refr_x, c, d))  # noqa: E731
    new_dx, new_dy, new_dz = pick(rfx, rlx, rfx2, rlx2), pick(rfy, rly, rfy2, rly2), pick(rfz, rlz, rfz2, rlz2)
    off = pick(zero - 0.001, zero + 0.001, zero + 0.001, zero - 0.001)
    spec_px, spec_py, spec_pz = isx + nx * off, isy + ny * off, isz + nz * off
    spec_weight = pick(1.0 - fres_in, fres_in, 1.0 - fres_out, fres_out) * ior
    new_medium = torch.where(spec & ent & refr_e, res.block,
                             torch.where(spec & ~ent & refr_x, torch.zeros_like(medium), medium))

    # ---- microfacet / diffuse
    g1, seed = hashes.rnd(seed)
    g2, seed = hashes.rnd(seed)
    cdx, cdy, cdz = _cosine_hemisphere(nx, ny, nz, g1, g2)
    gx1, seed = hashes.rnd(seed)
    gx2, seed = hashes.rnd(seed)
    rough_c = torch.clamp(rough, min=1e-3)
    whx, why, whz = _ggx_sample(nx, ny, nz, rough_c, gx1, gx2)
    wox, woy, woz = -ddx, -ddy, -ddz
    owh = wox * whx + woy * why + woz * whz
    mdx, mdy, mdz = 2.0 * owh * whx - wox, 2.0 * owh * why - woy, 2.0 * owh * whz - woz
    minv = _rsqrt_floor(mdx * mdx + mdy * mdy + mdz * mdz)
    mdx, mdy, mdz = mdx * minv, mdy * minv, mdz * minv
    is_micro = rough > 0.0
    d_ggx = _trowbridge_reitz_d(whx, why, whz, nx, ny, nz, rough_c)
    ndl = (nx * mdx + ny * mdy + nz * mdz).abs()
    ndv = (nx * wox + ny * woy + nz * woz).abs()
    micro_mul = torch.clamp(div(d_ggx, torch.clamp(4.0 * ndl * ndv, min=1e-6)), 1.0, 4.0)
    dif_dx, dif_dy, dif_dz = (torch.where(is_micro, m, c) for m, c in ((mdx, cdx), (mdy, cdy), (mdz, cdz)))
    dcol_r, dcol_g, dcol_b = (torch.where(is_micro, c * micro_mul, c) for c in (col_r, col_g, col_b))

    # ---- emissive texel (basic_shaders.cu:974-993)
    emissive = h_shade & ~spec & ~exit_to_air & ((texel & 0xFFFFFF) == 0) & (emis_w_tex > 0.0)
    e_r, e_g, e_b = unpack_texel(tabs["tex_emis"][torch.where(emissive, tex_idx, torch.zeros_like(tex_idx))])
    if first:
        e_strength = torch.where(needs_first, torch.full_like(emis_w_tex, 1.5), emis_w_tex * 100.0)
    else:
        e_strength = emis_w_tex * 100.0
    ecr, ecg, ecb = e_r * e_strength, e_g * e_strength, e_b * e_strength
    pr = pr + torch.where(emissive, rr * ecr, zero)
    pg = pg + torch.where(emissive, rg * ecg, zero)
    pb = pb + torch.where(emissive, rb * ecb, zero)
    if first:
        em_first = emissive & needs_first
        ar, ag, ab = (torch.where(em_first, c, o) for c, o in ((ecr, ar), (ecg, ag), (ecb, ab)))
        nr, ng, nb = (torch.where(em_first, c, o) for c, o in ((nx, nr), (ny, ng), (nz, nb)))
        fcr, fcg, fcb = (torch.where(em_first, c, o) for c, o in ((fog_r, fcr), (fog_g, fcg), (fog_b, fcb)))
        fog_factor = torch.where(em_first, hit_fog_factor, fog_factor)
        needs_first = needs_first & ~em_first

    # ---- ray colour / position / direction
    diffuse_like = h_shade & ~spec & ~emissive
    rr = torch.where(spec, rr * spec_weight * col_r, torch.where(diffuse_like, rr * dcol_r, rr))
    rg = torch.where(spec, rg * spec_weight * col_g, torch.where(diffuse_like, rg * dcol_g, rg))
    rb = torch.where(spec, rb * spec_weight * col_b, torch.where(diffuse_like, rb * dcol_b, rb))
    new_px = torch.where(spec, spec_px, torch.where(diffuse_like, isx + nx * 0.001, ox))
    new_py = torch.where(spec, spec_py, torch.where(diffuse_like, isy + ny * 0.001, oy))
    new_pz = torch.where(spec, spec_pz, torch.where(diffuse_like, isz + nz * 0.001, oz))
    new_ddx = torch.where(spec, new_dx, torch.where(diffuse_like, dif_dx, ddx))
    new_ddy = torch.where(spec, new_dy, torch.where(diffuse_like, dif_dy, ddy))
    new_ddz = torch.where(spec, new_dz, torch.where(diffuse_like, dif_dz, ddz))
    medium = torch.where(spec, new_medium, medium)
    if first:
        hf2 = h_shade & needs_first
        ar, ag, ab = (torch.where(hf2, c, o) for c, o in ((col_r, ar), (col_g, ag), (col_b, ab)))
        nr, ng, nb = (torch.where(hf2, c, o) for c, o in ((nx, nr), (ny, ng), (nz, nb)))
        fcr, fcg, fcb = (torch.where(hf2, c, o) for c, o in ((fog_r, fcr), (fog_g, fcg), (fog_b, fcb)))
        fog_factor = torch.where(hf2, hit_fog_factor, fog_factor)
        needs_first = needs_first & ~hf2
    done = done | emissive

    # ---- NEE shadow ray (raygen:626-665)
    nee = (active & ~spec & ~done) | (scattered & active)
    x1, seed = hashes.rnd(seed)
    x2, seed = hashes.rnd(seed)
    r_sun, seed = hashes.rnd(seed)
    is_sun = r_sun < linearstep(-0.1, 0.1, sun_y)
    sdx, sdy, sdz = _sample_star(params, is_sun, scattered, x1, x2)
    spx = tuple(torch.where(scattered, sp, p) for sp, p in zip(scatter_pos, (new_px, new_py, new_pz)))
    sres, sst = trace_plain(scene, spx[0], spx[1], spx[2], sdx, sdy, sdz, torch.zeros_like(medium),
                            max_steps=MAX_TRACE_STEPS if exact else SHADOW_TRACE_STEPS, active=nee,
                            want_steps=True, alpha="exact" if exact else "stochastic",
                            seed=None if exact else seed ^ SHADOW_SALT)
    sink["steps_shadow"] += sst.to(I64)
    (ssr, ssg, ssb), s_found = sky_mod.sky_color(sdx, sdy, sdz, params)
    sf = torch.where(scattered & done, scatter_factor * smoothstep(256.0, 128.0, spx[1]), scatter_factor)
    add = nee & ~sres.hit
    pr = pr + torch.where(add, ssr * rr * sf, zero)
    pg = pg + torch.where(add, ssg * rg * sf, zero)
    pb = pb + torch.where(add, ssb * rb * sf, zero)
    found = add & s_found
    comp = torch.where(is_sun, torch.full_like(zero, 0.05), torch.full_like(zero, 0.02))
    apply_comp = nee & found & ~done
    pr, pg, pb = (torch.where(apply_comp, c * comp, torch.where(nee & ~found, zero, c)) for c in (pr, pg, pb))

    # ---- depth and Russian roulette
    spec_even = spec & (s["depth"] % 2 == 0)
    depth_eff = s["depth"] - spec_even.to(I64)
    depth = torch.where(active, depth_eff + 1, s["depth"])
    rr_active = active & ~done & ~scattered & (depth_eff > 2)
    lum = 0.2126 * pr + 0.7152 * pg + 0.0722 * pb
    q = torch.clamp(1.0 - lum, min=0.05)
    r_rr, seed = hashes.rnd(seed)
    killed = rr_active & (r_rr < q)
    one_q = 1.0 - q
    pr, pg, pb = (torch.where(killed, zero, torch.where(rr_active, div(c, one_q), c)) for c in (pr, pg, pb))
    done = done | killed

    return dict(depth=depth, pos=(new_px, new_py, new_pz), dir=(new_ddx, new_ddy, new_ddz),
                medium=medium, seed=seed, ray_color=(rr, rg, rb), pixel_color=(pr, pg, pb),
                albedo=(ar, ag, ab), normal=(nr, ng, nb), needs_first=needs_first, done=done,
                scattered=scattered, scatter_pos=scatter_pos, scatter_factor=scatter_factor,
                fog_color=(fcr, fcg, fcb), fog_factor=fog_factor)


def render_sample_plain(scene: Scene, cam, params: SkyParams, height: int, width: int,
                        frame_id: int, row0: int = 0, full_height: int | None = None,
                        col0: int = 0, full_width: int | None = None, exact: bool = False):
    """Plain version of K11 on any device -> (color, albedo, normal, depth, steps)."""
    full_height = height if full_height is None else full_height
    full_width = width if full_width is None else full_width
    s = _init_state(cam, height, width, frame_id, row0, full_height, col0, full_width)
    tabs = plain_tables(scene.device)
    z = torch.zeros((height, width), dtype=I64, device=scene.device)
    sink = {"steps_primary": z, "steps_bounce": z.clone(), "steps_shadow": z.clone(), "rays": z.clone()}
    s = _bounce(scene, params, s, True, exact, tabs, sink)
    it = 1
    while it < MAX_LOOP_ITERS and bool(_active_of(s).any()):
        s = _bounce(scene, params, s, False, exact, tabs, sink)
        it += 1
    pr, pg, pb = s["pixel_color"]
    fcr, fcg, fcb = s["fog_color"]
    ff = s["fog_factor"]
    color = torch.stack([pr + (fcr - pr) * ff, pg + (fcg - pg) * ff, pb + (fcb - pb) * ff], dim=-1)
    steps = torch.stack([sink["steps_primary"], sink["steps_bounce"], sink["steps_shadow"],
                         sink["rays"]], dim=-1).to(I32)
    return (color, torch.stack(s["albedo"], dim=-1), torch.stack(s["normal"], dim=-1),
            sink["depth"], steps)
