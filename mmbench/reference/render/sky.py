"""Procedural sky: sun and moon disks with halos, Worley-cell stars, an fBm cloud march,
the sunset band and the day/night base colour, on the renderer's own Perlin noise.

Port of ``mega_minecraft_tpu/render/sky.py:25-338`` (the reference's getSkyColor /
getStarsColor / getCloudCoverage / pnoise, basic_shaders.cu:148-556, and the sun clock
of optixRenderer.cpp:878-900).  Plain PyTorch versions, elementwise over ray-direction
component tensors; ``csrc/sky.cuh`` is their CUDA twin, inlined into K11.  Constant
expressions are folded in f32 as numpy folds the JAX original's ``F32`` scalars, and
divisions go through tensors on the operand's device (``hashes.div``), so that the
plain version and the kernel round alike on the card.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.hashes import div

F32 = torch.float32
I64 = torch.int64
M32 = 0xFFFFFFFF


def f(x) -> float:
    """A Python float holding f32(x) (numpy folds the JAX original's F32 scalars)."""
    return float(np.float32(x))


def _fade(t):
    return t * t * t * (t * (t * 6.0 - 15.0) + 10.0)


def _grad(h, x, y, z):
    h = h & 15
    u = torch.where(h < 8, x, y)
    v = torch.where(h < 4, y, torch.where((h == 12) | (h == 14), x, z))
    return torch.where((h & 1) == 0, u, -u) + torch.where((h & 2) == 0, v, -v)


def _lattice_hash(ix, iy, iz):
    """Gather-free integer lattice hash (sky.py:40-59), u32 arithmetic in int64."""
    h = ((ix & M32) * 0x8DA6B343 + (iy & M32) * 0xD8163841 + (iz & M32) * 0xCB1AB31F) & M32
    h = h ^ (h >> 13)
    h = (h * 0x9E3779B1) & M32
    return h ^ (h >> 16)


def pnoise(px, py, pz):
    """Classic Perlin noise structure with the hash-based lattice."""
    xf, yf, zf = torch.floor(px), torch.floor(py), torch.floor(pz)
    X, Y, Z = xf.to(I64), yf.to(I64), zf.to(I64)
    x, y, z = px - xf, py - yf, pz - zf
    u, v, w = _fade(x), _fade(y), _fade(z)

    def lerp(t, a, b):
        return a + t * (b - a)

    def g(a, b, c):
        return _grad(_lattice_hash(X + a, Y + b, Z + c), x - a, y - b, z - c)

    return lerp(w,
                lerp(v, lerp(u, g(0, 0, 0), g(1, 0, 0)), lerp(u, g(0, 1, 0), g(1, 1, 0))),
                lerp(v, lerp(u, g(0, 0, 1), g(1, 0, 1)), lerp(u, g(0, 1, 1), g(1, 1, 1))))


def fbm_p(px, py, pz, octaves: int = 5):
    """Renderer-side fBm over pnoise (basic_shaders.cu:306-320)."""
    total = None
    amplitude = 1.0
    for _ in range(octaves):
        amplitude *= 0.5
        term = amplitude * pnoise(px, py, pz)
        total = term if total is None else total + term
        px, py, pz = px * 2.0, py * 2.0, pz * 2.0
    return total


def smoothstep(e0, e1, x):
    t = torch.clamp(div(x - f(e0), f(np.float32(e1) - np.float32(e0))), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def linearstep(e0, e1, x):
    return torch.clamp(div(x - f(e0), f(np.float32(e1) - np.float32(e0))), 0.0, 1.0)


def _fract(x):
    return x - torch.floor(x)


def _sin_hash(d):
    return _fract(torch.sin(d) * 58293.492)


def _rand1_from3_r(px, py, pz):
    """Renderer-side sin hash (basic_shaders.cu:336-340)."""
    return _sin_hash(px * 185.3 + py * 563.9 + pz * 887.2)


def _rand3_from3_r(px, py, pz):
    return (_sin_hash(px * 185.3 + py * 563.9 + pz * 887.2),
            _sin_hash(px * 593.1 + py * 591.2 + pz * 402.1),
            _sin_hash(px * 938.2 + py * 723.4 + pz * 768.9))


class SkyParams(NamedTuple):
    """Sun / moon / star state."""

    sun_dir: torch.Tensor  # [3] f32
    moon_dir: torch.Tensor  # [3]
    stars_rot: torch.Tensor  # [3, 3] inverse sun rotation
    time: torch.Tensor  # [] f32


_SUN_AXIS_FORWARD = np.array([6.0, -2.0, 2.0]) / np.linalg.norm([6.0, -2.0, 2.0])
_SUN_AXIS_RIGHT = np.cross(_SUN_AXIS_FORWARD, [0.0, 1.0, 0.0])
_SUN_AXIS_RIGHT /= np.linalg.norm(_SUN_AXIS_RIGHT)
_SUN_AXIS_UP = np.cross(_SUN_AXIS_RIGHT, _SUN_AXIS_FORWARD)
_SUN_AXIS_UP /= np.linalg.norm(_SUN_AXIS_UP)


def sky_params(sun_time, time, device="cuda") -> SkyParams:
    """Sun clock (optixRenderer.cpp:878-900): sunTime advances at −0.025 rad/s."""
    dev = torch.device(device)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)  # noqa: E731
    st = t(sun_time)
    fwd, right0, up0 = t(_SUN_AXIS_FORWARD), t(_SUN_AXIS_RIGHT), t(_SUN_AXIS_UP)
    rot_right = torch.cos(st) * right0 + torch.sin(st) * up0
    rot_up = torch.linalg.cross(rot_right, fwd)
    rot_up = rot_up / torch.linalg.norm(rot_up)
    m = torch.stack([rot_right, fwd, rot_up], dim=1)  # columns

    def app(v):
        r = m @ t(v)
        return r / torch.linalg.norm(r)

    return SkyParams(sun_dir=app([1.0, 0.15, 0.0]), moon_dir=app([-1.0, 0.50, 0.0]),
                     stars_rot=m.T.contiguous(), time=t(time))


def _stars_color(dx, dy, dz):
    """getStarsColor (basic_shaders.cu:355-398)."""
    ux, uy, uz = dx * 30.0, dy * 30.0, dz * 30.0
    ix, iy, iz = torch.floor(ux), torch.floor(uy), torch.floor(uz)
    rx, ry, rz = _rand3_from3_r(ix, iy, iz)
    px, py, pz = 0.1 + 0.9 * rx, 0.1 + 0.9 * ry, 0.1 + 0.9 * rz
    dxx, dyy, dzz = px - (ux - ix), py - (uy - iy), pz - (uz - iz)
    dist = torch.sqrt(dxx * dxx + dyy * dyy + dzz * dzz)
    rand = _rand1_from3_r(px, py, pz)
    brightness = smoothstep(0.08, 0.05, dist)

    def pal(r, c):
        full = lambda v: torch.full_like(r, v)  # noqa: E731
        return torch.where(r < 0.35, full(c[0]), torch.where(r < 0.70, full(c[1]), torch.where(
            r < 0.82, full(c[2]), torch.where(r < 0.94, full(c[3]), full(c[4])))))

    s = brightness * 3.0
    return (pal(rand, (1.000, 0.929, 0.482, 1.000, 1.000)) * s,
            pal(rand, (0.863, 0.984, 0.816, 0.663, 0.455)) * s,
            pal(rand, (0.333, 1.000, 1.000, 0.271, 0.282)) * s)


def _clouds_noise(cx, cy, cz, time):
    """sampleCloudsNoise (basic_shaders.cu:400-407)."""
    n1 = pnoise(cx - 962.43, cy - 962.43, cz - 962.43) * 0.01
    n2 = pnoise(cx * 254.32, cy * 254.32, cz * 254.32) * 0.01
    bt = lambda v: v.expand_as(cx)  # noqa: E731
    cn = (fbm_p(cx * 0.05 + n1, cz * 0.05 + n2, bt(time * 0.015), octaves=3) + 1.0) * 0.5
    cn = cn + fbm_p(cx * 0.15 - 325.32, cz * 0.15 + 613.58, bt(time * 0.040), octaves=3) * 0.3
    cn = cn * (pnoise(cx * 0.03 + 821.23, cz * 0.03 - 721.33, bt(time * 0.003 + 276.21)) + 1.0) * 0.9
    return smoothstep(0.35, 0.75, cn - 0.01 * cy)


def cloud_coverage(pos, dx, dy, dz, params: SkyParams):
    """getCloudCoverage (basic_shaders.cu:410-433); pos: (x, y, z) tensors."""
    t = div(torch.full_like(dy, 20.0), dy)
    cx = dx * t + pos[0] * 0.01 + 0.3 * params.time
    cy = torch.zeros_like(dx)
    cz = dz * t + pos[2] * 0.01 + 0.6 * params.time
    coverage = torch.zeros_like(dx)
    for i in range(12):
        step = f(0.2 * i)
        cx = cx + dx * step
        cy = cy + dy * step
        cz = cz + dz * step
        coverage = coverage + _clouds_noise(cx, cy, cz, params.time) * step
    coverage = torch.clamp(coverage * 0.1, max=1.0)
    return torch.where(dy < 0.04, torch.zeros_like(dy), coverage)


def sky_color(dx, dy, dz, params: SkyParams, origin=None, first_hit=None,
              include_stars: bool = True, coverage=None):
    """getSkyColor (basic_shaders.cu:436-556).

    dx/dy/dz: ray direction components; origin: (x, y, z) ray-origin tensors (clouds,
    with ``first_hit``, the bool mask of rays that still need first-hit data: clouds
    and stars render only for those); ``coverage``: the cloud coverage if the caller
    already has it (``cloud_coverage`` on the same rays).  Returns ((r, g, b),
    found_light) where found_light marks sun / moon disk hits."""
    sun, moon = params.sun_dir, params.moon_dir
    sun_y = sun[1]
    zero = torch.zeros_like(dy)

    entire = smoothstep(-0.4, 0.2, dy)
    base_strength = 0.04 + 0.96 * smoothstep(-0.25, 0.10, sun_y)
    ground = (0.5 * base_strength, f(np.float32(0.8) * np.float32(0.5)) * base_strength,
              f(np.float32(0.65) * np.float32(0.5)) * base_strength)
    r, g, b = zero, zero, zero

    sun_strength = smoothstep(-0.5, -0.2, sun_y)
    sun_d = dx * sun[0] + dy * sun[1] + dz * sun[2]
    is_body = torch.zeros_like(dy, dtype=torch.bool)

    if include_stars:
        sun_color_mod = smoothstep(-0.05, 0.40, sun_y)
        scr = 1.20
        scg = 0.05 + 0.70 * sun_color_mod
        scb = 0.42 * sun_color_mod
        halo = smoothstep(0.05, 0.20, sun_y) * 0.4
        hs = smoothstep(0.98, 0.9975, sun_d)
        halo_f = hs * hs * hs * halo
        disk = sun_d > 0.995
        one_m = 1.0 - sun_d
        disk_f = torch.where(disk, (1.0 - 5000.0 * (one_m * one_m)) * (0.3 + 0.7 * sun_color_mod) * 45.0,
                             zero)
        active = (sun_strength > 0.0) & (sun_d > 0.98)
        r = r + torch.where(active, (halo_f * (scr + 0.0) + disk_f * scr) * sun_strength, zero)
        g = g + torch.where(active, (halo_f * (scg + 0.1) + disk_f * scg) * sun_strength, zero)
        b = b + torch.where(active, (halo_f * (scb + 0.1) + disk_f * scb) * sun_strength, zero)
        is_body = is_body | (active & disk)

        moon_strength = smoothstep(-0.5, -0.2, moon[1])
        moon_d = dx * moon[0] + dy * moon[1] + dz * moon[2]
        mcr, mcg, mcb = f(0.6 * 0.3), f(0.7 * 0.3), f(1.0 * 0.3)
        mhalo = smoothstep(0.05, 0.20, moon[1]) * 0.2
        ms = smoothstep(0.985, 0.9983, moon_d)
        mhalo_f = ms * ms * ms * mhalo
        mdisk = moon_d > 0.997
        mdisk_f = torch.where(mdisk, torch.full_like(dy, 24.0), zero)
        mactive = (moon_strength > 0.0) & (moon_d > 0.985)
        r = r + torch.where(mactive, (mhalo_f * mcr + mdisk_f * mcr) * moon_strength, zero)
        g = g + torch.where(mactive, (mhalo_f * mcg + mdisk_f * mcg) * moon_strength, zero)
        b = b + torch.where(mactive, (mhalo_f * f(np.float32(mcb) + np.float32(0.15))
                                      + mdisk_f * mcb) * moon_strength, zero)
        is_body = is_body | (mactive & mdisk)

    # base colour + stars
    base_lerp = smoothstep(0.15, -0.15, dy) * 0.14
    sbr = 0.10 + f(np.float32(0.8) - np.float32(0.10)) * base_lerp
    sbg = 0.16 + f(np.float32(0.8) - np.float32(0.16)) * base_lerp
    sbb = 0.20 + f(np.float32(1.0) - np.float32(0.20)) * base_lerp
    not_body = ~is_body
    r = r + torch.where(not_body, sbr * base_strength, zero)
    g = g + torch.where(not_body, sbg * base_strength, zero)
    b = b + torch.where(not_body, sbb * base_strength, zero)

    stars_strength = smoothstep(0.03, -0.22, sun_y)
    if include_stars and first_hit is not None:
        m = params.stars_rot
        sx = m[0, 0] * dx + m[0, 1] * dy + m[0, 2] * dz
        sy = m[1, 0] * dx + m[1, 1] * dy + m[1, 2] * dz
        sz = m[2, 0] * dx + m[2, 1] * dy + m[2, 2] * dz
        str_, stg, stb = _stars_color(sx, sy, sz)
        sm = not_body & first_hit
        r = r + torch.where(sm, str_ * stars_strength, zero)
        g = g + torch.where(sm, stg * stars_strength, zero)
        b = b + torch.where(sm, stb * stars_strength, zero)

    # sunrise / sunset orange band
    hd = torch.acos(torch.clamp(dx * sun[0] + dz * sun[2], -1.0, 1.0))
    orange = (smoothstep(-0.13, -0.02, sun_y) * smoothstep(0.25, 0.05, sun_y)
              * smoothstep(-2.5, 0.65, sun_d)
              * smoothstep(1.05, 0.18, dy + smoothstep(0.0, np.pi, hd) * 0.6))
    orange = torch.where((sun_strength > 0.0) & not_body, orange, zero)
    r = r + (1.40 - r) * orange
    g = g + (0.35 - g) * orange
    b = b + (0.0 - b) * orange

    # clouds, first-hit rays only
    if first_hit is not None and origin is not None:
        cov = cloud_coverage(origin, dx, dy, dz, params) if coverage is None else coverage
        cov = torch.where(first_hit, torch.clamp(cov, max=0.92), zero)
        ccr = 0.9 * torch.pow(base_strength, 1.15)
        o9 = orange * 0.9
        ccr, ccg, ccb = ccr + (1.20 - ccr) * o9, ccr + (0.30 - ccr) * o9, ccr + (0.10 - ccr) * o9
        r = r + (ccr - r) * cov
        g = g + (ccg - g) * cov
        b = b + (ccb - b) * cov

    return ((ground[0] + (r - ground[0]) * entire, ground[1] + (g - ground[1]) * entire,
             ground[2] + (b - ground[2]) * entire), is_body)
