"""Plain PyTorch version of the GLM-compatible noise library (f32 throughout).

Port of ``mega_minecraft_tpu/ops/noise.py:33-430`` in exact mode: the correctly
rounded divide / sqrt of the reference's exact mode are IEEE ``/`` and ``sqrt``, and
simplex3's ``strict_sum`` sites are plain left-to-right sums.  Every function is
elementwise over broadcastable f32 tensors.  The CUDA twin is ``csrc/mmt_math.cuh``.
"""

from __future__ import annotations

import torch

from .hashes import div, f32, fract, rand2_from2, rand3_from2, rand3_from3

_FLT_MAX = float(torch.finfo(torch.float32).max)


def smoothstep(edge0, edge1, x):
    """GLM smoothstep; edges may be tensors or numbers (descending edges allowed)."""
    x = f32(x)
    e0 = f32(edge0, x)
    e1 = f32(edge1, x)
    t = torch.clamp(div(x - e0, e1 - e0), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def _mod289(x):
    return x - torch.floor(x * (1.0 / 289.0)) * 289.0


def _glm_mod289_lattice(x):
    """Floored integer mod 289 of an integer-valued f32 lattice coordinate."""
    return torch.remainder(x.to(torch.int32), 289).to(torch.float32)


def _permute(x):
    return _mod289((x * 34.0 + 1.0) * x)


def _taylor_inv_sqrt(r):
    return 1.79284291400159 - 0.85373472095314 * r


def _step(cond):
    return torch.where(cond, 1.0, 0.0).to(torch.float32)


def simplex2(px, py):
    """2D simplex noise, GLM-compatible."""
    px, py = f32(px), f32(py)
    Cx = 0.211324865405187
    Cy = 0.366025403784439
    Cz = -0.577350269189626
    Cw = 0.024390243902439

    s = px * Cy + py * Cy
    ix = torch.floor(px + s)
    iy = torch.floor(py + s)
    t = ix * Cx + iy * Cx
    x0x = px - ix + t
    x0y = py - iy + t

    gt = x0x > x0y
    i1x = _step(gt)
    i1y = 1.0 - i1x

    x12x = x0x + Cx - i1x
    x12y = x0y + Cx - i1y
    x12z = x0x + Cz
    x12w = x0y + Cz

    imx = _glm_mod289_lattice(ix)
    imy = _glm_mod289_lattice(iy)

    p0 = _permute(_permute(imy) + imx)
    p1 = _permute(_permute(imy + i1y) + imx + i1x)
    p2 = _permute(_permute(imy + 1.0) + imx + 1.0)

    m0 = torch.clamp_min(0.5 - (x0x * x0x + x0y * x0y), 0.0)
    m1 = torch.clamp_min(0.5 - (x12x * x12x + x12y * x12y), 0.0)
    m2 = torch.clamp_min(0.5 - (x12z * x12z + x12w * x12w), 0.0)
    m0 = m0 * m0
    m0 = m0 * m0
    m1 = m1 * m1
    m1 = m1 * m1
    m2 = m2 * m2
    m2 = m2 * m2

    def grad(p):
        x = 2.0 * fract(p * Cw) - 1.0
        h = torch.abs(x) - 0.5
        a0 = x - torch.floor(x + 0.5)
        return a0, h

    a00, h0 = grad(p0)
    a01, h1 = grad(p1)
    a02, h2 = grad(p2)

    m0 = m0 * _taylor_inv_sqrt(a00 * a00 + h0 * h0)
    m1 = m1 * _taylor_inv_sqrt(a01 * a01 + h1 * h1)
    m2 = m2 * _taylor_inv_sqrt(a02 * a02 + h2 * h2)

    g0 = a00 * x0x + h0 * x0y
    g1 = a01 * x12x + h1 * x12y
    g2 = a02 * x12z + h2 * x12w
    return 130.0 * (m0 * g0 + m1 * g1 + m2 * g2)


def simplex3(px, py, pz):
    """3D simplex noise, GLM-compatible (skew sums left to right, as glm)."""
    px, py, pz = f32(px), f32(py), f32(pz)
    C_x = 1.0 / 6.0
    C_y = 1.0 / 3.0

    s = px * C_y + py * C_y + pz * C_y
    ix = torch.floor(px + s)
    iy = torch.floor(py + s)
    iz = torch.floor(pz + s)
    t = ix * C_x + iy * C_x + iz * C_x
    x0x = px - ix + t
    x0y = py - iy + t
    x0z = pz - iz + t

    gx = _step(x0x >= x0y)
    gy = _step(x0y >= x0z)
    gz = _step(x0z >= x0x)
    lx = 1.0 - gx
    ly = 1.0 - gy
    lz = 1.0 - gz
    i1x = torch.minimum(gx, lz)
    i1y = torch.minimum(gy, lx)
    i1z = torch.minimum(gz, ly)
    i2x = torch.maximum(gx, lz)
    i2y = torch.maximum(gy, lx)
    i2z = torch.maximum(gz, ly)

    x1x = x0x - i1x + C_x
    x1y = x0y - i1y + C_x
    x1z = x0z - i1z + C_x
    x2x = x0x - i2x + C_y
    x2y = x0y - i2y + C_y
    x2z = x0z - i2z + C_y
    x3x = x0x - 0.5
    x3y = x0y - 0.5
    x3z = x0z - 0.5

    ix = _mod289(ix)
    iy = _mod289(iy)
    iz = _mod289(iz)

    pz0 = _permute(iz)
    pz1 = _permute(iz + i1z)
    pz2 = _permute(iz + i2z)
    pz3 = _permute(iz + 1.0)
    py0 = _permute(pz0 + iy)
    py1 = _permute(pz1 + iy + i1y)
    py2 = _permute(pz2 + iy + i2y)
    py3 = _permute(pz3 + iy + 1.0)
    p0 = _permute(py0 + ix)
    p1 = _permute(py1 + ix + i1x)
    p2 = _permute(py2 + ix + i2x)
    p3 = _permute(py3 + ix + 1.0)

    # ns = n_ * D.wyz - D.xzx with n_ = 1/7, D = (0, 0.5, 1, 2), each in f32
    n_ = f32(0.142857142857)
    ns_x = (n_ * 2.0 - 0.0).item()
    ns_y = (n_ * 0.5 - 1.0).item()
    ns_z = (n_ * 1.0 - 0.0).item()

    def gradcorner(p):
        j = p - 49.0 * torch.floor(p * ns_z * ns_z)
        x_ = torch.floor(j * ns_z)
        y_ = torch.floor(j - 7.0 * x_)
        x = x_ * ns_x + ns_y
        y = y_ * ns_x + ns_y
        h = 1.0 - torch.abs(x) - torch.abs(y)
        sx = torch.floor(x) * 2.0 + 1.0
        sy = torch.floor(y) * 2.0 + 1.0
        sh = -_step(h <= 0.0)
        return x + sx * sh, y + sy * sh, h

    g0x, g0y, g0z = gradcorner(p0)
    g1x, g1y, g1z = gradcorner(p1)
    g2x, g2y, g2z = gradcorner(p2)
    g3x, g3y, g3z = gradcorner(p3)

    n0 = _taylor_inv_sqrt(g0x * g0x + g0y * g0y + g0z * g0z)
    n1 = _taylor_inv_sqrt(g1x * g1x + g1y * g1y + g1z * g1z)
    n2 = _taylor_inv_sqrt(g2x * g2x + g2y * g2y + g2z * g2z)
    n3 = _taylor_inv_sqrt(g3x * g3x + g3y * g3y + g3z * g3z)

    m0 = torch.clamp_min(0.6 - (x0x * x0x + x0y * x0y + x0z * x0z), 0.0)
    m1 = torch.clamp_min(0.6 - (x1x * x1x + x1y * x1y + x1z * x1z), 0.0)
    m2 = torch.clamp_min(0.6 - (x2x * x2x + x2y * x2y + x2z * x2z), 0.0)
    m3 = torch.clamp_min(0.6 - (x3x * x3x + x3y * x3y + x3z * x3z), 0.0)
    m0 = m0 * m0
    m1 = m1 * m1
    m2 = m2 * m2
    m3 = m3 * m3

    d0 = (g0x * n0) * x0x + (g0y * n0) * x0y + (g0z * n0) * x0z
    d1 = (g1x * n1) * x1x + (g1y * n1) * x1y + (g1z * n1) * x1z
    d2 = (g2x * n2) * x2x + (g2y * n2) * x2y + (g2z * n2) * x2z
    d3 = (g3x * n3) * x3x + (g3y * n3) * x3y + (g3z * n3) * x3z
    return 42.0 * (m0 * m0 * d0 + m1 * m1 * d1 + m2 * m2 * d2 + m3 * m3 * d3)


def fbm2(px, py, octaves: int = 5):
    px, py = f32(px), f32(py)
    total = None
    amplitude = 1.0
    for _ in range(octaves):
        amplitude *= 0.5
        term = amplitude * simplex2(px, py)
        total = term if total is None else total + term
        px = px * 2.0
        py = py * 2.0
    return total


def fbm3(px, py, pz, octaves: int = 5):
    px, py, pz = f32(px), f32(py), f32(pz)
    total = None
    amplitude = 1.0
    for _ in range(octaves):
        amplitude *= 0.5
        term = amplitude * simplex3(px, py, pz)
        total = term if total is None else total + term
        px = px * 2.0
        py = py * 2.0
        pz = pz * 2.0
    return total


def simplex2_from2(px, py):
    return simplex2(px, py), simplex2(px + 5923.45, py + 4129.42)


def fbm2_from2(px, py, octaves: int = 5):
    return fbm2(px, py, octaves), fbm2(px + 5923.45, py + 4129.42, octaves)


def fbm3_from3(px, py, pz, octaves: int = 5):
    return (
        fbm3(px, py, pz, octaves),
        fbm3(px + 5923.45, py + 4129.42, pz + 5790.48, octaves),
        fbm3(px + 1765.68, py + 4704.36, pz + 5692.12, octaves),
    )


def _update_min2(d, min1, min2):
    is1 = d < min1
    is2 = ~is1 & (d < min2)
    min2 = torch.where(is1, min1, torch.where(is2, d, min2))
    min1 = torch.where(is1, d, min1)
    return is1, min1, min2


def worley2(px, py, want_color: bool = False, want_edge: bool = False):
    """2D Worley: dict with 'f1' and optionally 'color' (3-tuple), 'edge'."""
    px, py = f32(px), f32(py)
    ix, iy = torch.floor(px), torch.floor(py)
    fx, fy = px - ix, py - iy
    min1 = torch.full_like(px, _FLT_MAX)
    min2 = min1
    cpx = torch.zeros_like(px)
    cpy = torch.zeros_like(px)
    for ox in (-1, 0, 1):
        for oy in (-1, 0, 1):
            rx, ry = rand2_from2(ix + float(ox), iy + float(oy))
            dx = float(ox) + rx - fx
            dy = float(oy) + ry - fy
            d = torch.sqrt(dx * dx + dy * dy)
            is1, min1, min2 = _update_min2(d, min1, min2)
            cpx = torch.where(is1, rx, cpx)
            cpy = torch.where(is1, ry, cpy)
    out = {"f1": min1}
    if want_color:
        out["color"] = rand3_from2(cpx, cpy)
    if want_edge:
        out["edge"] = (min2 - min1) * 0.5
    return out


def worley3(px, py, pz, want_color: bool = False, want_edge: bool = False):
    """3D Worley: dict with 'f1' and optionally 'color' (3-tuple), 'edge'."""
    px, py, pz = f32(px), f32(py), f32(pz)
    ix, iy, iz = torch.floor(px), torch.floor(py), torch.floor(pz)
    fx, fy, fz = px - ix, py - iy, pz - iz
    min1 = torch.full_like(px, _FLT_MAX)
    min2 = min1
    cpx = torch.zeros_like(px)
    cpy = torch.zeros_like(px)
    cpz = torch.zeros_like(px)
    for ox in (-1, 0, 1):
        for oy in (-1, 0, 1):
            for oz in (-1, 0, 1):
                rx, ry, rz = rand3_from3(ix + float(ox), iy + float(oy), iz + float(oz))
                dx = float(ox) + rx - fx
                dy = float(oy) + ry - fy
                dz = float(oz) + rz - fz
                d = torch.sqrt(dx * dx + dy * dy + dz * dz)
                is1, min1, min2 = _update_min2(d, min1, min2)
                cpx = torch.where(is1, rx, cpx)
                cpy = torch.where(is1, ry, cpy)
                cpz = torch.where(is1, rz, cpz)
    out = {"f1": min1}
    if want_color:
        out["color"] = rand3_from3(cpx, cpy, cpz)
    if want_edge:
        out["edge"] = (min2 - min1) * 0.5
    return out


def special_cave_noise(px, py, pz):
    """3-min-distance Worley ratio: min3 / min1 - 1 (noise.py:396-430)."""
    px, py, pz = f32(px), f32(py), f32(pz)
    ix, iy, iz = torch.floor(px), torch.floor(py), torch.floor(pz)
    fx, fy, fz = px - ix, py - iy, pz - iz
    min1 = torch.full_like(px, _FLT_MAX)
    min2 = min1
    min3 = min1
    for ox in (-1, 0, 1):
        for oy in (-1, 0, 1):
            for oz in (-1, 0, 1):
                rx, ry, rz = rand3_from3(ix + float(ox), iy + float(oy), iz + float(oz))
                dx = float(ox) + rx - fx
                dy = float(oy) + ry - fy
                dz = float(oz) + rz - fz
                d = torch.sqrt(dx * dx + dy * dy + dz * dz)
                is1 = d < min1
                is2 = ~is1 & (d < min2)
                is3 = ~is1 & ~is2 & (d < min3)
                min3 = torch.where(is1 | is2, min2, torch.where(is3, d, min3))
                min2 = torch.where(is1, min1, torch.where(is2, d, min2))
                min1 = torch.where(is1, d, min1)
    return div(min3, min1) - 1.0
