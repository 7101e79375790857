"""Debug renderer: direct-light Lambert + shadowing + volumetric fog + bloom.

Port of ``mega_minecraft_tpu/render/debug_renderer.py`` (the reference's OpenGL debug
rasterizer, renderer.cpp:19-523 behind DEBUG_USE_GL_RENDERER: a shadow map, Lambert
sun / moon / ambient shading, a procedural sky, froxel fog, bloom and ACES).  As in JAX
the rasterizer is replaced by the engine's voxel DDA: per pixel one primary trace, one
shadow trace toward the sun (the moon at night) and eight shadow traces along the
primary ray for the fog's in-scatter; then a bright pass (luminance > 1) through five
separable 9-tap Gaussian passes at strides 1-16, added at 0.35.  The frame is
deterministic: no jitter, no random draw.  ``tint`` overlays a colour per chunk (16
blocks) or per zone (192 blocks), the reference's CHUNK_COLOR / ZONE_COLOR.

``render_debug`` dispatches on the scene's device: CUDA launches K17
(``csrc/debug.cu``: one thread per pixel for the ten traces, the shading, the fog and
the bright pass, then ten blur launches, under one launch count) or raises; the CPU
runs ``render_debug_plain``, which keeps JAX's whole-image form and operation order.
The blur wraps around the frame's borders (``roll``), as JAX's does.  Each lane has its
own DDA step budget, where JAX's counter is global: they differ only for a lane parked by
exact alpha cutout, which the procedural atlas never flags, so no pixel moves here.
"""

from __future__ import annotations

import torch

from ..ops.hashes import div
from ..world.blocks import Block
from . import sky as sky_mod
from .brickmap import Scene
from .camera import pixel_rays
from .materials import plain_tables, unpack_props
from .sky import SkyParams, smoothstep
from .tracer import MAX_TRACE_STEPS, _check_params, trace_plain

F32 = torch.float32
U8 = torch.uint8
AIR = int(Block.AIR)

FOG_DENSITY = 0.004
FOG_SAMPLES = 8
BLOOM_THRESHOLD = 1.0
BLOOM_PASSES = 5
#: bloom_blur.frag.glsl's weights: the centre tap, then taps 1-4 on each side
BLOOM_WEIGHTS = (0.227027, 0.1945946, 0.1216216, 0.054054, 0.016216)
BLOOM_STRENGTH = 0.35
#: tint -> cell size in blocks (0: no tint)
TINT_CELLS = {"none": 0, "chunk": 16, "zone": 16 * 12}


def _gauss_blur(img, stride: int):
    """Separable 9-tap Gaussian over [H, W, 3] at ``stride``, wrapping at the borders."""
    w = BLOOM_WEIGHTS
    out = img * w[0]
    for i in range(1, 5):
        out = out + (torch.roll(img, i * stride, 1) + torch.roll(img, -i * stride, 1)) * w[i]
    img = out
    out = img * w[0]
    for i in range(1, 5):
        out = out + (torch.roll(img, i * stride, 0) + torch.roll(img, -i * stride, 0)) * w[i]
    return out


def _tint_cell(tint: str) -> int:
    if tint not in TINT_CELLS:
        raise ValueError(f"tint must be one of {sorted(TINT_CELLS)}, not {tint!r}")
    return TINT_CELLS[tint]


def render_debug(scene: Scene, cam, params: SkyParams, height: int, width: int, tint: str = "none"):
    """One deterministic direct-light frame -> [height, width, 3] f32 linear HDR.

    tint: 'none' | 'chunk' | 'zone'.  CUDA scene: K17; CPU scene: the plain version."""
    cell = _tint_cell(tint)
    _check_params(scene, cam, params)
    if scene.device.type == "cuda":
        from .. import kernels

        return kernels.render_debug(scene, cam, params, height, width, cell)[0]
    from ..kernels import require_cpu

    require_cpu(scene.flat)
    return render_debug_plain(scene, cam, params, height, width, tint)


def render_debug_plain(scene: Scene, cam, params: SkyParams, height: int, width: int,
                       tint: str = "none", want_steps: bool = False):
    """Plain version of K17 on any device (debug_renderer.py:57-163).  With
    ``want_steps`` also the DDA steps each pixel's traces took [height, width] i32 (the
    shadow trace runs only where the primary ray hit, the one place its result is read)."""
    cell = _tint_cell(tint)
    dev = scene.device
    shape = (height, width)
    z = torch.zeros(shape, dtype=F32, device=dev)
    dx, dy, dz = pixel_rays(cam, width, height, (z, z))
    pos = tuple(cam.position[i].expand(shape) for i in range(3))
    air = torch.full(shape, AIR, dtype=U8, device=dev)

    res, steps = trace_plain(scene, *pos, dx, dy, dz, air, MAX_TRACE_STEPS, want_steps=True)
    hit = res.hit & (res.block != AIR)
    isx = pos[0] + dx * res.t
    isy = pos[1] + dy * res.t
    isz = pos[2] + dz * res.t

    props = plain_tables(dev)["props"][res.block.to(torch.int64)]
    col_r, col_g, col_b, _mat, emis = unpack_props(props)

    # tint overlays (lambert.frag.glsl:98-108); a divisor on the card stays a division
    if cell:
        cx = torch.floor(div(isx, float(cell)))
        cz = torch.floor(div(isz, float(cell)))
        h = sky_mod._rand3_from3_r(cx, cz, cx + cz)
        col_r = col_r * (0.5 + 0.5 * h[0])
        col_g = col_g * (0.5 + 0.5 * h[1])
        col_b = col_b * (0.5 + 0.5 * h[2])

    # sun (or moon at night) shadow ray from the hit point
    sun, moon = params.sun_dir, params.moon_dir
    use_sun = sun[1] > 0.0
    ldir = torch.where(use_sun, sun, moon)
    lx, ly, lz = (ldir[k].expand(shape) for k in range(3))
    eps = 1e-3
    sres, sst = trace_plain(scene, isx + res.nx * eps, isy + res.ny * eps, isz + res.nz * eps, lx, ly, lz,
                            air, MAX_TRACE_STEPS, active=hit, want_steps=True)
    steps = steps + sst
    lit = ~sres.hit

    ndotl = torch.clamp(res.nx * lx + res.ny * ly + res.nz * lz, min=0.0)
    sun_i = torch.where(use_sun, 1.0, 0.12)
    light_strength = smoothstep(-0.1, 0.1, torch.where(use_sun, sun[1], moon[1]).abs())
    ambient = 0.22 + 0.18 * smoothstep(-0.25, 0.10, sun[1])
    direct = torch.where(lit, ndotl * sun_i * light_strength, 0.0)
    shade = ambient + direct + emis * 4.0
    r, g, b = col_r * shade, col_g * shade, col_b * shade

    # sky for misses
    (skr, skg, skb), _ = sky_mod.sky_color(dx, dy, dz, params, origin=pos, first_hit=~hit)
    r = torch.where(hit, r, skr)
    g = torch.where(hit, g, skg)
    b = torch.where(hit, b, skb)

    # volumetric fog: shadowed in-scatter samples along the primary ray
    t_end = torch.where(hit, res.t, 300.0)
    in_scatter = torch.zeros(shape, dtype=F32, device=dev)
    for k in range(FOG_SAMPLES):
        tk = t_end * ((k + 0.5) / FOG_SAMPLES)
        fx, fy, fz = pos[0] + dx * tk, pos[1] + dy * tk, pos[2] + dz * tk
        fsh, fst = trace_plain(scene, fx, fy, fz, lx, ly, lz, air, MAX_TRACE_STEPS, want_steps=True)
        steps = steps + fst
        dens = torch.exp(-torch.clamp(fy - 128.0, min=0.0) * 0.01)
        in_scatter = in_scatter + torch.where(fsh.hit, 0.0, dens) / float(FOG_SAMPLES)
    fog_amount = 1.0 - torch.exp(-t_end * FOG_DENSITY)
    fog_amount = fog_amount * (0.35 + 0.65 * in_scatter) * light_strength
    (fr, fg, fb), _ = sky_mod.sky_color(dx, dy.abs() * 0 + 0.05, dz, params)
    r = r + (fr - r) * fog_amount
    g = g + (fg - g) * fog_amount
    b = b + (fb - b) * fog_amount

    img = torch.stack([r, g, b], dim=-1)

    # bloom: bright pass + widening Gaussian pings (postprocess_1 + bloom_blur)
    lum = 0.2126 * r + 0.7152 * g + 0.0722 * b
    blur = torch.where((lum > BLOOM_THRESHOLD)[..., None], img, 0.0)
    for p in range(BLOOM_PASSES):
        blur = _gauss_blur(blur, 1 << p)
    out = img + blur * BLOOM_STRENGTH
    return (out, steps) if want_steps else out
