"""Temporal reprojection: path-traced history carried across camera motion.

Port of ``mega_minecraft_tpu/render/reproject.py``.  Each new frame's first-hit world
points are projected into the previous camera, the history (colour, albedo, normal,
first-hit distance, per-pixel history length ``nsamp``) is gathered there with a 4-tap
bilinear footprint whose taps must pass a depth-consistency test, and the new 1-spp sample
is blended in as a running average over ``nsamp`` (clipped at ``N_MAX``).  Under a static
camera the history maps to itself, and only pixels whose first-hit distance moved have
their history shortened to 3.

- ``render_accumulate_temporal``: K11 (``render_sample`` with depth), then K13
  (``csrc/reproject.cu`` ``reproject_kernel``: the gather and the blend in one launch,
  into new buffers, since it reads the neighbours of the history);
- ``render_accumulate_static``: K11, then K13s (``static_blend_kernel``, pointwise).

CPU tensors take the plain versions (``reproject_history`` + ``blend``, ``static_blend``).
Both clamp the projected pixel coordinates to [-2, W + 1] / [-2, H + 1] before the integer
cast, which moves no in-bounds tap (JAX's cast saturates there; torch's is undefined).
"""

from __future__ import annotations

import torch

from . import tracer
from .camera import pixel_rays
from .tracer import DEPTH_CAP, FrameBuffers

F32 = torch.float32
I64 = torch.int64

#: history-length clip: bounds staleness while keeping ~N_MAX x variance reduction
N_MAX = 64.0
#: a history tap is valid when its stored first-hit distance matches the reprojected one
#: within max(REL_TOL * dist, ABS_TOL)
REL_TOL = 0.04
ABS_TOL = 0.75
#: the static path's soft clamp of the history length where the depth moved
STATIC_CLAMP = 3.0


def _center_dirs(cam, height: int, width: int):
    """Unjittered pixel-centre ray directions of the whole frame."""
    half = torch.full((height, width), 0.5, dtype=F32, device=cam.forward.device)
    return pixel_rays(cam, width, height, (half, half))


def reproject_history(fbs: FrameBuffers, cam_prev, cam_new, depth_new, height: int, width: int):
    """Gather (colour, albedo, normal [H, W, 3], nsamp [H, W]) history for each pixel of
    the NEW camera from the previous frame's buffers; nsamp = 0 where the history is
    invalid (off-screen, behind the previous camera, or failing the depth test).
    ``depth_new``: [H, W] first-hit distance under ``cam_new`` (DEPTH_CAP for sky)."""
    dx, dy, dz = _center_dirs(cam_new, height, width)
    d_eff = torch.clamp(depth_new, max=DEPTH_CAP)
    p, q = cam_new.position, cam_prev.position
    vx = p[0] + dx * d_eff - q[0]
    vy = p[1] + dy * d_eff - q[1]
    vz = p[2] + dz * d_eff - q[2]
    f, r, u = cam_prev.forward, cam_prev.right, cam_prev.up
    vf = vx * f[0] + vy * f[1] + vz * f[2]
    vr = vx * r[0] + vy * r[1] + vz * r[2]
    vu = vx * u[0] + vy * u[1] + vz * u[2]
    in_front = vf > 1e-3
    safe_vf = torch.where(in_front, vf, torch.ones_like(vf))
    # invert pixel_rays: d ∝ forward − right·sx − up·sy, sx = (ix − W/2 + 0.5)·plx
    px = -vr / safe_vf / cam_prev.pixel_length[0] + 0.5 * width - 0.5
    py = -vu / safe_vf / cam_prev.pixel_length[1] + 0.5 * height - 0.5
    px = torch.clamp(px, -2.0, width + 1.0)
    py = torch.clamp(py, -2.0, height + 1.0)
    dist_prev = torch.sqrt(vx * vx + vy * vy + vz * vz)
    tol = torch.clamp(REL_TOL * dist_prev, min=ABS_TOL)

    x0, y0 = torch.floor(px), torch.floor(py)
    fx, fy = px - x0, py - y0
    x0i, y0i = x0.to(I64), y0.to(I64)
    hist = torch.cat([fbs.color, fbs.albedo, fbs.normal,
                      torch.clamp(fbs.depth, max=DEPTH_CAP)[..., None], fbs.nsamp[..., None]],
                     dim=-1).reshape(height * width, 11)
    acc = torch.zeros((height, width, 11), dtype=F32, device=vx.device)
    wsum = torch.zeros((height, width), dtype=F32, device=vx.device)
    for ox, oy, bw in ((0, 0, (1 - fx) * (1 - fy)), (1, 0, fx * (1 - fy)),
                       (0, 1, (1 - fx) * fy), (1, 1, fx * fy)):
        tx, ty = x0i + ox, y0i + oy
        inb = (tx >= 0) & (tx < width) & (ty >= 0) & (ty < height) & in_front
        tap = hist[torch.where(inb, ty * width + tx, torch.zeros_like(tx))]
        valid = inb & ((tap[..., 9] - dist_prev).abs() <= tol)
        w = torch.where(valid, bw, torch.zeros_like(bw))
        acc = acc + tap * w[..., None]
        wsum = wsum + w
    ok = wsum > 0.25  # a substantial valid bilinear footprint
    inv = torch.where(ok, 1.0 / torch.clamp(wsum, min=1e-6), torch.zeros_like(wsum))
    out = acc * inv[..., None]
    return out[..., 0:3], out[..., 3:6], out[..., 6:9], out[..., 10]


def blend(hist_n, hc, ha, hn, c, a, n, depth) -> FrameBuffers:
    """One running-average step against per-pixel history of length ``hist_n``."""
    nsamp = torch.clamp(hist_n, max=N_MAX)
    w = (1.0 / (nsamp + 1.0))[..., None]
    return FrameBuffers(hc + (c - hc) * w, ha + (a - ha) * w, hn + (n - hn) * w, depth, nsamp + 1.0)


def static_blend(fbs: FrameBuffers, c, a, n, d) -> FrameBuffers:
    """Plain version of K13s: the history kept where the first-hit distance held, else
    shortened to STATIC_CLAMP, then the blend."""
    tol = torch.clamp(REL_TOL * d, min=ABS_TOL)
    same = (torch.clamp(fbs.depth, max=DEPTH_CAP) - d).abs() <= tol
    hns = torch.where(same, fbs.nsamp, torch.clamp(fbs.nsamp, max=STATIC_CLAMP))
    return blend(hns, fbs.color, fbs.albedo, fbs.normal, c, a, n, d)


def temporal_blend(fbs: FrameBuffers, cam_prev, cam, c, a, n, d) -> FrameBuffers:
    """Plain version of K13: ``reproject_history`` then the blend."""
    height, width = d.shape
    hc, ha, hn, hns = reproject_history(fbs, cam_prev, cam, d, height, width)
    return blend(hns, hc, ha, hn, c, a, n, d)


def _check_temporal(fbs: FrameBuffers):
    if fbs.depth is None or fbs.nsamp is None:
        raise ValueError("temporal accumulation needs init_framebuffers(..., temporal=True)")


def accumulate_temporal(fbs: FrameBuffers, cam_prev, cam, c, a, n, d) -> FrameBuffers:
    """The sample (c, a, n, d) blended into the history reprojected from ``cam_prev`` to
    ``cam``: K13 on the card (new buffers), the plain version on the CPU."""
    _check_temporal(fbs)
    return temporal_blend(fbs, cam_prev, cam, c, a, n, d)


def accumulate_static(fbs: FrameBuffers, c, a, n, d) -> FrameBuffers:
    """The sample blended into the history of a static camera: K13s on the card, the
    plain version on the CPU."""
    _check_temporal(fbs)
    return static_blend(fbs, c, a, n, d)


def render_accumulate_temporal(fbs: FrameBuffers, scene, cam_prev, cam, params, height: int,
                               width: int, frame_id: int) -> FrameBuffers:
    """One 1-spp sample and its reprojected accumulation (the moving-camera analogue of
    ``tracer.render_accumulate``): K11 then K13 on the card."""
    c, a, n, d = tracer.render_sample(scene, cam, params, height, width, frame_id, want_depth=True)
    return accumulate_temporal(fbs, cam_prev, cam, c, a, n, d)


def render_accumulate_static(fbs: FrameBuffers, scene, cam, params, height: int, width: int,
                             frame_id: int) -> FrameBuffers:
    """Static-camera accumulation with per-pixel history: K11 then K13s on the card."""
    c, a, n, d = tracer.render_sample(scene, cam, params, height, width, frame_id, want_depth=True)
    return accumulate_static(fbs, c, a, n, d)
