"""The plain reference of a presented frame and of a scene's fields.

``Flight`` replays the camera of a run (the moves and turns the harness gave the engine)
with the frozen ``camera.Player``.  ``frame`` follows one frame of the engine from the
history buffers and the scene it rendered with: the 1-spp sample (``render_sample_plain``),
the reprojected blend (``temporal_blend``), the a-trous denoise, the 2x upscale when the
configuration upscales, and the ACES present, as ``Engine.tick`` + ``Engine.present`` compose
them.  ``scene_fields`` builds a scene's packed fields from its blocks.

``precision="bf16"`` rounds every float buffer between the stages to bfloat16: the control of
the comparison (the nearest precision below float32).
"""

from __future__ import annotations

import numpy as np
import torch

from .render import camera, denoise, reproject, sky, tonemap, tracer
from .render.brickmap import Scene, build_fields_plain


class Flight:
    """The camera of a run: ``Player`` at a start pose, moved as ``Engine.tick`` moves it
    (``move`` then ``rotate``)."""

    def __init__(self, pos, theta: float, phi: float):
        self.player = camera.Player()
        self.player.pos = np.asarray(pos, np.float32)
        self.player.theta, self.player.phi = theta, phi

    def step(self, move, rotate):
        if any(move):
            self.player.move(*move)
        if any(rotate):
            self.player.rotate(*rotate)

    def camera(self, width: int, height: int, device):
        cam = self.player.camera_params(width, height, device="cpu")
        return type(cam)(*(t.to(device) for t in cam))


def sky_params(sun_time: float, time: float, device):
    params = sky.sky_params(sun_time, time, device="cpu")
    return type(params)(*(t.to(device) for t in params))


def _round(ts, precision: str):
    if precision == "f32":
        return ts
    if precision == "bf16":
        return tuple(t.to(torch.bfloat16).to(torch.float32) for t in ts)
    raise ValueError(f"unknown precision {precision!r}")


def frame(scene: Scene, history, cam_prev, cam, params, height: int, width: int, frame_id: int,
          upscale: bool, precision: str = "f32"):
    """One frame of the engine after a moving tick: (the presented [H', W', 3] u8 frame on
    the host, the sample's DDA counts [height, width, 4], the primary rays' dy)."""
    c, a, n, d, steps = tracer.render_sample_plain(scene, cam, params, height, width, frame_id)
    c, a, n = _round((c, a, n), precision)
    fb = reproject.temporal_blend(tracer.FrameBuffers(*history), cam_prev, cam, c, a, n, d)
    color, albedo, normal = _round((fb.color, fb.albedo, fb.normal), precision)
    (color,) = _round((denoise.atrous_denoise_plain(color, albedo, normal, nsamp=fb.nsamp),), precision)
    if upscale:
        (color,) = _round((denoise.upscale2x_plain(color),), precision)
    img = tonemap.present_plain(color).cpu().numpy()
    dy = tracer.primary_rays(cam, height, width, frame_id)[0][4]
    return img, steps, dy


def scene_fields(volume_u8) -> torch.Tensor:
    """The flat packed fields (fine ++ macro) of a [Z, X, 384] u8 block volume."""
    return build_fields_plain(volume_u8)
