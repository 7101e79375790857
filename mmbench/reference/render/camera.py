"""Player / fly-camera and pinhole ray generation.

Port of ``mega_minecraft_tpu/render/camera.py:25-123`` (the reference's player.cpp:8-74
and pixel rays basic_shaders.cu:558-572, fov optixRenderer.cpp:428-479).  ``pixel_rays``
is the plain version of the ray generation K11 inlines (``csrc/tracer.cu``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch

F32 = torch.float32

FOV_NORMAL = math.radians(47.0)
FOV_ZOOMED = math.radians(20.0)


class CameraParams(NamedTuple):
    position: torch.Tensor  # [3] f32
    forward: torch.Tensor  # [3]
    right: torch.Tensor  # [3]
    up: torch.Tensor  # [3]
    pixel_length: torch.Tensor  # [2]


@dataclass
class Player:
    """Host-side fly camera (player.hpp defaults: pos (0, 200, −20))."""

    pos: np.ndarray = field(default_factory=lambda: np.array([0.0, 200.0, -20.0], np.float32))
    theta: float = 0.0
    phi: float = 0.0
    zoomed: bool = False

    @property
    def forward(self) -> np.ndarray:
        st, ct = math.sin(self.theta), math.cos(self.theta)
        sp, cp = math.sin(self.phi), math.cos(self.phi)
        return np.array([st * cp, sp, ct * cp], np.float32)

    @property
    def forward_flat(self) -> np.ndarray:
        return np.array([math.sin(self.theta), 0.0, math.cos(self.theta)], np.float32)

    @property
    def right(self) -> np.ndarray:
        r = np.cross([0.0, 1.0, 0.0], self.forward)
        return (r / np.linalg.norm(r)).astype(np.float32)

    @property
    def up(self) -> np.ndarray:
        u = np.cross(self.forward, self.right)
        return (u / np.linalg.norm(u)).astype(np.float32)

    def move(self, dx: float, dy: float, dz: float):
        """move(input): x along right, y vertical, z along flattened forward."""
        self.pos = (
            self.pos + self.forward_flat * dz + self.right * dx + np.array([0, dy, 0], np.float32)
        ).astype(np.float32)

    def rotate(self, d_theta: float, d_phi: float):
        self.phi = max(-1.565, min(1.565, self.phi + d_phi))
        self.theta += d_theta

    def camera_params(self, width: int, height: int, device="cuda") -> CameraParams:
        tan_fovy = math.tan(FOV_ZOOMED if self.zoomed else FOV_NORMAL)
        xscaled = tan_fovy * width / height
        pixel_length = np.array([2 * xscaled / width, 2 * tan_fovy / height], np.float32)
        t = lambda a: torch.as_tensor(np.array(a, np.float32), device=torch.device(device))  # noqa: E731
        return CameraParams(t(self.pos), t(self.forward), t(self.right), t(self.up), t(pixel_length))


def pixel_rays(cam: CameraParams, width: int, height: int, jitter, row0: int = 0,
               full_height: int | None = None, col0: int = 0, full_width: int | None = None):
    """Jittered pinhole rays of the ``height`` x ``width`` tile whose top-left global
    pixel is (``row0``, ``col0``) of a ``full_height`` x ``full_width`` frame.

    jitter: (jx, jy) [height, width] f32 in [0, 1).  Returns (dx, dy, dz) [height, width]."""
    full_height = height if full_height is None else full_height
    full_width = width if full_width is None else full_width
    dev = cam.forward.device
    ix = torch.arange(width, dtype=F32, device=dev)[None, :] + float(col0)
    iy = torch.arange(height, dtype=F32, device=dev)[:, None] + float(row0)
    jx, jy = jitter
    # F32(full) * F32(0.5) is exact: the frame's half size
    sx = (ix - float(np.float32(full_width) * np.float32(0.5)) + jx) * cam.pixel_length[0]
    # row 0 is the TOP of the presented image (the flip is baked into ray generation)
    sy = (iy - float(np.float32(full_height) * np.float32(0.5)) + jy) * cam.pixel_length[1]
    d = [cam.forward[k] - cam.right[k] * sx - cam.up[k] * sy for k in range(3)]
    norm = torch.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
    return d[0] / norm, d[1] / norm, d[2] / norm
