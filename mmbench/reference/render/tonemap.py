"""ACES filmic tonemap and gamma: the present shader.

Port of ``mega_minecraft_tpu/render/tonemap.py:16,22`` (the reference's fullscreen-triangle
present shader, d3d11Renderer.cpp:17-24,44-46: Narkowicz's ACES fit, gamma 1/2.2).
``present`` runs K16 (``csrc/present.cu`` ``present_kernel``) on a CUDA frame and
``present_plain`` on a CPU one.  Both write the rational without multiply-add and raise
to the f32 exponent F32(1/2.2) with ``pow``; the truncation to u8 can then move a channel
by one step where a libm differs by an ulp at a .5 boundary.
"""

from __future__ import annotations

import numpy as np
import torch

F32 = torch.float32
#: the f32 constants of the curve and the exponent, as the JAX package rounds them
ACES_A, ACES_B, ACES_C, ACES_D, ACES_E = (float(np.float32(v)) for v in (2.51, 0.03, 2.43, 0.59, 0.14))
GAMMA_EXP = float(np.float32(1.0 / 2.2))


def aces_film(x):
    """Narkowicz's ACES curve, clipped to [0, 1]."""
    return torch.clamp((x * (ACES_A * x + ACES_B)) / (x * (ACES_C * x + ACES_D) + ACES_E), 0.0, 1.0)


def present(hdr):
    """[H, W, 3] linear HDR f32 -> [H, W, 3] u8 (ACES, gamma 1/2.2).  CUDA: K16; CPU: the
    plain version."""
    return present_plain(hdr)


def present_plain(hdr):
    ldr = torch.pow(aces_film(hdr.to(F32)), GAMMA_EXP)
    return (torch.clamp(ldr, 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)
