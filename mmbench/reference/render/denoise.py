"""Denoiser and upscale: the edge-avoiding à-trous filter with albedo / normal guides, and
the 2x bilinear upscale of the present path.

Port of ``mega_minecraft_tpu/render/denoise.py`` (the reference's OptiX AOV denoiser,
optixRenderer.cpp:757-833,939-975, replaced by an SVGF-style à-trous filter; its
USE_UPSCALING path, optixRenderer.cpp:462-466):

- ``atrous_denoise``: K14 (``csrc/denoise.cu``, one launch per iteration on ping-pong
  buffers) for CUDA tensors, ``atrous_denoise_plain`` for CPU ones.  Taps wrap around the
  borders (JAX's ``jnp.roll``); the 25 taps are summed ty outer, tx inner, and each
  squared distance as (d0² + d1²) + d2², in both versions;
- ``upscale2x``: K15 (``csrc/present.cu`` ``upscale2x_kernel``) / ``upscale2x_plain``:
  half-pixel-centred bilinear, the 0.75 / 0.25 lerp along x then along y with the
  neighbour index clamped at the border (JAX's ``jax.image.resize`` renormalises its edge
  weights, which is the clamp; it contracts both axes in one product, so the two agree to
  about an ulp);
- ``psnr``: host numpy over ``tonemap.present``.
"""

from __future__ import annotations

import numpy as np
import torch

F32 = torch.float32

_B3 = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)
#: the 25 tap weights, each B3 product rounded from double to f32 (ty outer, tx inner)
TAP_WEIGHTS = tuple(float(np.float32(_B3[ty] * _B3[tx])) for ty in range(5) for tx in range(5))
ITERATIONS = 4
SIGMA_COLOR, SIGMA_ALBEDO, SIGMA_NORMAL = 4.0, 0.25, 0.35


def _check_frame(color, albedo, normal, nsamp):
    for name, t in (("albedo", albedo), ("normal", normal)):
        if t.shape != color.shape or t.device != color.device:
            raise ValueError(f"{name}: {tuple(t.shape)} on {t.device}, colour {tuple(color.shape)} "
                             f"on {color.device}")
    if nsamp is not None and (nsamp.shape != color.shape[:2] or nsamp.device != color.device):
        raise ValueError(f"nsamp: {tuple(nsamp.shape)} on {nsamp.device}")


def atrous_denoise(color, albedo, normal, iterations: int = ITERATIONS, sigma_color: float = SIGMA_COLOR,
                   sigma_albedo: float = SIGMA_ALBEDO, sigma_normal: float = SIGMA_NORMAL, nsamp=None):
    """[H, W, 3] HDR colour with its albedo and normal guides -> denoised colour.

    Weights w = B3(tap) * exp(-|Δcolour|² / σc² - |Δalbedo|² / σa² - |Δnormal|² / σn²)
    over the 5x5 à-trous pattern at stride 2^i.  ``nsamp`` ([H, W] per-pixel history
    length, optional) tightens the colour sigma to σc / √clip(n, 1, 64).  CUDA: K14; CPU:
    the plain version."""
    _check_frame(color, albedo, normal, nsamp)
    return atrous_denoise_plain(color, albedo, normal, iterations, sigma_color, sigma_albedo,
                                sigma_normal, nsamp)


def sigma_terms(sigma_color: float, sigma_albedo: float, sigma_normal: float):
    """(1 / σc², σa², σn²) as the f32 values both versions use."""
    return (float(np.float32(1.0 / sigma_color ** 2)), float(np.float32(sigma_albedo ** 2)),
            float(np.float32(sigma_normal ** 2)))


def _dist2(a, b):
    d = a - b
    return (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]


def atrous_denoise_plain(color, albedo, normal, iterations: int = ITERATIONS,
                         sigma_color: float = SIGMA_COLOR, sigma_albedo: float = SIGMA_ALBEDO,
                         sigma_normal: float = SIGMA_NORMAL, nsamp=None):
    inv_sc2, sa2, sn2 = sigma_terms(sigma_color, sigma_albedo, sigma_normal)
    c = color.to(F32)
    # divisors as tensors: torch on the card multiplies by the reciprocal of a host scalar
    # divisor, where JAX and the kernel divide
    t = lambda v: torch.full((), v, dtype=F32, device=c.device)  # noqa: E731
    sa2, sn2 = t(sa2), t(sn2)
    if nsamp is not None:
        inv_sc2 = torch.clamp(nsamp.to(F32), 1.0, 64.0) / t(float(np.float32(sigma_color ** 2)))
    for it in range(iterations):
        stride = 1 << it
        acc = torch.zeros_like(c)
        wsum = torch.zeros(c.shape[:2], dtype=F32, device=c.device)
        for k, (ty, tx) in enumerate((ty, tx) for ty in range(-2, 3) for tx in range(-2, 3)):
            shift = (ty * stride, tx * stride)
            cs = torch.roll(c, shift, dims=(0, 1))
            als = torch.roll(albedo, shift, dims=(0, 1))
            ns = torch.roll(normal, shift, dims=(0, 1))
            e = -_dist2(cs, c) * inv_sc2 - _dist2(als, albedo) / sa2 - _dist2(ns, normal) / sn2
            w = TAP_WEIGHTS[k] * torch.exp(e)
            acc = acc + cs * w[..., None]
            wsum = wsum + w
        c = acc / torch.clamp(wsum, min=1e-6)[..., None]
    return c


def upscale2x(img):
    """Bilinear 2x upscale, [H, W, 3] f32 -> [2H, 2W, 3] (the reference's USE_UPSCALING
    present path).  CUDA: K15; CPU: the plain version."""
    return upscale2x_plain(img)


def _lerp2x(x, axis: int):
    n = x.shape[axis]
    i = torch.arange(2 * n, device=x.device)
    near = i // 2
    far = torch.clamp(torch.where(i % 2 == 0, near - 1, near + 1), 0, n - 1)
    return 0.75 * x.index_select(axis, near) + 0.25 * x.index_select(axis, far)


def upscale2x_plain(img):
    return _lerp2x(_lerp2x(img.to(F32), 1), 0)


def psnr(img, ref, peak: float | None = None) -> float:
    """PSNR (dB) of ``img`` against ``ref`` after ACES tonemapping to display space
    (convergence is judged on the presented image)."""
    from .tonemap import present

    a = present(img).cpu().numpy().astype(np.float32) / 255.0
    b = present(ref).cpu().numpy().astype(np.float32) / 255.0
    mse = float(np.mean((a - b) ** 2))
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10((peak or 1.0) ** 2 / mse))
