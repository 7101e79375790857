"""The port's present path (``mega_minecraft_tpu_torch/render``: ``tonemap.present`` /
``aces_film``, ``denoise.atrous_denoise``, ``denoise.upscale2x``, ``denoise.psnr``: the
plain versions of K16, K14 and K15) vs the JAX package's, on the same seeded numpy frames.

Tolerances and what sets them:
- ``present``: <= 1 step on <= 0.1% of the u8 channels (``pow`` is each platform's own
  and an ulp can cross a .5 rounding boundary); ``aces_film`` within 1e-6 relative;
- ``atrous_denoise`` (odd-sized frames, with and without ``nsamp``, and a frame whose
  border rows differ so the wrap-around of the taps shows): 1e-5 relative; JAX runs
  eagerly, its ``exp`` is XLA's own;
- ``upscale2x``: 1e-6 relative (JAX contracts both axes in one product, the port lerps
  along x then y);
- ``psnr``: equal to JAX's to 1e-6 dB.
The CUDA kernels are held to these plain versions on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from mega_minecraft_tpu.render import denoise as jd
from mega_minecraft_tpu.render import tonemap as jt
from mega_minecraft_tpu_torch.render import denoise as td
from mega_minecraft_tpu_torch.render import tonemap as tt


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs its files in several processes on the same
    cores, where torch's spinning thread pools would starve each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def frame(seed: int, h: int, w: int, scale: float = 1.0) -> dict:
    """A seeded HDR frame with guides: colour with a bright sun-lit share, albedo in
    [0, 1], unit-ish normals of a few facets, nsamp in [0, 70]."""
    rng = np.random.RandomState(seed)
    color = (rng.rand(h, w, 3) * scale * np.where(rng.rand(h, w, 1) < 0.1, 20.0, 1.0)).astype(np.float32)
    albedo = np.repeat(rng.rand(h, w, 1), 3, axis=2) * 0.5 + rng.rand(h, w, 3) * 0.1
    facets = np.array([[0, 1, 0], [1, 0, 0], [0, 0, -1], [0.6, 0.8, 0]], np.float32)
    normal = facets[rng.randint(0, 4, (h, w))]
    nsamp = rng.randint(0, 71, (h, w)).astype(np.float32)
    return {"color": color, "albedo": albedo.astype(np.float32), "normal": normal, "nsamp": nsamp}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_aces_and_present_close_to_jax():
    hdr = np.concatenate([frame(0, 37, 53, 4.0)["color"].reshape(-1),
                          np.linspace(0.0, 50.0, 30000, dtype=np.float32)]).reshape(-1, 1, 3)
    want = np.asarray(jt.present(hdr))
    got = tt.present(_t(hdr)).numpy()
    assert got.dtype == np.uint8 and got.shape == want.shape
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, (diff.max(), (diff > 0).mean())
    with jax.disable_jit():
        aces = np.asarray(jt.aces_film(hdr))
    np.testing.assert_allclose(tt.aces_film(_t(hdr)).numpy(), aces, rtol=1e-6, atol=0)
    assert got.min() == 0 and got.max() == 255


@pytest.mark.parametrize("with_nsamp", [True, False], ids=["nsamp", "fixed_sigma"])
@pytest.mark.parametrize("shape", [(21, 35), (9, 13)], ids=["21x35", "9x13"])
def test_atrous_denoise_close_to_jax(with_nsamp, shape):
    f = frame(1, *shape)
    ns = f["nsamp"] if with_nsamp else None
    with jax.disable_jit():
        want = np.asarray(jd.atrous_denoise(f["color"], f["albedo"], f["normal"], nsamp=ns))
    got = td.atrous_denoise(_t(f["color"]), _t(f["albedo"]), _t(f["normal"]),
                            nsamp=None if ns is None else _t(ns)).numpy()
    assert got.shape == f["color"].shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    # the filter smooths: the colour's spread falls
    assert got.std() < f["color"].std()


def test_atrous_denoise_wraps_around_borders():
    """Taps wrap modulo the frame (JAX's jnp.roll): a frame whose first and last rows
    alone are bright pulls the last row up through the wrap, which a clamped border
    would not."""
    h, w = 11, 17
    color = np.full((h, w, 3), 0.1, np.float32)
    color[0] = 2.0
    albedo = np.full((h, w, 3), 0.5, np.float32)
    normal = np.tile(np.array([0, 1, 0], np.float32), (h, w, 1))
    with jax.disable_jit():
        want = np.asarray(jd.atrous_denoise(color, albedo, normal, iterations=1))
    got = td.atrous_denoise(_t(color), _t(albedo), _t(normal), iterations=1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    assert got[h - 1].mean() > got[h // 2].mean() + 0.05
    np.testing.assert_allclose(got[h - 1], got[1], rtol=1e-6)  # symmetric about row 0


def test_upscale2x_close_to_jax():
    img = frame(2, 13, 22, 3.0)["color"]
    want = np.asarray(jd.upscale2x(img))
    got = td.upscale2x(_t(img)).numpy()
    assert got.shape == (26, 44, 3)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    # at the border the result is the clamped lerp: corner pixels repeat the input's corner
    np.testing.assert_array_equal(got[0, 0], img[0, 0])


def test_psnr_equals_jax():
    a = frame(3, 16, 24, 2.0)["color"]
    b = a + np.random.RandomState(4).normal(0, 0.05, a.shape).astype(np.float32)
    assert td.psnr(_t(a), _t(b)) == pytest.approx(jd.psnr(a, b), abs=1e-6)
    assert td.psnr(_t(a), _t(a)) == float("inf")


def test_device_checks():
    f = frame(5, 6, 8)
    with pytest.raises(ValueError):
        td.atrous_denoise(_t(f["color"]), _t(f["albedo"][:5]), _t(f["normal"]))
    with pytest.raises(ValueError):
        tt.present(_t(f["color"]).to("meta"))
