"""The port's temporal reprojection (``mega_minecraft_tpu_torch/render/reproject.py``:
``reproject_history``, the blends, ``render_accumulate_temporal`` / ``_static``; the plain
versions of K13 and K13s) vs the JAX package's, and the behavioural cases of
``tests/test_reproject.py`` on the port.

Against JAX, both sides take the same 1-spp samples (colour, albedo, normal, first-hit
distance) of a small seeded scene, rendered once by the port's plain ``render_sample``
(which ``tests/test_torch_render.py`` holds to the JAX tracer): the JAX functions run
whole with their ``tracer.render_sample`` handed those samples, so what is compared is the
reprojection and the blends.  The JAX side runs eagerly.  Tolerances: colour, albedo and
normal within 1e-5 on >= 99.9% of pixels, ``nsamp`` equal on >= 99.9% (a tap whose
depth test or footprint sits on its threshold may flip with one ulp of a division).
The CUDA kernels are held to these plain versions on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mega_minecraft_tpu.render import camera as jc
from mega_minecraft_tpu.render import reproject as jr
from mega_minecraft_tpu.render import tracer as jt
from mega_minecraft_tpu.render.tracer import FrameBuffers as JFrameBuffers
from mega_minecraft_tpu_torch import tables
from mega_minecraft_tpu_torch.render import camera, reproject, sky, tracer
from mega_minecraft_tpu_torch.render.reproject import N_MAX
from mega_minecraft_tpu_torch.render.tracer import DEPTH_CAP, FrameBuffers

from test_torch_brickmap import scene_volume
from test_torch_render import _scenes

H, W = 18, 26
#: (pos, theta, phi) of the three frames: a static start, then forward and turning
FRAMES = [((0.0, 112.0, -2.0), 0.1, -0.45), ((0.4, 112.3, -0.5), 0.13, -0.44),
          ((0.8, 112.5, 1.0), 0.16, -0.43)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs its files in several processes on the same
    cores, where torch's spinning thread pools would starve each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def samples():
    """JAX cameras, their port copies and the port's plain 1-spp samples of each frame."""
    _, ts = _scenes(scene_volume(), -1, 0)
    params = sky.sky_params(1.0, 3.0, device="cpu")
    out = []
    for fid, (pos, theta, phi) in enumerate(FRAMES):
        jcam = jc.Player(pos=np.array(pos, np.float32), theta=theta, phi=phi).camera_params(W, H)
        tcam = tables.camera_from_numpy(jcam, "cpu")
        smp = tracer.render_sample(ts, tcam, params, H, W, fid, want_depth=True)
        out.append((jcam, tcam, smp))
    depth = out[0][2][3]
    assert 0.2 < float((depth < DEPTH_CAP).double().mean()) < 1.0  # terrain and sky in view
    return out


def _jax_fbs(fbs):
    return JFrameBuffers(*(jnp.asarray(t.numpy()) for t in fbs))


def _check_close(got, want, tag):
    for name, g, w in zip(("color", "albedo", "normal"), got[:3], want[:3]):
        d = np.abs(g.numpy() - np.asarray(w)).max(-1)
        assert (d <= 1e-5).mean() >= 0.999, (tag, name, float(d.max()))
    n_eq = (got[-1].numpy() == np.asarray(want[-1])).mean()
    assert n_eq >= 0.999, (tag, n_eq)


def test_reproject_history_close_to_jax(samples):
    (jc0, tc0, s0), (jc1, tc1, s1), _ = samples
    fbs = reproject.static_blend(tracer.init_framebuffers(H, W, "cpu", temporal=True), *s0)
    fbs = fbs._replace(nsamp=torch.full((H, W), 5.0))
    with jax.disable_jit():
        want = jr.reproject_history(_jax_fbs(fbs), jc0, jc1, jnp.asarray(s1[3].numpy()), H, W)
    got = reproject.reproject_history(fbs, tc0, tc1, s1[3], H, W)
    _check_close(got, want, "reproject_history")
    kept = float((got[3] > 0).double().mean())
    assert 0.3 < kept < 1.0, kept  # most history survives the move, the disocclusions not


def test_render_accumulate_chain_close_to_jax(samples, monkeypatch):
    """static -> temporal -> temporal, each JAX function whole (its K11 handed the sample)."""
    queue = []
    monkeypatch.setattr(jt, "render_sample", lambda *a, **k: queue.pop(0))
    js, ts = _scenes(scene_volume(), -1, 0)
    jfbs = jt.init_framebuffers(H, W, temporal=True)
    tfbs = tracer.init_framebuffers(H, W, "cpu", temporal=True)
    for fid, (jcam, tcam, smp) in enumerate(samples):
        queue.append(tuple(jnp.asarray(t.numpy()) for t in smp))
        with jax.disable_jit():
            if fid == 0:
                jfbs = jr.render_accumulate_static(jfbs, js, jcam, None, H, W, fid)
            else:
                jfbs = jr.render_accumulate_temporal(jfbs, js, samples[fid - 1][0], jcam, None, H, W, fid)
        if fid == 0:
            tfbs = reproject.accumulate_static(tfbs, *smp)
        else:
            tfbs = reproject.accumulate_temporal(tfbs, samples[fid - 1][1], tcam, *smp)
        _check_close(tfbs, jfbs, f"frame {fid}")
        np.testing.assert_array_equal(tfbs.depth.numpy(), np.asarray(jfbs.depth))
    assert float(tfbs.nsamp.max()) == 3.0 and float(tfbs.nsamp.min()) >= 1.0


def test_render_accumulate_entry_points(samples):
    """The entry points render with K11's plain version and blend: frame 1 through
    render_accumulate_temporal equals its two halves run by hand."""
    _, ts = _scenes(scene_volume(), -1, 0)
    params = sky.sky_params(1.0, 3.0, device="cpu")
    (_, tc0, s0), (_, tc1, s1), _ = samples
    fbs = reproject.render_accumulate_static(tracer.init_framebuffers(H, W, "cpu", temporal=True), ts, tc0,
                                             params, H, W, 0)
    for a, b in zip(fbs, reproject.static_blend(tracer.init_framebuffers(H, W, "cpu", temporal=True), *s0)):
        assert torch.equal(a, b)
    got = reproject.render_accumulate_temporal(fbs, ts, tc0, tc1, params, H, W, 1)
    for a, b in zip(got, reproject.temporal_blend(fbs, tc0, tc1, *s1)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        reproject.accumulate_static(tracer.init_framebuffers(H, W, "cpu"), *s0)


# -- the behavioural cases of tests/test_reproject.py, on the port -----------------------

BH, BW = 24, 32


def _wall_setup(z0=50.0):
    """Previous frame: camera at the origin looking +z at the wall z = z0; the stored
    depth of each pixel is the ray's distance to the wall."""
    cam = camera.Player(pos=np.zeros(3, np.float32), theta=0.0, phi=0.0).camera_params(BW, BH, device="cpu")
    dz = reproject._center_dirs(cam, BH, BW)[2]
    depth = z0 / dz
    color = torch.from_numpy(np.random.RandomState(0).rand(BH, BW, 3).astype(np.float32))
    fbs = FrameBuffers(color, color * 0.5, torch.zeros((BH, BW, 3)), depth, torch.full((BH, BW), 7.0))
    return cam, fbs, depth


def test_identity_camera_returns_history():
    cam, fbs, depth = _wall_setup()
    hc, _, _, hns = reproject.reproject_history(fbs, cam, cam, depth, BH, BW)
    np.testing.assert_allclose(hc.numpy(), fbs.color.numpy(), atol=1e-2)
    np.testing.assert_allclose(hns.numpy(), 7.0, atol=1e-2)


def test_one_pixel_lateral_shift():
    """Moving the camera along +right by one pixel's footprint at the wall shifts every
    gathered history pixel by one column."""
    z0 = 50.0
    cam_prev, fbs, _ = _wall_setup(z0)
    shift = float(cam_prev.pixel_length[0]) * z0
    cam_new = camera.Player(pos=(cam_prev.right.numpy() * shift).astype(np.float32), theta=0.0,
                            phi=0.0).camera_params(BW, BH, device="cpu")
    depth_new = z0 / reproject._center_dirs(cam_new, BH, BW)[2]
    hc, _, _, hns = reproject.reproject_history(fbs, cam_prev, cam_new, depth_new, BH, BW)
    ok = np.isclose(hc.numpy()[:, 1:], fbs.color.numpy()[:, : BW - 1], atol=2e-2).all(axis=-1)
    assert ok.mean() > 0.9, ok.mean()
    assert (hns.numpy()[:, 1:] > 6.0).mean() > 0.9


def test_disocclusion_resets_history_length():
    cam, fbs, depth = _wall_setup()
    bad = fbs.depth.clone()
    bad[8:16, 10:20] = 5.0  # the stored surface much closer than the reprojected one
    _, _, _, hns = reproject.reproject_history(fbs._replace(depth=bad), cam, cam, depth, BH, BW)
    assert bool((hns[9:15, 11:19] == 0.0).all())
    assert bool((hns[:4] > 6.0).all())


def test_behind_camera_invalid():
    """A camera turned around sees points behind the previous camera: no history."""
    cam_prev, fbs, _ = _wall_setup()
    cam_new = camera.Player(pos=np.zeros(3, np.float32), theta=np.pi, phi=0.0).camera_params(BW, BH, device="cpu")
    _, _, _, hns = reproject.reproject_history(fbs, cam_prev, cam_new, torch.full((BH, BW), 50.0), BH, BW)
    assert float(hns.max()) == 0.0


def test_sky_pixels_reproject_by_direction():
    """Sky pixels (DEPTH_CAP) stay valid under a translation: the distance change is
    negligible against the cap."""
    cam_prev, fbs, _ = _wall_setup()
    fbs = fbs._replace(depth=torch.full((BH, BW), DEPTH_CAP))
    cam_new = camera.Player(pos=np.array([3.0, 1.0, -2.0], np.float32)).camera_params(BW, BH, device="cpu")
    _, _, _, hns = reproject.reproject_history(fbs, cam_prev, cam_new, torch.full((BH, BW), DEPTH_CAP), BH, BW)
    assert bool((hns[2:-2, 2:-2] > 6.0).all())


def test_far_off_projection_is_clamped():
    """A projection far outside the previous frame (huge px) carries no history and no
    undefined integer cast: the coordinates are clamped before it."""
    cam_prev, fbs, _ = _wall_setup()
    cam_new = camera.Player(pos=np.zeros(3, np.float32), theta=1.5, phi=0.0).camera_params(BW, BH, device="cpu")
    _, _, _, hns = reproject.reproject_history(fbs, cam_prev, cam_new, torch.full((BH, BW), 1e5), BH, BW)
    assert bool(torch.isfinite(hns).all()) and float(hns.max()) == 0.0


def test_fresh_pixel_takes_sample():
    c = torch.full((BH, BW, 3), 0.8)
    z3 = torch.zeros((BH, BW, 3))
    out = reproject.blend(torch.zeros((BH, BW)), z3, z3, z3, c, c, c, torch.full((BH, BW), 10.0))
    np.testing.assert_allclose(out.color.numpy(), 0.8, atol=1e-6)
    np.testing.assert_allclose(out.nsamp.numpy(), 1.0)


def test_history_clip_bounds_weight():
    hc = torch.zeros((BH, BW, 3))
    c = torch.ones((BH, BW, 3))
    out = reproject.blend(torch.full((BH, BW), 1e6), hc, hc, hc, c, c, c, torch.full((BH, BW), 10.0))
    np.testing.assert_allclose(out.color.numpy(), 1.0 / (N_MAX + 1.0), rtol=1e-5)
    assert float(out.nsamp[0, 0]) == N_MAX + 1.0


def test_static_blend_clamps_moved_depth():
    """Under a static camera, history whose first-hit distance moved is shortened to 3,
    the rest kept."""
    _, fbs, depth = _wall_setup()
    fbs = fbs._replace(nsamp=torch.full((BH, BW), 40.0))
    d = depth.clone()
    d[:5] = 3.0
    out = reproject.static_blend(fbs, fbs.color, fbs.albedo, fbs.normal, d)
    assert bool((out.nsamp[:5] == 4.0).all()) and bool((out.nsamp[5:] == 41.0).all())


def test_temporal_framebuffers():
    fbs = tracer.init_framebuffers(6, 8, "cpu", temporal=True)
    assert fbs.depth.shape == (6, 8) and fbs.nsamp.shape == (6, 8)
    assert float(fbs.depth[0, 0]) == DEPTH_CAP and float(fbs.nsamp.max()) == 0.0
    legacy = tracer.init_framebuffers(6, 8, "cpu")
    assert legacy.depth is None and legacy.nsamp is None
    carried = tables.framebuffers_from_numpy(jt.init_framebuffers(6, 8, temporal=True), "cpu")
    for a, b in zip(carried, fbs):
        assert torch.equal(a, b)
    assert tables.framebuffers_from_numpy(jt.init_framebuffers(6, 8), "cpu").nsamp is None
