"""The port's tracer path (``mega_minecraft_tpu_torch/render``: camera, sky, tracer and
the renderer's RNG; the plain versions of K11t, K11 and K12) vs the JAX package's, on the
same numpy inputs handed over by the carry functions of ``tables``.

The JAX side runs eagerly (each operation its own program, so XLA fuses no multiply-add;
the DDA's while loops still compile).  Tolerances and what sets them:
- the RNG (tea / lcg / rnd) and accumulation: equal;
- ``pixel_rays``: <= 1e-6 (one sqrt and a division; torch's CPU sqrt is not always
  correctly rounded);
- ``sky_color`` on 4,096 seeded directions, day and night, first-hit data on: >= 99.9%
  of directions within 1e-5.  Stars hash sin(x) * 58293.492 at x in the thousands, so
  one ulp of sin moves a star: at night the stars are compared as the share of
  directions that show one, within 0.5 points;
- ``trace``: the 128 rays of ``tests/test_render.py``'s brute-force test (with and
  without the macro level) and 64 rays through water and crystal: hit, block, normal and steps equal, t within 1e-5 relative;
- ``render_sample`` (16x16, frame 3, day): albedo and normal within 1e-5 on >= 99% of
  pixels, colour within 1e-4 on >= 98%, depth within 1e-5 relative; the agreement
  measured is in PERF.md.
The CUDA kernels are held to these plain versions on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mega_minecraft_tpu.ops import hashes as jh
from mega_minecraft_tpu.render import brickmap as jb
from mega_minecraft_tpu.render import camera as jc
from mega_minecraft_tpu.render import sky as jsky
from mega_minecraft_tpu.render import tracer as jt
from mega_minecraft_tpu.world.blocks import Block as B
from mega_minecraft_tpu_torch import tables
from mega_minecraft_tpu_torch.ops import hashes as th
from mega_minecraft_tpu_torch.render import brickmap as tb
from mega_minecraft_tpu_torch.render import camera as tc
from mega_minecraft_tpu_torch.render import materials as tmat
from mega_minecraft_tpu_torch.render import sky as tsky
from mega_minecraft_tpu_torch.render import tracer as tt

from test_torch_brickmap import scene_volume
from test_torch_cuda import cutout_atlas

DAY, NIGHT = 1.0, 4.0  # sun_time: sun y = +0.749 and -0.758
H = W = 16
FRAME = 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs its files in several processes on the same
    cores, where torch's spinning thread pools would starve each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scenes(vol, ocx=0, ocz=0):
    n = vol.shape[0] // 16
    chunks = vol.reshape(n, 16, n, 16, vol.shape[2]).transpose(0, 2, 1, 3, 4)
    js = jb.build_scene(jnp.asarray(chunks), ocx, ocz)
    return js, tables.scene_from_numpy(np.asarray(js.flat), np.asarray(js.origin), js.dims, "cpu")


@pytest.fixture(scope="module")
def scenes():
    return _scenes(scene_volume(), -1, 0)


@pytest.fixture(scope="module")
def camera_pair():
    player = jc.Player(pos=np.array([0.0, 112.0, -2.0], np.float32), theta=0.1, phi=-0.45)
    cam = player.camera_params(W, H)
    return cam, tables.camera_from_numpy(cam, "cpu")


def _sky_pair(sun_time):
    p = jsky.sky_params(sun_time, 3.0)
    return p, tables.sky_from_numpy(p, "cpu")


@pytest.fixture(scope="module")
def rendered(scenes, camera_pair):
    """One 1-spp sample of the JAX package (eager) and of the plain port, day."""
    (js, ts), (jcam, tcam) = scenes, camera_pair
    jp, tp = _sky_pair(DAY)
    want = [np.asarray(v) for v in jt.render_sample(js, jcam, jp, H, W, jnp.int32(FRAME),
                                                    tile_rows=None, tile_cols=None, want_depth=True)]
    got = tt.render_sample(ts, tcam, tp, H, W, FRAME, want_depth=True, want_steps=True)
    return want, [v.numpy() for v in got]


def test_render_rng_equal():
    rng = np.random.RandomState(11)
    a = rng.randint(0, 2 ** 32, 4096, dtype=np.uint64).astype(np.uint32)
    b = rng.randint(0, 2 ** 32, 4096, dtype=np.uint64).astype(np.uint32)
    ta, tb_ = torch.from_numpy(a.astype(np.int64)), torch.from_numpy(b.astype(np.int64))
    for rounds in (4, 16):
        want = np.asarray(jh.tea(jnp.asarray(a), jnp.asarray(b), rounds=rounds))
        np.testing.assert_array_equal(th.tea(ta, tb_, rounds=rounds).numpy(), want.astype(np.int64))
    np.testing.assert_array_equal(th.lcg_render(ta).numpy(),
                                  np.asarray(jh.lcg_render(jnp.asarray(a))).astype(np.int64))
    state_j, state_t = jnp.asarray(a), ta
    for _ in range(3):
        vj, state_j = jh.rnd(state_j)
        vt, state_t = th.rnd(state_t)
        np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
        np.testing.assert_array_equal(state_t.numpy(), np.asarray(state_j).astype(np.int64))


def test_camera_and_pixel_rays(camera_pair):
    jcam, tcam = camera_pair
    own = tc.Player(pos=np.array([0.0, 112.0, -2.0], np.float32), theta=0.1,
                    phi=-0.45).camera_params(W, H, device="cpu")
    for a, b in zip(own, tcam):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    rng = np.random.RandomState(5)
    jx, jy = rng.rand(2, 12, 10).astype(np.float32)
    want = jc.pixel_rays(jcam, 10, 12, (jnp.asarray(jx), jnp.asarray(jy)), row0=3,
                         full_height=40, col0=5, full_width=30)
    got = tc.pixel_rays(tcam, 10, 12, (torch.from_numpy(jx), torch.from_numpy(jy)), 3, 40, 5, 30)
    for a, b in zip(got, want):
        assert float(np.abs(a.numpy() - np.asarray(b)).max()) <= 1e-6


def test_sky_params_close():
    for st in (DAY, NIGHT, 0.3):
        want = jsky.sky_params(st, 2.5)
        got = tsky.sky_params(st, 2.5, device="cpu")
        for a, b in zip(got, want):
            assert float(np.abs(a.numpy() - np.asarray(b)).max()) <= 1e-6


@pytest.mark.parametrize("sun_time", [DAY, NIGHT], ids=["day", "night"])
def test_sky_color(sun_time):
    rng = np.random.RandomState(21)
    d = rng.normal(size=(4096, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = rng.uniform(-200, 200, size=(4096, 3)).astype(np.float32)
    first = rng.rand(4096) < 0.8
    jp, tp = _sky_pair(sun_time)
    jd, td = [jnp.asarray(d[:, k]) for k in range(3)], [torch.from_numpy(d[:, k].copy()) for k in range(3)]
    jo, to = [jnp.asarray(o[:, k]) for k in range(3)], [torch.from_numpy(o[:, k].copy()) for k in range(3)]
    for kwargs_j, kwargs_t in (({}, {}),
                               (dict(origin=jo, first_hit=jnp.asarray(first)),
                                dict(origin=to, first_hit=torch.from_numpy(first))),
                               (dict(origin=jo, first_hit=jnp.asarray(first), include_stars=False),
                                dict(origin=to, first_hit=torch.from_numpy(first), include_stars=False))):
        (wr, wg, wb), wbody = jsky.sky_color(*jd, jp, **kwargs_j)
        (gr, gg, gb), gbody = tsky.sky_color(*td, tp, **kwargs_t)
        np.testing.assert_array_equal(gbody.numpy(), np.asarray(wbody))
        diff = np.max([np.abs(g.numpy() - np.asarray(w)) for g, w in ((gr, wr), (gg, wg), (gb, wb))], 0)
        assert (diff <= 1e-5).mean() >= 0.999, ((diff <= 1e-5).mean(), kwargs_t.keys())
    if sun_time == NIGHT:  # stars: the share of first-hit directions that show one
        wr, _, _ = jsky._stars_color(*jd)
        gr, _, _ = tsky._stars_color(*td)
        share_w, share_g = float((np.asarray(wr) > 0).mean()), float((gr.numpy() > 0).mean())
        assert share_w > 0.001 and abs(share_w - share_g) <= 0.005


def _trace_both(js, ts, o, d, med, seed=None, **kw):
    jargs = [jnp.asarray(o[:, k]) for k in range(3)] + [jnp.asarray(d[:, k]) for k in range(3)]
    targs = [torch.from_numpy(o[:, k].copy()) for k in range(3)] + \
        [torch.from_numpy(d[:, k].copy()) for k in range(3)]
    jseed = None if seed is None else jnp.asarray(seed)
    tseed = None if seed is None else torch.from_numpy(seed.astype(np.int64))
    want, wsteps = jt.trace(js, *jargs, jnp.asarray(med), want_steps=True, seed=jseed, **kw)
    got, gsteps = tt.trace(ts, *targs, torch.from_numpy(med), want_steps=True, seed=tseed, **kw)
    for k in ("hit", "block", "nx", "ny", "nz"):
        np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(getattr(want, k)), k)
    np.testing.assert_array_equal(gsteps.numpy(), np.asarray(wsteps))
    wt, gt = np.asarray(want.t), got.t.numpy()
    assert (np.abs(gt - wt) <= 1e-5 * np.maximum(1.0, np.abs(wt))).all()
    return want


@pytest.mark.parametrize("use_macro", [True, False], ids=["two_level", "fine_only"])
def test_trace_box_rays(use_macro):
    """The rays of tests/test_render.py::TestTrace::test_matches_bruteforce, on its scene,
    with the macro level and without it."""
    rng = np.random.RandomState(0)
    vol = np.zeros((32, 32, 384), np.uint8)
    vol[:, :, :96] = int(B.STONE)
    for _ in range(20):
        z, x, y = rng.randint(0, 28), rng.randint(0, 28), rng.randint(96, 200)
        vol[z : z + 3, x : x + 3, y : y + 4] = int(B.STONE)
    js, ts = _scenes(vol)
    rng = np.random.RandomState(1)
    o = np.stack([rng.uniform(2, 30, 128), rng.uniform(100, 250, 128), rng.uniform(2, 30, 128)],
                 -1).astype(np.float32)
    d = rng.normal(size=(128, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    hit = np.asarray(_trace_both(js, ts, o, d, np.zeros(128, np.uint8), use_macro=use_macro).hit)
    assert hit.any() and not hit.all()


def test_trace_through_media(scenes):
    """32 rays from inside the water pool and 32 from inside the crystal, stochastic alpha
    with a bounce ray's cap."""
    js, ts = scenes
    rng = np.random.RandomState(2)
    o = np.concatenate([
        np.stack([rng.uniform(-6, 3, 32), rng.uniform(92, 95, 32), rng.uniform(9, 19, 32)], -1),
        np.stack([rng.uniform(-11.9, -9.1, 32), rng.uniform(101, 105, 32), rng.uniform(22.1, 24.9, 32)],
                 -1)]).astype(np.float32)
    d = rng.normal(size=(64, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    med = np.array([int(B.WATER)] * 32 + [int(B.CYAN_CRYSTAL)] * 32, np.uint8)
    seed = rng.randint(0, 2 ** 31, 64).astype(np.uint32)
    want = _trace_both(js, ts, o, d, med, seed=seed, alpha="stochastic", max_steps=32)
    # every ray leaves its medium: most through an exit into air (block AIR)
    assert np.asarray(want.hit).all() and (np.asarray(want.block) == 0).sum() > 32


@pytest.mark.parametrize("alpha", ["exact", "stochastic"])
def test_trace_alpha_cutout(monkeypatch, alpha):
    """Under a hand-set cutout atlas (``cutout_atlas``: leaves, X-shaped flora, stone,
    grass block and smooth sandstone half transparent) the seeded volume has flagged
    voxels: 96 rays aimed at the leaf canopy and 96 at the flora, exact park-and-resolve
    or stochastic pass-through, with a step cap no lane reaches."""
    vol = scene_volume()
    chunks = np.ascontiguousarray(vol.reshape(2, 16, 2, 16, 384).transpose(0, 2, 1, 3, 4))
    plain = tb.build_scene(torch.from_numpy(chunks), -1, 0)
    with cutout_atlas():
        ts = tb.build_scene(torch.from_numpy(chunks), -1, 0)
        monkeypatch.setattr(jt, "TEX_DIFF_PACKED", tmat.TEX_DIFF_PACKED)
        js = jb.Scene(jnp.asarray(ts.flat.numpy()), jnp.asarray(np.array(ts.origin, np.int32)), ts.dims)
        rng = np.random.RandomState(6)
        flora = np.argwhere((vol == int(B.GRASS)) | (vol == int(B.POPPY)))[rng.randint(0, 32, 96)]
        leaves = np.stack([rng.uniform(24, 30, 96), rng.uniform(110, 116, 96), rng.uniform(24, 30, 96)], -1)
        # targets as world (x, y, z) (the volume is [z, x, y]; the scene's origin is (-16, 0, 0))
        target = np.concatenate([leaves, flora[:, [1, 2, 0]] + rng.uniform(0.2, 0.8, (96, 3))]) + [-16, 0, 0]
        o = target + np.stack([rng.uniform(-20, 20, 192), rng.uniform(8, 40, 192),
                               rng.uniform(-20, 20, 192)], -1)
        d = target - o
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        o, d = o.astype(np.float32), d.astype(np.float32)
        seed = rng.randint(0, 2 ** 31, 192).astype(np.uint32) if alpha == "stochastic" else None
        want = _trace_both(js, ts, o, d, np.zeros(192, np.uint8), seed=seed, alpha=alpha, max_steps=4096)
    assert int((ts.flat < 0).sum()) > 1000
    base = tt.trace(plain, *(torch.from_numpy(v[:, k].copy()) for v in (o, d) for k in range(3)),
                    torch.zeros(192, dtype=torch.uint8))
    moved = np.asarray(want.t) != base.t.numpy()
    assert np.asarray(want.hit).sum() > 96 and moved.sum() > 20, moved.sum()


def test_render_sample_close_to_jax(rendered):
    want, got = rendered
    (wc, wa, wn, wd), (gc, ga, gn, gd, steps) = want, got
    assert gc.shape == ga.shape == gn.shape == (H, W, 3) and gd.shape == (H, W)
    assert np.isfinite(gc).all() and np.isfinite(ga).all()

    def frac(g, w, tol):
        return float((np.abs(g - w).max(-1) <= tol).mean())

    assert frac(ga, wa, 1e-5) >= 0.99 and frac(gn, wn, 1e-5) >= 0.99
    assert frac(gc, wc, 1e-4) >= 0.98
    assert (np.abs(gd - wd) <= 1e-5 * np.maximum(1.0, np.abs(wd))).mean() >= 0.99
    # the frame sees sky and the volume (stone, water, a crystal, glowstone, leaves)
    assert (wd >= 1e6).any() and (wd < 1e6).mean() > 0.5
    assert steps.shape == (H, W, 4) and (steps[..., 0] > 0).mean() > 0.5 and steps[..., 2].sum() > 0


def test_accumulate_and_render_accumulate(scenes, camera_pair):
    rng = np.random.RandomState(4)
    bufs = [rng.rand(H, W, 3).astype(np.float32) for _ in range(6)]
    want = jt.accumulate(jt.FrameBuffers(*[jnp.asarray(b) for b in bufs[:3]]),
                         *[jnp.asarray(b) for b in bufs[3:]], jnp.int32(FRAME))
    got = tt.accumulate(tt.FrameBuffers(*[torch.from_numpy(b) for b in bufs[:3]]),
                        *[torch.from_numpy(b) for b in bufs[3:]], FRAME)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    _, ts = scenes
    _, tcam = camera_pair
    _, tp = _sky_pair(DAY)
    fbs = tt.init_framebuffers(H, W, device="cpu")
    for fid in range(2):
        fbs = tt.render_accumulate(fbs, ts, tcam, tp, H, W, fid)
    c0 = tt.render_sample(ts, tcam, tp, H, W, 0)
    c1 = tt.render_sample(ts, tcam, tp, H, W, 1)
    acc = tt.accumulate(tt.accumulate(tt.init_framebuffers(H, W, device="cpu"), *c0, 0), *c1, 1)
    for g, w in zip(fbs[:3], acc[:3]):
        assert torch.equal(g, w)


def test_tiles_and_device_checks(scenes, camera_pair):
    _, ts = scenes
    _, tcam = camera_pair
    _, tp = _sky_pair(NIGHT)
    full = tt.render_sample(ts, tcam, tp, H, W, FRAME, want_depth=True)
    tile = tt.render_sample(ts, tcam, tp, 5, 7, FRAME, row0=9, full_height=H, col0=4, full_width=W,
                            want_depth=True)
    for f, t in zip(full, tile):
        assert torch.equal(f[9:14, 4:11], t)
    meta = tc.CameraParams(*(v.to("meta") for v in tcam))
    with pytest.raises(ValueError):
        tt.render_sample(ts, meta, tp, H, W, FRAME)
    with pytest.raises(ValueError):
        tt.trace(ts, *(torch.zeros(2) for _ in range(6)), torch.zeros(2, dtype=torch.uint8),
                 alpha="stochastic")
