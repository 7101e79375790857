"""The port's debug renderer (``mega_minecraft_tpu_torch/render/debug_renderer.py``, the
plain version of K17) vs the JAX package's ``render_debug``, on the box scene of
``tests/test_render.py:14-22`` at 24x32.

The JAX side runs its jitted function's Python body eagerly (``__wrapped__``) in exact
mode, so XLA fuses no multiply-add outside the DDA's while loops; its frames are made
once per module (each takes 15-25 s here).  Cases: by day with no tint, with the chunk
tint and with the zone tint (its cell of 192 is the one division whose reciprocal is not
exact, so the plain version divides by a tensor), and the box scene with every second
box glowstone, whose bright pass (luminance > 1) is not empty, so the bloom is compared
too.  Tolerances: the primary rays' hit mask
equal; colour within 1e-5 relative on >= 99.9% of channels and every channel within 1e-3
(sin, exp and the DDA's floats go through each library's own code).  Also: ``_gauss_blur``
equal to JAX's at strides 1-16 on a seeded image; the frame deterministic; a tint changes
it; the dispatch runs the plain version for a CPU scene.  The kernel is held to the plain
version on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 15).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mega_minecraft_tpu.ops import hashes as jh
from mega_minecraft_tpu.render import brickmap as jb
from mega_minecraft_tpu.render import camera as jc
from mega_minecraft_tpu.render import debug_renderer as jd
from mega_minecraft_tpu.render import sky as jsky
from mega_minecraft_tpu.render import tracer as jt
from mega_minecraft_tpu_torch import tables
from mega_minecraft_tpu_torch.render import camera as tc
from mega_minecraft_tpu_torch.render import debug_renderer as td
from mega_minecraft_tpu_torch.render import render_debug
from mega_minecraft_tpu_torch.render import tracer as tt

from test_torch_cuda import box_chunks, box_volume, bright_pass_recorder

H, W = 24, 32
CASES = {"day": (False, "none"), "day-chunk": (False, "chunk"), "day-zone": (False, "zone"),
         "emissive": (True, "none")}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs its files in several processes on the same
    cores, where torch's spinning thread pools would starve each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scenes():
    """{glow: (JAX scene, port scene)}: the box scene, and with glowstone boxes."""
    out = {}
    for glow in (False, True):
        js = jb.build_scene(jnp.asarray(box_chunks(box_volume(glow))), 0, 0)
        out[glow] = js, tables.scene_from_numpy(np.asarray(js.flat), np.asarray(js.origin), js.dims, "cpu")
    return out


@pytest.fixture(scope="module")
def view():
    player = jc.Player(pos=np.array([16.0, 140.0, -8.0], np.float32), phi=-0.5)
    cam, params = player.camera_params(W, H), jsky.sky_params(1.0, 0.0)
    return (cam, params), (tables.camera_from_numpy(cam, "cpu"), tables.sky_from_numpy(params, "cpu"))


@pytest.fixture(scope="module")
def jax_frames(scenes, view):
    (cam, params), _ = view
    frames = {}
    with jh.exact_scope(True):
        for name, (glow, tint) in CASES.items():
            frames[name] = np.asarray(jd.render_debug.__wrapped__(scenes[glow][0], cam, params, H, W, tint=tint))
    return frames


@pytest.mark.parametrize("name", list(CASES))
def test_render_debug_plain_matches_jax(scenes, view, jax_frames, name):
    glow, tint = CASES[name]
    _, (cam, params) = view
    with bright_pass_recorder() as bright:
        got = td.render_debug_plain(scenes[glow][1], cam, params, H, W, tint).numpy()
    want = jax_frames[name]
    assert got.shape == want.shape == (H, W, 3) and np.isfinite(got).all()
    d = np.abs(got.astype(np.float64) - want)
    rel = d / np.maximum(np.abs(want), 1e-30)
    print(f"render_debug {name}: max |diff| {d.max():.3g}, within 1e-5 relative {(rel <= 1e-5).mean():.6f}, "
          f"bright pass {int(bright[0].sum())} pixels")
    assert (rel <= 1e-5).mean() >= 0.999, (rel <= 1e-5).mean()
    assert d.max() <= 1e-3, d.max()
    if glow:
        assert int(bright[0].sum()) > 0, "the bright pass is empty: the bloom is not compared"


@pytest.mark.parametrize("glow", [False, True], ids=["box", "emissive"])
def test_primary_hit_mask_matches_jax(scenes, view, glow):
    (jcam, _), (tcam, _) = view
    js, ts = scenes[glow]
    z = jnp.zeros((H, W), jnp.float32)
    jd_ = jc.pixel_rays(jcam, W, H, (z, z))
    jpos = [jnp.broadcast_to(jcam.position[i], (H, W)) for i in range(3)]
    want = np.asarray(jt.trace(js, *jpos, *jd_, jnp.zeros((H, W), jnp.uint8)).hit)
    zt = torch.zeros((H, W))
    td_ = tc.pixel_rays(tcam, W, H, (zt, zt))
    tpos = [tcam.position[i].expand(H, W) for i in range(3)]
    got = tt.trace(ts, *tpos, *td_, torch.zeros((H, W), dtype=torch.uint8)).hit.numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < want.mean() < 1


@pytest.mark.parametrize("stride", [1, 2, 4, 8, 16])
def test_gauss_blur_equals_jax(stride):
    img = np.random.default_rng(stride).uniform(0.0, 4.0, (20, 26, 3)).astype(np.float32)
    want = np.asarray(jd._gauss_blur(jnp.asarray(img), stride))
    np.testing.assert_array_equal(td._gauss_blur(torch.from_numpy(img), stride).numpy(), want)


def test_frame_is_deterministic_and_a_tint_changes_it(scenes, view):
    _, (cam, params) = view
    scene = scenes[False][1]
    a = td.render_debug_plain(scene, cam, params, H, W)
    assert torch.equal(a, td.render_debug_plain(scene, cam, params, H, W))
    assert float(a.min()) >= 0.0
    chunk = td.render_debug_plain(scene, cam, params, H, W, "chunk")
    zone = td.render_debug_plain(scene, cam, params, H, W, "zone")
    assert bool((a != chunk).any()) and bool((a != zone).any()) and bool((chunk != zone).any())


def test_dispatch_runs_the_plain_version_on_the_cpu(scenes, view):
    _, (cam, params) = view
    scene = scenes[True][1]
    assert torch.equal(render_debug(scene, cam, params, H, W, "zone"),
                       td.render_debug_plain(scene, cam, params, H, W, "zone"))
    with pytest.raises(ValueError, match="tint"):
        render_debug(scene, cam, params, H, W, "biome")


def test_kernel_header_has_the_debug_constants():
    """K17 reads its fog and bloom constants from the generated header, made from this
    module's values."""
    from mega_minecraft_tpu_torch.kernels import _build

    header = _build.render_tables_header()
    for name, value in (("FOG_SAMPLES", "8"), ("BLOOM_PASSES", "5"), ("FOG_DENSITY", "0.004"),
                        ("BLOOM_THRESHOLD", "1.0"), ("BLOOM_STRENGTH", "0.35")):
        assert f"#define DEBUG_{name} {value}\n" in header
    weights = ", ".join(repr(float(np.float32(v))) + "f" for v in td.BLOOM_WEIGHTS)
    assert f"float DEBUG_BLOOM_WEIGHTS[5] = {{{weights}}};" in header
    assert td.TINT_CELLS == {"none": 0, "chunk": 16, "zone": 192}
