"""The state contract of K11's wavefront (``csrc/tracer.cu``: pass 0 over the frame, then a
pass a bounce over the compacted live paths), held on the CPU with the unchanged plain code.

Pass 0 is ``_bounce(..., first=True)`` over the frame.  Each later pass gathers the paths
that are ``_active_of`` after the last one into a flat [n, 1] state that holds only the
fields the kernel's queue carries (``CARRIED``, the list in the kernel's comment), sets the
fields a later bounce takes as constants for a live path to those constants, sets every
field that is final after pass 0 to NaN, runs ``_bounce(..., first=False)`` on it and
scatters the carried fields (and the pass's counts) back.  The frame that comes out (the
colour from the pixel colour and pass 0's fog colour and fog factor) must equal
``render_sample_plain`` exactly in colour, albedo, normal, depth and the four counts: the
later bounces read nothing that the queue does not carry.

The lanes of a flat state sit at other positions of their tensors than in the frame, which
could change results only where a CPU kernel treats a tensor's tail elements apart from its
vectorized body; the equality below shows that no operation of ``_bounce`` does.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from mega_minecraft_tpu_torch.render import brickmap as tb
from mega_minecraft_tpu_torch.render import camera as tc
from mega_minecraft_tpu_torch.render import sky as tsky
from mega_minecraft_tpu_torch.render import tracer as tt
from mega_minecraft_tpu_torch.render.materials import plain_tables

from test_torch_brickmap import scene_volume

DAY, NIGHT = 1.0, 4.0  # sun_time: sun y = +0.749 and -0.758
H = W = 16
FRAME = 3
#: the state a queue slot carries between passes (csrc/tracer.cu, K11's comment), besides
#: the pixel
CARRIED = ("pos", "dir", "ray_color", "pixel_color", "seed", "depth", "medium")
#: a live path's fields that the bounce kernel takes as constants
CONSTANT = {"scatter_factor": 1.0, "scattered": False, "done": False, "needs_first": False}
#: the fields that are final after pass 0 (the colour output and the workspace keep the
#: fog colour and factor of a live path for its last pass)
FINAL = ("albedo", "normal", "fog_color", "fog_factor", "scatter_pos")
SINK = ("steps_bounce", "steps_shadow", "rays")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs its files in several processes on the same
    cores, where torch's spinning thread pools would starve each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene_and_camera():
    """tests/test_torch_render.py's scene (its seeded volume at chunk (-1, 0)) and camera."""
    chunks = scene_volume().reshape(2, 16, 2, 16, 384).transpose(0, 2, 1, 3, 4)
    scene = tb.build_scene(torch.from_numpy(np.ascontiguousarray(chunks)), -1, 0)
    player = tc.Player(pos=np.array([0.0, 112.0, -2.0], np.float32), theta=0.1, phi=-0.45)
    return scene, player.camera_params(W, H, device="cpu")


def _gather(v, idx):
    return tuple(c.reshape(-1)[idx].reshape(-1, 1) for c in v) if isinstance(v, tuple) \
        else v.reshape(-1)[idx].reshape(-1, 1)


def _scatter(dst, src, idx):
    if isinstance(dst, tuple):
        return tuple(_scatter(d, s, idx) for d, s in zip(dst, src))
    out = dst.reshape(-1).clone()
    out[idx] = src.reshape(-1)
    return out.view(dst.shape)


def _flat_state(s, idx):
    """The live paths ``idx`` of the frame state ``s`` as the bounce kernel sees them."""
    n = idx.numel()
    one = torch.ones((n, 1))
    flat = {k: _gather(s[k], idx) for k in CARRIED}
    flat["scatter_factor"] = one * CONSTANT["scatter_factor"]
    for k in ("scattered", "done", "needs_first"):
        flat[k] = torch.full((n, 1), CONSTANT[k])
    nan = one * float("nan")
    flat.update(albedo=(nan, nan, nan), normal=(nan, nan, nan), fog_color=(nan, nan, nan), fog_factor=nan,
                scatter_pos=(nan, nan, nan))
    assert set(flat) == set(s), set(s) ^ set(flat)
    assert set(FINAL) | set(CARRIED) | set(CONSTANT) == set(s)
    return flat


def _wavefront(scene, cam, params, height, width, row0, full_height, col0, full_width, exact):
    """The wavefront's frame: pass 0 over the frame, each later pass over the gathered live
    paths -> (color, albedo, normal, depth, steps, live paths by pass)."""
    s = tt._init_state(cam, height, width, FRAME, row0, full_height, col0, full_width)
    tabs = plain_tables(scene.device)
    z = torch.zeros((height, width), dtype=torch.int64)
    sink = {"steps_primary": z, "steps_bounce": z.clone(), "steps_shadow": z.clone(), "rays": z.clone()}
    s = tt._bounce(scene, params, s, True, exact, tabs, sink)
    live = tt._active_of(s).reshape(-1)
    by_pass = [height * width]
    for _ in range(1, tt.MAX_LOOP_ITERS):
        idx = live.nonzero().reshape(-1)
        if idx.numel() == 0:
            break
        by_pass.append(idx.numel())
        flat_sink = {k: torch.zeros((idx.numel(), 1), dtype=torch.int64) for k in SINK}
        out = tt._bounce(scene, params, _flat_state(s, idx), False, exact, tabs, flat_sink)
        for k in CARRIED:
            s[k] = _scatter(s[k], out[k], idx)
        for k in SINK:
            sink[k] = sink[k].reshape(-1).index_add(0, idx, flat_sink[k].reshape(-1)).view(height, width)
        live = torch.zeros_like(live)
        live[idx] = tt._active_of(out).reshape(-1)
    (pr, pg, pb), (fcr, fcg, fcb), ff = s["pixel_color"], s["fog_color"], s["fog_factor"]
    color = torch.stack([pr + (fcr - pr) * ff, pg + (fcg - pg) * ff, pb + (fcb - pb) * ff], dim=-1)
    steps = torch.stack([sink["steps_primary"], sink["steps_bounce"], sink["steps_shadow"], sink["rays"]],
                        dim=-1).to(torch.int32)
    return (color, torch.stack(s["albedo"], dim=-1), torch.stack(s["normal"], dim=-1), sink["depth"], steps,
            by_pass)


@pytest.mark.parametrize("sun_time,exact,tile", [
    (DAY, False, None), (NIGHT, False, None), (DAY, True, None), (NIGHT, True, (7, 9, 5, 3)),
    (DAY, False, (5, 7, 9, 4)),
], ids=["day", "night", "day-exact", "night-exact-tile", "day-tile"])
def test_wavefront_passes_equal_render_sample_plain(scene_and_camera, sun_time, exact, tile):
    scene, cam = scene_and_camera
    params = tsky.sky_params(sun_time, 3.0, device="cpu")
    h, w, row0, col0 = tile or (H, W, 0, 0)
    where = (row0, H, col0, W)
    *got, by_pass = _wavefront(scene, cam, params, h, w, *where, exact)
    want = tt.render_sample_plain(scene, cam, params, h, w, FRAME, *where, exact=exact)
    for name, g, wnt in zip(("color", "albedo", "normal", "depth", "steps"), got, want):
        assert g.shape == wnt.shape, name
        assert torch.equal(g, wnt), (name, float((g.double() - wnt.double()).abs().max()))
    assert bool(torch.isfinite(got[0]).all())
    assert by_pass[0] == h * w and len(by_pass) >= 2  # paths live past pass 0
    assert int(want[4][..., 3].max()) == len(by_pass)  # the longest path took every pass
