"""The port's engine (``mega_minecraft_tpu_torch/app/engine.py``) on the CPU, where every
stage takes its plain version, vs the JAX package's.

- Controls, checkpoint round trip and the four debug dumps, as ``tests/test_engine.py``
  drives the JAX engine (64x36, ``view_chunks`` 3-4, a tiny spiral).
- The scene after ``_upload_new_chunks`` equals JAX's ``_assemble_region`` +
  ``update_chunks`` bucket by bucket on the same slot-table chunks, bit for bit.  The
  chunks are written into the slot table by hand (seeded volumes, one allocated chunk
  not DRAWABLE), since a CPU drain to DRAWABLE chunks takes minutes.
- The frame path as a whole: the engine ticks static -> moving -> moving over that scene
  and presents (denoise with nsamp, 2x upscale, ACES); the JAX functions run the same
  chain (``render_accumulate_static``, ``render_accumulate_temporal`` twice,
  ``atrous_denoise(nsamp=)``, ``upscale2x``, ``present``) eagerly on the engine's own
  samples and cameras (its K11 is held to JAX in ``tests/test_torch_render.py``).
  Tolerances: the history within 1e-5 on >= 99.9% of pixels and nsamp equal on >= 99.9%;
  the presented frame <= 1 step on <= 0.1% of its u8 channels.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mega_minecraft_tpu.app import engine as je
from mega_minecraft_tpu.render import brickmap as jb
from mega_minecraft_tpu.render import camera as jc
from mega_minecraft_tpu.render import denoise as jd
from mega_minecraft_tpu.render import reproject as jr
from mega_minecraft_tpu.render import tonemap as jtm
from mega_minecraft_tpu.render import tracer as jt
from mega_minecraft_tpu_torch.app.engine import Engine, EngineConfig, flythrough
from mega_minecraft_tpu_torch.render import tracer
from mega_minecraft_tpu_torch.terrain import heightfield
from mega_minecraft_tpu_torch.terrain.scheduler import ChunkState

from test_torch_brickmap import scene_volume

#: chunks written into the slot table as DRAWABLE, and one loaded chunk that is not
DRAWN = [(-2, -2), (0, -1), (-1, 0), (0, 0), (1, -2), (1, 1)]
NOT_DRAWN = (-1, -2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs its files in several processes on the same
    cores, where torch's spinning thread pools would starve each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny(**kw) -> EngineConfig:
    base = dict(width=64, height=36, view_chunks=3, gen_radius=0, capacity=64, device="cpu",
                native_scheduler=False)
    base.update(kw)
    return EngineConfig(**base)


def stocked_engine(**kw) -> Engine:
    """An engine on a 4x4-chunk window whose slot table holds DRAWN (seeded volumes) as
    DRAWABLE and NOT_DRAWN (stone) as FILLED, all of them newly filled; the camera looks
    down at them and stays off the streaming window (freecam)."""
    eng = Engine(tiny(view_chunks=4, **kw))
    t = eng.scheduler.t
    vol = scene_volume(3, 64)
    for cx, cz in DRAWN + [NOT_DRAWN]:
        s = t.alloc((cx, cz))
        z, x = (cz + 2) * 16, (cx + 2) * 16
        t.d_blocks[s] = torch.from_numpy(vol[z:z + 16, x:x + 16].copy())
        t.state[s] = int(ChunkState.DRAWABLE)
    s = eng.scheduler.slot_for(NOT_DRAWN)
    t.d_blocks[s] = 1
    t.state[s] = int(ChunkState.FILLED)
    eng.scheduler.newly_filled.extend(DRAWN + [NOT_DRAWN])
    eng.freecam = True
    eng.player.pos = np.array([0.0, 150.0, -30.0], np.float32)
    eng.player.phi = -0.6
    return eng


def test_upload_equals_jax_assemble_and_update():
    eng = stocked_engine()
    empty = eng.scene.flat.clone()
    assert eng._upload_new_chunks() and not eng.scheduler.newly_filled
    d_blocks = jnp.asarray(eng.scheduler.t.d_blocks.numpy())
    scene = jb.empty_scene(64, -2, -2)
    G = Engine.UPLOAD_BUCKET
    drawable = int(ChunkState.DRAWABLE)
    n_buckets = 0
    for bz, bx in sorted({((p[1] + 2) // G, (p[0] + 2) // G) for p in DRAWN + [NOT_DRAWN]}):
        gz, gx = min(G, 4 - bz * G), min(G, 4 - bx * G)
        slots, mask = np.zeros(gz * gx, np.int32), np.zeros(gz * gx, bool)
        for dz in range(gz):
            for dx in range(gx):
                p = (-2 + bx * G + dx, -2 + bz * G + dz)
                s = eng.scheduler.slot_for(p)
                if s >= 0 and eng.scheduler.state_at(p) == drawable:
                    slots[dz * gx + dx], mask[dz * gx + dx] = s, True
        region = je._assemble_region(d_blocks, jnp.asarray(slots), jnp.asarray(mask), gz, gx)
        scene = jb.update_chunks(scene, region, bz * G * 16, bx * G * 16)
        n_buckets += 1
    assert n_buckets == 3
    np.testing.assert_array_equal(eng.scene.flat.numpy(), np.asarray(scene.flat))
    assert eng.scene.origin == tuple(int(v) for v in np.asarray(scene.origin)) == (-32, 0, -32)
    assert (eng.scene.flat != empty).sum() > 100000
    # the chunk that is not DRAWABLE stayed air (its stone never reached the scene)
    field = eng.scene.field
    assert bool(((field[0:16, 16:32] & 0xFF) >= 139).all())
    # a destroyed chunk is cleared by its bucket's refresh
    t = eng.scheduler.t
    t.state[eng.scheduler.slot_for((1, 1))] = int(ChunkState.FILLED)
    eng.scheduler.vbos_destroyed.append((1, 1))
    assert eng._remove_far_chunks()
    assert bool(((eng.scene.field[48:64, 48:64] & 0xFF) >= 139).all())
    assert not eng._refresh_buckets([(9, 9)])  # outside the window: nothing to do


def _jax_cam(cam):
    return jc.CameraParams(*(jnp.asarray(t.numpy()) for t in cam))


def test_frame_path_close_to_jax(monkeypatch):
    eng = stocked_engine(use_upscaling=True)
    eng._upload_new_chunks()
    samples, cams = [], []
    render = tracer.render_sample

    def recording(scene, cam, params, *a, **k):
        out = render(scene, cam, params, *a, **k)
        samples.append(out)
        cams.append(cam)
        return out

    monkeypatch.setattr(tracer, "render_sample", recording)
    for move in ((0.0, 0.0, 0.0), (0.0, 0.0, 1.5), (0.3, 0.0, 1.5)):
        eng.tick(1.0 / 30.0, move=move)
    assert eng.frame_id == 3 and len(samples) == 3
    assert float(eng.fbs.nsamp.max()) == 3.0
    img = eng.present()
    assert img.shape == (36, 64, 3) and img.dtype == np.uint8

    h, w = eng.render_h, eng.render_w
    queue = [tuple(jnp.asarray(t.numpy()) for t in s) for s in samples]
    monkeypatch.setattr(jt, "render_sample", lambda *a, **k: queue.pop(0))
    with jax.disable_jit():
        fbs = jt.init_framebuffers(h, w, temporal=True)
        fbs = jr.render_accumulate_static(fbs, None, _jax_cam(cams[0]), None, h, w, 0)
        for i in (1, 2):
            fbs = jr.render_accumulate_temporal(fbs, None, _jax_cam(cams[i - 1]), _jax_cam(cams[i]), None, h,
                                                w, i)
        color = jd.atrous_denoise(fbs.color, fbs.albedo, fbs.normal, nsamp=fbs.nsamp)
        want = np.asarray(jtm.present(jd.upscale2x(color)))
    for name, g, wv in zip(("color", "albedo", "normal"), eng.fbs, fbs):
        d = np.abs(g.numpy() - np.asarray(wv)).max(-1)
        assert (d <= 1e-5).mean() >= 0.999, (name, float(d.max()))
    assert (eng.fbs.nsamp.numpy() == np.asarray(fbs.nsamp)).mean() >= 0.999
    diff = np.abs(img.astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, (diff.max(), (diff > 0).mean())
    assert img.std() > 5.0  # terrain and sky in the frame


def test_frame_id_path_without_reprojection():
    eng = stocked_engine(use_reprojection=False, use_denoising=False)
    eng._upload_new_chunks()
    eng.tick(1.0 / 30.0)
    eng.tick(1.0 / 30.0)
    assert eng.frame_id == 2 and eng.fbs.nsamp is None
    eng.tick(1.0 / 30.0, move=(0.0, 0.0, 1.0))  # a camera change resets the accumulation
    assert eng.frame_id == 1
    assert eng.present().shape == (36, 64, 3)


def test_zoom_resets_accumulation():
    eng = Engine(tiny())
    eng.frame_id = 5
    eng.set_zoomed(True)
    assert eng.player.zoomed and eng.frame_id == 0
    assert float(eng.fbs.nsamp.max()) == 0.0
    eng.frame_id = 7
    eng.set_zoomed(True)  # already zoomed: nothing changes
    assert eng.frame_id == 7


def test_time_pause_and_add():
    eng = Engine(tiny())
    st0 = eng.sun_time
    eng.toggle_time_paused()
    assert eng.time_paused
    eng.add_time(10.0)
    assert eng.sun_time == st0 + 10.0 * eng.cfg.sun_speed and eng.frame_id == 0


def test_checkpoint_roundtrip(tmp_path):
    eng = Engine(tiny())
    eng.player.pos = np.array([12.0, 180.0, -4.0], np.float32)
    eng.player.theta, eng.player.phi = 0.7, -0.2
    eng.sun_time, eng.time = 3.3, 42.0
    eng.scheduler.t.alloc((1, 2))
    eng.scheduler.t.alloc((-3, 4))
    path = str(tmp_path / "ckpt.json")
    eng.save_checkpoint(path)
    other = Engine(tiny())
    other.load_checkpoint(path, regenerate=False)
    np.testing.assert_allclose(other.player.pos, eng.player.pos)
    assert (other.player.theta, other.player.phi) == (eng.player.theta, eng.player.phi)
    assert (other.sun_time, other.time, other.frame_id) == (eng.sun_time, eng.time, 0)


def test_debug_dumps():
    eng = stocked_engine()
    eng.player.pos = np.array([5.0, 150.0, 7.0], np.float32)  # in chunk (0, 0)
    info = eng.debug_chunk_info()
    assert info == {"chunk": (0, 0), "state": "DRAWABLE", "slot": eng.scheduler.slot_for((0, 0)),
                    "drawable": True}
    zone = eng.debug_zone_info()
    assert zone["zone"] == (0, 0) and zone["ready"] is False and len(zone["state_grid"]) == 12
    assert zone["state_grid"][0][0] == int(ChunkState.DRAWABLE)
    assert eng.debug_column_layers().shape == (20,)
    slot = eng.scheduler.slot_for((0, 0))
    eng.scheduler.t.d_heightfield[slot] = heightfield.generate_heightfield(
        torch.tensor([[0, 0]], dtype=torch.int32))[0][0]
    assert eng.debug_force_regather()["regen_max_abs_diff"] == 0.0
    eng.scheduler.t.d_heightfield[slot, 3, 4] += 1.0
    assert eng.debug_force_regather()["regen_max_abs_diff"] == 1.0
    eng.player.pos = np.array([500.0, 150.0, 7.0], np.float32)
    assert eng.debug_chunk_info()["state"] == "UNLOADED" and eng.debug_force_regather()["slot"] == -1
    assert np.isnan(eng.debug_column_layers()).all()


def test_native_zone_info_and_sizes():
    """The native scheduler's zone_info, the upscaling render size and the small-radius
    erosion fallback."""
    eng = Engine(tiny(native_scheduler=True, use_upscaling=True))
    assert eng.scheduler.zone_info((0, 0)) == {"ready": False, "queued": None}
    assert (eng.render_w, eng.render_h) == (32, 18) and eng.fbs.color.shape == (18, 32, 3)
    assert Engine(tiny(gen_radius=4, view_chunks=5)).scheduler.skip_erosion


def test_flythrough_runs_on_cpu():
    out = flythrough(n_frames=2, cfg=tiny(width=16, height=8), warmup_drain=False)
    assert out["frames"] == 2 and out["image"].shape == (8, 16, 3) and out["ms_per_frame"] > 0
