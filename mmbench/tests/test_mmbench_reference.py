"""The frozen reference equals the port's plain stages at a tiny size on the CPU: a chunk
of a featured area, a chunk of the streaming world (the slot path's gather), a scene's
fields and a presented frame.  (On the card the port's kernels equal the same plain stages
bit for bit, ``chip_smoke.py``; a benchmark run compares them with this reference.)"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from mmbench.reference import chunk as ref_chunk
from mmbench.reference import frame as ref_frame
from mmbench.reference.render.brickmap import Scene as RefScene

CPU = torch.device("cpu")
AREA = (9, -4, 3)  # chunk x, chunk z, side


@pytest.fixture(scope="module")
def area():
    from mega_minecraft_tpu_torch.terrain import pipeline

    cx, cz, n = AREA
    return pipeline.generate_area_fused(pipeline.chunk_positions(cx - 1, cz - 1, n + 2, n + 2, device=CPU),
                                        n, n, features=True)


@pytest.mark.parametrize("ix, iz, k", [(0, 0, 1), (1, 1, 2), (2, 1, 1), (0, 0, 3)])
def test_area_chunk_equals_the_area_path(area, ix, iz, k):
    cx, cz, n = AREA
    got = ref_chunk.area_chunks(cx, cz, n, ix, iz, k, CPU)
    cluster = [(iz + dz) * n + ix + dx for dz in range(k) for dx in range(k)]
    assert torch.equal(got["blocks"], area["blocks"][cluster])
    x0, x1, z0, z1 = got["bounds"]
    rows = [zz * n + xx for zz in range(z0, z1 + 1) for xx in range(x0, x1 + 1)]
    for key in ("heightfield", "biome_weights", "layers"):
        assert torch.equal(got[key], area[key][rows]), key
    bf16 = ref_chunk.area_chunks(cx, cz, n, ix, iz, k, CPU, precision="bf16")
    assert int((bf16["blocks"] != got["blocks"]).sum()) > 0


@pytest.mark.parametrize("k", [1, 2])
def test_streamed_chunk_equals_the_slot_path(k):
    """The port's plain slot path on a (k + 6) x (k + 6) slot table (the layers of an area
    with its halo, no erosion): its fill, ``apply_features_slots_plain`` and decorators on
    the k x k chunks in the middle."""
    from mega_minecraft_tpu_torch.terrain import caves, decorators, feature_placement as fp
    from mega_minecraft_tpu_torch.terrain import features, fill, heightfield, layers, pipeline

    cx, cz = 40, 17
    side = k + 6
    pos_halo = pipeline.chunk_positions(cx - 4, cz - 4, side + 2, side + 2, device=CPU)
    hf_h, w_h = heightfield.generate_heightfield_plain(pos_halo)
    st = layers.layers_from_halo_plain(hf_h, w_h, pos_halo, side, side, fix_backward=True)
    hf, w, ls, pos = st["heightfield"], st["biome_weights"], st["layers"], st["chunk_pos"]
    cv = caves.generate_caves_plain(hf, w, pos)
    lists = fp.compact_placements_plain(fp.generate_placements_plain(
        hf, w, ls, cv["starts"], cv["ends"], cv["bottom_biome"], cv["top_biome"], pos), pos)
    sl = torch.as_tensor([(dz + 3) * side + dx + 3 for dz in range(k) for dx in range(k)])
    nslots = torch.as_tensor(np.stack([ref_chunk.source_rows(side, dx, dz) for dz in range(k) for dx in range(k)]),
                             dtype=torch.int32)
    blocks = fill.fill_chunks_plain(hf[sl], w[sl], ls[sl], cv["starts"][sl], cv["ends"][sl], pos[sl])
    blocks = features.apply_features_slots_plain(blocks, lists["surface"], lists["cave"], nslots, pos[sl])
    blocks = decorators.place_decorators_batch_plain(blocks, hf[sl], w[sl], cv["starts"][sl], cv["ends"][sl],
                                                     cv["bottom_biome"][sl], pos[sl])
    got = ref_chunk.streamed_chunks(cx, cz, k, ls, CPU)
    assert torch.equal(got["blocks"], blocks)
    assert torch.equal(got["heightfield"], hf) and torch.equal(got["biome_weights"], w)
    for key in ("starts", "ends", "bottom_biome", "top_biome"):
        assert torch.equal(got["caves"][key], cv[key]), key


def test_scene_fields_and_frame_equal_the_port(area):
    from mega_minecraft_tpu_torch.render import brickmap, camera, denoise, reproject, sky, tonemap, tracer

    cx, cz, n = AREA
    grid = area["blocks"].reshape(n, n, 16, 16, 384)[:2, :2]
    vol = brickmap.scene_volume(grid)
    flat = brickmap.build_fields_plain(vol)
    assert torch.equal(ref_frame.scene_fields(vol), flat)
    h, w = 18, 32
    p = camera.Player()
    p.pos = np.array([cx * 16 + 8.0, 150.0, cz * 16 + 4.0], np.float32)
    p.theta, p.phi = 0.3, -0.4
    flight = ref_frame.Flight(p.pos.copy(), p.theta, p.phi)
    cam0 = p.camera_params(w, h, device="cpu")
    params = sky.sky_params(1.0, 0.5, device="cpu")
    scene = brickmap.Scene(flat, (cx * 16, 0, cz * 16), vol.shape)
    fbs = reproject.render_accumulate_static(tracer.init_framebuffers(h, w, "cpu", temporal=True), scene, cam0,
                                             params, h, w, 0)
    p.move(0.0, 0.0, 2.0)
    p.rotate(0.05, 0.0)
    cam1 = p.camera_params(w, h, device="cpu")
    new = reproject.render_accumulate_temporal(fbs, scene, cam0, cam1, params, h, w, 1)
    want = tonemap.present_plain(denoise.upscale2x_plain(denoise.atrous_denoise_plain(
        new.color, new.albedo, new.normal, nsamp=new.nsamp))).numpy()
    cam_prev = flight.camera(w, h, CPU)
    flight.step((0.0, 0.0, 2.0), (0.05, 0.0))
    img, steps, dy = ref_frame.frame(RefScene(flat, scene.origin, scene.dims), tuple(fbs), cam_prev,
                                     flight.camera(w, h, CPU), ref_frame.sky_params(1.0, 0.5, CPU), h, w, 1,
                                     upscale=True)
    assert img.shape == (2 * h, 2 * w, 3) and np.array_equal(img, want)
    assert steps.shape == (h, w, 4) and int(steps.sum()) > 0 and dy.shape == (h, w)
    ctl, _, _ = ref_frame.frame(RefScene(flat, scene.origin, scene.dims), tuple(fbs), cam_prev,
                                flight.camera(w, h, CPU), ref_frame.sky_params(1.0, 0.5, CPU), h, w, 1,
                                upscale=True, precision="bf16")
    assert int((ctl != want).sum()) > 0
