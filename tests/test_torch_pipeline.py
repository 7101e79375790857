"""The port's slice vs the JAX package's, stage by stage and end to end, featureless and
featured.

The JAX ``generate_area_fused(pos_halo, 1, 1, features=False)`` runs ONCE, eagerly in
exact mode (``jax.disable_jit()`` + ``hashes.exact_scope(True)``: no XLA program is
compiled), for the 1x1-chunk area at the golden chunk (592, -368) with its halo.  Its
intermediates feed each port stage through ``tables.from_jax_outputs``, so every stage
sees exactly the JAX stage's inputs.  Tolerances:
- heightfield, weights, layers: max |diff| <= 1e-3 and >= 99.9% within 1e-5;
- cave starts / ends / biomes: agreement >= 0.999;
- blocks: agreement >= 0.9999, featureless and featured.
The featured JAX slice is the same run's outputs sent on through the JAX feature half
(placements, lists, area-level SDF features, decorators), again eagerly.  The CUDA
kernels themselves run only on a GPU (``tests/test_torch_cuda.py``; on a card
``python3 chip_smoke.py`` checks them at full size).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mega_minecraft_tpu.ops import hashes as jh
from mega_minecraft_tpu.terrain import decorators as j_decorators
from mega_minecraft_tpu.terrain import feature_placement as j_fp
from mega_minecraft_tpu.terrain import features as j_features
from mega_minecraft_tpu.terrain import heightfield as j_heightfield
from mega_minecraft_tpu.terrain import pipeline as j_pipeline
from mega_minecraft_tpu.world.blocks import Block
from mega_minecraft_tpu_torch.app import generate_demo
from mega_minecraft_tpu_torch.tables import from_jax_outputs
from mega_minecraft_tpu_torch.terrain import caves, fill, heightfield, layers, pipeline

ORIGIN_CHUNK = (592 // 16, -368 // 16)  # golden chunk (592, -368): cave-dense


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs its files in several processes on the same
    cores, where torch's spinning thread pools would starve each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pos_halo():
    return pipeline.chunk_positions(ORIGIN_CHUNK[0] - 1, ORIGIN_CHUNK[1] - 1, 3, 3, device="cpu")


@pytest.fixture(scope="module")
def jax_area():
    """The JAX stage outputs (numpy): the fused area plus its halo'd stage-1 output,
    recorded from inside the one generate_area_fused run (no second stage-1 run)."""
    pos_halo = _pos_halo().numpy()
    stage1 = j_heightfield.generate_heightfield
    seen = []

    def recording_stage1(*args, **kw):
        seen.append(stage1(*args, **kw))
        return seen[-1]

    j_heightfield.generate_heightfield = recording_stage1
    try:
        with jax.disable_jit(), jh.exact_scope(True):
            out = j_pipeline.generate_area_fused(jnp.asarray(pos_halo), 1, 1, features=False)
            out = jax.tree_util.tree_map(np.asarray, out)
    finally:
        j_heightfield.generate_heightfield = stage1
    (hf_h, w_h), = seen
    out["hf_halo"], out["w_halo"], out["pos_halo"] = np.asarray(hf_h), np.asarray(w_h), pos_halo
    return out


@pytest.fixture(scope="module")
def jax_in(jax_area):
    """The JAX outputs as port tensors (stage inputs)."""
    d = dict(jax_area)
    halo = {"heightfield": d.pop("hf_halo"), "biome_weights": d.pop("w_halo"),
            "pos_halo": d.pop("pos_halo")}
    return {"halo": from_jax_outputs(halo, "cpu"), **from_jax_outputs(d, "cpu")}


@pytest.fixture(scope="module")
def port_area():
    return pipeline.generate_area_fused(_pos_halo(), 1, 1)


def _close(got, want):
    d = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert d.max() <= 1e-3, d.max()
    assert (d <= 1e-5).mean() >= 0.999, (d <= 1e-5).mean()


def test_stage1_heightfield(jax_area, jax_in):
    hf, w = heightfield.generate_heightfield(jax_in["halo"]["pos_halo"])
    _close(hf, jax_area["hf_halo"])
    _close(w, jax_area["w_halo"])


def test_stage2_layers(jax_area, jax_in):
    h = jax_in["halo"]
    st = layers.layers_from_halo(h["heightfield"], h["biome_weights"], h["pos_halo"], 1, 1)
    _close(st["layers"], jax_area["layers"])
    np.testing.assert_array_equal(st["heightfield"].numpy(), jax_area["heightfield"])
    np.testing.assert_array_equal(st["biome_weights"].numpy(), jax_area["biome_weights"])
    np.testing.assert_array_equal(st["chunk_pos"].numpy(), jax_area["chunk_pos"])


@pytest.mark.parametrize("key", ["starts", "ends", "bottom_biome", "top_biome"])
def test_stage4_caves(jax_area, jax_in, key):
    cv = caves.generate_caves(jax_in["heightfield"], jax_in["biome_weights"], jax_in["chunk_pos"])
    assert cv[key].dtype == torch.int32
    assert (cv[key].numpy() == jax_area["caves"][key]).mean() >= 0.999


def test_stage5_fill(jax_area, jax_in):
    c = jax_in["caves"]
    blocks = fill.fill_chunks(jax_in["heightfield"], jax_in["biome_weights"], jax_in["layers"],
                              c["starts"], c["ends"], jax_in["chunk_pos"])
    assert blocks.dtype == torch.uint8 and blocks.shape == (1, 16, 16, 384)
    assert (blocks.numpy() == jax_area["blocks"]).mean() >= 0.9999


def test_slice_blocks(jax_area, port_area):
    assert (port_area["blocks"].numpy() == jax_area["blocks"]).mean() >= 0.9999


@pytest.mark.parametrize("key", ["heightfield", "biome_weights", "layers"])
def test_slice_float_outputs(jax_area, port_area, key):
    _close(port_area[key], jax_area[key])


def test_slice_caves_and_origins(jax_area, port_area):
    for key, want in jax_area["caves"].items():
        assert (port_area["caves"][key].numpy() == want).mean() >= 0.999
    np.testing.assert_array_equal(port_area["chunk_pos"].numpy(), jax_area["chunk_pos"])


@pytest.fixture(scope="module")
def port_featured():
    return pipeline.generate_area_fused(_pos_halo(), 1, 1, features=True)


def test_featured_slice_blocks(jax_area, port_featured):
    """``generate_area_fused(..., features=True)`` 1x1 against the JAX one."""
    a = {k: jnp.asarray(v) for k, v in jax_area.items() if k != "caves"}
    cv = {k: jnp.asarray(v) for k, v in jax_area["caves"].items()}
    with jax.disable_jit(), jh.exact_scope(True):
        pl = j_fp.generate_placements(a["heightfield"], a["biome_weights"], a["layers"], cv["starts"],
                                      cv["ends"], cv["bottom_biome"], cv["top_biome"], a["chunk_pos"])
        lists = j_fp.compact_placements(pl, a["chunk_pos"])
        featured = j_features.apply_features_area(a["blocks"], lists["surface"], lists["cave"],
                                                  a["chunk_pos"], 1, 1)
        want = np.asarray(j_decorators.place_decorators_batch(
            featured, a["heightfield"], a["biome_weights"], cv["starts"], cv["ends"],
            cv["bottom_biome"], a["chunk_pos"]))
    assert (np.asarray(featured) != jax_area["blocks"]).sum() > 500, "vacuous: no feature block"
    assert (want != np.asarray(featured)).sum() > 0, "vacuous: no decorator"
    assert (port_featured["blocks"].numpy() == want).mean() >= 0.9999
    for kind in ("surface", "cave"):
        np.testing.assert_array_equal(port_featured["placements"][kind]["count"].numpy(),
                                      np.asarray(lists[kind]["count"]))


def test_demo_render_writes_the_render_chain(tmp_path, capsys):
    """``--render`` on the CPU: a 1x1 area at 16x12 with 2 samples to a binary PPM, equal
    byte for byte to build_scene -> render_sample + accumulate -> atrous_denoise ->
    present on the same area from the demo's camera."""
    from mega_minecraft_tpu_torch.render import brickmap, camera, denoise, sky, tonemap, tracer

    cx, cz = ORIGIN_CHUNK
    path = str(tmp_path / "frame.ppm")
    argv = ["--device", "cpu", "--chunks", "1", "--origin", str(cx), str(cz), "--render", path,
            "--width", "16", "--height", "12", "--spp", "2"]
    assert generate_demo.main(argv) == 0
    assert f"wrote {path}" in capsys.readouterr().out
    data = open(path, "rb").read()
    header = b"P6\n16 12\n255\n"
    assert data[:len(header)] == header and len(data) == len(header) + 16 * 12 * 3
    got = np.frombuffer(data[len(header):], np.uint8).reshape(12, 16, 3)

    area = pipeline.generate_area(cx, cz, 1, 1, device="cpu")
    scene = brickmap.build_scene(area["blocks"], cx, cz)
    player = camera.Player(pos=np.array([(cx + 0.5) * 16, float(area["heightfield"].max()) + 14.0,
                                         cz * 16 - 40.0], np.float32), theta=0.0, phi=-0.3)
    cam = player.camera_params(16, 12, device="cpu")
    params = sky.sky_params(1.0, 0.0, device="cpu")
    fbs = tracer.init_framebuffers(12, 16, device="cpu")
    for fid in range(2):
        fbs = tracer.accumulate(fbs, *tracer.render_sample(scene, cam, params, 12, 16, fid), fid)
    want = tonemap.present(denoise.atrous_denoise(fbs.color, fbs.albedo, fbs.normal)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.std() > 0, "a flat frame"


@pytest.mark.parametrize("extra,want", [
    ([], dict(chunks=5, origin=None, device="cuda", features=False, width=640, height=360, spp=8)),
    (["--width", "320", "--height", "180", "--spp", "2", "--device", "cpu", "--chunks", "3"],
     dict(chunks=3, device="cpu", width=320, height=180, spp=2)),
], ids=["defaults", "overrides"])
def test_demo_render_flags_parse(extra, want):
    """``--render`` takes JAX's --width / --height / --spp, with its defaults."""
    args = generate_demo.parse_args(["--render", "out.png", *extra])
    assert args.render == "out.png"
    assert {k: getattr(args, k) for k in want} == want


@pytest.mark.parametrize("ncx,ncz", [(1, 1), (24, 23), (25, 24)])
def test_erode_needs_one_zone_grid(ncx, ncz):
    """As in JAX: erosion erodes the area as one 24x24-chunk zone grid or raises."""
    with pytest.raises(ValueError, match="24x24"):
        pipeline.generate_area(0, 0, ncx, ncz, erode=True, device="cpu")


def test_fused_features_returns_documented_shapes(port_featured, port_area):
    out = port_featured
    assert out["blocks"].shape == (1, 16, 16, 384) and out["blocks"].dtype == torch.uint8
    assert (out["blocks"] != port_area["blocks"]).sum() > 500
    assert torch.equal(out["heightfield"], port_area["heightfield"])
    assert set(out["placements"]) == {"surface", "cave"}


def test_generate_area_features_returns_placements():
    out = pipeline.generate_area(ORIGIN_CHUNK[0], ORIGIN_CHUNK[1], 1, 1, features=True, device="cpu")
    assert out["blocks"].shape == (1, 1, 16, 16, 384) and out["blocks"].dtype == torch.uint8
    surf, cave = out["placements"]["surface"], out["placements"]["cave"]
    assert set(surf) == {"feature", "x", "y", "z", "replace", "count"}
    assert set(cave) == set(surf) | {"height"}
    assert surf["feature"].shape == (1, 256) and cave["feature"].shape == (1, 1024)
    assert surf["count"].shape == (1,) and int(cave["count"]) == int((cave["feature"] > 0).sum())
    assert "placements" not in pipeline.generate_area(0, 0, 1, 1, device="cpu")


def test_demo_features_prints_feature_blocks(capsys):
    argv = ["--device", "cpu", "--features", "--chunks", "1", "--origin", *map(str, ORIGIN_CHUNK)]
    assert generate_demo.main(argv) == 0
    text = capsys.readouterr().out
    assert "feature and decorator blocks" in text
    tail = text.split("feature and decorator blocks")[1]
    assert "MUSHROOM" in tail


def test_demo_histogram_and_shade_map():
    blocks = torch.zeros((1, 16, 16, 384), dtype=torch.uint8)
    blocks[..., 0] = int(Block.BEDROCK)
    blocks[..., 1:100] = int(Block.STONE)
    lines = generate_demo.histogram_lines(blocks)
    assert [ln.split()[0] for ln in lines] == ["AIR", "STONE", "BEDROCK"]
    assert int(lines[2].split()[1]) == 256
    hf = torch.arange(256, dtype=torch.float32).reshape(1, 16, 16)
    shade = generate_demo.shade_map_lines(hf, 1)
    assert len(shade) == 8 and all(len(s) == 2 + 16 for s in shade)
    assert shade[0] == " " * 18  # the lowest rows are the lightest shade
    assert shade[-1][-1] == generate_demo.SHADES[-1]
