"""The port's multi-device programs (``mega_minecraft_tpu_torch/parallel/sharding.py``)
on meshes of n CPU shards (``Mesh(["cpu"] * n)``, the counterpart of the JAX tests' virtual
CPU devices) vs the JAX package's ``parallel/sharding.py`` on the conftest's 8-device mesh.

- ``erode_zone_sharded`` on tests/test_parallel.py's grid over 1, 2, 4 and 8 shards:
  equal bit for bit to JAX's ``erode_zone_sharded`` over as many devices and to the port's
  ``erode_zone_plain``, with its sweep counts; the flat zone untouched;
- ``dp_generate`` on 4 chunks over 2 shards: blocks equal to JAX's ``_gen_stage_layers`` /
  ``_gen_stage_fill`` run eagerly in exact mode with all 24 height formulas; heightfield,
  weights and layers (``gen_stage_layers``, the plain version of K2h) within the tolerance
  tests/test_torch_pipeline.py holds K2's plain version to (max |diff| <= 1e-3, >= 99.9%
  within 1e-5), and equal bit for bit to the area path's plain K1 / K2 chain;
- ``sharded_render`` on tests/test_parallel.py's 1-chunk scene at 16x32 (JAX's scene,
  camera and sky, carried over by ``tables``) over 8 shards: equal bit for bit to the
  port's whole-frame ``render_sample``; and the lower band of a 2-shard split against
  JAX's shard body, ``render_sample(..., row0=8, full_height=16)`` run eagerly as
  tests/test_torch_render.py runs it, at that file's tolerance (albedo and normal within
  1e-5 on >= 99% of pixels, colour within 1e-4 on >= 98%);
- ``make_mesh`` raises when asked for more devices than exist, and the programs raise on
  sizes the mesh does not divide.
The kernels K2h and K9b run only on a card (``tests/test_torch_cuda.py``, ``chip_smoke.py``
phase 17).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mega_minecraft_tpu.ops import hashes as jh
from mega_minecraft_tpu.parallel import sharding as j_sharding
from mega_minecraft_tpu.render import brickmap as jb
from mega_minecraft_tpu.render import camera as jc
from mega_minecraft_tpu.render import sky as jsky
from mega_minecraft_tpu.render import tracer as jt
from mega_minecraft_tpu.world.blocks import Block
from mega_minecraft_tpu_torch import tables
from mega_minecraft_tpu_torch.parallel import sharding
from mega_minecraft_tpu_torch.render import tracer as tt
from mega_minecraft_tpu_torch.terrain import erosion, heightfield, layers, pipeline

DP_CHUNKS = np.array([[0, 0], [592, -368], [-1024, 2048], [4096, 4096]], np.int32)
H, W, FRAME = 16, 32, 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs its files in several processes on the same
    cores, where torch's spinning thread pools would starve each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cpu_mesh(n):
    return sharding.Mesh([torch.device("cpu")] * n)


def _bits(a):
    return np.asarray(a).view(np.int32)


@pytest.fixture(scope="module")
def erosion_grid():
    """tests/test_parallel.py's grid: two plateaus and a ridge, eight layers below."""
    g = np.zeros((9, 384, 384), np.float32)
    hf = np.full((384, 384), 200.0, np.float32)
    hf[:, 192:] = 150.0
    hf[100:140, :] += 20.0
    for l in range(8):
        g[l] = hf - (8 - l) * 0.8
    g[8] = hf
    return g


@pytest.fixture(scope="module")
def plain_eroded(erosion_grid):
    sweeps = []
    out = erosion.erode_zone_plain(torch.from_numpy(erosion_grid), sweeps)
    return out.numpy(), sweeps


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_erode_zone_sharded_equals_jax_and_plain(erosion_grid, plain_eroded, n):
    want, want_sweeps = plain_eroded
    assert (np.abs(want[:8] - erosion_grid[:8]) > 1e-6).mean() > 0.01, "vacuous: nothing eroded"
    jax_out = j_sharding.erode_zone_sharded(j_sharding.make_mesh(n, platform="cpu"),
                                            jnp.asarray(erosion_grid))
    sweeps = []
    got = sharding.erode_zone_sharded(_cpu_mesh(n), torch.from_numpy(erosion_grid), sweeps)
    assert got.shape == (9, 384, 384) and got.dtype == torch.float32
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(jax_out))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    assert sweeps == want_sweeps


def test_flat_zone_untouched():
    g = np.zeros((9, 384, 384), np.float32)
    for l in range(8):
        g[l] = 100.0 + l
    g[8] = 110.0
    sweeps = []
    out = sharding.erode_zone_sharded(_cpu_mesh(8), torch.from_numpy(g), sweeps)
    np.testing.assert_array_equal(_bits(out.numpy()), _bits(g))
    assert sweeps == [1] * 8


def test_erosion_band_flags_and_halos():
    """One band sweep: its flag slot set only where a column changed, the other slot
    cleared, and the halo rows read (an inner band sees its neighbours' rows)."""
    rows = 4
    start = torch.full((rows + 2, 384), 10.0)
    end = torch.full((rows + 2, 384), 20.0)
    acc_out, dst = torch.zeros(rows + 2, 384), torch.zeros(rows + 2, 384)
    flags = torch.tensor([0, 7], dtype=torch.int32)
    sharding.erosion_band(start, end, None, acc_out, dst, False, False, 7, flags, 0)
    assert flags.tolist() == [0, 0]  # flat: nothing changed, slot 1 cleared
    start[0, 100] = 60.0  # a high column in the halo row above pulls its neighbours up
    sharding.erosion_band(start, end, None, acc_out, dst, False, False, 7, flags, 1)
    assert flags.tolist() == [0, 1]
    assert bool((dst[1, 99:102] > 10.0).all()) and bool((dst[2:rows + 1] == 10.0).all())
    # an edge band clamps to its own row instead of reading the halo
    sharding.erosion_band(start, end, None, acc_out, dst, True, False, 7, flags, 2)
    assert flags.tolist() == [0, 0] and bool((dst[1:rows + 1] == 10.0).all())


@pytest.fixture(scope="module")
def jax_dp():
    """JAX's stage bodies on DP_CHUNKS, eagerly in exact mode (numpy)."""
    with jax.disable_jit(), jh.exact_scope(True):
        pos = jnp.asarray(DP_CHUNKS)
        hf, w, ls = j_sharding._gen_stage_layers(pos)
        blocks = j_sharding._gen_stage_fill(hf, w, ls, pos)
        return [np.asarray(v) for v in (hf, w, ls, blocks)]


def _close(got, want):
    d = np.abs(got.numpy().astype(np.float64) - want)
    assert d.max() <= 1e-3 and (d <= 1e-5).mean() >= 0.999, (d.max(), (d <= 1e-5).mean())


def test_dp_generate_equals_jax_stage_bodies(jax_dp):
    hf_j, w_j, ls_j, blocks_j = jax_dp
    pos = torch.from_numpy(DP_CHUNKS)
    blocks = sharding.dp_generate(_cpu_mesh(2), pos)
    assert blocks.shape == (4, 16, 16, 384) and blocks.dtype == torch.uint8
    np.testing.assert_array_equal(blocks.numpy(), blocks_j)
    assert bool((blocks[..., 0] == int(Block.BEDROCK)).all())
    hf, w, ls = sharding.gen_stage_layers(pos)
    for got, want in ((hf, hf_j), (w, w_j), (ls, ls_j)):
        assert got.shape == want.shape
        _close(got, want)
    # the window recomputed from noise equals the area path's gather of K1's neighbours
    # (second chunk, whose window spans biomes)
    ox, oz = DP_CHUNKS[1].tolist()
    pos_halo = pipeline.chunk_positions(ox // 16 - 1, oz // 16 - 1, 3, 3, device="cpu")
    hf_h, w_h = heightfield.generate_heightfield_plain(pos_halo)
    st = layers.layers_from_halo_plain(hf_h, w_h, pos_halo, 1, 1)
    for k, got in (("heightfield", hf), ("biome_weights", w), ("layers", ls)):
        assert torch.equal(st[k][0], got[1]), k


@pytest.fixture(scope="module")
def render_inputs():
    """tests/test_parallel.py's 1-chunk scene, camera and day sky: JAX's, and the port's
    copies of them."""
    vol = np.zeros((1, 1, 16, 16, 384), np.uint8)
    vol[..., :100] = int(Block.STONE)
    vol[..., 99:100] = int(Block.GRASS_BLOCK)
    vol[0, 0, 6:10, 6:10, 100:104] = int(Block.STONE)
    js = jb.build_scene(jnp.asarray(vol), 0, 0)
    jcam = jc.Player(pos=np.array([8.0, 120.0, -10.0], np.float32), phi=-0.5).camera_params(W, H)
    jp = jsky.sky_params(1.0, 0.0)
    port = (tables.scene_from_numpy(np.asarray(js.flat), np.asarray(js.origin), js.dims, "cpu"),
            tables.camera_from_numpy(jcam, "cpu"), tables.sky_from_numpy(jp, "cpu"))
    return (js, jcam, jp), port


def test_sharded_render_equals_whole_frame(render_inputs):
    scene, cam, params = render_inputs[1]
    *whole, depth = tt.render_sample(scene, cam, params, H, W, FRAME, want_depth=True)
    got = sharding.sharded_render(_cpu_mesh(8), scene, cam, params, H, W, FRAME)
    for g, w in zip(got, whole):
        assert g.shape == (H, W, 3) and torch.equal(g, w)
    hit = float((depth < 1e6).double().mean())
    assert 0.02 < hit < 0.98, f"the frame shows no terrain or no sky ({hit})"


def test_render_band_close_to_jax_shard_body(render_inputs):
    """The lower band of a 2-shard split vs JAX's shard body for that band."""
    (js, jcam, jp), (scene, cam, params) = render_inputs
    rows = H // 2
    *want, depth = [np.asarray(v) for v in jt.render_sample(
        js, jcam, jp, rows, W, jnp.int32(FRAME), tile_rows=None, tile_cols=None, row0=rows,
        full_height=H, want_depth=True)]
    got = [b[rows:].numpy() for b in sharding.sharded_render(_cpu_mesh(2), scene, cam, params,
                                                             H, W, FRAME)]
    # the band holds the frame's terrain (rows 0-7 show only sky)
    assert (depth < 1e6).mean() > 0.1, "the band shows little terrain"

    def frac(g, w, tol):
        return float((np.abs(g - w).max(-1) <= tol).mean())

    (gc, ga, gn), (wc, wa, wn) = got, want
    assert gc.shape == wc.shape == (rows, W, 3)
    assert frac(ga, wa, 1e-5) >= 0.99 and frac(gn, wn, 1e-5) >= 0.99
    assert frac(gc, wc, 1e-4) >= 0.98


def test_mesh_sizes_and_errors():
    with pytest.raises(ValueError):
        sharding.make_mesh(torch.cuda.device_count() + 1)
    with pytest.raises(ValueError):
        sharding.make_mesh(0)
    if torch.cuda.device_count() == 0:
        with pytest.raises(ValueError):
            sharding.make_mesh()
    mesh = _cpu_mesh(3)
    assert mesh.size == 3 and mesh.distinct_devices() == [torch.device("cpu")]
    with pytest.raises(ValueError):
        sharding.dp_generate(mesh, torch.zeros((4, 2), dtype=torch.int32))
    with pytest.raises(ValueError):
        sharding.erode_zone_sharded(_cpu_mesh(5), torch.zeros((9, 384, 384)))
    with pytest.raises(ValueError):
        sharding.sharded_render(mesh, None, None, None, 16, 32, 0)
    with pytest.raises(ValueError):
        sharding.Mesh([])
