"""The CUDA kernels through the pipeline on the card vs the plain versions: K1-K4 for
the 1x1-chunk area at the golden chunk (592, -368) against the plain versions on the
CPU, K1-K8 for the featured 5x5 bench area against the plain chain run on the card, K9
on the two ``golden_erosion.npz`` grids against the plain erosion on the CPU (bit for
bit, with the same sweep counts), K3 with its Worley cell table and with every tile on
its direct path, bit for bit against the plain version (cave arrays and carve band) at
the golden chunks and two far ones; K4 with its lush-cave cell table and with every tile on
its direct path, bit for bit against the plain version at golden and far chunks that hold
lush blocks (one past |x| = 671,088,640); K7 and K7s (also without its cull) on synthetic lists that overflow K and the gather cap, bit for bit against
the plain versions, their pre-pass lists too; K5 on a batch read from a slot table (int16 / uint8 cave
rows); K7's stream pre-kernel into NaN-filled slot rows through ``out=`` / ``rows`` (the valid
rows equal the plain streams, the others stay NaN) feeding K7s; and a radius-8 streaming drain (K1, K2s, K3, K5, K6,
K7's pre-kernel, K4, K7s, K8) whose filled chunks must equal the featured area path
over all their sources.  The render path: K10 (scene fields, bit for bit), K11t (the
DDA of 1080p-camera primary rays: hit, block, normal and t equal), K11 (a 64x64 tile of
the 1080p frame, day, night and exact mode: >= 99.9% of pixels within 1e-5 in colour,
albedo, normal and depth, mean |diff| <= 1e-4, steps equal) and K12 (bit for bit) against
their plain versions on the card, on a scene built from a featured 2x2 area; the same
under ``cutout_atlas``, a hand-set atlas that reaches the alpha-cutout code (K10's flag
bits, K11t's exact park-and-resolve and stochastic pass-through on rays aimed at flagged
voxels, K11 in both trace modes with a camera aimed at one); and one launch each of K11
and K12 per ``render_accumulate``; K10 also on 36x20x384 volumes (a cut of the area and a sparse
one with solids on its faces).  The engine's frame path: K10u (``update_chunks``: a
3x3 bucket into that scene, a removal and an edge bucket, bit for bit, in place; a chain of
six buckets against the plain chain run on its own), K13 and
K13s (the blends after a moved and a static camera), K14 (with and without nsamp), K15 (also
at 1x1, 5x3, 9x7 and 960x540) and K16, each bit for bit against its plain version on the
card, and one engine tick /
present on the card with its launch counts.  The debug renderer: K17 against
``render_debug_plain`` bit for bit (and its DDA step counts) on the box scene of
``tests/test_render.py`` at 128x96, day with every tint, night, and with glowstone boxes
whose bright pass is not empty, one launch count per call.  The sharded programs
(``parallel/sharding.py``) on meshes that repeat the card: K9b over 4 row bands equal to K9
bit for bit with the same sweep counts, K2h against its plain version and bit for bit
against the area path's K1 / K2, and a 4-band ``sharded_render`` equal to the whole frame.

Every test here needs an NVIDIA GPU and nvcc: it is marked ``cuda`` and skips
without a card.  The file imports no JAX, so on a GPU machine without JAX it runs as

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``tests/conftest.py`` configures JAX).  Tolerances: heightfield, weights, layers
max |diff| <= 1e-3 and >= 99.9% within 1e-5 (``pow`` and the ravine ``sin`` go
through each platform's libm); cave arrays agreement >= 0.999; blocks >= 0.9999.  The
featured 5x5 area shares the card's libm with its plain chain: every field of the
placement lists and the blocks are equal.
"""

from __future__ import annotations

import contextlib
import math
import os

import numpy as np
import pytest
import torch

from mega_minecraft_tpu_torch import kernels, tables
from mega_minecraft_tpu_torch.render import (brickmap, camera, denoise, materials, reproject, sky, tonemap,
                                             tracer)
from mega_minecraft_tpu_torch.terrain import (caves, decorators, erosion, feature_placement, features,
                                              fill, heightfield, layers, pipeline, scheduler)
from mega_minecraft_tpu_torch.world.blocks import NUM_BLOCKS, X_SHAPED_HI, X_SHAPED_LO, Block

ORIGIN_CHUNK = (592 // 16, -368 // 16)
#: blocks whose tiles ``cutout_atlas`` makes half transparent: leaves, the X-shaped
#: flora, and the stone, grass-block and smooth-sandstone surfaces most rays reach
CUTOUT_BLOCKS = sorted({int(b) for b in Block if "LEAVES" in b.name} | set(range(X_SHAPED_LO, X_SHAPED_HI))
                       | {int(Block.STONE), int(Block.GRASS_BLOCK), int(Block.SMOOTH_SANDSTONE)})
GOLDEN_EROSION = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                              "golden_erosion.npz")


@contextlib.contextmanager
def cutout_atlas(blocks=CUTOUT_BLOCKS):
    """Swap in a diffuse table whose tiles of ``blocks`` are half transparent (a checker
    of 4x4-texel squares on every face and variant), with the alpha-flag and fraction
    tables made from it, for the plain versions and the kernels alike.  The procedural
    atlas has no transparent texel, so this is how the alpha-cutout code runs.  Yields
    (ALPHA_TESTED, ALPHA_T_FRAC); everything is restored on exit."""
    td = materials.TEX_DIFF_PACKED.copy().reshape(NUM_BLOCKS, 3, 8, 16, 16)
    v, u = np.indices((16, 16))
    hole = (u // 4 + v // 4) % 2 == 1
    for b in blocks:
        td[b][..., hole] &= ~np.uint32(1 << 24)
    td = td.reshape(-1)
    flags, frac = materials.alpha_tables(td)
    saved = materials.TEX_DIFF_PACKED, brickmap.ALPHA_TESTED, brickmap.ALPHA_T_FRAC
    try:
        materials.TEX_DIFF_PACKED, brickmap.ALPHA_TESTED, brickmap.ALPHA_T_FRAC = td, flags, frac
        materials.plain_tables.cache_clear()
        materials.kernel_tables.cache_clear()
        yield flags, frac
    finally:
        materials.TEX_DIFF_PACKED, brickmap.ALPHA_TESTED, brickmap.ALPHA_T_FRAC = saved
        materials.plain_tables.cache_clear()
        materials.kernel_tables.cache_clear()


def flagged_surface_voxels(scene, n: int, seed: int = 0) -> np.ndarray:
    """World-space centres (x, y, z) [n, 3] f32 of n alpha-flagged voxels of ``scene``
    that top their columns (open to the sky), drawn with ``seed``: targets for rays and
    cameras that must meet cutouts."""
    field = scene.field
    solid = (field & 0xFF) < brickmap.EMPTY_BASE
    yidx = torch.arange(field.shape[2], device=field.device)
    top = torch.where(solid, yidx, torch.full_like(yidx, -1)).amax(-1)  # [Z, X]
    word = torch.gather(field, 2, top.clamp(min=0)[..., None])[..., 0]
    z, x = torch.nonzero((top >= 0) & (word < 0), as_tuple=True)
    idx = torch.stack([z, x, top[z, x]], -1).cpu().numpy()  # (z, x, y)
    assert len(idx) > 0, "no flagged voxel tops its column"
    pick = idx[np.random.default_rng(seed).integers(0, len(idx), n)]
    ox, oy, oz = scene.origin
    return (np.stack([pick[:, 1] + ox, pick[:, 2] + oy, pick[:, 0] + oz], -1) + 0.5).astype(np.float32)


def rays_at(targets: np.ndarray, device, seed: int = 1):
    """(ox, oy, oz, dx, dy, dz) [n] f32 on ``device``: one ray per target, from a point
    2-24 blocks above it and up to 16 aside, through the target's voxel."""
    rng = np.random.default_rng(seed)
    n = len(targets)
    aim = targets + rng.uniform(-0.45, 0.45, (n, 3))
    o = aim + np.stack([rng.uniform(-16, 16, n), rng.uniform(2, 24, n), rng.uniform(-16, 16, n)], -1)
    d = aim - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return tuple(torch.tensor(v[:, k], dtype=torch.float32, device=device) for v in (o, d) for k in range(3))


def aimed_player(targets: np.ndarray) -> camera.Player:
    """A camera 12 blocks above and 4 before (along -z) the highest of ``targets``,
    looking steeply down at it, so that little can stand between them."""
    target = targets[int(np.argmax(targets[:, 1]))]
    return camera.Player(pos=(target + np.array([0.0, 12.0, -4.0], np.float32)).astype(np.float32),
                         theta=0.0, phi=-math.atan2(12.0, 4.0))


def box_volume(glow: bool = False) -> np.ndarray:
    """``tests/test_render.py``'s box scene, [32, 32, 384] u8 ([z, x, y]): stone below
    y = 96 and 20 seeded 3x3x4 boxes above; with ``glow`` every second box is glowstone,
    which the debug renderer lights past its bloom threshold."""
    rng = np.random.RandomState(0)
    vol = np.zeros((32, 32, 384), np.uint8)
    vol[:, :, :96] = int(Block.STONE)
    for i in range(20):
        z, x, y = rng.randint(0, 28), rng.randint(0, 28), rng.randint(96, 200)
        vol[z : z + 3, x : x + 3, y : y + 4] = int(Block.GLOWSTONE if glow and i % 2 else Block.STONE)
    return vol


def box_chunks(vol: np.ndarray) -> np.ndarray:
    """A [32, 32, 384] volume as the [2, 2, 16, 16, 384] chunk grid ``build_scene`` takes."""
    return np.ascontiguousarray(vol.reshape(2, 16, 2, 16, 384).transpose(0, 2, 1, 3, 4))


@contextlib.contextmanager
def bright_pass_recorder():
    """Record the bright pass of ``render_debug_plain`` calls (the first blur's input of
    each frame) into the yielded list, as [H, W] bool masks of the pixels it keeps."""
    from mega_minecraft_tpu_torch.render import debug_renderer

    seen, blur = [], debug_renderer._gauss_blur

    def recording(img, stride):
        if stride == 1:
            seen.append((img != 0).any(-1))
        return blur(img, stride)

    debug_renderer._gauss_blur = recording
    try:
        yield seen
    finally:
        debug_renderer._gauss_blur = blur


def _pos_halo(device="cpu"):
    return pipeline.chunk_positions(ORIGIN_CHUNK[0] - 1, ORIGIN_CHUNK[1] - 1, 3, 3, device=device)


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run python3 chip_smoke.py there)")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def plain_area():
    return pipeline.generate_area_fused(_pos_halo(), 1, 1)


def _close(got, want):
    d = (got.double() - want.double()).abs()
    assert float(d.max()) <= 1e-3
    assert float((d <= 1e-5).double().mean()) >= 0.999


@pytest.mark.cuda
def test_kernels_match_plain_on_gpu(cuda_device, plain_area):
    kernels.reset_launch_counts()
    out = pipeline.generate_area_fused(_pos_halo(cuda_device), 1, 1)
    torch.cuda.synchronize()
    gen = ("heightfield", "layers", "caves", "fill")
    assert kernels.launch_counts() == {k: int(k in gen) for k in kernels.LAUNCHES}
    assert out["blocks"].device == cuda_device
    assert (out["blocks"].cpu() == plain_area["blocks"]).double().mean() >= 0.9999
    for key in ("heightfield", "biome_weights", "layers"):
        _close(out[key].cpu(), plain_area[key])
    for key, want in plain_area["caves"].items():
        assert (out["caves"][key].cpu() == want).double().mean() >= 0.999
    assert torch.equal(out["chunk_pos"].cpu(), plain_area["chunk_pos"])


@pytest.mark.cuda
def test_featured_5x5_matches_plain_chain_on_gpu(cuda_device):
    pos = pipeline.chunk_positions(-1, -1, 7, 7, device=cuda_device)
    kernels.reset_launch_counts()
    out = pipeline.generate_area_fused(pos, 5, 5, features=True)
    torch.cuda.synchronize()
    # erosion, the scheduler's kernels, the render path's, the engine's frame path's and K17
    unused = ("erosion", "layers_slots", "features_slots", "scene_fields", "trace", "render_sample",
              "accumulate", "update_chunks", "reproject", "static_blend", "atrous_denoise", "upscale2x",
              "present", "render_debug", "dp_layers", "erosion_band")
    assert kernels.launch_counts() == {k: int(k not in unused) for k in kernels.LAUNCHES}

    hf, w = heightfield.generate_heightfield_plain(pos)
    st = layers.layers_from_halo_plain(hf, w, pos, 5, 5)
    hf_in, w_in, pos_in = st["heightfield"], st["biome_weights"], st["chunk_pos"]
    cv = caves.generate_caves_plain(hf_in, w_in, pos_in)
    blocks = fill.fill_chunks_plain(hf_in, w_in, st["layers"], cv["starts"], cv["ends"], pos_in)
    pl = feature_placement.generate_placements_plain(
        hf_in, w_in, st["layers"], cv["starts"], cv["ends"], cv["bottom_biome"], cv["top_biome"], pos_in)
    lists = feature_placement.compact_placements_plain(pl, pos_in)
    featured = features.apply_features_area_plain(blocks, lists["surface"], lists["cave"], pos_in, 5, 5)
    want = decorators.place_decorators_batch_plain(
        featured, hf_in, w_in, cv["starts"], cv["ends"], cv["bottom_biome"], pos_in)
    assert int((featured != blocks).sum()) > 0 and int((want != featured).sum()) > 0
    for kind in ("surface", "cave"):
        assert sorted(out["placements"][kind]) == sorted(lists[kind])
        for field, value in lists[kind].items():
            assert torch.equal(out["placements"][kind][field], value), (kind, field)
    assert torch.equal(out["blocks"], want)


#: chunk origins (blocks) of K3's carve checks: the golden chunks and two far ones
CARVE_CHUNKS = [(0, 0), (592, -368), (-1024, 2048), (4096, 4096), (-160, -160), (1048576, -1048576),
                (-2000000, 3000000)]


@pytest.mark.cuda
@pytest.mark.parametrize("table_cells", [caves.CELL_TABLE_CAP, 0], ids=["table", "direct"])
def test_carve_kernel_matches_plain_on_gpu(cuda_device, table_cells):
    """K3 with its cell table and with every tile on the direct path (capacity 0), bit for
    bit against the plain version: the four cave arrays and the carve band."""
    pos = torch.tensor(CARVE_CHUNKS, dtype=torch.int32, device=cuda_device)
    hf, w = kernels.heightfield(pos)
    stats = torch.zeros(2, dtype=torch.int32, device=cuda_device)
    got = kernels.caves(hf, w, pos, table_cells, stats, want_carved=True)
    direct, largest = stats.tolist()
    want = caves.generate_caves_plain(hf, w, pos)
    assert torch.equal(got.pop("carved"), caves.carve_band_plain(w, pos))
    for key, value in want.items():
        assert torch.equal(got[key], value), key
    assert 27 <= largest <= caves.CELL_TABLE_CAP
    assert (direct == 0) if table_cells else (direct > 0)


#: chunk origins (blocks) of K4's checks: golden chunks and far ones, the last past
#: |x| = 671,088,640 (its lush clay cells past 2^24); together they hold lush blocks
FILL_CHUNKS = [(0, 0), (592, -368), (-160, -160), (1048576, -1048576), (-2000000, 3000000),
               (671089664, -671092736)]


@pytest.mark.cuda
@pytest.mark.parametrize("table_cells", [tables.LUSH_TABLE_CELLS, 0], ids=["table", "direct"])
def test_fill_kernel_lush_chunks_match_plain_on_gpu(cuda_device, table_cells):
    """K4 with its lush-cave cell table and with every tile on the direct path (capacity 0),
    bit for bit against the plain version, on chunks whose lush blocks take the clay test."""
    st = [layers.layers_from_halo_plain(*heightfield.generate_heightfield_plain(p), p, 1, 1)
          for p in (pipeline.chunk_positions(ox // 16 - 1, oz // 16 - 1, 3, 3, device=cuda_device)
                    for ox, oz in FILL_CHUNKS)]
    hf, w, ls, pos = (torch.cat([d[k] for d in st]) for k in ("heightfield", "biome_weights", "layers", "chunk_pos"))
    cv = caves.generate_caves_plain(hf, w, pos)
    stats = torch.zeros(4, dtype=torch.int32, device=cuda_device)
    got = kernels.fill(hf, w, ls, cv["starts"], cv["ends"], pos, table_cells, stats)
    queued, lush, largest, direct = stats.tolist()
    assert torch.equal(got, fill.fill_chunks_plain(hf, w, ls, cv["starts"], cv["ends"], pos))
    assert queued > 0 and lush > 0 and 27 <= largest <= tables.LUSH_TABLE_CELLS
    assert (direct == 0) if table_cells else (direct > 0)


@pytest.mark.cuda
@pytest.mark.parametrize("overflow", [False, True], ids=["free", "overflow"])
def test_features_kernels_synthetic_lists_match_plain_on_gpu(cuda_device, overflow):
    """K7 and K7s (with and without its cull) on a strip of stone chunks whose lists overflow
    K and the gather cap, bit for bit against the plain versions, their pre-pass lists too."""
    from test_torch_feature_cull import _overflowing, _slot_table, _strip

    blocks, lists, pos = _strip()
    if overflow:
        lists = _overflowing(lists)
    to = lambda d: {k: v.to(cuda_device) for k, v in d.items()}  # noqa: E731
    blocks_d, pos_d, lists_d = blocks.to(cuda_device), pos.to(cuda_device), {k: to(d) for k, d in lists.items()}
    streams = kernels.feature_streams(lists_d["surface"], lists_d["cave"])
    got, got_lists = kernels.features(blocks_d, lists_d["surface"], lists_d["cave"], *streams, pos_d, 3, 1,
                                      want_lists=True)
    want = features.apply_features_area_plain(blocks, lists["surface"], lists["cave"], pos, 3, 1)
    assert torch.equal(got.cpu(), want)
    for kind in ("surface", "cave"):
        p_lists, p_len = features.cull_area_plain(lists[kind], pos, 3, 1, kind == "cave")
        k_lists, k_len = got_lists[kind]
        assert torch.equal(k_len.cpu(), p_len)
        keep = torch.arange(p_lists.shape[1])[None, :] < p_len[:, None]
        assert torch.equal(k_lists.cpu()[keep][:, :7], p_lists[keep][:, :7])

    table, nslots = _slot_table(lists, 3, 1)
    table_d = {k: to(d) for k, d in table.items()}
    sstreams = kernels.feature_streams(table_d["surface"], table_d["cave"])
    want = features.apply_features_slots_plain(blocks, table["surface"], table["cave"], nslots, pos)
    for cull in (True, False):
        got, got_lists = kernels.features_slots(blocks_d, table_d["surface"], table_d["cave"], *sstreams,
                                                nslots.to(cuda_device), pos_d, cull=cull, want_lists=True)
        assert torch.equal(got.cpu(), want), cull
        for kind in ("surface", "cave"):
            p_lists, p_len = features.cull_slots_plain(table[kind], nslots, pos, kind == "cave", cull)
            k_lists, k_len = got_lists[kind]
            assert torch.equal(k_len.cpu(), p_len)
            keep = torch.arange(p_lists.shape[1])[None, :] < p_len[:, None]
            assert torch.equal(k_lists.cpu()[keep][:, :7], p_lists[keep][:, :7])


@pytest.mark.cuda
def test_placements_kernel_on_a_slot_table_batch_matches_plain_on_gpu(cuda_device):
    """K5 on a batch read from a slot table as the drain reads it (the cave rows stored int16 /
    uint8, converted to int32), bit for bit against the plain version."""
    pos = pipeline.chunk_positions(-1, -1, 4, 3, device=cuda_device)
    st = layers.layers_from_halo_plain(*heightfield.generate_heightfield_plain(pos), pos, 2, 1)
    cv = caves.generate_caves_plain(st["heightfield"], st["biome_weights"], st["chunk_pos"])
    t = scheduler.TerrainState(8, device=cuda_device)
    rows = torch.tensor([5, 2], device=cuda_device)
    t.d_heightfield[rows], t.d_weights[rows], t.d_layers[rows] = st["heightfield"], st["biome_weights"], st["layers"]
    for name, key, dtype in (("starts", "starts", torch.int16), ("ends", "ends", torch.int16),
                             ("bottom", "bottom_biome", torch.uint8), ("top", "top_biome", torch.uint8)):
        getattr(t, f"d_cave_{name}")[rows] = cv[key].to(dtype)
    args = (*scheduler._rows(t, rows), *scheduler._cave_rows(t, rows, ("starts", "ends", "bottom", "top")),
            st["chunk_pos"])
    want = feature_placement.generate_placements_plain(*args)
    assert int((want["cave_feature"] > 0).sum()) + int((want["surface_feature"] > 0).sum()) > 0
    got = kernels.placements(*args)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


@pytest.mark.cuda
@pytest.mark.parametrize("overflow", [False, True], ids=["free", "overflow"])
def test_feature_streams_into_slot_rows_feed_k7s_on_gpu(cuda_device, overflow):
    """K7a with ``out=`` / ``rows`` into NaN-filled slot tables: the valid rows equal the plain
    streams, the others stay NaN, and K7s on those tables equals its plain version."""
    from test_torch_feature_cull import _overflowing, _slot_table, _strip

    blocks, lists, pos = _strip()
    if overflow:
        lists = _overflowing(lists)
    table, nslots = _slot_table(lists, 3, 1)  # row b = chunk b, row 3 empty
    to = lambda d: {k: v.to(cuda_device) for k, v in d.items()}  # noqa: E731
    table_d = {k: to(d) for k, d in table.items()}
    out = tuple(torch.full((4, K, 64), float("nan"), device=cuda_device) for K in (256, 1024))
    # the batch in another order than the table's rows
    order = torch.tensor([2, 0, 1], device=cuda_device)
    batch = {k: {f: v[order] for f, v in d.items()} for k, d in table_d.items()}
    kernels.feature_streams(batch["surface"], batch["cave"], out=out, rows=order.to(torch.int32))
    want = features.draw_streams_plain(table["surface"], table["cave"])
    for (kind, K), got, w in zip((("surface", 256), ("cave", 1024)), out, want):
        valid = torch.arange(K)[None, :] < torch.clamp(table[kind]["count"], max=K)[:, None]
        assert bool(valid.any())
        assert torch.equal(got.cpu()[valid], w[valid])
        assert bool(torch.isnan(got.cpu()[~valid]).all())
    got = kernels.features_slots(blocks.to(cuda_device), table_d["surface"], table_d["cave"], *out,
                                 nslots.to(cuda_device), pos.to(cuda_device))
    assert torch.equal(got.cpu(), features.apply_features_slots_plain(blocks, table["surface"], table["cave"],
                                                                      nslots, pos))


@pytest.mark.cuda
@pytest.mark.parametrize("key", ["0_0", "400_-560"])
def test_erosion_kernel_matches_plain_on_gpu(cuda_device, key):
    grid = np.load(GOLDEN_EROSION)[f"input_{key}"]
    sweeps = []
    want = erosion.erode_zone_plain(torch.from_numpy(grid), sweeps)
    kernels.reset_launch_counts()
    got, iters = kernels.erode_zone(torch.from_numpy(grid).to(cuda_device))
    torch.cuda.synchronize()
    assert kernels.launch_counts()["erosion"] == 1
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))
    assert iters.cpu().tolist() == sweeps


@pytest.mark.cuda
def test_radius8_drain_matches_area_path_on_gpu(cuda_device):
    s = scheduler.make_scheduler(1024, 8, skip_erosion=True, native=True, device=cuda_device)
    s.set_player_pos(0.0, 0.0)
    kernels.reset_launch_counts()
    s.drain()
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    for name in ("heightfield", "layers_slots", "caves", "placements", "compact_placements",
                 "feature_streams", "fill", "features_slots", "decorators"):
        assert counts[name] > 0, name
    assert counts["layers"] == counts["features"] == counts["erosion"] == 0
    # the chunks within 4 of the centre are filled; their sources lie within 7
    area = pipeline.generate_area_fused(pipeline.chunk_positions(-8, -8, 17, 17, device=cuda_device),
                                        15, 15, features=True)
    blocks = area["blocks"].reshape(15, 15, 16, 16, 384)
    for dz in range(-4, 5):
        for dx in range(-4, 5):
            assert s.state_at((dx, dz)) >= int(scheduler.ChunkState.FILLED)
            got = s.t.d_blocks[s.slot_for((dx, dz))]
            assert torch.equal(got, blocks[7 + dz, 7 + dx]), (dx, dz)


@pytest.fixture(scope="module")
def render_scene(cuda_device):
    """A featured 2x2 area at chunk (-1, -1) as a scene, and the 1080p bench camera."""
    out = pipeline.generate_area_fused(pipeline.chunk_positions(-2, -2, 4, 4, device=cuda_device),
                                       2, 2, features=True)
    blocks = out["blocks"].reshape(2, 2, 16, 16, 384)
    hmax = float(out["heightfield"].max())
    player = camera.Player(pos=np.array([0.0, hmax + 16.0, -30.0], np.float32), theta=0.05, phi=-0.22)
    return brickmap.build_scene(blocks, -1, -1), player, blocks


def _frac_close(got, want, tol=1e-5):
    d = (got.double() - want.double()).abs()
    if d.dim() == 3:
        d = d.amax(-1)
    return float((d <= tol).double().mean()), float(d.mean())


@pytest.mark.cuda
def test_scene_fields_kernel_matches_plain_on_gpu(render_scene):
    scene, _, blocks = render_scene
    want = brickmap.build_fields_plain(brickmap.scene_volume(blocks))
    assert torch.equal(scene.flat, want)


@pytest.mark.cuda
@pytest.mark.parametrize("source", ["cut_area", "random_mask"])
def test_scene_fields_kernel_on_cut_dims_on_gpu(cuda_device, render_scene, source):
    """K10 on 36x20x384 (multiples of 4, not of a 4x4 group's 16 columns in z or x): the
    featured area tiled and cut, and a sparse seeded volume with solids on its six faces;
    bit for bit, one count and at most 20 launches a call."""
    _, _, blocks = render_scene
    if source == "cut_area":
        vol = brickmap.scene_volume(blocks).repeat(2, 1, 1)[:36, 6:26].contiguous()
    else:
        g = torch.Generator().manual_seed(11)
        vol = (torch.rand((36, 20, 384), generator=g) < 2e-4).to(torch.uint8) * int(Block.STONE)
        vol[:, :, :24] = int(Block.DIRT)
        for z, x, y in ((0, 3, 200), (35, 5, 117), (7, 0, 301), (11, 19, 90), (20, 13, 383)):
            vol[z, x, y] = int(Block.BIRCH_LEAVES)
        vol = vol.to(cuda_device)
    kernels.reset_launch_counts()
    got = kernels.scene_fields(vol)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["scene_fields"] == 1 and kernels.scene_launches() <= 20
    assert torch.equal(got, brickmap.build_fields_plain(vol))


@pytest.mark.cuda
def test_trace_kernel_matches_plain_on_gpu(cuda_device, render_scene):
    scene, player, _ = render_scene
    cam = player.camera_params(1920, 1080, device=cuda_device)
    rays, _ = tracer.primary_rays(cam, 1080, 1920, 3)
    med = torch.zeros((1080, 1920), dtype=torch.uint8, device=cuda_device)
    got, gs = tracer.trace(scene, *rays, med, want_steps=True)
    want, ws = tracer.trace_plain(scene, *rays, med, want_steps=True)
    for k in got._fields:
        assert torch.equal(getattr(got, k), getattr(want, k)), k
    assert torch.equal(gs, ws) and bool(want.hit.any())


@pytest.mark.cuda
@pytest.mark.parametrize("sun_time,exact", [(1.0, False), (4.0, False), (1.0, True)],
                         ids=["day", "night", "exact"])
def test_render_sample_kernel_matches_plain_on_gpu(cuda_device, render_scene, sun_time, exact):
    scene, player, _ = render_scene
    cam = player.camera_params(1920, 1080, device=cuda_device)
    params = sky.sky_params(sun_time, 0.0, device=cuda_device)
    tile = dict(row0=500, full_height=1080, col0=900, full_width=1920, exact=exact)
    kernels.reset_launch_counts()
    got = tracer.render_sample(scene, cam, params, 64, 64, 3, want_depth=True, want_steps=True, **tile)
    assert kernels.launch_counts()["render_sample"] == 1
    want = tracer.render_sample_plain(scene, cam, params, 64, 64, 3, **tile)
    for name, g, w in zip(("color", "albedo", "normal", "depth"), got, want):
        assert bool(torch.isfinite(g).all()), name
        frac, mean = _frac_close(g, w)
        assert frac >= 0.999 and mean <= 1e-4, (name, frac, mean)
    assert torch.equal(got[4], want[4])


@pytest.mark.cuda
def test_render_sample_kernel_odd_tile_matches_plain_on_gpu(cuda_device, render_scene):
    """K11 on a 997x135 tile at row 471, column 461 of the 1080p frame (sizes that fit no
    CTA tile, edges inside the frame, the scene in view): every output equal to the plain
    version, one count and ``render_launches()`` kernel launches a call."""
    scene, player, _ = render_scene
    cam = player.camera_params(1920, 1080, device=cuda_device)
    params = sky.sky_params(1.0, 0.0, device=cuda_device)
    tile = dict(row0=471, full_height=1080, col0=461, full_width=1920, exact=False)
    kernels.reset_launch_counts()
    got = tracer.render_sample(scene, cam, params, 135, 997, 3, want_depth=True, want_steps=True, **tile)
    assert kernels.launch_counts()["render_sample"] == 1
    assert kernels.render_launches() == tracer.MAX_LOOP_ITERS
    want = tracer.render_sample_plain(scene, cam, params, 135, 997, 3, **tile)
    for name, g, w in zip(("color", "albedo", "normal", "depth", "steps"), got, want):
        assert torch.equal(g, w), name
    assert bool((want[4][..., 3] > 1).any())  # paths that bounce


@pytest.mark.cuda
def test_render_sample_kernel_mapped_normals_on_gpu(cuda_device, render_scene, monkeypatch):
    """The normal-map switch (config.render.mapped_normals, off by default) in both versions."""
    scene, player, _ = render_scene
    monkeypatch.setattr(tracer, "MAPPED_NORMALS", True)
    cam = player.camera_params(1920, 1080, device=cuda_device)
    params = sky.sky_params(1.0, 0.0, device=cuda_device)
    tile = dict(row0=500, full_height=1080, col0=900, full_width=1920, exact=False)
    got = tracer.render_sample(scene, cam, params, 64, 64, 3, want_depth=True, want_steps=True, **tile)
    want = tracer.render_sample_plain(scene, cam, params, 64, 64, 3, **tile)
    for name, g, w in zip(("color", "albedo", "normal", "depth"), got, want):
        frac, mean = _frac_close(g, w)
        assert frac >= 0.999 and mean <= 1e-4, (name, frac, mean)
    assert torch.equal(got[4], want[4])


@pytest.mark.cuda
def test_alpha_cutout_kernels_match_plain_on_gpu(cuda_device, render_scene):
    """The alpha-cutout code under ``cutout_atlas``: K10's flag and fraction bits, K11t's
    exact park-and-resolve and stochastic pass-through on 65,536 rays aimed at flagged
    voxels, and K11 in both trace modes on a 320x180 frame of a camera aimed at one, each
    against its plain version."""
    scene0, _, blocks = render_scene
    with cutout_atlas():
        scene = brickmap.build_scene(blocks, -1, -1)
        assert torch.equal(scene.flat, brickmap.build_fields_plain(brickmap.scene_volume(blocks)))
        targets = flagged_surface_voxels(scene, 65536)
        rays = rays_at(targets, cuda_device)
        seed = torch.arange(65536, dtype=torch.int64, device=cuda_device) * 2654435761 % 2 ** 32
        med = torch.zeros(65536, dtype=torch.uint8, device=cuda_device)
        for alpha in ("exact", "stochastic"):
            sd = seed if alpha == "stochastic" else None
            got, gs = tracer.trace(scene, *rays, med, want_steps=True, alpha=alpha, seed=sd)
            want, ws = tracer.trace_plain(scene, *rays, med, want_steps=True, alpha=alpha, seed=sd)
            for k in got._fields:
                assert torch.equal(getattr(got, k), getattr(want, k)), (alpha, k)
            assert torch.equal(gs, ws), alpha
            # the cutouts change what the rays see
            moved = int((got.t != tracer.trace(scene0, *rays, med).t).sum())
            assert moved > 10000, (alpha, moved)
        cam = aimed_player(targets).camera_params(320, 180, device=cuda_device)
        params = sky.sky_params(1.0, 0.0, device=cuda_device)
        for exact in (True, False):
            got = tracer.render_sample(scene, cam, params, 180, 320, 3, want_depth=True, want_steps=True,
                                       exact=exact)
            want = tracer.render_sample_plain(scene, cam, params, 180, 320, 3, exact=exact)
            for name, g, w in zip(("color", "albedo", "normal", "depth"), got, want):
                assert bool(torch.isfinite(g).all()), (exact, name)
                frac, mean = _frac_close(g, w)
                assert frac >= 0.999 and mean <= 1e-4, (exact, name, frac, mean)
            assert torch.equal(got[4], want[4]), exact
            base = tracer.render_sample(scene0, cam, params, 180, 320, 3, want_depth=True, exact=exact)
            assert float((got[3] != base[3]).double().mean()) > 0.01, exact  # cutouts in view


@pytest.mark.cuda
def test_accumulate_kernel_and_render_accumulate_on_gpu(cuda_device, render_scene):
    scene, player, _ = render_scene
    g = torch.Generator(device="cpu").manual_seed(5)
    bufs = [torch.rand((48, 80, 3), generator=g).to(cuda_device) for _ in range(6)]
    got = tracer.accumulate(tracer.FrameBuffers(*bufs[:3]), *bufs[3:], 7)
    want = tracer.accumulate_plain(tracer.FrameBuffers(*bufs[:3]), *bufs[3:], 7)
    for a, b in zip(got[:3], want[:3]):
        assert torch.equal(a, b)
    cam = player.camera_params(80, 48, device=cuda_device)
    params = sky.sky_params(1.0, 0.0, device=cuda_device)
    fbs = tracer.init_framebuffers(48, 80, device=cuda_device)
    kernels.reset_launch_counts()
    fbs = tracer.render_accumulate(fbs, scene, cam, params, 48, 80, 0)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts["render_sample"] == 1 and counts["accumulate"] == 1
    assert sum(counts.values()) == 2


# -- the engine's frame path ------------------------------------------------------------


@pytest.mark.cuda
def test_update_chunks_kernel_matches_plain_on_gpu(cuda_device, render_scene):
    """K10u on a 6x6-chunk scene made of the featured 2x2 area: a 3x3 bucket with one
    chunk masked, a removal (all masked) and a 1x2 edge bucket, each bit for bit against
    the plain version, in place, one count each."""
    _, _, blocks = render_scene
    tiled = blocks.repeat(3, 3, 1, 1, 1)
    scene = brickmap.build_scene(tiled, -3, -3)
    slot_table = blocks.reshape(4, 16, 16, 384).contiguous()
    one_air = [True] * 4 + [False] + [True] * 4
    for gz, gx, z0, x0, slots, mask in ((3, 3, 16, 32, [0, 1, 2, 3, 0, 1, 2, 3, 0], one_air),
                                        (2, 2, 48, 48, [0, 1, 2, 3], [False] * 4),
                                        (1, 2, 80, 64, [3, 2], [True, True])):
        want = brickmap.update_chunks_plain(scene, slot_table, slots, mask, gz, gx, z0, x0)
        before = scene.flat.clone()
        kernels.reset_launch_counts()
        out = brickmap.update_chunks(scene, slot_table, slots, mask, gz, gx, z0, x0)
        assert kernels.launch_counts()["update_chunks"] == 1
        assert out.flat.data_ptr() == scene.flat.data_ptr()
        assert torch.equal(out.flat, want), (gz, gx, z0, x0)
        assert int((out.flat != before).sum()) > 1000
        scene = out


@pytest.mark.cuda
def test_update_chunks_kernel_chain_matches_plain_chain_on_gpu(cuda_device, render_scene):
    """K10u over a chain of six buckets on a 6x6-chunk scene (rewrites, removals, the corner,
    buckets that overlap), its macro level read back from its own earlier calls each time,
    against the plain chain run on its own; at most 20 launches a call."""
    _, _, blocks = render_scene
    tiled = blocks.repeat(3, 3, 1, 1, 1)
    scene = brickmap.build_scene(tiled, -3, -3)
    plain = brickmap.Scene(scene.flat.clone(), scene.origin, scene.dims)
    slot_table = blocks.reshape(4, 16, 16, 384).contiguous()
    chain = ((3, 3, 0, 0, [3, 2, 1, 0, 3, 2, 1, 0, 3], [True] * 9),
             (3, 3, 48, 48, [0] * 9, [False] * 9),
             (2, 2, 64, 64, [1, 1, 2, 2], [True, False, True, True]),
             (1, 1, 80, 0, [2], [True]),
             (3, 3, 32, 16, [0, 1, 2, 3, 0, 1, 2, 3, 0], [True] * 4 + [False] + [True] * 4),
             (1, 2, 0, 64, [3, 0], [False, False]))
    for gz, gx, z0, x0, slots, mask in chain:
        plain.flat.copy_(brickmap.update_chunks_plain(plain, slot_table, slots, mask, gz, gx, z0, x0))
        kernels.reset_launch_counts()
        scene = brickmap.update_chunks(scene, slot_table, slots, mask, gz, gx, z0, x0)
        torch.cuda.synchronize()
        assert kernels.launch_counts()["update_chunks"] == 1 and kernels.scene_launches() <= 20
        assert torch.equal(scene.flat, plain.flat), (gz, gx, z0, x0)


def _frame_inputs(device, h=45, w=80, seed=3):
    g = torch.Generator(device="cpu").manual_seed(seed)
    r = lambda *shape: torch.rand(shape, generator=g).to(device)  # noqa: E731
    color = r(h, w, 3) * torch.where(r(h, w, 1) < 0.1, 20.0, 1.0)
    normal = torch.nn.functional.normalize(r(h, w, 3) - 0.5, dim=-1)
    return color, r(h, w, 3), normal, torch.floor(r(h, w) * 70.0)


@pytest.mark.cuda
def test_temporal_blend_kernels_match_plain_on_gpu(cuda_device, render_scene):
    """K13 after a moved camera and K13s under a static one, on samples of the scene,
    every buffer bit for bit; one launch each per entry point."""
    scene, player, _ = render_scene
    h, w = 90, 160
    params = sky.sky_params(1.0, 0.0, device=cuda_device)
    cam0 = player.camera_params(w, h, device=cuda_device)
    moved = camera.Player(pos=player.pos + np.array([0.5, 0.2, 2.0], np.float32), theta=player.theta + 0.03,
                          phi=player.phi)
    cam1 = moved.camera_params(w, h, device=cuda_device)
    fbs = tracer.init_framebuffers(h, w, device=cuda_device, temporal=True)
    kernels.reset_launch_counts()
    fbs = reproject.render_accumulate_static(fbs, scene, cam0, params, h, w, 0)
    fbs = reproject.render_accumulate_static(fbs, scene, cam0, params, h, w, 1)
    c, a, n, d = tracer.render_sample(scene, cam1, params, h, w, 2, want_depth=True)
    got = reproject.accumulate_temporal(fbs, cam0, cam1, c, a, n, d)
    counts = kernels.launch_counts()
    assert (counts["static_blend"], counts["reproject"], counts["render_sample"]) == (2, 1, 3)
    want = reproject.temporal_blend(fbs, cam0, cam1, c, a, n, d)
    for name, x, y in zip(got._fields, got, want):
        assert torch.equal(x, y), name
    assert 0.3 < float((got.nsamp > 1.0).double().mean()) < 1.0
    got_s = reproject.accumulate_static(fbs, c, a, n, d)
    want_s = reproject.static_blend(fbs, c, a, n, d)
    for name, x, y in zip(got_s._fields, got_s, want_s):
        assert torch.equal(x, y), name


@pytest.mark.cuda
def test_present_path_kernels_match_plain_on_gpu(cuda_device):
    """K14 with and without nsamp (odd-sized frame, taps wrapping), K15 and K16, bit for
    bit; K15 also against torch's bilinear interpolate (within 1e-6)."""
    color, albedo, normal, nsamp = _frame_inputs(cuda_device, 45, 77)
    for ns in (nsamp, None):
        kernels.reset_launch_counts()
        got = denoise.atrous_denoise(color, albedo, normal, nsamp=ns)
        assert kernels.launch_counts()["atrous_denoise"] == 1
        assert torch.equal(got, denoise.atrous_denoise_plain(color, albedo, normal, nsamp=ns))
    up = denoise.upscale2x(color)
    assert torch.equal(up, denoise.upscale2x_plain(color))
    lib = torch.nn.functional.interpolate(color.permute(2, 0, 1)[None], scale_factor=2, mode="bilinear",
                                          align_corners=False)[0].permute(1, 2, 0)
    assert float(((up - lib).abs() / lib.abs().clamp(min=1e-6)).max()) <= 1e-6
    hdr = torch.cat([color.reshape(-1), torch.linspace(0.0, 50.0, 30000, device=cuda_device)]).reshape(-1, 1, 3)
    assert torch.equal(tonemap.present(hdr), tonemap.present_plain(hdr))


@pytest.mark.cuda
@pytest.mark.parametrize("size", [(1, 1), (3, 5), (7, 9), (540, 960)], ids=str)
def test_upscale2x_kernel_matches_plain_on_gpu(cuda_device, size):
    """K15 bit for bit at odd sizes, widths that are no multiple of its 4-pixel run and the
    fly-through's 960x540; within 1e-6 of torch's bilinear interpolate."""
    img = torch.as_tensor(np.random.default_rng(5).random((*size, 3), dtype=np.float32) * 4.0,
                          device=cuda_device)
    kernels.reset_launch_counts()
    up = denoise.upscale2x(img)
    assert kernels.launch_counts()["upscale2x"] == 1
    assert torch.equal(up.view(torch.int32), denoise.upscale2x_plain(img).view(torch.int32))
    lib = torch.nn.functional.interpolate(img.permute(2, 0, 1)[None], scale_factor=2, mode="bilinear",
                                          align_corners=False)[0].permute(1, 2, 0)
    assert float(((up - lib).abs() / lib.abs().clamp(min=1e-6)).max()) <= 1e-6


@pytest.mark.cuda
def test_engine_tick_and_present_on_gpu(cuda_device):
    """Engine ticks on the card (a radius-0 spiral: no chunk becomes drawable, so no scene
    update) through K11 and K13s / K13, then present through K14, K15 and K16."""
    from mega_minecraft_tpu_torch.app.engine import Engine, EngineConfig

    eng = Engine(EngineConfig(width=128, height=72, view_chunks=3, gen_radius=0, capacity=64,
                              use_upscaling=True))
    kernels.reset_launch_counts()
    eng.tick(1.0 / 30.0)
    eng.tick(1.0 / 30.0, move=(0.0, 0.0, 2.0))
    img = eng.present()
    counts = kernels.launch_counts()
    assert img.shape == (72, 128, 3) and img.dtype == np.uint8
    for name, want in (("render_sample", 2), ("static_blend", 1), ("reproject", 1), ("atrous_denoise", 1),
                       ("upscale2x", 1), ("present", 1)):
        assert counts[name] == want, (name, counts)


@pytest.mark.cuda
@pytest.mark.parametrize("sun_time,tint,glow", [(1.0, "none", False), (1.0, "chunk", False), (1.0, "zone", False),
                                                (4.0, "none", False), (1.0, "none", True), (4.0, "zone", True)],
                         ids=["day", "day-chunk", "day-zone", "night", "emissive", "emissive-night-zone"])
def test_render_debug_kernel_matches_plain_on_gpu(cuda_device, sun_time, tint, glow):
    """K17 against render_debug_plain on the card, bit for bit (the box scene of
    tests/test_render.py, 128x96), one launch count per call; the emissive cases'
    bright pass is not empty."""
    from mega_minecraft_tpu_torch.render import debug_renderer

    scene = brickmap.build_scene(torch.from_numpy(box_chunks(box_volume(glow))).to(cuda_device), 0, 0)
    cam = camera.Player(pos=np.array([16.0, 140.0, -8.0], np.float32), phi=-0.5).camera_params(
        128, 96, device=cuda_device)
    params = sky.sky_params(sun_time, 0.0, device=cuda_device)
    kernels.reset_launch_counts()
    got = debug_renderer.render_debug(scene, cam, params, 96, 128, tint)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["render_debug"] == 1
    with bright_pass_recorder() as bright:
        want, steps = debug_renderer.render_debug_plain(scene, cam, params, 96, 128, tint, want_steps=True)
    _, ksteps = kernels.render_debug(scene, cam, params, 96, 128, debug_renderer.TINT_CELLS[tint], want_steps=True)
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, want)
    assert torch.equal(ksteps, steps) and int(steps.sum()) > 0
    if glow:
        assert int(bright[0].sum()) > 0, "the bright pass is empty"


@pytest.mark.cuda
def test_sharded_erosion_bands_match_k9_on_gpu(cuda_device):
    from mega_minecraft_tpu_torch.parallel import sharding

    grid = torch.from_numpy(np.load(GOLDEN_EROSION)["input_400_-560"]).to(cuda_device)
    want, iters = kernels.erode_zone(grid)
    kernels.reset_launch_counts()
    sweeps = []
    got = sharding.erode_zone_sharded(sharding.Mesh([cuda_device] * 4), grid, sweeps)
    torch.cuda.synchronize()
    assert sweeps == iters.cpu().tolist()
    assert kernels.launch_counts()["erosion_band"] == 4 * sum(sweeps)
    assert kernels.launch_counts()["erosion"] == 0
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
def test_dp_layers_kernel_matches_plain_and_area_path_on_gpu(cuda_device):
    from mega_minecraft_tpu_torch.parallel import sharding

    pos_halo = _pos_halo(cuda_device)
    pos = pos_halo[4:5].contiguous()
    kernels.reset_launch_counts()
    hf, w, ls = sharding.gen_stage_layers(pos)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["dp_layers"] == 1
    for got, want in zip((hf, w, ls), sharding.gen_stage_layers_plain(pos)):
        _close(got, want)
    hf_h, w_h = kernels.heightfield(pos_halo)
    st = kernels.layers(hf_h, w_h, pos_halo, 1, 1)
    for got, key in ((hf, "heightfield"), (w, "biome_weights"), (ls, "layers")):
        assert torch.equal(got, st[key]), key
    blocks = sharding.dp_generate(sharding.Mesh([cuda_device] * 1), pos)
    empty = torch.full((1, 16, 16, 32), 384, dtype=torch.int32, device=cuda_device)
    assert torch.equal(blocks, kernels.fill(st["heightfield"], st["biome_weights"], st["layers"],
                                            empty, empty, pos, tables.LUSH_TABLE_CELLS))


@pytest.mark.cuda
def test_sharded_render_bands_match_whole_frame_on_gpu(cuda_device, render_scene):
    from mega_minecraft_tpu_torch.parallel import sharding

    scene, player, _ = render_scene
    cam = player.camera_params(256, 128, device=cuda_device)
    params = sky.sky_params(1.0, 0.0, device=cuda_device)
    whole = tracer.render_sample(scene, cam, params, 128, 256, 3)
    kernels.reset_launch_counts()
    got = sharding.sharded_render(sharding.Mesh([cuda_device] * 4), scene, cam, params, 128, 256, 3)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["render_sample"] == 4
    for g, w in zip(got, whole):
        assert torch.equal(g, w)
