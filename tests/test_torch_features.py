"""The port's feature half (placements, lists, SDF features) vs the JAX package's.

The JAX side runs eagerly in exact mode (``jax.disable_jit()`` +
``hashes.exact_scope(True)``: no XLA program is compiled).  One module fixture takes the
terrain of the golden chunk (0, 0) from ``tests/golden/golden_chunks.npz`` (heightfield,
weights, layers, cave layers; its blocks from the port's fill) and runs each JAX feature
stage on the previous JAX stage's outputs; every port stage is fed exactly the JAX
stage's inputs through ``tables.from_jax_outputs``.  The featured slice as a whole is
held to the JAX one in ``tests/test_torch_pipeline.py``.  Tolerances:
- ``is_feature_pos``, ``lcg_value_at``, ``random_biome``, ``draw_stream``, placement grids,
  compacted lists: equal;
- SDF functions: ``hit`` and ``block`` agreement >= 0.999 over a window of offsets (libm's
  sin / cos / pow / acos / atan2 differ between XLA-CPU and torch-CPU by an ulp at shell
  boundaries), equal for the feature functions without libm calls;
- feature application: blocks agreement >= 0.9999.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mega_minecraft_tpu.ops import hashes as jh
from mega_minecraft_tpu.terrain import feature_placement as j_fp
from mega_minecraft_tpu.terrain import features as j_features
from mega_minecraft_tpu.terrain import features_sdf as j_sdf
from mega_minecraft_tpu.terrain import fill as j_fill
from mega_minecraft_tpu_torch.ops import hashes
from mega_minecraft_tpu_torch.tables import from_jax_outputs
from mega_minecraft_tpu_torch.terrain import feature_placement as fp
from mega_minecraft_tpu_torch.terrain import features, features_sdf as sdf, fill, layers
from mega_minecraft_tpu_torch.world import features_data as fd
from mega_minecraft_tpu_torch.world.blocks import Block

GOLDEN = Path(__file__).parent / "golden" / "golden_chunks.npz"
ORIGIN = (0, 0)  # golden chunk (0, 0): pines, shrubs and a warped fungus (small windows)
I32 = torch.int32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs its files in several processes on the same
    cores, where torch's spinning thread pools would starve each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _eager():
    class _Scope:
        def __enter__(self):
            self.a, self.b = jax.disable_jit(), jh.exact_scope(True)
            self.a.__enter__()
            self.b.__enter__()

        def __exit__(self, *exc):
            self.b.__exit__(*exc)
            self.a.__exit__(*exc)

    return _Scope()


def _golden_terrain():
    """The golden chunk's stage outputs as port tensors ([1, ...])."""
    g = np.load(GOLDEN)
    k = f"{ORIGIN[0]}_{ORIGIN[1]}"
    i32 = lambda name: torch.as_tensor(g[name + k].astype(np.int32))[None]  # noqa: E731
    gen = {
        "heightfield": torch.as_tensor(g["hf18_" + k][1:17, 1:17].copy())[None],
        "biome_weights": torch.as_tensor(g["weights_" + k])[None],
        "layers": layers.fix_backward_stratified(torch.as_tensor(g["layers_" + k])[None]),
        "caves": {"starts": i32("cavestarts_"), "ends": i32("caveends_"),
                  "bottom_biome": i32("cavebottom_"), "top_biome": i32("cavetop_")},
        "chunk_pos": torch.tensor([ORIGIN], dtype=I32),
    }
    cv = gen["caves"]
    gen["blocks"] = fill.fill_chunks(gen["heightfield"], gen["biome_weights"], gen["layers"],
                                     cv["starts"], cv["ends"], gen["chunk_pos"])
    return gen


@pytest.fixture(scope="module")
def jax_stages():
    """numpy outputs of every JAX feature stage on the golden terrain, chained."""
    gen_np = jax.tree_util.tree_map(lambda t: t.numpy(), _golden_terrain())
    gen = jax.tree_util.tree_map(jnp.asarray, gen_np)
    with _eager():
        cv = gen["caves"]
        pl = j_fp.generate_placements(
            gen["heightfield"], gen["biome_weights"], gen["layers"], cv["starts"], cv["ends"],
            cv["bottom_biome"], cv["top_biome"], gen["chunk_pos"])
        lists = j_fp.compact_placements(pl, gen["chunk_pos"])
        featured = j_features.apply_features_area(
            gen["blocks"], lists["surface"], lists["cave"], gen["chunk_pos"], 1, 1)
    return {"gen": gen_np, **_np({"placements": pl, "lists": lists,
                                  "featured": {"blocks": featured}})}


@pytest.fixture(scope="module")
def port_in(jax_stages):
    return from_jax_outputs(jax_stages, "cpu")


# ---------------------------------------------------------------------------
# scalar building blocks (inputs from a numpy seed): equal
# ---------------------------------------------------------------------------


def test_module_constants_equal_the_reference():
    """Seeds, caps, gather order and window tables of the port's feature modules."""
    from mega_minecraft_tpu_torch import kernels

    for name in ("SEED_COLUMN", "SEED_SURFACE_POS", "SEED_CAVE_BOTTOM_F", "SEED_CAVE_BOTTOM_L",
                 "SEED_CAVE_TOP_F", "SEED_CAVE_TOP_L", "CHUNK_FEATURE_CAP", "CHUNK_CAVE_FEATURE_CAP",
                 "MAX_GATHERED_FEATURES", "MAX_GATHERED_CAVE_FEATURES"):
        assert getattr(fp, name) == getattr(j_fp, name), name
    np.testing.assert_array_equal(fp.GATHER_OFFSETS, j_fp.GATHER_OFFSETS)
    for name in ("SEED_SURFACE_FEATURE_RNG", "SEED_SURFACE_BLOCK_RNG", "SEED_CAVE_FEATURE_RNG",
                 "SEED_CAVE_BLOCK_RNG"):
        assert getattr(sdf, name) == getattr(j_sdf, name), name
    assert features.SURFACE_XZ_RADIUS == j_features.SURFACE_XZ_RADIUS
    assert features.CAVE_WINDOWS == j_features.CAVE_WINDOWS
    assert (kernels.SURFACE_CAP, kernels.CAVE_CAP) == (fp.CHUNK_FEATURE_CAP, fp.CHUNK_CAVE_FEATURE_CAP)
    assert kernels.STREAM_LEN == sdf.STREAM_LEN == 64
    # every window is at least as wide as the reference's radius on both sides
    for cave, radii in ((False, features.SURFACE_XZ_RADIUS),
                        (True, {k: v[0] for k, v in features.CAVE_WINDOWS.items()})):
        half = features.window_half_widths(cave)
        for f, r in radii.items():
            assert half[f, 0] >= r and half[f, 1] >= r, (cave, f)


def test_is_feature_pos_equal():
    rng = np.random.default_rng(11)
    n = 4096
    wx = rng.integers(-5000, 5000, n).astype(np.int32)
    wz = rng.integers(-5000, 5000, n).astype(np.int32)
    cell = rng.choice([4, 5, 7, 16, 28, 112], n).astype(np.int32)
    pad = rng.integers(0, 2, n).astype(np.int32)
    seed = (rng.integers(1, 20, n) * fp.SEED_SURFACE_POS).astype(np.int32)
    # snap a third of the points onto their cell's feature position so both answers occur
    with _eager():
        cf = cell.astype(np.float32)
        gx = np.floor(wx.astype(np.float32) / cf) * cf
        gz = np.floor(wz.astype(np.float32) / cf) * cf
        rx, rz = (np.asarray(v) for v in jh.rand2_from3(gx, gz, seed.astype(np.float32)))
        internal = (cell - 2 * pad).astype(np.float32)
        snap = np.arange(n) % 3 == 0
        wx = np.where(snap, gx.astype(np.int32) + pad + np.floor(rx * internal).astype(np.int32), wx)
        wz = np.where(snap, gz.astype(np.int32) + pad + np.floor(rz * internal).astype(np.int32), wz)
        want = np.asarray(j_fp.is_feature_pos(*(jnp.asarray(a) for a in (wx, wz, cell, pad, seed))))
    got = fp.is_feature_pos(*(torch.as_tensor(a) for a in (wx, wz, cell, pad, seed))).numpy()
    assert 0.2 < want.mean() < 0.5
    np.testing.assert_array_equal(got, want)


def test_lcg_value_at_equal():
    rng = np.random.default_rng(12)
    state0 = rng.integers(1, hashes.LCG_M, 7).astype(np.int64)
    j = np.arange(16899, dtype=np.int32)
    with _eager():
        want = np.stack([np.asarray(jh.lcg_value_at(jnp.uint32(s), jnp.asarray(j),
                                                    jnp.asarray(jh.lcg_pow_table(16900))))
                         for s in state0])
    ptab = torch.as_tensor(hashes.lcg_pow_table(16900))
    got = hashes.lcg_value_at(torch.as_tensor(state0)[:, None], torch.as_tensor(j)[None], ptab)
    np.testing.assert_array_equal(got.numpy(), want)
    # and equal to stepping the stream draw by draw
    v, s = hashes.lcg_u01(torch.as_tensor(state0))
    v, s = hashes.lcg_u01(s)
    np.testing.assert_array_equal(got[:, 1].numpy(), v.numpy())


def test_random_biome_equal():
    rng = np.random.default_rng(13)
    w = rng.random((512, 24)).astype(np.float32) ** 4
    w /= w.sum(-1, keepdims=True) * rng.choice([1.0, 1.3], (512, 1)).astype(np.float32)
    r = rng.random(512).astype(np.float32)
    with _eager():
        want = np.asarray(j_fill.random_biome(jnp.asarray(w), jnp.asarray(r)))
    got = fill.random_biome(torch.as_tensor(w), torch.as_tensor(r))
    assert got.dtype == I32 and len(np.unique(want)) > 8
    np.testing.assert_array_equal(got.numpy(), want)


def test_draw_stream_equal():
    rng = np.random.default_rng(14)
    x, z = (rng.integers(-4000, 4000, 64).astype(np.int32) for _ in range(2))
    y = rng.integers(1, 300, 64).astype(np.int32)
    for seed in (sdf.SEED_SURFACE_FEATURE_RNG, sdf.SEED_CAVE_FEATURE_RNG):
        with _eager():
            want = np.asarray(j_sdf.draw_stream(jnp.asarray(x), jnp.asarray(y), jnp.asarray(z), seed))
        got = sdf.draw_stream(torch.as_tensor(x), torch.as_tensor(y), torch.as_tensor(z), seed)
        assert got.shape == (64, 64)
        np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# K5 / K6 plain versions on the JAX stage outputs: equal
# ---------------------------------------------------------------------------


def test_generate_placements_equal(jax_stages, port_in):
    g = port_in["gen"]
    cv = g["caves"]
    pl = fp.generate_placements(g["heightfield"], g["biome_weights"], g["layers"], cv["starts"],
                                cv["ends"], cv["bottom_biome"], cv["top_biome"], g["chunk_pos"])
    want = jax_stages["placements"]
    assert sorted(pl) == sorted(want)
    assert (want["cave_feature"] > 0).sum() > 0 and (want["surface_feature"] > 0).sum() > 3
    for k, v in want.items():
        assert pl[k].dtype == (torch.bool if v.dtype == bool else I32), k
        np.testing.assert_array_equal(pl[k].numpy(), v, err_msg=k)


def test_compact_placements_equal(jax_stages, port_in):
    lists = fp.compact_placements(port_in["placements"], port_in["gen"]["chunk_pos"])
    for kind, want in jax_stages["lists"].items():
        assert sorted(lists[kind]) == sorted(want)
        for k, v in want.items():
            assert lists[kind][k].dtype == I32
            np.testing.assert_array_equal(lists[kind][k].numpy(), v, err_msg=f"{kind}.{k}")


def test_compact_placements_overflow_truncates_and_counts():
    """A dense synthetic grid: more cave candidates than the 1,024 cap."""
    rng = np.random.default_rng(15)
    B = 2
    pl = {
        "surface_feature": rng.integers(0, 3, (B, 16, 16)).astype(np.int32),
        "surface_y": rng.integers(60, 200, (B, 16, 16)).astype(np.int32),
        "surface_replace": rng.random((B, 16, 16)) < 0.5,
        "cave_feature": (rng.integers(1, 10, (B, 16, 16, 32, 2))
                         * (rng.random((B, 16, 16, 32, 2)) < 0.12)).astype(np.int32),
        "cave_y": rng.integers(1, 140, (B, 16, 16, 32)).astype(np.int32),
        "cave_height": rng.integers(1, 40, (B, 16, 16, 32)).astype(np.int32),
        "cave_replace": rng.random((B, 16, 16, 32, 2)) < 0.5,
    }
    pos = np.array([[32, -48], [-4096, 160]], np.int32)
    with _eager():
        want = _np(j_fp.compact_placements({k: jnp.asarray(v) for k, v in pl.items()}, jnp.asarray(pos)))
    got = fp.compact_placements(from_jax_outputs(pl, "cpu"), torch.as_tensor(pos))
    n_cave = (pl["cave_feature"] > 0).reshape(B, -1).sum(-1)
    assert (n_cave > fp.CHUNK_CAVE_FEATURE_CAP).all()
    np.testing.assert_array_equal(got["cave"]["count"].numpy(), n_cave)
    assert got["cave"]["feature"].shape == (B, fp.CHUNK_CAVE_FEATURE_CAP)
    assert (got["cave"]["feature"] > 0).all()
    for kind in ("surface", "cave"):
        for k, v in want[kind].items():
            np.testing.assert_array_equal(got[kind][k].numpy(), v, err_msg=f"{kind}.{k}")


# ---------------------------------------------------------------------------
# the 29 SDF functions, one case each
# ---------------------------------------------------------------------------

#: feature functions whose geometry calls no libm function: equal
EXACT_FUNCTIONS = {
    ("surface", int(fd.Feature.SPHERE)), ("surface", int(fd.Feature.KELP)),
    ("cave", int(fd.CaveFeature.TEST_GLOWSTONE_PILLAR)),
    ("cave", int(fd.CaveFeature.TEST_SHROOMLIGHT_PILLAR)), ("cave", int(fd.CaveFeature.CAVE_VINE)),
}
FEATURE_CASES = ([("surface", f) for f in sorted(sdf.SURFACE_FEATURE_FNS)]
            + [("cave", f) for f in sorted(sdf.CAVE_FEATURE_FNS)])


def _function_id(case):
    kind, f = case
    return (fd.CaveFeature(f) if kind == "cave" else fd.Feature(f)).name.lower()


def test_registries_cover_every_feature():
    assert len(FEATURE_CASES) == 29
    assert sorted(sdf.SURFACE_FEATURE_FNS) == sorted(j_sdf.SURFACE_FEATURE_FNS)
    assert sorted(sdf.CAVE_FEATURE_FNS) == sorted(j_sdf.CAVE_FEATURE_FNS)


@pytest.mark.parametrize("case", FEATURE_CASES, ids=_function_id)
def test_sdf_function(case):
    kind, fid = case
    cave = kind == "cave"
    rng = np.random.default_rng(1000 + fid + (100 if cave else 0))
    px, pz = (int(v) for v in rng.integers(-3000, 3000, 2))
    py = 70  # under sea level - 32, so corals / kelp / icebergs / crystals all generate
    layer_h = 18 if cave else 0
    radius = (features.CAVE_WINDOWS[fid][0] if cave else features.SURFACE_XZ_RADIUS[fid])
    bounds = (fd.CAVE_FEATURE_HEIGHT_BOUNDS if cave else fd.FEATURE_HEIGHT_BOUNDS)[fid]
    # one window shape (25 x 25 x 40 offsets, strided to cover the type's extent and
    # holding the placement's own column) for every feature function
    offs = (np.arange(25, dtype=np.int32) - 12) * -(-radius // 12)
    y_lo, y_hi = int(bounds[0]) - 2, int(bounds[1]) + layer_h + 2
    offs_y = y_lo + np.arange(40, dtype=np.int32) * -(-(y_hi - y_lo + 1) // 40)
    fz, fx, fy = (np.ascontiguousarray(a) for a in
                  np.broadcast_arrays(offs[:, None, None], offs[None, :, None], offs_y[None, None, :]))
    wx, wy, wz = fx + px, fy + py, fz + pz
    feat_seed = sdf.SEED_CAVE_FEATURE_RNG if cave else sdf.SEED_SURFACE_FEATURE_RNG
    block_seed = sdf.SEED_CAVE_BLOCK_RNG if cave else sdf.SEED_SURFACE_BLOCK_RNG

    with _eager():
        stream = j_sdf.draw_stream(jnp.int32(px), jnp.int32(py), jnp.int32(pz), feat_seed)
        brng = jh.seed_4(jnp.asarray(wx), jnp.asarray(wy), jnp.asarray(wz), block_seed)
        extra = {"fy_pos": jnp.int32(py), "fpos": (jnp.int32(px), jnp.int32(py), jnp.int32(pz)),
                 "layer_height": jnp.int32(layer_h)}
        fn = (j_sdf.CAVE_FEATURE_FNS if cave else j_sdf.SURFACE_FEATURE_FNS)[fid]
        w_hit, w_block, _ = fn(stream, *(jnp.asarray(a) for a in (fx, fy, fz, wx, wy, wz)), brng, extra)
        w_hit = np.broadcast_to(np.asarray(w_hit), fx.shape)
        w_block = np.where(w_hit, np.broadcast_to(np.asarray(w_block), fx.shape), 0)
        stream, brng = np.array(stream), np.array(brng)

    t = lambda a: torch.as_tensor(a)  # noqa: E731
    i0 = lambda v: torch.tensor(v, dtype=I32)  # noqa: E731
    extra = {"fy_pos": i0(py), "fpos": (i0(px), i0(py), i0(pz)), "layer_height": i0(layer_h)}
    fn = (sdf.CAVE_FEATURE_FNS if cave else sdf.SURFACE_FEATURE_FNS)[fid]
    g_hit, g_block, _ = fn(t(stream), *(t(a) for a in (fx, fy, fz, wx, wy, wz)),
                           t(brng.astype(np.int64)), extra)
    g_hit = g_hit.expand(fx.shape).numpy()
    g_block = np.where(g_hit, g_block.expand(fx.shape).numpy(), 0)

    assert w_hit.sum() > 0, "vacuous: the function hit no block of the window"
    if case in EXACT_FUNCTIONS:
        np.testing.assert_array_equal(g_hit, w_hit)
        np.testing.assert_array_equal(g_block, w_block)
    else:
        assert (g_hit == w_hit).mean() >= 0.999
        assert (g_block == w_block).mean() >= 0.999
        # and of the blocks the reference places, nearly all are placed the same
        assert (g_block[w_hit] == w_block[w_hit]).mean() >= 0.97


# ---------------------------------------------------------------------------
# K7 plain version
# ---------------------------------------------------------------------------


def test_apply_features_area_on_jax_lists(jax_stages, port_in):
    g = port_in["gen"]
    got = features.apply_features_area(g["blocks"], port_in["lists"]["surface"],
                                       port_in["lists"]["cave"], g["chunk_pos"], 1, 1)
    want = jax_stages["featured"]["blocks"]
    assert got.dtype == torch.uint8 and got.shape == (1, 16, 16, 384)
    assert (want != jax_stages["gen"]["blocks"]).sum() > 200, "vacuous: no feature blocks"
    assert (got.numpy() == want).mean() >= 0.9999


def _synthetic_lists(B, surf_entries, cave_entries):
    surf = {k: np.zeros((B, 64), np.int32) for k in ("feature", "x", "y", "z", "replace")}
    cave = {k: np.zeros((B, 128), np.int32) for k in ("feature", "x", "y", "z", "replace", "height")}
    for b, entries in enumerate(surf_entries):
        for s, row in enumerate(entries):
            for k, v in zip(("feature", "x", "y", "z", "replace"), row):
                surf[k][b, s] = v
    for b, entries in enumerate(cave_entries):
        for s, row in enumerate(entries):
            for k, v in zip(("feature", "x", "y", "z", "replace", "height"), row):
                cave[k][b, s] = v
    for lists in (surf, cave):
        lists["count"] = (lists["feature"] > 0).sum(-1).astype(np.int32)
    return surf, cave


def _stone_blocks(B):
    blocks = np.zeros((B, 16, 16, 384), np.uint8)
    blocks[:, :, :, :146] = int(Block.STONE)
    blocks[:, :, :, 60:91] = 0  # a cave layer
    return blocks


def test_apply_features_area_2x2_synthetic_vs_jax():
    """Cross-chunk features of several types over a 2x2 area, against the JAX program
    on the same lists: blocks agreement >= 0.9999."""
    F, C = fd.Feature, fd.CaveFeature
    pos = np.array([[0, 0], [16, 0], [0, 16], [16, 16]], np.int32)
    surf, cave = _synthetic_lists(4, [
        [(F.SPHERE, 14, 150, 14, 0)],
        [(F.PINE_TREE, 18, 147, 14, 0)],
        [],
        [(F.SPHERE, 18, 150, 18, 1)],
    ], [
        [(C.AMBER_FUNGUS, 15, 61, 15, 1, 29)],
        [],
        [(C.CAVE_VINE, 14, 61, 17, 0, 29)],
        [],
    ])
    blocks = _stone_blocks(4)
    with _eager():
        want = np.asarray(j_features.apply_features_area(
            jnp.asarray(blocks), {k: jnp.asarray(v) for k, v in surf.items()},
            {k: jnp.asarray(v) for k, v in cave.items()}, jnp.asarray(pos), 2, 2))
    got = features.apply_features_area(
        torch.as_tensor(blocks), from_jax_outputs(surf, "cpu"), from_jax_outputs(cave, "cpu"),
        torch.as_tensor(pos), 2, 2).numpy()
    assert (want != blocks).sum() > 400, "vacuous"
    for b in range(4):
        assert (want[b] != blocks[b]).sum() > 50, f"chunk {b} received no feature block"
    assert (got == want).mean() >= 0.9999
    assert ((got != blocks) == (want != blocks)).mean() >= 0.9999


def _apply_synthetic(ncx, surf_entries, cave_entries, counts=None):
    """Port feature application over an ncx x 1 strip of stone chunks -> [16, ncx*16, 384]."""
    pos = np.array([[16 * i, 0] for i in range(ncx)], np.int32)
    surf, cave = _synthetic_lists(ncx, surf_entries, cave_entries)
    if counts is not None:
        surf["count"] = np.asarray(counts, np.int32)
    out = features.apply_features_area(
        torch.as_tensor(_stone_blocks(ncx)), from_jax_outputs(surf, "cpu"),
        from_jax_outputs(cave, "cpu"), torch.as_tensor(pos), ncx, 1).numpy()
    return out.reshape(1, ncx, 16, 16, 384).transpose(0, 2, 1, 3, 4).reshape(16, ncx * 16, 384)


SP, KELP = int(fd.Feature.SPHERE), int(fd.Feature.KELP)
PIL = int(fd.CaveFeature.TEST_GLOWSTONE_PILLAR)
GRAVEL, GLOW, STONE = int(Block.GRAVEL), int(Block.GLOWSTONE), int(Block.STONE)
KELP_MAIN = int(Block.KELP_MAIN)


def test_priority_spiral_rank_decides_per_consumer_chunk():
    """A sphere listed by chunk 0 and kelp strands listed by chunk 1 overlap on both sides
    of the chunk border: each consumer chunk takes its own chunk's placement (rank 0)
    over the neighbour's (rank 3 or 7).  No libm in these feature functions: exact."""
    area = _apply_synthetic(2, [[(SP, 15, 102, 8, 1)],
                                [(KELP, 16, 100, 8, 1), (KELP, 14, 100, 8, 1)]], [[], []])
    assert area[8, 16, 102] == KELP_MAIN  # consumer chunk 1: its own kelp wins
    assert area[8, 14, 102] == GRAVEL  # consumer chunk 0: its own sphere wins
    assert area[8, 17, 102] == GRAVEL  # the sphere reaches across the border
    assert area[8, 14, 108] == KELP_MAIN  # above the sphere the neighbour's kelp shows


def test_priority_slot_order_within_a_chunk():
    area = _apply_synthetic(1, [[(KELP, 8, 100, 8, 1), (SP, 8, 102, 8, 1)]], [[]])
    assert area[8, 8, 102] == KELP_MAIN and area[8, 9, 102] == GRAVEL


def test_replace_flag_guards_terrain():
    keep = _apply_synthetic(1, [[(SP, 8, 144, 8, 0)]], [[]])
    assert keep[8, 8, 145] == STONE and keep[8, 8, 146] == GRAVEL
    over = _apply_synthetic(1, [[(SP, 8, 144, 8, 1)]], [[]])
    assert over[8, 8, 145] == GRAVEL


def test_surface_wins_over_cave_and_both_test_the_terrain():
    area = _apply_synthetic(1, [[(SP, 8, 70, 8, 0)]], [[(PIL, 8, 60, 8, 0, 30)]])
    assert area[8, 8, 70] == GRAVEL and area[8, 8, 80] == GLOW and area[8, 8, 59] == STONE
    # the cave pass tested the terrain (AIR), not the sphere's gravel: without the
    # sphere the same voxel is the pillar's
    assert _apply_synthetic(1, [[]], [[(PIL, 8, 60, 8, 0, 30)]])[8, 8, 70] == GLOW


def test_source_more_than_three_chunks_away_is_invisible():
    """Chunk 4 lists a sphere that lies over chunks 0 and 1: chunk 1 (3 away) takes it,
    chunk 0 (4 away) does not."""
    area = _apply_synthetic(5, [[], [], [], [], [(SP, 14, 150, 8, 0)]], [[]] * 5)
    assert (area[:, :16] == _stone_blocks(1)[0]).all()
    assert area[8, 16, 150] == GRAVEL and area[8, 19, 150] == GRAVEL


def test_gather_cap_hides_late_entries():
    """An entry whose index in the consumer's gathered list (true counts of the earlier
    spiral sources + slot) reaches the cap of 2,048 is invisible to that consumer."""
    entries = [[(SP, 4, 200, 8, 0)], [(SP, 17, 200, 8, 0)]]
    free = _apply_synthetic(2, entries, [[], []])
    assert free[8, 14, 200] == GRAVEL and free[8, 17, 200] == GRAVEL
    # chunk 0 claims 2,048 entries of its own gather, so chunk 1's sphere (next in chunk
    # 0's spiral) is cut there; chunk 1 gathers itself first and keeps it
    capped = _apply_synthetic(2, entries, [[], []], counts=[fp.MAX_GATHERED_FEATURES, 1])
    assert capped[8, 14, 200] == 0 and capped[8, 17, 200] == GRAVEL
    assert capped[8, 4, 200] == GRAVEL
