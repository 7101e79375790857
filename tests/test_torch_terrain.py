"""The port's plain terrain stages vs the reference goldens (at tests/test_golden.py's
gates) and their helper functions vs the JAX package (eager, exact mode), plus the
stage wrappers' device dispatch and input checks.

Chunk origins are the golden CHUNKS plus two seeded ones.  The whole-area
comparison with the JAX pipeline is in test_torch_pipeline.py.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mega_minecraft_tpu.ops import hashes as jh
from mega_minecraft_tpu.terrain import fill as j_fill
from mega_minecraft_tpu.terrain import gather as j_gather
from mega_minecraft_tpu.terrain import layers as j_layers
from mega_minecraft_tpu.world import biomes as bio
from mega_minecraft_tpu.world.blocks import Block
from mega_minecraft_tpu_torch import kernels, tables
from mega_minecraft_tpu_torch.terrain import caves, fill, gather, heightfield, layers, pipeline

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_CHUNKS_NPZ = os.path.join(ROOT, "tests", "golden", "golden_chunks.npz")
CHUNKS = [(0, 0), (592, -368), (-1024, 2048), (4096, 4096), (-160, -160)]
RNG_SEED = 20261016
SEEDED = [tuple(int(v) * 16 for v in np.random.default_rng(RNG_SEED).integers(-4096, 4096, 2))
          for _ in range(2)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs its files in several processes on the same
    cores, where torch's spinning thread pools would starve each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_exact(fn, *args):
    with jax.disable_jit(), jh.exact_scope(True):
        return jax.tree_util.tree_map(np.asarray, fn(*[jnp.asarray(a) for a in args]))


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN_CHUNKS_NPZ)


@pytest.fixture(scope="module")
def golden_stages(golden):
    """Plain stages 1 and 4 over the 5 golden chunks, once (stage 4 fed the golden
    heightfield and weights, as test_golden.py feeds the JAX stage)."""
    pos = torch.tensor(CHUNKS, dtype=torch.int32)
    hf, w = heightfield.generate_heightfield(pos)
    g_hf = torch.stack([torch.from_numpy(golden[f"hf18_{cx}_{cz}"][1:17, 1:17]) for cx, cz in CHUNKS])
    g_w = torch.stack([torch.from_numpy(golden[f"weights_{cx}_{cz}"]) for cx, cz in CHUNKS])
    cv = caves.generate_caves(g_hf.contiguous(), g_w.contiguous(), pos)
    return {"hf": hf, "w": w, "caves": cv}


# -- goldens (tests/test_golden.py:132-213 gates) ------------------------------------------


@pytest.mark.parametrize("i", range(len(CHUNKS)))
def test_golden_weights(golden, golden_stages, i):
    cx, cz = CHUNKS[i]
    d = np.abs(golden_stages["w"][i].numpy() - golden[f"weights_{cx}_{cz}"])
    assert (d <= 2e-3).mean() > 0.95
    assert d.max() < 0.02


@pytest.mark.parametrize("i", range(len(CHUNKS)))
def test_golden_height(golden, golden_stages, i):
    cx, cz = CHUNKS[i]
    d = np.abs(golden_stages["hf"][i].numpy() - golden[f"hf18_{cx}_{cz}"][1:17, 1:17])
    assert np.median(d) < 0.05
    assert (d < 1.0).mean() > 0.98


@pytest.mark.parametrize("cx,cz", CHUNKS)
def test_golden_layers(golden, cx, cz):
    hf18 = torch.from_numpy(golden[f"hf18_{cx}_{cz}"])[None]
    w = torch.from_numpy(golden[f"weights_{cx}_{cz}"])[None]
    got = layers.generate_layers(hf18, w, torch.tensor([[cx, cz]], dtype=torch.int32))[0].numpy()
    ref = golden[f"layers_{cx}_{cz}"]
    # forward entries past the surface are unwritten (zero) in the golden buffer
    max_h = golden[f"hf18_{cx}_{cz}"][1:17, 1:17]
    live = np.ones_like(ref, dtype=bool)
    overflow = np.zeros_like(max_h, dtype=bool)
    for i in range(1, bio.NUM_FORWARD_MATERIALS):
        overflow |= ref[i - 1] > max_h
        live[i] = ~overflow
    d = np.abs(got - ref)[live]
    assert np.median(d) < 0.05
    assert (d < 1.0).mean() > 0.98


@pytest.mark.parametrize("i", range(len(CHUNKS)))
def test_golden_cave_layers(golden, golden_stages, i):
    cx, cz = CHUNKS[i]
    cv = golden_stages["caves"]
    assert (cv["starts"][i].numpy() == golden[f"cavestarts_{cx}_{cz}"]).mean() > 0.95
    assert (cv["ends"][i].numpy() == golden[f"caveends_{cx}_{cz}"]).mean() > 0.95


@pytest.mark.parametrize("i", range(2))
def test_golden_cave_biomes(golden, golden_stages, i):
    cx, cz = CHUNKS[i]
    cv = golden_stages["caves"]
    ref_starts = golden[f"cavestarts_{cx}_{cz}"]
    m = (cv["starts"][i].numpy() == ref_starts) & (ref_starts != 384)
    assert m.sum() > 0
    assert (cv["bottom_biome"][i].numpy()[m] == golden[f"cavebottom_{cx}_{cz}"][m]).mean() > 0.97


# -- helper functions vs JAX eager on seeded inputs -------------------------------------------


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(RNG_SEED + 7)


def test_max_slope_and_material_weights(rng):
    g18 = rng.uniform(60.0, 250.0, (2, 18, 18)).astype(np.float32)
    np.testing.assert_array_equal(
        layers.max_slope(torch.from_numpy(g18)).numpy(), _jax_exact(j_layers.max_slope, g18)
    )
    w = rng.uniform(0.0, 1.0, (2, 24, 16, 16)).astype(np.float32)
    got = layers.total_material_weights(torch.from_numpy(w)).numpy()
    want = _jax_exact(j_layers.total_material_weights, w)
    assert np.abs(got - want).max() <= 1e-5  # sum order: einsum vs in-order loop


def test_fix_backward_stratified(rng):
    ls = rng.uniform(0.0, 200.0, (2, 20, 16, 16)).astype(np.float32)
    np.testing.assert_array_equal(
        layers.fix_backward_stratified(torch.from_numpy(ls)).numpy(),
        _jax_exact(j_layers.fix_backward_stratified, ls),
    )


def test_halo_gather_matches_jax(rng):
    hf = rng.uniform(60.0, 250.0, (4 * 5, 16, 16)).astype(np.float32)  # 2 x 3 inner + halo
    got = gather.gather_halo_heightfields(torch.from_numpy(hf), 3, 2).numpy()
    grid = hf.reshape(4, 5, 16, 16)
    want = np.stack([
        _jax_exact(j_gather.gather_heightfield_3x3, grid[iz:iz + 3, ix:ix + 3])
        for iz in range(2) for ix in range(3)
    ])
    np.testing.assert_array_equal(got, want)
    full = gather.assemble_chunk_grid(torch.from_numpy(grid))
    np.testing.assert_array_equal(gather.split_chunk_grid(full, 4, 5).numpy(), grid)


def test_cave_depths_match_jax(rng):
    starts = np.sort(rng.integers(0, 384, (3, 32)), axis=-1).astype(np.int32)
    ends = np.minimum(starts + rng.integers(0, 30, (3, 32)), 384).astype(np.int32)
    starts[:, 20:] = 384  # unused layers
    y = np.arange(384, dtype=np.int32)[None, :, None]
    got = fill._cave_depths(torch.from_numpy(starts)[:, None], torch.from_numpy(ends)[:, None],
                            torch.from_numpy(y))
    want = _jax_exact(j_fill._cave_depths, starts[:, None], ends[:, None], y)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


# -- seeded origins: whole-column invariants of the plain stages -------------------------------


@pytest.mark.parametrize("origin", SEEDED)
def test_seeded_chunk_invariants(origin):
    """Stages 1, 2 (own-edge halo), 4 and 5 at a seeded chunk: shapes, dtypes, finite
    values, ordered cave layers, bedrock at y = 0, air above surface and sea."""
    pos = torch.tensor([origin], dtype=torch.int32)
    hf, w = heightfield.generate_heightfield(pos)
    g18 = torch.nn.functional.pad(hf[:, None], (1, 1, 1, 1), mode="replicate")[:, 0]
    ls = layers.fix_backward_stratified(layers.generate_layers(g18, w, pos))
    cv = caves.generate_caves(hf, w, pos)
    blocks = fill.fill_chunks(hf, w, ls, cv["starts"], cv["ends"], pos)
    assert blocks.shape == (1, 16, 16, 384) and blocks.dtype == torch.uint8
    assert ls.shape == (1, 20, 16, 16) and w.shape == (1, 24, 16, 16)
    for t in (hf, w, ls):
        assert bool(torch.isfinite(t).all())
    s, e = cv["starts"], cv["ends"]
    used = s[..., 1:] != 384
    assert bool((s <= e).all()) and bool((s[..., 1:][used] > e[..., :-1][used]).all())
    assert bool((blocks[..., 0] == int(Block.BEDROCK)).all())
    y = torch.arange(384, dtype=torch.float32)
    above = (y > hf[..., None]) & (y > bio.SEA_LEVEL)
    assert bool(above.any()) and bool((blocks[above] == int(Block.AIR)).all())


def test_generate_area_layout():
    out = pipeline.generate_area(0, 0, 1, 1, device="cpu")
    assert out["blocks"].shape == (1, 1, 16, 16, 384)
    assert out["chunk_pos"].tolist() == [[0, 0]]


# -- wrappers: dispatch and checks --------------------------------------------------------------


def test_stage_on_unsupported_device_raises():
    pos = torch.zeros((1, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel or plain path"):
        heightfield.generate_heightfield(pos)


def _misaligned_placement_inputs():
    """K5's inputs for one chunk, the cave starts 4 bytes off a 16-byte boundary."""
    cave = [torch.zeros((1, 16, 16, 32), dtype=torch.int32) for _ in range(4)]
    cave[0] = torch.zeros(16 * 16 * 32 + 1, dtype=torch.int32)[1:].view(1, 16, 16, 32)
    return (torch.zeros((1, 16, 16)), torch.zeros((1, 24, 16, 16)), torch.zeros((1, 20, 16, 16)), *cave,
            torch.zeros((1, 2), dtype=torch.int32))


def _stream_lists(B):
    """K7a's input lists (x, y, z, count) of B chunks."""
    return tuple({**{k: torch.zeros((B, K), dtype=torch.int32) for k in "xyz"},
                  "count": torch.zeros(B, dtype=torch.int32)} for K in (256, 1024))


def _stream_rows(C):
    """K7a's outputs of C rows."""
    return torch.zeros((C, 256, 64)), torch.zeros((C, 1024, 64))


@pytest.mark.parametrize(
    "call",
    [
        lambda: kernels.heightfield(torch.zeros((1, 2), dtype=torch.int64)),
        lambda: kernels.heightfield(torch.zeros((1, 3), dtype=torch.int32)),
        lambda: kernels.caves(torch.zeros((1, 16, 16)), torch.zeros((1, 24, 16, 16)),
                              torch.zeros((2, 2), dtype=torch.int32), caves.CELL_TABLE_CAP),
        lambda: kernels.fill(torch.zeros((1, 16, 16)), torch.zeros((1, 24, 16, 16)),
                             torch.zeros((1, 20, 16, 16)).transpose(2, 3),
                             torch.zeros((1, 16, 16, 32), dtype=torch.int32),
                             torch.zeros((1, 16, 16, 32), dtype=torch.int32),
                             torch.zeros((1, 2), dtype=torch.int32), tables.LUSH_TABLE_CELLS),
        lambda: kernels.layers(torch.zeros((9, 16, 16)), torch.zeros((9, 24, 16, 16)),
                               torch.zeros((9, 2), dtype=torch.int32), 2, 1),
        lambda: kernels.dp_layers(torch.zeros((4, 2))),
        lambda: kernels.erosion_band(*(torch.zeros((50, 384)),) * 3, torch.zeros((50, 383)),
                                     torch.zeros((50, 384)), False, False, 7,
                                     torch.zeros(2, dtype=torch.int32), 0),
        lambda: kernels.caves(torch.zeros((1, 16, 16)), torch.zeros((1, 24, 16, 16)),
                              torch.zeros((1, 2), dtype=torch.int32), -1),
        lambda: kernels.caves(torch.zeros((1, 16, 16)), torch.zeros((1, 24, 16, 16)),
                              torch.zeros((1, 2), dtype=torch.int32), kernels.MAX_TABLE_CELLS + 1),
        lambda: kernels.fill(torch.zeros((1, 16, 16)), torch.zeros((1, 24, 16, 16)),
                             torch.zeros((1, 20, 16, 16)), torch.zeros((1, 16, 16, 32), dtype=torch.int32),
                             torch.zeros((1, 16, 16, 32), dtype=torch.int32),
                             torch.zeros((1, 2), dtype=torch.int32), tables.LUSH_TABLE_CELLS + 1),
        lambda: kernels.fill(torch.zeros((1, 16, 16)), torch.zeros((1, 24, 16, 16)),
                             torch.zeros((1, 20, 16, 16)), torch.zeros((1, 16, 16, 32), dtype=torch.int32),
                             torch.zeros((1, 16, 16, 32), dtype=torch.int32),
                             torch.zeros((1, 2), dtype=torch.int32), tables.LUSH_TABLE_CELLS,
                             torch.zeros(3, dtype=torch.int32)),
        lambda: kernels.placements(*_misaligned_placement_inputs()),
        lambda: kernels.feature_streams(*_stream_lists(2), rows=torch.zeros(2, dtype=torch.int32)),
        lambda: kernels.feature_streams(*_stream_lists(2), out=_stream_rows(3)),
        lambda: kernels.feature_streams(*_stream_lists(2), out=_stream_rows(3), rows=torch.zeros(2)),
        lambda: kernels.feature_streams(*_stream_lists(2), out=_stream_rows(3)[::-1],
                                        rows=torch.zeros(2, dtype=torch.int32)),
    ],
    ids=["dtype", "shape", "batch", "contiguity", "halo-shape", "dp-layers-dtype", "erosion-band-shape",
         "caves-table-cells", "caves-table-too-large", "fill-table-too-large", "fill-stats-shape",
         "placements-misaligned", "streams-rows-without-out", "streams-out-needs-rows",
         "streams-rows-dtype", "streams-out-shape"],
)
def test_kernel_wrappers_validate_before_launch(call):
    before = kernels.launch_counts()
    with pytest.raises((TypeError, ValueError)):
        call()
    assert kernels.launch_counts() == before


def test_from_jax_outputs_dtypes():
    out = tables.from_jax_outputs(
        {"heightfield": np.zeros((1, 16, 16), np.float32), "blocks": np.zeros((1, 2), np.uint8),
         "caves": {"starts": np.zeros((1, 32), np.int32)}}, "cpu")
    assert out["heightfield"].dtype == torch.float32
    assert out["blocks"].dtype == torch.uint8
    assert out["caves"]["starts"].dtype == torch.int32
    with pytest.raises(KeyError):
        tables.from_jax_outputs({"nope": np.zeros(1)}, "cpu")


def test_tables_carry_the_numpy_tables():
    tb = tables.load_tables("cpu")
    np.testing.assert_array_equal(tb.biome_material_weights.numpy(), bio.BIOME_MATERIAL_WEIGHTS)
    np.testing.assert_array_equal(tb.biome_noise_weights.numpy(), bio.BIOME_NOISE_WEIGHTS)
    np.testing.assert_array_equal(tb.cave_biome_noise_weights.numpy(), bio.CAVE_BIOME_NOISE_WEIGHTS)
    np.testing.assert_array_equal(tb.material_block.numpy(), bio.MATERIAL_BLOCK)
    np.testing.assert_array_equal(tb.grass_blocks.numpy(), bio.GRASS_BLOCKS)
    assert tb.sea_level == bio.SEA_LEVEL and tb.device == torch.device("cpu")
