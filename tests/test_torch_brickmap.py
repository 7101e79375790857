"""The port's scene build (``mega_minecraft_tpu_torch/render/brickmap.py``, the plain
version of K10) vs the JAX package's, on the same numpy volumes.

The fields are integer, so every comparison is bit equality: the whole ``build_scene``
buffer (fine then macro) on a seeded 32x32x384 volume holding stone, water, a crystal,
glowstone, leaves and X-shaped flora; each building block (distance, clearances,
skyline, macro encoding) on its solid mask; the alpha-flag bits (31 and 8-15) on a
24x24x64 volume whose flag table is set by hand, since the procedural atlas flags no
block; and the streamed update (``update_chunks``, the plain version of K10u, with the
engine's ``_assemble_region`` folded in) against JAX's ``_assemble_region`` +
``update_chunks`` fed the same slot-table chunks: a region written into an empty scene,
blocks removed, a region at the edge of a 9x9-chunk scene (clamped window) and one in its
middle (a window smaller than the scene).  The CUDA kernel is held to this plain version on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mega_minecraft_tpu.render import brickmap as jb
from mega_minecraft_tpu.render import materials as jmat
from mega_minecraft_tpu.world.blocks import RENDER_SOLID, Block as B
from mega_minecraft_tpu_torch import tables
from mega_minecraft_tpu_torch.render import brickmap as tb


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs its files in several processes on the same
    cores, where torch's spinning thread pools would starve each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def scene_volume(seed: int = 0, size: int = 32, ydim: int = 384) -> np.ndarray:
    """A seeded [size, size, ydim] u8 volume: rough stone terrain, a water pool, a
    crystal, glowstone, a leaf canopy, a floating slab and scattered X-shaped flora."""
    rng = np.random.RandomState(seed)
    vol = np.zeros((size, size, ydim), np.uint8)
    base = ydim // 4
    hts = rng.randint(base - 6, base + 10, size=(size, size))
    for z in range(size):
        for x in range(size):
            vol[z, x, : hts[z, x]] = int(B.STONE)
    s = size // 32 if size >= 32 else 1
    vol[8 * s : 20 * s, 8 * s : 20 * s, base - 6 : base + 4] = int(B.WATER)
    vol[22 * s : 25 * s, 4 * s : 7 * s, base + 4 : base + 10] = int(B.CYAN_CRYSTAL)
    vol[4 * s : 6 * s, 22 * s : 24 * s, base + 12 : base + 15] = int(B.GLOWSTONE)
    vol[24 * s : 30 * s, 24 * s : 30 * s, base + 14 : base + 20] = int(B.BIRCH_LEAVES)
    vol[12 * s : 14 * s, 20 * s : 22 * s, base + 40 : base + 44] = int(B.STONE)
    for _ in range(size):
        z, x = rng.randint(0, size, 2)
        vol[z, x, hts[z, x]] = int(B.GRASS if rng.rand() < 0.5 else B.POPPY)
    return vol


@pytest.fixture(scope="module")
def vol():
    return scene_volume()


@pytest.fixture(scope="module")
def jax_scene(vol):
    chunks = vol.reshape(2, 16, 2, 16, 384).transpose(0, 2, 1, 3, 4)
    return jb.build_scene(jnp.asarray(chunks), -3, 5)


def test_build_scene_bit_equal_to_jax(vol, jax_scene):
    chunks = np.ascontiguousarray(vol.reshape(2, 16, 2, 16, 384).transpose(0, 2, 1, 3, 4))
    got = tb.build_scene(torch.from_numpy(chunks), -3, 5)
    assert got.dims == jax_scene.dims == (32, 32, 384)
    assert got.origin == tuple(int(v) for v in np.asarray(jax_scene.origin)) == (-48, 0, 80)
    assert got.flat.dtype == torch.int32
    np.testing.assert_array_equal(got.flat.numpy(), np.asarray(jax_scene.flat))
    # a numpy input goes to the device asked for
    np.testing.assert_array_equal(tb.build_scene(chunks, -3, 5, device="cpu").flat.numpy(),
                                  np.asarray(jax_scene.flat))
    # the field and macro views, and the scene carried over from JAX
    carried = tables.scene_from_numpy(np.asarray(jax_scene.flat), np.asarray(jax_scene.origin),
                                      jax_scene.dims, "cpu")
    assert torch.equal(carried.field, got.field) and torch.equal(carried.macro, got.macro)
    assert tuple(carried.macro.shape) == (8, 8, 96)
    materials = {int(v) for v in np.unique(vol)}
    assert {int(B.WATER), int(B.CYAN_CRYSTAL), int(B.GLOWSTONE), int(B.BIRCH_LEAVES),
            int(B.GRASS), int(B.POPPY)} <= materials


PARTS = {
    "chebyshev_3d": (lambda m: jb.chebyshev_distance(m), lambda m: tb.chebyshev_distance(m)),
    "chebyshev_2d": (lambda m: jb.chebyshev_distance(m, axes=(0, 1)),
                     lambda m: tb.chebyshev_distance(m, axes=(0, 1))),
    "up_clearance": (jb._up_clearance, tb._up_clearance),
    "slab_2": (lambda m: jb._slab_clearance(m, 2), lambda m: tb._slab_clearance(m, 2)),
    "slab_8": (lambda m: jb._slab_clearance(m, 8), lambda m: tb._slab_clearance(m, 8)),
    "skyline": (jb._skyline_descent, tb._skyline_descent),
}


@pytest.mark.parametrize("part", sorted(PARTS))
def test_field_part_bit_equal_to_jax(vol, part):
    solid = RENDER_SOLID[vol]
    want = np.asarray(PARTS[part][0](jnp.asarray(solid)))
    got = PARTS[part][1](torch.from_numpy(solid)).numpy()
    np.testing.assert_array_equal(got, want)


def test_macro_and_dilation_bit_equal_to_jax(vol, jax_scene):
    field = np.array(jax_scene.field)
    np.testing.assert_array_equal(tb._encode_macro(torch.from_numpy(field)).numpy(),
                                  np.asarray(jb._encode_macro(jnp.asarray(field))))
    top = np.random.RandomState(3).randint(-1, 300, size=(20, 28)).astype(np.int32)
    for r in (1, 3, 8):
        np.testing.assert_array_equal(tb._dilate_max_2d(torch.from_numpy(top), r, -1).numpy(),
                                      np.asarray(jb._dilate_max_2d(jnp.asarray(top), r, -1)))


def test_alpha_flag_bits_with_hand_set_table(monkeypatch):
    """Bits 31 and 8-15 of flagged solids, reached with a flag table set by hand."""
    vol = scene_volume(seed=7, size=24, ydim=64)
    flags = np.zeros_like(jmat.ALPHA_TESTED)
    frac = np.zeros_like(jmat.ALPHA_T_FRAC)
    for blk, f in ((B.BIRCH_LEAVES, 77), (B.GRASS, 200), (B.POPPY, 255), (B.STONE, 1)):
        flags[int(blk)], frac[int(blk)] = True, f
    monkeypatch.setattr(jmat, "ALPHA_TESTED", flags)
    monkeypatch.setattr(jmat, "ALPHA_T_FRAC", frac)
    monkeypatch.setattr(tb, "ALPHA_TESTED", flags)
    monkeypatch.setattr(tb, "ALPHA_T_FRAC", frac)
    solid = RENDER_SOLID[vol]
    want = np.asarray(jb._encode(jnp.asarray(vol.astype(np.int32)), jnp.asarray(solid)))
    got = tb._encode(torch.from_numpy(vol.astype(np.int32)), torch.from_numpy(solid)).numpy()
    np.testing.assert_array_equal(got, want)
    flagged = want < 0
    assert flagged.sum() > 1000 and ((want[flagged] >> 8) & 0xFF).max() == 255


def test_empty_scene_equals_jax():
    assert tb.empty_field_word() == jb.empty_field_word()
    got, want = tb.empty_scene(32, 2, -1, device="cpu"), jb.empty_scene(32, 2, -1)
    np.testing.assert_array_equal(got.flat.numpy(), np.asarray(want.flat))
    assert got.origin == (32, 0, -16) and got.dims == want.dims


def test_doubling_distance_bounds_true_linf():
    """The JAX transform (kept bit for bit) is the cheapest sum of distinct powers of two
    whose {-s, 0, s}^3 offsets reach a solid: never below the true capped L∞ distance,
    and above it at some voxels (offset (3, 3, 4): 5 where L∞ is 4)."""
    solid = np.zeros((8, 8, 32), bool)
    solid[:, :, :4] = True
    solid[3, 3, 14] = True
    got = tb.chebyshev_distance(torch.from_numpy(solid)).numpy()
    pts = np.argwhere(solid)
    idx = np.indices(solid.shape).reshape(3, -1).T
    true = np.minimum(np.abs(idx[:, None, :] - pts[None]).max(-1).min(1), 63).reshape(solid.shape)
    assert (got >= true).all()
    assert got[0, 0, 18] == 5 and true[0, 0, 18] == 4


# -- streamed updates (K10u's plain version) -------------------------------------------


def _slot_table(seed: int, n: int) -> np.ndarray:
    """[n, 16, 16, 384] u8 chunks cut from seeded volumes (the slot table's layout)."""
    vol = scene_volume(seed, 32)
    ch = vol.reshape(2, 16, 2, 16, 384).transpose(0, 2, 1, 3, 4).reshape(4, 16, 16, 384)
    return np.ascontiguousarray(np.concatenate([ch] * (n // 4 + 1))[:n])


def _jax_update(flat, dims, d_blocks, slots, mask, gz, gx, z0, x0):
    from mega_minecraft_tpu.app.engine import _assemble_region

    scene = jb.Scene(jnp.asarray(flat), jnp.zeros(3, jnp.int32), dims)
    region = _assemble_region(jnp.asarray(d_blocks), jnp.asarray(slots, jnp.int32), jnp.asarray(mask), gz, gx)
    return np.asarray(jb.update_chunks(scene, region, z0, x0).flat)


def _port_update(flat, dims, d_blocks, slots, mask, gz, gx, z0, x0):
    scene = tb.Scene(torch.from_numpy(flat.copy()), (0, 0, 0), dims)
    out = tb.update_chunks(scene, torch.from_numpy(d_blocks), slots, mask, gz, gx, z0, x0)
    assert out.flat.data_ptr() == scene.flat.data_ptr()  # in place
    return out.flat.numpy()


@pytest.fixture(scope="module")
def scene9():
    """A 9x9-chunk scene (144 x 144 x 384, wider than a one-chunk region's 142-block
    window) built by JAX from tiled seeded volumes."""
    vol = np.tile(scene_volume(0, 32), (5, 5, 1))[:144, :144]
    js = jb.build_scene(jnp.asarray(vol.reshape(9, 16, 9, 16, 384).transpose(0, 2, 1, 3, 4)), 0, 0)
    return np.array(js.flat), js.dims


UPDATE_CASES = {
    # scene, region (gz, gx), volume offset (z0, x0), slots, mask
    "into_empty_scene": ("empty", 2, 2, 16, 0, [1, 2, 3, 0], [True, False, True, True]),
    "blocks_removed": ("built", 1, 2, 16, 16, [2, 3], [False, True]),
    "edge_clamped_window": ("9x9", 1, 1, 0, 128, [5], [True]),
    "window_inside_scene": ("9x9", 1, 1, 64, 64, [6], [True]),
}


@pytest.mark.parametrize("case", sorted(UPDATE_CASES))
def test_update_chunks_bit_equal_to_jax(case, scene9, vol):
    kind, gz, gx, z0, x0, slots, mask = UPDATE_CASES[case]
    if kind == "empty":
        flat, dims = np.array(jb.empty_scene(48, 0, 0).flat), (48, 48, 384)
    elif kind == "built":
        chunks = vol[:32, :32].reshape(2, 16, 2, 16, 384).transpose(0, 2, 1, 3, 4)
        js = jb.build_scene(jnp.asarray(np.tile(chunks, (2, 2, 1, 1, 1))[:3, :3]), 0, 0)
        flat, dims = np.array(js.flat), js.dims
    else:
        flat, dims = scene9
    d_blocks = _slot_table(9, 8)
    zlo, xlo, wz, wx = tb.update_window(dims, gz, gx, z0, x0)
    if kind == "9x9":
        assert (wz, wx) == (gz * 16 + 126, gx * 16 + 126) and (wz, wx) < dims[:2]
        assert (xlo == dims[1] - wx) == (case == "edge_clamped_window")
    want = _jax_update(flat, dims, d_blocks, slots, mask, gz, gx, z0, x0)
    got = _port_update(flat, dims, d_blocks, slots, mask, gz, gx, z0, x0)
    np.testing.assert_array_equal(got, want)
    assert (got != flat).sum() > 1000  # the update changed the scene
