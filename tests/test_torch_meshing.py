"""The port's mesher (``mega_minecraft_tpu_torch/render/meshing.py`` with the native face
scan ``native/mesher.cpp``, built with g++ into ``build/native/``) vs the JAX package's.

Host code in both packages (numpy and ctypes C++, no device program), so the meshes are
compared exactly: positions, normals, UVs, material classes and indices equal.  Cases:
JAX's two ``TestMeshing`` cases (``tests/test_render.py:360-375``); a seeded chunk of
random block ids (every transparency class, the X-shaped flora's jitter, the seeded UV
rotation and flip) with three neighbours and one missing, against JAX's ``mesh_chunk``;
the native face scan against the numpy one (the same quads; the scan orders differ);
and an ``export_obj`` round trip.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from mega_minecraft_tpu.render import meshing as jmesh
from mega_minecraft_tpu_torch import native
from mega_minecraft_tpu_torch.render import meshing
from mega_minecraft_tpu_torch.world.blocks import NUM_BLOCKS, Block

KEYS = ("positions", "normals", "uvs", "mats", "indices")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs its files in several processes on the same
    cores, where torch's spinning thread pools would starve each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _random_chunk(rng):
    """[16, 16, 384] u8: air above a random surface, random block ids below it and a
    sprinkle of random ids (flora, leaves, water, glass...) above."""
    b = rng.integers(1, NUM_BLOCKS, (16, 16, 384), dtype=np.uint8)
    height = rng.integers(60, 120, (16, 16, 1))
    y = np.arange(384)[None, None, :]
    air = (y >= height) & (rng.random((16, 16, 384)) < 0.97)
    b[air] = int(Block.AIR)
    b[rng.random((16, 16, 384)) < 0.2] = int(Block.AIR)
    return b


@pytest.fixture(scope="module")
def seeded():
    rng = np.random.default_rng(20261017)
    blocks = _random_chunk(rng)
    nbs = {(1, 0): _random_chunk(rng), (-1, 0): _random_chunk(rng), (0, 1): _random_chunk(rng)}
    return blocks, nbs, (-48, 112)


def _face_rows(mesh):
    """The regular faces of a mesh as rows (4 corners' position, normal, UV, material),
    sorted, and the X-shaped quads (appended after them, diagonal normals) as they are."""
    diag = np.abs(np.abs(mesh["normals"][:, 0]) - np.float32(0.70710678)) < 1e-6
    x0 = int(np.argmax(diag)) if diag.any() else len(mesh["positions"])
    reg = np.concatenate([mesh["positions"][:x0].reshape(-1, 12), mesh["normals"][:x0].reshape(-1, 12),
                          mesh["uvs"][:x0].reshape(-1, 8), mesh["mats"][:x0].reshape(-1, 4).astype(np.float32)],
                         axis=1)
    return reg[np.lexsort(reg.T[::-1])], {k: mesh[k][x0:] for k in KEYS if k != "indices"}


def test_counts_and_visibility():
    blocks = np.zeros((16, 16, 384), np.uint8)
    blocks[:, :, :100] = int(Block.STONE)
    full = np.copy(blocks)
    mesh = meshing.mesh_chunk(blocks, {(1, 0): full, (-1, 0): full, (0, 1): full, (0, -1): full}, (0, 0))
    # top faces + bottom faces at the world floor (y=0 neighbor is out of range,
    # which the reference emits unconditionally, chunk.cu:1881): 512 quads
    assert mesh["positions"].shape[0] == 2048
    assert set(np.unique(mesh["normals"][:, 1])) == {-1.0, 1.0}


def test_x_shaped():
    blocks = np.zeros((16, 16, 384), np.uint8)
    blocks[8, 8, 100] = int(Block.GRASS)
    mesh = meshing.mesh_chunk(blocks, {}, (0, 0))
    assert mesh["positions"].shape[0] == 8  # two crossed quads
    assert len(mesh["indices"]) == 12


@pytest.mark.parametrize("key", KEYS)
def test_mesh_chunk_equals_jax(seeded, key):
    blocks, nbs, origin = seeded
    got = meshing.mesh_chunk(blocks, nbs, origin)
    want = jmesh.mesh_chunk(blocks, nbs, origin)
    assert len(got["indices"]) > 60000, "vacuous: few faces"
    assert got[key].dtype == want[key].dtype
    np.testing.assert_array_equal(got[key], want[key])


def test_native_faces_equal_numpy_faces(seeded, monkeypatch):
    blocks, nbs, origin = seeded
    assert native.available(), "g++ could not build native/mesher.cpp"
    assert str(native.LIB).endswith("build/native/libmesher.so")
    got = meshing.mesh_chunk(blocks, nbs, origin)
    monkeypatch.setattr(native, "extract_faces", lambda b, n: None)
    want = meshing.mesh_chunk(blocks, nbs, origin)
    g_rows, g_x = _face_rows(got)
    w_rows, w_x = _face_rows(want)
    assert len(g_rows) > 10000 and len(g_x["positions"]) > 100, "vacuous: few faces or no flora"
    np.testing.assert_array_equal(g_rows, w_rows)
    for k in g_x:
        np.testing.assert_array_equal(g_x[k], w_x[k])
    np.testing.assert_array_equal(got["indices"], want["indices"])


def test_block_histogram_native_and_numpy(seeded, monkeypatch):
    blocks = seeded[0]
    want = np.bincount(blocks.reshape(-1), minlength=256)
    np.testing.assert_array_equal(native.block_histogram(blocks), want)
    monkeypatch.setattr(native, "_load", lambda: None)
    np.testing.assert_array_equal(native.block_histogram(blocks), want)


def test_export_obj_roundtrip(seeded, tmp_path):
    blocks, nbs, origin = seeded
    blocks = blocks.copy()
    blocks[:, :, :110] = int(Block.STONE)  # fewer faces: a solid floor under the random top
    mesh = meshing.mesh_chunk(blocks, nbs, origin)
    assert len(mesh["indices"]) > 3000, "vacuous: few faces"
    path = tmp_path / "chunk.obj"
    meshing.export_obj(mesh, str(path))
    v, vn, vt, f = [], [], [], []
    for line in path.read_text().splitlines():
        tag, *vals = line.split()
        if tag == "f":
            f.append([int(c.split("/")[0]) for c in vals])
            assert all(len(set(c.split("/"))) == 1 for c in vals)
        else:
            {"v": v, "vn": vn, "vt": vt}[tag].append([float(x) for x in vals])
    np.testing.assert_array_equal(np.asarray(v, np.float32), mesh["positions"])
    np.testing.assert_array_equal(np.asarray(vn, np.float32), mesh["normals"])
    np.testing.assert_array_equal(np.asarray(vt, np.float32), mesh["uvs"])
    np.testing.assert_array_equal(np.asarray(f, np.int32) - 1, mesh["indices"].reshape(-1, 3))
