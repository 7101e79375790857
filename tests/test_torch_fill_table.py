"""K4's lush-cave cell table on the CPU.

K4 (``csrc/fill.cu``) takes a tile of ``tables.FILL_TILE_COLS`` consecutive columns of a
chunk; the clay test of its lush near blocks searches the 27 Worley cells around each clay
point (``terrain/fill.py`` ``lush_clay_point``), whose jitters it hashes once a tile into a
table over the box of the points' floor cells with the +-1 ring, keyed by the integer cell
(``mmt_math.cuh`` ``TableJitter``).  Here, with the port's plain noise:
- (a) that table search, emulated in plain torch, equals ``ops/noise.py`` ``worley3(...)["f1"]``
  bit for bit on the clay points of the golden chunks, of far chunks and of one chunk past
  |x| = 671,088,640, where the cells pass 2^24 and their floats round (the port's ``worley3``
  is held to JAX's in ``tests/test_torch_ops.py``);
- (b) the box of every tile, taken over all its blocks below ``CAVE_BIOME_Y_MAX`` (a
  superset of its lush blocks), fits ``tables.LUSH_TABLE_CELLS``, so that no tile takes the
  kernel's direct path there.
"""

from __future__ import annotations

import pytest
import torch

from mega_minecraft_tpu_torch.ops.hashes import rand3_from3
from mega_minecraft_tpu_torch.ops.noise import worley3
from mega_minecraft_tpu_torch.tables import CAVE_BIOME_Y_MAX, FILL_TILE_COLS, LUSH_TABLE_CELLS
from mega_minecraft_tpu_torch.terrain import fill
from mega_minecraft_tpu_torch.terrain.heightfield import column_world_coords

#: chunk origins (blocks): the golden chunks, far ones, and one whose clay cells pass 2^24
GOLDEN = [(0, 0), (592, -368), (-1024, 2048), (4096, 4096), (-160, -160)]
FAR = [(1048576, -1048576), (-2000000, 3000000), (29999984, -29999984)]
BEYOND_2_24 = [(671089664, -671092736)]
SAMPLE = 4096  # clay points a chunk whose F1 is searched both ways


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs its files in several processes on the same
    cores, where torch's spinning thread pools would starve each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def clay_points(origin):
    """[tiles, FILL_TILE_COLS * 192, 3] f32: the clay point of every block below CAVE_BIOME_Y_MAX
    of each tile of the chunk (FILL_TILE_COLS consecutive x of one z row, as K4 takes them)."""
    wx, wz = column_world_coords(torch.tensor([origin], dtype=torch.int32))
    wyf = torch.arange(CAVE_BIOME_Y_MAX, dtype=torch.float32)
    p = fill.lush_clay_point(wx.to(torch.float32)[0, ..., None], wyf, wz.to(torch.float32)[0, ..., None])
    p = torch.stack(torch.broadcast_tensors(*p), dim=-1)  # [z, x, y, 3]
    tiles = 16 * (16 // FILL_TILE_COLS)
    return p.reshape(16, 16 // FILL_TILE_COLS, FILL_TILE_COLS * CAVE_BIOME_Y_MAX, 3).reshape(tiles, -1, 3)


def tile_boxes(points):
    """The floor cells' box of each tile with the +-1 ring: (first cell [T, 3] i64, edges [T, 3])."""
    cells = torch.floor(points).to(torch.int64)
    lo = cells.amin(dim=1) - 1
    return lo, cells.amax(dim=1) + 2 - lo


def table_f1(points, lo, edges, pick):
    """Worley F1 at points[t, i] for (t, i) in ``pick``, read from each tile's table of its box:
    rand3_from3 of the float of each integer cell (the table's key), the search's distances,
    compares and order those of worley3."""
    n_max = int(edges.prod(dim=1).max())
    tables = torch.zeros((points.shape[0], n_max, 3), dtype=torch.float32)
    for t in range(points.shape[0]):
        ex, ey, ez = (int(e) for e in edges[t])
        a, b, c = torch.meshgrid(torch.arange(ex), torch.arange(ey), torch.arange(ez), indexing="ij")
        cell = [(lo[t, k] + v.reshape(-1)).to(torch.float32) for k, v in enumerate((a, b, c))]
        tables[t, : ex * ey * ez] = torch.stack(rand3_from3(*cell), dim=-1)
    ti, pi = pick
    p = points[ti, pi]
    ip = torch.floor(p)
    f = p - ip
    base = ip.to(torch.int64) - lo[ti]
    min1 = torch.full(p.shape[:1], torch.finfo(torch.float32).max)
    for ox in (-1, 0, 1):
        for oy in (-1, 0, 1):
            for oz in (-1, 0, 1):
                o = torch.tensor([ox, oy, oz])
                rel = base + o
                idx = (rel[:, 0] * edges[ti, 1] + rel[:, 1]) * edges[ti, 2] + rel[:, 2]
                r = tables[ti, idx]
                d = o.to(torch.float32) + r - f
                dist = torch.sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2])
                min1 = torch.where(dist < min1, dist, min1)
    return min1


@pytest.mark.parametrize("origin", GOLDEN + FAR + BEYOND_2_24, ids=str)
def test_table_search_equals_worley3_and_box_fits(origin):
    points = clay_points(origin)
    lo, edges = tile_boxes(points)
    cells = edges.prod(dim=1)
    # (b) every tile's box, over all its band blocks, fits the table
    assert int(cells.max()) <= LUSH_TABLE_CELLS, edges[int(cells.argmax())].tolist()
    assert int(cells.min()) >= 27
    # (a) the table search on a sample of every tile's points equals worley3's F1 bit for bit
    g = torch.Generator().manual_seed(abs(origin[0]) % 9973 + abs(origin[1]) % 7919)
    flat = torch.randperm(points.shape[0] * points.shape[1], generator=g)[:SAMPLE]
    pick = (flat // points.shape[1], flat % points.shape[1])
    got = table_f1(points, lo, edges, pick)
    p = points[pick]
    want = worley3(p[:, 0], p[:, 1], p[:, 2])["f1"]
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    if origin in BEYOND_2_24:
        assert float(p[:, 0].abs().min()) > 2.0**24  # the cells' floats round here
