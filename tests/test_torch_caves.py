"""K3's carve-test cell table on the CPU: the cell box that the Worley searches of a chunk's
carve band read, with the +-1 ring, computed from the port's plain noise
(``terrain/caves.py`` ``carve_warp``), must fit the table's capacity
``caves.CELL_TABLE_CAP`` at the golden chunks and at far ones, so that no tile of K3 takes
the direct path there (a tile's box lies inside its chunk's); and the distinct-cell count
that prices the hashes in ``chip_smoke.py``'s bound of K3.
"""

from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch

from mega_minecraft_tpu_torch.terrain import caves

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import distinct_cells  # noqa: E402

#: chunk origins (blocks): the golden chunks, then far ones up to the world border
GOLDEN = [(0, 0), (592, -368), (-1024, 2048), (4096, 4096), (-160, -160)]
FAR = [(1048576, -1048576), (-2000000, 3000000), (29999984, -29999984)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs its files in several processes on the same
    cores, where torch's spinning thread pools would starve each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("origin", GOLDEN + FAR, ids=str)
def test_carve_cell_box_fits_the_table(origin):
    pos = torch.tensor([origin], dtype=torch.int32)
    cells = torch.stack([torch.floor(c) for c in caves.carve_warp(*caves.band_coords(pos))], dim=-1)
    cells = cells.to(torch.int64).reshape(1, -1, 3)
    assert cells.shape == (1, 16 * 16 * caves.CARVE_Y_MAX, 3)
    edges = cells.amax(dim=1)[0] - cells.amin(dim=1)[0] + 3  # the box with the +-1 ring
    assert int(edges.prod()) <= caves.CELL_TABLE_CAP, edges.tolist()
    n = int(distinct_cells(cells, torch.ones(cells.shape[:2], dtype=torch.bool))[0])
    assert 27 <= n <= int(edges.prod())


def test_distinct_cells_counts_the_union_of_neighbourhoods():
    def count(cells, active=None):
        cells = torch.tensor(cells)
        active = torch.ones(cells.shape[:2], dtype=torch.bool) if active is None else torch.tensor(active)
        return distinct_cells(cells, active).tolist()

    assert count([[[5, -3, 7]] * 4]) == [27]
    assert count([[[5, -3, 7], [6, -3, 7]]]) == [36]  # neighbours along x: 4 x 3 x 3
    assert count([[[0, 0, 0], [0, 9, 0]]]) == [54]  # disjoint neighbourhoods
    # inactive entries read nothing, nor widen the box; a chunk with none reads no cell
    assert count([[[0, 0, 0], [0, 9, 0]], [[1, 1, 1], [50, 2, 2]]], [[True, False], [False, False]]) == [27, 0]
