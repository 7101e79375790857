"""K7's / K7s's per-chunk cull (the pre-pass of ``csrc/features.cu``) on the CPU.

The plain versions ``features.cull_area_plain`` / ``cull_slots_plain`` list, for each consumer
chunk, every visible entry of its gathered list whose XZ window meets the chunk's 16 x 16
columns, in gathered order (every visible entry with ``cull=False``).  Here:
- the culled list is exactly the gathered entries whose window holds at least one of the
  chunk's columns (each column's window survivors, counted column by column), in order;
- applying each chunk's culled lists with the per-chunk plain application
  (``features.apply_culled_plain``) equals the unculled plain results:
  ``apply_features_area_plain`` (K7's semantics) and ``apply_features_slots_plain`` (K7s's);
on a featured 2x1 area built from the golden chunks (their terrain's placement lists, K5 and
K6 plain, moved onto the area's chunks; their ``golden_blockgrid.npz`` blocks as terrain), and
on synthetic lists over a strip of stone chunks that overflow K and the gather cap, with and
without the cull.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest
import torch

from mega_minecraft_tpu_torch.terrain import feature_placement as fp
from mega_minecraft_tpu_torch.terrain import features, layers
from mega_minecraft_tpu_torch.world import features_data as fd
from mega_minecraft_tpu_torch.world.blocks import Block

GOLDEN = Path(__file__).parent / "golden"
#: the golden chunks whose terrain and blocks make the 2x1 area, in its row-major order
AREA_SOURCES = [(0, 0), (592, -368)]
I32 = torch.int32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs its files in several processes on the same
    cores, where torch's spinning thread pools would starve each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _golden_lists(origin):
    """K5 + K6 (plain) on the golden chunk's terrain: {"surface", "cave"} lists of one chunk."""
    g = np.load(GOLDEN / "golden_chunks.npz")
    k = f"{origin[0]}_{origin[1]}"
    i32 = lambda name: torch.as_tensor(g[name + k].astype(np.int32))[None]  # noqa: E731
    pos = torch.tensor([origin], dtype=I32)
    pl = fp.generate_placements_plain(
        torch.as_tensor(g["hf18_" + k][1:17, 1:17].copy())[None], torch.as_tensor(g["weights_" + k])[None],
        layers.fix_backward_stratified(torch.as_tensor(g["layers_" + k])[None]), i32("cavestarts_"),
        i32("caveends_"), i32("cavebottom_"), i32("cavetop_"), pos)
    return fp.compact_placements_plain(pl, pos)


@pytest.fixture(scope="module")
def golden_area():
    """A 2x1 area at chunk (0, 0): chunk i carries AREA_SOURCES[i]'s placement lists moved by
    its offset, and that chunk's golden featured blocks as terrain."""
    pos = torch.tensor([[0, 0], [16, 0]], dtype=I32)
    per = [_golden_lists(o) for o in AREA_SOURCES]
    lists = {}
    for kind in ("surface", "cave"):
        d = {k: torch.cat([p[kind][k] for p in per]).clone() for k in per[0][kind]}
        for i, (ox, oz) in enumerate(AREA_SOURCES):
            d["x"][i] += int(pos[i, 0]) - ox
            d["z"][i] += int(pos[i, 1]) - oz
        lists[kind] = d
    gb = np.load(GOLDEN / "golden_blockgrid.npz")
    blocks = torch.stack([torch.from_numpy(gb[f"pre_{ox}_{oz}"]) for ox, oz in AREA_SOURCES])
    return blocks, lists, pos


def _strip():
    """Three stone chunks in a row with a cave layer, and hand-made lists: a neighbour's
    sphere that reaches chunk 0, placements with and without replace, cave pillars and fungi."""
    F, C = fd.Feature, fd.CaveFeature
    blocks = torch.zeros((3, 16, 16, 384), dtype=torch.uint8)
    blocks[..., :146] = int(Block.STONE)
    blocks[..., 60:91] = int(Block.AIR)
    pos = torch.tensor([[0, 0], [16, 0], [32, 0]], dtype=I32)
    surface_rows = [[(F.KELP, 14, 100, 8, 1), (F.SPHERE, 15, 102, 8, 1), (F.SPHERE, 8, 144, 8, 0)],
                    [(F.KELP, 16, 100, 8, 1), (F.SPHERE, 17, 200, 8, 0), (F.PINE_TREE, 30, 146, 3, 0)],
                    [(F.SPHERE, 33, 200, 8, 0), (F.CACTUS, 47, 146, 15, 0)]]
    cave_rows = [[(C.TEST_GLOWSTONE_PILLAR, 8, 60, 8, 0, 30), (C.STORMLIGHT_SPHERE, 15, 61, 12, 1, 29)],
                 [(C.CAVE_VINE, 20, 61, 5, 0, 29)], [(C.AMBER_FUNGUS, 35, 61, 9, 0, 29)]]
    lists = {}
    for kind, rows, fields, K in (("surface", surface_rows, ("feature", "x", "y", "z", "replace"), 256),
                                  ("cave", cave_rows, ("feature", "x", "y", "z", "replace", "height"), 1024)):
        d = {k: torch.zeros((3, K), dtype=I32) for k in fields}
        for b, entries in enumerate(rows):
            for slot, row in enumerate(entries):
                for k, v in zip(fields, row):
                    d[k][b, slot] = int(v)
        d["count"] = (d["feature"] > 0).sum(-1).to(I32)
        lists[kind] = d
    return blocks, lists, pos


def _overflowing(lists):
    """The strip's lists with chunk 0's surface count past K and at the gather cap (its list
    holds 3 valid entries): on the area path chunk 0 claims its consumers' whole gather."""
    out = {kind: dict(d) for kind, d in lists.items()}
    out["surface"]["count"] = torch.tensor([fp.MAX_GATHERED_FEATURES, 3, 2], dtype=I32)
    return out


def _slot_table(lists, ncx, ncz):
    """The area's lists as a slot table (row b = chunk b, one more empty row) and each chunk's
    [49] source rows in GATHER_OFFSETS order (the empty row beyond the area)."""
    B = ncx * ncz
    table = {kind: {k: torch.cat([v, torch.zeros((1, *v.shape[1:]), dtype=v.dtype)]) for k, v in d.items()}
             for kind, d in lists.items()}
    nslots = torch.full((B, len(fp.GATHER_OFFSETS)), B, dtype=I32)
    for cb in range(B):
        vz, vx = divmod(cb, ncx)
        for r, (dx, dz) in enumerate(fp.GATHER_OFFSETS):
            sx, sz = vx + int(dx), vz + int(dz)
            if 0 <= sx < ncx and 0 <= sz < ncz:
                nslots[cb, r] = sz * ncx + sx
    return table, nslots


def _held_by_a_column(recs, n, origin, cave):
    """[n] bool: the entries of a culled-list layout whose window holds at least one of the
    chunk's 256 columns, tested column by column."""
    half = features.window_half_widths(cave)
    x, z, f = recs[:n, 0].numpy(), recs[:n, 2].numpy(), recs[:n, 4].numpy()
    cols = np.arange(16)
    fx = origin[0] + cols[None, :] - x[:, None]
    fz = origin[1] + cols[None, :] - z[:, None]
    lo, hi = -half[f, 0][:, None], half[f, 1][:, None]
    in_x, in_z = (fx >= lo) & (fx <= hi), (fz >= lo) & (fz <= hi)
    return (in_x[:, :, None] & in_z[:, None, :]).reshape(n, -1).any(axis=1)


def _check_cull(culled, unculled, pos, cave):
    """The culled lists are the unculled ones' entries that some column's window holds, in order."""
    n_kept = n_all = 0
    for b in range(pos.shape[0]):
        n, m = int(culled[1][b]), int(unculled[1][b])
        held = _held_by_a_column(unculled[0][b], m, pos[b].tolist(), cave)
        assert torch.equal(culled[0][b, :n], unculled[0][b, :m][torch.from_numpy(held)]), b
        assert not culled[0][b, n:].any()
        n_kept, n_all = n_kept + n, n_all + m
    return n_kept, n_all


def test_golden_area_cull_keeps_the_column_survivors_and_the_blocks(golden_area):
    blocks, lists, pos = golden_area
    culled, kept = {}, {}
    for kind, cave in (("surface", False), ("cave", True)):
        culled[kind] = features.cull_area_plain(lists[kind], pos, 2, 1, cave)
        unculled = features.cull_area_plain(lists[kind], pos, 2, 1, cave, cull=False)
        assert unculled[1].tolist() == [int(lists[kind]["count"].sum())] * 2  # every source inside
        kept[kind] = _check_cull(culled[kind], unculled, pos, cave)
    # the cull drops entries, yet applying the culled lists gives the area's blocks
    assert kept["surface"][0] < kept["surface"][1] and kept["cave"][0] < kept["cave"][1]
    want = features.apply_features_area_plain(blocks, lists["surface"], lists["cave"], pos, 2, 1)
    assert int((want != blocks).sum()) > 1000, "vacuous"
    got = features.apply_culled_plain(blocks, culled["surface"], culled["cave"], pos)
    assert torch.equal(got, want)


@pytest.mark.parametrize("cull", [True, False], ids=["cull", "no-cull"])
def test_golden_area_slot_cull_equals_the_gather_then_chunk(golden_area, cull):
    blocks, lists, pos = golden_area
    table, nslots = _slot_table(lists, 2, 1)
    culled = {kind: features.cull_slots_plain(table[kind], nslots, pos, kind == "cave", cull)
              for kind in ("surface", "cave")}
    want = features.apply_features_slots_plain(blocks, table["surface"], table["cave"], nslots, pos)
    got = features.apply_culled_plain(blocks, culled["surface"], culled["cave"], pos)
    assert torch.equal(got, want)
    if not cull:  # every valid gathered entry, in the plain gather's order
        rows = {k: v[nslots.long()] for k, v in table["cave"].items()}
        gathered = fp.gather_from_neighborhood_batch(rows, fp.MAX_GATHERED_CAVE_FEATURES)
        for b in range(2):
            n = int(culled["cave"][1][b])
            assert int((gathered["feature"][b] > 0).sum()) == n
            for w, k in ((0, "x"), (1, "y"), (2, "z"), (4, "feature"), (5, "replace"), (6, "height")):
                assert torch.equal(culled["cave"][0][b, :n, w], gathered[k][b, :n]), (b, k)


@pytest.mark.parametrize("overflow", [False, True], ids=["free", "overflow"])
@pytest.mark.parametrize("cull", [True, False], ids=["cull", "no-cull"])
def test_synthetic_lists_area_and_slots(overflow, cull):
    blocks, lists, pos = _strip()
    if overflow:
        lists = _overflowing(lists)
    area = {kind: features.cull_area_plain(lists[kind], pos, 3, 1, kind == "cave", cull)
            for kind in ("surface", "cave")}
    if cull:
        for kind in ("surface", "cave"):
            _check_cull(area[kind], features.cull_area_plain(lists[kind], pos, 3, 1, kind == "cave", False),
                        pos, kind == "cave")
    want = features.apply_features_area_plain(blocks, lists["surface"], lists["cave"], pos, 3, 1)
    assert torch.equal(features.apply_culled_plain(blocks, area["surface"], area["cave"], pos), want)
    # chunk 1's sphere at x = 17 reaches x = 14 of chunk 0 unless chunk 0's count fills its gather
    assert (int(want[0, 8, 14, 200]) == int(Block.GRAVEL)) == (not overflow)
    # chunk 0's gather: its own 3 entries and its neighbours' 5 (cut at the cap with the
    # overflow); the cull drops the neighbours' 3 whose windows miss it
    assert int(area["surface"][1][0]) == {(False, False): 8, (False, True): 5}.get((overflow, cull), 3)

    table, nslots = _slot_table(lists, 3, 1)
    slots = {kind: features.cull_slots_plain(table[kind], nslots, pos, kind == "cave", cull)
             for kind in ("surface", "cave")}
    want = features.apply_features_slots_plain(blocks, table["surface"], table["cave"], nslots, pos)
    assert torch.equal(features.apply_culled_plain(blocks, slots["surface"], slots["cave"], pos), want)
    # the slot path ranks min(count, K) = K entries of chunk 0's list: the neighbours stay visible
    assert int(want[0, 8, 14, 200]) == int(Block.GRAVEL)
