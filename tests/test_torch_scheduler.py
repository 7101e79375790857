"""The port's streaming scheduler vs the JAX package's, and the per-chunk pieces of its
fill stage.

- ``generate_spiral`` equal to JAX's;
- the port's ``TerrainScheduler`` (Python core) and ``NativeTerrainScheduler`` (C++
  core), driven by the script of tests/test_native_scheduler.py with the stage
  dispatchers recorded, equal to JAX's ``TerrainScheduler`` dispatch for dispatch
  (slots, origins, neighbour and zone slot tables, the fix flag), in the state bytes,
  ``newly_filled``, ``vbos_destroyed``, the drawable count and every slot.  No device
  data moves: the port's slot table lives on the ``meta`` device and JAX's is not
  allocated;
- ``gather_heightfields_batch`` and ``gather_from_neighborhood_batch`` equal to JAX on
  seeded inputs, one list interleaving empty entries and the gathers overflowing the
  2,048 / 4,096 caps;
- ``apply_features_chunk_plain`` equal to JAX ``apply_features_chunk`` (eager, exact mode)
  on one chunk with a few surface and cave placements (blocks equal), and
  ``apply_features_slots_plain`` (gather + per-chunk application through a slot table)
  equal to the two steps run by hand;
- a radius-1 drain on the CPU through the real dispatchers and the plain versions, with
  a ``StageTimer``: the centre chunk, the one that reaches its feature lists, holds in the
  slot table what the area path's stages compute for the same 1x1 area (no chunk fills
  below radius 4, and a filled chunk needs a featured 7x7 area to compare with, too slow
  here: the filled chunks are held to the area path on the card, by
  tests/test_torch_cuda.py and chip_smoke.py);
- the port's copy of the config: the JAX package's defaults and ``MMTPU_*`` override.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mega_minecraft_tpu.ops import hashes as jh
from mega_minecraft_tpu.terrain import feature_placement as j_fp
from mega_minecraft_tpu.terrain import features as j_features
from mega_minecraft_tpu.terrain import gather as j_gather
from mega_minecraft_tpu import config as j_config
from mega_minecraft_tpu.terrain import scheduler as j_sched
from mega_minecraft_tpu_torch import config
from mega_minecraft_tpu_torch.native import sched as nsched
from mega_minecraft_tpu_torch.terrain import caves, feature_placement as fp
from mega_minecraft_tpu_torch.terrain import features, gather, heightfield, layers, pipeline
from mega_minecraft_tpu_torch.terrain import scheduler as sched
from mega_minecraft_tpu_torch.utils.profiling import StageTimer
from mega_minecraft_tpu_torch.world import features_data as fd
from mega_minecraft_tpu_torch.world.blocks import Block

SEED = 20261016
#: player positions and ticks at each (tests/test_native_scheduler.py:70)
SCRIPT = [((0.0, 0.0), 120), ((90.0, 40.0), 80), ((300.0, -120.0), 120)]
DISPATCHERS = ("dispatch_heightfield", "dispatch_layers", "dispatch_erosion", "dispatch_caves",
               "dispatch_feature_placements", "dispatch_fill")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs its files in several processes on the same
    cores, where torch's spinning thread pools would starve each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_generate_spiral_equals_jax():
    np.testing.assert_array_equal(sched.generate_spiral(), j_sched.generate_spiral())
    assert sched.ACTION_TIME == j_sched.ACTION_TIME and sched.STAGE_BATCH == j_sched.STAGE_BATCH


class Recorder:
    """Replaces a module's stage dispatchers with recorders of their arguments."""

    def __init__(self, monkeypatch, module):
        self.calls = []
        for name in DISPATCHERS:
            monkeypatch.setattr(module, name, self._make(name))

    def _make(self, name):
        def fn(t, *args, **kwargs):
            rec = [name] + [np.asarray(a).astype(np.int64).tolist() for a in args]
            rec += [(k, kwargs[k]) for k in sorted(kwargs)]
            self.calls.append(tuple(map(str, rec)))

        return fn


def _host_only(self):
    """JAX TerrainState.__post_init__ without its device arrays (never read here)."""
    c = self.capacity
    self.state = np.zeros(c, np.uint8)
    self.chunk_pos = np.zeros((c, 2), np.int32)
    self.in_use = np.zeros(c, bool)
    self.slot_of = {}
    self.free = list(range(c - 1, -1, -1))


def _drive(s):
    for (x, z), n in SCRIPT:
        s.set_player_pos(x, z)
        for _ in range(n):
            s.destroy_far_vbos()
            s.tick(1.0 / 60.0)


@pytest.mark.parametrize("skip_erosion,radius", [(True, 6), (False, 20)])
def test_schedulers_dispatch_as_jax(monkeypatch, skip_erosion, radius):
    monkeypatch.setattr(j_sched.TerrainState, "__post_init__", _host_only)
    rec_j = Recorder(monkeypatch, j_sched)
    ref = j_sched.TerrainScheduler(capacity=4096, radius=radius, skip_erosion=skip_erosion)
    _drive(ref)
    kinds = {c[0] for c in rec_j.calls}
    assert {"dispatch_fill", "dispatch_layers"} <= kinds
    assert ("dispatch_erosion" in kinds) == (not skip_erosion)

    cores = [sched.TerrainScheduler]
    if nsched.available():
        cores.append(sched.NativeTerrainScheduler)
    for cls in cores:
        rec = Recorder(monkeypatch, sched)
        s = cls(capacity=4096, radius=radius, skip_erosion=skip_erosion, device="meta")
        _drive(s)
        assert len(rec.calls) == len(rec_j.calls), cls.__name__
        for i, (a, b) in enumerate(zip(rec.calls, rec_j.calls)):
            assert a == b, (cls.__name__, i)
        state = s.core.snapshot()[0] if cls is sched.NativeTerrainScheduler else s.t.state
        assert state.tobytes() == ref.t.state.tobytes()
        assert s.newly_filled == ref.newly_filled and s.vbos_destroyed == ref.vbos_destroyed
        assert s.drawable_count() == ref.drawable_count()
        assert sorted(s.loaded_chunks()) == sorted(ref.t.slot_of)
        assert all(s.slot_for(p) == ref.t.slot_of[p] for p in ref.t.slot_of)


def test_make_scheduler_picks_the_core():
    assert isinstance(sched.make_scheduler(64, 2, True, native=False, device="meta"),
                      sched.TerrainScheduler)
    s = sched.make_scheduler(64, 2, True, device="meta")
    assert isinstance(s, sched.NativeTerrainScheduler if nsched.available() else sched.TerrainScheduler)
    assert s.t.d_blocks.device.type == "meta" and s.t.d_sstream is None
    assert s.t.d_cave_starts.dtype == torch.int16 and s.t.d_blocks.dtype == torch.uint8


def test_cpu_drain_fills_the_slot_table_as_the_area_stages():
    s = sched.make_scheduler(16, 1, skip_erosion=True, native=False, device="cpu")
    s.timer = StageTimer("cpu")
    s.set_player_pos(0.0, 0.0)
    s.drain()
    rep = s.timer.report()
    for stage in ("heightfield", "layers", "caves", "feature_placements"):
        assert rep[stage]["seconds"] > 0.0, stage
    cells = [(0, 0)]
    assert s.state_at((0, 0)) == int(sched.ChunkState.NEEDS_GATHER_FEATURE_PLACEMENTS)
    assert s.state_at((1, 1)) == int(sched.ChunkState.HAS_HEIGHTFIELD)
    assert s.drawable_count() == 0 and int((s.t.state >= int(sched.ChunkState.FILLED)).sum()) == 0

    pos_h = pipeline.chunk_positions(-1, -1, 3, 3, device="cpu")
    hf, w = heightfield.generate_heightfield(pos_h)
    st = layers.layers_from_halo(hf, w, pos_h, 1, 1)
    cv = caves.generate_caves(st["heightfield"], st["biome_weights"], st["chunk_pos"])
    pl = fp.generate_placements(st["heightfield"], st["biome_weights"], st["layers"], cv["starts"],
                                cv["ends"], cv["bottom_biome"], cv["top_biome"], st["chunk_pos"])
    lists = fp.compact_placements(pl, st["chunk_pos"])
    assert int(lists["surface"]["count"].sum()) + int(lists["cave"]["count"].sum()) > 0
    slots = torch.tensor([s.slot_for(p) for p in cells])
    t = s.t
    pairs = [(t.d_heightfield, st["heightfield"]), (t.d_weights, st["biome_weights"]),
             (t.d_layers, st["layers"]), (t.d_cave_starts, cv["starts"].to(torch.int16)),
             (t.d_cave_ends, cv["ends"].to(torch.int16)),
             (t.d_cave_bottom, cv["bottom_biome"].to(torch.uint8)),
             (t.d_cave_top, cv["top_biome"].to(torch.uint8))]
    pairs += [(t.d_sf[k], lists["surface"][k]) for k in t.d_sf]
    pairs += [(t.d_cf[k], lists["cave"][k]) for k in t.d_cf]
    for got, want in pairs:
        assert torch.equal(got[slots], want)


def test_config_copy_equals_jax(monkeypatch):
    want = j_config.load_config().terrain
    got = config.load_config().terrain
    for f in dataclasses.fields(got):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    monkeypatch.setenv("MMTPU_TERRAIN_STAGE_BATCH", "8")
    assert config.load_config().terrain.stage_batch == j_config.load_config().terrain.stage_batch == 8
    assert config.load_config(**{"terrain.zone_size": 6}).terrain.zone_size == 6


def test_gather_heightfields_batch_equals_jax():
    hf = np.random.default_rng(SEED).uniform(0.0, 300.0, (3, 3, 3, 16, 16)).astype(np.float32)
    want = np.asarray(j_gather.gather_heightfields_batch(jnp.asarray(hf)))
    np.testing.assert_array_equal(gather.gather_heightfields_batch(torch.from_numpy(hf)).numpy(), want)
    np.testing.assert_array_equal(gather.gather_heightfield_3x3(torch.from_numpy(hf[1])).numpy(), want[1])


@pytest.mark.parametrize("kind", ["surface", "cave"])
def test_gather_from_neighborhood_batch_equals_jax(kind):
    rng = np.random.default_rng(SEED + (kind == "cave"))
    K, cap = (256, 2048) if kind == "surface" else (1024, 4096)
    fields = ("feature", "x", "y", "z", "replace") + (("height",) if kind == "cave" else ())
    lists = {k: rng.integers(-500, 500, (2, 49, K)).astype(np.int32) for k in fields}
    # chunk 0: sparse lists with empty entries between valid ones; chunk 1: full lists
    # (each source overflowing its K), so both gathers pass the cap
    valid = rng.random((2, 49, K)) < (cap / (49 * K) * 1.3)
    valid[1] = True
    lists["feature"] = np.where(valid, rng.integers(1, 9, (2, 49, K)), 0).astype(np.int32)
    lists["count"] = np.full((2, 49), K + 7, np.int32)
    want = j_fp.gather_from_neighborhood_batch({k: jnp.asarray(v) for k, v in lists.items()}, cap)
    got = fp.gather_from_neighborhood_batch({k: torch.from_numpy(v) for k, v in lists.items()}, cap)
    assert sorted(got) == sorted(fields)
    assert int(valid[0].sum()) > cap
    for k in fields:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    one = fp.gather_from_neighborhood({k: torch.from_numpy(v[0]) for k, v in lists.items()}, cap)
    assert all(torch.equal(one[k], got[k][0]) for k in fields)


def _chunk_lists():
    """A stone chunk with a cave layer at y 60..90, and gathered lists of four surface and
    three cave placements (some overlapping, one surface sphere inside the cave over a
    cave pillar, some replacing, one outside its bounds)."""
    F, C = fd.Feature, fd.CaveFeature
    blocks = np.zeros((16, 16, 384), np.uint8)
    blocks[..., :146] = int(Block.STONE)
    blocks[..., 60:91] = int(Block.AIR)
    surf = [(F.CACTUS, 21, 146, 36, 0), (F.SPHERE, 24, 150, 38, 1), (F.KELP, 18, 146, 34, 1),
            (F.SPHERE, 22, 70, 37, 1)]
    cave = [(C.TEST_GLOWSTONE_PILLAR, 22, 60, 37, 0, 30), (C.CAVE_VINE, 26, 61, 40, 0, 29),
            (C.STORMLIGHT_SPHERE, 19, 61, 33, 1, 29)]
    lists = {}
    for kind, rows, fields, K in (("surface", surf, ("feature", "x", "y", "z", "replace"), 8),
                                  ("cave", cave, ("feature", "x", "y", "z", "replace", "height"), 8)):
        d = {k: np.zeros(K, np.int32) for k in fields}
        for i, row in enumerate(rows):
            for k, v in zip(fields, row):
                d[k][i] = int(v)
        lists[kind] = d
    return blocks, lists, np.array([16, 32], np.int32)


def test_apply_features_chunk_equals_jax():
    blocks, lists, pos = _chunk_lists()
    with jax.disable_jit(), jh.exact_scope(True):
        want = np.asarray(j_features.apply_features_chunk(
            jnp.asarray(blocks), {k: jnp.asarray(v) for k, v in lists["surface"].items()},
            {k: jnp.asarray(v) for k, v in lists["cave"].items()}, jnp.asarray(pos),
            jnp.zeros((16, 16), jnp.float32)))
    t = {kind: {k: torch.from_numpy(v) for k, v in d.items()} for kind, d in lists.items()}
    got = features.apply_features_chunk_plain(torch.from_numpy(blocks), t["surface"], t["cave"],
                                              torch.from_numpy(pos)).numpy()
    assert (want != blocks).sum() > 300, "vacuous"
    assert (want == int(Block.GLOWSTONE)).sum() > 0 and (want == int(Block.GRAVEL)).sum() > 0
    # the glowstone pillar's column at y 70 lies inside the surface sphere in the cave too:
    # the surface placement wins
    assert want[37 - 32, 22 - 16, 70] == int(Block.GRAVEL)
    np.testing.assert_array_equal(got, want)


def test_apply_features_slots_plain_is_gather_then_chunk():
    blocks, lists, pos = _chunk_lists()
    # a slot table of 60 chunks: the consumer's own lists at slot 7, the other 48 gathered
    # slots empty but for one cave placement at slot 40 (spiral rank 3)
    C = 60
    d_sf = {k: torch.zeros((C, 256), dtype=torch.int32) for k in lists["surface"]}
    d_cf = {k: torch.zeros((C, 1024), dtype=torch.int32) for k in lists["cave"]}
    for kind, d in (("surface", d_sf), ("cave", d_cf)):
        for k, v in lists[kind].items():
            d[k][7, : len(v)] = torch.from_numpy(v)
    for k, v in zip(("feature", "x", "y", "z", "replace", "height"),
                    (int(fd.CaveFeature.CAVE_VINE), 30, 61, 36, 0, 29)):
        d_cf[k][40, 0] = v
    d_sf["count"] = (d_sf["feature"] > 0).sum(-1).to(torch.int32)
    d_cf["count"] = (d_cf["feature"] > 0).sum(-1).to(torch.int32)
    nslots = torch.tensor([7, 8, 9, 40, *range(10, 40), *range(41, 56)], dtype=torch.int32)
    got = features.apply_features_slots(torch.from_numpy(blocks)[None], d_sf, d_cf, None, None,
                                        nslots[None], torch.from_numpy(pos)[None])
    rows = {kind: {k: v[nslots.long()][None] for k, v in d.items()}
            for kind, d in (("surface", d_sf), ("cave", d_cf))}
    surf = fp.gather_from_neighborhood_batch(rows["surface"], fp.MAX_GATHERED_FEATURES)
    cave = fp.gather_from_neighborhood_batch(rows["cave"], fp.MAX_GATHERED_CAVE_FEATURES)
    assert int((cave["feature"][0] > 0).sum()) == 4
    want = features.apply_features_chunk_plain(
        torch.from_numpy(blocks), {k: v[0] for k, v in surf.items()},
        {k: v[0] for k, v in cave.items()}, torch.from_numpy(pos))
    assert torch.equal(got[0], want)
