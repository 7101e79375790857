"""Streaming terrain scheduler: chunk slot table, state machine, action-time budget.

Port of ``mega_minecraft_tpu/terrain/scheduler.py`` (the reference's Terrain class:
spiral scan of the chunk window around the player, per-state work queues drained
latest pipeline stage first under an action-time budget, zone erosion over the 24x24
gathered grid, far-chunk eviction).  Chunks are slots of fixed-capacity arrays on one
device (``TerrainState``): "a chunk" is an index.  The host logic (state machine,
queues, budget) runs in Python (``TerrainScheduler``) or in the native C++ core
(``NativeTerrainScheduler``, ``native/scheduler.cpp``); both plan the same batches.

Each stage dispatch uploads its batch's slots and origins in one host-to-device copy and
launches its kernels against the slot table, with no read-back: on CUDA the stages are
K1 (heightfield), K2s (layers over a 3x3 slot table), K9 (zone erosion over a 24x24 slot
table, in place), K3 (caves), K5 + K6 + K7's stream pre-kernel (placement lists, and
their streams written into the slot table in place), K4 + K7s + K8 (fill, per-chunk
features over a 49-chunk slot table, decorators).  Whole per-chunk rows move between the
slot table and a stage's batch with ``index_select`` / ``index_copy_``.  Batches are as long as the plan makes them (no
padding to ``STAGE_BATCH``).  On the CPU the same dispatches run the plain versions.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

import numpy as np
import torch

from .. import kernels
from ..config import load_config
from . import caves as caves_mod
from . import decorators, erosion, feature_placement as fp, features, fill, heightfield, layers

I32 = np.int32


class ChunkState(enum.IntEnum):
    EMPTY = 0
    HAS_HEIGHTFIELD = 1
    NEEDS_LAYERS = 2
    HAS_LAYERS = 3
    NEEDS_EROSION = 4
    NEEDS_CAVES = 5
    NEEDS_FEATURE_PLACEMENTS = 6
    NEEDS_GATHER_FEATURE_PLACEMENTS = 7
    READY_TO_FILL = 8
    FILLED = 9
    NEEDS_VBOS = 10
    DRAWABLE = 11


# scheduler constants (the reference's terrain.cpp:65-83); the budget knobs come from
# the config tree (MMTPU_TERRAIN_* overrides), with the reference's values as defaults
_TCFG = load_config().terrain
CHUNK_VBOS_GEN_RADIUS = _TCFG.chunk_vbos_gen_radius
ZONE_SIZE = _TCFG.zone_size
CHUNK_MAX_GEN_RADIUS = CHUNK_VBOS_GEN_RADIUS + ZONE_SIZE * 2
MAX_ACTION_TIME_PER_FRAME = _TCFG.max_action_time_per_frame
TOTAL_ACTION_TIME_PER_SECOND = _TCFG.total_action_time_per_second
ACTION_TIME = {
    "heightfield": 3,
    "gather_heightfield": 2,
    "layers": 5,
    "erode_zone": MAX_ACTION_TIME_PER_FRAME,
    "caves": 8,
    "feature_placements": 3,
    "gather_feature_placements": 5,
    "fill": 8,
    "vbos": MAX_ACTION_TIME_PER_FRAME // 3,
}
STAGE_BATCH = _TCFG.stage_batch  # at most this many chunks per stage dispatch


class TerrainState:
    """Fixed-capacity chunk table: the host state mirror and the per-chunk data arrays on
    ``device`` (the JAX dtypes: int16 cave starts / ends, uint8 cave biomes and blocks).

    Beside the JAX arrays it holds each chunk's true placement ``count`` (in ``d_sf`` /
    ``d_cf``), and on CUDA the 64-draw stream of every valid list entry (``d_sstream``
    [capacity, 256, 64], ``d_cstream`` [capacity, 1024, 64] f32; slot < min(count, K) of a
    row, the entries K7s reads), written in place once by the placement stage; the plain path
    draws its streams itself, so on other devices they are None.  A ``meta`` device
    allocates nothing: enough to drive the host logic alone."""

    def __init__(self, capacity: int = 8192, *, device):
        c = self.capacity = capacity
        self.device = dev = torch.device(device)
        self.state = np.zeros(c, np.uint8)
        self.chunk_pos = np.zeros((c, 2), I32)  # chunk coords
        self.in_use = np.zeros(c, bool)
        self.slot_of: dict = {}
        self.free = list(range(c - 1, -1, -1))

        def full(shape, dtype, value=0):
            return torch.full(shape, value, dtype=dtype, device=dev)

        self.d_heightfield = full((c, 16, 16), torch.float32)
        self.d_weights = full((c, 24, 16, 16), torch.float32)
        self.d_layers = full((c, 20, 16, 16), torch.float32)
        self.d_cave_starts = full((c, 16, 16, 32), torch.int16, 384)
        self.d_cave_ends = full((c, 16, 16, 32), torch.int16, 384)
        self.d_cave_bottom = full((c, 16, 16, 32), torch.uint8)
        self.d_cave_top = full((c, 16, 16, 32), torch.uint8)
        self.d_blocks = full((c, 16, 16, 384), torch.uint8)
        # compacted per-chunk feature placement lists (feature 0 = none)
        fc, cc = fp.CHUNK_FEATURE_CAP, fp.CHUNK_CAVE_FEATURE_CAP
        self.d_sf = {k: full((c, fc), torch.int32) for k in kernels.SURFACE_FIELDS}
        self.d_cf = {k: full((c, cc), torch.int32) for k in kernels.CAVE_FIELDS}
        self.d_sf["count"] = full((c,), torch.int32)
        self.d_cf["count"] = full((c,), torch.int32)
        self.d_sstream = self.d_cstream = None
        if dev.type == "cuda":
            self.d_sstream = full((c, fc, kernels.STREAM_LEN), torch.float32)
            self.d_cstream = full((c, cc, kernels.STREAM_LEN), torch.float32)

    def upload(self, *arrays):
        """int32 numpy arrays -> int32 tensors of the same shapes on the device, in one
        copy (through pinned memory on CUDA, so the host does not wait for the device)."""
        flat = [np.ascontiguousarray(a, dtype=I32).reshape(-1) for a in arrays]
        buf = torch.from_numpy(np.concatenate(flat))
        if self.device.type == "cuda":
            buf = buf.pin_memory().to(self.device, non_blocking=True)
        else:
            buf = buf.to(self.device)
        out, i = [], 0
        for a, f in zip(arrays, flat):
            out.append(buf[i : i + f.size].view(np.shape(a)))
            i += f.size
        return out

    def alloc(self, pos) -> int:
        slot = self.free.pop()
        self.slot_of[pos] = slot
        self.state[slot] = int(ChunkState.EMPTY)
        self.chunk_pos[slot] = pos
        self.in_use[slot] = True
        return slot

    def state_at(self, pos) -> int:
        s = self.slot_of.get(pos)
        return -1 if s is None else int(self.state[s])


# ---------------------------------------------------------------------------
# Stage dispatchers, shared by both schedulers: upload the batch's slot tables, run the
# stage against the slot table (kernels on CUDA, plain versions on the CPU)
# ---------------------------------------------------------------------------


def dispatch_heightfield(t, slots_np, pos_np):
    sl, pos = t.upload(slots_np, pos_np)
    sl = sl.long()
    hf, w = heightfield.generate_heightfield(pos)
    t.d_heightfield.index_copy_(0, sl, hf)
    t.d_weights.index_copy_(0, sl, w)


def dispatch_layers(t, slots_np, pos_np, nslots_np, fix_backward: bool):
    sl, pos, nsl = t.upload(slots_np, pos_np, nslots_np)
    layers.layers_slots(t.d_layers, t.d_heightfield, t.d_weights, nsl, sl, pos, fix_backward)


def dispatch_erosion(t, gslots_np):
    (gsl,) = t.upload(gslots_np)
    erosion.erode_zone_slots(t.d_layers, t.d_heightfield, gsl)


def _rows(t, sl):
    """The batch's heightfield, weights and layers rows."""
    return (t.d_heightfield.index_select(0, sl), t.d_weights.index_select(0, sl),
            t.d_layers.index_select(0, sl))


def _cave_rows(t, sl, names):
    return [getattr(t, f"d_cave_{n}").index_select(0, sl).to(torch.int32) for n in names]


def dispatch_caves(t, slots_np, pos_np):
    sl, pos = t.upload(slots_np, pos_np)
    sl = sl.long()
    hf, w, _ = _rows(t, sl)
    cv = caves_mod.generate_caves(hf, w, pos)
    t.d_cave_starts.index_copy_(0, sl, cv["starts"].to(torch.int16))
    t.d_cave_ends.index_copy_(0, sl, cv["ends"].to(torch.int16))
    t.d_cave_bottom.index_copy_(0, sl, cv["bottom_biome"].to(torch.uint8))
    t.d_cave_top.index_copy_(0, sl, cv["top_biome"].to(torch.uint8))


def dispatch_feature_placements(t, slots_np, pos_np):
    sl32, pos = t.upload(slots_np, pos_np)
    sl = sl32.long()
    hf, w, ls = _rows(t, sl)
    cv = _cave_rows(t, sl, ("starts", "ends", "bottom", "top"))
    lists = fp.compact_placements(fp.generate_placements(hf, w, ls, *cv, pos), pos)
    for k, v in t.d_sf.items():
        v.index_copy_(0, sl, lists["surface"][k])
    for k, v in t.d_cf.items():
        v.index_copy_(0, sl, lists["cave"][k])
    if t.d_sstream is not None:  # the valid rows' streams, straight into the batch's slots
        kernels.feature_streams(lists["surface"], lists["cave"], out=(t.d_sstream, t.d_cstream), rows=sl32)


def dispatch_fill(t, slots_np, pos_np, nbslots_np):
    sl, pos, nsl = t.upload(slots_np, pos_np, nbslots_np)
    sl = sl.long()
    hf, w, ls = _rows(t, sl)
    cs, ce, cb = _cave_rows(t, sl, ("starts", "ends", "bottom"))
    blocks = fill.fill_chunks(hf, w, ls, cs, ce, pos)
    blocks = features.apply_features_slots(blocks, t.d_sf, t.d_cf, t.d_sstream, t.d_cstream, nsl,
                                           pos)
    blocks = decorators.place_decorators_batch(blocks, hf, w, cs, ce, cb, pos)
    t.d_blocks.index_copy_(0, sl, blocks)


def generate_spiral() -> np.ndarray:
    """Spiral scan offsets (terrain.cpp:220-252)."""
    out = []
    x = z = 0
    d = 1
    m = 1
    while True:
        while 2 * x * d < m:
            out.append((x, z))
            x += d
        if m > CHUNK_MAX_GEN_RADIUS * 2:
            return np.array(out, I32)
        while 2 * z * d < m:
            out.append((x, z))
            z += d
        d = -d
        m += 1


@dataclass
class Zone:
    pos: tuple  # world chunk coords of zone corner (multiples of ZONE_SIZE)
    queued_for_erosion: bool = False
    try_erosion: bool = False


def _zone_pos(cx: int, cz: int):
    return ((cx // ZONE_SIZE) * ZONE_SIZE, (cz // ZONE_SIZE) * ZONE_SIZE)


class _Timed:
    timer = None  # optional utils.profiling.StageTimer

    def _timed(self, name, fn):
        if self.timer is None:
            return fn()
        with self.timer.stage(name):
            return fn()


class TerrainScheduler(_Timed):
    """Action-time budgeted streaming generator over the chunk slot table (host logic
    in Python)."""

    def __init__(self, capacity: int = 8192, radius: int | None = None,
                 skip_erosion: bool = False, *, device):
        """skip_erosion: bypass the zone-erosion stage (the reference's
        DEBUG_SKIP_EROSION), required when the generation radius is clipped below a
        full 24x24 zone grid.  device: where the slot table lives."""
        self.skip_erosion = skip_erosion
        self.t = TerrainState(capacity, device=device)
        self.spiral = generate_spiral()
        if radius is not None:
            keep = np.abs(self.spiral).max(axis=1) <= radius
            self.spiral = self.spiral[keep]
        self.zones: dict = {}
        self.queues = {k: [] for k in ACTION_TIME}
        self.action_time_left = 0.0
        self.current_chunk = (0, 0)
        self.last_chunk = None
        self.needs_update = True
        self.newly_filled: list = []
        self.vbos_destroyed: list = []  # consumed by the engine (destroyChunk analogue)
        self._queued = set()  # (stage, pos) pairs to avoid duplicate queueing

    # -- chunk window update (updateChunks / updateChunk) ------------------------------

    def set_player_pos(self, x: float, z: float):
        self.current_chunk = (int(np.floor(x / 16.0)), int(np.floor(z / 16.0)))

    def _neighbors_state_ok(self, cx, cz, r, min_state) -> bool:
        for dz in range(-r, r + 1):
            for dx in range(-r, r + 1):
                if self.t.state_at((cx + dx, cz + dz)) < min_state:
                    return False
        return True

    def _route_chunk(self, pos):
        st = self.t.state_at(pos)
        if st < 0:
            return
        key = None
        s = ChunkState(st)
        if s == ChunkState.EMPTY:
            key = "heightfield"
        elif s == ChunkState.HAS_HEIGHTFIELD:
            if self._neighbors_state_ok(*pos, 1, int(ChunkState.HAS_HEIGHTFIELD)):
                key = "gather_heightfield"
        elif s == ChunkState.NEEDS_LAYERS:
            key = "layers"
        elif s == ChunkState.NEEDS_CAVES:
            key = "caves"
        elif s == ChunkState.NEEDS_FEATURE_PLACEMENTS:
            key = "feature_placements"
        elif s == ChunkState.NEEDS_GATHER_FEATURE_PLACEMENTS:
            if self._neighbors_state_ok(*pos, 3, int(ChunkState.NEEDS_GATHER_FEATURE_PLACEMENTS)):
                key = "gather_feature_placements"
        elif s == ChunkState.READY_TO_FILL:
            key = "fill"
        elif s == ChunkState.NEEDS_VBOS:
            dist = max(abs(pos[0] - self.current_chunk[0]), abs(pos[1] - self.current_chunk[1]))
            if dist <= CHUNK_VBOS_GEN_RADIUS:
                key = "vbos"
        if key is not None and (key, pos) not in self._queued:
            self.queues[key].append(pos)
            self._queued.add((key, pos))

    def update_chunks(self):
        ccx, ccz = self.current_chunk
        for dx, dz in self.spiral:
            pos = (int(ccx + dx), int(ccz + dz))
            if pos not in self.t.slot_of:
                self.t.alloc(pos)
                zp = _zone_pos(*pos)
                if zp not in self.zones:
                    self.zones[zp] = Zone(pos=zp)
            self._route_chunk(pos)

    # -- zone erosion readiness (updateZones / isZoneReadyForErosion) -------------------

    def _zone_ready_for_erosion(self, zone: Zone) -> bool:
        zx, zz = zone.pos
        # the full 24x24 gathered grid (12x12 core + 6-chunk ring) must be >= HAS_LAYERS
        for dz in range(-ZONE_SIZE // 2, ZONE_SIZE + ZONE_SIZE // 2):
            for dx in range(-ZONE_SIZE // 2, ZONE_SIZE + ZONE_SIZE // 2):
                if self.t.state_at((zx + dx, zz + dz)) < int(ChunkState.HAS_LAYERS):
                    return False
        return True

    def update_zones(self):
        for zone in self.zones.values():
            if zone.try_erosion and not zone.queued_for_erosion:
                zone.try_erosion = False
                if self._zone_ready_for_erosion(zone):
                    zone.queued_for_erosion = True
                    self.queues["erode_zone"].append(zone.pos)

    # -- stage executors -------------------------------------------------------------------

    def _pop_batch(self, key, cost) -> list:
        batch = []
        q = self.queues[key]
        while q and self.action_time_left >= cost and len(batch) < STAGE_BATCH:
            pos = q.pop(0)
            self._queued.discard((key, pos))
            batch.append(pos)
            self.action_time_left -= cost
            self.needs_update = True
        return batch

    def _slots(self, batch):
        return np.array([self.t.slot_of[p] for p in batch], I32)

    def _set_state(self, batch, state):
        for p in batch:
            self.t.state[self.t.slot_of[p]] = int(state)

    def _exec_heightfield(self):
        batch = self._pop_batch("heightfield", ACTION_TIME["heightfield"])
        if batch:
            dispatch_heightfield(self.t, self._slots(batch), np.array(batch, I32) * 16)
            self._set_state(batch, ChunkState.HAS_HEIGHTFIELD)

    def _exec_gather_heightfield(self):
        batch = self._pop_batch("gather_heightfield", ACTION_TIME["gather_heightfield"])
        self._set_state(batch, ChunkState.NEEDS_LAYERS)

    def _exec_layers(self):
        batch = self._pop_batch("layers", ACTION_TIME["layers"])
        if not batch:
            return
        # 3x3 neighbour slots of the 18x18 halo'd heightfield
        nslots = np.zeros((len(batch), 3, 3), I32)
        for i, (cx, cz) in enumerate(batch):
            for dz in (-1, 0, 1):
                for dx in (-1, 0, 1):
                    nslots[i, dz + 1, dx + 1] = self.t.slot_of[(cx + dx, cz + dz)]
        dispatch_layers(self.t, self._slots(batch), np.array(batch, I32) * 16, nslots,
                        fix_backward=self.skip_erosion)
        if self.skip_erosion:
            self._set_state(batch, ChunkState.NEEDS_CAVES)
            return
        for p in batch:
            self.t.state[self.t.slot_of[p]] = int(ChunkState.HAS_LAYERS)
            zp = _zone_pos(*p)
            # this chunk's zone and the 3 zones toward its quadrant may now be erodible
            # (addZonesToTryErosionSet, terrain.cpp:430-457)
            self.zones[zp].try_erosion = True
            lx, lz = p[0] - zp[0], p[1] - zp[1]
            qx = -1 if lx < ZONE_SIZE // 2 else 1
            qz = -1 if lz < ZONE_SIZE // 2 else 1
            for dzp in ((qx, 0), (0, qz), (qx, qz)):
                np_pos = (zp[0] + dzp[0] * ZONE_SIZE, zp[1] + dzp[1] * ZONE_SIZE)
                if np_pos in self.zones and not self.zones[np_pos].queued_for_erosion:
                    self.zones[np_pos].try_erosion = True

    def _exec_erosion(self):
        q = self.queues["erode_zone"]
        cost = ACTION_TIME["erode_zone"]
        if not q or self.action_time_left < cost:
            return
        zx, zz = q.pop(0)
        self.action_time_left -= cost
        self.needs_update = True
        half = ZONE_SIZE // 2
        gslots = np.zeros((2 * ZONE_SIZE, 2 * ZONE_SIZE), I32)
        for iz in range(2 * ZONE_SIZE):
            for ix in range(2 * ZONE_SIZE):
                gslots[iz, ix] = self.t.slot_of[(zx + ix - half, zz + iz - half)]
        # one dispatch: gather 24x24 -> erode -> write back the core + backward fix
        dispatch_erosion(self.t, gslots)
        self._set_state([(zx + ix, zz + iz) for iz in range(ZONE_SIZE) for ix in range(ZONE_SIZE)],
                        ChunkState.NEEDS_CAVES)

    def _exec_caves(self):
        batch = self._pop_batch("caves", ACTION_TIME["caves"])
        if batch:
            dispatch_caves(self.t, self._slots(batch), np.array(batch, I32) * 16)
            self._set_state(batch, ChunkState.NEEDS_FEATURE_PLACEMENTS)

    def _exec_feature_placements(self):
        batch = self._pop_batch("feature_placements", ACTION_TIME["feature_placements"])
        if batch:
            dispatch_feature_placements(self.t, self._slots(batch), np.array(batch, I32) * 16)
            self._set_state(batch, ChunkState.NEEDS_GATHER_FEATURE_PLACEMENTS)

    def _exec_gather_features(self):
        batch = self._pop_batch("gather_feature_placements",
                                ACTION_TIME["gather_feature_placements"])
        self._set_state(batch, ChunkState.READY_TO_FILL)

    def _exec_fill(self):
        batch = self._pop_batch("fill", ACTION_TIME["fill"])
        if not batch:
            return
        # 49-chunk neighbourhood slot table of the feature gather (chunk.cu:1158-1196)
        nb_slots = np.empty((len(batch), len(fp.GATHER_OFFSETS)), I32)
        for bi, p in enumerate(batch):
            for oi, o in enumerate(fp.GATHER_OFFSETS):
                nb_slots[bi, oi] = self.t.slot_of[(p[0] + int(o[0]), p[1] + int(o[1]))]
        # one dispatch: fill + feature gather / apply + decorators
        dispatch_fill(self.t, self._slots(batch), np.array(batch, I32) * 16, nb_slots)
        self._set_state(batch, ChunkState.FILLED)
        # FILLED chunks whose 4-neighbourhood is FILLED become NEEDS_VBOS
        for p in batch:
            for q in [p, (p[0] + 1, p[1]), (p[0] - 1, p[1]), (p[0], p[1] + 1), (p[0], p[1] - 1)]:
                self._check_needs_vbos(q)

    def _check_needs_vbos(self, pos):
        if self.t.state_at(pos) != int(ChunkState.FILLED):
            return
        for d in ((1, 0), (-1, 0), (0, 1), (0, -1)):
            if self.t.state_at((pos[0] + d[0], pos[1] + d[1])) < int(ChunkState.FILLED):
                return
        self.t.state[self.t.slot_of[pos]] = int(ChunkState.NEEDS_VBOS)

    def _exec_vbos(self):
        batch = self._pop_batch("vbos", ACTION_TIME["vbos"])
        self._set_state(batch, ChunkState.DRAWABLE)
        self.newly_filled.extend(batch)

    def destroy_far_vbos(self):
        """DRAWABLE chunks beyond the VBO radius (+2 hysteresis) drop back to FILLED and
        are reported in ``vbos_destroyed`` (Terrain::destroyFarChunkVbos,
        terrain.cpp:1009-1019)."""
        ccx, ccz = self.current_chunk
        limit = CHUNK_VBOS_GEN_RADIUS + 2
        for slot in np.where(self.t.state == int(ChunkState.DRAWABLE))[0]:
            cx, cz = int(self.t.chunk_pos[slot][0]), int(self.t.chunk_pos[slot][1])
            if max(abs(cx - ccx), abs(cz - ccz)) > limit:
                self.t.state[slot] = int(ChunkState.FILLED)
                self.vbos_destroyed.append((cx, cz))
                self.needs_update = True

    # -- frame tick (Terrain::tick, terrain.cpp:587-960): queues drain in reverse
    # pipeline order so nearly-done chunks finish first ------------------------------------

    def tick(self, dt: float):
        if self.current_chunk != self.last_chunk:
            self.last_chunk = self.current_chunk
            self.needs_update = True
        if self.needs_update:
            self.update_zones()
            self.update_chunks()
            self.needs_update = False
        self.action_time_left = min(self.action_time_left + TOTAL_ACTION_TIME_PER_SECOND * dt,
                                    MAX_ACTION_TIME_PER_FRAME)
        self._timed("vbos", self._exec_vbos)
        self._timed("fill", self._exec_fill)
        self._timed("gather_features", self._exec_gather_features)
        self._timed("feature_placements", self._exec_feature_placements)
        self._timed("caves", self._exec_caves)
        self._timed("erosion", self._exec_erosion)
        self._timed("layers", self._exec_layers)
        self._timed("gather_heightfield", self._exec_gather_heightfield)
        self._timed("heightfield", self._exec_heightfield)

    def drain(self, max_frames: int = 100000, dt: float = 1.0 / 60.0) -> int:
        """Tick until all queues are empty and no state changes remain (the
        reference's DEBUG_TIME_CHUNK_FILL drain).  Returns the frames ticked."""
        frames = idle = 0
        while idle < 3 and frames < max_frames:
            before = bytes(self.t.state)
            self.tick(dt)
            frames += 1
            if not any(self.queues.values()) and bytes(self.t.state) == before:
                idle += 1
                self.needs_update = True
            else:
                idle = 0
        return frames

    def drawable_count(self) -> int:
        return int((self.t.state == int(ChunkState.DRAWABLE)).sum())

    def slot_for(self, pos) -> int:
        return self.t.slot_of.get(tuple(pos), -1)

    def state_at(self, pos) -> int:
        return self.t.state_at(tuple(pos))

    def loaded_chunks(self) -> list:
        return list(self.t.slot_of)

    def zone_info(self, zone_pos) -> dict:
        """Erosion readiness of the zone at ``zone_pos`` (its corner, chunk coords)."""
        z = self.zones.get(tuple(zone_pos))
        return {"ready": self._zone_ready_for_erosion(z) if z else False,
                "queued": z.queued_for_erosion if z else False}


class NativeTerrainScheduler(_Timed):
    """``TerrainScheduler`` whose host logic runs in the native C++ core
    (``native/scheduler.cpp``); each ``tick`` executes the core's flat batch plan
    against the slot table through the shared dispatchers."""

    def __init__(self, capacity: int = 8192, radius: int | None = None,
                 skip_erosion: bool = False, *, device):
        from ..native import sched as nsched

        self._ns = nsched
        self.skip_erosion = skip_erosion
        self.t = TerrainState(capacity, device=device)  # device arrays; host mirrors unused
        self.core = nsched.NativeSchedulerCore(capacity, radius, skip_erosion)
        self.newly_filled: list = []
        self.vbos_destroyed: list = []

    def set_player_pos(self, x: float, z: float):
        self.core.set_player_chunk(int(np.floor(x / 16.0)), int(np.floor(z / 16.0)))

    def destroy_far_vbos(self):
        self.vbos_destroyed.extend(self.core.destroy_far_vbos())

    def slot_for(self, pos) -> int:
        return self.core.slot_of(int(pos[0]), int(pos[1]))

    def state_at(self, pos) -> int:
        return self.core.state_at(int(pos[0]), int(pos[1]))

    def zone_info(self, zone_pos) -> dict:
        """Erosion readiness of the zone at ``zone_pos``: its 24x24 gathered grid all at
        HAS_LAYERS or later (the core keeps the queued flag to itself: None)."""
        zx, zz = int(zone_pos[0]), int(zone_pos[1])
        half = ZONE_SIZE // 2
        ready = all(self.core.state_at(zx + dx, zz + dz) >= int(ChunkState.HAS_LAYERS)
                    for dz in range(-half, ZONE_SIZE + half) for dx in range(-half, ZONE_SIZE + half))
        return {"ready": ready, "queued": None}

    def loaded_chunks(self) -> list:
        _, cx, cz, iu = self.core.snapshot()
        return [(int(cx[i]), int(cz[i])) for i in np.where(iu != 0)[0]]

    def drawable_count(self) -> int:
        return self.core.drawable_count()

    def tick(self, dt: float):
        plan = self.core.tick(dt)
        ns, t = self._ns, self.t
        i = 0
        while i < len(plan) and plan[i] != -1:
            st, n = int(plan[i]), int(plan[i + 1])
            i += 2
            if st in (ns.ST_GATHER_FEATURES, ns.ST_GATHER_HEIGHTFIELD):
                i += n  # state-only transitions, already applied in the core
                continue
            if st == ns.ST_EROSION:
                gslots = plan[i : i + 576].reshape(24, 24).copy()
                i += 576
                self._timed("erosion", lambda g=gslots: dispatch_erosion(t, g))
                continue
            w = {ns.ST_FILL: 3 + 49, ns.ST_LAYERS: 3 + 9}.get(st, 3)
            if st not in (ns.ST_VBOS, ns.ST_FILL, ns.ST_FEATURE_PLACEMENTS, ns.ST_CAVES,
                          ns.ST_LAYERS, ns.ST_HEIGHTFIELD):
                raise RuntimeError(f"unknown plan stage {st}")
            rec = plan[i : i + w * n].reshape(n, w)
            i += w * n
            slots, pos = rec[:, 0].copy(), rec[:, 1:3] * 16
            if st == ns.ST_VBOS:
                self.newly_filled.extend((int(r[1]), int(r[2])) for r in rec)
            elif st == ns.ST_FILL:
                self._timed("fill", lambda: dispatch_fill(t, slots, pos, rec[:, 3:].copy()))
            elif st == ns.ST_FEATURE_PLACEMENTS:
                self._timed("feature_placements",
                            lambda: dispatch_feature_placements(t, slots, pos))
            elif st == ns.ST_CAVES:
                self._timed("caves", lambda: dispatch_caves(t, slots, pos))
            elif st == ns.ST_LAYERS:
                self._timed("layers", lambda: dispatch_layers(
                    t, slots, pos, rec[:, 3:].reshape(n, 3, 3).copy(),
                    fix_backward=self.skip_erosion))
            else:
                self._timed("heightfield", lambda: dispatch_heightfield(t, slots, pos))

    def drain(self, max_frames: int = 100000, dt: float = 1.0 / 60.0) -> int:
        """Tick until all queues are empty and no state changes remain (as
        ``TerrainScheduler.drain``)."""
        frames = idle = 0
        while idle < 3 and frames < max_frames:
            before = self.core.snapshot()[0].tobytes()
            self.tick(dt)
            frames += 1
            if not self.core.queues_busy() and self.core.snapshot()[0].tobytes() == before:
                idle += 1
                self.core.force_update()
            else:
                idle = 0
        return frames


def make_scheduler(capacity: int = 8192, radius: int | None = None, skip_erosion: bool = False,
                   native: bool | None = None, *, device):
    """The native-core scheduler when ``native`` is true, or when it is None and the core
    builds here (g++); else the pure-Python one.  ``device``: where the slot table lives
    and the stages run."""
    if native is None:
        from ..native import sched as nsched

        native = nsched.available()
    cls = NativeTerrainScheduler if native else TerrainScheduler
    return cls(capacity, radius, skip_erosion, device=device)
