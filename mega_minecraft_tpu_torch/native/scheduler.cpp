// Native streaming-scheduler core: chunk table, state machine, work queues,
// action-time budget, zone-erosion readiness, VBO eviction.
//
// The port's copy of mega_minecraft_tpu/native/scheduler.cpp, unchanged below this
// comment.  C++ equivalent of the reference's Terrain class host logic (its
// terrain.cpp: spiral scan terrain.cpp:220-252, action-time budget + per-stage costs
// terrain.cpp:65-83, queue drains in reverse pipeline order terrain.cpp:587-960, zone
// readiness terrain.cpp:456-567, far-VBO eviction terrain.cpp:1009-1019; chunk state
// machine chunk.hpp:18-32).  The Python side owns only the device-stage dispatches;
// each frame this core plans the batches (with every neighbor-slot table
// pre-resolved) into a flat int32 buffer.
//
// Semantics mirror terrain/scheduler.py's TerrainScheduler (the pure-Python core);
// tests/test_torch_scheduler.py holds both, dispatch for dispatch, to the JAX
// package's TerrainScheduler.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

enum ChunkState : int {
  EMPTY = 0,
  HAS_HEIGHTFIELD = 1,
  NEEDS_LAYERS = 2,
  HAS_LAYERS = 3,
  NEEDS_EROSION = 4,
  NEEDS_CAVES = 5,
  NEEDS_FEATURE_PLACEMENTS = 6,
  NEEDS_GATHER_FEATURE_PLACEMENTS = 7,
  READY_TO_FILL = 8,
  FILLED = 9,
  NEEDS_VBOS = 10,
  DRAWABLE = 11,
};

// stage ids in the plan stream (drain order is reverse pipeline order)
enum Stage : int {
  ST_HEIGHTFIELD = 0,
  ST_GATHER_HEIGHTFIELD = 1,
  ST_LAYERS = 2,
  ST_EROSION = 3,
  ST_CAVES = 4,
  ST_FEATURE_PLACEMENTS = 5,
  ST_GATHER_FEATURES = 6,
  ST_FILL = 7,
  ST_VBOS = 8,
  NUM_STAGES = 9,
};

// scheduler constants (terrain.cpp:65-83)
constexpr int CHUNK_VBOS_GEN_RADIUS = 16;
constexpr int ZONE_SIZE = 12;
constexpr int CHUNK_MAX_GEN_RADIUS = CHUNK_VBOS_GEN_RADIUS + ZONE_SIZE * 2;
constexpr int MAX_ACTION_TIME_PER_FRAME = 500;
constexpr int TOTAL_ACTION_TIME_PER_SECOND = 60 * MAX_ACTION_TIME_PER_FRAME;
constexpr int STAGE_BATCH = 16;

constexpr int ACTION_TIME[NUM_STAGES] = {
    /*heightfield*/ 3,
    /*gather_heightfield*/ 2,
    /*layers*/ 5,
    /*erode_zone*/ MAX_ACTION_TIME_PER_FRAME,
    /*caves*/ 8,
    /*feature_placements*/ 3,
    /*gather_feature_placements*/ 5,
    /*fill*/ 8,
    /*vbos*/ MAX_ACTION_TIME_PER_FRAME / 3,
};

// 49-chunk gather offsets (dx, dz), reference order (chunk.cu:1158-1167)
constexpr int GATHER_OFFSETS[49][2] = {
    {0, 0},   {0, 1},   {1, 1},   {1, 0},   {1, -1},  {0, -1},  {-1, -1},
    {-1, 0},  {-1, 1},  {2, 0},   {2, 1},   {2, 2},   {1, 2},   {0, 2},
    {-1, 2},  {-2, 2},  {-2, 1},  {-2, 0},  {-2, -1}, {-2, -2}, {-1, -2},
    {0, -2},  {1, -2},  {2, -2},  {2, -1},  {-3, -3}, {-2, -3}, {-1, -3},
    {0, -3},  {1, -3},  {2, -3},  {3, -3},  {3, -2},  {3, -1},  {3, 0},
    {3, 1},   {3, 2},   {3, 3},   {2, 3},   {1, 3},   {0, 3},   {-1, 3},
    {-2, 3},  {-3, 3},  {-3, 2},  {-3, 1},  {-3, 0},  {-3, -1}, {-3, -2},
};

inline int64_t key_of(int cx, int cz) {
  return (static_cast<int64_t>(cx) << 32) ^ static_cast<uint32_t>(cz);
}

inline int floordiv(int a, int b) {
  int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

struct Zone {
  bool queued_for_erosion = false;
  bool try_erosion = false;
};

struct Scheduler {
  int capacity;
  int radius;  // -1 = full spiral
  bool skip_erosion;

  std::vector<uint8_t> state;
  std::vector<int> chunk_cx, chunk_cz;
  std::vector<uint8_t> in_use;
  std::unordered_map<int64_t, int> slot_of;
  std::vector<int> free_slots;  // pop from back

  std::vector<std::pair<int, int>> spiral;  // (dx, dz)
  std::unordered_map<int64_t, Zone> zones;  // key of zone corner chunk coords
  std::vector<int64_t> zone_order;          // insertion order (parity with the
                                            // Python dict's iteration order)

  std::deque<std::pair<int, int>> queues[NUM_STAGES];
  std::unordered_set<int64_t> queued[NUM_STAGES];  // dedup per stage

  double action_time_left = 0.0;
  int cur_cx = 0, cur_cz = 0;
  bool has_last = false;
  int last_cx = 0, last_cz = 0;
  bool needs_update = true;

  // outputs consumed by the embedder
  std::vector<std::pair<int, int>> newly_filled;    // DRAWABLE this frame
  std::vector<std::pair<int, int>> vbos_destroyed;  // evicted this frame

  explicit Scheduler(int cap, int rad, bool skip)
      : capacity(cap), radius(rad), skip_erosion(skip) {
    state.assign(cap, 0);
    chunk_cx.assign(cap, 0);
    chunk_cz.assign(cap, 0);
    in_use.assign(cap, 0);
    free_slots.reserve(cap);
    for (int i = 0; i < cap; ++i) free_slots.push_back(cap - 1 - i);
    build_spiral();
  }

  // spiral scan offsets (terrain.cpp:220-252; mirrors generate_spiral())
  void build_spiral() {
    int x = 0, z = 0, d = 1, m = 1;
    for (;;) {
      while (2 * x * d < m) {
        push_spiral(x, z);
        x += d;
      }
      if (m > CHUNK_MAX_GEN_RADIUS * 2) return;
      while (2 * z * d < m) {
        push_spiral(x, z);
        z += d;
      }
      d = -d;
      m += 1;
    }
  }
  void push_spiral(int x, int z) {
    if (radius >= 0 && (std::abs(x) > radius || std::abs(z) > radius)) return;
    spiral.emplace_back(x, z);
  }

  int slot(int cx, int cz) const {
    auto it = slot_of.find(key_of(cx, cz));
    return it == slot_of.end() ? -1 : it->second;
  }
  int state_at(int cx, int cz) const {
    int s = slot(cx, cz);
    return s < 0 ? -1 : static_cast<int>(state[s]);
  }

  int alloc(int cx, int cz) {
    int s = free_slots.back();
    free_slots.pop_back();
    slot_of[key_of(cx, cz)] = s;
    state[s] = EMPTY;
    chunk_cx[s] = cx;
    chunk_cz[s] = cz;
    in_use[s] = 1;
    return s;
  }

  bool neighbors_state_ok(int cx, int cz, int r, int min_state) const {
    for (int dz = -r; dz <= r; ++dz)
      for (int dx = -r; dx <= r; ++dx)
        if (state_at(cx + dx, cz + dz) < min_state) return false;
    return true;
  }

  void enqueue(int st, int cx, int cz) {
    int64_t k = key_of(cx, cz);
    if (queued[st].count(k)) return;
    queues[st].emplace_back(cx, cz);
    queued[st].insert(k);
  }

  // route a chunk's current state to the matching work queue (updateChunk,
  // terrain.cpp:301-428)
  void route_chunk(int cx, int cz) {
    int st = state_at(cx, cz);
    if (st < 0) return;
    switch (st) {
      case EMPTY:
        enqueue(ST_HEIGHTFIELD, cx, cz);
        break;
      case HAS_HEIGHTFIELD:
        if (neighbors_state_ok(cx, cz, 1, HAS_HEIGHTFIELD))
          enqueue(ST_GATHER_HEIGHTFIELD, cx, cz);
        break;
      case NEEDS_LAYERS:
        enqueue(ST_LAYERS, cx, cz);
        break;
      case NEEDS_CAVES:
        enqueue(ST_CAVES, cx, cz);
        break;
      case NEEDS_FEATURE_PLACEMENTS:
        enqueue(ST_FEATURE_PLACEMENTS, cx, cz);
        break;
      case NEEDS_GATHER_FEATURE_PLACEMENTS:
        if (neighbors_state_ok(cx, cz, 3, NEEDS_GATHER_FEATURE_PLACEMENTS))
          enqueue(ST_GATHER_FEATURES, cx, cz);
        break;
      case READY_TO_FILL:
        enqueue(ST_FILL, cx, cz);
        break;
      case NEEDS_VBOS: {
        int dist = std::max(std::abs(cx - cur_cx), std::abs(cz - cur_cz));
        if (dist <= CHUNK_VBOS_GEN_RADIUS) enqueue(ST_VBOS, cx, cz);
        break;
      }
      default:
        break;
    }
  }

  void update_chunks() {
    for (auto& [dx, dz] : spiral) {
      int cx = cur_cx + dx, cz = cur_cz + dz;
      int64_t k = key_of(cx, cz);
      if (!slot_of.count(k)) {
        alloc(cx, cz);
        int64_t zk = zone_key(cx, cz);
        if (zones.emplace(zk, Zone{}).second) zone_order.push_back(zk);
      }
      route_chunk(cx, cz);
    }
  }

  static int64_t zone_key(int cx, int cz) {
    return key_of(floordiv(cx, ZONE_SIZE) * ZONE_SIZE,
                  floordiv(cz, ZONE_SIZE) * ZONE_SIZE);
  }
  static void zone_corner(int cx, int cz, int* zx, int* zz) {
    *zx = floordiv(cx, ZONE_SIZE) * ZONE_SIZE;
    *zz = floordiv(cz, ZONE_SIZE) * ZONE_SIZE;
  }

  // the full 24x24 gathered grid (12x12 core + 6-chunk halo) must be >= HAS_LAYERS
  // (isZoneReadyForErosion, terrain.cpp:456-522)
  bool zone_ready(int zx, int zz) const {
    for (int dz = -ZONE_SIZE / 2; dz < ZONE_SIZE + ZONE_SIZE / 2; ++dz)
      for (int dx = -ZONE_SIZE / 2; dx < ZONE_SIZE + ZONE_SIZE / 2; ++dx)
        if (state_at(zx + dx, zz + dz) < HAS_LAYERS) return false;
    return true;
  }

  void update_zones() {
    for (int64_t k : zone_order) {
      Zone& zone = zones[k];
      if (zone.try_erosion && !zone.queued_for_erosion) {
        zone.try_erosion = false;
        int zx = static_cast<int>(k >> 32);
        int zz = static_cast<int>(static_cast<uint32_t>(k & 0xffffffffu));
        if (zone_ready(zx, zz)) {
          zone.queued_for_erosion = true;
          queues[ST_EROSION].emplace_back(zx, zz);
        }
      }
    }
  }

  // pop up to STAGE_BATCH entries within budget (terrain.cpp:621 drain pattern)
  std::vector<std::pair<int, int>> pop_batch(int st) {
    std::vector<std::pair<int, int>> batch;
    int cost = ACTION_TIME[st];
    auto& q = queues[st];
    while (!q.empty() && action_time_left >= cost &&
           static_cast<int>(batch.size()) < STAGE_BATCH) {
      auto pos = q.front();
      q.pop_front();
      queued[st].erase(key_of(pos.first, pos.second));
      batch.push_back(pos);
      action_time_left -= cost;
      needs_update = true;
    }
    return batch;
  }

  // after-layers zone bookkeeping (addZonesToTryErosionSet, terrain.cpp:430-457)
  void mark_zones_after_layers(int cx, int cz) {
    int zx, zz;
    zone_corner(cx, cz, &zx, &zz);
    zones[key_of(zx, zz)].try_erosion = true;
    int lx = cx - zx, lz = cz - zz;
    int qx = lx < ZONE_SIZE / 2 ? -1 : 1;
    int qz = lz < ZONE_SIZE / 2 ? -1 : 1;
    const int offs[3][2] = {{qx, 0}, {0, qz}, {qx, qz}};
    for (auto& o : offs) {
      int64_t k = key_of(zx + o[0] * ZONE_SIZE, zz + o[1] * ZONE_SIZE);
      auto it = zones.find(k);
      if (it != zones.end() && !it->second.queued_for_erosion)
        it->second.try_erosion = true;
    }
  }

  void check_needs_vbos(int cx, int cz) {
    if (state_at(cx, cz) != FILLED) return;
    const int d4[4][2] = {{1, 0}, {-1, 0}, {0, 1}, {0, -1}};
    for (auto& d : d4)
      if (state_at(cx + d[0], cz + d[1]) < FILLED) return;
    state[slot(cx, cz)] = NEEDS_VBOS;
  }

  // --------------------------------------------------------------------
  // plan writer
  // --------------------------------------------------------------------
  struct PlanWriter {
    int32_t* buf;
    int64_t cap, n = 0;
    bool overflow = false;
    void put(int32_t v) {
      if (n < cap)
        buf[n++] = v;
      else
        overflow = true;
    }
  };

  // One frame (Terrain::tick, terrain.cpp:587-960): refresh window/zones, refill
  // the budget, drain queues in reverse pipeline order, writing one record per
  // non-empty batch into `plan`.
  int64_t tick(double dt, int32_t* plan, int64_t plan_cap) {
    newly_filled.clear();
    if (!has_last || cur_cx != last_cx || cur_cz != last_cz) {
      has_last = true;
      last_cx = cur_cx;
      last_cz = cur_cz;
      needs_update = true;
    }
    if (needs_update) {
      update_zones();
      update_chunks();
      needs_update = false;
    }
    action_time_left = std::min(
        action_time_left + TOTAL_ACTION_TIME_PER_SECOND * dt,
        static_cast<double>(MAX_ACTION_TIME_PER_FRAME));

    PlanWriter w{plan, plan_cap};

    // --- vbos ---
    {
      auto batch = pop_batch(ST_VBOS);
      if (!batch.empty()) {
        w.put(ST_VBOS);
        w.put(static_cast<int32_t>(batch.size()));
        for (auto& [cx, cz] : batch) {
          int s = slot(cx, cz);
          state[s] = DRAWABLE;
          newly_filled.emplace_back(cx, cz);
          w.put(s);
          w.put(cx);
          w.put(cz);
        }
      }
    }
    // --- fill ---
    {
      auto batch = pop_batch(ST_FILL);
      if (!batch.empty()) {
        w.put(ST_FILL);
        w.put(static_cast<int32_t>(batch.size()));
        for (auto& [cx, cz] : batch) {
          w.put(slot(cx, cz));
          w.put(cx);
          w.put(cz);
          for (auto& o : GATHER_OFFSETS) w.put(slot(cx + o[0], cz + o[1]));
        }
        for (auto& [cx, cz] : batch) state[slot(cx, cz)] = FILLED;
        for (auto& [cx, cz] : batch) {
          check_needs_vbos(cx, cz);
          check_needs_vbos(cx + 1, cz);
          check_needs_vbos(cx - 1, cz);
          check_needs_vbos(cx, cz + 1);
          check_needs_vbos(cx, cz - 1);
        }
      }
    }
    // --- gather feature placements (state-only) ---
    {
      auto batch = pop_batch(ST_GATHER_FEATURES);
      if (!batch.empty()) {
        w.put(ST_GATHER_FEATURES);
        w.put(static_cast<int32_t>(batch.size()));
        for (auto& [cx, cz] : batch) {
          int s = slot(cx, cz);
          state[s] = READY_TO_FILL;
          w.put(s);
        }
      }
    }
    // --- feature placements ---
    {
      auto batch = pop_batch(ST_FEATURE_PLACEMENTS);
      if (!batch.empty()) {
        w.put(ST_FEATURE_PLACEMENTS);
        w.put(static_cast<int32_t>(batch.size()));
        for (auto& [cx, cz] : batch) {
          int s = slot(cx, cz);
          state[s] = NEEDS_GATHER_FEATURE_PLACEMENTS;
          w.put(s);
          w.put(cx);
          w.put(cz);
        }
      }
    }
    // --- caves ---
    {
      auto batch = pop_batch(ST_CAVES);
      if (!batch.empty()) {
        w.put(ST_CAVES);
        w.put(static_cast<int32_t>(batch.size()));
        for (auto& [cx, cz] : batch) {
          int s = slot(cx, cz);
          state[s] = NEEDS_FEATURE_PLACEMENTS;
          w.put(s);
          w.put(cx);
          w.put(cz);
        }
      }
    }
    // --- erosion (one zone per frame at most: cost == full frame budget) ---
    {
      auto& q = queues[ST_EROSION];
      if (!q.empty() && action_time_left >= ACTION_TIME[ST_EROSION]) {
        auto [zx, zz] = q.front();
        q.pop_front();
        action_time_left -= ACTION_TIME[ST_EROSION];
        needs_update = true;
        w.put(ST_EROSION);
        w.put(1);
        constexpr int half = ZONE_SIZE / 2;
        for (int iz = 0; iz < 2 * ZONE_SIZE; ++iz)
          for (int ix = 0; ix < 2 * ZONE_SIZE; ++ix)
            w.put(slot(zx + ix - half, zz + iz - half));
        for (int iz = 0; iz < ZONE_SIZE; ++iz)
          for (int ix = 0; ix < ZONE_SIZE; ++ix)
            state[slot(zx + ix, zz + iz)] = NEEDS_CAVES;
      }
    }
    // --- layers ---
    {
      auto batch = pop_batch(ST_LAYERS);
      if (!batch.empty()) {
        w.put(ST_LAYERS);
        w.put(static_cast<int32_t>(batch.size()));
        for (auto& [cx, cz] : batch) {
          w.put(slot(cx, cz));
          w.put(cx);
          w.put(cz);
          for (int dz = -1; dz <= 1; ++dz)
            for (int dx = -1; dx <= 1; ++dx) w.put(slot(cx + dx, cz + dz));
        }
        for (auto& [cx, cz] : batch) {
          if (skip_erosion) {
            state[slot(cx, cz)] = NEEDS_CAVES;
          } else {
            state[slot(cx, cz)] = HAS_LAYERS;
            mark_zones_after_layers(cx, cz);
          }
        }
      }
    }
    // --- gather heightfield (state-only) ---
    {
      auto batch = pop_batch(ST_GATHER_HEIGHTFIELD);
      if (!batch.empty()) {
        w.put(ST_GATHER_HEIGHTFIELD);
        w.put(static_cast<int32_t>(batch.size()));
        for (auto& [cx, cz] : batch) {
          int s = slot(cx, cz);
          state[s] = NEEDS_LAYERS;
          w.put(s);
        }
      }
    }
    // --- heightfield ---
    {
      auto batch = pop_batch(ST_HEIGHTFIELD);
      if (!batch.empty()) {
        w.put(ST_HEIGHTFIELD);
        w.put(static_cast<int32_t>(batch.size()));
        for (auto& [cx, cz] : batch) {
          int s = slot(cx, cz);
          state[s] = HAS_HEIGHTFIELD;
          w.put(s);
          w.put(cx);
          w.put(cz);
        }
      }
    }

    w.put(-1);
    return w.overflow ? -1 : w.n;
  }

  // DRAWABLE chunks beyond the VBO radius (+2 hysteresis) drop back to FILLED
  // (destroyFarChunkVbos, terrain.cpp:1009-1019)
  int destroy_far_vbos(int32_t* out_cx, int32_t* out_cz, int max_out) {
    vbos_destroyed.clear();
    int limit = CHUNK_VBOS_GEN_RADIUS + 2;
    int n = 0;
    for (int s = 0; s < capacity; ++s) {
      if (!in_use[s] || state[s] != DRAWABLE) continue;
      int cx = chunk_cx[s], cz = chunk_cz[s];
      if (std::max(std::abs(cx - cur_cx), std::abs(cz - cur_cz)) > limit) {
        state[s] = FILLED;
        vbos_destroyed.emplace_back(cx, cz);
        needs_update = true;
        if (n < max_out) {
          out_cx[n] = cx;
          out_cz[n] = cz;
        }
        ++n;
      }
    }
    return n;
  }

  bool queues_busy() const {
    for (auto& q : queues)
      if (!q.empty()) return true;
    return false;
  }
};

}  // namespace

extern "C" {

void* sched_create(int capacity, int radius, int skip_erosion) {
  return new Scheduler(capacity, radius, skip_erosion != 0);
}
void sched_free(void* h) { delete static_cast<Scheduler*>(h); }

void sched_set_player_chunk(void* h, int cx, int cz) {
  auto* s = static_cast<Scheduler*>(h);
  s->cur_cx = cx;
  s->cur_cz = cz;
}

int64_t sched_tick(void* h, double dt, int32_t* plan, int64_t plan_cap) {
  return static_cast<Scheduler*>(h)->tick(dt, plan, plan_cap);
}

int sched_destroy_far_vbos(void* h, int32_t* out_cx, int32_t* out_cz, int max_out) {
  return static_cast<Scheduler*>(h)->destroy_far_vbos(out_cx, out_cz, max_out);
}

int sched_newly_filled(void* h, int32_t* out_cx, int32_t* out_cz, int max_out) {
  auto* s = static_cast<Scheduler*>(h);
  int n = 0;
  for (auto& [cx, cz] : s->newly_filled) {
    if (n < max_out) {
      out_cx[n] = cx;
      out_cz[n] = cz;
    }
    ++n;
  }
  return n;
}

int sched_state_at(void* h, int cx, int cz) {
  return static_cast<Scheduler*>(h)->state_at(cx, cz);
}
int sched_slot_of(void* h, int cx, int cz) {
  return static_cast<Scheduler*>(h)->slot(cx, cz);
}
int sched_queues_busy(void* h) {
  return static_cast<Scheduler*>(h)->queues_busy() ? 1 : 0;
}
int sched_drawable_count(void* h) {
  auto* s = static_cast<Scheduler*>(h);
  int n = 0;
  for (int i = 0; i < s->capacity; ++i)
    if (s->in_use[i] && s->state[i] == DRAWABLE) ++n;
  return n;
}
int64_t sched_chunk_count(void* h) {
  return static_cast<int64_t>(static_cast<Scheduler*>(h)->slot_of.size());
}
double sched_action_time_left(void* h) {
  return static_cast<Scheduler*>(h)->action_time_left;
}
void sched_force_update(void* h) { static_cast<Scheduler*>(h)->needs_update = true; }

// copy the full state/pos tables (for drain detection + checkpointing)
void sched_snapshot(void* h, uint8_t* out_state, int32_t* out_cx, int32_t* out_cz,
                    uint8_t* out_in_use) {
  auto* s = static_cast<Scheduler*>(h);
  std::memcpy(out_state, s->state.data(), s->capacity);
  std::memcpy(out_cx, s->chunk_cx.data(), s->capacity * sizeof(int32_t));
  std::memcpy(out_cz, s->chunk_cz.data(), s->capacity * sizeof(int32_t));
  std::memcpy(out_in_use, s->in_use.data(), s->capacity);
}

}  // extern "C"
