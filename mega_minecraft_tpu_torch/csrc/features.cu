// K7: area-level feature application; K7s: the streaming scheduler's per-chunk feature
// application; and their pre-kernel, the per-placement streams.
//
// K7 replaces mega_minecraft_tpu/terrain/features.py:173,431 apply_placements_area /
// apply_features_area (jitted XLA on the TPU, together with all of features_sdf.py).
// K7s replaces features.py:91,461,471 apply_placements / apply_features_chunk /
// apply_features_batch with feature_placement.py:333,349 gather_from_neighborhood(_batch),
// the feature step of the scheduler's _stage_fill (scheduler.py:150-156).
// The JAX program inverted the reference's per-block loop into per-type batches of
// windowed whole-volume SDF evaluations with a packed min-key combine, because SIMD
// lanes cannot leave a loop early.  Threads can: here the loop is the reference's own.
//
// One CUDA block per column of the area, one thread per y (384 threads).  The voxel's
// winner is the first placement, in its consumer chunk's 49-source spiral order and then
// list slot, whose window holds the column, whose height bounds hold y, whose terrain
// test passes (AIR or replace) and whose SDF hits; the index in the consumer's gathered
// list runs on the TRUE per-chunk counts, and entries at index >= 2,048 (surface) /
// 4,096 (cave) are invisible to this consumer.  Surface placements first; the cave pass
// runs only for voxels no surface placement took, and both test the TERRAIN block.
//
// The window test depends on the column alone, so the block makes it once for all its
// voxels: 49 threads read the sources' counts, thread 0 lays the visible part of each
// source's list end to end (49 offsets),
// the 384 threads test 384 gathered entries at a time and compact the survivors, in
// gathered order, into shared memory (warp ballots and a 12-warp prefix), and every
// thread then walks only the survivors -- a handful instead of the hundreds in reach.
// The buffer is flushed (walked and emptied) whenever it could not take another batch,
// so any number of survivors is handled.  The per-block RNG is re-seeded for every
// evaluation, so it is computed once per pass and handed to each feature function by value.
//
// The 64 draws of a placement's stream do not depend on the voxel: the pre-kernel
// writes them once per list entry ([B, K, 64] f32) and K7 reads them (broadcast loads).
//
// K7s is the same block program with another source of lists.  A chunk of the batch
// reads its 49 sources through a [B, 49] slot table (GATHER_OFFSETS order) from the
// scheduler's slot table of lists, true counts and streams ([capacity, K(, 64)]).  Its
// gathered list ranks the valid entries the stored lists hold, min(count, K) per source
// (valid entries come first), where the area path ranks by the true counts; the two
// differ only for a list that overflows its K.  The JAX per-chunk program evaluates
// every gathered entry over the whole chunk; K7s keeps K7's window cull (template CULL),
// which chip_smoke.py holds equal to the unculled kernel on every chunk it streams and
// to the plain version on the first batch.
//
// Bound on the H100: arithmetic and latency, not bytes (K7 must move 2 bytes per voxel,
// one read and one write).  The SDFs run for the few voxels inside a placement's window
// and bounds; the rest of a block's time is the gathered lists' walk and its barriers.

#include "features_sdf.cuh"

using namespace mmt;

struct PlacementLists {
  const int* feature;
  const int* x;
  const int* y;
  const int* z;
  const int* replace;
  const int* height;  // cave lists only
  const int* count;   // [B] true (uncapped) counts
  const float* streams;  // [B, K, STREAM_LEN]
};

// thread (e, i) of the pre-kernel: entry e of the surface lists, then of the cave lists
__global__ void feature_streams_kernel(const int* __restrict__ sx, const int* __restrict__ sy,
                                       const int* __restrict__ sz, const int* __restrict__ cx,
                                       const int* __restrict__ cy, const int* __restrict__ cz,
                                       int n_surface, int n_cave, float* __restrict__ s_out,
                                       float* __restrict__ c_out) {
  int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_surface + n_cave) return;
  bool cave = e >= n_surface;
  if (cave) e -= n_surface;
  uint32_t state = cave ? seed_4(cx[e], cy[e], cz[e], SEED_CAVE_FEATURE_RNG)
                        : seed_4(sx[e], sy[e], sz[e], SEED_SURFACE_FEATURE_RNG);
  float* out = (cave ? c_out : s_out) + (size_t)e * STREAM_LEN;
  for (int i = 0; i < STREAM_LEN; ++i) out[i] = lcg_u01(&state);
}

#define N_WARPS (Y_SIZE / 32)
// candidate buffer: it is flushed as soon as it holds more than CAND_CAP - Y_SIZE entries,
// so a batch of up to Y_SIZE survivors always fits
#define CAND_CAP (2 * Y_SIZE)

struct GatherScratch {
  int off[NUM_GATHER_OFFSETS + 1];  // gathered index of each spiral rank's first visible entry
  int src[NUM_GATHER_OFFSETS];      // the rank's source chunk
  int count[NUM_GATHER_OFFSETS];    // its true placement count (0 beyond the area)
  int warp_count[N_WARPS];
  int cand[CAND_CAP];               // list entries (sb * K + k) whose window holds the column
};

// evaluates the buffered candidates, in order, for one voxel that has no winner yet
template <bool CAVE>
MMT_FN bool walk_candidates(const PlacementLists& L, const int* cand, int n_cand, int wx, int wy,
                            int wz, bool terrain_is_air, uint32_t brng, int& block) {
  for (int i = 0; i < n_cand; ++i) {
    int e = cand[i];
    int feat = L.feature[e];
    Placement p = {L.x[e], L.y[e], L.z[e]};
    int h = CAVE ? L.height[e] : 0;
    const int* bounds = CAVE ? CAVE_FEATURE_HEIGHT_BOUNDS[feat] : FEATURE_HEIGHT_BOUNDS[feat];
    if (wy < p.y + bounds[0] || wy > p.y + h + bounds[1]) continue;
    if (!terrain_is_air && L.replace[e] == 0) continue;
    const float* s = L.streams + (size_t)e * STREAM_LEN;
    int fx = wx - p.x, fz = wz - p.z;
    bool hit = CAVE ? cave_feature_hit(feat, s, fx, wy - p.y, fz, wx, wy, wz, brng, p, h, block)
                    : surface_feature_hit(feat, s, fx, wy - p.y, fz, wx, wy, wz, brng, p, block);
    if (hit) return true;
  }
  return false;
}

// the sources of a consumer chunk of an area: the chunks at GATHER_OFFSETS inside the
// area, ranked by their true counts (a source beyond the area has no placements)
struct AreaSources {
  int vx, vz, ncx, ncz;
  MMT_FN void get(int r, const int* count, int K, int& src, int& cnt) const {
    int sx = vx + GATHER_OFFSETS[r][0], sz = vz + GATHER_OFFSETS[r][1];
    bool inside = sx >= 0 && sx < ncx && sz >= 0 && sz < ncz;
    src = inside ? sz * ncx + sx : 0;
    cnt = inside ? count[src] : 0;
  }
};

// the sources of a chunk of the scheduler's batch: its 49 slots, ranked by the valid
// entries their stored lists hold
struct SlotSources {
  const int* slots;  // [49]
  MMT_FN void get(int r, const int* count, int K, int& src, int& cnt) const {
    src = slots[r];
    int c = count[src];
    cnt = c < K ? c : K;
  }
};

// the first placement of one kind (surface / cave) that claims the voxel, if any; every
// thread of the block calls it (it holds barriers), `skip` voxels only take part
template <bool CAVE, bool CULL, class Sources>
MMT_FN bool first_hit(const PlacementLists& L, int K, GatherScratch& sh, const Sources& S, int wx,
                      int wy, int wz, bool terrain_is_air, bool skip, int& block) {
  const int cap = CAVE ? MAX_GATHERED_CAVE_FEATURES : MAX_GATHERED_FEATURES;
  const int n_types = CAVE ? NUM_CAVE_FEATURES : NUM_FEATURES;
  int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  __syncthreads();  // the scratch may still be read by the previous pass
  if (tid < NUM_GATHER_OFFSETS) S.get(tid, L.count, K, sh.src[tid], sh.count[tid]);
  __syncthreads();
  if (tid == 0) {
    int gathered = 0, total = 0;  // index in the gathered list; visible entries so far
    for (int r = 0; r < NUM_GATHER_OFFSETS; ++r) {
      int cnt = sh.count[r];
      int n = cnt < K ? cnt : K;
      if (n > cap - gathered) n = cap - gathered;  // the gather cuts its list at the cap
      sh.off[r] = total;
      total += n > 0 ? n : 0;
      gathered += cnt;
    }
    sh.off[NUM_GATHER_OFFSETS] = total;
  }
  __syncthreads();
  int total = sh.off[NUM_GATHER_OFFSETS];
  uint32_t brng = seed_4(wx, wy, wz, CAVE ? SEED_CAVE_BLOCK_RNG : SEED_SURFACE_BLOCK_RNG);
  bool found = false;
  int n_cand = 0;
  for (int base = 0; base < total; base += Y_SIZE) {
    // this thread's gathered entry: does its window hold the column?
    int g = base + tid, e = 0;
    bool keep = false;
    if (g < total) {
      int r = 0;
      while (sh.off[r + 1] <= g) ++r;
      e = sh.src[r] * K + (g - sh.off[r]);
      int feat = L.feature[e];
      if (feat > 0 && feat < n_types) {
        int fx = wx - L.x[e], fz = wz - L.z[e];
        const int* win = CAVE ? CAVE_WINDOW[feat] : SURFACE_WINDOW[feat];
        keep = !CULL || (fx >= -win[0] && fx <= win[1] && fz >= -win[0] && fz <= win[1]);
      }
    }
    // append the kept entries to the buffer in gathered order
    unsigned mask = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) sh.warp_count[warp] = __popc(mask);
    __syncthreads();
    int before = 0, batch = 0;
    for (int k = 0; k < N_WARPS; ++k) {
      if (k < warp) before += sh.warp_count[k];
      batch += sh.warp_count[k];
    }
    if (keep) sh.cand[n_cand + before + __popc(mask & ((1u << lane) - 1u))] = e;
    n_cand += batch;
    __syncthreads();
    // flush when another batch might not fit, and after the last batch
    if (n_cand > CAND_CAP - Y_SIZE || base + Y_SIZE >= total) {
      if (!skip && !found)
        found = walk_candidates<CAVE>(L, sh.cand, n_cand, wx, wy, wz, terrain_is_air, brng, block);
      n_cand = 0;
      __syncthreads();
    }
  }
  return found;
}

// one voxel (block (b, col), thread y): surface placements first, then cave placements
// for the voxels no surface placement took; both test the terrain block
template <bool CULL, class Sources>
MMT_FN void feature_voxel(const unsigned char* blocks, const PlacementLists& surf,
                          const PlacementLists& cave, const Sources& S, GatherScratch& sh,
                          const int* pos, unsigned char* out) {
  int bc = blockIdx.x;  // b * 256 + col
  int b = bc >> 8, col = bc & 255;
  int y = threadIdx.x;
  int wx = pos[2 * b] + (col & 15), wz = pos[2 * b + 1] + (col >> 4);
  size_t o = (size_t)bc * Y_SIZE + y;
  int terrain = blocks[o];
  bool is_air = terrain == BLOCK_AIR;
  int s_block = 0, c_block = 0;
  bool s_hit = first_hit<false, CULL>(surf, CHUNK_FEATURE_CAP, sh, S, wx, y, wz, is_air, false,
                                      s_block);
  bool c_hit = first_hit<true, CULL>(cave, CHUNK_CAVE_FEATURE_CAP, sh, S, wx, y, wz, is_air, s_hit,
                                     c_block);
  out[o] = (unsigned char)(s_hit ? s_block : (c_hit ? c_block : terrain));
}

__global__ void __launch_bounds__(Y_SIZE) features_kernel(
    const unsigned char* __restrict__ blocks, PlacementLists surf, PlacementLists cave,
    const int* __restrict__ pos, int ncx, int ncz, unsigned char* __restrict__ out) {
  __shared__ GatherScratch sh;
  int b = blockIdx.x >> 8;
  AreaSources S = {b % ncx, b / ncx, ncx, ncz};
  feature_voxel<true>(blocks, surf, cave, S, sh, pos, out);
}

// K7s: lists, counts and streams are the slot table's; nslots [B, 49]
template <bool CULL>
__global__ void __launch_bounds__(Y_SIZE) features_slots_kernel(
    const unsigned char* __restrict__ blocks, PlacementLists surf, PlacementLists cave,
    const int* __restrict__ nslots, const int* __restrict__ pos, unsigned char* __restrict__ out) {
  __shared__ GatherScratch sh;
  SlotSources S = {nslots + (blockIdx.x >> 8) * NUM_GATHER_OFFSETS};
  feature_voxel<CULL>(blocks, surf, cave, S, sh, pos, out);
}

extern "C" int mmt_feature_streams(const int* sx, const int* sy, const int* sz, const int* cx,
                                   const int* cy, const int* cz, int B, float* s_out, float* c_out,
                                   void* stream) {
  int n_surface = B * CHUNK_FEATURE_CAP, n_cave = B * CHUNK_CAVE_FEATURE_CAP;
  int n = n_surface + n_cave;
  feature_streams_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      sx, sy, sz, cx, cy, cz, n_surface, n_cave, s_out, c_out);
  return (int)cudaGetLastError();
}

extern "C" int mmt_features(const unsigned char* blocks, const int* s_feature, const int* s_x,
                            const int* s_y, const int* s_z, const int* s_replace,
                            const int* s_count, const float* s_streams, const int* c_feature,
                            const int* c_x, const int* c_y, const int* c_z, const int* c_replace,
                            const int* c_height, const int* c_count, const float* c_streams,
                            const int* pos, int ncx, int ncz, unsigned char* out, void* stream) {
  PlacementLists surf = {s_feature, s_x, s_y, s_z, s_replace, nullptr, s_count, s_streams};
  PlacementLists cave = {c_feature, c_x, c_y, c_z, c_replace, c_height, c_count, c_streams};
  features_kernel<<<ncx * ncz * 256, Y_SIZE, 0, (cudaStream_t)stream>>>(blocks, surf, cave, pos,
                                                                        ncx, ncz, out);
  return (int)cudaGetLastError();
}

extern "C" int mmt_features_slots(const unsigned char* blocks, const int* s_feature, const int* s_x,
                                  const int* s_y, const int* s_z, const int* s_replace,
                                  const int* s_count, const float* s_streams, const int* c_feature,
                                  const int* c_x, const int* c_y, const int* c_z,
                                  const int* c_replace, const int* c_height, const int* c_count,
                                  const float* c_streams, const int* nslots, const int* pos, int B,
                                  int cull, unsigned char* out, void* stream) {
  PlacementLists surf = {s_feature, s_x, s_y, s_z, s_replace, nullptr, s_count, s_streams};
  PlacementLists cave = {c_feature, c_x, c_y, c_z, c_replace, c_height, c_count, c_streams};
  if (cull)
    features_slots_kernel<true><<<B * 256, Y_SIZE, 0, (cudaStream_t)stream>>>(blocks, surf, cave,
                                                                            nslots, pos, out);
  else
    features_slots_kernel<false><<<B * 256, Y_SIZE, 0, (cudaStream_t)stream>>>(blocks, surf, cave,
                                                                             nslots, pos, out);
  return (int)cudaGetLastError();
}
