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
// A voxel's winner is the first placement, in its consumer chunk's gathered list (49-source
// spiral order, then list slot), whose window holds the column, whose height bounds hold y,
// whose terrain test passes (AIR or replace) and whose SDF hits.  The index in the gathered
// list runs on the TRUE per-chunk counts (K7) or on min(count, K) (K7s, the valid entries
// the slot table's lists hold; the two differ only for a list that overflows its K); entries
// at index >= 2,048 (surface) / 4,096 (cave) are invisible to the consumer.  Surface
// placements first; the cave pass runs only for voxels no surface placement took, and both
// test the TERRAIN block.
//
// Two launches (one count):
//   1. cull_kernel, one CTA per consumer chunk and kind: the 49 sources' visible counts and
//      offsets by two warp scans; then every visible entry, in gathered order, whose XZ window
//      (SURFACE_WINDOW / CAVE_WINDOW) meets the chunk's 16 x 16 columns is written, with what
//      the walk reads (Candidate: position, stream row, feature, replace, height), to the
//      chunk's list in device memory (sized at the gather cap: no overflow).  Of the ~750
//      entries a chunk can see, a few tens survive.
//   2. features_kernel, one CTA per column, FEATURE_THREADS = 128 threads (each y = t + k * 128):
//      the chunk's list, NT entries a batch, is tested against the column's window and the
//      survivors compacted in order into shared memory (warp ballots and a prefix); every
//      voxel then walks them (walk_candidates) -- one batch and about four barriers a kind
//      when the list holds at most 128 entries.  The per-block RNG is re-seeded for every
//      evaluation, so it is computed once per pass and handed to each feature function by value.
// The culled list is a superset, in the same order, of each column's window survivors, so the
// result is the per-column walk's.  K7s with CULL = false keeps every visible entry in both
// launches: the JAX per-chunk program's semantics, which chip_smoke.py holds equal to the
// culled kernel on every chunk it streams and to the plain version on the first batch.
//
// The 64 draws of a placement's stream do not depend on the voxel: the pre-kernel writes
// them once per VALID list entry (slot < min(count, K) of each chunk and kind, the only entries
// the cull above can hand to the walk; the rows past them are left unwritten) into [B, K, 64]
// f32 rows, and K7 reads them (broadcast loads).  A warp takes a row: lane j computes draws j
// and j + 32 by a jump from the entry's seed (LCG_JUMP: a^(j+1) mod m, mmt_feature_tables.h),
// the same integer states as stepping the stream, and the warp's two stores are coalesced.
//
// Bound on the H100: arithmetic and latency, not bytes (K7 must move 2 bytes per voxel,
// one read and one write).  The SDFs run for the few voxels inside a placement's window
// and bounds; the rest of a block's time is the list walk and its barriers.

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

// a list entry that the walk reads: its position, stream row (e = source * K + slot),
// feature, replace flag and (cave) layer height, in two 16-byte words
struct __align__(16) Candidate {
  int x, y, z, e;
  int feat, replace, height, pad;
};

// the pre-kernel's CTA: a chunk (blockIdx.x) and kind (blockIdx.y: 0 surface, 1 cave), a warp a
// valid list entry in turn.  Row b of the batch goes to row rows[b] of the outputs (b without
// rows); a row outside [0, n_rows) is skipped
#define STREAM_THREADS 128
static_assert(STREAM_LEN == 64, "a lane writes draws lane and lane + 32 of a row");

__global__ void __launch_bounds__(STREAM_THREADS) feature_streams_kernel(
    const int* __restrict__ sx, const int* __restrict__ sy, const int* __restrict__ sz,
    const int* __restrict__ s_count, const int* __restrict__ cx, const int* __restrict__ cy,
    const int* __restrict__ cz, const int* __restrict__ c_count, const int* __restrict__ rows, int n_rows,
    float* __restrict__ s_out, float* __restrict__ c_out) {
  const int b = blockIdx.x;
  const bool cave = blockIdx.y != 0;
  const int K = cave ? CHUNK_CAVE_FEATURE_CAP : CHUNK_FEATURE_CAP;
  int n = (cave ? c_count : s_count)[b];
  n = n < K ? n : K;
  const int r = rows ? rows[b] : b;
  if (n <= 0 || r < 0 || r >= n_rows) return;
  const int lane = threadIdx.x & 31;
  const uint32_t jump_lo = LCG_JUMP[lane], jump_hi = LCG_JUMP[lane + 32];
  const size_t in_row = (size_t)b * K;
  const int *x = (cave ? cx : sx) + in_row, *y = (cave ? cy : sy) + in_row, *z = (cave ? cz : sz) + in_row;
  const int seed = cave ? SEED_CAVE_FEATURE_RNG : SEED_SURFACE_FEATURE_RNG;
  float* out = (cave ? c_out : s_out) + (size_t)r * K * STREAM_LEN;
  for (int e = threadIdx.x >> 5; e < n; e += STREAM_THREADS / 32) {
    const uint32_t state0 = seed_4(x[e], y[e], z[e], seed);
    float* o = out + (size_t)e * STREAM_LEN;
    o[lane] = lcg_value_at(state0, jump_lo);
    o[lane + 32] = lcg_value_at(state0, jump_hi);
  }
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

struct AreaSourcesOf {
  int ncx, ncz;
  MMT_FN AreaSources operator()(int b) const { return {b % ncx, b / ncx, ncx, ncz}; }
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

struct SlotSourcesOf {
  const int* nslots;  // [B, 49]
  MMT_FN SlotSources operator()(int b) const { return {nslots + b * NUM_GATHER_OFFSETS}; }
};

#define CULL_THREADS 256
static_assert(NUM_GATHER_OFFSETS <= 64, "the ranks' scans span two warps");

struct CullScratch {
  int off[NUM_GATHER_OFFSETS + 1];  // list index of each spiral rank's first visible entry
  int src[NUM_GATHER_OFFSETS];      // the rank's source chunk
  int part;                         // the first warp's sum, for the scans
  int warp_count[CULL_THREADS / 32];
};

// inclusive prefix sum of v over threads 0..63 (each warp's shuffles, then the first warp's
// sum carried into the second); every thread of the CTA calls it (it holds barriers)
MMT_FN int scan64(int v, CullScratch& sh) {
  const int t = threadIdx.x, lane = t & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    int u = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v += u;
  }
  if (t == 31) sh.part = v;
  __syncthreads();
  if (t >= 32 && t < 64) v += sh.part;
  __syncthreads();  // sh.part is written again by the next scan
  return v;
}

// pre-pass of one consumer chunk and kind: every visible gathered entry, in order, whose
// window meets the chunk's columns (every visible entry without CULL) to out; its length to
// *count
template <bool CAVE, bool CULL, class Sources>
MMT_FN void cull_chunk(const PlacementLists& L, int K, const Sources& S, int x0, int z0, CullScratch& sh,
                       Candidate* __restrict__ out, int* count) {
  const int cap = CAVE ? MAX_GATHERED_CAVE_FEATURES : MAX_GATHERED_FEATURES;
  const int n_types = CAVE ? NUM_CAVE_FEATURES : NUM_FEATURES;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  int src = 0, cnt = 0;
  if (t < NUM_GATHER_OFFSETS) S.get(t, L.count, K, src, cnt);
  // the gathered index of the rank's first entry, then its visible entries: at most K, and
  // none past the gather cap
  const int gathered = scan64(cnt, sh) - cnt;
  int n = cnt < K ? cnt : K;
  if (n > cap - gathered) n = cap - gathered;
  n = n > 0 ? n : 0;
  const int off = scan64(n, sh);
  if (t < NUM_GATHER_OFFSETS) {
    sh.off[t] = off - n;
    sh.src[t] = src;
  }
  if (t == NUM_GATHER_OFFSETS - 1) sh.off[NUM_GATHER_OFFSETS] = off;
  __syncthreads();
  const int total = sh.off[NUM_GATHER_OFFSETS];
  int n_out = 0;
  for (int base = 0; base < total; base += CULL_THREADS) {
    const int g = base + t;
    bool keep = false;
    Candidate c;
    if (g < total) {
      int r = 0, hi = NUM_GATHER_OFFSETS - 1;  // the last rank whose first entry is <= g
      while (r < hi) {
        int mid = (r + hi + 1) >> 1;
        if (sh.off[mid] <= g) r = mid;
        else hi = mid - 1;
      }
      const int e = sh.src[r] * K + (g - sh.off[r]);
      const int feat = L.feature[e];
      if (feat > 0 && feat < n_types) {
        const int x = L.x[e], z = L.z[e];
        const int* win = CAVE ? CAVE_WINDOW[feat] : SURFACE_WINDOW[feat];
        // the window [x - win[0], x + win[1]] x [z - win[0], z + win[1]] meets the columns
        keep = !CULL || (x0 - x <= win[1] && x0 + 15 - x >= -win[0] && z0 - z <= win[1] &&
                         z0 + 15 - z >= -win[0]);
        if (keep) c = {x, L.y[e], z, e, feat, L.replace[e], CAVE ? L.height[e] : 0, 0};
      }
    }
    const unsigned mask = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) sh.warp_count[warp] = __popc(mask);
    __syncthreads();
    int before = 0, batch = 0;
    for (int k = 0; k < CULL_THREADS / 32; ++k) {
      if (k < warp) before += sh.warp_count[k];
      batch += sh.warp_count[k];
    }
    if (keep) out[n_out + before + __popc(mask & ((1u << lane) - 1u))] = c;
    n_out += batch;
    __syncthreads();
  }
  if (t == 0) *count = n_out;
}

// blockIdx.x: the consumer chunk b; blockIdx.y: 0 surface, 1 cave.  out_s / out_c [B, cap],
// counts [B, 2]
template <bool CULL, class SourcesOf>
__global__ void __launch_bounds__(CULL_THREADS)
cull_kernel(PlacementLists surf, PlacementLists cave, SourcesOf sources, const int* __restrict__ pos,
            Candidate* __restrict__ out_s, Candidate* __restrict__ out_c, int* __restrict__ counts) {
  __shared__ CullScratch sh;
  const int b = blockIdx.x, x0 = pos[2 * b], z0 = pos[2 * b + 1];
  if (blockIdx.y == 0)
    cull_chunk<false, CULL>(surf, CHUNK_FEATURE_CAP, sources(b), x0, z0, sh,
                            out_s + (size_t)b * MAX_GATHERED_FEATURES, counts + 2 * b);
  else
    cull_chunk<true, CULL>(cave, CHUNK_CAVE_FEATURE_CAP, sources(b), x0, z0, sh,
                           out_c + (size_t)b * MAX_GATHERED_CAVE_FEATURES, counts + 2 * b + 1);
}

// evaluates the buffered candidates, in order, for one voxel that has no winner yet
template <bool CAVE>
MMT_FN bool walk_candidates(const Candidate* cand, int n_cand, const float* streams, int wx, int wy,
                            int wz, bool terrain_is_air, uint32_t brng, int& block) {
  for (int i = 0; i < n_cand; ++i) {
    const Candidate c = cand[i];
    int feat = c.feat;
    Placement p = {c.x, c.y, c.z};
    int h = CAVE ? c.height : 0;
    const int* bounds = CAVE ? CAVE_FEATURE_HEIGHT_BOUNDS[feat] : FEATURE_HEIGHT_BOUNDS[feat];
    if (wy < p.y + bounds[0] || wy > p.y + h + bounds[1]) continue;
    if (!terrain_is_air && c.replace == 0) continue;
    const float* s = streams + (size_t)c.e * STREAM_LEN;
    int fx = wx - p.x, fz = wz - p.z;
    bool hit = CAVE ? cave_feature_hit(feat, s, fx, wy - p.y, fz, wx, wy, wz, brng, p, h, block)
                    : surface_feature_hit(feat, s, fx, wy - p.y, fz, wx, wy, wz, brng, p, block);
    if (hit) return true;
  }
  return false;
}

// the first placement of one kind (surface / cave) that claims each of the thread's VPT voxels
// (y = t + k * NT), from the chunk's culled list of n entries; every thread of the CTA calls it
// (it holds barriers), `skip` voxels only take part
template <bool CAVE, bool CULL, int NT, int VPT>
MMT_FN void first_hits(const Candidate* __restrict__ list, int n, const float* streams, int wx, int wz,
                       const bool* is_air, const bool* skip, bool* found, int* block, Candidate* cand,
                       int* warp_count) {
  constexpr int CAND_CAP = 2 * NT;  // flushed once it holds more than CAND_CAP - NT entries
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  uint32_t brng[VPT];
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    brng[k] = seed_4(wx, t + k * NT, wz, CAVE ? SEED_CAVE_BLOCK_RNG : SEED_SURFACE_BLOCK_RNG);
    found[k] = false;
  }
  __syncthreads();  // the buffer may still be read by the previous pass
  int n_cand = 0;
  for (int base = 0; base < n; base += NT) {
    // this thread's list entry: does its window hold the column?
    const int j = base + t;
    bool keep = false;
    Candidate c;
    if (j < n) {
      c = list[j];
      const int* win = CAVE ? CAVE_WINDOW[c.feat] : SURFACE_WINDOW[c.feat];
      const int fx = wx - c.x, fz = wz - c.z;
      keep = !CULL || (fx >= -win[0] && fx <= win[1] && fz >= -win[0] && fz <= win[1]);
    }
    // append the kept entries to the buffer in list order
    const unsigned mask = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) warp_count[warp] = __popc(mask);
    __syncthreads();
    int before = 0, batch = 0;
#pragma unroll
    for (int k = 0; k < NT / 32; ++k) {
      if (k < warp) before += warp_count[k];
      batch += warp_count[k];
    }
    if (keep) cand[n_cand + before + __popc(mask & ((1u << lane) - 1u))] = c;
    n_cand += batch;
    __syncthreads();
    // walk when another batch might not fit, and after the last batch
    if (n_cand > CAND_CAP - NT || base + NT >= n) {
#pragma unroll
      for (int k = 0; k < VPT; ++k)
        if (!skip[k] && !found[k])
          found[k] = walk_candidates<CAVE>(cand, n_cand, streams, wx, t + k * NT, wz, is_air[k], brng[k],
                                           block[k]);
      n_cand = 0;
      __syncthreads();
    }
  }
}

// one column (blockIdx.x = b * 256 + col) of the chunks' blocks: surface placements first,
// then cave placements for the voxels no surface placement took; both test the terrain block
template <int NT, bool CULL>
__global__ void __launch_bounds__(NT) features_kernel(
    const unsigned char* __restrict__ blocks, const float* __restrict__ s_streams,
    const float* __restrict__ c_streams, const Candidate* __restrict__ list_s,
    const Candidate* __restrict__ list_c, const int* __restrict__ counts, const int* __restrict__ pos,
    unsigned char* __restrict__ out) {
  static_assert(Y_SIZE % NT == 0 && NT % 32 == 0, "a thread takes Y_SIZE / NT voxels");
  constexpr int VPT = Y_SIZE / NT;
  __shared__ Candidate cand[2 * NT];
  __shared__ int warp_count[NT / 32];
  const int bc = blockIdx.x, b = bc >> 8, col = bc & 255, t = threadIdx.x;
  const int wx = pos[2 * b] + (col & 15), wz = pos[2 * b + 1] + (col >> 4);
  int terrain[VPT], s_block[VPT], c_block[VPT];
  bool is_air[VPT], none[VPT], s_hit[VPT], c_hit[VPT];
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    terrain[k] = blocks[(size_t)bc * Y_SIZE + t + k * NT];
    is_air[k] = terrain[k] == BLOCK_AIR;
    none[k] = false;
    s_block[k] = c_block[k] = 0;
  }
  first_hits<false, CULL, NT, VPT>(list_s + (size_t)b * MAX_GATHERED_FEATURES, counts[2 * b], s_streams, wx,
                                   wz, is_air, none, s_hit, s_block, cand, warp_count);
  first_hits<true, CULL, NT, VPT>(list_c + (size_t)b * MAX_GATHERED_CAVE_FEATURES, counts[2 * b + 1],
                                  c_streams, wx, wz, is_air, s_hit, c_hit, c_block, cand, warp_count);
#pragma unroll
  for (int k = 0; k < VPT; ++k)
    out[(size_t)bc * Y_SIZE + t + k * NT] = (unsigned char)(s_hit[k] ? s_block[k] : (c_hit[k] ? c_block[k] : terrain[k]));
}

// threads of the column pass, a column a CTA: three voxels a thread.  On the H100 (ptxas: 72
// registers, 32 bytes spilled) it beat 384 (a thread a voxel, 75 registers), 192 and 64 (80
// registers, 148 bytes of spill loads) at the 5x5 and 33x33 areas and the drain's batches:
// fewer threads a column share one list batch and its barriers, and more columns fit an SM
#define FEATURE_THREADS 128

template <bool CULL>
static int launch_columns(int B, const unsigned char* blocks, const float* s_streams, const float* c_streams,
                          const Candidate* list_s, const Candidate* list_c, const int* counts, const int* pos,
                          unsigned char* out, cudaStream_t st) {
  features_kernel<FEATURE_THREADS, CULL><<<B * 256, FEATURE_THREADS, 0, st>>>(
      blocks, s_streams, c_streams, list_s, list_c, counts, pos, out);
  return (int)cudaGetLastError();
}

// rows: [B] i32 output rows of the batch's chunks, or null for rows 0..B-1; n_rows: the outputs'
// rows ([n_rows, K, 64] each)
extern "C" int mmt_feature_streams(const int* sx, const int* sy, const int* sz, const int* s_count,
                                   const int* cx, const int* cy, const int* cz, const int* c_count,
                                   const int* rows, int B, int n_rows, float* s_out, float* c_out,
                                   void* stream) {
  feature_streams_kernel<<<dim3(B, 2), STREAM_THREADS, 0, (cudaStream_t)stream>>>(
      sx, sy, sz, s_count, cx, cy, cz, c_count, rows, n_rows, s_out, c_out);
  return (int)cudaGetLastError();
}

// K7: cand_s [B, MAX_GATHERED_FEATURES] and cand_c [B, MAX_GATHERED_CAVE_FEATURES] Candidates
// and counts [B, 2] are the pre-pass's lists (scratch the caller allocates)
extern "C" int mmt_features(const unsigned char* blocks, const int* s_feature, const int* s_x,
                            const int* s_y, const int* s_z, const int* s_replace,
                            const int* s_count, const float* s_streams, const int* c_feature,
                            const int* c_x, const int* c_y, const int* c_z, const int* c_replace,
                            const int* c_height, const int* c_count, const float* c_streams,
                            const int* pos, int ncx, int ncz, void* cand_s, void* cand_c, int* counts,
                            unsigned char* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  PlacementLists surf = {s_feature, s_x, s_y, s_z, s_replace, nullptr, s_count, s_streams};
  PlacementLists cave = {c_feature, c_x, c_y, c_z, c_replace, c_height, c_count, c_streams};
  const int B = ncx * ncz;
  Candidate* ls = (Candidate*)cand_s;
  Candidate* lc = (Candidate*)cand_c;
  cull_kernel<true><<<dim3(B, 2), CULL_THREADS, 0, st>>>(surf, cave, AreaSourcesOf{ncx, ncz}, pos, ls, lc,
                                                         counts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_columns<true>(B, blocks, s_streams, c_streams, ls, lc, counts, pos, out, st);
}

// K7s: lists, counts and streams are the slot table's; nslots [B, 49]
extern "C" int mmt_features_slots(const unsigned char* blocks, const int* s_feature, const int* s_x,
                                  const int* s_y, const int* s_z, const int* s_replace,
                                  const int* s_count, const float* s_streams, const int* c_feature,
                                  const int* c_x, const int* c_y, const int* c_z,
                                  const int* c_replace, const int* c_height, const int* c_count,
                                  const float* c_streams, const int* nslots, const int* pos, int B,
                                  int cull, void* cand_s, void* cand_c, int* counts, unsigned char* out,
                                  void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  PlacementLists surf = {s_feature, s_x, s_y, s_z, s_replace, nullptr, s_count, s_streams};
  PlacementLists cave = {c_feature, c_x, c_y, c_z, c_replace, c_height, c_count, c_streams};
  Candidate* ls = (Candidate*)cand_s;
  Candidate* lc = (Candidate*)cand_c;
  if (cull)
    cull_kernel<true><<<dim3(B, 2), CULL_THREADS, 0, st>>>(surf, cave, SlotSourcesOf{nslots}, pos, ls, lc,
                                                           counts);
  else
    cull_kernel<false><<<dim3(B, 2), CULL_THREADS, 0, st>>>(surf, cave, SlotSourcesOf{nslots}, pos, ls, lc,
                                                            counts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return cull ? launch_columns<true>(B, blocks, s_streams, c_streams, ls, lc, counts, pos, out, st)
              : launch_columns<false>(B, blocks, s_streams, c_streams, ls, lc, counts, pos, out, st);
}
