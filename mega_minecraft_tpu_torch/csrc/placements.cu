// K5: feature placement grids, and K6: their compaction into per-chunk lists.
//
// K5 replaces mega_minecraft_tpu/terrain/feature_placement.py:92 generate_placements,
// K6 replaces feature_placement.py:256 compact_placements (jitted XLA on the TPU).
//
// K5: one thread per column.  The thread walks its column's 32 cave layers in order
// (floor gens, then ceiling gens) and then the surface gens of one randomly picked biome,
// on ONE sequential minstd stream that advances only where the reference's control flow
// draws: a draw for gen g happens iff the layer is live, nothing is placed in this slot yet
// and g < count[biome].  The JAX program drew for every column with a mask and looked its
// tables up with compare/select chains; a thread here branches and indexes the tables.
// The two sin-hashes of is_feature_pos are evaluated last, only when every cheaper condition
// holds (they have no side effect).
//
// The walk does little arithmetic (~7 draws and ~2 position tests a column); its time is the
// memory traffic of the per-column layer rows ([B, 16, 16, 32] i32, layer fastest: a column's
// row is 128 bytes, 128-byte aligned).  A thread that touched one 4-byte layer of each row at a
// time made every warp-wide access hit 32 sectors for 4 bytes each.  So the walk takes its
// column's layers 4 at a time, in 16-byte words: a CTA of PLACEMENT_COLS columns stages their
// input rows in shared memory with coalesced 16-byte copies, each thread walks its column's
// rows there (16-byte loads; 16-byte stores of cave_y, cave_height and cave_feature, 2 layers x
// 2 slots a word, and of cave_replace every 8 layers), and the output rows are copied out
// coalesced.  Rows are padded (36 words a 32-word row, 68 a feature row, 20 a replace row) so
// that 16-byte shared accesses of 8 lanes hit distinct banks.  On the H100 at 33x33 chunks this
// took half the time of the same walk on its rows in device memory, and 10% less than a CTA of
// 64 columns.
//
// K6: one block per chunk, one thread per column.  Candidates are ordered as the
// reference orders them (surface: column z*16+x; cave: ((column*32 + layer)*2 + slot)).
// A block-wide exclusive prefix sum over the per-column valid counts gives every valid
// candidate its list position; the first `cap` are kept and `count` is the uncapped
// number.  Past the valid entries the list holds, like the reference's stable argsort,
// the first rejected candidates in order with feature 0.
//
// Bound on the H100: bytes for both (K5 reads and writes ~0.3 MB per chunk, K6 reads ~0.4 MB);
// K6's time is the strided reads of the dense cave grid.

#include "mmt_math.cuh"
#include "mmt_feature_tables.h"

using namespace mmt;

#define N_LAYERS MAX_CAVE_LAYERS_PER_COLUMN
#define N_CAVE_CAND (N_LAYERS * 2)
static_assert(N_LAYERS % 8 == 0, "the walk takes 4 layers a step and stores replace flags 8 at a time");

// isFeaturePos (feature_placement.py:49-61): is (wx, wz) the jittered point of its grid
// cell?  The seed is made in i32 and enters the hash as f32.
MMT_FN bool is_feature_pos(int wx, int wz, int cell, int padding, int seed) {
  float cellf = (float)cell;
  float gx = floorf((float)wx / cellf) * cellf;
  float gz = floorf((float)wz / cellf) * cellf;
  float rx, rz;
  rand2_from3(gx, gz, (float)seed, rx, rz);
  float internal = (float)(cell - 2 * padding);
  int px = (int)gx + padding + (int)floorf(rx * internal);
  int pz = (int)gz + padding + (int)floorf(rz * internal);
  return wx == px && wz == pz;
}

// one column's walk state
struct Column {
  int wx, wz, ground;
  uint32_t state;
  bool broken, surface_is_cave;
};

// cave layer li of the column: the feature and replace flag of its floor and ceiling slot
MMT_FN void cave_layer(Column& c, int li, int start, int end, int bottom_biome, int top_biome, int& feat0,
                       int& feat1, uint32_t& rep) {
  int layer_h = end - start;
  bool stop_here = start == Y_SIZE || c.ground <= start;
  bool active = !c.broken && !stop_here;
  feat0 = feat1 = 0;
  rep = 0u;
#pragma unroll 1
  for (int top = 0; top < 2; ++top) {
    // ceiling features only when the layer has a ceiling
    bool layer_ok = active && (top == 0 || end != Y_SIZE);
    int feat_out = 0;
    bool rep_out = false;
    if (layer_ok) {
      int biome = top ? top_biome : bottom_biome;
      int n_gens = (unsigned)biome < (unsigned)NUM_CAVE_BIOMES ? CG_COUNT[biome] : 0;
      int f_seed = top ? SEED_CAVE_TOP_F : SEED_CAVE_BOTTOM_F;
      int l_seed = top ? SEED_CAVE_TOP_L : SEED_CAVE_BOTTOM_L;
      int lava_y = top ? end : start + 1;
      for (int g = 0; g < n_gens; ++g) {
        float r = lcg_u01(&c.state);
        int f = CG_FEATURE[biome][g];
        bool ok = r < CG_CHANCE[biome][g] && (CG_FROM_CEILING[biome][g] != 0) == (top != 0) &&
                  (CG_IN_LAVA[biome][g] != 0 || lava_y > LAVA_LEVEL) &&
                  layer_h >= CG_MIN_HEIGHT[biome][g];
        if (ok && is_feature_pos(c.wx, c.wz, CG_CELL[biome][g], CG_PADDING[biome][g],
                                 f * f_seed + li * l_seed)) {
          feat_out = f;
          rep_out = CG_CAN_REPLACE[biome][g] != 0;
          break;  // placed: no further draw for this slot
        }
      }
    }
    if (top) feat1 = feat_out;
    else feat0 = feat_out;
    rep |= (rep_out ? 1u : 0u) << (8 * top);
  }
  bool surface_here = active && c.ground > start && c.ground <= end;
  c.surface_is_cave = c.surface_is_cave || surface_here;
  c.broken = c.broken || stop_here || surface_here;
}

// the column's 32 cave layers, 4 a step, from its input rows (starts, ends, bottom and top
// biomes) to its output rows: y = start + 1, height = end - start, features [32][2], replace
// flags [32][2] bytes.  y and height may overwrite starts and ends (a step reads before it writes).
// The 4 layers of a step go through ONE copy of cave_layer (a loop, not unrolled; unrolled, the
// kernel held 3x the SASS instructions and took twice the time on the H100): the layers' inputs
// shift out of the loaded words, a layer pair's features are stored as one word, the replace
// bytes shift into a register
MMT_FN void cave_walk(Column& c, const int4* starts, const int4* ends, const int4* bottom, const int4* top,
                      int4* y_out, int4* h_out, int4* feat_out, uint4* rep_out) {
  uint64_t rep_prev = 0u;
#pragma unroll 1
  for (int g = 0; g < N_LAYERS / 4; ++g) {
    int4 s = starts[g], e = ends[g];
    y_out[g] = make_int4(s.x + 1, s.y + 1, s.z + 1, s.w + 1);
    h_out[g] = make_int4(e.x - s.x, e.y - s.y, e.z - s.z, e.w - s.w);
    int4 bb = bottom[g], tb = top[g];
    int f_even = 0, f_odd = 0;  // the features of the pair's first layer (floor, ceiling)
    uint64_t rep = 0u;          // the 4 layers' 8 replace bytes, (layer, slot) in byte order
#pragma unroll 1
    for (int k = 0; k < 4; ++k) {
      int f0, f1;
      uint32_t r;
      cave_layer(c, 4 * g + k, s.x, e.x, bb.x, tb.x, f0, f1, r);
      s = make_int4(s.y, s.z, s.w, 0);
      e = make_int4(e.y, e.z, e.w, 0);
      bb = make_int4(bb.y, bb.z, bb.w, 0);
      tb = make_int4(tb.y, tb.z, tb.w, 0);
      if (k & 1) {
        feat_out[2 * g + (k >> 1)] = make_int4(f_even, f_odd, f0, f1);
      } else {
        f_even = f0;
        f_odd = f1;
      }
      rep = (rep >> 16) | ((uint64_t)r << 48);
    }
    if (g & 1)
      rep_out[g >> 1] = make_uint4((uint32_t)rep_prev, (uint32_t)(rep_prev >> 32), (uint32_t)rep,
                                   (uint32_t)(rep >> 32));
    else
      rep_prev = rep;
  }
}

// surface features of one randomly picked biome (coalesced: consecutive threads, consecutive
// columns)
MMT_FN void surface_walk(Column& c, int b, int col, float height, const float* __restrict__ w,
                         const float* __restrict__ layers, int* __restrict__ surface_feature,
                         int* __restrict__ surface_y, unsigned char* __restrict__ surface_replace) {
  int feat_out = 0;
  bool rep_out = false;
  if (!c.surface_is_cave) {
    float r_biome = lcg_u01(&c.state);
    int biome = BIOME_PLAINS;
    float running = 0.f;
    for (int k = 0; k < NUM_BIOMES; ++k) {
      running = running + w[(b * NUM_BIOMES + k) * 256 + col];
      if (r_biome - running <= 0.f) {
        biome = k;
        break;
      }
    }
    int n_gens = SG_COUNT[biome];
    for (int g = 0; g < n_gens; ++g) {
      float r = lcg_u01(&c.state);
      bool ok = r < SG_CHANCE[biome][g];
      // possibleTopLayers: one of the listed materials must be the top layer, thick enough
      int ntl = SG_N_TOP_LAYERS[biome][g];
      bool can_place = ntl == 0;
      for (int t = 0; t < ntl; ++t) {
        int mat = SG_TOP_LAYER_MAT[biome][g][t];
        int mat1 = mat + 1 < NUM_MATERIALS ? mat + 1 : NUM_MATERIALS - 1;
        float l_start = layers[(b * NUM_MATERIALS + mat) * 256 + col];
        float l_end = layers[(b * NUM_MATERIALS + mat1) * 256 + col];
        can_place = can_place || (l_start <= height && l_end >= height &&
                                  fminf(l_end, height) - l_start >= SG_TOP_LAYER_MIN[biome][g][t]);
      }
      int feat = SG_FEATURE[biome][g];
      if (ok && can_place &&
          is_feature_pos(c.wx, c.wz, SG_CELL[biome][g], SG_PADDING[biome][g], feat * SEED_SURFACE_POS)) {
        feat_out = feat;
        rep_out = SG_CAN_REPLACE[biome][g] != 0;
        break;
      }
    }
  }
  const int bc = b * 256 + col;
  surface_feature[bc] = feat_out;
  surface_y[bc] = c.ground + 1;
  surface_replace[bc] = rep_out ? 1 : 0;
}

MMT_FN Column column_start(const float* __restrict__ hf, const int* __restrict__ pos, int bc, float& height) {
  const int b = bc >> 8, col = bc & 255;
  height = hf[bc];
  Column c;
  c.wx = pos[2 * b] + (col & 15);
  c.wz = pos[2 * b + 1] + (col >> 4);
  c.ground = (int)height;
  c.state = seed_3(c.wx, c.wz, SEED_COLUMN);
  c.broken = c.surface_is_cave = false;
  return c;
}

// int4 words of a staged row: a 32-layer row (8, padded to 9), a feature row (16 + 1) and a
// replace row (4 + 1)
#define STAGE_ROW 9
#define STAGE_FEAT 17
#define STAGE_REP 5
// columns a CTA, a warp: 29.7 KB of shared memory, 7 CTAs an SM; at most 64 registers a thread
#define PLACEMENT_COLS 32
static_assert(256 % PLACEMENT_COLS == 0 && PLACEMENT_COLS % 32 == 0, "a CTA holds whole warps of one chunk");

__global__ void __launch_bounds__(PLACEMENT_COLS, 1024 / PLACEMENT_COLS) placements_kernel(
    const float* __restrict__ hf, const float* __restrict__ w, const float* __restrict__ layers,
    const int* __restrict__ starts, const int* __restrict__ ends,
    const int* __restrict__ bottom_biome, const int* __restrict__ top_biome,
    const int* __restrict__ pos, int* __restrict__ surface_feature, int* __restrict__ surface_y,
    unsigned char* __restrict__ surface_replace, int* __restrict__ cave_feature,
    int* __restrict__ cave_y, int* __restrict__ cave_height,
    unsigned char* __restrict__ cave_replace) {
  constexpr int T = PLACEMENT_COLS;
  __shared__ int4 rows[4 * T * STAGE_ROW];  // starts / y, ends / height, bottom and top biomes
  __shared__ int4 feat[T * STAGE_FEAT];
  __shared__ int4 rep[T * STAGE_REP];
  const int t = threadIdx.x, bc0 = blockIdx.x * T, bc = bc0 + t;
  const int4* in[4] = {(const int4*)starts, (const int4*)ends, (const int4*)bottom_biome,
                       (const int4*)top_biome};
#pragma unroll
  for (int a = 0; a < 4; ++a)
    for (int q = t; q < T * 8; q += T)
      rows[(a * T + (q >> 3)) * STAGE_ROW + (q & 7)] = in[a][(size_t)bc0 * 8 + q];
  __syncthreads();
  float height;
  Column c = column_start(hf, pos, bc, height);
  int4* mine = rows + t * STAGE_ROW;
  cave_walk(c, mine, mine + T * STAGE_ROW, mine + 2 * T * STAGE_ROW, mine + 3 * T * STAGE_ROW, mine,
            mine + T * STAGE_ROW, feat + t * STAGE_FEAT, (uint4*)(rep + t * STAGE_REP));
  surface_walk(c, bc >> 8, bc & 255, height, w, layers, surface_feature, surface_y, surface_replace);
  __syncthreads();
  int4* out[2] = {(int4*)cave_y, (int4*)cave_height};
#pragma unroll
  for (int a = 0; a < 2; ++a)
    for (int q = t; q < T * 8; q += T)
      out[a][(size_t)bc0 * 8 + q] = rows[(a * T + (q >> 3)) * STAGE_ROW + (q & 7)];
  for (int q = t; q < T * 16; q += T)
    ((int4*)cave_feature)[(size_t)bc0 * 16 + q] = feat[(q >> 4) * STAGE_FEAT + (q & 15)];
  for (int q = t; q < T * 4; q += T)
    ((int4*)cave_replace)[(size_t)bc0 * 4 + q] = rep[(q >> 2) * STAGE_REP + (q & 3)];
}

// exclusive prefix sum of one int per thread over a 256-thread block; *total gets the sum
MMT_FN int block_exclusive_scan_256(int v, int* s_warp, int* total) {
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    int n = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += n;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  int before = 0, sum = 0;
  for (int k = 0; k < 8; ++k) {
    if (k < warp) before += s_warp[k];
    sum += s_warp[k];
  }
  __syncthreads();  // s_warp may be reused by the next scan
  *total = sum;
  return before + incl - v;
}

__global__ void __launch_bounds__(256) compact_placements_kernel(
    const int* __restrict__ surface_feature, const int* __restrict__ surface_y,
    const unsigned char* __restrict__ surface_replace, const int* __restrict__ cave_feature,
    const int* __restrict__ cave_y, const int* __restrict__ cave_height,
    const unsigned char* __restrict__ cave_replace, const int* __restrict__ pos,
    int* __restrict__ s_feature, int* __restrict__ s_x, int* __restrict__ s_y,
    int* __restrict__ s_z, int* __restrict__ s_replace, int* __restrict__ s_count,
    int* __restrict__ c_feature, int* __restrict__ c_x, int* __restrict__ c_y,
    int* __restrict__ c_z, int* __restrict__ c_replace, int* __restrict__ c_height,
    int* __restrict__ c_count) {
  __shared__ int s_warp[8];
  int b = blockIdx.x, col = threadIdx.x;
  int bc = b * 256 + col;
  int wx = pos[2 * b] + (col & 15), wz = pos[2 * b + 1] + (col >> 4);

  // surface: one candidate per column
  int sf = surface_feature[bc];
  int valid = sf > 0 ? 1 : 0;
  int total;
  int before = block_exclusive_scan_256(valid, s_warp, &total);
  // valid candidates first, then the rejected ones, both in candidate order
  int slot = valid ? before : total + (col - before);
  if (slot < CHUNK_FEATURE_CAP) {
    int o = b * CHUNK_FEATURE_CAP + slot;
    s_feature[o] = valid ? sf : 0;
    s_x[o] = wx;
    s_y[o] = surface_y[bc];
    s_z[o] = wz;
    s_replace[o] = surface_replace[bc];
  }
  if (col == 0) s_count[b] = total;

  // cave: 32 layers x {floor, ceiling} candidates per column
  const int* cf = cave_feature + (size_t)bc * N_CAVE_CAND;
  int n_valid = 0;
  for (int k = 0; k < N_CAVE_CAND; ++k) n_valid += cf[k] > 0 ? 1 : 0;
  before = block_exclusive_scan_256(n_valid, s_warp, &total);
  int v_slot = before;                                // next valid candidate's position
  int r_slot = total + (col * N_CAVE_CAND - before);  // next rejected candidate's position
  for (int k = 0; k < N_CAVE_CAND; ++k) {
    int f = cf[k];
    int slot_k = f > 0 ? v_slot++ : r_slot++;
    if (slot_k < CHUNK_CAVE_FEATURE_CAP) {
      int o = b * CHUNK_CAVE_FEATURE_CAP + slot_k;
      c_feature[o] = f > 0 ? f : 0;
      c_x[o] = wx;
      c_y[o] = cave_y[bc * N_LAYERS + (k >> 1)];
      c_z[o] = wz;
      c_height[o] = cave_height[bc * N_LAYERS + (k >> 1)];
      c_replace[o] = cave_replace[(size_t)bc * N_CAVE_CAND + k];
    }
  }
  if (col == 0) c_count[b] = total;
}

// every row pointer must be 16-byte aligned (the wrapper checks)
extern "C" int mmt_placements(const float* hf, const float* w, const float* layers,
                              const int* starts, const int* ends, const int* bottom_biome,
                              const int* top_biome, const int* pos, int B, int* surface_feature,
                              int* surface_y, unsigned char* surface_replace, int* cave_feature,
                              int* cave_y, int* cave_height, unsigned char* cave_replace,
                              void* stream) {
  placements_kernel<<<B * (256 / PLACEMENT_COLS), PLACEMENT_COLS, 0, (cudaStream_t)stream>>>(
      hf, w, layers, starts, ends, bottom_biome, top_biome, pos, surface_feature, surface_y,
      surface_replace, cave_feature, cave_y, cave_height, cave_replace);
  return (int)cudaGetLastError();
}

extern "C" int mmt_compact_placements(
    const int* surface_feature, const int* surface_y, const unsigned char* surface_replace,
    const int* cave_feature, const int* cave_y, const int* cave_height,
    const unsigned char* cave_replace, const int* pos, int B, int* s_feature, int* s_x, int* s_y,
    int* s_z, int* s_replace, int* s_count, int* c_feature, int* c_x, int* c_y, int* c_z,
    int* c_replace, int* c_height, int* c_count, void* stream) {
  compact_placements_kernel<<<B, 256, 0, (cudaStream_t)stream>>>(
      surface_feature, surface_y, surface_replace, cave_feature, cave_y, cave_height, cave_replace,
      pos, s_feature, s_x, s_y, s_z, s_replace, s_count, c_feature, c_x, c_y, c_z, c_replace,
      c_height, c_count);
  return (int)cudaGetLastError();
}
