// K5: feature placement grids, and K6: their compaction into per-chunk lists.
//
// K5 replaces mega_minecraft_tpu/terrain/feature_placement.py:92 generate_placements,
// K6 replaces feature_placement.py:256 compact_placements (jitted XLA on the TPU).
//
// K5: one CUDA block per chunk, one thread per column.  The thread walks its column's
// 32 cave layers in order (floor gens, then ceiling gens) and then the surface gens of
// one randomly picked biome, on ONE sequential minstd stream that advances only where
// the reference's control flow draws: a draw for gen g happens iff the layer is live,
// nothing is placed in this slot yet and g < count[biome].  The JAX program drew for
// every column with a mask and looked its tables up with compare/select chains; a
// thread here branches and indexes the tables.  The two sin-hashes of is_feature_pos are
// evaluated last, only when every cheaper condition holds (they have no side effect).
//
// K6: one block per chunk, one thread per column.  Candidates are ordered as the
// reference orders them (surface: column z*16+x; cave: ((column*32 + layer)*2 + slot)).
// A block-wide exclusive prefix sum over the per-column valid counts gives every valid
// candidate its list position; the first `cap` are kept and `count` is the uncapped
// number.  Past the valid entries the list holds, like the reference's stable argsort,
// the first rejected candidates in order with feature 0.
//
// Bound on the H100: both are far below the card's rates (K5 reads ~0.3 MB and K6
// ~0.4 MB per chunk); K5's time is the serial chain of draws and sin-hashes per thread,
// K6's the strided reads of the dense cave grid.

#include "mmt_math.cuh"
#include "mmt_feature_tables.h"

using namespace mmt;

#define N_LAYERS MAX_CAVE_LAYERS_PER_COLUMN
#define N_CAVE_CAND (N_LAYERS * 2)

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

__global__ void __launch_bounds__(256) placements_kernel(
    const float* __restrict__ hf, const float* __restrict__ w, const float* __restrict__ layers,
    const int* __restrict__ starts, const int* __restrict__ ends,
    const int* __restrict__ bottom_biome, const int* __restrict__ top_biome,
    const int* __restrict__ pos, int* __restrict__ surface_feature, int* __restrict__ surface_y,
    unsigned char* __restrict__ surface_replace, int* __restrict__ cave_feature,
    int* __restrict__ cave_y, int* __restrict__ cave_height,
    unsigned char* __restrict__ cave_replace) {
  int b = blockIdx.x, col = threadIdx.x;
  int bc = b * 256 + col;
  int wx = pos[2 * b] + (col & 15), wz = pos[2 * b + 1] + (col >> 4);
  float height = hf[bc];
  int ground = (int)height;
  uint32_t state = seed_3(wx, wz, SEED_COLUMN);

  bool broken = false, surface_is_cave = false;
  for (int li = 0; li < N_LAYERS; ++li) {
    int start = starts[bc * N_LAYERS + li], end = ends[bc * N_LAYERS + li];
    int layer_h = end - start;
    bool stop_here = start == Y_SIZE || ground <= start;
    bool active = !broken && !stop_here;
    for (int top = 0; top < 2; ++top) {
      // ceiling features only when the layer has a ceiling
      bool layer_ok = active && (top == 0 || end != Y_SIZE);
      int feat_out = 0;
      bool rep_out = false;
      if (layer_ok) {
        int biome = (top ? top_biome : bottom_biome)[bc * N_LAYERS + li];
        int n_gens = (unsigned)biome < (unsigned)NUM_CAVE_BIOMES ? CG_COUNT[biome] : 0;
        int f_seed = top ? SEED_CAVE_TOP_F : SEED_CAVE_BOTTOM_F;
        int l_seed = top ? SEED_CAVE_TOP_L : SEED_CAVE_BOTTOM_L;
        int lava_y = top ? end : start + 1;
        for (int g = 0; g < n_gens; ++g) {
          float r = lcg_u01(&state);
          int feat = CG_FEATURE[biome][g];
          bool ok = r < CG_CHANCE[biome][g] && (CG_FROM_CEILING[biome][g] != 0) == (top != 0) &&
                    (CG_IN_LAVA[biome][g] != 0 || lava_y > LAVA_LEVEL) &&
                    layer_h >= CG_MIN_HEIGHT[biome][g];
          if (ok && is_feature_pos(wx, wz, CG_CELL[biome][g], CG_PADDING[biome][g],
                                   feat * f_seed + li * l_seed)) {
            feat_out = feat;
            rep_out = CG_CAN_REPLACE[biome][g] != 0;
            break;  // placed: no further draw for this slot
          }
        }
      }
      cave_feature[(bc * N_LAYERS + li) * 2 + top] = feat_out;
      cave_replace[(bc * N_LAYERS + li) * 2 + top] = rep_out ? 1 : 0;
    }
    cave_y[bc * N_LAYERS + li] = start + 1;
    cave_height[bc * N_LAYERS + li] = layer_h;
    bool surface_here = active && ground > start && ground <= end;
    surface_is_cave = surface_is_cave || surface_here;
    broken = broken || stop_here || surface_here;
  }

  // surface features of one randomly picked biome
  int feat_out = 0;
  bool rep_out = false;
  if (!surface_is_cave) {
    float r_biome = lcg_u01(&state);
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
      float r = lcg_u01(&state);
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
          is_feature_pos(wx, wz, SG_CELL[biome][g], SG_PADDING[biome][g], feat * SEED_SURFACE_POS)) {
        feat_out = feat;
        rep_out = SG_CAN_REPLACE[biome][g] != 0;
        break;
      }
    }
  }
  surface_feature[bc] = feat_out;
  surface_y[bc] = ground + 1;
  surface_replace[bc] = rep_out ? 1 : 0;
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

extern "C" int mmt_placements(const float* hf, const float* w, const float* layers,
                              const int* starts, const int* ends, const int* bottom_biome,
                              const int* top_biome, const int* pos, int B, int* surface_feature,
                              int* surface_y, unsigned char* surface_replace, int* cave_feature,
                              int* cave_y, int* cave_height, unsigned char* cave_replace,
                              void* stream) {
  placements_kernel<<<B, 256, 0, (cudaStream_t)stream>>>(
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
