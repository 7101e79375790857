// K3: caves + cave biomes.
//
// Replaces mega_minecraft_tpu/terrain/caves.py:175 generate_caves (jitted XLA on the
// TPU).  Two launches:
//   1. carve_kernel: the 3-D carve test of every block below CARVE_Y_MAX = 144 (caves.py:
//      51-70), written as one byte per block to a [B, 256, 144] scratch.  One CTA of 256
//      threads takes a tile of one chunk, 4 x 4 columns by 16 y, one block a thread.  The
//      test is a threshold (two fbm3 of 4 octaves, the top / bottom ratios) and a Worley
//      ratio (special_cave_noise) at a domain-warped point (fbm3_from3, 5 octaves).  The
//      Worley search hashes 27 cells, 81 correctly rounded sins a block, but its cells are
//      ~200 blocks wide: a tile's warped points fall in one or two cells an axis.  So the
//      CTA (a) evaluates the threshold and, where it exceeds 0.04 (elsewhere the block is
//      not carved whatever the noise), the warped point, kept in registers; (b) reduces the
//      floor cells' min / max over the tile, adds the +-1 ring and fills a shared-memory
//      table with rand3_from3 of each cell of that box, one hash (one component of one cell)
//      a thread; (c) runs the 27-cell search on table reads
//      (mmt_math.cuh special_cave_noise_table: the same distances, selects and order, so the
//      result is the direct search's bit for bit).  A box of more cells than the table holds
//      (the launch argument table_cells, terrain/caves.py CELL_TABLE_CAP; 0 forces it) takes
//      the direct path, hashing as special_cave_noise does; each such CTA adds one to
//      stats[0], and stats[1] keeps the largest box (cells) any CTA saw.
//   2. column_kernel, one CTA of four warps per 32 columns: the columns' carve bands are
//      staged in shared memory (coalesced words); one lane a column computes the
//      above-surface and ravine thresholds and walks the column's y in ascending order,
//      keeping its flips ("filled" changes between y and y+1) -- the JAX program's sort of
//      flip positions, including its truncation to the first 64 flips -- as the layers'
//      starts and ends in shared memory; the valid layer edges of the 32 columns are then
//      listed (ballot + popc) and their cave biomes computed one edge a thread over the
//      four warps; the outputs leave as coalesced 32 x 32 blocks.  (A warp a column, as
//      before, spent 32 lanes on each column's ravine and left most lanes idle at the
//      edges: 9.1 of 65.6 ms at 33x33, 14% of K3 then, 42% once the carve test was fast.)
//
// Bound on the H100: arithmetic in carve_kernel.  The function needs the threshold of every
// block, the warp and the Worley search only where the threshold exceeds 0.04 (about 90% of
// the band on land, less near the sea), and each distinct cell's jitter once: so the bound
// counts the threshold a block (3,296 operations), the warp and the search without their 81
// hashes an active block (7,266), and three hashes per distinct cell that a chunk's active
// blocks read (chip_smoke.py op_counts).  The table takes the hashes to a few hundred a
// tile of 256 blocks.  The bound prices operations at 67 TFLOP/s, the rate of fused
// multiply-adds; built with -fmad=false every add and multiply issues alone, so the kernel
// can reach half of it.
// The scratch is 144 bytes per column.

#include <limits.h>

#include "mmt_math.cuh"

using namespace mmt;

// the threshold of the 3-D 'carved' term (caves.py:51-70); n* = w* * 0.005
MMT_FN float carve_threshold(float nx, float ny, float nz, float wyf, float ocean_beach) {
  float top_ratio = smoothstep(142.f, 95.f, wyf + ocean_beach * 50.f);
  float bottom_ratio = smoothstep(5.f, 20.f, wyf);
  float thr = F(0.24) + F(0.12) * fbm3(nx * 4.f, ny * 4.f, nz * 4.f, 4);
  float huge = smoothstep(F(0.2), F(0.4), fbm3(nx * F(0.07), ny * F(0.07), nz * F(0.07), 4));
  thr = thr * (1.f + F(1.4) * huge);
  return thr * top_ratio * (F(0.3) + F(0.7) * bottom_ratio);
}

// the domain-warped point of special_cave_noise (caves.py:57-59)
MMT_FN void carve_warp(float nx, float ny, float nz, float& px, float& py, float& pz) {
  float ox, oy, oz;
  fbm3_from3(nx * F(0.8), ny * F(0.8), nz * F(0.8), 5, ox, oy, oz);
  px = nx + ox * F(1.8);
  py = ny * F(1.6) + oy * F(1.8);
  pz = nz + oz * F(1.8);
}

// per-column ravine threshold (caves.py:73-98): 1e9 where there is no ravine
MMT_FN float ravine_min_y(float wxf, float wzf, float ocean_beach) {
  float rx = wxf * F(0.0015), rz = wzf * F(0.0015);
  float wofx, wofz;
  fbm2_from2(rx * 10.f, rz * 10.f, 4, wofx, wofz);
  float f1, edge, cpx, cpy;
  worley2(rx + F(0.03) * wofx, rz + F(0.03) * wofz, f1, edge, cpx, cpy);
  float rav_thr = F(0.12) * (1.f - ocean_beach);
  bool in_rav_cell = f1 < rav_thr;
  float rav_top = 120.f + 24.f * rand3_from2_x(cpx, cpy);
  float rav_ratio = 1.f - f1 / rav_thr;
  float rav_depth = 60.f + 26.f * fbm2(rx * 8.f + F(8391.32), rz * 8.f + F(4821.39), 4);
  rav_depth = rav_depth * smoothstep(0.f, F(0.3), rav_ratio);
  float wave_off = 4.f * fbm2(rx * 3.f + F(5129.32), rz * 3.f + F(1392.49), 4);
  float wave = smoothstep(F(0.4), F(0.6), sinf((rx + rz) * 15.f + wave_off));
  rav_depth = rav_depth * wave;
  return (in_rav_cell && rav_depth > F(0.0001)) ? rav_top - rav_depth : F(1e9);
}

// sum of the ocean + beach biome weights of one column, in biome order
MMT_FN float ocean_beach_weight(const float* w, int b, int col) {
  float acc = w[(b * NUM_BIOMES) * 256 + col];
  for (int k = 1; k < NUM_OCEAN_AND_BEACH_BIOMES; ++k) acc = acc + w[(b * NUM_BIOMES + k) * 256 + col];
  return acc;
}

#define CARVE_THREADS 256
#define CARVE_TILES (16 * (CARVE_Y_MAX / 16))  // tiles a chunk: 4 x 4 column groups x 9 y slabs

__global__ void __launch_bounds__(CARVE_THREADS)
carve_kernel(const float* __restrict__ w, const int* __restrict__ pos, int table_cells,
             unsigned char* __restrict__ carved, int* __restrict__ stats) {
  extern __shared__ float table[];  // [3][table_cells]: rand3_from3 components of the box
  __shared__ int lo[3], hi[3];
  const int t = threadIdx.x, lane = t & 31;
  const int b = blockIdx.x / CARVE_TILES, r = blockIdx.x - b * CARVE_TILES;
  const int cg = r / (CARVE_Y_MAX / 16), ys = r - cg * (CARVE_Y_MAX / 16);
  const int y = ys * 16 + (t & 15), c = t >> 4;
  const int lx = (cg & 3) * 4 + (c & 3), lz = (cg >> 2) * 4 + (c >> 2), col = lz * 16 + lx;
  if (t < 3) {
    lo[t] = INT_MAX;
    hi[t] = INT_MIN;
  }
  __syncthreads();

  // (a) the threshold, and the warped point where the threshold can carve
  float wxf = (float)(pos[2 * b] + lx), wzf = (float)(pos[2 * b + 1] + lz), wyf = (float)y;
  float nx = wxf * F(0.0050), ny = wyf * F(0.0050), nz = wzf * F(0.0050);
  float thr = carve_threshold(nx, ny, nz, wyf, ocean_beach_weight(w, b, col));
  bool active = thr > F(0.04);
  float px = 0.f, py = 0.f, pz = 0.f;
  if (active) carve_warp(nx, ny, nz, px, py, pz);
  // the table is keyed by the integer cell (mmt_math.cuh TableJitter)
  int cx = (int)floorf(px), cy = (int)floorf(py), cz = (int)floorf(pz);

  // (b) the cell box of the tile's active blocks, with the +-1 ring
  int v[6] = {active ? cx : INT_MAX, active ? cy : INT_MAX, active ? cz : INT_MAX,
              active ? cx : INT_MIN, active ? cy : INT_MIN, active ? cz : INT_MIN};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    v[k] = __reduce_min_sync(0xffffffffu, v[k]);
    v[k + 3] = __reduce_max_sync(0xffffffffu, v[k + 3]);
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      atomicMin(&lo[k], v[k]);
      atomicMax(&hi[k], v[k + 3]);
    }
  }
  __syncthreads();
  const int out = (b * 256 + col) * CARVE_Y_MAX + y;
  if (hi[0] < lo[0]) {  // no block of the tile can carve
    carved[out] = 0;
    return;
  }
  const int x0 = lo[0] - 1, y0 = lo[1] - 1, z0 = lo[2] - 1;
  // the box's edges, each capped at 2^20 so that their product fits
  const long long nxc = min((long long)hi[0] - x0 + 2, 1LL << 20),
                  nyc = min((long long)hi[1] - y0 + 2, 1LL << 20),
                  nzc = min((long long)hi[2] - z0 + 2, 1LL << 20);
  const long long cells = nxc * nyc * nzc;
  const bool direct = cells > table_cells;
  if (t == 0 && stats != nullptr) {
    if (direct) atomicAdd(&stats[0], 1);
    int seen = cells > INT_MAX ? INT_MAX : (int)cells;
    if (seen > *(volatile int*)&stats[1]) atomicMax(&stats[1], seen);
  }
  if (!direct) fill_jitter_table(table, (int)cells, x0, y0, z0, (int)nyc, (int)nzc, t, CARVE_THREADS);
  __syncthreads();

  // (c) the Worley ratio on the table (or hashed, on the direct path)
  bool cut = false;
  if (active) {
    float cave_noise = direct ? special_cave_noise(px, py, pz)
                              : special_cave_noise_table(px, py, pz, table, (int)cells, x0, y0, z0,
                                                         (int)nyc, (int)nzc);
    cut = cave_noise < thr;
  }
  carved[out] = cut ? 1 : 0;
}

#define COL_THREADS 128  // a CTA of column_kernel takes 32 consecutive columns

__global__ void __launch_bounds__(COL_THREADS)
column_kernel(const float* __restrict__ hf, const float* __restrict__ w, const int* __restrict__ pos,
              const int* __restrict__ cave_w, const unsigned char* __restrict__ carved,
              int* __restrict__ starts, int* __restrict__ ends, int* __restrict__ bottom,
              int* __restrict__ top) {
  static_assert(MAX_CAVE_LAYERS_PER_COLUMN == 32, "one lane a layer");
  static_assert(CARVE_Y_MAX % 4 == 0, "the carve band moves in words");
  constexpr int BAND_WORDS = CARVE_Y_MAX / 4, ROW_WORDS = BAND_WORDS + 1;  // + 1: no bank conflicts
  // the 32 columns' carve bands, their 32 layers of each output (rows padded to 33 words),
  // and the list of their valid layer edges
  __shared__ unsigned int s_band[32 * ROW_WORDS];
  __shared__ int S[32][33], E[32][33], s_bottom[32][33], s_top[32][33];
  __shared__ unsigned short s_items[2 * 32 * 32];
  __shared__ int s_n_items;
  const int t = threadIdx.x, lane = t & 31;
  const int col0 = blockIdx.x * 32;  // b * 256 + col of the first column; 256 % 32 == 0

  // the carve bands, coalesced
  const unsigned int* band = reinterpret_cast<const unsigned int*>(carved + (size_t)col0 * CARVE_Y_MAX);
  for (int i = t; i < 32 * BAND_WORDS; i += COL_THREADS) s_band[(i / BAND_WORDS) * ROW_WORDS + i % BAND_WORDS] = band[i];
  __syncthreads();

  if (t < 32) {
    // lane = column: the above-surface and ravine thresholds, then the column's flips
    // ("filled" changes between y and y + 1) in ascending y, the first 2 * 32 of them kept,
    // as the JAX program's sort of flip positions
    const int bc = col0 + lane, b = bc >> 8, col = bc & 255;
    const float surf = fmax_nan(floorf(hf[bc]), (float)SEA_LEVEL);
    const float rav = ravine_min_y((float)(pos[2 * b] + (col & 15)), (float)(pos[2 * b + 1] + (col >> 4)),
                                   ocean_beach_weight(w, b, col));
    const unsigned int* cv = s_band + lane * ROW_WORDS;
    auto filled = [&](int y) {
      if (y >= Y_SIZE) return false;  // past the top: the reference's zero padding
      float yf = (float)y;
      bool carve = y < CARVE_Y_MAX && ((cv[y >> 2] >> ((y & 3) * 8)) & 0xffu);
      bool cave = yf > surf || carve || yf > rav;
      return !(y != 0 && cave);
    };
    int count = 0;
    bool prev = filled(0);
    for (int y = 0; y < Y_SIZE; ++y) {
      bool cur = filled(y + 1);
      if (cur != prev) {
        if (count < 2 * MAX_CAVE_LAYERS_PER_COLUMN) {
          if (count & 1) E[lane][count >> 1] = y;
          else S[lane][count >> 1] = y;
        }
        ++count;
      }
      prev = cur;
    }
    for (int k = (count + 1) >> 1; k < MAX_CAVE_LAYERS_PER_COLUMN; ++k) S[lane][k] = Y_SIZE;
    for (int k = count >> 1; k < MAX_CAVE_LAYERS_PER_COLUMN; ++k) E[lane][k] = Y_SIZE;
    __syncwarp();

    // lane = layer: the defaults of the layers with no edge, and the list of valid edges
    // (item = (column * 32 + layer) * 2 + top)
    int n_items = 0;
    for (int j = 0; j < 32; ++j) {
      const bool has_b = S[j][lane] != Y_SIZE, has_t = E[j][lane] != Y_SIZE;
      if (!has_b) s_bottom[j][lane] = 0;
      if (!has_t) s_top[j][lane] = CAVE_NONE;
      const unsigned mb = __ballot_sync(0xffffffffu, has_b), mt = __ballot_sync(0xffffffffu, has_t);
      const unsigned below = (1u << lane) - 1u;
      if (has_b) s_items[n_items + __popc(mb & below)] = (unsigned short)((j * 32 + lane) * 2);
      n_items += __popc(mb);
      if (has_t) s_items[n_items + __popc(mt & below)] = (unsigned short)((j * 32 + lane) * 2 + 1);
      n_items += __popc(mt);
    }
    if (lane == 0) s_n_items = n_items;
  }
  __syncthreads();

  // thread = item: the cave biome at each valid layer edge, over the CTA's four warps
  for (int i = t; i < s_n_items; i += COL_THREADS) {
    const int item = s_items[i], is_top = item & 1, k = (item >> 1) & 31, j = item >> 6;
    const int bc = col0 + j, b = bc >> 8, col = bc & 255;
    const int wx = pos[2 * b] + (col & 15), wz = pos[2 * b + 1] + (col >> 4);
    if (is_top)
      s_top[j][k] = cave_biome(wx, E[j][k] + 1, wz, hf[bc], SEED_TOP_BIOME, cave_w, NUM_CAVE_BIOMES);
    else
      s_bottom[j][k] = cave_biome(wx, S[j][k], wz, hf[bc], SEED_BOTTOM_BIOME, cave_w, NUM_CAVE_BIOMES);
  }
  __syncthreads();

  // the 32 x 32 block of each output, coalesced
  const size_t base = (size_t)col0 * MAX_CAVE_LAYERS_PER_COLUMN;
  for (int i = t; i < 32 * 32; i += COL_THREADS) {
    starts[base + i] = S[i >> 5][i & 31];
    ends[base + i] = E[i >> 5][i & 31];
    bottom[base + i] = s_bottom[i >> 5][i & 31];
    top[base + i] = s_top[i >> 5][i & 31];
  }
}

extern "C" int mmt_caves(const float* hf, const float* w, const int* pos, int B, const int* cave_w,
                         int table_cells, int* stats, unsigned char* carved, int* starts, int* ends,
                         int* bottom, int* top, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  size_t smem = (size_t)table_cells * 3 * sizeof(float);  // <= 48 KB (kernels.MAX_TABLE_CELLS)
  carve_kernel<<<B * CARVE_TILES, CARVE_THREADS, smem, st>>>(w, pos, table_cells, carved, stats);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  column_kernel<<<B * 256 / 32, COL_THREADS, 0, st>>>(hf, w, pos, cave_w, carved, starts, ends, bottom, top);
  return (int)cudaGetLastError();
}
