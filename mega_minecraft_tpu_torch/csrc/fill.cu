// K4: chunk fill -- a u8 block id for every block of [B, 16, 16, 384].
//
// Replaces mega_minecraft_tpu/terrain/fill.py:283 fill_chunks (jitted XLA on the TPU).  The
// JAX program evaluated every post-process noise for every block (SIMD lanes cannot branch)
// and selected; here a block evaluates a noise only where its mask can select the result --
// the mesa strata simplex only for mesa blocks, the cave biome (fbm3_from3 + 2 simplex3 + 4
// fbm2) only for solid stone-like blocks below y = 192, the quartz simplex and the clay Worley
// only for their cave biome.  Unselected values are discarded in JAX, so the result is the same.
//
// Bound on the H100: arithmetic.  What costs is rare: ~20% of the blocks take the cave biome
// (6,513 operations), ~0.3% the lush caves' clay test (fbm3_from3 and a 27-cell Worley F1 whose
// 81 correctly rounded sins are 88% of its 41,809 operations).  A warp of 32 consecutive y of
// one column paid for its slowest lane, so one CTA of 256 threads takes a tile of FILL_COLS = 8
// consecutive columns of one chunk (half a row, 3,072 blocks) and packs the rare work into full
// warps (the ~720 queued blocks of a tile fill nearly three rounds of 256 lanes; 4 columns left
// the second of two rounds 40% full, 13% slower on the H100):
//   0. the columns' biome weights, layer starts, cave layers and heights go to shared memory;
//      their 7 x 4 per-column fields are computed by warp f (field f), lane c (column c);
//   1. every block runs the cascade up to the biome post-process (fill_block_cascade: seeded
//      biome pick, cave-depth scan, material and grass, quartz towers, bedrock / air / water /
//      cave / lava priority), its byte to shared memory; a block that the cave-biome post-process
//      can change (below y = 192, solid, no quartz tower, stone-like) goes to a queue (warp
//      ballot + one shared atomic a warp) with its cave depths;
//   2. the threads take the queue's entries: the cave biome, the crystal, warped and amber
//      branches and the lush caves' near test; a near lush block goes to a second queue;
//   3. the second queue's clay points (fbm3_from3) go to shared memory, their floor cells' box
//      with the +-1 ring is reduced, and a table of rand3_from3 of every cell of the box is
//      filled, one hash a thread (mmt_math.cuh fill_jitter_table); the 27-cell F1 search then
//      reads the table (worley3_f1_search with a TableJitter: the direct search's result bit
//      for bit).  A box of more cells than the launch's table_cells (terrain/fill.py
//      LUSH_TABLE_CELLS, at most the static table; 0 forces it) takes the direct path, hashing
//      as worley3_f1 does: no bound on the box holds at every int32 position, since past 2^24
//      the noise's own rounding leaves the simplex cell and the fBm offsets are unbounded by
//      its in-cell amplitude;
//   4. the tile's 3,072 bytes leave as 16-byte stores.
// stats (optional, i32 [4]) counts: blocks queued for the cave biome, lush blocks (the second
// queue), the largest cell box (cells) a tile saw, tiles that took the direct path.

#include <limits.h>

#include "mmt_math.cuh"

using namespace mmt;

// per-column fields (fill.py:103,118,144,181,191,203,213)
enum { FLD_QUARTZ = 0, FLD_DIRT_H, FLD_TSH, FLD_MUD_END, FLD_SSH, FLD_SNOW_H, FLD_MYC_RAND, N_FIELDS };

MMT_FN float column_field(int i, float wx, float wz) {
  const float sea = (float)SEA_LEVEL;
  switch (i) {
    case FLD_QUARTZ: return 140.f + 15.f * fbm2(wx * F(0.0080), wz * F(0.0080), 3);
    case FLD_DIRT_H: return (sea + 1.5f) + F(1.7) * fbm2(wx * F(0.0065), wz * F(0.0065), 3);
    case FLD_TSH: return 108.f + 12.f * fbm2(wx * F(0.0040), wz * F(0.0040), 3);
    case FLD_MUD_END: return (sea + F(0.8)) + F(1.1) * simplex2(wx * F(0.0300), wz * F(0.0300));
    case FLD_SSH: return 112.f + 16.f * fbm2(wx * F(0.0200), wz * F(0.0200), 3);
    case FLD_SNOW_H: return 202.f + 5.f * fbm2(wx * F(0.0500), wz * F(0.0500), 3);
    default: return rand1_from2(wx + 913213.f, wz + 85941.f);  // FLD_MYC_RAND
  }
}

MMT_FN int terracotta(float sample_h) {
  return sample_h < 5.f    ? BLOCK_TERRACOTTA
         : sample_h < 8.f  ? BLOCK_ORANGE_TERRACOTTA
         : sample_h < 12.f ? BLOCK_RED_TERRACOTTA
         : sample_h < 14.f ? BLOCK_WHITE_TERRACOTTA
         : sample_h < 20.f ? BLOCK_TERRACOTTA
         : sample_h < 21.f ? BLOCK_ORANGE_TERRACOTTA
         : sample_h < 26.f ? BLOCK_YELLOW_TERRACOTTA
         : sample_h < 29.f ? BLOCK_PURPLE_TERRACOTTA
                           : BLOCK_TERRACOTTA;
}

// biome post-process (fill.py:111-221); at most one branch matches rand_biome
MMT_FN int biome_postprocess(int block, int rb, float wx, float wyf, float wz, bool is_top,
                             const float* fld) {
  if (rb == BIOME_ARCHIPELAGO && wyf >= (float)SEA_LEVEL && block != BLOCK_WATER &&
      wyf > fld[FLD_DIRT_H])
    block = is_top ? BLOCK_GRASS_BLOCK : BLOCK_DIRT;
  if (rb == BIOME_TROPICAL_BEACH && is_top && block != BLOCK_SMOOTH_SAND && block != BLOCK_WATER)
    block = BLOCK_SMOOTH_SAND;
  if (rb == BIOME_BEACH && is_top && block != BLOCK_SAND && block != BLOCK_WATER) block = BLOCK_SAND;
  float tsh = fld[FLD_TSH];
  if (rb == BIOME_MESA && wyf >= 90.f && block != BLOCK_WATER && wyf >= tsh &&
      !(block == BLOCK_CLAY && wyf < tsh + 20.f)) {
    float sample_h = wyf + 3.f * simplex3(wx * F(0.0100), wz * F(0.0100), wyf * F(0.0300)) - tsh;
    sample_h = sample_h - floorf(sample_h / 32.f) * 32.f;
    block = terracotta(sample_h);
  }
  if (rb == BIOME_FROZEN_WASTELAND && block == BLOCK_WATER) block = BLOCK_PACKED_ICE;
  if (rb == BIOME_SHREKS_SWAMP && wyf >= 100.f &&
      (block == BLOCK_DIRT || block == BLOCK_JUNGLE_GRASS_BLOCK) && wyf < fld[FLD_MUD_END])
    block = BLOCK_MUD;
  if (rb == BIOME_TIANZI_MOUNTAINS && wyf >= 90.f && block != BLOCK_WATER && block != BLOCK_DIRT &&
      block != BLOCK_GRASS_BLOCK && wyf >= fld[FLD_SSH])
    block = BLOCK_SMOOTH_SANDSTONE;
  if (rb == BIOME_CRYSTALS && is_top && block != BLOCK_QUARTZ && fld[FLD_MYC_RAND] < F(0.1))
    block = BLOCK_MYCELIUM;
  if (rb == BIOME_MOUNTAINS && wyf >= 190.f && wyf >= fld[FLD_SNOW_H]) block = BLOCK_SNOW;
  return block;
}

MMT_FN bool stone_like(int block) {
  return block == BLOCK_STONE || block == BLOCK_DEEPSLATE || block == BLOCK_BLACKSTONE;
}

#define LUSH_NEAR (-1)

// cave-biome post-process (fill.py:224-280) of a stone-like block, but for the lush caves' clay
// test: a near block of a lush cave returns LUSH_NEAR (clay or moss by lush_clay_point's F1)
MMT_FN int cave_biome_stone(int block, int wx, int y, int wz, float hfv, int bottom_d, int top_d,
                            const int* cave_w) {
  int cb = cave_biome(wx, y, wz, hfv, SEED_FILL_CAVE_BIOME, cave_w, NUM_CAVE_BIOMES);
  float wxf = (float)wx, wyf = (float)y, wzf = (float)wz;
  if (cb == CAVE_CRYSTAL_CAVES) {
    float qn = simplex3((wxf + wyf) * F(0.05), (wzf + F(5819323.0)) * F(0.05),
                        ((wxf + wzf) * 2.f) * F(0.05));
    if (qn < F(-0.25)) return BLOCK_QUARTZ;
    float r = rand1_from3(wxf, wyf, wzf);
    if (block == BLOCK_STONE && r < 0.5f) return BLOCK_COBBLESTONE;
    if (block == BLOCK_DEEPSLATE && r < F(0.4)) return BLOCK_COBBLED_DEEPSLATE;
    return block;
  }
  if (cb == CAVE_LUSH_CAVES) {
    float thr = F(1.5) + F(4.5) * simplex3(wxf * F(0.025), wyf * F(0.025), wzf * F(0.025));
    float bd = (float)bottom_d, td = (float)top_d;
    bool near = (bd >= 0.f && bd <= thr) || (td >= 0.f && td <= thr);
    return near ? LUSH_NEAR : block;
  }
  if ((cb == CAVE_WARPED_FOREST || cb == CAVE_AMBER_FOREST) && bottom_d == 0) {
    bool warped = cb == CAVE_WARPED_FOREST;
    if (block == BLOCK_DEEPSLATE) return warped ? BLOCK_WARPED_DEEPSLATE : BLOCK_AMBER_DEEPSLATE;
    if (block == BLOCK_BLACKSTONE) return warped ? BLOCK_WARPED_BLACKSTONE : BLOCK_AMBER_BLACKSTONE;
  }
  return block;
}

// the point of a lush near block's clay Worley F1 (fill.py:263-265): clay where F1 < 0.25
MMT_FN void lush_clay_point(int wx, int y, int wz, float& px, float& py, float& pz) {
  float nx = (float)wx * F(0.025), ny = (float)y * F(0.025), nz = (float)wz * F(0.025);
  float ny2 = ny + F(192031.9821);
  float ox, oy, oz;
  fbm3_from3(nx * F(0.4), ny2 * F(0.4), nz * F(0.4), 3, ox, oy, oz);
  px = nx + ox * 2.f;
  py = ny2 + oy * 2.f;
  pz = nz + oz * 2.f;
}

// one block of one column up to the biome post-process; w [24], lay [20], st / en [32] and
// fld [N_FIELDS] are the column's values.  cave_stone: the cave-biome post-process applies
// (below CAVE_BIOME_Y_MAX, solid, no quartz tower, stone-like), with the block's cave depths.
MMT_FN int fill_block_cascade(int y, int wx, int wz, float hfv, const float* w, const float* lay,
                              const int* st, const int* en, const float* fld, const int* grass_tab,
                              const int* mat_block, int& bottom_d, int& top_d, bool& cave_stone) {
  float wyf = (float)y;
  // seeded random-biome pick: first biome whose running weight reaches u, else PLAINS
  uint32_t state = seed_3(wx, y, wz);
  float u = lcg_u01(&state);
  int rb = BIOME_PLAINS;
  float running = 0.f;
  for (int b = 0; b < NUM_BIOMES; ++b) {
    running = running + w[b];
    if (u - running <= 0.f) {
      rb = b;
      break;
    }
  }
  int grass = grass_tab[rb];
  bool is_ocean = false;
  for (int b = 0; b < NUM_OCEAN_BIOMES; ++b) is_ocean = is_ocean || w[b] > 0.f;

  // cave-layer scan (fill.py:60-91)
  bool in_cave = false, has_above = false, has_below = false;
  int c_start = -1, c_end = -1, above_min = 9999, below_max = -9999;
  for (int k = 0; k < MAX_CAVE_LAYERS_PER_COLUMN; ++k) {
    int s = st[k], e = en[k];
    if (s == Y_SIZE) continue;
    if (s < y && y <= e) {
      in_cave = true;
      c_start = s > c_start ? s : c_start;
      c_end = e > c_end ? e : c_end;
    }
    if (s >= y) {
      has_above = true;
      above_min = s < above_min ? s : above_min;
    }
    if (e < y) {
      has_below = true;
      below_max = e > below_max ? e : below_max;
    }
  }
  bottom_d = in_cave ? c_start - y : (has_above ? above_min - y : -Y_SIZE);
  top_d = in_cave ? y - (c_end + 1) : (has_below ? y - (below_max + 1) : -Y_SIZE);

  bool above_ground = wyf > hfv;
  bool is_top = wyf >= hfv - 1.f;

  // material layer lookup: first layer containing y; forward materials only below
  // the backward-stratified base
  bool fwd_ok = wyf < lay[NUM_FORWARD_MATERIALS];
  int body = mat_block[0];
  for (int m = 0; m < NUM_MATERIALS; ++m) {
    float end = m + 1 < NUM_MATERIALS ? lay[m + 1] : hfv;
    if (lay[m] <= wyf && wyf < end && (m >= NUM_FORWARD_MATERIALS || fwd_ok)) {
      body = mat_block[m];
      break;
    }
  }
  if (body == BLOCK_DIRT && is_top) body = grass;
  bool pre_hit = rb == BIOME_CRYSTALS && hfv > 176.f && wyf > fld[FLD_QUARTZ];
  if (pre_hit) body = BLOCK_QUARTZ;

  // priority cascade
  bool water_zone = above_ground && y <= SEA_LEVEL;
  bool cave_mask = in_cave && !(water_zone && is_ocean) && !(above_ground && y > SEA_LEVEL);
  bool water_mask = water_zone && !(in_cave && !is_ocean);
  bool bedrock_mask = y == 0;
  bool air_mask = above_ground && y > SEA_LEVEL;
  bool solid_mask = !above_ground && !cave_mask && !bedrock_mask;
  int block = body;
  if (cave_mask) block = y <= LAVA_LEVEL ? BLOCK_LAVA : BLOCK_AIR;
  if (water_mask) block = BLOCK_WATER;
  if (air_mask) block = BLOCK_AIR;
  if (bedrock_mask) block = BLOCK_BEDROCK;

  if ((solid_mask || water_mask) && !cave_mask)
    block = biome_postprocess(block, rb, (float)wx, wyf, (float)wz, is_top, fld);
  cave_stone = y < CAVE_BIOME_Y_MAX && solid_mask && !pre_hit && stone_like(block);
  return block;
}

#define FILL_COLS 8        // columns of a tile: consecutive x of one z row of a chunk
#define FILL_THREADS 256
#define FILL_TILE (FILL_COLS * Y_SIZE)
#define QUEUE_CAP (FILL_COLS * CAVE_BIOME_Y_MAX)
static_assert(FILL_COLS == FILL_TILE_COLS, "terrain/fill.py FILL_TILE_COLS");
static_assert(16 % FILL_COLS == 0 && FILL_TILE % FILL_THREADS == 0 && FILL_TILE % 16 == 0, "tile shape");
#define INDEX_BITS 12  // a queue entry: the tile's block index, then its two cave depths in 10 bits each
static_assert(FILL_TILE <= (1 << INDEX_BITS) && Y_SIZE <= 512 && INDEX_BITS + 20 <= 32, "queue entry");

// a queue entry: the tile's block index and its two cave depths (each in [-385, 383])
MMT_FN unsigned int queue_entry(int i, int bottom_d, int top_d) {
  return (unsigned int)i | ((unsigned int)(bottom_d + 512) << INDEX_BITS) |
         ((unsigned int)(top_d + 512) << (INDEX_BITS + 10));
}

__global__ void __launch_bounds__(FILL_THREADS) fill_kernel(
    const float* __restrict__ hf, const float* __restrict__ w, const float* __restrict__ layers,
    const int* __restrict__ starts, const int* __restrict__ ends, const int* __restrict__ pos,
    const int* __restrict__ grass_tab, const int* __restrict__ mat_block,
    const int* __restrict__ cave_w, int table_cells, int* __restrict__ stats,
    unsigned char* __restrict__ blocks) {
  __shared__ float s_w[FILL_COLS][NUM_BIOMES], s_lay[FILL_COLS][NUM_MATERIALS], s_fld[FILL_COLS][N_FIELDS];
  __shared__ float s_hf[FILL_COLS];
  __shared__ int s_st[FILL_COLS][MAX_CAVE_LAYERS_PER_COLUMN], s_en[FILL_COLS][MAX_CAVE_LAYERS_PER_COLUMN];
  __shared__ __align__(16) unsigned char s_blk[FILL_TILE];
  __shared__ unsigned int s_q[QUEUE_CAP];          // blocks for the cave-biome post-process
  __shared__ unsigned short s_lq[QUEUE_CAP];       // lush near blocks
  __shared__ float s_pt[3][QUEUE_CAP];             // their clay points
  __shared__ float s_table[3 * LUSH_TABLE_CELLS];  // the jitters of the points' cell box
  __shared__ int s_nq, s_nl, s_lo[3], s_hi[3];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int bc0 = blockIdx.x * FILL_COLS;  // b * 256 + col of the tile's first column
  const int b = bc0 >> 8, col0 = bc0 & 255;
  const int wx0 = pos[2 * b] + (col0 & 15), wz = pos[2 * b + 1] + (col0 >> 4);  // column c: wx0 + c

  // 0. the columns' values
  for (int i = t; i < FILL_COLS * NUM_BIOMES; i += FILL_THREADS)
    s_w[i % FILL_COLS][i / FILL_COLS] = w[(b * NUM_BIOMES + i / FILL_COLS) * 256 + col0 + i % FILL_COLS];
  for (int i = t; i < FILL_COLS * NUM_MATERIALS; i += FILL_THREADS)
    s_lay[i % FILL_COLS][i / FILL_COLS] = layers[(b * NUM_MATERIALS + i / FILL_COLS) * 256 + col0 + i % FILL_COLS];
  for (int i = t; i < FILL_COLS * MAX_CAVE_LAYERS_PER_COLUMN; i += FILL_THREADS) {
    (&s_st[0][0])[i] = starts[bc0 * MAX_CAVE_LAYERS_PER_COLUMN + i];
    (&s_en[0][0])[i] = ends[bc0 * MAX_CAVE_LAYERS_PER_COLUMN + i];
  }
  if (t < FILL_COLS) s_hf[t] = hf[bc0 + t];
  for (int f = warp; f < N_FIELDS; f += FILL_THREADS / 32)  // warp-uniform: field f in warp f % warps
    if (lane < FILL_COLS) s_fld[lane][f] = column_field(f, (float)(wx0 + lane), (float)wz);
  if (t == 0) {
    s_nq = 0;
    s_nl = 0;
  }
  if (t < 3) {
    s_lo[t] = INT_MAX;
    s_hi[t] = INT_MIN;
  }
  __syncthreads();

  // 1. the cascade of every block; the cave-biome queue
  for (int i = t; i < FILL_TILE; i += FILL_THREADS) {  // warp-uniform: FILL_TILE % FILL_THREADS == 0
    const int c = i / Y_SIZE, y = i - c * Y_SIZE;
    int bottom_d, top_d;
    bool cave_stone;
    s_blk[i] = (unsigned char)fill_block_cascade(y, wx0 + c, wz, s_hf[c], s_w[c], s_lay[c], s_st[c], s_en[c],
                                                 s_fld[c], grass_tab, mat_block, bottom_d, top_d, cave_stone);
    const unsigned m = __ballot_sync(0xffffffffu, cave_stone);
    int base = 0;
    if (lane == 0 && m) base = atomicAdd(&s_nq, __popc(m));
    base = __shfl_sync(0xffffffffu, base, 0);
    if (cave_stone) s_q[base + __popc(m & ((1u << lane) - 1u))] = queue_entry(i, bottom_d, top_d);
  }
  __syncthreads();

  // 2. the cave biome of the queued blocks; the lush queue
  const int nq = s_nq;
  for (int q = t; q < nq; q += FILL_THREADS) {
    const unsigned int e = s_q[q];
    const int i = (int)(e & ((1u << INDEX_BITS) - 1u)), c = i / Y_SIZE, y = i - c * Y_SIZE;
    const int r = cave_biome_stone(s_blk[i], wx0 + c, y, wz, s_hf[c], (int)((e >> INDEX_BITS) & 1023u) - 512,
                                   (int)(e >> (INDEX_BITS + 10)) - 512, cave_w);
    if (r == LUSH_NEAR) s_lq[atomicAdd(&s_nl, 1)] = (unsigned short)i;
    else s_blk[i] = (unsigned char)r;
  }
  __syncthreads();

  // 3. the lush queue's clay points, their cell box and its table, the F1 searches
  const int nl = s_nl;
  if (nl > 0) {
    int v[6] = {INT_MAX, INT_MAX, INT_MAX, INT_MIN, INT_MIN, INT_MIN};
    for (int q = t; q < nl; q += FILL_THREADS) {
      const int i = s_lq[q], c = i / Y_SIZE;
      float p[3];
      lush_clay_point(wx0 + c, i - c * Y_SIZE, wz, p[0], p[1], p[2]);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        s_pt[k][q] = p[k];
        const int cell = (int)floorf(p[k]);
        v[k] = min(v[k], cell);
        v[k + 3] = max(v[k + 3], cell);
      }
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      v[k] = __reduce_min_sync(0xffffffffu, v[k]);
      v[k + 3] = __reduce_max_sync(0xffffffffu, v[k + 3]);
    }
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        atomicMin(&s_lo[k], v[k]);
        atomicMax(&s_hi[k], v[k + 3]);
      }
    }
    __syncthreads();
    const int x0 = s_lo[0] - 1, y0 = s_lo[1] - 1, z0 = s_lo[2] - 1;
    // the box's edges, each capped at 2^20 so that their product fits
    const long long nxc = min((long long)s_hi[0] - x0 + 2, 1LL << 20),
                    nyc = min((long long)s_hi[1] - y0 + 2, 1LL << 20),
                    nzc = min((long long)s_hi[2] - z0 + 2, 1LL << 20);
    const long long cells = nxc * nyc * nzc;
    const bool direct = cells > table_cells;
    if (t == 0 && stats != nullptr) {
      atomicAdd(&stats[0], nq);
      atomicAdd(&stats[1], nl);
      int seen = cells > INT_MAX ? INT_MAX : (int)cells;
      if (seen > *(volatile int*)&stats[2]) atomicMax(&stats[2], seen);
      if (direct) atomicAdd(&stats[3], 1);
    }
    if (!direct) fill_jitter_table(s_table, (int)cells, x0, y0, z0, (int)nyc, (int)nzc, t, FILL_THREADS);
    __syncthreads();
    const TableJitter jitter{s_table, (int)cells, x0, y0, z0, (int)nyc, (int)nzc};
    for (int q = t; q < nl; q += FILL_THREADS) {
      const float px = s_pt[0][q], py = s_pt[1][q], pz = s_pt[2][q];
      const float clay_n = direct ? worley3_f1(px, py, pz) : worley3_f1_search(px, py, pz, jitter);
      s_blk[s_lq[q]] = (unsigned char)(clay_n < F(0.25) ? BLOCK_CLAY : BLOCK_MOSS);
    }
  } else if (t == 0 && stats != nullptr && nq > 0) {
    atomicAdd(&stats[0], nq);
  }
  __syncthreads();

  // 4. the tile's bytes, coalesced
  const uint4* src = reinterpret_cast<const uint4*>(s_blk);
  uint4* dst = reinterpret_cast<uint4*>(blocks + (size_t)bc0 * Y_SIZE);
  for (int i = t; i < FILL_TILE / 16; i += FILL_THREADS) dst[i] = src[i];
}

extern "C" int mmt_fill(const float* hf, const float* w, const float* layers, const int* starts,
                        const int* ends, const int* pos, int B, const int* grass_tab,
                        const int* mat_block, const int* cave_w, int table_cells, int* stats,
                        unsigned char* blocks, void* stream) {
  fill_kernel<<<B * (256 / FILL_COLS), FILL_THREADS, 0, (cudaStream_t)stream>>>(
      hf, w, layers, starts, ends, pos, grass_tab, mat_block, cave_w, table_cells, stats, blocks);
  return (int)cudaGetLastError();
}
