// K4: chunk fill -- a u8 block id for every block of [B, 16, 16, 384].
//
// Replaces mega_minecraft_tpu/terrain/fill.py:283 fill_chunks (jitted XLA on the
// TPU).  One CUDA block per column, one thread per y (384 threads = 12 warps).  The
// block stages the column's 24 biome weights, 20 layer starts and 32 + 32 cave-layer
// bounds in shared memory, and 7 of its warps each compute one per-column field
// (quartz_start, dirt_h, tsh, mud_end, ssh, snow_h, myc_rand) once instead of 384
// times.  Each thread then runs the reference's cascade for its block in the JAX
// program's order: seeded random-biome pick, cave-depth scan, material lookup and
// grass, quartz towers, bedrock/air/water/cave/lava priority, biome post-process,
// and below CAVE_BIOME_Y_MAX = 192 the cave-biome post-process.
//
// Bound on the H100: arithmetic.  The JAX program evaluated every post-process noise
// for every block (SIMD lanes cannot branch) and selected; a thread here evaluates a
// noise only where its mask can select the result -- the mesa strata simplex only for
// mesa blocks, the cave biome (fbm3_from3 + 2 simplex3 + 4 fbm2) only for solid
// stone-like blocks below y = 192, the quartz simplex and clay Worley only for their
// cave biome.  Unselected values are discarded in JAX, so the result is the same.
// Writes are 384 contiguous bytes per column.

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

// cave-biome post-process (fill.py:224-280); identity unless the block is stone-like
MMT_FN int cave_biome_postprocess(int block, int wx, int y, int wz, float hfv, int bottom_d,
                                  int top_d, const int* cave_w) {
  bool stone_like = block == BLOCK_STONE || block == BLOCK_DEEPSLATE || block == BLOCK_BLACKSTONE;
  if (!stone_like) return block;
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
    float nx = wxf * F(0.025), ny = wyf * F(0.025), nz = wzf * F(0.025);
    float thr = F(1.5) + F(4.5) * simplex3(nx, ny, nz);
    float bd = (float)bottom_d, td = (float)top_d;
    bool near = (bd >= 0.f && bd <= thr) || (td >= 0.f && td <= thr);
    if (!near) return block;
    float ny2 = ny + F(192031.9821);
    float ox, oy, oz;
    fbm3_from3(nx * F(0.4), ny2 * F(0.4), nz * F(0.4), 3, ox, oy, oz);
    float clay_n = worley3_f1(nx + ox * 2.f, ny2 + oy * 2.f, nz + oz * 2.f);
    return clay_n < F(0.25) ? BLOCK_CLAY : BLOCK_MOSS;
  }
  if ((cb == CAVE_WARPED_FOREST || cb == CAVE_AMBER_FOREST) && bottom_d == 0) {
    bool warped = cb == CAVE_WARPED_FOREST;
    if (block == BLOCK_DEEPSLATE) return warped ? BLOCK_WARPED_DEEPSLATE : BLOCK_AMBER_DEEPSLATE;
    if (block == BLOCK_BLACKSTONE) return warped ? BLOCK_WARPED_BLACKSTONE : BLOCK_AMBER_BLACKSTONE;
  }
  return block;
}

// one block of one column; w [24], lay [20], st / en [32] and fld [N_FIELDS] are
// the column's values
MMT_FN int fill_block(int y, int wx, int wz, float hfv, const float* w, const float* lay,
                      const int* st, const int* en, const float* fld, const int* grass_tab,
                      const int* mat_block, const int* cave_w) {
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
  int bottom_d = in_cave ? c_start - y : (has_above ? above_min - y : -Y_SIZE);
  int top_d = in_cave ? y - (c_end + 1) : (has_below ? y - (below_max + 1) : -Y_SIZE);

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
  if (y < CAVE_BIOME_Y_MAX && solid_mask && !pre_hit)
    block = cave_biome_postprocess(block, wx, y, wz, hfv, bottom_d, top_d, cave_w);
  return block;
}

__global__ void __launch_bounds__(Y_SIZE) fill_kernel(
    const float* __restrict__ hf, const float* __restrict__ w, const float* __restrict__ layers,
    const int* __restrict__ starts, const int* __restrict__ ends, const int* __restrict__ pos,
    const int* __restrict__ grass_tab, const int* __restrict__ mat_block,
    const int* __restrict__ cave_w, unsigned char* __restrict__ blocks) {
  __shared__ float s_w[NUM_BIOMES], s_lay[NUM_MATERIALS], s_fld[N_FIELDS];
  __shared__ int s_st[MAX_CAVE_LAYERS_PER_COLUMN], s_en[MAX_CAVE_LAYERS_PER_COLUMN];
  int bc = blockIdx.x;  // b * 256 + col
  int b = bc >> 8, col = bc & 255;
  int y = threadIdx.x;
  int wx = pos[2 * b] + (col & 15), wz = pos[2 * b + 1] + (col >> 4);
  if (y < NUM_BIOMES) s_w[y] = w[(b * NUM_BIOMES + y) * 256 + col];
  if (y < NUM_MATERIALS) s_lay[y] = layers[(b * NUM_MATERIALS + y) * 256 + col];
  if (y < MAX_CAVE_LAYERS_PER_COLUMN) {
    s_st[y] = starts[bc * MAX_CAVE_LAYERS_PER_COLUMN + y];
    s_en[y] = ends[bc * MAX_CAVE_LAYERS_PER_COLUMN + y];
  }
  // lane 0 of warps 0..6 each computes one field, so the seven run in parallel
  if ((y & 31) == 0 && (y >> 5) < N_FIELDS) s_fld[y >> 5] = column_field(y >> 5, (float)wx, (float)wz);
  __syncthreads();
  blocks[(size_t)bc * Y_SIZE + y] = (unsigned char)fill_block(
      y, wx, wz, hf[bc], s_w, s_lay, s_st, s_en, s_fld, grass_tab, mat_block, cave_w);
}

extern "C" int mmt_fill(const float* hf, const float* w, const float* layers, const int* starts,
                        const int* ends, const int* pos, int B, const int* grass_tab,
                        const int* mat_block, const int* cave_w, unsigned char* blocks,
                        void* stream) {
  fill_kernel<<<B * 256, Y_SIZE, 0, (cudaStream_t)stream>>>(hf, w, layers, starts, ends, pos,
                                                            grass_tab, mat_block, cave_w, blocks);
  return (int)cudaGetLastError();
}
