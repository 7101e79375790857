// K8: decorators -- the 1-2-block flora and small crystals placed after the features.
//
// Replaces mega_minecraft_tpu/terrain/decorators.py:53,194 place_decorators(_batch)
// (jitted XLA on the TPU).  The JAX program applied each gen of each biome to all
// columns at once with one-hot selects over y; a thread here owns one column and applies
// its own placements in order, so a later placement reads what an earlier one wrote.
//
// One CUDA block per chunk, one thread per column.  The chunk consumes ONE sequential
// minstd stream; a column uses 2 + 2 * (its drawing cave layers) draws, the drawing
// layers being those before the column's first empty slot (start == 384).  A block-wide
// exclusive prefix sum over the 256 columns in z*16+x order gives the column's first
// stream position, one jump (a^position by square-and-multiply in 64-bit arithmetic)
// puts the thread's state there, and the column's draws follow by stepping: biome pick,
// surface draw, then (floor, ceiling) per drawing layer.  Surface: the first gen of the
// picked biome whose cumulative chance crosses the draw is tried.  Cave layers 0..7:
// every gen of the layer's bottom biome whose cumulative chance (floor and ceiling gens
// summed apart) exceeds the layer's draw is tried, as the reference never sets its
// placed flag.  The block first copies the chunk's blocks to the output with 16-byte
// loads, then each thread edits its own column there.
//
// Bound on the H100: bytes (98,304 read + 98,304 written per chunk; the draws and the
// few table tests per column are small beside that).

#include "mmt_math.cuh"
#include "mmt_feature_tables.h"

using namespace mmt;

#define N_LAYERS MAX_CAVE_LAYERS_PER_COLUMN

MMT_FN bool dec_in_set(int block, const int* set, int n) {
  for (int i = 0; i < n; ++i)
    if (block == set[i]) return true;
  return false;
}

// tryPlaceSingleDecorator (decorators.py:114-146) on one column
MMT_FN void try_place(unsigned char* column, int y, int g) {
  if (y < 0 || y > Y_SIZE - 1) return;
  if (!dec_in_set(column[y], DEC_REPLACE[g], DEC_N_REPLACE[g])) return;
  int u_off = DEC_CEILING[g] ? 1 : -1;
  int uy = y + u_off;
  if (uy < 0 || uy > Y_SIZE - 1) return;
  int ub = column[uy];
  if (ub < NUM_NON_SOLID_BLOCKS) return;
  if (DEC_N_UNDER[g] > 0 && !dec_in_set(ub, DEC_UNDER[g], DEC_N_UNDER[g])) return;
  if (DEC_SECOND[g] != BLOCK_AIR) {
    int oy = y - u_off;
    if (oy < 0 || oy > Y_SIZE - 1) return;
    if (!dec_in_set(column[oy], DEC_REPLACE[g], DEC_N_REPLACE[g])) return;
    column[oy] = (unsigned char)DEC_SECOND[g];
  }
  column[y] = (unsigned char)DEC_BLOCK[g];
}

__global__ void __launch_bounds__(256) decorators_kernel(
    const unsigned char* __restrict__ blocks, const float* __restrict__ hf,
    const float* __restrict__ w, const int* __restrict__ starts, const int* __restrict__ ends,
    const int* __restrict__ bottom_biome, const int* __restrict__ pos,
    unsigned char* __restrict__ out) {
  __shared__ int s_warp[8];
  int b = blockIdx.x, col = threadIdx.x;
  int bc = b * 256 + col;

  // copy the chunk (256 * 384 bytes = 6,144 uint4)
  const uint4* src = reinterpret_cast<const uint4*>(blocks + (size_t)b * 256 * Y_SIZE);
  uint4* dst = reinterpret_cast<uint4*>(out + (size_t)b * 256 * Y_SIZE);
  for (int i = col; i < 256 * Y_SIZE / 16; i += 256) dst[i] = src[i];

  // the column's drawing layers: those before its first empty slot
  const int* st = starts + (size_t)bc * N_LAYERS;
  int n_draw = 0;
  while (n_draw < N_LAYERS && st[n_draw] != Y_SIZE) ++n_draw;
  int k_col = 2 + 2 * n_draw;

  // exclusive prefix sum of k_col over the block's 256 columns
  int lane = col & 31, warp = col >> 5;
  int incl = k_col;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    int n = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += n;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();  // also orders the copy above before the column edits below
  int col_base = incl - k_col;
  for (int k = 0; k < warp; ++k) col_base += s_warp[k];

  uint32_t state0 = seed_4(pos[2 * b], 0, pos[2 * b + 1], SEED_DECORATORS);
  uint32_t state = lcg_mulmod(lcg_pow((uint32_t)col_base), state0);  // after col_base draws
  float r_biome = lcg_u01(&state);
  float r_surface = lcg_u01(&state);

  int biome = BIOME_PLAINS;
  float running = 0.f;
  for (int k = 0; k < NUM_BIOMES; ++k) {
    running = running + w[(b * NUM_BIOMES + k) * 256 + col];
    if (r_biome - running <= 0.f) {
      biome = k;
      break;
    }
  }

  unsigned char* column = out + (size_t)bc * Y_SIZE;
  int ground_y = (int)hf[bc] + 1;

  // surface decorators: the first gen whose cumulative chance crosses the draw
  running = 0.f;
  for (int j = 0; j < DEC_SURF_COUNT[biome]; ++j) {
    int g = DEC_SURF_START[biome] + j;
    running = running + DEC_CHANCE[g];
    if (r_surface < running) {
      try_place(column, ground_y, g);
      break;
    }
  }

  // cave decorators: every gen past the crossing point places too
  int n_apply = n_draw < MAX_APPLY_LAYERS ? n_draw : MAX_APPLY_LAYERS;
  for (int li = 0; li < n_apply; ++li) {
    float r_bottom = lcg_u01(&state);
    float r_top = lcg_u01(&state);
    int cb = bottom_biome[(size_t)bc * N_LAYERS + li];
    if ((unsigned)cb >= (unsigned)NUM_CAVE_BIOMES) continue;
    int floor_y = st[li] + 1;
    int ceil_y = ends[(size_t)bc * N_LAYERS + li];
    float run_b = 0.f, run_t = 0.f;
    for (int j = 0; j < DEC_CAVE_COUNT[cb]; ++j) {
      int g = DEC_CAVE_START[cb] + j;
      if (DEC_CEILING[g]) {
        run_t = run_t + DEC_CHANCE[g];
        if (r_top < run_t) try_place(column, ceil_y, g);
      } else {
        run_b = run_b + DEC_CHANCE[g];
        if (r_bottom < run_b) try_place(column, floor_y, g);
      }
    }
  }
}

extern "C" int mmt_decorators(const unsigned char* blocks, const float* hf, const float* w,
                              const int* starts, const int* ends, const int* bottom_biome,
                              const int* pos, int B, unsigned char* out, void* stream) {
  decorators_kernel<<<B, 256, 0, (cudaStream_t)stream>>>(blocks, hf, w, starts, ends,
                                                         bottom_biome, pos, out);
  return (int)cudaGetLastError();
}
