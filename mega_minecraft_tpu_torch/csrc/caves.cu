// K3: caves + cave biomes.
//
// Replaces mega_minecraft_tpu/terrain/caves.py:175 generate_caves (jitted XLA on the
// TPU).  Two launches:
//   1. carve_kernel, one thread per (column, y < CARVE_Y_MAX = 144): the 3-D carve
//      test (fbm3_from3 + special_cave_noise + two fbm3 per block), written as one
//      byte per block to a [B, 256, 144] scratch.  This is the heavy part: ~81
//      correctly rounded sins and ~23 simplex3 per block.  A 5x5 area has only
//      6,400 columns, far below the card's 132 SMs x 2048 threads, so the work is
//      spread over (column, y) to fill the card.
//   2. column_kernel, one warp per column: the above-surface test and the ravine
//      threshold once per column, then flips ("filled" changes between y and y+1)
//      compacted in ascending y by __ballot_sync + __popc prefix sums over 12
//      chunks of 32 y's -- the JAX program's sort of flip positions, including its
//      truncation to the first 64 flips -- and the cave biomes at the valid layer
//      edges, one layer per lane.
//
// Bound on the H100: arithmetic in carve_kernel; the scratch is 144 bytes per column.

#include "mmt_math.cuh"

using namespace mmt;

// the 3-D 'carved' term (caves.py:51-70)
MMT_FN bool carved_at(float wxf, float wyf, float wzf, float ocean_beach) {
  float nx = wxf * F(0.0050), ny = wyf * F(0.0050), nz = wzf * F(0.0050);
  float top_ratio = smoothstep(142.f, 95.f, wyf + ocean_beach * 50.f);
  float bottom_ratio = smoothstep(5.f, 20.f, wyf);
  float ox, oy, oz;
  fbm3_from3(nx * F(0.8), ny * F(0.8), nz * F(0.8), 5, ox, oy, oz);
  float cave_noise = special_cave_noise(nx + ox * F(1.8), ny * F(1.6) + oy * F(1.8), nz + oz * F(1.8));
  float thr = F(0.24) + F(0.12) * fbm3(nx * 4.f, ny * 4.f, nz * 4.f, 4);
  float huge = smoothstep(F(0.2), F(0.4), fbm3(nx * F(0.07), ny * F(0.07), nz * F(0.07), 4));
  thr = thr * (1.f + F(1.4) * huge);
  thr = thr * top_ratio * (F(0.3) + F(0.7) * bottom_ratio);
  return thr > F(0.04) && cave_noise < thr;
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

// thread tid = (b * 256 + col) * CARVE_Y_MAX + y of the [B, 256, 144] carve band
MMT_FN void carve_thread(int tid, const float* w, const int* pos, unsigned char* carved) {
  int y = tid % CARVE_Y_MAX;
  int bc = tid / CARVE_Y_MAX;  // b * 256 + col
  int b = bc >> 8, col = bc & 255;
  float wxf = (float)(pos[2 * b] + (col & 15));
  float wzf = (float)(pos[2 * b + 1] + (col >> 4));
  carved[tid] = carved_at(wxf, (float)y, wzf, ocean_beach_weight(w, b, col)) ? 1 : 0;
}

__global__ void carve_kernel(const float* __restrict__ w, const int* __restrict__ pos, int B,
                             unsigned char* __restrict__ carved) {
  int tid = blockIdx.x * blockDim.x + threadIdx.x;
  if (tid < B * 256 * CARVE_Y_MAX) carve_thread(tid, w, pos, carved);
}

#define WARPS_PER_BLOCK 4

__global__ void column_kernel(const float* __restrict__ hf, const float* __restrict__ w,
                              const int* __restrict__ pos, int B, const int* __restrict__ cave_w,
                              const unsigned char* __restrict__ carved, int* __restrict__ starts,
                              int* __restrict__ ends, int* __restrict__ bottom,
                              int* __restrict__ top) {
  __shared__ int keys[WARPS_PER_BLOCK][2 * MAX_CAVE_LAYERS_PER_COLUMN];
  int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int bc = blockIdx.x * WARPS_PER_BLOCK + warp;  // b * 256 + col
  if (bc >= B * 256) return;  // whole warp leaves together
  int b = bc >> 8, col = bc & 255;
  int wx = pos[2 * b] + (col & 15), wz = pos[2 * b + 1] + (col >> 4);
  float hfv = hf[bc];
  float surf = fmax_nan(floorf(hfv), (float)SEA_LEVEL);
  float rav = ravine_min_y((float)wx, (float)wz, ocean_beach_weight(w, b, col));
  const unsigned char* cv = carved + (size_t)bc * CARVE_Y_MAX;
  auto filled = [&](int y) {
    if (y >= Y_SIZE) return false;  // past the top: the reference's zero padding
    float yf = (float)y;
    bool cave = yf > surf || (y < CARVE_Y_MAX && cv[y]) || yf > rav;
    return !(y != 0 && cave);
  };
  int count = 0;
  for (int c = 0; c < Y_SIZE / 32; ++c) {
    int y = c * 32 + lane;
    bool flip = filled(y) != filled(y + 1);
    unsigned mask = __ballot_sync(0xffffffffu, flip);
    int rank = count + __popc(mask & ((1u << lane) - 1u));
    if (flip && rank < 2 * MAX_CAVE_LAYERS_PER_COLUMN) keys[warp][rank] = y;
    count += __popc(mask);
  }
  __syncwarp();
  int k = lane;  // one cave layer per lane
  int s = 2 * k < count ? keys[warp][2 * k] : Y_SIZE;
  int e = 2 * k + 1 < count ? keys[warp][2 * k + 1] : Y_SIZE;
  int out = bc * MAX_CAVE_LAYERS_PER_COLUMN + k;
  starts[out] = s;
  ends[out] = e;
  bottom[out] = s != Y_SIZE ? cave_biome(wx, s, wz, hfv, SEED_BOTTOM_BIOME, cave_w, NUM_CAVE_BIOMES) : 0;
  top[out] = e != Y_SIZE ? cave_biome(wx, e + 1, wz, hfv, SEED_TOP_BIOME, cave_w, NUM_CAVE_BIOMES)
                         : CAVE_NONE;
}

extern "C" int mmt_caves(const float* hf, const float* w, const int* pos, int B, const int* cave_w,
                         unsigned char* carved, int* starts, int* ends, int* bottom, int* top,
                         void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int threads = 128;
  int n = B * 256 * CARVE_Y_MAX;
  carve_kernel<<<(n + threads - 1) / threads, threads, 0, st>>>(w, pos, B, carved);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  int cols = B * 256;
  column_kernel<<<(cols + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK, 32 * WARPS_PER_BLOCK, 0, st>>>(
      hf, w, pos, B, cave_w, carved, starts, ends, bottom, top);
  return (int)cudaGetLastError();
}
