// K1: heightfield + surface biome weights.
//
// Replaces mega_minecraft_tpu/terrain/heightfield.py:299 generate_heightfield (a jitted
// XLA program on the TPU).  One thread per column (B * 256 threads): the 6-channel
// domain-warped biome noise, the 24 multiplicative biome weights in the reference's
// channel order, then sum over b = 0..23 of w_b * h_b(x, z) for w_b > 0 only.
//
// Bound on the H100: arithmetic.  Each column reads 8 bytes and writes 100; the
// noise is hundreds of f32 operations per simplex and ~200 per correctly rounded sin
// in the Worley biomes.  The JAX program evaluated all 24 height formulas for every
// column (SIMD lanes cannot branch); here a thread evaluates only the biomes with
// non-zero weight (typically 1-4), which is the reference's per-thread branch.
// Divergence within a warp is bounded because neighbouring columns share biomes.
//
// K2h's first half is here too: heightfield_window_kernel runs the same column code over
// each chunk's own 18x18 window (see below and layers.cu).

#include "mmt_math.cuh"

using namespace mmt;

namespace {

MMT_FN float h_archipelago(float x, float z) {
  float island = (fbm2(x * F(0.0055), z * F(0.0055), 4) + 1.f) * 0.5f;
  island = powf(island, F(2.4));
  island = smoothstep(1.f, 0.f, island);
  float base = 107.f + 24.f * fbm2(x * F(0.0060), z * F(0.0060), 5);
  return base + 22.f * island;
}

MMT_FN float h_savanna(float x, float z) {
  float ox, oz;
  fbm2_from2(x * F(0.0040), z * F(0.0040), 5, ox, oz);
  float nx = x + ox * 100.f;
  float nz = z + oz * 100.f;
  float f1, edge, cx, cy;
  worley2(nx * F(0.0070), nz * F(0.0070), f1, edge, cx, cy);
  float p1 = smoothstep(F(0.30), F(0.20), f1) * (1.f + F(0.3) * simplex2(nx * F(0.0100), nz * F(0.0100)));
  worley2((nx + F(-3910.12)) * F(0.0045), (nz + F(-9012.34)) * F(0.0045), f1, edge, cx, cy);
  float p2 = smoothstep(F(0.16), F(0.08), f1) * (1.f + F(0.2) * simplex2(nx * F(0.0130), nz * F(0.0130)));
  float plateau = p1 * 14.f + p2 * 9.f;
  return 136.f + 9.f * fbm2(x * F(0.0080), z * F(0.0080), 4) + plateau;
}

MMT_FN float h_mesa(float x, float z) {
  x = x * F(0.7);
  z = z * F(0.7);
  float ox, oz;
  fbm2_from2(x * F(0.0050), z * F(0.0050), 5, ox, oz);
  ox = ox * 300.f;
  oz = oz * 300.f;
  float f1, river, cx, cy;
  worley2((x + ox) * F(0.0030), (z + oz) * F(0.0030), f1, river, cx, cy);
  float base = 122.f + 10.f * smoothstep(0.f, F(0.05), river);
  base = base + (F(37.5) + 5.f * fbm2((x + F(0.02) * ox) * F(0.0300), (z + F(0.02) * oz) * F(0.0300), 4)) *
                    smoothstep(F(0.07), F(0.22), river);
  return base + 6.f * simplex2(x * F(0.0250), z * F(0.0250));
}

MMT_FN float h_sparse_desert(float x, float z) {
  float ox, oz;
  simplex2_from2(x * F(0.0080), z * F(0.0080), ox, oz);
  float f1, edge, cx, cy;
  worley2((x + ox * 20.f) * F(0.0160), (z + oz * 20.f) * F(0.0160), f1, edge, cx, cy);
  float dunes = (f1 * f1) * 18.f;  // pow(f1, 2)
  return 132.f + 4.f * fbm2(x * F(0.0070), z * F(0.0070), 4) + dunes;
}

MMT_FN float h_tianzi(float x, float z) {
  float ox, oz;
  simplex2_from2(x * F(0.0800), z * F(0.0800), ox, oz);
  float nx = (x + ox * 3.f) * F(0.0150);
  float nz = (z + oz * 3.f) * F(0.0150);
  float f1, edge, cx, cy;
  worley2(nx, nz, f1, edge, cx, cy);
  float w1 = smoothstep(F(0.45), F(0.35), f1) * F(1.2);
  worley2(nx * F(1.4) + F(4292.12), nz * F(1.4) + F(9183.27), f1, edge, cx, cy);
  float w2 = smoothstep(F(0.45), F(0.35), f1) * F(0.6);
  float mountains = (w1 + w2) * (54.f + 7.f * fbm2(nx * F(1.7), nz * F(1.7), 3));
  float hills = 16.f * simplex2(x * F(0.0150), z * F(0.0150));
  return 128.f + hills + 9.f * fbm2(x * F(0.0070), z * F(0.0070), 3) + mountains;
}

MMT_FN float h_crystals(float x, float z) {
  float base_noise = simplex2(x * F(0.0030), z * F(0.0030));
  float f1, edge, cx, cy;
  worley2(x * F(0.0700), z * F(0.0700), f1, edge, cx, cy);
  float towers = smoothstep(F(0.10), F(0.15), edge);
  towers = towers * (F(0.4) + F(1.2) * rand3_from2_x(cx, cy));
  float height = 60.f * towers * smoothstep(F(0.70), F(0.74), base_noise);
  height = height + 18.f * smoothstep(F(0.35), F(0.8), base_noise);
  return 137.f + 8.f * fbm2(x * F(0.0200), z * F(0.0200), 5) + height;
}

MMT_FN float h_mountains(float x, float z) {
  float a = fabsf(fbm2(x * F(0.0035), z * F(0.0035), 5)) + F(0.05);
  float n = a * a;  // pow(., 2)
  n = n + ((fbm2(x * F(0.0050), z * F(0.0050), 5) - 0.5f) * 2.f) * F(0.05);
  return 165.f + 140.f * (n - F(0.15)) + n * (20.f * fbm2(x * F(0.0350), z * F(0.0350), 5));
}

// base + amp * fbm2(x * s, z * s, 5): the shape of 14 of the 24 formulas
MMT_FN float h_fbm(float base, float amp, float s, float x, float z) {
  return base + amp * fbm2(x * s, z * s, 5);
}

MMT_FN float biome_height(int b, float x, float z) {
  switch (b) {
    case BIOME_CORAL_REEF: return h_fbm(107.f, 16.f, F(0.0065), x, z);
    case BIOME_ARCHIPELAGO: return h_archipelago(x, z);
    case BIOME_WARM_OCEAN: return h_fbm(93.f, 18.f, F(0.0055), x, z);
    case BIOME_ICEBERGS: return h_fbm(66.f, 18.f, F(0.0060), x, z);
    case BIOME_COOL_OCEAN: return h_fbm(80.f, 22.f, F(0.0065), x, z);
    case BIOME_ROCKY_BEACH: return h_fbm(134.f, 8.f, F(0.0070), x, z);
    case BIOME_TROPICAL_BEACH: return h_fbm(F(129.5), 6.f, F(0.0045), x, z);
    case BIOME_BEACH: return h_fbm(132.f, 5.f, F(0.0055), x, z);
    case BIOME_SAVANNA: return h_savanna(x, z);
    case BIOME_MESA: return h_mesa(x, z);
    case BIOME_FROZEN_WASTELAND: return h_fbm(136.f, 16.f, F(0.0035), x, z);
    case BIOME_REDWOOD_FOREST: return h_fbm(134.f, 8.f, F(0.0120), x, z);
    case BIOME_SHREKS_SWAMP: return h_fbm(130.f, 12.f, F(0.0080), x, z);
    case BIOME_SPARSE_DESERT: return h_sparse_desert(x, z);
    case BIOME_LUSH_BIRCH_FOREST: {
      float hills = (simplex2(x * F(0.0012), z * F(0.0012)) + F(0.8)) * 20.f;
      return h_fbm(135.f, 8.f, F(0.0090), x, z) + hills;
    }
    case BIOME_TIANZI_MOUNTAINS: return h_tianzi(x, z);
    case BIOME_JUNGLE: {
      float hills = (simplex2(x * F(0.0030), z * F(0.0030)) + 0.5f) * 25.f;
      return h_fbm(139.f, 8.f, F(0.0120), x, z) + hills;
    }
    case BIOME_RED_DESERT: return h_fbm(137.f, 13.f, F(0.0075), x, z);
    case BIOME_PURPLE_MUSHROOMS: return h_fbm(136.f, 9.f, F(0.0140), x, z);
    case BIOME_CRYSTALS: return h_crystals(x, z);
    case BIOME_OASIS: return h_fbm(132.f, 9.f, F(0.0120), x, z);
    case BIOME_DESERT: return h_fbm(136.f, 6.f, F(0.0110), x, z);
    case BIOME_PLAINS: return h_fbm(144.f, 8.f, F(0.0080), x, z);
    default: return h_mountains(x, z);  // BIOME_MOUNTAINS
  }
}

// biome_noise (heightfield.py:46-66): ocean, beach, rocky, magic, temperature, moisture
MMT_FN void biome_noise(float wx, float wz, float n[6]) {
  float ox, oz;
  fbm2_from2(wx * F(0.0150), wz * F(0.0150), 3, ox, oz);
  float px = (wx + ox * 20.f) * F(OVERALL_BIOME_SCALE);
  float pz = (wz + oz * 20.f) * F(OVERALL_BIOME_SCALE);
  float ocean_noise = simplex2(px * F(0.0007) + F(2853.49), pz * F(0.0007) + F(-9481.42));
  n[0] = smoothstep(F(0.01), F(-0.02), ocean_noise);
  n[1] = smoothstep(F(-0.15), F(-0.05), ocean_noise);
  const float sc[4] = {F(0.0015), F(0.0030), F(0.0012), F(0.0050)};
  const float offx[4] = {F(-8102.35), F(5612.35), F(-4021.34), F(1835.32)};
  const float offz[4] = {F(-7620.23), F(9182.49), F(-8720.12), F(3019.39)};
  const float thr[4] = {F(0.08), F(0.07), F(0.06), F(0.12)};
  for (int i = 0; i < 4; ++i) {
    float s = simplex2(px * sc[i] + offx[i], pz * sc[i] + offz[i]);
    n[2 + i] = smoothstep(-thr[i], thr[i], s);
  }
}

}  // namespace

// one column: world (x, z) -> height and the 24 weights
MMT_FN float heightfield_column(float wx, float wz, const int* noise_w, float w[NUM_BIOMES]) {
  float n[6];
  biome_noise(wx, wz, n);
  for (int b = 0; b < NUM_BIOMES; ++b) {
    float v = 1.f;
    for (int c = 0; c < 6; ++c) {
      int kind = noise_w[b * 6 + c];
      if (kind == 1) v = v * n[c];
      else if (kind == 2) v = v * (1.f - n[c]);
    }
    w[b] = v;
  }
  float height = 0.f;
  for (int b = 0; b < NUM_BIOMES; ++b)
    if (w[b] > 0.f) height = height + w[b] * biome_height(b, wx, wz);
  return height;
}

// thread tid = b * 256 + z * 16 + x of the [B, 16, 16] grid
MMT_FN void heightfield_thread(int tid, const int* pos, const int* noise_w, float* hf,
                               float* w_out) {
  int b = tid >> 8, col = tid & 255;
  float wx = (float)(pos[2 * b] + (col & 15));
  float wz = (float)(pos[2 * b + 1] + (col >> 4));
  float w[NUM_BIOMES];
  hf[tid] = heightfield_column(wx, wz, noise_w, w);
  for (int k = 0; k < NUM_BIOMES; ++k) w_out[(b * NUM_BIOMES + k) * 256 + col] = w[k];
}

__global__ void heightfield_kernel(const int* __restrict__ pos, int B,
                                   const int* __restrict__ noise_w, float* __restrict__ hf,
                                   float* __restrict__ w_out) {
  int tid = blockIdx.x * blockDim.x + threadIdx.x;
  if (tid < B * 256) heightfield_thread(tid, pos, noise_w, hf, w_out);
}

// K2h, first half (with layers_window_kernel in layers.cu; replaces
// mega_minecraft_tpu/parallel/sharding.py:58-72 _gen_stage_layers' heightfield): one thread
// per column of each chunk's 18x18 window, world x, z = origin - 1 .. origin + 16, the
// heightfield recomputed from noise where the area path gathers it from the neighbouring
// chunks' K1 outputs.  heightfield_column is a function of the world column alone, so the
// window equals those outputs bit for bit.  h18 [B, 18, 18] is the window; the 16x16 inner
// columns also write hf [B, 16, 16] and their weights [B, 24, 16, 16], as K1 does.
__global__ void heightfield_window_kernel(const int* __restrict__ pos, int B,
                                          const int* __restrict__ noise_w, float* __restrict__ h18,
                                          float* __restrict__ hf, float* __restrict__ w_out) {
  int tid = blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= B * 324) return;
  int b = tid / 324, c = tid % 324;
  int lz = c / 18 - 1, lx = c % 18 - 1;
  float wx = (float)(pos[2 * b] + lx);
  float wz = (float)(pos[2 * b + 1] + lz);
  float w[NUM_BIOMES];
  float h = heightfield_column(wx, wz, noise_w, w);
  h18[tid] = h;
  if (lx < 0 || lx > 15 || lz < 0 || lz > 15) return;
  int col = lz * 16 + lx;
  hf[b * 256 + col] = h;
  for (int k = 0; k < NUM_BIOMES; ++k) w_out[(b * NUM_BIOMES + k) * 256 + col] = w[k];
}

extern "C" int mmt_heightfield_window(const int* pos, int B, const int* noise_w, float* h18,
                                      float* hf, float* w, void* stream) {
  const int threads = 128;
  int blocks = (B * 324 + threads - 1) / threads;
  heightfield_window_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(pos, B, noise_w, h18, hf,
                                                                           w);
  return (int)cudaGetLastError();
}

extern "C" int mmt_heightfield(const int* pos, int B, const int* noise_w, float* hf, float* w,
                               void* stream) {
  const int threads = 128;
  int blocks = (B * 256 + threads - 1) / threads;
  heightfield_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(pos, B, noise_w, hf, w);
  return (int)cudaGetLastError();
}
