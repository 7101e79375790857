// K2 and K2s: material layers, with the 18x18 halo gather and (under a flag)
// fix_backward_stratified folded in.
//
// K2 replaces mega_minecraft_tpu/terrain/layers.py:60 generate_layers (+ :28
// total_material_weights, :36 max_slope, :118 fix_backward_stratified) and the halo
// slice + inner-chunk selection of pipeline.py:56-72, all jitted XLA on the TPU.  K2s
// replaces the streaming scheduler's _stage_layers (scheduler.py:96-102) with
// gather.py:27,34 gather_heightfield(s)_3x3/_batch: the same column code, addressed
// through the batch's [B, 3, 3] heightfield slot table and [B] own slots, writing the
// slot table's layers rows in place.  The fix runs only without erosion: erosion moves
// layer 12, from which the fix measures, so then the fix follows erosion (K9).
// One thread per inner column.  The thread reads its 3x3 heightfield neighbourhood
// straight from the halo'd stage-1 output by index arithmetic (no 18x18 copy), does
// the 24 -> 20 biome-to-material contraction as an in-thread loop over c = 0..23
// (it replaced an MXU einsum; 480 FLOPs do not need a tensor core), runs the 10
// forward / 2 backward stratified fBm thicknesses and 8 slope-limited eroded layers,
// applies the backward-stratified fixup, and writes the inner chunk's layers,
// heightfield, weights and origin.
//
// K2h's second half (layers_window_kernel) reads each chunk's own 18x18 window, which
// heightfield_window_kernel (heightfield.cu) recomputed, instead of gathering it.
//
// Bound on the H100: arithmetic (11 five-octave fBm per column); the 9 neighbour
// reads and 24 weight reads per column hit L2/L1 (neighbouring threads read
// neighbouring addresses).

#include "mmt_math.cuh"

using namespace mmt;

// getStratifiedMaterialThickness (layers.py:49-57)
MMT_FN float strat_thickness(int l, float mat_weight, float wx, float wz, const float* thickness,
                             const float* amplitude, const float* scale) {
  float th = thickness[l], amp = amplitude[l], sc = scale[l];
  float off = (float)l * F(5283.64);
  float n = fbm2(wx * sc + off, wz * sc + off, 5);
  float t = fmax_nan(0.f, th + amp * n) * mat_weight;
  return mat_weight > 0.f ? t : 0.f;
}

// one column: its heightfield, max slope, 24 weights -> 20 layer starts (fixed if `fix`)
MMT_FN void layers_column(float wx, float wz, float center, float slope, const float* w,
                          const float* bmw, const float* thickness, const float* amplitude,
                          const float* scale, bool fix, float out[NUM_MATERIALS]) {
  float tmw[NUM_MATERIALS];
  for (int m = 0; m < NUM_MATERIALS; ++m) {
    float acc = 0.f;
    for (int c = 0; c < NUM_BIOMES; ++c) acc = acc + w[c] * bmw[c * NUM_MATERIALS + m];
    tmw[m] = acc;
  }
  const int n_fwd = NUM_FORWARD_MATERIALS, n_strat = NUM_STRATIFIED_MATERIALS;
  float height = 0.f;
  for (int l = 0; l < n_fwd; ++l) {
    out[l] = height;
    if (l < n_fwd - 1)
      height = height + strat_thickness(l, tmw[l], wx, wz, thickness, amplitude, scale);
  }
  height = 0.f;
  for (int l = n_strat - 1; l >= n_fwd; --l) {
    height = height + strat_thickness(l, tmw[l], wx, wz, thickness, amplitude, scale);
    out[l] = height;
  }
  height = center;
  for (int l = NUM_MATERIALS - 1; l >= n_strat; --l) {
    float th = thickness[l], ms = scale[l];
    float layer_h = fmax_nan(0.f, th * ((ms - slope) / ms)) * tmw[l];
    height = height - layer_h;
    out[l] = height;
  }
  // fix_backward_stratified: cumulative thickness -> start below the eroded base
  if (fix)
    for (int l = n_fwd; l < n_strat; ++l) out[l] = out[n_strat] - out[l];
}

// thread tid = b * 256 + z * 16 + x over the B = ncz * ncx inner chunks
MMT_FN void layers_thread(int tid, const float* hf_halo, const float* w_halo, const int* pos_halo,
                          int ncx, const float* bmw, const float* thickness,
                          const float* amplitude, const float* scale, const int* dirs, bool fix,
                          float* layers_out, float* hf_in, float* w_in, int* pos_in) {
  int b = tid >> 8, col = tid & 255;
  int z = col >> 4, x = col & 15;
  int hx = ncx + 2;
  int iz = b / ncx, ix = b % ncx;
  int hb = (iz + 1) * hx + ix + 1;  // this chunk in the halo grid
  int gz = (iz + 1) * 16 + z, gx = (ix + 1) * 16 + x;  // block coords in the halo grid
  float center = hf_halo[hb * 256 + col];
  float slope = 0.f;
  for (int i = 0; i < 8; ++i) {
    int az = gz + dirs[2 * i + 1], ax = gx + dirs[2 * i];
    float nb = hf_halo[((az >> 4) * hx + (ax >> 4)) * 256 + (az & 15) * 16 + (ax & 15)];
    float s = fabsf(nb - center);
    if (i & 1) s = s * F(1.41421356237309504880);  // diagonal
    slope = fmax_nan(slope, s);
  }
  float w[NUM_BIOMES];
  for (int c = 0; c < NUM_BIOMES; ++c) {
    w[c] = w_halo[(hb * NUM_BIOMES + c) * 256 + col];
    w_in[(b * NUM_BIOMES + c) * 256 + col] = w[c];
  }
  float wx = (float)(pos_halo[2 * hb] + x);
  float wz = (float)(pos_halo[2 * hb + 1] + z);
  float out[NUM_MATERIALS];
  layers_column(wx, wz, center, slope, w, bmw, thickness, amplitude, scale, fix, out);
  for (int l = 0; l < NUM_MATERIALS; ++l) layers_out[(b * NUM_MATERIALS + l) * 256 + col] = out[l];
  hf_in[tid] = center;
  if (col == 0) {
    pos_in[2 * b] = pos_halo[2 * hb];
    pos_in[2 * b + 1] = pos_halo[2 * hb + 1];
  }
}

__global__ void layers_kernel(const float* __restrict__ hf_halo, const float* __restrict__ w_halo,
                              const int* __restrict__ pos_halo, int ncx, int ncz,
                              const float* __restrict__ bmw, const float* __restrict__ thickness,
                              const float* __restrict__ amplitude, const float* __restrict__ scale,
                              const int* __restrict__ dirs, int fix, float* __restrict__ layers_out,
                              float* __restrict__ hf_in, float* __restrict__ w_in,
                              int* __restrict__ pos_in) {
  int tid = blockIdx.x * blockDim.x + threadIdx.x;
  if (tid < ncx * ncz * 256)
    layers_thread(tid, hf_halo, w_halo, pos_halo, ncx, bmw, thickness, amplitude, scale, dirs,
                  fix != 0, layers_out, hf_in, w_in, pos_in);
}

// K2s: thread tid = b * 256 + z * 16 + x over the batch; nslots[b] is the chunk's 3x3
// neighbourhood [dz + 1][dx + 1], slots[b] its own row of the slot table
__global__ void layers_slots_kernel(float* __restrict__ d_layers, const float* __restrict__ d_hf,
                                    const float* __restrict__ d_w, const int* __restrict__ nslots,
                                    const int* __restrict__ slots, const int* __restrict__ pos,
                                    int B, const float* __restrict__ bmw,
                                    const float* __restrict__ thickness,
                                    const float* __restrict__ amplitude,
                                    const float* __restrict__ scale, const int* __restrict__ dirs,
                                    int fix) {
  int tid = blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= B * 256) return;
  int b = tid >> 8, col = tid & 255;
  int z = col >> 4, x = col & 15;
  const int* ns = nslots + b * 9;
  size_t own = (size_t)slots[b];
  float center = d_hf[(size_t)ns[4] * 256 + col];
  float slope = 0.f;
  for (int i = 0; i < 8; ++i) {
    int az = 16 + z + dirs[2 * i + 1], ax = 16 + x + dirs[2 * i];  // block in the 48x48 grid
    float nb = d_hf[(size_t)ns[(az >> 4) * 3 + (ax >> 4)] * 256 + (az & 15) * 16 + (ax & 15)];
    float s = fabsf(nb - center);
    if (i & 1) s = s * F(1.41421356237309504880);  // diagonal
    slope = fmax_nan(slope, s);
  }
  float w[NUM_BIOMES];
  for (int c = 0; c < NUM_BIOMES; ++c) w[c] = d_w[(own * NUM_BIOMES + c) * 256 + col];
  float out[NUM_MATERIALS];
  layers_column((float)(pos[2 * b] + x), (float)(pos[2 * b + 1] + z), center, slope, w, bmw,
                thickness, amplitude, scale, fix != 0, out);
  for (int l = 0; l < NUM_MATERIALS; ++l) d_layers[(own * NUM_MATERIALS + l) * 256 + col] = out[l];
}

// K2h, second half (replaces mega_minecraft_tpu/parallel/sharding.py:73-76, generate_layers
// + fix_backward_stratified on the recomputed window): thread tid = b * 256 + z * 16 + x;
// the max slope from the chunk's own window h18 [B, 18, 18], the weights [B, 24, 16, 16]
// and origin pos [B, 2], then the column code of K2 with the backward fix
__global__ void layers_window_kernel(const float* __restrict__ h18, const float* __restrict__ w_in,
                                     const int* __restrict__ pos, int B,
                                     const float* __restrict__ bmw,
                                     const float* __restrict__ thickness,
                                     const float* __restrict__ amplitude,
                                     const float* __restrict__ scale, const int* __restrict__ dirs,
                                     float* __restrict__ layers_out) {
  int tid = blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= B * 256) return;
  int b = tid >> 8, col = tid & 255;
  int z = col >> 4, x = col & 15;
  const float* win = h18 + b * 324;
  float center = win[(z + 1) * 18 + x + 1];
  float slope = 0.f;
  for (int i = 0; i < 8; ++i) {
    float nb = win[(z + 1 + dirs[2 * i + 1]) * 18 + x + 1 + dirs[2 * i]];
    float s = fabsf(nb - center);
    if (i & 1) s = s * F(1.41421356237309504880);  // diagonal
    slope = fmax_nan(slope, s);
  }
  float w[NUM_BIOMES];
  for (int c = 0; c < NUM_BIOMES; ++c) w[c] = w_in[(b * NUM_BIOMES + c) * 256 + col];
  float out[NUM_MATERIALS];
  layers_column((float)(pos[2 * b] + x), (float)(pos[2 * b + 1] + z), center, slope, w, bmw,
                thickness, amplitude, scale, true, out);
  for (int l = 0; l < NUM_MATERIALS; ++l) layers_out[(b * NUM_MATERIALS + l) * 256 + col] = out[l];
}

extern "C" int mmt_layers_window(const float* h18, const float* w, const int* pos, int B,
                                 const float* bmw, const float* thickness, const float* amplitude,
                                 const float* scale, const int* dirs, float* layers_out,
                                 void* stream) {
  const int threads = 128;
  int blocks = (B * 256 + threads - 1) / threads;
  layers_window_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      h18, w, pos, B, bmw, thickness, amplitude, scale, dirs, layers_out);
  return (int)cudaGetLastError();
}

extern "C" int mmt_layers(const float* hf_halo, const float* w_halo, const int* pos_halo, int ncx,
                          int ncz, const float* bmw, const float* thickness, const float* amplitude,
                          const float* scale, const int* dirs, int fix, float* layers_out,
                          float* hf_in, float* w_in, int* pos_in, void* stream) {
  const int threads = 128;
  int blocks = (ncx * ncz * 256 + threads - 1) / threads;
  layers_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(hf_halo, w_halo, pos_halo, ncx, ncz,
                                                               bmw, thickness, amplitude, scale,
                                                               dirs, fix, layers_out, hf_in, w_in,
                                                               pos_in);
  return (int)cudaGetLastError();
}

extern "C" int mmt_layers_slots(float* d_layers, const float* d_hf, const float* d_w,
                                const int* nslots, const int* slots, const int* pos, int B,
                                const float* bmw, const float* thickness, const float* amplitude,
                                const float* scale, const int* dirs, int fix, void* stream) {
  const int threads = 128;
  int blocks = (B * 256 + threads - 1) / threads;
  layers_slots_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      d_layers, d_hf, d_w, nslots, slots, pos, B, bmw, thickness, amplitude, scale, dirs, fix);
  return (int)cudaGetLastError();
}
