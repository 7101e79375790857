// K15 (upscale2x_kernel) and K16 (present_kernel): the present path's 2x bilinear upscale
// and ACES tonemap.
//
// K15 replaces mega_minecraft_tpu/render/denoise.py:112 upscale2x (jax.image.resize,
// bilinear, half-pixel centres), jitted XLA on the TPU.  At scale 2 every output pixel lies
// a quarter pixel from its nearest input pixel: weights 0.75 / 0.25, and at the border the
// resize renormalises the weights of the taps inside the image, which is the nearest pixel
// alone, i.e. the neighbour index clamped.  The kernel lerps along x then along y with
// those weights, as the plain version (render/denoise.py upscale2x_plain) does, so the two
// agree bit for bit; JAX contracts both axes in one product and differs by about an ulp.
// Output rows 2p - 1 and 2p both lie between input rows p - 1 and p (clamped), and output
// pixels 2c - 1 and 2c between input pixels c - 1 and c: so one thread takes the two output
// rows of a row pair (p = blockIdx.y, no division) and a run of 4 output pixels of each,
// reads the 2 x 4 input pixels once through the read-only path, lerps each input row along
// x once and writes each output row's run as three 16-byte stores (scalar ones where a run
// is cut by the right edge or a row is not 16-byte aligned, as with an odd width).  The
// first and last row pairs write one row each.  Bound: bytes ([H, W, 3] read once,
// [2H, 2W, 3] written once), 9.3 us at 960 x 540 on the H100.
//
// K16 replaces mega_minecraft_tpu/render/tonemap.py:22 present (+ aces_film :16): the
// Narkowicz rational with no multiply-add (-fmad=false), powf to F(1/2.2), clip, *255 +
// 0.5 and truncation to u8; the plain version calls torch.pow with the same f32 exponent,
// which on the card is the same powf.  One thread per channel.  Bound: bytes (f32 read,
// u8 written).

#include <stdint.h>

#include "mmt_math.cuh"

namespace {

#define UPSCALE_RUN 4  // output pixels a thread writes in each of its two rows

// one output row's run of n <= 4 pixels, 16-byte stores where the run is whole and aligned
__device__ __forceinline__ void store_run(float* dst, const float (&v)[3 * UPSCALE_RUN], int n) {
  if (n == UPSCALE_RUN && ((uintptr_t)dst & 15) == 0) {
    float4* d4 = reinterpret_cast<float4*>(dst);
    d4[0] = make_float4(v[0], v[1], v[2], v[3]);
    d4[1] = make_float4(v[4], v[5], v[6], v[7]);
    d4[2] = make_float4(v[8], v[9], v[10], v[11]);
  } else {
    for (int i = 0; i < 3 * n; ++i) dst[i] = v[i];
  }
}

__global__ void upscale2x_kernel(const float* __restrict__ img, int H, int W, float* __restrict__ out) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;  // run: output pixels 4k .. 4k + 3
  const int W2 = 2 * W;
  if (UPSCALE_RUN * k >= W2) return;
  const int n = min(UPSCALE_RUN, W2 - UPSCALE_RUN * k);
  // input pixels 2k - 1 .. 2k + 2, clamped; output pixel 4k + j lerps c[nr[j]] with c[fr[j]]
  const int c[4] = {max(2 * k - 1, 0), 2 * k, min(2 * k + 1, W - 1), min(2 * k + 2, W - 1)};
  const int nr[UPSCALE_RUN] = {1, 1, 2, 2}, fr[UPSCALE_RUN] = {0, 2, 1, 3};
  for (int p = blockIdx.y; p <= H; p += gridDim.y) {
    const int ra = max(p - 1, 0), rb = min(p, H - 1);  // the input rows above and below the pair
    const float* rows[2] = {img + (size_t)ra * W * 3, img + (size_t)rb * W * 3};
    float h[2][3 * UPSCALE_RUN];  // each input row lerped along x at the run's pixels
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float px[4][3];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) px[i][ch] = __ldg(rows[r] + c[i] * 3 + ch);
#pragma unroll
      for (int j = 0; j < UPSCALE_RUN; ++j)
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) h[r][3 * j + ch] = 0.75f * px[nr[j]][ch] + 0.25f * px[fr[j]][ch];
    }
    float v[3 * UPSCALE_RUN];
    if (p > 0) {  // output row 2p - 1: nearest input row p - 1 (a), far row p (b)
#pragma unroll
      for (int i = 0; i < 3 * UPSCALE_RUN; ++i) v[i] = 0.75f * h[0][i] + 0.25f * h[1][i];
      store_run(out + ((size_t)(2 * p - 1) * W2 + UPSCALE_RUN * k) * 3, v, n);
    }
    if (p < H) {  // output row 2p: nearest input row p (b), far row p - 1 (a)
#pragma unroll
      for (int i = 0; i < 3 * UPSCALE_RUN; ++i) v[i] = 0.75f * h[1][i] + 0.25f * h[0][i];
      store_run(out + ((size_t)(2 * p) * W2 + UPSCALE_RUN * k) * 3, v, n);
    }
  }
}

__global__ void present_kernel(const float* __restrict__ hdr, long long n, uint8_t* __restrict__ out) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float x = hdr[i];
  float num = x * (F(2.51) * x + F(0.03));
  float den = x * (F(2.43) * x + F(0.59)) + F(0.14);
  float ldr = powf(mmt::clamp01(num / den), F(1.0 / 2.2));
  out[i] = (uint8_t)(mmt::clamp01(ldr) * 255.f + 0.5f);
}

}  // namespace

extern "C" int mmt_upscale2x(const float* img, int H, int W, float* out, void* stream) {
  if (H > 0 && W > 0) {
    const int threads = 128, runs = (2 * W + UPSCALE_RUN - 1) / UPSCALE_RUN;
    dim3 grid((runs + threads - 1) / threads, min(H + 1, 65535));
    upscale2x_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(img, H, W, out);
  }
  return (int)cudaGetLastError();
}

extern "C" int mmt_present(const float* hdr, long long n, uint8_t* out, void* stream) {
  if (n > 0) present_kernel<<<(unsigned)((n + 255) / 256), 256, 0, (cudaStream_t)stream>>>(hdr, n, out);
  return (int)cudaGetLastError();
}
