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
// One thread per output float.  Bound: bytes ([H, W, 3] read once, [2H, 2W, 3] written).
//
// K16 replaces mega_minecraft_tpu/render/tonemap.py:22 present (+ aces_film :16): the
// Narkowicz rational with no multiply-add (-fmad=false), powf to F(1/2.2), clip, *255 +
// 0.5 and truncation to u8; the plain version calls torch.pow with the same f32 exponent,
// which on the card is the same powf.  One thread per channel.  Bound: bytes (f32 read,
// u8 written).

#include <stdint.h>

#include "mmt_math.cuh"

namespace {

__global__ void upscale2x_kernel(const float* __restrict__ img, int H, int W, float* __restrict__ out) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long n = 4LL * H * W * 3;
  if (i >= n) return;
  int ch = (int)(i % 3);
  long long p = i / 3;
  int ox = (int)(p % (2 * W)), oy = (int)(p / (2 * W));
  int r0 = oy / 2, c0 = ox / 2;
  int rf = min(max((oy % 2 == 0) ? r0 - 1 : r0 + 1, 0), H - 1);
  int cf = min(max((ox % 2 == 0) ? c0 - 1 : c0 + 1, 0), W - 1);
  float h0 = 0.75f * img[((long long)r0 * W + c0) * 3 + ch] + 0.25f * img[((long long)r0 * W + cf) * 3 + ch];
  float h1 = 0.75f * img[((long long)rf * W + c0) * 3 + ch] + 0.25f * img[((long long)rf * W + cf) * 3 + ch];
  out[i] = 0.75f * h0 + 0.25f * h1;
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
  long long n = 4LL * H * W * 3;
  if (n > 0) upscale2x_kernel<<<(unsigned)((n + 255) / 256), 256, 0, (cudaStream_t)stream>>>(img, H, W, out);
  return (int)cudaGetLastError();
}

extern "C" int mmt_present(const float* hdr, long long n, uint8_t* out, void* stream) {
  if (n > 0) present_kernel<<<(unsigned)((n + 255) / 256), 256, 0, (cudaStream_t)stream>>>(hdr, n, out);
  return (int)cudaGetLastError();
}
