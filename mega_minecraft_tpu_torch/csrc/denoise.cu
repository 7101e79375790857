// K14: the edge-avoiding à-trous denoiser, one launch per iteration on ping-pong buffers.
//
// Replaces mega_minecraft_tpu/render/denoise.py:32 atrous_denoise, jitted XLA on the TPU.
// Iteration i filters the colour with the 5x5 pattern at stride 2^i: tap (ty, tx) reads the
// pixel (y - ty * stride, x - tx * stride) modulo the frame (jnp.roll wraps around), and
// weighs it by F(B3[ty] * B3[tx]) * expf(-|dc|² * inv - |da|² / σa² - |dn|² / σn²), where
// inv = clip(nsamp, 1, 64) / σc² per pixel (or 1 / σc²); the colour of iteration i + 1 is
// the weighted mean.  Each iteration reads the whole output of the one before, hence one
// launch each.  Sums run as in the plain version (render/denoise.py): taps ty outer, tx
// inner, each squared distance (d0² + d1²) + d2², no multiply-add; the plain version's
// torch.exp on the card is the same expf, so the two agree bit for bit.
//
// One thread per pixel, 25 taps of 9 floats each (colour, albedo, normal) read through L1
// / L2.  Bound: the larger of bytes (per iteration the colour read and written, the
// guides and nsamp read once per call) and operations (~45 per tap: 3 three-channel
// distances, 2 divisions, expf ~ 10, the weighted sums; 25 taps, 4 iterations).

#include <stdint.h>

#include "mmt_math.cuh"

namespace {

__global__ void atrous_kernel(const float* __restrict__ c, const float* __restrict__ alb,
                              const float* __restrict__ nrm, const float* __restrict__ nsamp, float inv_const,
                              float sc2, float sa2, float sn2, int H, int W, int stride, float* __restrict__ out) {
  long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= (long long)H * W) return;
  const double B3[5] = {1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0};
  int y = (int)(p / W), x = (int)(p % W);
  float inv = inv_const;
  if (nsamp) inv = fminf(fmaxf(nsamp[p], 1.f), 64.f) / sc2;
  float c0 = c[p * 3], c1 = c[p * 3 + 1], c2 = c[p * 3 + 2];
  float a0 = alb[p * 3], a1 = alb[p * 3 + 1], a2 = alb[p * 3 + 2];
  float n0 = nrm[p * 3], n1 = nrm[p * 3 + 1], n2 = nrm[p * 3 + 2];
  float acc0 = 0.f, acc1 = 0.f, acc2 = 0.f, wsum = 0.f;
  for (int ty = -2; ty <= 2; ++ty) {
    int yy = ((y - ty * stride) % H + H) % H;
    for (int tx = -2; tx <= 2; ++tx) {
      int xx = ((x - tx * stride) % W + W) % W;
      long long q = ((long long)yy * W + xx) * 3;
      float s0 = c[q], s1 = c[q + 1], s2 = c[q + 2];
      float d0 = s0 - c0, d1 = s1 - c1, d2 = s2 - c2;
      float dc = (d0 * d0 + d1 * d1) + d2 * d2;
      d0 = alb[q] - a0, d1 = alb[q + 1] - a1, d2 = alb[q + 2] - a2;
      float da = (d0 * d0 + d1 * d1) + d2 * d2;
      d0 = nrm[q] - n0, d1 = nrm[q + 1] - n1, d2 = nrm[q + 2] - n2;
      float dn = (d0 * d0 + d1 * d1) + d2 * d2;
      float w = (float)(B3[ty + 2] * B3[tx + 2]) * expf((-dc) * inv - da / sa2 - dn / sn2);
      acc0 = acc0 + s0 * w;
      acc1 = acc1 + s1 * w;
      acc2 = acc2 + s2 * w;
      wsum = wsum + w;
    }
  }
  float den = mmt::fmax_nan(wsum, F(1e-6));
  out[p * 3] = acc0 / den;
  out[p * 3 + 1] = acc1 / den;
  out[p * 3 + 2] = acc2 / den;
}

}  // namespace

// color, albedo, normal [H, W, 3] f32, nsamp [H, W] f32 or null; inv_const = F(1/σc²),
// sc2 = F(σc²), sa2 = F(σa²), sn2 = F(σn²); bufs: two [H, W, 3] f32 buffers, the result in
// bufs + ((iterations - 1) % 2) * H * W * 3
extern "C" int mmt_atrous_denoise(const float* color, const float* albedo, const float* normal, const float* nsamp,
                                  int iterations, float inv_const, float sc2, float sa2, float sn2, int H, int W,
                                  float* bufs, void* stream) {
  long long n = (long long)H * W;
  if (n == 0) return 0;
  unsigned g = (unsigned)((n + 127) / 128);
  for (int it = 0; it < iterations; ++it) {
    const float* src = it == 0 ? color : bufs + ((it - 1) % 2) * n * 3;
    atrous_kernel<<<g, 128, 0, (cudaStream_t)stream>>>(src, albedo, normal, nsamp, inv_const, sc2, sa2, sn2, H, W,
                                                       1 << it, bufs + (it % 2) * n * 3);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
