// K17: the debug renderer's frame (direct light, shadows, fog, bloom).
//
// Replaces mega_minecraft_tpu/render/debug_renderer.py:58 render_debug with _gauss_blur
// (:44), jitted XLA on the TPU.  Plain version: render/debug_renderer.py
// render_debug_plain.  One entry point, one launch count, eleven launches:
//  - debug_shade_kernel, one thread per pixel: the primary ray (camera_ray, no jitter)
//    and its DDA (trace_ray, trace.cuh), the material look-up and the optional chunk /
//    zone tint, one shadow trace toward the sun (the moon when sun.y <= 0) where the ray
//    hit, Lambert + ambient + 4x emission, the sky with clouds and stars where it missed,
//    eight shadow traces along the ray for the fog's in-scatter (summed one at a time, in
//    JAX's order) and the fog blend toward the horizon sky; its epilogue writes the frame
//    and its bright pass (luminance > 1);
//  - blur_kernel, 5 strides (1, 2, 4, 8, 16) x (horizontal, then vertical) on ping-pong
//    buffers, wrapping at the borders as jnp.roll does (index (x - i s) mod W); the last
//    vertical pass adds the blur to the frame at 0.35.
// The JAX program traces the shadow ray of every pixel; where the primary ray missed,
// its result is never read, so the kernel skips it.  Arithmetic follows the plain version
// operation by operation (no FMA, IEEE '/' and sqrtf, F(decimal) constants, libm expf and
// sinf as torch calls them, NaN-propagating min and max), so the two agree bit for bit.
//
// Bound on the H100: ten DDA traces a pixel, of dependent 4-byte loads scattered over
// the field, under the divergence of rays that take different step counts (as K11t);
// each blur pass reads and writes the frame once (25 MB at 1080p).

#include <stdint.h>

#include "mmt_math.cuh"
#include "mmt_render_tables.h"
#include "sky.cuh"
#include "trace.cuh"

using namespace mmt;

struct DebugArgs {
  SceneArgs sc;
  const float* params;  // camera and sky, the layout of frame_sky / camera_ray (trace.cuh)
  int height, width, max_steps;
  int tint_cell;  // 0: no tint; 16: per chunk; 192: per zone
  float* img;     // [H, W, 3] the frame before bloom
  float* bright;  // [H, W, 3] its bright pass, then the even blur passes
  float* tmp;     // [H, W, 3] the odd blur passes
  float* out;     // [H, W, 3] img + blur * 0.35
  int32_t* steps; // [H, W] DDA steps of the pixel's traces, or null
};

__global__ void __launch_bounds__(128) debug_shade_kernel(DebugArgs a) {
  int px = blockIdx.x * blockDim.x + threadIdx.x, py = blockIdx.y;
  if (px >= a.width || py >= a.height) return;
  const float* P = a.params;
  const SkyP sky = frame_sky(P);
  float d[3];
  camera_ray(P, px, py, a.width, a.height, 0.f, 0.f, d);
  const float o[3] = {P[0], P[1], P[2]};

  int steps = 0, st;
  TraceOut res = trace_ray(a.sc, o[0], o[1], o[2], d[0], d[1], d[2], BLOCK_AIR, a.max_steps, true, false, 0u,
                           true, &st);
  steps += st;
  const bool hit = res.hit && res.block != BLOCK_AIR;

  const bool use_sun = sky.sun[1] > 0.f;
  const float* L = use_sun ? sky.sun : sky.moon;
  const float light_strength = smoothstep(F(-0.1), F(0.1), fabsf(use_sun ? sky.sun[1] : sky.moon[1]));
  float c[3];
  if (hit) {
    float is[3];
    for (int k = 0; k < 3; ++k) is[k] = o[k] + d[k] * res.t;
    const uint32_t props = BLOCK_PROPS_TAB[res.block];
    const float inv255 = F(1.0 / 255.0);
    float col[3] = {(float)(props & 0xFFu) * inv255, (float)((props >> 8) & 0xFFu) * inv255,
                    (float)((props >> 16) & 0xFFu) * inv255};
    const float emis = (float)((props >> 27) & 0x1Fu) * F(1.0 / 31.0);
    if (a.tint_cell) {  // tint overlays (lambert.frag.glsl:98-108)
      const float cell = (float)a.tint_cell;
      float cx = floorf(is[0] / cell), cz = floorf(is[2] / cell), h[3];
      rand3_from3_r(cx, cz, cx + cz, h);
      for (int k = 0; k < 3; ++k) col[k] = col[k] * (F(0.5) + F(0.5) * h[k]);
    }
    const float eps = F(1e-3);
    TraceOut sres = trace_ray(a.sc, is[0] + res.n[0] * eps, is[1] + res.n[1] * eps, is[2] + res.n[2] * eps, L[0],
                              L[1], L[2], BLOCK_AIR, a.max_steps, true, false, 0u, true, &st);
    steps += st;
    const float ndotl = fmaxn(res.n[0] * L[0] + res.n[1] * L[1] + res.n[2] * L[2], 0.f);
    const float sun_i = use_sun ? 1.f : F(0.12);
    const float ambient = F(0.22) + F(0.18) * smoothstep(F(-0.25), F(0.10), sky.sun[1]);
    const float direct = sres.hit ? 0.f : ndotl * sun_i * light_strength;
    const float shade = ambient + direct + emis * 4.f;
    for (int k = 0; k < 3; ++k) c[k] = col[k] * shade;
  } else {  // the sky, with clouds and stars
    const float cov = cloud_coverage(o[0], o[2], d[0], d[1], d[2], sky);
    sky_color(d[0], d[1], d[2], sky, true, true, true, cov, c);
  }

  // volumetric fog: shadowed in-scatter samples along the primary ray
  const float t_end = hit ? res.t : 300.f;
  float in_scatter = 0.f;
  for (int k = 0; k < DEBUG_FOG_SAMPLES; ++k) {
    const float tk = t_end * (float)((k + 0.5) / DEBUG_FOG_SAMPLES);
    float f[3];
    for (int j = 0; j < 3; ++j) f[j] = o[j] + d[j] * tk;
    TraceOut fsh = trace_ray(a.sc, f[0], f[1], f[2], L[0], L[1], L[2], BLOCK_AIR, a.max_steps, true, false, 0u,
                             true, &st);
    steps += st;
    const float dens = expf(-fmaxn(f[1] - 128.f, 0.f) * F(0.01));
    in_scatter = in_scatter + (fsh.hit ? 0.f : dens) / (float)DEBUG_FOG_SAMPLES;
  }
  float fog_amount = 1.f - expf(-t_end * F(DEBUG_FOG_DENSITY));
  fog_amount = fog_amount * (F(0.35) + F(0.65) * in_scatter) * light_strength;
  float fc[3];
  sky_color(d[0], F(0.05), d[2], sky, true, false, false, 0.f, fc);
  for (int k = 0; k < 3; ++k) c[k] = c[k] + (fc[k] - c[k]) * fog_amount;

  // the bright pass
  const float lum = F(0.2126) * c[0] + F(0.7152) * c[1] + F(0.0722) * c[2];
  const bool bright = lum > F(DEBUG_BLOOM_THRESHOLD);
  const long long p = (long long)py * a.width + px;
  for (int k = 0; k < 3; ++k) {
    a.img[p * 3 + k] = c[k];
    a.bright[p * 3 + k] = bright ? c[k] : 0.f;
  }
  if (a.steps) a.steps[p] = steps;
}

// one pass of the separable 9-tap Gaussian at ``stride`` along x (vertical = 0) or y;
// with img, also img + result * 0.35
__global__ void __launch_bounds__(128) blur_kernel(const float* __restrict__ src, float* __restrict__ dst,
                                                   const float* __restrict__ img, int H, int W, int stride,
                                                   int vertical) {
  int x = blockIdx.x * blockDim.x + threadIdx.x, y = blockIdx.y;
  if (x >= W || y >= H) return;
  const long long p = (long long)y * W + x;
  long long lo[4], hi[4];
  for (int i = 1; i <= 4; ++i) {
    const int s = i * stride;
    if (vertical) {
      lo[i - 1] = (long long)(((y - s) % H + H) % H) * W + x;
      hi[i - 1] = (long long)((y + s) % H) * W + x;
    } else {
      lo[i - 1] = (long long)y * W + ((x - s) % W + W) % W;
      hi[i - 1] = (long long)y * W + (x + s) % W;
    }
  }
  for (int k = 0; k < 3; ++k) {
    float v = src[p * 3 + k] * DEBUG_BLOOM_WEIGHTS[0];
    for (int i = 1; i <= 4; ++i)
      v = v + (src[lo[i - 1] * 3 + k] + src[hi[i - 1] * 3 + k]) * DEBUG_BLOOM_WEIGHTS[i];
    if (img) v = img[p * 3 + k] + v * F(DEBUG_BLOOM_STRENGTH);
    dst[p * 3 + k] = v;
  }
}

extern "C" int mmt_render_debug(const DebugArgs* args, void* stream) {
  DebugArgs a = *args;
  if (a.width <= 0 || a.height <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((a.width + 127) / 128, a.height);
  debug_shade_kernel<<<grid, 128, 0, s>>>(a);
  cudaError_t err = cudaGetLastError();
  float *even = a.bright, *odd = a.tmp;
  for (int pass = 0; pass < DEBUG_BLOOM_PASSES && err == cudaSuccess; ++pass) {
    const bool last = pass == DEBUG_BLOOM_PASSES - 1;
    blur_kernel<<<grid, 128, 0, s>>>(even, odd, nullptr, a.height, a.width, 1 << pass, 0);
    err = cudaGetLastError();
    if (err != cudaSuccess) break;
    blur_kernel<<<grid, 128, 0, s>>>(odd, last ? a.out : even, last ? a.img : nullptr, a.height, a.width,
                                     1 << pass, 1);
    err = cudaGetLastError();
  }
  return (int)err;
}
