// K13 (reproject_kernel) and K13s (static_blend_kernel): temporal accumulation of the
// 1-spp sample into per-pixel history.
//
// K13 replaces mega_minecraft_tpu/render/reproject.py:47 reproject_history with :122 _blend
// (via :135 render_accumulate_temporal), jitted XLA on the TPU.  Per pixel: the centre ray
// of the new camera (camera.pixel_rays with jitter 0.5) to its first hit, that point's
// offset from the previous camera, its projection px, py there (two divisions each, as
// JAX writes them; clamped to [-2, W + 1] / [-2, H + 1] before the integer cast, which
// moves no in-bounds tap), then the 4-tap bilinear gather of the 11-float history
// (colour, albedo, normal, min(depth, DEPTH_CAP), nsamp) in the taps' order (0,0), (1,0),
// (0,1), (1,1), a tap counting only inside the frame, in front of the camera and within
// max(0.04 * dist, 0.75) of the expected distance; footprints under 0.25 carry nothing.
// The blend follows in the same thread: nsamp = min(history, 64), a running average with
// weight 1 / (nsamp + 1).  It gathers neighbours of the history, so it writes new buffers.
//
// K13s replaces the blend of :158 render_accumulate_static: pointwise, the history
// shortened to 3 where the first-hit distance moved beyond the same tolerance.
//
// Every operation is the plain version's (render/reproject.py) in its order, with no
// multiply-add, so the two agree bit for bit on the card.  One thread per pixel.  Bound:
// bytes (history 11 floats and sample 10 floats read, 11 written per pixel; K13 reads
// its taps mostly from L2, counted once).

#include <stdint.h>

#include "mmt_math.cuh"

#define DEPTH_CAP F(1e6)
#define N_MAX 64.f

namespace {

__device__ __forceinline__ void blend_out(float hist_n, const float* hc, const float* ha, const float* hn,
                                          const float* c, const float* a, const float* n, long long p, float d,
                                          float* oc, float* oa, float* on, float* od, float* ons) {
  float ns = fminf(hist_n, N_MAX);
  float w = 1.f / (ns + 1.f);
  for (int k = 0; k < 3; ++k) {
    oc[p * 3 + k] = hc[k] + (c[p * 3 + k] - hc[k]) * w;
    oa[p * 3 + k] = ha[k] + (a[p * 3 + k] - ha[k]) * w;
    on[p * 3 + k] = hn[k] + (n[p * 3 + k] - hn[k]) * w;
  }
  od[p] = d;
  ons[p] = ns + 1.f;
}

// cams: the previous camera's position, forward, right, up, pixel_length, then the new
// camera's (14 floats each)
__global__ void reproject_kernel(const float* __restrict__ hc, const float* __restrict__ ha,
                                 const float* __restrict__ hn, const float* __restrict__ hd,
                                 const float* __restrict__ hns, const float* __restrict__ c,
                                 const float* __restrict__ a, const float* __restrict__ n,
                                 const float* __restrict__ d, const float* __restrict__ cams, int H, int W,
                                 float* __restrict__ oc, float* __restrict__ oa, float* __restrict__ on,
                                 float* __restrict__ od, float* __restrict__ ons) {
  long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= (long long)H * W) return;
  const float *qp = cams, *f = cams + 3, *r = cams + 6, *u = cams + 9, *pl = cams + 12;
  const float *np_ = cams + 14, *nf = cams + 17, *nr = cams + 20, *nu = cams + 23, *npl = cams + 26;
  int y = (int)(p / W), x = (int)(p % W);
  float half_w = (float)W * 0.5f, half_h = (float)H * 0.5f;
  // the new camera's centre ray (camera.pixel_rays, jitter 0.5)
  float sx = (((float)x - half_w) + 0.5f) * npl[0];
  float sy = (((float)y - half_h) + 0.5f) * npl[1];
  float dx = (nf[0] - nr[0] * sx) - nu[0] * sy;
  float dy = (nf[1] - nr[1] * sx) - nu[1] * sy;
  float dz = (nf[2] - nr[2] * sx) - nu[2] * sy;
  float norm = sqrtf((dx * dx + dy * dy) + dz * dz);
  dx = dx / norm, dy = dy / norm, dz = dz / norm;
  float dn = d[p];
  float de = fminf(dn, DEPTH_CAP);
  float vx = (np_[0] + dx * de) - qp[0];
  float vy = (np_[1] + dy * de) - qp[1];
  float vz = (np_[2] + dz * de) - qp[2];
  float vf = (vx * f[0] + vy * f[1]) + vz * f[2];
  float vr = (vx * r[0] + vy * r[1]) + vz * r[2];
  float vu = (vx * u[0] + vy * u[1]) + vz * u[2];
  bool in_front = vf > F(1e-3);
  float safe = in_front ? vf : 1.f;
  float px = ((-vr / safe) / pl[0] + half_w) - 0.5f;
  float py = ((-vu / safe) / pl[1] + half_h) - 0.5f;
  px = fminf(fmaxf(px, -2.f), (float)(W + 1));
  py = fminf(fmaxf(py, -2.f), (float)(H + 1));
  float dist = sqrtf((vx * vx + vy * vy) + vz * vz);
  float tol = fmaxf(F(0.04) * dist, F(0.75));
  float x0 = floorf(px), y0 = floorf(py);
  float fx = px - x0, fy = py - y0;
  int x0i = (int)x0, y0i = (int)y0;
  float acc[11];
  for (int k = 0; k < 11; ++k) acc[k] = 0.f;
  float wsum = 0.f;
  for (int t = 0; t < 4; ++t) {
    int ox = t & 1, oy = t >> 1;
    float bw = (ox ? fx : 1.f - fx) * (oy ? fy : 1.f - fy);
    int tx = x0i + ox, ty = y0i + oy;
    bool inb = tx >= 0 && tx < W && ty >= 0 && ty < H && in_front;
    long long q = inb ? (long long)ty * W + tx : 0;
    float tap[11] = {hc[q * 3], hc[q * 3 + 1], hc[q * 3 + 2], ha[q * 3], ha[q * 3 + 1], ha[q * 3 + 2],
                     hn[q * 3], hn[q * 3 + 1], hn[q * 3 + 2], fminf(hd[q], DEPTH_CAP), hns[q]};
    bool valid = inb && fabsf(tap[9] - dist) <= tol;
    float w = valid ? bw : 0.f;
    for (int k = 0; k < 11; ++k) acc[k] = acc[k] + tap[k] * w;
    wsum = wsum + w;
  }
  float inv = wsum > 0.25f ? 1.f / fmaxf(wsum, F(1e-6)) : 0.f;
  float h[11];
  for (int k = 0; k < 11; ++k) h[k] = acc[k] * inv;
  blend_out(h[10], h, h + 3, h + 6, c, a, n, p, dn, oc, oa, on, od, ons);
}

__global__ void static_blend_kernel(const float* __restrict__ hc, const float* __restrict__ ha,
                                    const float* __restrict__ hn, const float* __restrict__ hd,
                                    const float* __restrict__ hns, const float* __restrict__ c,
                                    const float* __restrict__ a, const float* __restrict__ n,
                                    const float* __restrict__ d, long long count, float* __restrict__ oc,
                                    float* __restrict__ oa, float* __restrict__ on, float* __restrict__ od,
                                    float* __restrict__ ons) {
  long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= count) return;
  float dn = d[p];
  float tol = fmaxf(F(0.04) * dn, F(0.75));
  bool same = fabsf(fminf(hd[p], DEPTH_CAP) - dn) <= tol;
  float ns = same ? hns[p] : fminf(hns[p], 3.f);
  float h[9];
  for (int k = 0; k < 3; ++k) h[k] = hc[p * 3 + k], h[3 + k] = ha[p * 3 + k], h[6 + k] = hn[p * 3 + k];
  blend_out(ns, h, h + 3, h + 6, c, a, n, p, dn, oc, oa, on, od, ons);
}

}  // namespace

// history colour, albedo, normal [H, W, 3], depth, nsamp [H, W]; the sample's colour,
// albedo, normal, depth; cams [28] f32 on the device; outputs as the history
extern "C" int mmt_reproject(const float* hc, const float* ha, const float* hn, const float* hd, const float* hns,
                             const float* c, const float* a, const float* n, const float* d, const float* cams, int H,
                             int W, float* oc, float* oa, float* on, float* od, float* ons, void* stream) {
  long long count = (long long)H * W;
  if (count > 0)
    reproject_kernel<<<(unsigned)((count + 127) / 128), 128, 0, (cudaStream_t)stream>>>(
        hc, ha, hn, hd, hns, c, a, n, d, cams, H, W, oc, oa, on, od, ons);
  return (int)cudaGetLastError();
}

extern "C" int mmt_static_blend(const float* hc, const float* ha, const float* hn, const float* hd, const float* hns,
                                const float* c, const float* a, const float* n, const float* d, long long count,
                                float* oc, float* oa, float* on, float* od, float* ons, void* stream) {
  if (count > 0)
    static_blend_kernel<<<(unsigned)((count + 255) / 256), 256, 0, (cudaStream_t)stream>>>(
        hc, ha, hn, hd, hns, c, a, n, d, count, oc, oa, on, od, ons);
  return (int)cudaGetLastError();
}
