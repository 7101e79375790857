// The voxel DDA of one ray and the pinhole camera ray, as device code shared by the
// kernels that trace: K11t and K11 (tracer.cu) and K17 (debug.cu).  Moved here from
// tracer.cu unchanged: kernels/_build.py compiles each .cu on its own (no -rdc), so a
// device function that two sources call lives in a header both include.
//
// trace_ray replaces mega_minecraft_tpu/render/tracer.py:104 trace; camera_ray its
// camera.py:88-123 pixel_rays for one pixel.  Arithmetic as in tracer.cu's notes.
#pragma once

#include <stdint.h>

#include "mmt_math.cuh"
#include "mmt_render_tables.h"
#include "sky.cuh"

using namespace mmt;

namespace {

__device__ __forceinline__ float fminn(float a, float b) { return (a < b || a != a) ? a : b; }
__device__ __forceinline__ float fmaxn(float a, float b) { return (a > b || a != a) ? a : b; }
__device__ __forceinline__ int clampi(int v, int lo, int hi) { return v < lo ? lo : (v > hi ? hi : v); }
__device__ __forceinline__ float signf(float x) { return (float)((0.f < x) - (x < 0.f)); }
// clip(floor(v), 0, hi) with the plain version's handling of huge and non-finite values
__device__ __forceinline__ int floor_i(float v, int hi) {
  float fl = floorf(v);
  if (fl != fl) return 0;
  fl = fl < -1.f ? -1.f : (fl > (float)(hi + 1) ? (float)(hi + 1) : fl);
  return clampi((int)fl, 0, hi);
}
__device__ __forceinline__ float inv_guard(float d) {
  return fabsf(d) < F(1e-12) ? F(1e12) * signf(d) + F(1e12) * (d == 0.f ? 1.f : 0.f) : 1.f / d;
}

#define STEP_GROW (1.f + F(1e-5))

struct SceneArgs {
  const int32_t* flat;
  const uint32_t* tex_diff;
  int zdim, xdim, ydim;
  float o0, o1, o2;
};

struct TraceOut {
  bool hit;
  float t;
  int block;
  float n[3];
};

// the crossed-quad intersections of voxel (vx, vz) (tracer.py:256-263)
__device__ __forceinline__ void quads(float ox, float oz, float dx, float dz, int vx, int vz, float o0,
                                      float o2, float t, float t_exit, float& t_a, float& t_b, bool& ok_a,
                                      bool& ok_b) {
  float cx0 = (float)vx + o0, cz0 = (float)vz + o2;
  float den_a = dx - dz, den_b = dx + dz;
  bool small_a = fabsf(den_a) < F(1e-6), small_b = fabsf(den_b) < F(1e-6);
  t_a = ((cx0 - cz0) + (oz - ox)) / (small_a ? 1.f : den_a);
  t_b = (((1.f + cx0) + cz0) - (ox + oz)) / (small_b ? 1.f : den_b);
  ok_a = !small_a && t_a >= t && t_a <= t_exit;
  ok_b = !small_b && t_b >= t && t_b <= t_exit;
}

__device__ __forceinline__ bool texel_alpha(const uint32_t* tex_diff, int val, float u, float v, int face_base) {
  float cu = u - floorf(u), cv = v - floorf(v);
  cu = cu < 0.f ? 0.f : (cu > F(0.999) ? F(0.999) : cu);
  cv = cv < 0.f ? 0.f : (cv > F(0.999) ? F(0.999) : cv);
  int tu = (int)floorf(cu * 16.f), tv = (int)floorf(cv * 16.f);
  return ((__ldg(tex_diff + (long long)val * (3 * 8 * 256) + face_base + tv * 16 + tu) >> 24) & 1u) != 0u;
}

// the DDA of one ray (tracer.py:104-532); steps: DDA steps taken
__device__ TraceOut trace_ray(const SceneArgs& sc, float ox, float oy, float oz, float dx, float dy, float dz,
                              int medium, int max_steps, bool active, bool stochastic, uint32_t seed,
                              bool use_macro, int* steps_out) {
  const int MS = MACRO_SCALE;
  const int xm = sc.xdim / MS, ym = sc.ydim / MS;
  const long long macro_off = (long long)sc.zdim * sc.xdim * sc.ydim;
  const float o0 = sc.o0, o1 = sc.o1, o2 = sc.o2;
  float idx = inv_guard(dx), idy = inv_guard(dy), idz = inv_guard(dz);
  float tx0 = (o0 - ox) * idx, tx1 = ((o0 + (float)sc.xdim) - ox) * idx;
  float ty0 = (o1 - oy) * idy, ty1 = ((o1 + (float)sc.ydim) - oy) * idy;
  float tz0 = (o2 - oz) * idz, tz1 = ((o2 + (float)sc.zdim) - oz) * idz;
  float t_in = fmaxn(fmaxn(fminn(tx0, tx1), fminn(ty0, ty1)), fminn(tz0, tz1));
  float t_out = fminn(fminn(fmaxn(tx0, tx1), fmaxn(ty0, ty1)), fmaxn(tz0, tz1));
  float t_start = fmaxn(t_in, 0.f) + F(1e-4);
  bool alive = t_out > t_start && t_out > 0.f && active;
  float horiz = sqrtf(dx * dx + dz * dz);
  t_out = fminn(t_out, t_start + F(320.0) / fmaxn(horiz, F(1e-3)));
  const bool is_air = medium == BLOCK_AIR;
  const bool ascending = dy >= 0.f;
  float h_inf = fmaxn(fmaxn(fabsf(dx), fabsf(dz)), F(1e-6));
  float inv_h = 1.f / h_inf;
  float inv_dy_abs = 1.f / fmaxn(fabsf(dy), F(1e-6));
  float inv_maxc = 1.f / fmaxn(h_inf, fabsf(dy));

  float t = alive ? t_start : F(1e20);
  bool hit = false, hit_x = false, x_use_a = false, pending = false, coarse = false;
  int hit_block = 0, steps = 0;
  for (;;) {
    while (alive && steps < max_steps) {
      ++steps;
      int vx = floor_i((ox + dx * t) - o0, sc.xdim - 1);
      int vy = floor_i((oy + dy * t) - o1, sc.ydim - 1);
      int vz = floor_i((oz + dz * t) - o2, sc.zdim - 1);
      long long widx = coarse ? macro_off + ((long long)(vz / MS) * xm + vx / MS) * ym + vy / MS
                              : ((long long)vz * sc.xdim + vx) * sc.ydim + vy;
      uint32_t packed = (uint32_t)__ldg(sc.flat + widx);
      int val = (int)(packed & 0xFFu);
      bool is_solid = val < EMPTY_BASE;
      bool descend = coarse && is_solid;
      float nsol = is_solid ? 0.f : 1.f;
      float up_b = (float)((packed >> 8) & 0x3Fu) * nsol;
      float c2_b = (float)((packed >> 14) & 0x3Fu) * nsol;
      float c8_b = (float)((packed >> 20) & 0x3Fu) * nsol;
      float sky_q = (float)((packed >> 26) & 0x1Fu) * nsol;
      bool is_x = val >= X_SHAPED_LO && val < X_SHAPED_HI;

      float csz = coarse ? (float)MS : 1.f;
      float cellx = (float)(coarse ? vx / MS * MS : vx), celly = (float)(coarse ? vy / MS * MS : vy),
            cellz = (float)(coarse ? vz / MS * MS : vz);
      float bx = dx > 0.f ? (cellx + o0) + csz : cellx + o0;
      float by = dy > 0.f ? (celly + o1) + csz : celly + o1;
      float bz = dz > 0.f ? (cellz + o2) + csz : cellz + o2;
      float tex = fabsf(dx) < F(1e-12) ? F(3e38) : (bx - ox) * idx;
      float tey = fabsf(dy) < F(1e-12) ? F(3e38) : (by - oy) * idy;
      float tez = fabsf(dz) < F(1e-12) ? F(3e38) : (bz - oz) * idz;
      float t_exit = fminn(fminn(tex, tey), tez);

      bool candidate = !coarse && (is_air ? is_solid : val != medium);
      // only a candidate X-shaped voxel reads the crossed quads (two divisions)
      float t_a = 0.f, t_b = 0.f;
      bool ok_a = false, ok_b = false;
      if (candidate && is_x) quads(ox, oz, dx, dz, vx, vz, o0, o2, t, t_exit, t_a, t_b, ok_a, ok_b);
      bool flagged = candidate && (packed & 0x80000000u);
      bool pend_new = false, opaque = true;
      if (stochastic) {
        if (flagged) {
          float t_frac = (float)((packed >> 8) & 0xFFu) * F(1.0 / 255.0);
          uint32_t h = ((uint32_t)vx * 2654435761u) ^ ((uint32_t)vy * 2246822519u + (uint32_t)vz * 3266489917u);
          h ^= seed;
          opaque = rnd_u01(&h) >= t_frac;
        }
      } else {
        pend_new = flagged;
      }
      bool a_first = ok_a && (!ok_b || t_a <= t_b);
      bool new_hit = candidate && !pend_new && (is_x ? (ok_a || ok_b) : true) && opaque;
      if (new_hit) {
        hit = true;
        hit_block = is_solid ? val : BLOCK_AIR;
        if (is_x) {
          hit_x = true;
          x_use_a = a_first;
          t = a_first ? t_a : t_b;
        }
      }
      pending = pending || pend_new;
      alive = alive && !new_hit && !pend_new;

      float skip3d = ((float)val - (float)EMPTY_BASE) * inv_maxc;
      float s_up = (up_b - 1.f) * inv_h;
      float s2 = fminn((c2_b - 1.f) * inv_h, 2.f * inv_dy_abs);
      float s8 = fminn((c8_b - 1.f) * inv_h, 8.f * inv_dy_abs);
      float s_sky = fminn((float)SKY_R * inv_h, (4.f * sky_q - 1.f) * inv_dy_abs);
      float skip_dir = ascending ? s_up : fmaxn(fmaxn(s2, s8), s_sky);
      float skip = (is_air ? fmaxn(skip3d, skip_dir) : 0.f) * (coarse ? (float)MS : 1.f);
      float t_next = fmaxn(t + fmaxn(skip, 0.f), t_exit);
      t_next = fmaxn(t_next, t) * STEP_GROW + F(1e-4);
      if (alive && !descend) t = t_next;
      bool sat = ascending ? up_b >= 63.f : (c8_b >= 63.f || sky_q >= 8.f);
      if (use_macro) coarse = (coarse && !descend) || (alive && !coarse && is_air && sat);
      alive = alive && t < t_out;
    }
    if (!pending) break;
    // resolve the parked voxel: alpha-test its texel(s) (tracer.py:364-456)
    int vx = floor_i((ox + dx * t) - o0, sc.xdim - 1);
    int vy = floor_i((oy + dy * t) - o1, sc.ydim - 1);
    int vz = floor_i((oz + dz * t) - o2, sc.zdim - 1);
    int val = (int)((uint32_t)__ldg(sc.flat + ((long long)vz * sc.xdim + vx) * sc.ydim + vy) & 0xFFu);
    bool is_x = val >= X_SHAPED_LO && val < X_SHAPED_HI;
    float fx = (float)vx, fy = (float)vy, fz = (float)vz;
    float bx = dx > 0.f ? (fx + o0) + 1.f : fx + o0;
    float by = dy > 0.f ? (fy + o1) + 1.f : fy + o1;
    float bz = dz > 0.f ? (fz + o2) + 1.f : fz + o2;
    float tex = fabsf(dx) < F(1e-12) ? F(3e38) : (bx - ox) * idx;
    float tey = fabsf(dy) < F(1e-12) ? F(3e38) : (by - oy) * idy;
    float tez = fabsf(dz) < F(1e-12) ? F(3e38) : (bz - oz) * idz;
    float t_exit = fminn(fminn(tex, tey), tez);
    float t_a = 0.f, t_b = 0.f;
    bool ok_a = false, ok_b = false;
    bool a1, a2 = false;
    if (is_x) {
      quads(ox, oz, dx, dz, vx, vz, o0, o2, t, t_exit, t_a, t_b, ok_a, ok_b);
      float qa_y = oy + dy * t_a, qb_y = oy + dy * t_b;
      a1 = texel_alpha(sc.tex_diff, val, ox + dx * t_a, 1.f - (qa_y - floorf(qa_y)), 0);
      a2 = texel_alpha(sc.tex_diff, val, ox + dx * t_b, 1.f - (qb_y - floorf(qb_y)), 0);
    } else {
      float exf = (((fx + (dx < 0.f ? 1.f : 0.f)) + o0) - ox) * idx;
      float eyf = (((fy + (dy < 0.f ? 1.f : 0.f)) + o1) - oy) * idy;
      float ezf = (((fz + (dz < 0.f ? 1.f : 0.f)) + o2) - oz) * idz;
      float t_en = fmaxn(fmaxn(exf, eyf), ezf);
      bool on_yf = eyf >= t_en && exf < t_en, on_xf = exf >= t_en;
      int face_b = on_yf ? (dy < 0.f ? 1 * 8 * 256 : 2 * 8 * 256) : 0;
      float hxf = ox + dx * t_en, hyf = oy + dy * t_en, hzf = oz + dz * t_en;
      float fu = on_yf ? hxf : (on_xf ? hzf : hxf);
      float fv = on_yf ? hzf : 1.f - (hyf - floorf(hyf));
      a1 = texel_alpha(sc.tex_diff, val, fu, fv, face_b);
    }
    ok_a = ok_a && a1;
    ok_b = ok_b && a2;
    bool a_first = ok_a && (!ok_b || t_a <= t_b);
    bool res_hit = is_x ? (ok_a || ok_b) : a1;
    if (res_hit) {
      hit = true;
      hit_block = val;
      if (is_x) {
        hit_x = true;
        x_use_a = a_first;
        t = a_first ? t_a : t_b;
      }
    } else {
      t = fmaxn(t, t_exit) * STEP_GROW + F(1e-4);
      alive = t < t_out;
    }
    pending = false;
  }

  // hit voxel and entry-face normal
  float vxf = floorf((ox + dx * t) - o0), vyf = floorf((oy + dy * t) - o1), vzf = floorf((oz + dz * t) - o2);
  float ex = (((vxf + (dx < 0.f ? 1.f : 0.f)) + o0) - ox) * idx;
  float ey = (((vyf + (dy < 0.f ? 1.f : 0.f)) + o1) - oy) * idy;
  float ez = (((vzf + (dz < 0.f ? 1.f : 0.f)) + o2) - oz) * idz;
  float t_entry = fmaxn(fmaxn(ex, ey), ez);
  TraceOut r;
  r.n[0] = ex >= t_entry ? -signf(dx) : 0.f;
  r.n[1] = (ey >= t_entry && ex < t_entry) ? -signf(dy) : 0.f;
  r.n[2] = (ez >= t_entry && ex < t_entry && ey < t_entry) ? -signf(dz) : 0.f;
  if (hit_x) {
    const float s = F(0.70710678);
    float sd_a = signf(dx - dz), sd_b = signf(dx + dz);
    r.n[0] = x_use_a ? -sd_a * s : -sd_b * s;
    r.n[1] = 0.f;
    r.n[2] = x_use_a ? sd_a * s : -sd_b * s;
  }
  r.t = hit ? (hit_x ? t : fmaxn(t_entry, 0.f)) : F(1e20);
  if (medium != BLOCK_AIR && hit_block == BLOCK_AIR && hit) {
    r.n[0] = -r.n[0];
    r.n[1] = -r.n[1];
    r.n[2] = -r.n[2];
  }
  r.hit = hit;
  r.block = hit_block;
  *steps_out = steps;
  return r;
}

// the camera and sky parameters of a frame as one f32 vector P: position 0-2, forward
// 3-5, right 6-8, up 9-11, pixel_length 12-13, sun 14-16, moon 17-19, stars_rot 20-28,
// time 29 (kernels/__init__.py _param_vec)
__device__ __forceinline__ SkyP frame_sky(const float* P) {
  SkyP sky;
  for (int k = 0; k < 3; ++k) sky.sun[k] = P[14 + k], sky.moon[k] = P[17 + k];
  for (int k = 0; k < 9; ++k) sky.rot[k] = P[20 + k];
  sky.time = P[29];
  return sky;
}

// the pinhole ray through pixel (ix, iy) of a full_width x full_height frame with
// jitter (j1, j2) (camera.py:88-123): unit direction into dir[3]
__device__ __forceinline__ void camera_ray(const float* P, int ix, int iy, int full_width, int full_height,
                                           float j1, float j2, float* dir) {
  float sx = (((float)ix - (float)full_width * 0.5f) + j1) * P[12];
  float sy = (((float)iy - (float)full_height * 0.5f) + j2) * P[13];
  for (int k = 0; k < 3; ++k) dir[k] = (P[3 + k] - P[6 + k] * sx) - P[9 + k] * sy;
  float norm = sqrtf(dir[0] * dir[0] + dir[1] * dir[1] + dir[2] * dir[2]);
  for (int k = 0; k < 3; ++k) dir[k] = dir[k] / norm;
}

}  // namespace
