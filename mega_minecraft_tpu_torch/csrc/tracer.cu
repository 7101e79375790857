// K11t (trace_kernel) and K11 (render_sample_kernel, render_bounce_kernel): the voxel
// path tracer, one thread per ray / path.
//
// Replaces mega_minecraft_tpu/render/tracer.py:104 trace (K11t) and :1259 render_sample
// with _render_rows:1176, _init_state:1123, _make_body:691, camera.py:88 pixel_rays,
// sky.py:228 sky_color and the unpackers of materials.py (K11), jitted XLA on the TPU.
// render_sample_compact (:1415) computes the same image and has no kernel of its own.
//
// The JAX program is written in lanes: every ray of a tile takes each DDA step and each
// bounce in lock step, `where` picks results, loops run while any lane is alive.  Here
// one thread is one ray (the reference's raygen), its state in registers, and a branch
// replaces each `where`.  What that changes, and what the kernel does about it:
//  - The step and bounce caps are per lane.  JAX's counters are global, but every lane
//    starts at 0 together, so they are per-lane counts, except while a lane is parked by
//    exact alpha cutout (only a real atlas flags voxels); each lane has its own budget.
//  - Every bounce draws its ten numbers from the lane's LCG in JAX's order, used or not,
//    so the streams stay in step with the plain version (tracer.py:776-1093).
//  - A branch computes only the side it takes, so guarded expressions keep their guards
//    (the 1e-12 inverse, the cell-exit and quad denominators, the 1e-6 / 1e-12 floors).
//  - The first bounce (clouds, stars, AOVs, scatter events, depth) is K11's pass 0, each
//    later bounce a pass of its own over the paths still alive (below, at K11); the sky is
//    evaluated only where a lane reads it.
// The DDA (trace_ray) and the camera ray live in trace.cuh, which K17 (debug.cu) shares.
// Arithmetic follows the plain version (render/tracer.py, render/sky.py) operation by
// operation: no FMA (-fmad=false), IEEE '/' and sqrtf, libm sinf/cosf/expf/logf/powf/
// acosf as torch calls them, min/max that propagate NaN like torch.minimum/maximum.
//
// Bound on the H100: the DDA's dependent loads (one 4-byte word per step, scattered
// over the field: 39 MB at 10x10 fits the 50 MB L2, 428 MB at 33x33 does not) and the
// divergence of rays of one warp that take different step and bounce counts, which K11's
// pixel tiles and its pass a bounce over compacted live paths cut down.

#include <stdint.h>

#include <algorithm>

#include "mmt_math.cuh"
#include "mmt_render_tables.h"
#include "sky.cuh"
#include "trace.cuh"

using namespace mmt;

namespace {

// ---------------------------------------------------------------------------------
// sampling helpers (tracer.py:542-659)
// ---------------------------------------------------------------------------------

__device__ __forceinline__ float rsqrt_floor(float x) { return 1.f / sqrtf(fmaxn(x, F(1e-12))); }

__device__ void perp_dirs(float nx, float ny, float nz, float* p1, float* p2) {
  bool ax = fabsf(nx) < F(0.57735026918962576450914878050);
  bool ay = fabsf(ny) < F(0.57735026918962576450914878050);
  float ox = ax ? 1.f : 0.f, oy = (!ax && ay) ? 1.f : 0.f, oz = (!ax && !ay) ? 1.f : 0.f;
  float p1x = ny * oz - nz * oy, p1y = nz * ox - nx * oz, p1z = nx * oy - ny * ox;
  float inv = rsqrt_floor(p1x * p1x + p1y * p1y + p1z * p1z);
  p1x = p1x * inv;
  p1y = p1y * inv;
  p1z = p1z * inv;
  float p2x = ny * p1z - nz * p1y, p2y = nz * p1x - nx * p1z, p2z = nx * p1y - ny * p1x;
  float inv2 = rsqrt_floor(p2x * p2x + p2y * p2y + p2z * p2z);
  p1[0] = p1x, p1[1] = p1y, p1[2] = p1z;
  p2[0] = p2x * inv2, p2[1] = p2y * inv2, p2[2] = p2z * inv2;
}

__device__ void cosine_hemisphere(const float* n, float s1, float s2, float* out) {
  float up = sqrtf(s1);
  float over = sqrtf(fmaxn(1.f - s1, 0.f));
  float around = s2 * (float)(2.0 * 3.141592653589793);
  float p1[3], p2[3];
  perp_dirs(n[0], n[1], n[2], p1, p2);
  float ca = cosf(around) * over, sa = sinf(around) * over;
  for (int k = 0; k < 3; ++k) out[k] = up * n[k] + ca * p1[k] + sa * p2[k];
}

__device__ void sample_star(const SkyP& p, bool is_sun, bool scattering, float s1, float s2, float* out) {
  const float* n = is_sun ? p.sun : p.moon;
  if (scattering) {
    out[0] = n[0], out[1] = n[1], out[2] = n[2];
    return;
  }
  float radius = is_sun ? F(0.1000) : F(0.0775);
  float p1[3], p2[3];
  perp_dirs(n[0], n[1], n[2], p1, p2);
  float around = s2 * (float)(2.0 * 3.141592653589793);
  float c = cosf(around), s = sinf(around);
  float dd[3];
  for (int k = 0; k < 3; ++k) dd[k] = c * p1[k] + s * p2[k];
  float inv = rsqrt_floor(dd[0] * dd[0] + dd[1] * dd[1] + dd[2] * dd[2]);
  float r[3];
  for (int k = 0; k < 3; ++k) r[k] = n[k] + s1 * radius * dd[k] * inv;
  float nn = 1.f / sqrtf(r[0] * r[0] + r[1] * r[1] + r[2] * r[2]);
  for (int k = 0; k < 3; ++k) out[k] = r[k] * nn;
}

__device__ __forceinline__ void reflect(const float* d, const float* n, float sgn, float* out) {
  float nx = sgn * n[0], ny = sgn * n[1], nz = sgn * n[2];
  float dd = d[0] * nx + d[1] * ny + d[2] * nz;
  out[0] = d[0] - 2.f * dd * nx;
  out[1] = d[1] - 2.f * dd * ny;
  out[2] = d[2] - 2.f * dd * nz;
}

__device__ void refract(const float* d, const float* n, float sgn, float eta, float* out) {
  float nx = sgn * n[0], ny = sgn * n[1], nz = sgn * n[2];
  float nd = nx * d[0] + ny * d[1] + nz * d[2];
  float k = 1.f - eta * eta * (1.f - nd * nd);
  bool ok = k >= 0.f;
  float ks = sqrtf(fmaxn(k, 0.f));
  float rx = eta * d[0] - (eta * nd + ks) * nx;
  float ry = eta * d[1] - (eta * nd + ks) * ny;
  float rz = eta * d[2] - (eta * nd + ks) * nz;
  float inv = rsqrt_floor(rx * rx + ry * ry + rz * rz);
  out[0] = ok ? rx * inv : 0.f;
  out[1] = ok ? ry * inv : 0.f;
  out[2] = ok ? rz * inv : 0.f;
}

__device__ __forceinline__ float schlick(const float* d, const float* n, float sgn, float ior) {
  float cos_t = fabsf(d[0] * (sgn * n[0]) + d[1] * (sgn * n[1]) + d[2] * (sgn * n[2]));
  float r0 = (1.f - ior) / (1.f + ior);
  r0 = r0 * r0;
  return r0 + (1.f - r0) * powf(1.f - cos_t, 5.f);
}

__device__ void ggx_sample(const float* n, float rough, float s1, float s2, float* out) {
  float a = rough * rough;
  float phi = (float)(2.0 * 3.141592653589793) * s1;
  float cos_t = sqrtf((1.f - s2) / (1.f + (a * a - 1.f) * s2));
  float sin_t = sqrtf(fmaxn(1.f - cos_t * cos_t, 0.f));
  float p1[3], p2[3];
  perp_dirs(n[0], n[1], n[2], p1, p2);
  float cp = cosf(phi), sp = sinf(phi);
  float w[3];
  for (int k = 0; k < 3; ++k) w[k] = cp * sin_t * p1[k] + sp * sin_t * p2[k] + cos_t * n[k];
  float inv = rsqrt_floor(w[0] * w[0] + w[1] * w[1] + w[2] * w[2]);
  for (int k = 0; k < 3; ++k) out[k] = w[k] * inv;
}

__device__ float trowbridge_reitz_d(const float* wh, const float* n, float rough) {
  float c = wh[0] * n[0] + wh[1] * n[1] + wh[2] * n[2];
  float cos2 = c * c;
  float tan2 = (1.f - cos2) / fmaxn(cos2, F(1e-12));
  float cos4 = cos2 * cos2;
  float e = fabsf(sqrtf(tan2) / (rough * rough));
  float ope = 1.f + e;
  float d = 1.f / (F(3.141592653589793) * rough * rough * fmaxn(cos4, F(1e-12)) * (ope * ope));
  return fmaxn(d, 0.f);
}

__device__ void wave_normal(float px, float py, float pz, float* n, float time) {
  float ax = (px + py) * F(0.45), az = pz + py, at = time * F(0.3);
  float perlin_x = fbm_p(ax, az, at, 4);
  float perlin_z = fbm_p(ax + F(74159.21), az + F(21982.43), at + F(18923.34), 4);
  float nx2 = n[0] + perlin_x * F(0.3), nz2 = n[2] + perlin_z * F(0.3);
  float inv = rsqrt_floor(nx2 * nx2 + n[1] * n[1] + nz2 * nz2);
  n[0] = nx2 * inv;
  n[1] = n[1] * inv;
  n[2] = nz2 * inv;
}

__device__ __forceinline__ float mat_tab(const float* tab, int mat) { return tab[mat]; }

}  // namespace

// ---------------------------------------------------------------------------------
// K11t: trace() over N rays
// ---------------------------------------------------------------------------------

struct TraceArgs {
  SceneArgs sc;
  const float *ox, *oy, *oz, *dx, *dy, *dz;
  const uint8_t* medium;
  const uint8_t* active;  // or null
  const int32_t* seed;    // u32 bits, or null (exact alpha)
  int n, max_steps, use_macro;
  uint8_t* hit;
  float* t;
  uint8_t* block;
  float *nx, *ny, *nz;
  int32_t* steps;  // or null
};

__global__ void trace_kernel(TraceArgs a) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  int steps;
  TraceOut r = trace_ray(a.sc, a.ox[i], a.oy[i], a.oz[i], a.dx[i], a.dy[i], a.dz[i], a.medium[i], a.max_steps,
                         a.active ? a.active[i] != 0 : true, a.seed != nullptr,
                         a.seed ? (uint32_t)a.seed[i] : 0u, a.use_macro != 0, &steps);
  a.hit[i] = r.hit;
  a.t[i] = r.t;
  a.block[i] = (uint8_t)r.block;
  a.nx[i] = r.n[0];
  a.ny[i] = r.n[1];
  a.nz[i] = r.n[2];
  if (a.steps) a.steps[i] = steps;
}

// ---------------------------------------------------------------------------------
// K11: one 1-spp sample, a launch a bounce over the live paths
// ---------------------------------------------------------------------------------
//
// Pass 0 (render_sample_kernel) is the loop's iteration 0 over the frame: the primary DDA,
// clouds and sky, the first-hit AOVs and depth, the scatter event, shading, NEE, the depth
// rule and roulette.  A pixel whose path ends there writes its outputs; a live path
// (tracer.py _active_of) goes into a queue.  Passes 1 .. max_loop_iters - 1
// (render_bounce_kernel) each take the last pass's queue, run one bounce and queue the
// survivors again, so a warp's lanes are live paths of one bounce, not pixels of which
// most ended at their first hit.  Queue slots come from one atomic a warp (ballot, popc),
// so a warp's survivors stay together.  A pass reads its queue's length on the device,
// its warps taking 32 slots at a time off a counter; the host reads no count.
//
// A queue slot carries what a later bounce reads and writes (Q_FIELDS words, structure
// of arrays): pos, dir, ray colour, pixel colour, the seed, depth and medium, and the
// pixel.  tests/test_torch_wavefront.py holds the same list (CARRIED) to the plain
// version.  After pass 0 the AOVs, depth, the scatter position and factor, the fog colour
// and the fog factor are final: the colour output holds the fog colour and the workspace
// the fog factor of a live path until its last pass writes pix + (fogc - pix) * ff, and a
// live path's scatter factor is 1, its scattered, done and needs-first flags false.
//
// Pass 0 takes 16x8-pixel CTAs of 8x4-pixel warps, so a warp's rays are close in direction
// and in the field words they read.  Both kernels must fit 5 CTAs an SM (registers capped at
// 102; pass 0 spills a little): faster than the 4 that 110-131 registers allow.
#define Q_FIELDS 15
#define K11_THREADS 128
#define K11_MIN_CTAS 5
#define FULL_MASK 0xFFFFFFFFu

struct RenderArgs {
  SceneArgs sc;
  const uint32_t *tex_emis, *tex_norm;
  const float* params;  // cam: position, forward, right, up, pixel_length; sky: sun, moon, rot, time
  int height, width, row0, col0, full_height, full_width;
  uint32_t frame_id;
  int exact, max_ray_depth, max_loop_iters, max_steps, bounce_steps, shadow_steps, mapped_normals;
  float fog_scatter;
  float *color, *albedo, *normal, *depth;
  int32_t* steps;       // [H, W, 4] or null: primary, bounce, shadow steps, radiance rays
  int32_t* ws;          // workspace of mmt_render_workspace_words() words
  int32_t* pass_steps;  // [max_loop_iters, H * W, 3] or null: (pixel, radiance steps, shadow steps)
                        // of pass k by pixel (pass 0) or queue slot
};

// the workspace: live paths after each pass, each pass's next slot to take, the fog
// factor by pixel, two queues of Q_FIELDS x H*W words
struct Workspace {
  int *count, *fetch;
  float* ff;
  uint32_t* queue[2];
};

__host__ __device__ __forceinline__ long long ws_head(int loops) { return (2LL * loops + 3) / 4 * 4; }

__host__ __device__ __forceinline__ long long ws_words(int height, int width, int loops) {
  const long long cap = (long long)height * width;
  return ws_head(loops) + cap + 2 * Q_FIELDS * cap;
}

__device__ __forceinline__ Workspace workspace(const RenderArgs& a) {
  const long long cap = (long long)a.height * a.width;
  Workspace w;
  w.count = a.ws;
  w.fetch = a.ws + a.max_loop_iters;
  w.ff = (float*)(a.ws + ws_head(a.max_loop_iters));
  w.queue[0] = (uint32_t*)(w.ff + cap);
  w.queue[1] = w.queue[0] + Q_FIELDS * cap;
  return w;
}

// a path's state in registers; the pass-0-only fields are constants in a later bounce
struct Path {
  float pos[3], dir[3], ray[3], pix[3];
  uint32_t seed;
  int depth, medium;
  bool needs_first, done, scattered;
  float alb[3], nrm[3], spos[3], fogc[3], sfac, ff, depth_out;
  int st_primary, st_bounce, st_shadow, n_rays;
  int last_rad, last_shadow;  // DDA steps of the last bounce's radiance and shadow rays
};

__device__ __forceinline__ bool path_active(const RenderArgs& a, const Path& s) {
  return !s.done && !s.scattered && s.depth < a.max_ray_depth;
}

// ---- init (tracer.py:1123-1173; camera.py:88-123)
__device__ __forceinline__ void path_init(const RenderArgs& a, int px, int py, Path& s) {
  const float* P = a.params;
  int ix = a.col0 + px, iy = a.row0 + py;
  s.seed = tea((uint32_t)(iy * a.full_width + ix), a.frame_id, 4);
  float j1 = rnd_u01(&s.seed), j2 = rnd_u01(&s.seed);
  camera_ray(P, ix, iy, a.full_width, a.full_height, j1, j2, s.dir);
  for (int k = 0; k < 3; ++k) {
    s.pos[k] = P[k] + 0.f;
    s.ray[k] = 1.f, s.pix[k] = 0.f, s.alb[k] = 0.f, s.nrm[k] = 0.f, s.fogc[k] = 0.f;
    s.spos[k] = s.pos[k];
  }
  s.depth = 0, s.medium = BLOCK_AIR;
  s.sfac = 1.f, s.ff = 0.f, s.depth_out = F(1e6);
  s.needs_first = true, s.done = false, s.scattered = false;
  s.st_primary = s.st_bounce = s.st_shadow = s.n_rays = 0;
}

// one iteration of the bounce loop (tracer.py:714-1118); FIRST: iteration 0
template <bool FIRST>
__device__ __forceinline__ void path_bounce(const RenderArgs& a, const SkyP& sky, Path& s) {
  const float sun_y = sky.sun[1];
  float* pos = s.pos;
  float* dir = s.dir;
  float* ray = s.ray;
  float* pix = s.pix;
  const bool active = path_active(a, s);
  bool nf = FIRST && s.needs_first;
  const uint32_t seed0 = s.seed;

  // ---- radiance DDA
  int steps;
  const bool exact_ray = FIRST || a.exact;
  TraceOut res = trace_ray(a.sc, pos[0], pos[1], pos[2], dir[0], dir[1], dir[2], s.medium,
                           exact_ray ? a.max_steps : a.bounce_steps, active, !exact_ray, seed0, true, &steps);
  if (FIRST) s.st_primary += steps, s.depth_out = fminn(res.t, F(1e6));
  else s.st_bounce += steps;
  s.last_rad = steps;
  s.n_rays += active ? 1 : 0;
  const bool hit = res.hit && active, miss = !res.hit && active;
  float is[3];
  for (int k = 0; k < 3; ++k) is[k] = pos[k] + dir[k] * res.t;

  // ---- the lane's ten draws of this bounce, in JAX's order
  uint32_t seed = s.seed;
  float r_scatter = rnd_u01(&seed), r_spec = rnd_u01(&seed), g1 = rnd_u01(&seed), g2 = rnd_u01(&seed);
  float gx1 = rnd_u01(&seed), gx2 = rnd_u01(&seed), x1 = rnd_u01(&seed), x2 = rnd_u01(&seed);
  float r_sun = rnd_u01(&seed);
  const uint32_t shadow_seed = seed ^ 0x5BD1E995u;
  float r_rr = rnd_u01(&seed);
  s.seed = seed;

  float cov = 0.f, fog[3] = {0.f, 0.f, 0.f};
  if (nf) {
    cov = cloud_coverage(pos[0], pos[2], dir[0], dir[1], dir[2], sky);
    if (hit) sky_color(dir[0], dir[1], dir[2], sky, false, true, true, cov, fog);
  }

  // ---- miss (sky)
  if (miss) {
    float sc[3];
    sky_color(dir[0], dir[1], dir[2], sky, true, FIRST, nf, cov, sc);
    for (int k = 0; k < 3; ++k) pix[k] = pix[k] + sc[k] * ray[k];
    if (nf) {
      float sky_time = logf(fmaxn(1.f - r_scatter, F(1e-7))) / a.fog_scatter;
      float m_sf = smoothstep(0.f, F(3.5), r_scatter);
      for (int k = 0; k < 3; ++k) {
        s.alb[k] = sc[k];
        s.nrm[k] = -dir[k];
        s.spos[k] = pos[k] + dir[k] * sky_time;
        s.fogc[k] = sc[k];
      }
      s.scattered = true;
      s.sfac = m_sf;
      s.ff = 1.f - m_sf;
      nf = false;
    }
    s.done = true;
  }

  // ---- hit
  bool spec = false, emissive = false, h_shade = false;
  float new_p[3] = {pos[0], pos[1], pos[2]}, new_d[3] = {dir[0], dir[1], dir[2]};
  if (hit) {
    const bool exit_to_air = s.medium != BLOCK_AIR && res.block == BLOCK_AIR;
    const int eff = exit_to_air ? s.medium : res.block;
    const uint32_t props = BLOCK_PROPS_TAB[eff];
    const float inv255 = F(1.0 / 255.0);
    float col[3] = {(float)(props & 0xFFu) * inv255, (float)((props >> 8) & 0xFFu) * inv255,
                    (float)((props >> 16) & 0xFFu) * inv255};
    const int mat = (int)((props >> 24) & 0x7u);
    const bool is_spec = MAT_SPECULAR_TAB[mat] != 0;
    const float rough = mat_tab(MAT_ROUGHNESS_TAB, mat), ior = mat_tab(MAT_IOR_TAB, mat);
    const bool on_y = fabsf(res.n[1]) > 0.5f, on_x = fabsf(res.n[0]) > 0.5f;
    const int face = on_y ? (res.n[1] > 0.f ? 1 : 2) : 0;
    float fu = on_y ? fract(is[0]) : (on_x ? fract(is[2]) : fract(is[0]));
    float fv = on_y ? fract(is[2]) : 1.f - fract(is[1]);
    int tu = floor_i(fu * 16.f, 15), tv = floor_i(fv * 16.f, 15);
    float vxf = floorf(is[0] - res.n[0] * 0.5f), vyf = floorf(is[1] - res.n[1] * 0.5f),
          vzf = floorf(is[2] - res.n[2] * 0.5f);
    float hface = rand1_from3(vxf + res.n[0], vyf + res.n[1] * 2.f, vzf + res.n[2] * 3.f);
    int variant = floor_i(hface * 8.f, 7);
    long long tex_idx = ((long long)((eff * 3 + face) * 8 + variant)) * 256 + tv * 16 + tu;
    uint32_t texel = __ldg(a.sc.tex_diff + tex_idx);
    if (!exit_to_air) {
      col[0] = (float)(texel & 0xFFu) * inv255;
      col[1] = (float)((texel >> 8) & 0xFFu) * inv255;
      col[2] = (float)((texel >> 16) & 0xFFu) * inv255;
    }
    const float emis_w_tex = (float)((texel >> 25) & 0x7Fu) * F(1.0 / 127.0);
    const float horiz = sqrtf(dir[0] * dir[0] + dir[2] * dir[2]) * res.t;
    const float hit_fog = smoothstep(F(220.0), F(300.0), horiz);

    // volumetric scatter event at the first hit
    bool h_scatter = false;
    if (nf) {
      float chance = (1.f - expf(a.fog_scatter * res.t)) * smoothstep(F(0.55), F(0.35), sun_y);
      h_scatter = chance > r_scatter;
      if (h_scatter) {
        float sc_t = logf(fmaxn(1.f - r_scatter, F(1e-7))) / a.fog_scatter;
        for (int k = 0; k < 3; ++k) {
          s.alb[k] = col[k];
          s.nrm[k] = res.n[k];
          s.spos[k] = pos[k] + dir[k] * sc_t;
          s.fogc[k] = fog[k];
        }
        s.scattered = true;
        s.sfac = smoothstep(0.f, F(3.5), 1.f - r_scatter);
        s.ff = hit_fog;
        nf = false;
      }
    }
    h_shade = !h_scatter;

    float n[3] = {res.n[0], res.n[1], res.n[2]};
    if (h_shade && a.mapped_normals && !exit_to_air && !(res.block >= X_SHAPED_LO && res.block < X_SHAPED_HI)) {
      uint32_t tn = __ldg(a.tex_norm + tex_idx);
      float tnx = (float)(tn & 0xFFu) * inv255 * 2.f - 1.f, tny = (float)((tn >> 8) & 0xFFu) * inv255 * 2.f - 1.f,
            tnz = (float)((tn >> 16) & 0xFFu) * inv255 * 2.f - 1.f;
      float tx = (on_y || !on_x) ? 1.f : 0.f, tz = (!on_y && on_x) ? 1.f : 0.f;
      float by = on_y ? 0.f : -1.f, bz = on_y ? 1.f : 0.f;
      float pnx = tx * tnx + 0.f * tny + n[0] * tnz;
      float pny = by * tny + n[1] * tnz;
      float pnz = tz * tnx + bz * tny + n[2] * tnz;
      float inv_n = rsqrtf(fmaxn(pnx * pnx + pny * pny + pnz * pnz, F(1e-12)));
      n[0] = pnx * inv_n, n[1] = pny * inv_n, n[2] = pnz * inv_n;
    }
    if (h_shade && MAT_WAVY_TAB[mat]) wave_normal(is[0], is[1], is[2], n, sky.time);

    spec = h_shade && is_spec;
    if (spec) {
      float entering = dir[0] * n[0] + dir[1] * n[1] + dir[2] * n[2];
      bool ent = entering < 0.f;
      float nd[3], off, w;
      if (ent) {
        bool refr_e = r_spec < -entering;
        float fres_in = schlick(dir, n, 1.f, ior);
        if (refr_e) refract(dir, n, 1.f, 1.f / fmaxn(ior, F(1e-6)), nd);
        else reflect(dir, n, 1.f, nd);
        off = refr_e ? F(-0.001) : F(0.001);
        w = refr_e ? 1.f - fres_in : fres_in;
        if (refr_e) s.medium = res.block;
      } else {
        float sin_tt = ior * sqrtf(fmaxn(1.f - entering * entering, 0.f));
        bool refr_x = r_spec < entering / fmaxn(sin_tt, 1.f);
        float fres_out = schlick(dir, n, -1.f, ior);
        if (refr_x) refract(dir, n, -1.f, ior, nd);
        else reflect(dir, n, -1.f, nd);
        off = refr_x ? F(0.001) : F(-0.001);
        w = refr_x ? 1.f - fres_out : fres_out;
        if (refr_x) s.medium = BLOCK_AIR;
      }
      w = w * ior;
      for (int k = 0; k < 3; ++k) {
        ray[k] = ray[k] * w * col[k];
        new_p[k] = is[k] + n[k] * off;
        new_d[k] = nd[k];
      }
    } else if (h_shade) {
      emissive = !exit_to_air && (texel & 0xFFFFFFu) == 0u && emis_w_tex > 0.f;
      if (emissive) {
        uint32_t et = __ldg(a.tex_emis + tex_idx);
        float e_strength = nf ? F(1.5) : emis_w_tex * 100.f;
        float ec[3] = {(float)(et & 0xFFu) * inv255 * e_strength, (float)((et >> 8) & 0xFFu) * inv255 * e_strength,
                       (float)((et >> 16) & 0xFFu) * inv255 * e_strength};
        for (int k = 0; k < 3; ++k) pix[k] = pix[k] + ray[k] * ec[k];
        if (nf) {
          for (int k = 0; k < 3; ++k) s.alb[k] = ec[k], s.nrm[k] = n[k], s.fogc[k] = fog[k];
          s.ff = hit_fog;
          nf = false;
        }
      } else {
        float d[3], dcol[3] = {col[0], col[1], col[2]};
        if (rough > 0.f) {
          float rc = fmaxn(rough, F(1e-3)), wh[3];
          ggx_sample(n, rc, gx1, gx2, wh);
          float wo[3] = {-dir[0], -dir[1], -dir[2]};
          float owh = wo[0] * wh[0] + wo[1] * wh[1] + wo[2] * wh[2];
          for (int k = 0; k < 3; ++k) d[k] = 2.f * owh * wh[k] - wo[k];
          float minv = rsqrt_floor(d[0] * d[0] + d[1] * d[1] + d[2] * d[2]);
          for (int k = 0; k < 3; ++k) d[k] = d[k] * minv;
          float dg = trowbridge_reitz_d(wh, n, rc);
          float ndl = fabsf(n[0] * d[0] + n[1] * d[1] + n[2] * d[2]);
          float ndv = fabsf(n[0] * wo[0] + n[1] * wo[1] + n[2] * wo[2]);
          float mm = dg / fmaxn(4.f * ndl * ndv, F(1e-6));
          mm = mm < 1.f ? 1.f : (mm > 4.f ? 4.f : mm);
          for (int k = 0; k < 3; ++k) dcol[k] = col[k] * mm;
        } else {
          cosine_hemisphere(n, g1, g2, d);
        }
        for (int k = 0; k < 3; ++k) {
          ray[k] = ray[k] * dcol[k];
          new_p[k] = is[k] + n[k] * F(0.001);
          new_d[k] = d[k];
        }
      }
    }
    if (h_shade && nf) {  // first-hit AOVs of a shaded (non-emissive) hit
      for (int k = 0; k < 3; ++k) s.alb[k] = col[k], s.nrm[k] = n[k], s.fogc[k] = fog[k];
      s.ff = hit_fog;
      nf = false;
    }
    s.done = s.done || emissive;
  }
  if (FIRST) s.needs_first = nf;

  // ---- NEE shadow ray (raygen:626-665)
  const bool done = s.done, scattered = s.scattered;
  const bool nee = (active && !spec && !done) || (scattered && active);
  const bool is_sun = r_sun < linearstep(F(-0.1), F(0.1), sun_y);
  float sd[3];
  sample_star(sky, is_sun, scattered, x1, x2, sd);
  const float* sp = scattered ? s.spos : new_p;
  bool shadow_hit = false;
  s.last_shadow = 0;
  if (nee) {
    int ssteps;
    TraceOut sres = trace_ray(a.sc, sp[0], sp[1], sp[2], sd[0], sd[1], sd[2], BLOCK_AIR,
                              a.exact ? a.max_steps : a.shadow_steps, true, !a.exact, shadow_seed, true, &ssteps);
    shadow_hit = sres.hit;
    s.st_shadow += ssteps;
    s.last_shadow = ssteps;
  }
  const bool add = nee && !shadow_hit;
  bool found = false;
  if (add) {
    float ss[3];
    found = sky_color(sd[0], sd[1], sd[2], sky, true, false, false, 0.f, ss);
    float sf = (scattered && done) ? s.sfac * smoothstep(F(256.0), F(128.0), sp[1]) : s.sfac;
    for (int k = 0; k < 3; ++k) pix[k] = pix[k] + ss[k] * ray[k] * sf;
  }
  if (nee && found && !done) {
    float comp = is_sun ? F(0.05) : F(0.02);
    for (int k = 0; k < 3; ++k) pix[k] = pix[k] * comp;
  } else if (nee && !found) {
    pix[0] = pix[1] = pix[2] = 0.f;
  }

  // ---- depth and Russian roulette
  const int depth_eff = s.depth - ((spec && s.depth % 2 == 0) ? 1 : 0);
  if (active) s.depth = depth_eff + 1;
  const bool rr_active = active && !done && !scattered && depth_eff > 2;
  if (rr_active) {
    float lum = F(0.2126) * pix[0] + F(0.7152) * pix[1] + F(0.0722) * pix[2];
    float q = fmaxn(1.f - lum, F(0.05));
    if (r_rr < q) {
      pix[0] = pix[1] = pix[2] = 0.f;
      s.done = true;
    } else {
      float one_q = 1.f - q;
      for (int k = 0; k < 3; ++k) pix[k] = pix[k] / one_q;
    }
  }
  for (int k = 0; k < 3; ++k) pos[k] = new_p[k], dir[k] = new_d[k];
}

__device__ __forceinline__ void record_pass(const RenderArgs& a, int pass, long long slot, int o, const Path& s) {
  if (a.pass_steps) {
    int32_t* r = a.pass_steps + ((long long)pass * a.height * a.width + slot) * 3;
    r[0] = o, r[1] = s.last_rad, r[2] = s.last_shadow;
  }
}

__device__ __forceinline__ void write_color(const RenderArgs& a, int o, const float* pix, const float* fogc, float ff) {
  for (int k = 0; k < 3; ++k) a.color[o * 3 + k] = pix[k] + (fogc[k] - pix[k]) * ff;
}

// queue slot i of q (Q_FIELDS x cap words, structure of arrays) <-> a path and its pixel o
__device__ __forceinline__ void store_path(uint32_t* q, long long cap, long long i, const Path& s, int o) {
  for (int k = 0; k < 3; ++k) {
    q[k * cap + i] = __float_as_uint(s.pos[k]);
    q[(3 + k) * cap + i] = __float_as_uint(s.dir[k]);
    q[(6 + k) * cap + i] = __float_as_uint(s.ray[k]);
    q[(9 + k) * cap + i] = __float_as_uint(s.pix[k]);
  }
  q[12 * cap + i] = s.seed;
  q[13 * cap + i] = (uint32_t)s.depth | ((uint32_t)s.medium << 16);
  q[14 * cap + i] = (uint32_t)o;
}

__device__ __forceinline__ int load_path(const uint32_t* q, long long cap, long long i, Path& s) {
  for (int k = 0; k < 3; ++k) {
    s.pos[k] = __uint_as_float(q[k * cap + i]);
    s.dir[k] = __uint_as_float(q[(3 + k) * cap + i]);
    s.ray[k] = __uint_as_float(q[(6 + k) * cap + i]);
    s.pix[k] = __uint_as_float(q[(9 + k) * cap + i]);
  }
  s.seed = q[12 * cap + i];
  const uint32_t dm = q[13 * cap + i];
  s.depth = (int)(dm & 0xFFFFu), s.medium = (int)(dm >> 16);
  s.needs_first = false, s.done = false, s.scattered = false;
  s.sfac = 1.f;
  s.st_primary = s.st_bounce = s.st_shadow = s.n_rays = 0;
  return (int)q[14 * cap + i];
}

// the warp's live lanes into consecutive slots of q: one atomic a warp; every lane calls it
__device__ __forceinline__ void enqueue(bool live, int* count, uint32_t* q, long long cap, const Path& s, int o) {
  const unsigned m = __ballot_sync(FULL_MASK, live);
  if (m == 0u) return;
  const int lane = threadIdx.x & 31, leader = __ffs(m) - 1;
  int base = 0;
  if (lane == leader) base = atomicAdd(count, __popc(m));
  base = __shfl_sync(FULL_MASK, base, leader);
  if (live) store_path(q, cap, base + __popc(m & ((1u << lane) - 1u)), s, o);
}

// pass 0: iteration 0 for every pixel of the tile
__global__ void __launch_bounds__(K11_THREADS, K11_MIN_CTAS) render_sample_kernel(RenderArgs a) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int px = blockIdx.x * 16 + (warp & 1) * 8 + (lane & 7), py = blockIdx.y * 8 + (warp >> 1) * 4 + (lane >> 3);
  const bool valid = px < a.width && py < a.height;
  const int o = valid ? py * a.width + px : 0;
  const SkyP sky = frame_sky(a.params);
  Path s;
  bool live = false;
  if (valid) {
    path_init(a, px, py, s);
    path_bounce<true>(a, sky, s);
    record_pass(a, 0, o, o, s);
    live = a.max_loop_iters > 1 && path_active(a, s);
    for (int k = 0; k < 3; ++k) a.albedo[o * 3 + k] = s.alb[k], a.normal[o * 3 + k] = s.nrm[k];
    a.depth[o] = s.depth_out;
    if (a.steps) {
      a.steps[o * 4] = s.st_primary;
      a.steps[o * 4 + 1] = s.st_bounce;
      a.steps[o * 4 + 2] = s.st_shadow;
      a.steps[o * 4 + 3] = s.n_rays;
    }
    if (live) {  // the colour output keeps the fog colour until the path's last pass
      for (int k = 0; k < 3; ++k) a.color[o * 3 + k] = s.fogc[k];
    } else {
      write_color(a, o, s.pix, s.fogc, s.ff);
    }
  }
  const Workspace w = workspace(a);
  if (live) w.ff[o] = s.ff;
  enqueue(live, w.count, w.queue[0], (long long)a.height * a.width, s, o);
}

// pass `pass` >= 1: one bounce of each queued path; warps take 32 slots at a time
__global__ void __launch_bounds__(K11_THREADS, K11_MIN_CTAS) render_bounce_kernel(RenderArgs a, int pass) {
  const Workspace w = workspace(a);
  const long long cap = (long long)a.height * a.width;
  const uint32_t* qin = w.queue[(pass - 1) & 1];
  uint32_t* qout = w.queue[pass & 1];
  const int n = w.count[pass - 1];
  const bool last = pass == a.max_loop_iters - 1;
  const int lane = threadIdx.x & 31;
  const SkyP sky = frame_sky(a.params);
  for (;;) {
    int base = 0;
    if (lane == 0) base = atomicAdd(w.fetch + pass, 32);
    base = __shfl_sync(FULL_MASK, base, 0);
    if (base >= n) break;
    const int i = base + lane;
    Path s;
    int o = 0;
    bool live = false;
    if (i < n) {
      o = load_path(qin, cap, i, s);
      path_bounce<false>(a, sky, s);
      record_pass(a, pass, i, o, s);
      if (a.steps) {
        a.steps[o * 4 + 1] += s.st_bounce;
        a.steps[o * 4 + 2] += s.st_shadow;
        a.steps[o * 4 + 3] += s.n_rays;
      }
      live = !last && path_active(a, s);
      if (!live) {
        float fogc[3] = {a.color[o * 3], a.color[o * 3 + 1], a.color[o * 3 + 2]};
        write_color(a, o, s.pix, fogc, w.ff[o]);
      }
    }
    enqueue(live, w.count + pass, qout, cap, s, o);
  }
}

int g_render_launches = 0;  // kernel launches of the last K11 call

extern "C" int mmt_trace(const TraceArgs* args, void* stream) {
  TraceArgs a = *args;
  if (a.n > 0) trace_kernel<<<(a.n + 127) / 128, 128, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int mmt_render_workspace_words(int height, int width, int max_loop_iters) {
  return (int)ws_words(height, width, max_loop_iters);
}

extern "C" int mmt_render_launches(void) { return g_render_launches; }

extern "C" int mmt_render_sample(const RenderArgs* args, void* stream) {
  RenderArgs a = *args;
  cudaStream_t st = (cudaStream_t)stream;
  g_render_launches = 0;
  if (a.width <= 0 || a.height <= 0) return 0;
  cudaError_t err = cudaMemsetAsync(a.ws, 0, 2 * sizeof(int32_t) * a.max_loop_iters, st);
  if (err != cudaSuccess) return (int)err;
  render_sample_kernel<<<dim3((a.width + 15) / 16, (a.height + 7) / 8), K11_THREADS, 0, st>>>(a);
  ++g_render_launches;
  if (a.max_loop_iters > 1) {
    // a persistent grid: as many CTAs as the card holds at once, at most one a 128 slots
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, render_bounce_kernel, K11_THREADS, 0);
    const long long cap_ctas = ((long long)a.height * a.width + K11_THREADS - 1) / K11_THREADS;
    const int grid = (int)std::max(1LL, std::min((long long)sms * std::max(per_sm, 1), cap_ctas));
    for (int pass = 1; pass < a.max_loop_iters; ++pass) {
      render_bounce_kernel<<<grid, K11_THREADS, 0, st>>>(a, pass);
      ++g_render_launches;
    }
  }
  return (int)cudaGetLastError();
}
