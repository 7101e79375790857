// The procedural sky as device functions: CUDA twin of mega_minecraft_tpu_torch/render/
// sky.py, which ports mega_minecraft_tpu/render/sky.py:25-338 (the reference's
// getSkyColor, basic_shaders.cu:436-556).  Inlined into K11 (csrc/tracer.cu) and K17
// (csrc/debug.cu).
//
// Operation order follows the JAX original; f32 constant products are folded as numpy
// folds them (F(a) * F(b) in f32); libm sinf / cosf / acosf / powf, as torch calls them.
#pragma once

#include "mmt_math.cuh"

namespace mmt {

struct SkyP {
  float sun[3], moon[3], rot[9], time;
};

MMT_FN float fade(float t) { return t * t * t * (t * (t * 6.f - 15.f) + 10.f); }

MMT_FN float grad_p(uint32_t h, float x, float y, float z) {
  h &= 15u;
  float u = h < 8u ? x : y;
  float v = h < 4u ? y : ((h == 12u || h == 14u) ? x : z);
  return ((h & 1u) == 0u ? u : -u) + ((h & 2u) == 0u ? v : -v);
}

MMT_FN uint32_t lattice_hash(int ix, int iy, int iz) {
  uint32_t h = (uint32_t)ix * 0x8DA6B343u + (uint32_t)iy * 0xD8163841u + (uint32_t)iz * 0xCB1AB31Fu;
  h ^= h >> 13;
  h *= 0x9E3779B1u;
  return h ^ (h >> 16);
}

MMT_FN float lerp_p(float t, float a, float b) { return a + t * (b - a); }

MMT_FN float pnoise(float px, float py, float pz) {
  float xf = floorf(px), yf = floorf(py), zf = floorf(pz);
  int X = (int)xf, Y = (int)yf, Z = (int)zf;
  float x = px - xf, y = py - yf, z = pz - zf;
  float u = fade(x), v = fade(y), w = fade(z);
#define G(a, b, c) grad_p(lattice_hash(X + a, Y + b, Z + c), x - (float)a, y - (float)b, z - (float)c)
  float r = lerp_p(w, lerp_p(v, lerp_p(u, G(0, 0, 0), G(1, 0, 0)), lerp_p(u, G(0, 1, 0), G(1, 1, 0))),
                   lerp_p(v, lerp_p(u, G(0, 0, 1), G(1, 0, 1)), lerp_p(u, G(0, 1, 1), G(1, 1, 1))));
#undef G
  return r;
}

MMT_FN float fbm_p(float px, float py, float pz, int octaves) {
  float total = 0.f, amplitude = 1.f;
  for (int o = 0; o < octaves; ++o) {
    amplitude *= 0.5f;
    float term = amplitude * pnoise(px, py, pz);
    total = o == 0 ? term : total + term;
    px = px * 2.f;
    py = py * 2.f;
    pz = pz * 2.f;
  }
  return total;
}

MMT_FN float linearstep(float e0, float e1, float x) { return clamp01((x - e0) / (e1 - e0)); }

MMT_FN float sin_hash_r(float d) { return fract(sinf(d) * F(58293.492)); }

// the renderer's vec3 sin hash (render/sky.py _rand3_from3_r)
MMT_FN void rand3_from3_r(float x, float y, float z, float* r) {
  r[0] = sin_hash_r(x * F(185.3) + y * F(563.9) + z * F(887.2));
  r[1] = sin_hash_r(x * F(593.1) + y * F(591.2) + z * F(402.1));
  r[2] = sin_hash_r(x * F(938.2) + y * F(723.4) + z * F(768.9));
}

MMT_FN float clouds_noise(float cx, float cy, float cz, float time) {
  float n1 = pnoise(cx - F(962.43), cy - F(962.43), cz - F(962.43)) * F(0.01);
  float n2 = pnoise(cx * F(254.32), cy * F(254.32), cz * F(254.32)) * F(0.01);
  float cn = (fbm_p(cx * F(0.05) + n1, cz * F(0.05) + n2, time * F(0.015), 3) + 1.f) * 0.5f;
  cn = cn + fbm_p(cx * F(0.15) - F(325.32), cz * F(0.15) + F(613.58), time * F(0.040), 3) * F(0.3);
  cn = cn * (pnoise(cx * F(0.03) + F(821.23), cz * F(0.03) - F(721.33), time * F(0.003) + F(276.21)) + 1.f) *
       F(0.9);
  return smoothstep(F(0.35), F(0.75), cn - F(0.01) * cy);
}

// getCloudCoverage (basic_shaders.cu:410-433)
MMT_FN float cloud_coverage(float ox, float oz, float dx, float dy, float dz, const SkyP& p) {
  if (dy < F(0.04)) return 0.f;
  float t = 20.f / dy;
  float cx = dx * t + ox * F(0.01) + F(0.3) * p.time;
  float cy = 0.f;
  float cz = dz * t + oz * F(0.01) + F(0.6) * p.time;
  float coverage = 0.f;
  for (int i = 0; i < 12; ++i) {
    float step = (float)(0.2 * i);
    cx = cx + dx * step;
    cy = cy + dy * step;
    cz = cz + dz * step;
    coverage = coverage + clouds_noise(cx, cy, cz, p.time) * step;
  }
  float c = coverage * F(0.1);
  return (c > 1.f || c != c) ? (c != c ? c : 1.f) : c;
}

MMT_FN float star_pal(float r, float c0, float c1, float c2, float c3, float c4) {
  return r < F(0.35) ? c0 : (r < F(0.70) ? c1 : (r < F(0.82) ? c2 : (r < F(0.94) ? c3 : c4)));
}

// getStarsColor (basic_shaders.cu:355-398)
MMT_FN void stars_color(float dx, float dy, float dz, float* c) {
  float ux = dx * 30.f, uy = dy * 30.f, uz = dz * 30.f;
  float ix = floorf(ux), iy = floorf(uy), iz = floorf(uz);
  float rr[3];
  rand3_from3_r(ix, iy, iz, rr);
  float px = F(0.1) + F(0.9) * rr[0], py = F(0.1) + F(0.9) * rr[1], pz = F(0.1) + F(0.9) * rr[2];
  float dxx = px - (ux - ix), dyy = py - (uy - iy), dzz = pz - (uz - iz);
  float dist = sqrtf(dxx * dxx + dyy * dyy + dzz * dzz);
  float rnd = sin_hash_r(px * F(185.3) + py * F(563.9) + pz * F(887.2));
  float s = smoothstep(F(0.08), F(0.05), dist) * 3.f;
  c[0] = star_pal(rnd, F(1.000), F(0.929), F(0.482), F(1.000), F(1.000)) * s;
  c[1] = star_pal(rnd, F(0.863), F(0.984), F(0.816), F(0.663), F(0.455)) * s;
  c[2] = star_pal(rnd, F(0.333), F(1.000), F(1.000), F(0.271), F(0.282)) * s;
}

// getSkyColor.  first_hit: clouds and stars for a ray that still needs first-hit data
// (the tracer's first bounce); cov: its cloud coverage (ignored otherwise).  Writes the
// colour to out[3]; returns whether the ray hit the sun or moon disk.
MMT_FN bool sky_color(float dx, float dy, float dz, const SkyP& p, bool include_stars, bool with_clouds,
                      bool first_hit, float cov, float* out) {
  float sun_y = p.sun[1];
  float entire = smoothstep(F(-0.4), F(0.2), dy);
  float base_strength = F(0.04) + F(0.96) * smoothstep(F(-0.25), F(0.10), sun_y);
  float g0 = 0.5f * base_strength, g1 = (F(0.8) * 0.5f) * base_strength, g2 = (F(0.65) * 0.5f) * base_strength;
  float r = 0.f, g = 0.f, b = 0.f;
  float sun_strength = smoothstep(F(-0.5), F(-0.2), sun_y);
  float sun_d = dx * p.sun[0] + dy * p.sun[1] + dz * p.sun[2];
  bool body = false;
  if (include_stars) {
    float sun_color_mod = smoothstep(F(-0.05), F(0.40), sun_y);
    float scr = F(1.20);
    float scg = F(0.05) + F(0.70) * sun_color_mod;
    float scb = F(0.42) * sun_color_mod;
    float halo = smoothstep(F(0.05), F(0.20), sun_y) * F(0.4);
    float hs = smoothstep(F(0.98), F(0.9975), sun_d);
    float halo_f = hs * hs * hs * halo;
    bool disk = sun_d > F(0.995);
    float one_m = 1.f - sun_d;
    float disk_f = disk ? (1.f - 5000.f * (one_m * one_m)) * (F(0.3) + F(0.7) * sun_color_mod) * 45.f : 0.f;
    bool active = sun_strength > 0.f && sun_d > F(0.98);
    if (active) {
      r = r + (halo_f * (scr + 0.f) + disk_f * scr) * sun_strength;
      g = g + (halo_f * (scg + F(0.1)) + disk_f * scg) * sun_strength;
      b = b + (halo_f * (scb + F(0.1)) + disk_f * scb) * sun_strength;
      body = body || disk;
    }
    float moon_strength = smoothstep(F(-0.5), F(-0.2), p.moon[1]);
    float moon_d = dx * p.moon[0] + dy * p.moon[1] + dz * p.moon[2];
    float mcr = (float)(0.6 * 0.3), mcg = (float)(0.7 * 0.3), mcb = (float)(1.0 * 0.3);
    float mhalo = smoothstep(F(0.05), F(0.20), p.moon[1]) * F(0.2);
    float ms = smoothstep(F(0.985), F(0.9983), moon_d);
    float mhalo_f = ms * ms * ms * mhalo;
    bool mdisk = moon_d > F(0.997);
    float mdisk_f = mdisk ? 24.f : 0.f;
    bool mactive = moon_strength > 0.f && moon_d > F(0.985);
    if (mactive) {
      r = r + (mhalo_f * mcr + mdisk_f * mcr) * moon_strength;
      g = g + (mhalo_f * mcg + mdisk_f * mcg) * moon_strength;
      b = b + (mhalo_f * (mcb + F(0.15)) + mdisk_f * mcb) * moon_strength;
      body = body || mdisk;
    }
  }
  float base_lerp = smoothstep(F(0.15), F(-0.15), dy) * F(0.14);
  if (!body) {
    r = r + (F(0.10) + (F(0.8) - F(0.10)) * base_lerp) * base_strength;
    g = g + (F(0.16) + (F(0.8) - F(0.16)) * base_lerp) * base_strength;
    b = b + (F(0.20) + (F(1.0) - F(0.20)) * base_lerp) * base_strength;
  }
  if (include_stars && with_clouds && !body && first_hit) {
    float stars_strength = smoothstep(F(0.03), F(-0.22), sun_y);
    const float* m = p.rot;
    float sx = m[0] * dx + m[1] * dy + m[2] * dz;
    float sy = m[3] * dx + m[4] * dy + m[5] * dz;
    float sz = m[6] * dx + m[7] * dy + m[8] * dz;
    float st[3];
    stars_color(sx, sy, sz, st);
    r = r + st[0] * stars_strength;
    g = g + st[1] * stars_strength;
    b = b + st[2] * stars_strength;
  }
  float dd = dx * p.sun[0] + dz * p.sun[2];
  float hd = acosf(dd < -1.f ? -1.f : (dd > 1.f ? 1.f : dd));
  float orange = 0.f;
  if (sun_strength > 0.f && !body)
    orange = smoothstep(F(-0.13), F(-0.02), sun_y) * smoothstep(F(0.25), F(0.05), sun_y) *
             smoothstep(F(-2.5), F(0.65), sun_d) *
             smoothstep(F(1.05), F(0.18), dy + smoothstep(0.f, F(3.141592653589793), hd) * F(0.6));
  r = r + (F(1.40) - r) * orange;
  g = g + (F(0.35) - g) * orange;
  b = b + (0.f - b) * orange;
  if (with_clouds) {
    float c = first_hit ? (cov > F(0.92) ? F(0.92) : cov) : 0.f;
    float ccr = F(0.9) * powf(base_strength, F(1.15));
    float o9 = orange * F(0.9);
    float cr = ccr + (F(1.20) - ccr) * o9, cg = ccr + (F(0.30) - ccr) * o9, cb = ccr + (F(0.10) - ccr) * o9;
    r = r + (cr - r) * c;
    g = g + (cg - g) * c;
    b = b + (cb - b) * c;
  }
  out[0] = g0 + (r - g0) * entire;
  out[1] = g1 + (g - g1) * entire;
  out[2] = g2 + (b - g2) * entire;
  return body;
}

}  // namespace mmt
