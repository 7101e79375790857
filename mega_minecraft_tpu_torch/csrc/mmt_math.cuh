// Hash, LCG, correctly rounded sin and GLM-compatible noise as inline device code.
//
// CUDA twin of mega_minecraft_tpu_torch/ops/{hashes,noise}.py, which port
// mega_minecraft_tpu/ops/{hashes,noise}.py (exact mode).  Every expression keeps the
// reference's operation order: the library is built with -fmad=false and no fast
// math, so each product and sum rounds on its own (the Dekker products in sin_cr are
// exact only without FMA), '/' and sqrtf are IEEE, and rintf rounds half to even.
// Float constants are written F(decimal): a double literal rounded to f32, which is
// what numpy.float32(decimal) gives the reference.
#pragma once

#include <math.h>
#include <stdint.h>

#include "mmt_ids.h"  // block / biome ids and scalar constants, generated at build

#define MMT_FN __device__ __forceinline__

#define F(x) ((float)(x))

namespace mmt {

// ---------------------------------------------------------------------------
// small helpers with the reference's NaN behaviour (jnp.maximum / jnp.clip
// propagate NaN; fmaxf would drop it)
// ---------------------------------------------------------------------------

MMT_FN float fmax_nan(float a, float b) { return (a > b || a != a) ? a : b; }
MMT_FN float clamp01(float t) { return t < 0.f ? 0.f : (t > 1.f ? 1.f : t); }
MMT_FN float fract(float x) { return x - floorf(x); }

MMT_FN float smoothstep(float e0, float e1, float x) {
  float t = clamp01((x - e0) / (e1 - e0));
  return t * t * (3.f - 2.f * t);
}

// ---------------------------------------------------------------------------
// integer hash + minstd LCG (hashes.py:40-104)
// ---------------------------------------------------------------------------

MMT_FN uint32_t hash_u32(uint32_t a) {
  a = (a + 0x7ED55D16u) + (a << 12);
  a = (a ^ 0xC761C23Cu) ^ (a >> 19);
  a = (a + 0x165667B1u) + (a << 5);
  a = (a + 0xD3A2646Cu) ^ (a << 9);
  a = (a + 0xFD7046C5u) + (a << 3);
  a = (a ^ 0xB55A4F09u) ^ (a >> 16);
  return a;
}

#define LCG_M 2147483647u

MMT_FN uint32_t engine_init(uint32_t s) {
  s = s % LCG_M;
  return s == 0u ? 1u : s;
}

MMT_FN uint32_t seed_1(int x) { return engine_init(hash_u32((uint32_t)x)); }

MMT_FN uint32_t seed_3(int x, int y, int z) {
  uint32_t h = 0x80000000u | ((uint32_t)x << 22) | (uint32_t)y;
  return engine_init(hash_u32(h) ^ hash_u32((uint32_t)z));
}

MMT_FN uint32_t seed_4(int x, int y, int z, int w) {
  uint32_t h = 0x80000000u | ((uint32_t)x << 22) | ((uint32_t)y << 11) | (uint32_t)w;
  return engine_init(hash_u32(h) ^ hash_u32((uint32_t)z));
}

MMT_FN uint32_t lcg_next(uint32_t s) {
  return (uint32_t)(((uint64_t)s * 48271ull) % (uint64_t)LCG_M);
}

// the uniform [0, 1] value of a state: ((x - 1) as f32) / f32(m - 2)
MMT_FN float lcg_value(uint32_t state) { return (float)(state - 1u) / F(2147483645.0); }

// one uniform draw in [0, 1]; advances *state
MMT_FN float lcg_u01(uint32_t* state) {
  *state = lcg_next(*state);
  return lcg_value(*state);
}

// (x * y) mod (2^31 - 1) for x, y < 2^31: the 64-bit product holds it whole
MMT_FN uint32_t lcg_mulmod(uint32_t x, uint32_t y) {
  return (uint32_t)(((uint64_t)x * (uint64_t)y) % (uint64_t)LCG_M);
}

// a^k mod m by square-and-multiply: the multiplier of a k-step jump of the stream
MMT_FN uint32_t lcg_pow(uint32_t k) {
  uint32_t result = 1u, base = 48271u;
  while (k) {
    if (k & 1u) result = lcg_mulmod(result, base);
    base = lcg_mulmod(base, base);
    k >>= 1;
  }
  return result;
}

// the uniform value of 0-based draw j of the stream that starts at state0, from the jump
// multiplier a^(j+1) mod m (lcg_pow(j + 1), or a table of them)
MMT_FN float lcg_value_at(uint32_t state0, uint32_t jump) { return lcg_value(lcg_mulmod(jump, state0)); }

// ---------------------------------------------------------------------------
// sin correctly rounded to f32 in double-single arithmetic (hashes.py:192-299)
// ---------------------------------------------------------------------------

MMT_FN void two_prod(float a, float b, float& p, float& e) {
  p = a * b;
  float aa = a * 4097.f;
  float ah = aa - (aa - a);
  float al = a - ah;
  float bb = b * 4097.f;
  float bh = bb - (bb - b);
  float bl = b - bh;
  e = ((ah * bh - p) + ah * bl + al * bh) + al * bl;
}

MMT_FN void two_sum(float a, float b, float& s, float& e) {
  s = a + b;
  float v = s - a;
  e = (a - (s - v)) + (b - v);
}

MMT_FN void ds_mul(float a_hi, float a_lo, float b_hi, float b_lo, float& s, float& t) {
  float p, e;
  two_prod(a_hi, b_hi, p, e);
  e = e + (a_hi * b_lo + a_lo * b_hi);
  two_sum(p, e, s, t);
}

MMT_FN void ds_add(float a_hi, float a_lo, float b_hi, float b_lo, float& s, float& t) {
  float s0, e;
  two_sum(a_hi, b_hi, s0, e);
  e = e + a_lo + b_lo;
  two_sum(s0, e, s, t);
}

MMT_FN float sin_cr(float d) {
  const float PI_HI = F(3.1415927410125732), PI_MED = F(-8.742277657347586e-08),
              PI_LO = F(-3.4302490200117637e-15);
  const float INVPI_HI = F(0.31830987334251404), INVPI_LO = F(1.2841276486597053e-08);
  float q_hi, q_e;
  two_prod(d, INVPI_HI, q_hi, q_e);
  float q_lo = q_e + d * INVPI_LO;
  float k0 = rintf(q_hi);
  float k1 = rintf((q_hi - k0) + q_lo);
  float p1, e1;
  two_prod(k0, PI_HI, p1, e1);
  float s1 = d - p1;
  float t_hi, t_lo;
  two_sum(s1, -e1, t_hi, t_lo);
  float p1b, e1b;
  two_prod(k1, PI_HI, p1b, e1b);
  float t2;
  two_sum(t_hi, -p1b, t_hi, t2);
  t_lo = t_lo + t2 - e1b;
  float p2, e2;
  two_prod(k0, PI_MED, p2, e2);
  float u_hi, u_lo;
  two_sum(t_hi, -p2, u_hi, u_lo);
  float k = k0 + k1;
  float r_hi, r_lo;
  two_sum(u_hi, u_lo + t_lo - (e2 + k1 * PI_MED + k * PI_LO), r_hi, r_lo);
  float r2_hi, r2_lo;
  ds_mul(r_hi, r_lo, r_hi, r_lo, r2_hi, r2_lo);
  const float C_HI[7] = {F(-7.647163609812713e-13), F(1.6059044372074283e-10),
                         F(-2.5052107943679403e-08), F(2.7557318844628753e-06),
                         F(-0.00019841270113829523), F(0.008333333767950535),
                         F(-0.1666666716337204)};
  const float C_LO[7] = {F(-1.2200710471178288e-20), F(-5.352526511562726e-18),
                         F(-4.4176230446483665e-16), F(3.793571224297229e-14),
                         F(2.725596874933456e-12), F(-4.34617203337595e-10),
                         F(4.967053879312289e-09)};
  float p_hi = C_HI[0], p_lo = C_LO[0];
#pragma unroll
  for (int i = 1; i < 7; ++i) {
    ds_mul(p_hi, p_lo, r2_hi, r2_lo, p_hi, p_lo);
    ds_add(p_hi, p_lo, C_HI[i], C_LO[i], p_hi, p_lo);
  }
  float r3_hi, r3_lo, tt_hi, tt_lo, s_hi, s_lo;
  ds_mul(r2_hi, r2_lo, r_hi, r_lo, r3_hi, r3_lo);
  ds_mul(r3_hi, r3_lo, p_hi, p_lo, tt_hi, tt_lo);
  ds_add(r_hi, r_lo, tt_hi, tt_lo, s_hi, s_lo);
  float sin_r = s_hi + s_lo;
  bool odd0 = (k0 - 2.f * floorf(k0 * 0.5f)) != 0.f;
  bool odd1 = (k1 - 2.f * floorf(k1 * 0.5f)) != 0.f;
  return (odd0 != odd1) ? -sin_r : sin_r;
}

MMT_FN float sinhash(float d) { return fract(sin_cr(d) * F(39021.426)); }

MMT_FN float rand1_from1(float x) { return sinhash(x * F(238.68)); }

MMT_FN float rand1_from2(float x, float y) { return sinhash(x * F(238.68) + y * F(491.28)); }

MMT_FN float rand1_from3(float x, float y, float z) {
  return sinhash(x * F(238.68) + y * F(491.28) + z * F(640.88));
}

MMT_FN void rand2_from2(float x, float y, float& r0, float& r1) {
  r0 = sinhash(x * F(238.68) + y * F(491.28));
  r1 = sinhash(x * F(654.37) + y * F(560.45));
}

MMT_FN void rand2_from3(float x, float y, float z, float& r0, float& r1) {
  r0 = sinhash(x * F(238.68) + y * F(491.28) + z * F(640.88));
  r1 = sinhash(x * F(654.37) + y * F(560.45) + z * F(151.81));
}

MMT_FN void rand3_from2(float x, float y, float& r0, float& r1, float& r2) {
  r0 = sinhash(x * F(238.68) + y * F(491.28));
  r1 = sinhash(x * F(654.37) + y * F(560.45));
  r2 = sinhash(x * F(640.88) + y * F(151.81));
}

// first component of rand3_from2 (the only one the terrain reads)
MMT_FN float rand3_from2_x(float x, float y) { return sinhash(x * F(238.68) + y * F(491.28)); }

// component k (0, 1, 2) of rand3_from3
MMT_FN float rand3_from3_k(float x, float y, float z, int k) {
  float a = k == 0 ? F(238.68) : (k == 1 ? F(654.37) : F(640.88));
  float b = k == 0 ? F(491.28) : (k == 1 ? F(560.45) : F(151.81));
  float c = k == 0 ? F(402.98) : (k == 1 ? F(747.42) : F(674.81));
  return sinhash(x * a + y * b + z * c);
}

MMT_FN void rand3_from3(float x, float y, float z, float& r0, float& r1, float& r2) {
  r0 = rand3_from3_k(x, y, z, 0);
  r1 = rand3_from3_k(x, y, z, 1);
  r2 = rand3_from3_k(x, y, z, 2);
}

// ---------------------------------------------------------------------------
// simplex noise (noise.py:48-252)
// ---------------------------------------------------------------------------

MMT_FN float mod289(float x) { return x - floorf(x * F(1.0 / 289.0)) * 289.f; }

// floored integer mod 289 of an integer-valued lattice coordinate (C's % truncates)
MMT_FN float mod289_lattice(float x) {
  int m = ((int)x) % 289;
  if (m < 0) m += 289;
  return (float)m;
}

MMT_FN float permute(float x) { return mod289((x * 34.f + 1.f) * x); }

MMT_FN float taylor_inv_sqrt(float r) { return F(1.79284291400159) - F(0.85373472095314) * r; }

MMT_FN float simplex2(float px, float py) {
  const float Cx = F(0.211324865405187), Cy = F(0.366025403784439),
              Cz = F(-0.577350269189626), Cw = F(0.024390243902439);
  float s = px * Cy + py * Cy;
  float ix = floorf(px + s);
  float iy = floorf(py + s);
  float t = ix * Cx + iy * Cx;
  float x0x = px - ix + t;
  float x0y = py - iy + t;
  float i1x = x0x > x0y ? 1.f : 0.f;
  float i1y = x0x > x0y ? 0.f : 1.f;
  float x12x = x0x + Cx - i1x;
  float x12y = x0y + Cx - i1y;
  float x12z = x0x + Cz;
  float x12w = x0y + Cz;
  float imx = mod289_lattice(ix);
  float imy = mod289_lattice(iy);
  float p0 = permute(permute(imy) + imx);
  float p1 = permute(permute(imy + i1y) + imx + i1x);
  float p2 = permute(permute(imy + 1.f) + imx + 1.f);
  float m0 = fmax_nan(0.5f - (x0x * x0x + x0y * x0y), 0.f);
  float m1 = fmax_nan(0.5f - (x12x * x12x + x12y * x12y), 0.f);
  float m2 = fmax_nan(0.5f - (x12z * x12z + x12w * x12w), 0.f);
  m0 = m0 * m0;
  m0 = m0 * m0;
  m1 = m1 * m1;
  m1 = m1 * m1;
  m2 = m2 * m2;
  m2 = m2 * m2;
  float g[3];
  const float p[3] = {p0, p1, p2};
  const float xa[3] = {x0x, x12x, x12z};
  const float ya[3] = {x0y, x12y, x12w};
  float m[3] = {m0, m1, m2};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float x = 2.f * fract(p[i] * Cw) - 1.f;
    float h = fabsf(x) - 0.5f;
    float a0 = x - floorf(x + 0.5f);
    m[i] = m[i] * taylor_inv_sqrt(a0 * a0 + h * h);
    g[i] = a0 * xa[i] + h * ya[i];
  }
  return 130.f * (m[0] * g[0] + m[1] * g[1] + m[2] * g[2]);
}

MMT_FN void simplex3_gradcorner(float p, float& ax, float& ay, float& h) {
  const float n_ = F(0.142857142857);
  const float ns_x = n_ * 2.f - 0.f;
  const float ns_y = n_ * 0.5f - 1.f;
  const float ns_z = n_ * 1.f - 0.f;
  float j = p - 49.f * floorf(p * ns_z * ns_z);
  float x_ = floorf(j * ns_z);
  float y_ = floorf(j - 7.f * x_);
  float x = x_ * ns_x + ns_y;
  float y = y_ * ns_x + ns_y;
  h = 1.f - fabsf(x) - fabsf(y);
  float sx = floorf(x) * 2.f + 1.f;
  float sy = floorf(y) * 2.f + 1.f;
  float sh = -(h <= 0.f ? 1.f : 0.f);
  ax = x + sx * sh;
  ay = y + sy * sh;
}

MMT_FN float simplex3(float px, float py, float pz) {
  const float C_x = F(1.0 / 6.0), C_y = F(1.0 / 3.0);
  float s = px * C_y + py * C_y + pz * C_y;
  float ix = floorf(px + s);
  float iy = floorf(py + s);
  float iz = floorf(pz + s);
  float t = ix * C_x + iy * C_x + iz * C_x;
  float x0x = px - ix + t;
  float x0y = py - iy + t;
  float x0z = pz - iz + t;
  float gx = x0x >= x0y ? 1.f : 0.f;
  float gy = x0y >= x0z ? 1.f : 0.f;
  float gz = x0z >= x0x ? 1.f : 0.f;
  float lx = 1.f - gx, ly = 1.f - gy, lz = 1.f - gz;
  float i1x = fminf(gx, lz), i1y = fminf(gy, lx), i1z = fminf(gz, ly);
  float i2x = fmaxf(gx, lz), i2y = fmaxf(gy, lx), i2z = fmaxf(gz, ly);
  float x1x = x0x - i1x + C_x, x1y = x0y - i1y + C_x, x1z = x0z - i1z + C_x;
  float x2x = x0x - i2x + C_y, x2y = x0y - i2y + C_y, x2z = x0z - i2z + C_y;
  float x3x = x0x - 0.5f, x3y = x0y - 0.5f, x3z = x0z - 0.5f;
  ix = mod289(ix);
  iy = mod289(iy);
  iz = mod289(iz);
  float pz0 = permute(iz), pz1 = permute(iz + i1z), pz2 = permute(iz + i2z),
        pz3 = permute(iz + 1.f);
  float py0 = permute(pz0 + iy), py1 = permute(pz1 + iy + i1y), py2 = permute(pz2 + iy + i2y),
        py3 = permute(pz3 + iy + 1.f);
  float p[4] = {permute(py0 + ix), permute(py1 + ix + i1x), permute(py2 + ix + i2x),
                permute(py3 + ix + 1.f)};
  const float xs[4] = {x0x, x1x, x2x, x3x};
  const float ys[4] = {x0y, x1y, x2y, x3y};
  const float zs[4] = {x0z, x1z, x2z, x3z};
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float gxx, gyy, gzz;
    simplex3_gradcorner(p[i], gxx, gyy, gzz);
    float n = taylor_inv_sqrt(gxx * gxx + gyy * gyy + gzz * gzz);
    float m = fmax_nan(0.6f - (xs[i] * xs[i] + ys[i] * ys[i] + zs[i] * zs[i]), 0.f);
    m = m * m;
    float d = (gxx * n) * xs[i] + (gyy * n) * ys[i] + (gzz * n) * zs[i];
    float term = m * m * d;
    acc = (i == 0) ? term : acc + term;  // left to right from the first term
  }
  return 42.f * acc;
}

MMT_FN float fbm2(float px, float py, int octaves) {
  float total = 0.f, amplitude = 1.f;
  for (int o = 0; o < octaves; ++o) {
    amplitude *= 0.5f;
    float term = amplitude * simplex2(px, py);
    total = (o == 0) ? term : total + term;
    px = px * 2.f;
    py = py * 2.f;
  }
  return total;
}

MMT_FN float fbm3(float px, float py, float pz, int octaves) {
  float total = 0.f, amplitude = 1.f;
  for (int o = 0; o < octaves; ++o) {
    amplitude *= 0.5f;
    float term = amplitude * simplex3(px, py, pz);
    total = (o == 0) ? term : total + term;
    px = px * 2.f;
    py = py * 2.f;
    pz = pz * 2.f;
  }
  return total;
}

MMT_FN void fbm2_from2(float px, float py, int octaves, float& a, float& b) {
  a = fbm2(px, py, octaves);
  b = fbm2(px + F(5923.45), py + F(4129.42), octaves);
}

MMT_FN void simplex2_from2(float px, float py, float& a, float& b) {
  a = simplex2(px, py);
  b = simplex2(px + F(5923.45), py + F(4129.42));
}

MMT_FN void fbm3_from3(float px, float py, float pz, int octaves, float& a, float& b, float& c) {
  a = fbm3(px, py, pz, octaves);
  b = fbm3(px + F(5923.45), py + F(4129.42), pz + F(5790.48), octaves);
  c = fbm3(px + F(1765.68), py + F(4704.36), pz + F(5692.12), octaves);
}

// ---------------------------------------------------------------------------
// Worley noise (noise.py:319-430)
// ---------------------------------------------------------------------------

#define MMT_FLT_MAX 3.40282346638528859812e+38f

// 2-D Worley: F1, (F2 - F1) / 2 and the closest cell's jitter (cpx, cpy);
// the 'color' red channel of the reference is rand3_from2_x(cpx, cpy)
MMT_FN void worley2(float px, float py, float& f1, float& edge, float& cpx, float& cpy) {
  float ix = floorf(px), iy = floorf(py);
  float fx = px - ix, fy = py - iy;
  float min1 = MMT_FLT_MAX, min2 = MMT_FLT_MAX;
  cpx = 0.f;
  cpy = 0.f;
  for (int ox = -1; ox <= 1; ++ox) {
    for (int oy = -1; oy <= 1; ++oy) {
      float rx, ry;
      rand2_from2(ix + (float)ox, iy + (float)oy, rx, ry);
      float dx = (float)ox + rx - fx;
      float dy = (float)oy + ry - fy;
      float d = sqrtf(dx * dx + dy * dy);
      bool is1 = d < min1;
      bool is2 = !is1 && d < min2;
      min2 = is1 ? min1 : (is2 ? d : min2);
      min1 = is1 ? d : min1;
      if (is1) {
        cpx = rx;
        cpy = ry;
      }
    }
  }
  f1 = min1;
  edge = (min2 - min1) * 0.5f;
}

// The jitter of a 3-D Worley search's cell: rand3_from3 at the cell (ix + ox, iy + oy, iz + oz),
// (ix, iy, iz) being the floor of the point.  HashJitter hashes it; TableJitter reads it from a
// table of a cell box that fill_jitter_table filled: component k of the integer cell
// (x0 + a, y0 + b, z0 + c) at table[k * stride + (a * ny + b) * nz + c].  The table hashes the
// float of the integer cell, (float)(x0 + a); the hash reads ix + (float)ox.  Both are the
// integer ix + ox rounded to nearest even (ix, a float holding an integer, and ox are exact), so
// the two agree at every coordinate, past 2^24 too, where that float is no longer the integer.
struct HashJitter {
  MMT_FN void operator()(float ix, float iy, float iz, int ox, int oy, int oz, float& rx, float& ry,
                         float& rz) const {
    rand3_from3(ix + (float)ox, iy + (float)oy, iz + (float)oz, rx, ry, rz);
  }
};

struct TableJitter {
  const float* table;
  int stride, x0, y0, z0, ny, nz;
  MMT_FN void operator()(float ix, float iy, float iz, int ox, int oy, int oz, float& rx, float& ry,
                         float& rz) const {
    int cell = (((int)ix + ox - x0) * ny + ((int)iy + oy - y0)) * nz + ((int)iz + oz - z0);
    rx = table[cell];
    ry = table[stride + cell];
    rz = table[2 * stride + cell];
  }
};

// the jitters of the nx x ny x nz cells from (x0, y0, z0), one hash (one component of one cell)
// per step of a loop that threads t = 0 .. nt - 1 share; table holds 3 * n floats (stride n)
MMT_FN void fill_jitter_table(float* table, int n, int x0, int y0, int z0, int ny, int nz, int t,
                              int nt) {
  for (int i = t; i < 3 * n; i += nt) {
    int k = i / n, cell = i - k * n;
    int a = cell / (ny * nz), rem = cell - a * (ny * nz);
    int b = rem / nz, c = rem - b * nz;
    table[i] = rand3_from3_k((float)(x0 + a), (float)(y0 + b), (float)(z0 + c), k);
  }
}

// Worley F1 over the 27 cells around (px, py, pz), the jitters from `jitter`
template <class Jitter>
MMT_FN float worley3_f1_search(float px, float py, float pz, Jitter jitter) {
  float ix = floorf(px), iy = floorf(py), iz = floorf(pz);
  float fx = px - ix, fy = py - iy, fz = pz - iz;
  float min1 = MMT_FLT_MAX;
  for (int ox = -1; ox <= 1; ++ox)
    for (int oy = -1; oy <= 1; ++oy)
      for (int oz = -1; oz <= 1; ++oz) {
        float rx, ry, rz;
        jitter(ix, iy, iz, ox, oy, oz, rx, ry, rz);
        float dx = (float)ox + rx - fx;
        float dy = (float)oy + ry - fy;
        float dz = (float)oz + rz - fz;
        float d = sqrtf(dx * dx + dy * dy + dz * dz);
        min1 = d < min1 ? d : min1;
      }
  return min1;
}

// worley3's F1 hashing each of its 27 cells (27 rand3_from3, 81 sin_cr)
MMT_FN float worley3_f1(float px, float py, float pz) { return worley3_f1_search(px, py, pz, HashJitter()); }

// the 3-min-distance Worley ratio min3 / min1 - 1 over the 27 cells around (px, py, pz), the
// jitters from `jitter`
template <class Jitter>
MMT_FN float special_cave_search(float px, float py, float pz, Jitter jitter) {
  float ix = floorf(px), iy = floorf(py), iz = floorf(pz);
  float fx = px - ix, fy = py - iy, fz = pz - iz;
  float min1 = MMT_FLT_MAX, min2 = MMT_FLT_MAX, min3 = MMT_FLT_MAX;
  for (int ox = -1; ox <= 1; ++ox)
    for (int oy = -1; oy <= 1; ++oy)
      for (int oz = -1; oz <= 1; ++oz) {
        float rx, ry, rz;
        jitter(ix, iy, iz, ox, oy, oz, rx, ry, rz);
        float dx = (float)ox + rx - fx;
        float dy = (float)oy + ry - fy;
        float dz = (float)oz + rz - fz;
        float d = sqrtf(dx * dx + dy * dy + dz * dz);
        bool is1 = d < min1;
        bool is2 = !is1 && d < min2;
        bool is3 = !is1 && !is2 && d < min3;
        min3 = (is1 || is2) ? min2 : (is3 ? d : min3);
        min2 = is1 ? min1 : (is2 ? d : min2);
        min1 = is1 ? d : min1;
      }
  return min3 / min1 - 1.f;
}

// special_cave_noise hashing each of its 27 cells (27 rand3_from3, 81 sin_cr)
MMT_FN float special_cave_noise(float px, float py, float pz) {
  return special_cave_search(px, py, pz, HashJitter());
}

// special_cave_noise with the jitters read from a table of a cell box (TableJitter): the box must
// hold the 27 cells around the point; the result is special_cave_noise's bit for bit
MMT_FN float special_cave_noise_table(float px, float py, float pz, const float* table, int stride,
                                      int x0, int y0, int z0, int ny, int nz) {
  return special_cave_search(px, py, pz, TableJitter{table, stride, x0, y0, z0, ny, nz});
}

// ---------------------------------------------------------------------------
// cave biomes (caves.py:120-172), shared by K3 (layer edges) and K4 (fill)
// ---------------------------------------------------------------------------

MMT_FN void cave_biome_noise(float wx, float wy, float wz, float max_height, float n[4]) {
  float ox, oy, oz;
  fbm3_from3(wx * F(0.0470), wy * F(0.0470), wz * F(0.0470), 3, ox, oy, oz);
  float px = wx + ox * 30.f;
  float py = wy + oy * 24.f;
  float pz = wz + oz * 30.f;
  float n2x = px * F(0.2);
  float n2z = pz * F(0.2);
  float top_h = (float)SEA_LEVEL + F(0.15) * (max_height - (float)SEA_LEVEL);
  float none_start = top_h - 19.f + 23.f * fbm2(n2x, n2z, 3);
  float none_end = none_start - 5.f + 3.f * fbm2(n2x + F(3821.34), n2z + F(4920.32), 3);
  float shallow_start = top_h - 72.f + 18.f * fbm2(n2x + F(-4921.34), n2z + F(8402.13), 3);
  float shallow_end = shallow_start - 10.f + 7.f * fbm2(n2x + F(9411.32), n2z + F(-3921.34), 3);
  n[0] = smoothstep(none_end, none_start, py);
  n[1] = smoothstep(shallow_end, shallow_start, py);
  float sw = simplex3(px * F(0.0030) + F(5821.32), py * F(0.0030) + F(4920.12),
                      pz * F(0.0030) + F(7931.59));
  n[2] = smoothstep(-F(0.05), F(0.05), sw);
  float sr = simplex3(px * F(0.0022) + F(-9193.23), py * F(0.0022) + F(-6813.39),
                      pz * F(0.0022) + F(-2171.23));
  n[3] = smoothstep(-F(0.05), F(0.05), sr);
}

// getCaveBiome: weighted pick by one seeded u01 draw; table [n_cave_biomes, 4] of
// 0 (ignore) / 1 (n) / 2 (1 - n), multiplied in channel order
MMT_FN int cave_biome(int wx, int wy, int wz, float max_height, int seed, const int* table,
                      int n_cave_biomes) {
  float n[4];
  cave_biome_noise((float)wx, (float)wy, (float)wz, max_height, n);
  uint32_t st = seed_4(wx, wy, wz, seed);
  float rnd = lcg_u01(&st);
  float running = 0.f;
  for (int cb = 0; cb < n_cave_biomes; ++cb) {
    float w = 1.f;
    for (int c = 0; c < 4; ++c) {
      int kind = table[cb * 4 + c];
      if (kind == 1) w = w * n[c];
      else if (kind == 2) w = w * (1.f - n[c]);
    }
    running = running + w;
    if (rnd - running <= 0.f) return cb;
  }
  return CAVE_NONE;
}

// ---------------------------------------------------------------------------
// the renderer's per-pixel RNG (hashes.py:473-494; random_number_generators.h)
// ---------------------------------------------------------------------------

MMT_FN uint32_t tea(uint32_t v0, uint32_t v1, int rounds) {
  uint32_t s0 = 0u;
  for (int i = 0; i < rounds; ++i) {
    s0 += 0x9E3779B9u;
    v0 += ((v1 << 4) + 0xA341316Cu) ^ (v1 + s0) ^ ((v1 >> 5) + 0xC8013EA4u);
    v1 += ((v0 << 4) + 0xAD90777Du) ^ (v0 + s0) ^ ((v0 >> 5) + 0x7E95761Eu);
  }
  return v0;
}

MMT_FN uint32_t lcg_render(uint32_t s) { return 1664525u * s + 1013904223u; }

// uniform in [0, 1) from the low 24 bits of the next state; advances *state
MMT_FN float rnd_u01(uint32_t* state) {
  *state = lcg_render(*state);
  return (float)(*state & 0x00FFFFFFu) / F(16777216.0);
}

}  // namespace mmt
