// Feature SDF library as device functions: the per-block geometry tests of the 20 surface
// and 9 cave feature types.
//
// CUDA twin of mega_minecraft_tpu_torch/terrain/features_sdf.py, which ports
// mega_minecraft_tpu/terrain/features_sdf.py.  Each feature function answers for ONE block
// whether the placement's geometry hits it and with which block id.  Every expression keeps the
// plain version's operation order (the library is built without FMA contraction and
// without fast math), and every constant is the f32 the plain version's Python number
// becomes; cosf / sinf / acosf / atan2f / powf / fmodf are CUDA's libm, the same
// functions the plain version's torch calls reach on the card.
//
// Arguments of a feature function:
//   s        the placement's 64-draw stream (feature_streams kernel), read-only
//   fx,fy,fz block position minus placement position
//   wx,wy,wz world block position
//   brng     the per-block minstd state, seeded anew for every placement evaluation;
//            a draw advances it only where the plain version's mask holds
//   p        the placement's position; h (cave features) the cave layer's height
// Where a feature function can leave early without changing its answer (its result is ANDed
// with an in-bounds test that costs little), it does.
#pragma once

#include "mmt_math.cuh"
#include "mmt_feature_tables.h"

namespace mmt {

#define SDF_FN __device__ __noinline__

#define SDF_PI F(3.141592653589793)
#define SDF_TWO_PI F(6.283185307179586)
#define SDF_PI_OVER_TWO F(1.5707963267948966)
// cos(pi / 6) in f32 (written out: a compiler may fold cosf of a constant differently)
#define SDF_COS_PI_OVER_6 F(0.8660253882408142)

struct Placement {
  int x, y, z;
};

// powf with a run-time exponent: kept out of line so that no constant exponent is
// strength-reduced to multiplies (the plain version calls pow on a tensor exponent)
__device__ __noinline__ float pow_rt(float x, float e) { return powf(x, e); }

MMT_FN float length2(float x, float z) { return sqrtf(x * x + z * z); }
MMT_FN float length3(float x, float y, float z) { return sqrtf(x * x + y * y + z * z); }
MMT_FN int iabs(int v) { return v < 0 ? -v : v; }
MMT_FN int imax(int a, int b) { return a > b ? a : b; }
MMT_FN int imin(int a, int b) { return a < b ? a : b; }
MMT_FN bool in_range_i(int v, int lo, int hi) { return v >= lo && v <= hi; }
MMT_FN bool in_range_f(float v, float lo, float hi) { return v >= lo && v <= hi; }
MMT_FN float clampf(float v, float lo, float hi) { return fminf(fmaxf(v, lo), hi); }

// one draw of the per-block state, advanced only where `mask`
MMT_FN float brng_draw(uint32_t& brng, bool mask) {
  uint32_t nxt = lcg_next(brng);
  if (mask) brng = nxt;
  return lcg_value(nxt);
}

struct Vec3 {
  float x, y, z;
};

// calculateLineParams
MMT_FN void line_params(float px, float py, float pz, Vec3 a, Vec3 b, float& ratio, float& dist,
                        bool& in01) {
  float vx = b.x - a.x, vy = b.y - a.y, vz = b.z - a.z;
  float wx_ = px - a.x, wy_ = py - a.y, wz_ = pz - a.z;
  float denom = vx * vx + vy * vy + vz * vz;
  if (denom == 0.f) denom = F(1e-9);
  ratio = (wx_ * vx + wy_ * vy + wz_ * vz) / denom;
  float lx = vx * ratio, ly = vy * ratio, lz = vz * ratio;
  dist = length3(wx_ - lx, wy_ - ly, wz_ - lz);
  in01 = ratio >= 0.f && ratio <= 1.f;
}

// isInRasterizedLine
MMT_FN bool in_rasterized_line(int fx, int fy, int fz, Vec3 a, Vec3 b) {
  float px = (float)fx + 0.5f, py = (float)fy + 0.5f, pz = (float)fz + 0.5f;
  float ratio, dist;
  bool in01;
  line_params(px, py, pz, a, b, ratio, dist, in01);
  float mx = a.x + (b.x - a.x) * ratio;
  float my = a.y + (b.y - a.y) * ratio;
  float mz = a.z + (b.z - a.z) * ratio;
  bool same_cell = fx == (int)floorf(mx) && fy == (int)floorf(my) && fz == (int)floorf(mz);
  return in01 && dist < 2.f && same_cell;
}

// jungleLeaves
MMT_FN bool jungle_leaves(float px, float py, float pz, float max_h, float min_r, float max_r,
                          float rand) {
  float mult = F(0.8) + F(0.4) * rand;
  float ratio = py / max_h;
  float radius = (max_r + (min_r - max_r) * ratio) * mult;
  return in_range_f(py, 0.f, max_h) && length2(px, pz) < radius;
}

// deCasteljau: point i of `size` on the Bezier curve of n control points (n <= 5)
MMT_FN Vec3 de_casteljau_point(const Vec3* ctrl, int n, float t) {
  Vec3 pts[5];
  for (int j = 0; j < n; ++j) pts[j] = ctrl[j];
  for (int m = n; m > 1; --m)
    for (int j = 0; j < m - 1; ++j) {
      pts[j].x = pts[j].x + (pts[j + 1].x - pts[j].x) * t;
      pts[j].y = pts[j].y + (pts[j + 1].y - pts[j].y) * t;
      pts[j].z = pts[j].z + (pts[j + 1].z - pts[j].z) * t;
    }
  return pts[0];
}

MMT_FN float crystal_radius(float ratio) {
  return ratio < F(0.8) ? F(0.8) + F(0.25) * ratio : F(1.0 / (1.0 - 0.8)) * (1.f - ratio);
}

// isInCrystal: 6-sided prism along the line a -> b
MMT_FN bool in_crystal(float px, float py, float pz, Vec3 a, Vec3 b, float radius_mult) {
  float ratio, dist;
  bool in01;
  line_params(px, py, pz, a, b, ratio, dist, in01);
  float radius = crystal_radius(clampf(ratio, 0.f, 1.f)) * radius_mult;
  float lx = b.x - a.x, ly = b.y - a.y, lz = b.z - a.z;
  float qx = px - (a.x + ratio * lx);
  float qy = py - (a.y + ratio * ly);
  float qz = pz - (a.z + ratio * lz);
  float qlen = length3(qx, qy, qz);
  // axis = normalize(cross(line, (1, 0, 0)))
  float cy_ = lz, cz_ = -ly;
  float cl = sqrtf(cy_ * cy_ + cz_ * cz_);
  if (cl == 0.f) cl = F(1e-9);
  float qsafe = qlen == 0.f ? F(1e-9) : qlen;
  float dot = (qy * cy_ + qz * cz_) / (qsafe * cl);
  float ang = acosf(clampf(dot, -1.f, 1.f));
  float pos_angle = qlen == 0.f ? 0.f : ang + SDF_TWO_PI;
  const float p = F(3.141592653589793 / 6.0);
  const float two_p = 2.f * p;
  float m = fmodf(pos_angle, two_p);  // torch.remainder: fmod, moved to the divisor's sign
  if (m != 0.f && m < 0.f) m += two_p;
  radius = (radius * SDF_COS_PI_OVER_6) / cosf(p - m);
  return in01 && dist < radius;
}

MMT_FN int random_crystal_block(float rand) {
  float cr = rand * 3.f;
  return cr < 1.f ? BLOCK_MAGENTA_CRYSTAL : (cr < 2.f ? BLOCK_CYAN_CRYSTAL : BLOCK_GREEN_CRYSTAL);
}

// ---------------------------------------------------------------------------
// surface features
// ---------------------------------------------------------------------------

SDF_FN bool feat_sphere(int fx, int fy, int fz, int& block) {
  float dx = (float)fx, dy = (float)fy, dz = (float)fz;
  block = BLOCK_GRAVEL;
  return dx * dx + dy * dy + dz * dz <= 25.f;
}

SDF_FN bool feat_coral(const float* s, int fx, int fy, int fz, int wx, int wy, int wz, Placement p,
                       int& block) {
  float px = (float)fx, py = (float)fy, pz = (float)fz;
  bool in_reef = p.y <= SEA_LEVEL - 6 && length2(px, pz) <= 8.f;
  if (!in_reef) return false;
  int coral_rand = (int)floorf(s[0] * 5.f);
  float wxf = (float)wx, wyf = (float)wy, wzf = (float)wz;
  bool hit;
  if (coral_rand == 0) {
    float r = F(2.8) + F(1.4) * s[1] + F(0.4) * simplex3(wxf * F(0.2), wyf * F(0.2), wzf * F(0.2));
    hit = length3(px, py * F(1.15), pz) < r;
    block = BLOCK_BRAIN_CORAL_BLOCK;
  } else if (coral_rand == 1) {
    float r = F(2.2) + F(1.7) * s[1] + F(1.2) * simplex3(wxf * F(0.3), wyf * F(0.3), wzf * F(0.3));
    hit = length3(px, py * F(1.25), pz) < r;
    block = BLOCK_BUBBLE_CORAL_BLOCK;
  } else if (coral_rand <= 3) {
    // fire / horn: rasterized branch lines; draw order z, y, x
    Vec3 zero = {0.f, 0.f, 0.f};
    Vec3 p1;
    p1.z = (s[1] * 2.f - 1.f) * F(2.5);
    p1.y = s[2] * F(3.5);
    p1.x = (s[3] * 2.f - 1.f) * F(2.5);
    hit = in_rasterized_line(fx, fy, fz, zero, p1);
    int k = 4;
    for (int i = 0; i < 5; ++i) {
      Vec3 p2;
      p2.x = p1.x + 4.f * (s[k] * 2.f - 1.f);
      p2.y = p1.y + 2.f + 3.f * s[k + 1];
      p2.z = p1.z + 4.f * (s[k + 2] * 2.f - 1.f);
      hit = hit || in_rasterized_line(fx, fy, fz, p1, p2);
      k += 3;
    }
    block = coral_rand == 2 ? BLOCK_FIRE_CORAL_BLOCK : BLOCK_HORN_CORAL_BLOCK;
  } else {
    float f1, edge, cpx, cpy;
    worley2(wxf * F(0.7), wzf * F(0.7), f1, edge, cpx, cpy);
    float h_tube = ((1.f - f1) + edge) * F(3.5);
    h_tube = h_tube * smoothstep(F(3.7), F(2.5), length2(px, pz)) - 2.f;
    hit = in_range_f(py, -1.f, h_tube);
    block = BLOCK_TUBE_CORAL_BLOCK;
  }
  return hit;
}

SDF_FN bool feat_kelp(const float* s, int fx, int fy, int fz, Placement p, int& block) {
  int height = (int)floorf(5.f + 15.f * s[0]);
  height = imin(height, SEA_LEVEL - p.y - 1);
  block = fy == height ? BLOCK_KELP_END : BLOCK_KELP_MAIN;
  return fx == 0 && fz == 0 && in_range_i(fy, 0, height);
}

SDF_FN bool feat_iceberg(const float* s, int fx, int fz, int wx, int wy, int wz, Placement p,
                         int& block) {
  if (!(p.y <= SEA_LEVEL - 32)) return false;
  float px = (float)fx, pz = (float)fz;
  float py = (float)wy - (float)SEA_LEVEL;
  float hd = length2(px, pz);
  float radius = 20.f + 12.f * s[0];
  float center_ratio = 1.f - hd / radius;
  if (!(center_ratio <= F(1.15))) return false;
  float nx = (float)wx * F(0.0450);
  float nz = (float)wz * F(0.0450);
  float fb = fbm2(nx, nz, 3);
  float start_h = -6.f - 34.f * center_ratio + 14.f * fb;
  float end_h = -4.f + 20.f * center_ratio + 8.f * fb;
  bool hit = end_h >= start_h && in_range_f(py, start_h, end_h);
  if (!hit) return false;
  float packed_h = F(-2.2) + F(5.6) * center_ratio + F(1.2) * simplex2(nx * F(0.8), nz * F(0.8));
  block = py < -4.f ? BLOCK_BLUE_ICE : (py > end_h - packed_h ? BLOCK_PACKED_ICE : BLOCK_BLUE_ICE);
  return true;
}

SDF_FN bool feat_acacia(const float* s, int fx, int fy, int fz, int& block) {
  if (!(imax(iabs(fx), iabs(fz)) <= 15)) return false;
  float px = (float)fx, py = (float)fy, pz = (float)fz;
  int trunk_h = (int)floorf(F(4.5) + F(1.5) * s[0]);
  bool trunk = fx == 0 && fz == 0 && in_range_i(fy, 0, trunk_h);

  float angle = s[1] * SDF_TWO_PI;
  float bsy = (float)trunk_h;
  float bex = cosf(angle) * (2.f + F(1.5) * s[2]);
  float bez = sinf(angle) * (2.f + F(1.5) * s[2]);
  float bey = bsy + F(2.5) + F(1.5) * s[3];
  Vec3 a1 = {0.f, floorf(bsy), 0.f}, b1 = {ceilf(bex), ceilf(bey), ceilf(bez)};
  bool branch1 = in_rasterized_line(fx, fy, fz, a1, b1);
  bool l1 = jungle_leaves(px - bex, py - bey + 0.5f, pz - bez, 2.f, 2.f, 4.f, 0.5f + 0.5f * s[4]);

  bool second = s[5] < 0.5f;
  float angle2 = angle + SDF_PI_OVER_TWO + s[6] * SDF_PI;
  float bs2y = (float)trunk_h - F(0.8) - F(0.8) * s[7];
  float be2x = cosf(angle2) * (F(1.5) + 1.f * s[8]);
  float be2z = sinf(angle2) * (F(1.5) + 1.f * s[8]);
  float be2y = bs2y + 2.f + 1.f * s[9];
  Vec3 a2 = {0.f, floorf(bs2y), 0.f}, b2 = {ceilf(be2x), ceilf(be2y), ceilf(be2z)};
  bool branch2 = second && in_rasterized_line(fx, fy, fz, a2, b2);
  bool l2 = second && jungle_leaves(px - be2x, py - be2y + 0.5f, pz - be2z, F(2.001), F(1.5), F(3.5),
                                    0.5f + 0.5f * s[10]);

  bool wood = trunk || branch1 || branch2;
  bool leaves = (l1 || l2) && !wood;
  block = wood ? BLOCK_ACACIA_WOOD : BLOCK_ACACIA_LEAVES;
  return wood || leaves;
}

SDF_FN bool feat_redwood(const float* s, int fx, int fy, int fz, int wx, int wy, int wz, Placement p,
                         int& block) {
  float scale = F(0.6) + F(0.3) * s[0];
  float px = (float)fx * scale, py = (float)fy * scale, pz = (float)fz * scale;
  float height = 27.f + 13.f * s[1];
  float hd = length2(px, pz);
  float leaves_start = 10.f + 4.f * s[2];
  bool in_bounds = !((py > height + 8.f) || (hd > 12.f) || ((py < leaves_start - 4.f) && (hd > 3.f)));
  if (!in_bounds) return false;
  float wxf = (float)wx, wyf = (float)wy, wzf = (float)wz;

  float trunk_ratio = (py - (-4.f)) / (height - (-4.f));
  bool sat = trunk_ratio >= 0.f && trunk_ratio <= 1.f;
  float trunk_r = 2.f / (trunk_ratio + 2.f) + F(0.08) / pow_rt(trunk_ratio + F(0.4), 3.f);
  trunk_r = trunk_r + F(0.3) * simplex3(wxf * F(0.13), wyf * F(0.13), wzf * F(0.13)) *
                          smoothstep(F(0.6), F(0.2), trunk_ratio);
  bool trunk = sat && hd < trunk_r;

  float leaves_end = height + F(1.5) + 1.f * s[3];
  bool in_leaf_band = in_range_f(py, leaves_start, leaves_end);

  int cell_base = (int)(floorf(py * 0.5f) * 2.f);
  float branch_seed = F(593.23) * rand1_from3((float)p.x, (float)p.y, (float)p.z);
  float leaves_seed = F(412.39) * rand1_from1(branch_seed);
  float leaves_simplex = F(1.1) * simplex3(wxf * F(0.2), wyf * F(0.2), wzf * F(0.2));
  bool in_leaves = false, branch_hit = false;
  for (int dy = -4; dy <= 4; dy += 2) {
    float cell_h = (float)(cell_base + dy);
    float hr = (cell_h - leaves_start) / (leaves_end - leaves_start);
    hr = F(1.1) - 0.5f * hr;
    float r0, r1, r2;
    rand3_from2(cell_h, leaves_seed, r0, r1, r2);
    float ccx = (r0 - 0.5f) * F(7.5) * hr;
    float ccy = (r1 - 0.5f) * F(1.3) * hr;
    float ccz = (r2 - 0.5f) * F(7.5) * hr;
    ccy = fminf(ccy + cell_h, height + F(0.8));
    float bsy = ccy - 2.f - F(1.5) * rand1_from1(cell_h + branch_seed);
    float ratio, dist;
    bool in01;
    Vec3 a = {0.f, bsy, 0.f}, b = {ccx, ccy, ccz};
    line_params(px, py, pz, a, b, ratio, dist, in01);
    branch_hit = branch_hit || (in01 && dist < 0.5f);
    float lx = px - ccx;
    float ly = (py - ccy) * F(1.7);
    float lz = pz - ccz;
    float ld = length3(lx, ly, lz);
    float lr = (F(2.5) + 0.5f * rand1_from1(cell_h + leaves_seed) + leaves_simplex) * hr;
    in_leaves = in_leaves || (ld <= 5.f && ld < lr);
  }

  bool wood = trunk || (branch_hit && in_leaf_band);
  bool leaves = in_leaves && in_leaf_band && !wood;
  block = wood ? BLOCK_REDWOOD_WOOD : BLOCK_REDWOOD_LEAVES;
  return wood || leaves;
}

SDF_FN bool feat_cypress(const float* s, int fx, int fy, int fz, int wx, int wy, int wz, int& block) {
  float px = (float)fx, py = (float)fy, pz = (float)fz;
  float trunk_h = 25.f + 12.f * s[0];
  float td = length2(px, pz);
  bool in_bounds = !((py > trunk_h + 4.f) || (td > 12.f));
  if (!in_bounds) return false;

  float ratio = (py - (-2.f)) / (trunk_h - (-2.f));
  bool sat = ratio >= 0.f && ratio <= 1.f;
  float trunk_r = 0.5f * ((F(1.3) + ratio) / pow_rt(F(0.73) + ratio, 4.f)) + 0.5f;
  trunk_r = trunk_r * (1.f + F(0.3) * simplex3((float)wx * F(0.15), (float)wy * F(0.15),
                                               (float)wz * F(0.15)) *
                                 smoothstep(F(0.55), F(0.15), ratio));
  bool wood = sat && td < trunk_r;

  bool leaves = jungle_leaves(px, py - trunk_h, pz, 2.f, 3.f, F(4.5), s[1]);
  float n_branches_f = 6.f + floorf(s[2] * 5.f);
  float branch_h = trunk_h - 1.f;
  float angle = s[3] * SDF_TWO_PI;
  float droop = rand1_from2((float)wx, (float)wz);
  int k = 4;
  for (int i = 0; i < 10; ++i) {
    bool live = (float)i < n_branches_f;
    branch_h = branch_h - (1.f + F(3.6) * s[k]);
    angle = angle + SDF_PI_OVER_TWO + s[k + 1] * SDF_PI;
    float blen = 4.f + F(1.5) * s[k + 2];
    float bex = cosf(angle) * blen;
    float bez = sinf(angle) * blen;
    float bey = F(2.2) + F(1.2) * s[k + 3];
    float shrink = 1.f - F(0.3) * (branch_h / trunk_h);
    bex = bex * shrink;
    bey = bey * shrink;
    bez = bez * shrink;
    bey = bey + branch_h;
    if (live) {
      Vec3 a = {0.f, branch_h, 0.f}, b = {bex, bey, bez};
      wood = wood || in_rasterized_line(fx, fy, fz, a, b);
      float lx = px - bex + F(0.3);
      float ly = py - bey + F(0.3);
      float lz = pz - bez + F(0.3);
      bool droop_mask = droop < F(0.2) && in_range_f(ly, fmaxf(droop * -10.f, -2.f), 0.f);
      if (droop_mask) ly = 0.f;
      leaves = leaves || jungle_leaves(lx, ly, lz, 2.f, F(2.5), 4.f, s[k + 4]);
    }
    k += 5;
  }
  leaves = leaves && !wood;
  block = wood ? BLOCK_CYPRESS_WOOD : BLOCK_CYPRESS_LEAVES;
  return wood || leaves;
}

SDF_FN bool feat_birch(const float* s, int fx, int fy, int fz, int& block) {
  float px = (float)fx, py = (float)fy, pz = (float)fz;
  int height = (int)floorf(F(6.2) + 4.f * s[0]);
  bool tall = s[1] < F(0.08);
  if (tall) height = (int)((float)height * F(1.9));
  bool in_bounds = imax(iabs(fx), iabs(fz)) <= 8 && in_range_i(fy, 0, height + 6);
  if (!in_bounds) return false;
  bool wood = fx == 0 && fz == 0 && in_range_i(fy, 0, height);

  float mult = tall ? F(1.5) : 1.f;
  float leaves_start = (float)height - (3.f - F(2.2) * s[2]) * mult;
  float leaves_end = (float)height + (F(4.2) + F(1.2) * s[3]) * mult;
  float ratio = (py - leaves_start) / (leaves_end - leaves_start);
  bool in_band = in_range_f(ratio, 0.f, 1.f);
  float x = pow_rt(clampf(ratio, 0.f, 1.f), F(0.8));
  float radius = 5.f * (0.5f * (x * x * x) - F(1.5) * (x * x) + x) * (F(2.8) + F(0.8) * s[4]);
  bool leaves = in_band && length2(px, pz) <= radius && !wood;

  float leaf_rand = s[5];
  int leaf_block = leaf_rand < F(0.1)   ? BLOCK_YELLOW_BIRCH_LEAVES
                   : leaf_rand < F(0.2) ? BLOCK_ORANGE_BIRCH_LEAVES
                                        : BLOCK_BIRCH_LEAVES;
  block = wood ? BLOCK_BIRCH_WOOD : leaf_block;
  return wood || leaves;
}

SDF_FN bool feat_pine(const float* s, int fx, int fy, int fz, int& block) {
  int height = (int)floorf(7.f + 4.f * s[0]);
  bool in_bounds = fy >= 0 && fy <= height + 4 && imax(iabs(fx), iabs(fz)) <= 6;
  if (!in_bounds) return false;
  bool wood = fx == 0 && fz == 0 && fy <= height;
  float py = (float)fy;
  float leaves_start = (float)height - 4.f - F(2.5) * s[1];
  float leaves_end = (float)height + 3.f;
  float ratio = (py - leaves_start) / (leaves_end - leaves_start);
  float radius = 3.f + (1.f - 3.f) * ratio;
  bool leaves = in_range_f(ratio, 0.f, 1.f) && length2((float)fx, (float)fz) < radius && !wood;
  block = wood ? BLOCK_PINE_WOOD : (s[2] < 0.5f ? BLOCK_PINE_LEAVES_1 : BLOCK_PINE_LEAVES_2);
  return wood || leaves;
}

SDF_FN bool feat_pine_shrub(const float* s, int fx, int fy, int fz, int& block) {
  int height = (int)floorf(2.f + 2.f * s[0]);
  bool in_bounds = fy >= 0 && fy <= height + 4 && imax(iabs(fx), iabs(fz)) <= 6;
  if (!in_bounds) return false;
  bool wood = fx == 0 && fz == 0 && fy <= height;
  bool leaves = jungle_leaves((float)fx, (float)fy - ((float)height - 1.f), (float)fz, F(2.5), F(1.5),
                              F(2.5), s[1]) && !wood;
  block = wood ? BLOCK_PINE_WOOD : (s[2] < 0.5f ? BLOCK_PINE_LEAVES_1 : BLOCK_PINE_LEAVES_2);
  return wood || leaves;
}

SDF_FN bool feat_medium_purple_mushroom(const float* s, int fx, int fy, int fz, int& block) {
  if (!(iabs(fx) + iabs(fz) <= 8)) return false;
  int height = (int)floorf(F(1.5) + F(2.3) * s[0]);
  bool wood = fx == 0 && fz == 0 && in_range_i(fy, 0, height);
  float radius = s[1] < 0.5f ? F(1.8) : F(2.5);
  bool cap = fy == height + 1 && length2((float)fx, (float)fz) < radius && !wood;
  block = wood ? BLOCK_MUSHROOM_STEM : BLOCK_PURPLE_MUSHROOM_CAP;
  return wood || cap;
}

SDF_FN bool feat_purple_mushroom(const float* s, int fx, int fy, int fz, int& block) {
  float universal = 1.f + s[0] * F(1.2);
  float px = (float)fx * universal, py = (float)fy * universal, pz = (float)fz * universal;
  if (s[1] < F(0.2)) {
    px = px * 0.5f;
    py = py * 0.5f;
    pz = pz * 0.5f;
  }
  float height = 25.f + s[2] * 30.f;
  float hd = length2(px, pz);
  bool far_cap = length3(px, py - height, pz) > 35.f;
  bool in_bounds = !((py < -1.f) || (py > height + 12.f) ||
                     ((hd > 8.f) && ((py < height - 12.f) || far_cap)));
  if (!in_bounds) return false;

  // 5 control points (draws 3..14, order z, y, x), spline of 7 points
  Vec3 ctrl[5];
  ctrl[0] = {0.f, 0.f, 0.f};
  int kk = 3;
  for (int i = 1; i < 5; ++i) {
    float sxz = i == 4 ? F(6.0 * 0.6) : 6.f;
    float sy = i == 4 ? F(2.0 * 0.6) : 2.f;
    float oz = (s[kk] * 2.f - 1.f) * sxz;
    float oy = (s[kk + 1] * 2.f - 1.f) * sy;
    float ox = (s[kk + 2] * 2.f - 1.f) * sxz;
    ctrl[i] = {ox, height * F(i / 4.0) + oy, oz};
    kk += 3;
  }
  Vec3 spline[7];
  for (int i = 0; i < 7; ++i) spline[i] = de_casteljau_point(ctrl, 5, F(i / 6.0));

  bool hit = false;
  block = 0;
  for (int i = 0; i < 7; ++i) {
    Vec3 a = spline[i], b;
    bool band = true;
    if (i < 6) {
      b = spline[i + 1];
      band = !((py < a.y - 3.f) || (py > b.y + 3.f));
    } else {
      Vec3 prev = spline[5];
      float dx_ = a.x - prev.x, dy_ = a.y - prev.y, dz_ = a.z - prev.z;
      float n = sqrtf(dx_ * dx_ + dy_ * dy_ + dz_ * dz_);
      if (n == 0.f) n = F(1e-9);
      float ext = 3.f + s[15] * F(1.5);
      b = {a.x + (dx_ / n) * ext, a.y + (dy_ / n) * ext, a.z + (dz_ / n) * ext};
    }
    float ratio, dist;
    bool in01;
    line_params(px, py, pz, a, b, ratio, dist, in01);
    float radius;
    int pot_block;
    if (i < 6) {
      float t = ((float)i + clampf(ratio, 0.f, 1.f)) / 6.f;
      float xq = t - 0.5f;
      radius = (4.f * xq * xq + F(1.5)) * F(1.2);
      pot_block = BLOCK_MUSHROOM_STEM;
    } else {
      // glm::mix does not clamp: height < 33 shrinks the cap below 0.8x
      radius = (7.f * s[16] + 12.f) * (F(0.8) + F(0.4) * ((height - 33.f) / 40.f));
      bool underside = dist < radius - F(1.8) && ratio < 0.5f && universal < F(1.4);
      pot_block = underside ? BLOCK_MUSHROOM_UNDERSIDE : BLOCK_PURPLE_MUSHROOM_CAP;
    }
    bool seg_hit = in01 && dist <= radius;
    if (i < 6) seg_hit = seg_hit || (ratio < 0.f && length3(px - a.x, py - a.y, pz - a.z) < radius);
    if (i < 5) seg_hit = seg_hit || (ratio > 1.f && length3(px - b.x, py - b.y, pz - b.z) < radius);
    seg_hit = seg_hit && band && !hit;
    if (seg_hit) block = pot_block;
    hit = hit || seg_hit;
  }
  return hit;
}

SDF_FN bool feat_rafflesia(const float* s, int fx, int fy, int fz, int& block) {
  float px = (float)fx, py = (float)fy, pz = (float)fz;
  bool in_bounds = !((py > 10.f) || (length3(px, py, pz) > 15.f));
  if (!in_bounds) return false;
  px = px * F(0.8);
  py = py * F(0.8);
  pz = pz * F(0.8);
  float cx = px, cy = (py - 1.f) * F(1.4), cz = pz;
  bool spikes = length3(cx, cy, cz) - 1.f < 0.f;

  float center_sdf = fabsf(length3(cx, cy - 1.f, cz) - 2.f) - F(0.8);
  float hole = length3(cx, cy - F(1.8), cz) - F(1.8);
  bool center = fmaxf(center_sdf, -hole) < 0.f;
  int center_block = cy > 1.f ? BLOCK_RAFFLESIA_CENTER : BLOCK_RAFFLESIA_STEM;

  bool petal_hit = false;
  float start_angle = s[0] * SDF_TWO_PI;
  const float step[5] = {F(0 * 6.283185307179586 * 0.2), F(1 * 6.283185307179586 * 0.2),
                         F(2 * 6.283185307179586 * 0.2), F(3 * 6.283185307179586 * 0.2),
                         F(4 * 6.283185307179586 * 0.2)};
  for (int i = 0; i < 5; ++i) {
    float ang = start_angle + step[i];
    float st = sinf(-ang);
    float ct = cosf(-ang);
    float ppx = px * ct + pz * st;
    float ppy = py - F(3.2);
    float ppz = -px * st + pz * ct;
    ppy = ppy - ((i & 1) ? F(0.53) : 0.f);
    ppy = ppy + clampf((fabsf(ppx - 3.f) - F(1.5)) / F(1.5), 0.f, 1.f) * F(1.3);
    ppx = ppx - F(3.8);
    ppz = ppz * F(1.2);
    // sdCappedCylinder(p, r = 2.5, h = 0.5)
    float dlx = fabsf(length2(ppx, ppz)) - F(2.5);
    float dly = fabsf(ppy) - 0.5f;
    float sd = fminf(fmaxf(dlx, dly), 0.f) + length2(fmaxf(dlx, 0.f), fmaxf(dly, 0.f));
    petal_hit = petal_hit || sd < 0.f;
  }

  bool hit1 = spikes;
  bool hit2 = center && !hit1;
  bool hit3 = petal_hit && !hit1 && !hit2;
  block = hit1 ? BLOCK_RAFFLESIA_SPIKES : (hit2 ? center_block : BLOCK_RAFFLESIA_PETAL);
  return hit1 || hit2 || hit3;
}

SDF_FN bool feat_large_jungle(const float* s, int fx, int fy, int fz, uint32_t brng, int& block) {
  float px = (float)fx, py = (float)fy, pz = (float)fz;
  float height = 18.f + 10.f * s[0];
  bool in_bounds = !((py > height + 6.f) || (length2(px, pz) > 15.f));
  if (!in_bounds) return false;
  bool trunk = in_range_f(py, 0.f, height) && fx >= 0 && fx <= 1 && fz >= 0 && fz <= 1;

  float qx = px - 0.5f;
  float qz = pz - 0.5f;
  bool top_leaf = jungle_leaves(qx, py - (height - 2.f), qz, 4.f, 4.f, 7.f, s[1]);
  float r_top = brng_draw(brng, top_leaf && !trunk);
  int leaf_block = r_top < 0.5f ? BLOCK_JUNGLE_LEAVES_FRUITS : BLOCK_JUNGLE_LEAVES_PLAIN;

  float num_branches = 0.5f + F(2.5) * s[2];
  float branch_h = height;
  bool wood = trunk;
  bool leaves = top_leaf;
  int k = 3;
  for (int i = 0; i < 3; ++i) {
    bool live = (float)i < num_branches;
    branch_h = branch_h - (8.f + s[k] * 3.f) * (height / 30.f);
    float ang = SDF_TWO_PI * s[k + 1];
    float bex = cosf(-ang) * (3.f + F(1.5) * s[k + 2]);
    float bez = sinf(-ang) * (3.f + F(1.5) * s[k + 2]);
    float bey = branch_h + 1.f + F(1.5) * s[k + 3];
    float ratio, dist;
    bool in01;
    Vec3 a = {0.f, branch_h, 0.f}, b = {bex, bey, bez};
    line_params(qx, py, qz, a, b, ratio, dist, in01);
    float br = F(1.2) - F(0.4) * ratio;
    wood = wood || (live && in01 && dist < br);
    bool bl = jungle_leaves(qx - bex, py - bey + F(0.2), qz - bez, 2.f, F(2.5), F(3.5), s[k + 4]);
    bool new_leaf = live && bl && !leaves;
    float r_b = brng_draw(brng, new_leaf && !wood);
    if (new_leaf) leaf_block = r_b < 0.25f ? BLOCK_JUNGLE_LEAVES_FRUITS : BLOCK_JUNGLE_LEAVES_PLAIN;
    leaves = leaves || new_leaf;
    k += 5;
  }
  leaves = leaves && !wood;
  block = wood ? BLOCK_JUNGLE_WOOD : leaf_block;
  return wood || leaves;
}

SDF_FN bool feat_small_jungle(const float* s, int fx, int fy, int fz, uint32_t brng, int& block) {
  float px = (float)fx, py = (float)fy, pz = (float)fz;
  float height = 8.f + 4.f * s[0];
  float max_dist = py < height - 2.f ? 2.f : 8.f;
  bool in_bounds = !((py > height + 4.f) || (length2(px, pz) > max_dist));
  if (!in_bounds) return false;
  bool wood = in_range_f(py, 0.f, height) && fx == 0 && fz == 0;
  bool lv = jungle_leaves(px, py - (height - 1.f), pz, 3.f, 2.f, 4.f, s[1]) && !wood;
  float r = brng_draw(brng, lv);
  int leaf_block = r < 0.25f ? BLOCK_JUNGLE_LEAVES_FRUITS : BLOCK_JUNGLE_LEAVES_PLAIN;
  block = wood ? BLOCK_JUNGLE_WOOD : leaf_block;
  return wood || lv;
}

SDF_FN bool feat_tiny_jungle(const float* s, int fx, int fy, int fz, int& block) {
  if (!((fx + fy + fz) <= 8)) return false;
  int height = (int)floorf(0.5f + F(2.5) * s[0]);
  bool wood = fx == 0 && fz == 0 && in_range_i(fy, 0, height);
  int manh = iabs(fx) + iabs(fy - height) + iabs(fz);
  bool leaf = manh == 1 && !wood;
  block = wood ? BLOCK_JUNGLE_WOOD : BLOCK_JUNGLE_LEAVES_PLAIN;
  return wood || leaf;
}

SDF_FN bool feat_cactus(const float* s, int fx, int fy, int fz, int& block) {
  int height = (int)floorf(F(7.5) + s[0] * 6.f);
  bool in_bounds = iabs(fx) <= 5 && iabs(fz) <= 5 && (float)fy <= (float)height + 2.f;
  if (!in_bounds) return false;
  bool hit = fx == 0 && fz == 0 && in_range_i(fy, 0, height);
  int k = 1;
  for (int arm = 0; arm < 4; ++arm) {
    bool has_arm = s[k] < F(0.35);
    int a_start = (int)floorf(4.f + s[k + 1] * ((float)height - 10.f));
    int a_len = (int)floorf(2.f + s[k + 2] * 1.f);
    int a_h = (int)floorf(3.f + s[k + 3] * 3.f);
    a_h = imin(height - a_start - 1, a_h);
    int p2x = DIR_VECS_2D[arm * 2][0] * a_len, p2z = DIR_VECS_2D[arm * 2][1] * a_len;
    bool seg1 = in_range_i(fx, imin(0, p2x), imax(0, p2x)) &&
                in_range_i(fz, imin(0, p2z), imax(0, p2z)) && fy == a_start;
    bool seg2 = fx == p2x && fz == p2z && in_range_i(fy, a_start, a_start + a_h);
    hit = hit || (has_arm && (seg1 || seg2));
    k += 4;
  }
  block = BLOCK_CACTUS;
  return hit;
}

SDF_FN bool feat_palm(const float* s, int fx, int fy, int fz, int& block) {
  bool in_bounds = !((fy < -2) || (fy > 28) || ((iabs(fx) + iabs(fz)) > 24));
  if (!in_bounds) return false;
  float px = (float)fx, py = (float)fy, pz = (float)fz;

  // 4 control points random walk (draws 0..8, order z, y, x)
  Vec3 ctrl[4];
  ctrl[0] = {0.f, 0.f, 0.f};
  float cx = 0.f, cy = 0.f, cz = 0.f;
  int k = 0;
  for (int i = 1; i < 4; ++i) {
    float walk = F(1.0 + (i / 4.0) * 5.0);
    cz = cz + walk * (s[k] * 2.f - 1.f);
    cy = cy + 3.f + 5.f * s[k + 1];
    cx = cx + walk * (s[k + 2] * 2.f - 1.f);
    ctrl[i] = {cx, cy, cz};
    k += 3;
  }
  float lo_x = fminf(fminf(0.f, ctrl[1].x), fminf(ctrl[2].x, ctrl[3].x));
  float hi_x = fmaxf(fmaxf(0.f, ctrl[1].x), fmaxf(ctrl[2].x, ctrl[3].x));
  float lo_y = fminf(fminf(0.f, ctrl[1].y), fminf(ctrl[2].y, ctrl[3].y));
  float hi_y = fmaxf(fmaxf(0.f, ctrl[1].y), fmaxf(ctrl[2].y, ctrl[3].y));
  float lo_z = fminf(fminf(0.f, ctrl[1].z), fminf(ctrl[2].z, ctrl[3].z));
  float hi_z = fmaxf(fmaxf(0.f, ctrl[1].z), fmaxf(ctrl[2].z, ctrl[3].z));
  bool in_box = px >= lo_x - 7.f && px <= hi_x + 7.f && py >= lo_y - 1.f && py <= hi_y + 6.f &&
                pz >= lo_z - 7.f && pz <= hi_z + 7.f;
  if (!in_box) return false;

  Vec3 spline[5];
  for (int i = 0; i < 5; ++i) spline[i] = de_casteljau_point(ctrl, 4, F(i / 4.0));
  int tx = (int)floorf(spline[4].x);
  int ty = (int)floorf(spline[4].y);
  int tz = (int)floorf(spline[4].z);
  int lx = fx - tx, ly = fy - ty, lz = fz - tz;
  float ld = length2((float)lx, (float)lz);
  ld = ld * (F(0.6) + F(0.3) * clampf((20.f - (float)ty) * F(0.05), 0.f, 1.f) + F(0.3) * s[9]);
  bool on_spoke = lx == 0 || lz == 0 || iabs(lx) == iabs(lz);
  int leaf_h = ld > 3.f ? -1 : 0;
  bool leaves = in_range_i(ly, -1, 0) && ld < F(3.9) && on_spoke && ly == leaf_h;

  bool wood = false;
  for (int i = 0; i < 4; ++i) {
    Vec3 a = spline[i], b = spline[i + 1];
    float ddx = b.x - a.x, ddy = b.y - a.y, ddz = b.z - a.z;
    float n = sqrtf(ddx * ddx + ddy * ddy + ddz * ddz);
    if (n == 0.f) n = F(1e-9);
    float padx = (ddx / n) * 0.5f, pady = (ddy / n) * 0.5f, padz = (ddz / n) * 0.5f;
    if (i > 0) a = {a.x - padx, a.y - pady, a.z - padz};
    if (i + 1 < 4) b = {b.x + padx, b.y + pady, b.z + padz};
    wood = wood || in_rasterized_line(fx, fy, fz, a, b);
  }
  wood = wood && !leaves;
  block = leaves ? BLOCK_PALM_LEAVES : BLOCK_PALM_WOOD;
  return wood || leaves;
}

SDF_FN bool feat_crystal(const float* s, int fx, int fy, int fz, Placement p, bool medium,
                         int& block) {
  if (!(p.y <= 180) || !(imax(iabs(fx), iabs(fz)) <= 25)) return false;
  float scale = F(0.55) + F(0.4) * s[0];
  if (medium) scale = scale * 2.f;
  float px = (float)fx * scale;
  float py = ((float)fy + 2.f) * scale;
  float pz = (float)fz * scale;

  // draw order z, y, x
  float cez = 12.f * (s[1] * 2.f - 1.f);
  float cey = 18.f + 8.f * s[2];
  float cex = 12.f * (s[3] * 2.f - 1.f);
  if (!(py <= cey + 2.f)) return false;
  block = random_crystal_block(s[4]);

  Vec3 zero = {0.f, 0.f, 0.f}, ce = {cex, cey, cez};
  bool hit = in_crystal(px, py, pz, zero, ce, 4.f + F(1.2) * s[5]);

  float qx = px * F(0.8), qy = py * F(0.8), qz = pz * F(0.8);
  float nsc = 4.f + 2.f * s[6];
  float ang = s[7] * SDF_TWO_PI;
  int k = 8;
  for (int i = 0; i < 6; ++i) {
    bool live = (float)i < nsc;
    ang = ang + SDF_PI_OVER_TWO + SDF_PI * s[k];
    float ex = cosf(ang) * (6.f + 3.f * s[k + 1]);
    float ez = sinf(ang) * (6.f + 3.f * s[k + 1]);
    float ey = 7.f + 5.f * s[k + 2];
    Vec3 e = {ex, ey, ez};
    hit = hit || (live && in_crystal(qx, qy, qz, zero, e, F(1.5) + F(1.5) * s[k + 3]));
    k += 4;
  }
  return hit;
}

// ---------------------------------------------------------------------------
// cave features; h is the cave layer's height
// ---------------------------------------------------------------------------

SDF_FN bool cave_test_pillar(int fx, int fy, int fz, int h) {
  return fx == 0 && fz == 0 && in_range_i(fy, 0, h);
}

SDF_FN bool cave_vine(const float* s, int fx, int fy, int fz, uint32_t brng, int h, int& block) {
  int ty = fy - h;  // floorTopPos.y
  int height = (int)floorf(3.f + 12.f * s[0]);
  height = imin(height, h);
  bool on_col = fx == 0 && fz == 0 && in_range_i(ty, -height, 0);
  bool glowing = brng_draw(brng, on_col) < F(0.2);
  block = ty == -height ? (glowing ? BLOCK_CAVE_VINES_GLOW_END : BLOCK_CAVE_VINES_END)
                        : (glowing ? BLOCK_CAVE_VINES_GLOW_MAIN : BLOCK_CAVE_VINES_MAIN);
  return on_col;
}

SDF_FN bool cave_glowstone_cluster(const float* s, int fx, int fy, int fz, int wy, int h, int& block) {
  float px = (float)fx, pz = (float)fz;
  float tyf = ((float)fy - (float)h) * F(1.35);
  float sc = 1.f + 0.5f * s[0];
  float tx = px * sc, ty2 = tyf * sc, tz = pz * sc;
  float radius = length3(tx, ty2, tz);
  block = BLOCK_GLOWSTONE;
  if (!(radius <= 6.f)) return false;
  float xz_angle = atan2f(pz, px);
  float max_r = F(3.5) + 2.f * simplex2(xz_angle * F(1.5), (float)wy * F(1.5));
  return radius < max_r;
}

SDF_FN bool cave_stormlight(const float* s, int fx, int fy, int fz, uint32_t brng, int h,
                            bool ceiling, int& block) {
  float radius = F(3.5) + 4.f * s[0];
  float dist = length3((float)fx, ceiling ? (float)fy - (float)h : (float)fy, (float)fz);
  bool inside = dist <= radius;
  float light_chance = smoothstep(F(0.4), F(0.2), dist / radius);
  float r = brng_draw(brng, inside);
  block = r < light_chance ? BLOCK_GLOWSTONE : random_crystal_block(s[1]);
  return inside;
}

SDF_FN bool cave_crystal_pillar(const float* s, int fx, int fy, int fz, int layer_h, int& block) {
  float h = (float)layer_h;
  float py = (float)fy;
  float ty = py - h;
  float d2 = length2((float)fx, (float)fz);
  bool in_bounds = !((py < -8.f) || (ty > 8.f)) && d2 <= 7.f;
  if (!in_bounds) return false;
  float hr = py / (h == 0.f ? F(1e-9) : h);
  float dist = hr < 0.f ? length3((float)fx, py, (float)fz)
                        : (hr > 1.f ? length3((float)fx, ty, (float)fz) : d2);
  hr = clampf(hr, 0.f, 1.f);
  float radius = hr - 0.5f;
  radius = 4.f * (2.f * radius * radius + 0.5f);
  float ratio = dist / radius;
  block = ratio < F(0.4) ? BLOCK_GLOWSTONE : random_crystal_block(s[0]);
  return dist <= radius;
}

SDF_FN bool cave_warped_fungus(const float* s, int fx, int fy, int fz, int wx, int wz, uint32_t brng,
                               Placement p, int& block) {
  int manh = iabs(fx) + iabs(fz);
  int height = (int)floorf(F(2.5) + 3.f * s[0]);
  bool in_bounds = manh <= 6 && !((fy < -2) || (fy > height + 3));
  if (!in_bounds) return false;
  bool stem = fx == 0 && fz == 0 && in_range_i(fy, 0, height);

  int sh = fy - (height - 1);
  bool shroom_zone = in_range_i(sh, 0, 1) && manh == 1 && !stem;
  float r = brng_draw(brng, shroom_zone);
  float chance = sh == 0 ? F(0.2) : 0.5f;
  bool shroom = shroom_zone && r < chance;

  float cap_r = length2((float)fx, (float)fz);
  bool cap_ok = cap_r <= F(3.7);
  int cap_end = height + 1 - (int)(cap_r / F(2.5));
  float cap_start = (float)cap_end -
                    (F(4.2) * simplex2(((float)wx + (float)p.y) * 3.f, ((float)wz + (float)p.y) * 3.f) *
                     fmaxf(cap_r - F(2.3), 0.f));
  bool cap = cap_ok && (float)fy >= floorf(cap_start) && fy <= cap_end;

  bool h1 = stem;
  bool h2 = shroom && !h1;
  bool h3 = cap && !h1 && !h2;
  block = h1 ? BLOCK_WARPED_STEM : (h2 ? BLOCK_SHROOMLIGHT : BLOCK_WARPED_WART);
  return h1 || h2 || h3;
}

SDF_FN bool cave_amber_fungus(const float* s, int fx, int fy, int fz, int wx, int wy, int wz,
                              uint32_t brng, int& block) {
  int manh = iabs(fx) + iabs(fz);
  int height = (int)floorf(F(4.5) + F(4.5) * s[0]);
  bool in_bounds = manh <= 4 && !((fy < -2) || (fy > height + 3));
  if (!in_bounds) return false;
  bool stem = fx == 0 && fz == 0 && in_range_i(fy, 0, height);
  bool wart_top = fx == 0 && fz == 0 && fy == height + 1;

  int cap_start = height / 2;  // height >= 4: floor and truncating division agree
  cap_start = cap_start - (simplex2((float)wx, (float)wz) < 0.f ? 1 : 0);
  bool in_cap = in_range_i(fy, cap_start, height);
  int cap_manh = (fy - cap_start) < (height / 4 + 1) ? 2 : 1;
  bool on_ring = in_cap && manh == cap_manh;
  // shroomlight on a jittered 2-grid; (worldBlockPos / 2) * 2 is C division, which
  // truncates toward zero for negative coordinates
  int gx = (wx / 2) * 2, gy = (wy / 2) * 2, gz = (wz / 2) * 2;
  float r0, r1, r2;
  rand3_from3((float)gx, (float)gy, (float)gz, r0, r1, r2);
  int sx = gx + (int)floorf(r0 * 2.f);
  int sy = gy + (int)floorf(r1 * 2.f);
  int sz = gz + (int)floorf(r2 * 2.f);
  bool at_grid = wx == sx && wy == sy && wz == sz;
  float r = brng_draw(brng, on_ring && at_grid);
  bool shroom = on_ring && at_grid && r < F(0.65);

  bool h1 = stem || wart_top;
  bool h2 = on_ring && !h1;
  block = stem ? BLOCK_AMBER_STEM : ((shroom && h2) ? BLOCK_SHROOMLIGHT : BLOCK_AMBER_WART);
  return h1 || h2;
}

// ---------------------------------------------------------------------------
// registries: feature id -> feature function
// ---------------------------------------------------------------------------

MMT_FN bool surface_feature_hit(int feat, const float* s, int fx, int fy, int fz, int wx, int wy,
                                int wz, uint32_t brng, Placement p, int& block) {
  switch (feat) {
    case FEAT_SPHERE: return feat_sphere(fx, fy, fz, block);
    case FEAT_CORAL: return feat_coral(s, fx, fy, fz, wx, wy, wz, p, block);
    case FEAT_KELP: return feat_kelp(s, fx, fy, fz, p, block);
    case FEAT_ICEBERG: return feat_iceberg(s, fx, fz, wx, wy, wz, p, block);
    case FEAT_ACACIA_TREE: return feat_acacia(s, fx, fy, fz, block);
    case FEAT_REDWOOD_TREE: return feat_redwood(s, fx, fy, fz, wx, wy, wz, p, block);
    case FEAT_CYPRESS_TREE: return feat_cypress(s, fx, fy, fz, wx, wy, wz, block);
    case FEAT_BIRCH_TREE: return feat_birch(s, fx, fy, fz, block);
    case FEAT_PINE_TREE: return feat_pine(s, fx, fy, fz, block);
    case FEAT_PINE_SHRUB: return feat_pine_shrub(s, fx, fy, fz, block);
    case FEAT_RAFFLESIA: return feat_rafflesia(s, fx, fy, fz, block);
    case FEAT_LARGE_JUNGLE_TREE: return feat_large_jungle(s, fx, fy, fz, brng, block);
    case FEAT_SMALL_JUNGLE_TREE: return feat_small_jungle(s, fx, fy, fz, brng, block);
    case FEAT_TINY_JUNGLE_TREE: return feat_tiny_jungle(s, fx, fy, fz, block);
    case FEAT_MEDIUM_PURPLE_MUSHROOM: return feat_medium_purple_mushroom(s, fx, fy, fz, block);
    case FEAT_PURPLE_MUSHROOM: return feat_purple_mushroom(s, fx, fy, fz, block);
    case FEAT_MEDIUM_CRYSTAL: return feat_crystal(s, fx, fy, fz, p, true, block);
    case FEAT_CRYSTAL: return feat_crystal(s, fx, fy, fz, p, false, block);
    case FEAT_PALM_TREE: return feat_palm(s, fx, fy, fz, block);
    case FEAT_CACTUS: return feat_cactus(s, fx, fy, fz, block);
    default: return false;
  }
}

MMT_FN bool cave_feature_hit(int feat, const float* s, int fx, int fy, int fz, int wx, int wy, int wz,
                             uint32_t brng, Placement p, int h, int& block) {
  switch (feat) {
    case CAVEFEAT_TEST_GLOWSTONE_PILLAR:
      block = BLOCK_GLOWSTONE;
      return cave_test_pillar(fx, fy, fz, h);
    case CAVEFEAT_TEST_SHROOMLIGHT_PILLAR:
      block = BLOCK_SHROOMLIGHT;
      return cave_test_pillar(fx, fy, fz, h);
    case CAVEFEAT_CAVE_VINE: return cave_vine(s, fx, fy, fz, brng, h, block);
    case CAVEFEAT_GLOWSTONE_CLUSTER: return cave_glowstone_cluster(s, fx, fy, fz, wy, h, block);
    case CAVEFEAT_STORMLIGHT_SPHERE: return cave_stormlight(s, fx, fy, fz, brng, h, false, block);
    case CAVEFEAT_CEILING_STORMLIGHT_SPHERE: return cave_stormlight(s, fx, fy, fz, brng, h, true, block);
    case CAVEFEAT_CRYSTAL_PILLAR: return cave_crystal_pillar(s, fx, fy, fz, h, block);
    case CAVEFEAT_WARPED_FUNGUS: return cave_warped_fungus(s, fx, fy, fz, wx, wz, brng, p, block);
    case CAVEFEAT_AMBER_FUNGUS: return cave_amber_fungus(s, fx, fy, fz, wx, wy, wz, brng, block);
    default: return false;
  }
}

}  // namespace mmt
