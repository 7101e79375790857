// K10: the scene fields of the brickmap (packed fine and macro words), seven launches
// behind one C entry point; K10u (mmt_update_chunks): the streamed update, seven launches.
//
// K10 replaces mega_minecraft_tpu/render/brickmap.py:280,288 blocks_to_field /
// _build_fields (with _encode:211, _encode_macro:242, chebyshev_distance:140,
// _up_clearance:157, _slab_clearance:165, _skyline_descent:197), jitted XLA on the TPU.
// K10u replaces brickmap.py:325,377 _update_chunk_field / update_chunks with
// app/engine.py:31 _assemble_region folded into its first kernel.
//
// The output is integer and must equal the JAX program's bit for bit.  Its distance
// transform (chebyshev_distance) is not the exact capped L∞ distance: a doubling round
// with offset s takes the min over the points {-s, 0, s}^3 (not the whole cube) and adds s,
// so a voxel gets the cheapest sum of distinct powers of two whose offsets reach a solid
// through points inside the volume.  JAX takes a round's shifted mins along z, x and y in
// turn, a neighbour outside the volume counting as the cap; the volume is a box and no
// value exceeds the cap, so the three compose to the min over the in-volume points of
// {-s, 0, s}^3, which a round here takes in one pass.  The three horizontal clearances
// (nearest solid at or above y, in [y-2, y], in [y-8, y]) are the same rounds over the 9
// points {-s, 0, s}^2 of their y slice.  No byte overflows: a value is at most 63 + 32.
//
// Design.  A level's state is four u8 channels of every voxel (the 3-D distance and the
// three clearances), interleaved by 4-voxel words: the uint4 of word w of a column holds
// the four channels of voxels y = 4w..4w+3, one byte a voxel, so one byte-wise min takes
// four voxels' minima, a horizontal neighbour is one 16-byte load and the 3-D distance's y
// neighbours are its channel shifted by s bytes (a funnel shift of two words for s = 1, 2,
// the word s/4 away for s >= 4).
//   1. prep: a warp per column reads its voxels once (K10: the block ids; K10u: the old
//      words or the region's blocks from the slot table), stages the column's solid bytes
//      in shared memory, takes the column top (a warp max) and writes the rounds' seeds
//      (0 in the set, else the cap or K10u's old bound).  K10: a CTA is one 4x4 group of
//      columns, and its any-solid cells make the macro column's seeds in the same CTA;
//      K10u: the macro cells outside the region keep their old solidity (an old macro
//      word's low byte is 0 exactly when its cell is solid), inside it the region's blocks
//      give it.
//   2. rounds s = 1 .. 16: one launch each for both levels (the first also takes the
//      skyline's 17x17 max of the column tops), ping-pong between two state buffers.  A CTA
//      takes a tile of one class of columns (z mod s, x mod s) and takes the min in three
//      separable passes through shared memory (below).
//   3. encode: the round s = 32 on the same tiles and the packed words, 16 bytes a thread
//      (K10u: into the window's place in the scene, the old words read by the thread that
//      rewrites them).
// Launches: 7 a call for K10 and for K10u (mmt_scene_launches returns the last call's);
// the count by name is one a call.  Scratch: two state buffers (8 B a voxel of each level)
// and the column tops and skylines.
//
// What bounds it on the H100 (80GB HBM3, 700 W; tools/kernel_ab.py's device spans at
// 33x33): not device memory (a round moves the state once, 8 B a voxel, at ~1.3 TB/s) but
// the integer pipe and latency.  A byte min costs five or six integer instructions
// (__vminu4 compiles to six on sm_90a, the SWAR compare below to five) at half the f32
// instruction rate, so the tiles take the 27-point min as separable y, x and z passes: 26 byte
// mins a word, against 58 for a thread that reads its word's 27 neighbours itself (0.84-1.02
// ms a round that way, 0.65-0.78 ms this way).  Small CTAs hide latency best: 6x6 columns
// and 8 words (288 threads, 32 registers, 7 CTAs an SM) beat 16 words (576 threads, 3 an SM)
// by 5% and 4 words by 13%.
//
// Bound on the H100: K10 by operations (chip_smoke.py's K10_VOXEL_OPS a voxel at the f32
// rate: 0.0277 ms for the 10x10 scene, 0.302 ms at 33x33; the bytes, the u8 volume read
// and the i32 words written once, come to 49 / 535 MB).  About 62 B a voxel move through
// device memory in all.  K10u by operations too (K10's per window voxel and per macro
// cell); its bytes are the window's words read and written, the region's blocks and the
// old macro words read and the new ones written.

#include <stdint.h>

#include "mmt_math.cuh"
#include "mmt_render_tables.h"

namespace {

constexpr uint32_t CAP4 = DIST_CAP * 0x01010101u;
constexpr int MAX_Y = 512;       // the tallest level taken (a column's solid bytes in shared memory)
constexpr int MAX_W = MAX_Y / 4;
constexpr int KW = MAX_W / 32;   // a lane's words of a column, at most
constexpr int PREP_WARPS = 16;   // a prep CTA: 16 columns (K10: a 4x4 group)

int g_launches = 0;  // kernel launches of the last call

__device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }
__device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }
// the byte-wise min of two words whose bytes are all below 128 (a state byte is at most
// 63 + 32): a SWAR compare in five integer instructions (a + 0x80 - b never leaves its byte),
// where __vminu4 compiles to six
__device__ __forceinline__ uint32_t vmin(uint32_t a, uint32_t b) {
  uint32_t g = (a + 0x80808080u - b) & 0x80808080u;  // 0x80 in the bytes where a >= b
  uint32_t m = g - (g >> 7);                         // 0x7F there
  return (b & m) | (a & ~m);
}
__device__ __forceinline__ uint32_t byte_of(uint32_t v, int j) { return (v >> (8 * j)) & 0xFFu; }

// the region of K10u: gz x gx chunks at fine scene offset (z0, x0), chunk c = slot[c] of
// the slot table (-1: air)
struct Region {
  int slot[MAX_REGION_CHUNKS];
  int gz, gx, z0, x0;
};

// where a level's voxels come from
struct Src {
  const uint8_t* vol;     // K10's fine level: [Z, X, Y] block ids
  const int32_t* words;   // K10u: the scene's old words of this level
  const uint8_t* blocks;  // K10u: the slot table [C, 16, 16, Y_fine] ([z, x, y])
  int sX, z0, x0;         // the x extent of the scene level the words lie in; the level's corner in it
  Region rg;
};

// a level [Z, X, Y] (Y a multiple of 4, at most MAX_Y) and where its words go
struct Level {
  int Z, X, Y;
  uint4* a;
  uint4* b;  // the two state buffers [Z * X * Y / 4]
  int* top;
  int* sky;  // [Z * X]
  int32_t* dst;
  int dX, dz0, dx0;  // the words: the destination volume's x extent and the level's corner in it
  int macro;         // the macro level: solid cells encode 0, no alpha, no seeds
  Src src;
};

// a block id -> 1 if it renders solid, else 0 (ids past the table are not solid)
__device__ __forceinline__ uint32_t is_solid_id(uint32_t b) { return b < EMPTY_BASE ? RENDER_SOLID_TAB[b] : 0u; }

// four block ids -> their solid bytes (1 / 0)
__device__ __forceinline__ uint32_t solid_bytes(uint32_t v) {
  uint32_t s = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) s |= is_solid_id(byte_of(v, j)) << (8 * j);
  return s;
}

__device__ __forceinline__ bool in_region(const Region& rg, int sz, int sx) {
  int rz = sz - rg.z0, rx = sx - rg.x0;
  return rz >= 0 && rz < rg.gz * 16 && rx >= 0 && rx < rg.gx * 16;
}

// the four block ids at y = 4w..4w+3 of the region's column at fine scene (sz, sx)
__device__ __forceinline__ uint32_t region_ids4(const Src& S, int Y, int sz, int sx, int w) {
  int rz = sz - S.rg.z0, rx = sx - S.rg.x0;
  int s = S.rg.slot[(rz >> 4) * S.rg.gx + (rx >> 4)];
  if (s < 0) return 0u;
  return *reinterpret_cast<const uint32_t*>(S.blocks + (((long long)s * 16 + (rz & 15)) * 16 + (rx & 15)) * Y + 4 * w);
}

// voxels y = 4w..4w+3 of fine column (z, x) of a level: their block ids (K10u outside its
// region: the old low bytes, which are the solids' ids and empty codes >= EMPTY_BASE);
// returns true there, with the old words in ``old``
__device__ __forceinline__ bool src4(const Level& L, int z, int x, int w, uint32_t& ids, uint4& old) {
  const Src& S = L.src;
  if (S.vol) {
    ids = *reinterpret_cast<const uint32_t*>(S.vol + ((long long)z * L.X + x) * L.Y + 4 * w);
    return false;
  }
  int sz = S.z0 + z, sx = S.x0 + x;
  if (in_region(S.rg, sz, sx)) {
    ids = region_ids4(S, L.Y, sz, sx, w);
    return false;
  }
  old = *reinterpret_cast<const uint4*>(S.words + ((long long)sz * S.sX + sx) * L.Y + 4 * w);
  ids = (old.x & 0xFF) | (old.y & 0xFF) << 8 | (old.z & 0xFF) << 16 | (old.w & 0xFF) << 24;
  return true;
}

// the prep's view of voxels y = 4w..4w+3: their solid bytes (1 / 0) and the rounds' seeds
// (channels as the state: K10u's old bounds outside its region, else the cap)
__device__ __forceinline__ uint32_t prep4(const Level& L, int z, int x, int w, uint4& seed) {
  uint32_t ids, sol = 0;
  uint4 o;
  seed = make_uint4(CAP4, CAP4, CAP4, CAP4);
  if (!src4(L, z, x, w, ids, o)) return solid_bytes(ids);
  const uint32_t ow[4] = {o.x, o.y, o.z, o.w};
  uint32_t d = 0, u = 0, c2 = 0, c8 = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    int low = (int)(ow[j] & 0xFF);
    sol |= (uint32_t)(low > 0 && low < EMPTY_BASE) << (8 * j);
    d |= (uint32_t)imin(imax(low - (EMPTY_BASE - 1), 1), DIST_CAP) << (8 * j);
    u |= ((ow[j] >> 8) & 0x3F) << (8 * j);
    c2 |= ((ow[j] >> 14) & 0x3F) << (8 * j);
    c8 |= ((ow[j] >> 20) & 0x3F) << (8 * j);
  }
  seed = make_uint4(d, u, c2, c8);
  return sol;
}

// a word of solid bytes (1 / 0) -> its 4 bits
__device__ __forceinline__ uint32_t bits4(uint32_t b) { return (b | b >> 7 | b >> 14 | b >> 21) & 0xFu; }

// one column's seeds (warp-wide; every lane of the warp calls it): the lane's words
// w = lane + 32 k with their solid bytes sol[k] and old bounds seed[k]; colw: the warp's
// shared words (2 + MAX_W), the column's solid bytes after two words of air (y = -8..-1)
template <int K>
__device__ void seed_column(const Level& L, long long c, int lane, uint32_t* colw, const uint32_t (&sol)[K],
                            const uint4 (&seed)[K]) {
  int W = L.Y >> 2, top = -1;
  if (lane < 2) colw[lane] = 0u;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    int w = lane + 32 * k;
    if (w < W) {
      colw[2 + w] = sol[k];
      if (sol[k]) top = 4 * w + ((31 - __clz(sol[k])) >> 3);
    }
  }
  top = __reduce_max_sync(0xFFFFFFFFu, top);
  __syncwarp();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    int w = lane + 32 * k;
    if (w >= W) continue;
    // bit t: solid at y = 4w - 8 + t
    uint32_t m12 = bits4(colw[w]) | bits4(colw[w + 1]) << 4 | bits4(colw[w + 2]) << 8;
    uint32_t d = 0, u = 0, c2 = 0, c8 = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int sh = 8 * j;
      if (!((m12 >> (8 + j)) & 1u)) d |= byte_of(seed[k].x, j) << sh;
      if (4 * w + j > top) u |= byte_of(seed[k].y, j) << sh;
      if (!((m12 >> (6 + j)) & 0x7u)) c2 |= byte_of(seed[k].z, j) << sh;
      if (!((m12 >> j) & 0x1FFu)) c8 |= byte_of(seed[k].w, j) << sh;
    }
    L.a[c * W + w] = make_uint4(d, u, c2, c8);
  }
  if (lane == 0) L.top[c] = top;
}

// K10's prep: a CTA per 4x4 group of fine columns (warp k: column (4 zm + k / 4, 4 xm + k % 4)),
// then warp 0 seeds the group's macro column from the group's any-solid cells
__global__ void __launch_bounds__(PREP_WARPS * 32) scene_prep_kernel(Level F, Level M) {
  __shared__ uint32_t colw[PREP_WARPS][2 + MAX_W];
  __shared__ uint8_t anyw[PREP_WARPS][MAX_W];
  int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int zm = blockIdx.x / M.X, xm = blockIdx.x % M.X;
  int z = 4 * zm + (warp >> 2), x = 4 * xm + (warp & 3);
  int W = F.Y >> 2;
  uint32_t sol[KW];
  uint4 seed[KW];
#pragma unroll
  for (int k = 0; k < KW; ++k) {
    int w = lane + 32 * k;
    sol[k] = 0;
    seed[k] = make_uint4(CAP4, CAP4, CAP4, CAP4);
    if (w < W) {
      sol[k] = prep4(F, z, x, w, seed[k]);
      anyw[warp][w] = sol[k] != 0;
    }
  }
  seed_column<KW>(F, (long long)z * F.X + x, lane, colw[warp], sol, seed);
  __syncthreads();
  if (warp != 0) return;
  uint32_t msol[1] = {0};
  const uint4 mseed[1] = {make_uint4(CAP4, CAP4, CAP4, CAP4)};
  if (lane < (M.Y >> 2)) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t any = 0;
      for (int k = 0; k < PREP_WARPS; ++k) any |= anyw[k][4 * lane + j];
      msol[0] |= any << (8 * j);
    }
  }
  seed_column<1>(M, blockIdx.x, lane, colw[0], msol, mseed);
}

// K10u's macro cells y = 4wm..4wm+3 of macro column (zm, xm): solid bytes
__device__ uint32_t update_macro_solid4(const Level& M, int zm, int xm, int wm) {
  const Src& S = M.src;
  int sz = 4 * zm, sx = 4 * xm;  // the fine scene column of the cell's corner
  if (!in_region(S.rg, sz, sx)) {
    uint4 o = *reinterpret_cast<const uint4*>(S.words + ((long long)zm * M.X + xm) * M.Y + 4 * wm);
    return (uint32_t)((o.x & 0xFF) == 0) | (uint32_t)((o.y & 0xFF) == 0) << 8 |
           (uint32_t)((o.z & 0xFF) == 0) << 16 | (uint32_t)((o.w & 0xFF) == 0) << 24;
  }
  uint32_t out = 0;
  int Yf = 4 * M.Y;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint32_t any = 0;
    for (int dz = 0; dz < 4; ++dz)
      for (int dx = 0; dx < 4; ++dx) any |= solid_bytes(region_ids4(S, Yf, sz + dz, sx + dx, 4 * wm + j));
    out |= (uint32_t)(any != 0) << (8 * j);
  }
  return out;
}

// K10u's prep: CTAs [0, nbF) a warp per window column, the rest a warp per macro column
__global__ void __launch_bounds__(PREP_WARPS * 32) update_prep_kernel(Level F, Level M, int nbF) {
  __shared__ uint32_t colw[PREP_WARPS][2 + MAX_W];
  int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if ((int)blockIdx.x < nbF) {
    int c = blockIdx.x * PREP_WARPS + warp;
    if (c >= F.Z * F.X) return;
    int z = c / F.X, x = c % F.X, W = F.Y >> 2;
    uint32_t sol[KW];
    uint4 seed[KW];
#pragma unroll
    for (int k = 0; k < KW; ++k) {
      int w = lane + 32 * k;
      sol[k] = 0;
      seed[k] = make_uint4(CAP4, CAP4, CAP4, CAP4);
      if (w < W) {
        sol[k] = prep4(F, z, x, w, seed[k]);
      }
    }
    seed_column<KW>(F, c, lane, colw[warp], sol, seed);
    return;
  }
  int cm = (blockIdx.x - nbF) * PREP_WARPS + warp;
  if (cm >= M.Z * M.X) return;
  uint32_t msol[1] = {0};
  const uint4 mseed[1] = {make_uint4(CAP4, CAP4, CAP4, CAP4)};
  if (lane < (M.Y >> 2)) msol[0] = update_macro_solid4(M, cm / M.X, cm % M.X, lane);
  seed_column<1>(M, cm, lane, colw[warp], msol, mseed);
}

// A round's tiles.  The columns of a level fall into the s x s classes (z mod s, x mod s),
// and a column's horizontal neighbours at offset s are its class's neighbours at class
// index +-1.  A CTA takes a TK x TK tile of one class (class indices) and TW words of y and
// takes the round's min in three separable passes through shared memory: (1) it stages the
// (TK + 2)^2 columns around the tile (the cap outside the level), channel 0 of each word
// already reduced over y - s, y, y + s; (2) the min over x - s, x, x + s of each staged row;
// (3) the min over z - s, z, z + s, plus s, against the word's own value.
constexpr int TK = 6;                // output columns a tile side
constexpr int TS = TK + 2;           // staged columns a tile side
constexpr int TW = 8;                // words of y a tile
constexpr int RT = TK * TK * TW;     // threads of a round CTA ((TW, TK, TK)): one an output word;
                                     // as many CTAs an SM as its 2048 threads hold (32 registers)

struct Tile {
  int z0, x0, w0;  // the tile's first output column (level coordinates) and word
  int s;           // the class stride (the round's offset)
};

// round CTA b of a level -> its tile, or false where the tile holds no column of the level
__device__ __forceinline__ bool tile_of(const Level& L, int s, int b, Tile& t) {
  int W = L.Y >> 2, Cx = imin(s, L.X);
  int tz = ((L.Z + s - 1) / s + TK - 1) / TK, tx = ((L.X + s - 1) / s + TK - 1) / TK, tw = (W + TW - 1) / TW;
  int iw = b % tw;
  b /= tw;
  int ix = b % tx;
  b /= tx;
  int iz = b % tz;
  b /= tz;
  int cx = b % Cx, cz = b / Cx;
  t.z0 = cz + s * iz * TK, t.x0 = cx + s * ix * TK, t.w0 = iw * TW, t.s = s;
  return t.z0 < L.Z && t.x0 < L.X;
}

// the round CTAs of a level: its s x s classes (fewer where the level is narrower) times the
// tiles of the largest class times the word tiles
__host__ __device__ __forceinline__ int round_blocks(const Level& L, int s) {
  int W = L.Y / 4, tz = ((L.Z + s - 1) / s + TK - 1) / TK, tx = ((L.X + s - 1) / s + TK - 1) / TK;
  return (s < L.Z ? s : L.Z) * (s < L.X ? s : L.X) * tz * tx * ((W + TW - 1) / TW);
}

__device__ __forceinline__ uint4 vmin4(uint4 a, uint4 b) {
  return make_uint4(vmin(a.x, b.x), vmin(a.y, b.y), vmin(a.z, b.z), vmin(a.w, b.w));
}

struct RoundSmem {
  uint4 ys[TS * TS][TW];  // pass 1: the staged words, channel 0 reduced over y
  uint4 xs[TS * TK][TW];  // pass 2: the staged rows reduced over x
};

// passes 1-3 of the round on the tile; returns this thread's output word's new value and
// its (z, x, w), or false where the word lies outside the level
__device__ __forceinline__ bool round_tile(const Level& L, const uint4* __restrict__ in, const Tile& t,
                                           RoundSmem& sm, uint4& out, int& z, int& x, int& w) {
  const uint32_t* in32 = reinterpret_cast<const uint32_t*>(in);
  int W = L.Y >> 2, s = t.s, k = s >> 2;
  int wi = threadIdx.x, kx = threadIdx.y, kz = threadIdx.z;
  for (int kc = kx + TK * kz; kc < TS * TS; kc += TK * TK) {
    int zz = t.z0 + s * ((kc / TS) - 1), xx = t.x0 + s * ((kc % TS) - 1), ww = t.w0 + wi;
    uint4 v = make_uint4(CAP4, CAP4, CAP4, CAP4);
    if (zz >= 0 && zz < L.Z && xx >= 0 && xx < L.X && ww < W) {
      long long col = ((long long)zz * L.X + xx) * W;
      v = in[col + ww];
      uint32_t lo, hi;  // channel 0 at y - s and y + s, the cap outside the column
      if (s < 4) {
        uint32_t p = ww > 0 ? in32[4 * (col + ww - 1)] : CAP4;
        uint32_t n = ww + 1 < W ? in32[4 * (col + ww + 1)] : CAP4;
        lo = __funnelshift_l(p, v.x, 8 * s);
        hi = __funnelshift_r(v.x, n, 8 * s);
      } else {
        lo = ww >= k ? in32[4 * (col + ww - k)] : CAP4;
        hi = ww + k < W ? in32[4 * (col + ww + k)] : CAP4;
      }
      v.x = vmin(v.x, vmin(lo, hi));
    }
    sm.ys[kc][wi] = v;
  }
  __syncthreads();
  for (int rz = kz; rz < TS; rz += TK) {
    const uint4* row = &sm.ys[rz * TS + kx][wi];
    sm.xs[rz * TK + kx][wi] = vmin4(vmin4(row[0], row[TW]), row[2 * TW]);
  }
  __syncthreads();
  z = t.z0 + s * kz, x = t.x0 + s * kx, w = t.w0 + wi;
  if (z >= L.Z || x >= L.X || w >= W) return false;
  uint4 m = vmin4(vmin4(sm.xs[kz * TK + kx][wi], sm.xs[(kz + 1) * TK + kx][wi]), sm.xs[(kz + 2) * TK + kx][wi]);
  uint4 v0 = in[((long long)z * L.X + x) * W + w];
  uint32_t add = (uint32_t)s * 0x01010101u;  // at most 63 + 32 a byte: no overflow
  out = make_uint4(vmin(v0.x, m.x + add), vmin(v0.y, m.y + add), vmin(v0.z, m.z + add), vmin(v0.w, m.w + add));
  return true;
}

// the highest column top within horizontal L∞ radius SKY_R (inside the level)
__device__ __forceinline__ void sky_column(const Level& L, int c) {
  int z = c / L.X, x = c % L.X, m = -1;
  for (int zz = imax(0, z - SKY_R); zz <= imin(L.Z - 1, z + SKY_R); ++zz)
    for (int xx = imax(0, x - SKY_R); xx <= imin(L.X - 1, x + SKY_R); ++xx) m = imax(m, L.top[zz * L.X + xx]);
  L.sky[c] = m;
}

// a round of both levels: CTAs [0, nbF) the fine tiles, then the macro tiles; with sky, then
// a thread per fine and per macro column for the skyline
__global__ void __launch_bounds__(RT, 2048 / RT) scene_round_kernel(Level F, Level M, int s, int flip, int sky) {
  __shared__ RoundSmem sm;
  int b = blockIdx.x, nbF = round_blocks(F, s), nbM = round_blocks(M, s);
  if (b >= nbF + nbM) {
    if (!sky) return;
    int c = (b - nbF - nbM) * RT + threadIdx.x + TW * (threadIdx.y + TK * threadIdx.z);
    if (c < F.Z * F.X) return sky_column(F, c);
    c -= F.Z * F.X;
    if (c < M.Z * M.X) sky_column(M, c);
    return;
  }
  const Level& L = b < nbF ? F : M;
  Tile t;
  if (!tile_of(L, s, b < nbF ? b : b - nbF, t)) return;
  uint4 v;
  int z, x, w;
  if (round_tile(L, flip ? L.b : L.a, t, sm, v, z, x, w)) (flip ? L.a : L.b)[((long long)z * L.X + x) * (L.Y >> 2) + w] = v;
}

// the packed words of voxels y = 4w..4w+3 of column (z, x) from their final channels v; a
// voxel is solid exactly where its distance is 0 (every other seed and every round's value
// is at least 1); alpha: the flag and fraction tables in shared memory
__device__ __forceinline__ void encode4(const Level& L, const uint8_t* alpha, int z, int x, int w, uint4 v) {
  int sky = L.sky[z * L.X + x];
  uint32_t ids = 0, q4 = 31u * 0x01010101u;  // the skyline seeds: K10u's old ones outside its region
  uint4 o;
  if (!L.macro && src4(L, z, x, w, ids, o))  // K10u: the old words of these voxels, before they are rewritten
    q4 = ((o.x >> 26) & 0x1F) | ((o.y >> 26) & 0x1F) << 8 | ((o.z >> 26) & 0x1F) << 16 | ((o.w >> 26) & 0x1F) << 24;
  uint32_t out[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint32_t d = byte_of(v.x, j), up = byte_of(v.y, j), c2 = byte_of(v.z, j), c8 = byte_of(v.w, j);
    uint32_t q = (uint32_t)imin(imin(imax(4 * w + j - sky, 0), 124) >> 2, (int)byte_of(q4, j));
    uint32_t id = byte_of(ids, j);
    uint32_t low = d == 0 ? (L.macro ? 0u : id) : (uint32_t)(EMPTY_BASE - 1) + d;
    uint32_t word = low | (up << 8) | (c2 << 14) | (c8 << 20) | (q << 26);
    if (!L.macro && d == 0 && alpha[id]) word |= 0x80000000u | ((uint32_t)alpha[256 + id] << 8);
    out[j] = word;
  }
  *reinterpret_cast<uint4*>(L.dst + (((long long)L.dz0 + z) * L.dX + L.dx0 + x) * L.Y + 4 * w) =
      make_uint4(out[0], out[1], out[2], out[3]);
}

// the round s = 32 and the encoding, both levels (tiles as scene_round_kernel's)
__global__ void __launch_bounds__(RT, 2048 / RT) scene_encode_kernel(Level F, Level M, const uint8_t* __restrict__ alpha,
                                                          int flip) {
  __shared__ RoundSmem sm;
  __shared__ uint32_t sa[128];  // the alpha tables [2][256] u8
  int b = blockIdx.x, nbF = round_blocks(F, 32), tid = threadIdx.x + TW * (threadIdx.y + TK * threadIdx.z);
  const Level& L = b < nbF ? F : M;
  Tile t;
  if (!tile_of(L, 32, b < nbF ? b : b - nbF, t)) return;
  if (tid < 128) sa[tid] = reinterpret_cast<const uint32_t*>(alpha)[tid];
  uint4 v;
  int z, x, w;
  if (round_tile(L, flip ? L.b : L.a, t, sm, v, z, x, w)) encode4(L, reinterpret_cast<const uint8_t*>(sa), z, x, w, v);
}

// the rounds and the encoding of both levels, seeded in their ``a`` buffers: 6 launches
cudaError_t sweep(Level& F, Level& M, const uint8_t* alpha, cudaStream_t st) {
  int cols = F.Z * F.X + M.Z * M.X, flip = 0;
  for (int s = 1; s < 32; s *= 2, flip ^= 1) {
    int nb = round_blocks(F, s) + round_blocks(M, s) + (s == 1 ? (cols + RT - 1) / RT : 0);
    scene_round_kernel<<<nb, dim3(TW, TK, TK), 0, st>>>(F, M, s, flip, s == 1);
    ++g_launches;
  }
  scene_encode_kernel<<<round_blocks(F, 32) + round_blocks(M, 32), dim3(TW, TK, TK), 0, st>>>(F, M, alpha, flip);
  ++g_launches;
  return cudaGetLastError();
}

// a level over the state words ``state`` (its two buffers) and the columns ``cols`` (top, sky)
Level make_level(int Z, int X, int Y, uint4* state, int* cols, int32_t* dst, int dX, int dz0, int dx0, int macro) {
  Level L = {};
  long long nw = (long long)Z * X * Y / 4;
  L.Z = Z, L.X = X, L.Y = Y;
  L.a = state, L.b = state + nw;
  L.top = cols, L.sky = cols + Z * X;
  L.dst = dst, L.dX = dX, L.dz0 = dz0, L.dx0 = dx0, L.macro = macro;
  return L;
}

}  // namespace

// the kernel launches of the last mmt_scene_fields / mmt_update_chunks call
extern "C" int mmt_scene_launches(void) { return g_launches; }

// vol [Z, X, Y] u8 (Z, X multiples of 4, Y of 16, at most 512) -> flat [Z*X*Y + Z*X*Y/64] i32
// (fine then macro); alpha [2][256] u8 on the device: the flag and the transparent-texel
// fraction by block id.  Scratch: state [2 * (Z*X*Y + Z*X*Y/64)] u32 (two buffers of each
// level), cols [2 * (Z*X + Z*X/16)] i32.
extern "C" int mmt_scene_fields(const uint8_t* vol, const uint8_t* alpha, int Z, int X, int Y, int32_t* flat,
                                uint32_t* state, int* cols, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  g_launches = 0;
  if (Z % 4 || X % 4 || Y % 16 || Y > MAX_Y) return (int)cudaErrorInvalidValue;
  long long n = (long long)Z * X * Y;
  uint4* s4 = reinterpret_cast<uint4*>(state);
  Level F = make_level(Z, X, Y, s4, cols, flat, X, 0, 0, 0);
  Level M = make_level(Z / 4, X / 4, Y / 4, s4 + n / 2, cols + 2 * Z * X, flat + n, X / 4, 0, 0, 1);
  F.src.vol = vol;
  scene_prep_kernel<<<(Z / 4) * (X / 4), PREP_WARPS * 32, 0, st>>>(F, M);
  ++g_launches;
  return (int)sweep(F, M, alpha, st);
}

// K10u: the region's chunks written into the scene's flat buffer (in place), the window
// [zlo, zlo + wz) x [xlo, xlo + wx) re-swept from the old words' bounds, and the whole
// macro level recomputed, its solidity outside the region from the old macro words.
// slots [gz * gx] host ints (-1: air).  Scratch: state [2 * (n_w + n_m)] u32, cols
// [2 * (wz * wx + Z * X / 16)] i32, with n_w = wz * wx * Y and n_m = Z * X * Y / 64.
extern "C" int mmt_update_chunks(int32_t* flat, const uint8_t* d_blocks, const int* slots, int gz, int gx, int z0,
                                 int x0, int zlo, int xlo, int wz, int wx, const uint8_t* alpha, int Z, int X,
                                 int Y, uint32_t* state, int* cols, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  g_launches = 0;
  if (gz * gx > MAX_REGION_CHUNKS || Z % 4 || X % 4 || Y % 16 || Y > MAX_Y) return (int)cudaErrorInvalidValue;
  Src src = {};
  for (int c = 0; c < MAX_REGION_CHUNKS; ++c) src.rg.slot[c] = c < gz * gx ? slots[c] : -1;
  src.rg.gz = gz, src.rg.gx = gx, src.rg.z0 = z0, src.rg.x0 = x0;
  src.blocks = d_blocks;
  long long n = (long long)Z * X * Y, nw = (long long)wz * wx * Y;
  uint4* s4 = reinterpret_cast<uint4*>(state);
  Level F = make_level(wz, wx, Y, s4, cols, flat, X, zlo, xlo, 0);
  Level M = make_level(Z / 4, X / 4, Y / 4, s4 + nw / 2, cols + 2 * wz * wx, flat + n, X / 4, 0, 0, 1);
  F.src = src, F.src.words = flat, F.src.sX = X, F.src.z0 = zlo, F.src.x0 = xlo;
  M.src = src, M.src.words = flat + n, M.src.sX = X / 4;
  int nbF = (wz * wx + PREP_WARPS - 1) / PREP_WARPS, nbM = (M.Z * M.X + PREP_WARPS - 1) / PREP_WARPS;
  update_prep_kernel<<<nbF + nbM, PREP_WARPS * 32, 0, st>>>(F, M, nbF);
  ++g_launches;
  return (int)sweep(F, M, alpha, st);
}
