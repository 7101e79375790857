// K10: the scene fields of the brickmap (packed fine and macro words), several launches
// behind one C entry point.
//
// Replaces mega_minecraft_tpu/render/brickmap.py:280,288 blocks_to_field / _build_fields
// (with _encode:211, _encode_macro:242, chebyshev_distance:140, _up_clearance:157,
// _slab_clearance:165, _skyline_descent:197), jitted XLA on the TPU.
//
// The output is integer and must equal the JAX program's bit for bit.  Its distance
// transform (chebyshev_distance) is not the exact capped L∞ distance: a doubling round
// with offset s takes the min over the 27 points {-s, 0, s}^3 (not the whole cube) and
// adds s, so a voxel gets the cheapest sum of distinct powers of two whose offsets reach
// a solid (for the offset (3, 3, 4): rounds 1 and 4, cost 5, where L∞ is 4), through
// points inside the volume.  So the kernel runs the same rounds: per round s = 1..32 a
// shifted min along z, x and y (one launch each, a neighbour outside the volume is the
// cap) and the update d = min(d, e + s).  The four fields ride together, one byte each
// of a u32 per voxel (__vminu4 takes the four minima at once): the 3-D distance, and the
// seeds of the three horizontal clearances (at-or-above solid, a solid in [y-2, y], in
// [y-8, y]), which skip the y shift.  The skyline is a 2-D max filter of radius 8 over
// the column tops (JAX's doubling dilation reaches every offset in [-8, 8], so it is the
// box).  The macro level is the same code over the any-solid reduction of 4x4x4 cells.
//
// Launches per level: column tops, the skyline filter, the seeds, 6 rounds of 4, the
// encoding; plus the solid mask and the macro reduction: 56 in all, one count per call.
//
// Bound on the H100: bytes (the u8 volume read once, the i32 field written once: 49 MB
// for the 10x10 scene, 535 MB at 33x33); the rounds move 4 bytes a voxel ~4 times each
// through device memory (12 B a voxel of scratch), about 20x the bound's bytes.
//
// K10u (mmt_update_chunks) replaces brickmap.py:325,377 _update_chunk_field /
// update_chunks with app/engine.py:31 _assemble_region folded into its first kernel: a
// region of at most 16 slot-table chunks (the engine's 3x3 buckets) written into the
// scene and the window around it (the region padded by DIST_CAP = 63 blocks, cut to the
// volume, its start clamped as dynamic_slice clamps it) re-swept.  window_kernel reads the
// old words outside the region (low byte, solidity, and the distance, clearance and skyline
// bounds they carry: solids just outside the window stay accounted for, since a voxel
// outside the window reads as the cap) and the region's blocks inside it (bounds at the
// cap, skyline 31); then the same rounds run over the window with those seeds in place of
// the cap, the encoding writes the window back into the field in place and the macro
// level is recomputed whole (a new solid moves macro distances up to 63 * 4 blocks away):
// 57 launches, one count.  Bound: operations (K10's per window voxel plus the macro pass).

#include <stdint.h>

#include "mmt_math.cuh"
#include "mmt_render_tables.h"

#define THREADS 256

namespace {

__device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }
__device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }

// fine level: solid = RENDER_SOLID[block id]
__global__ void solid_kernel(const uint8_t* __restrict__ vol, long long n, uint8_t* __restrict__ mask) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) mask[i] = RENDER_SOLID_TAB[vol[i]];
}

// macro level: a 4x4x4 cell is solid if any of its fine words holds a solid block id
__global__ void macro_solid_kernel(const int32_t* __restrict__ field, int Z, int X, int Y,
                                   uint8_t* __restrict__ mask) {
  int zm = Z / MACRO_SCALE, xm = X / MACRO_SCALE, ym = Y / MACRO_SCALE;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)zm * xm * ym) return;
  int y = (int)(i % ym), x = (int)((i / ym) % xm), z = (int)(i / ((long long)ym * xm));
  uint8_t any = 0;
  for (int dz = 0; dz < MACRO_SCALE && !any; ++dz)
    for (int dx = 0; dx < MACRO_SCALE && !any; ++dx) {
      const int32_t* col = field + ((long long)(z * MACRO_SCALE + dz) * X + x * MACRO_SCALE + dx) * Y
                           + y * MACRO_SCALE;
      for (int dy = 0; dy < MACRO_SCALE; ++dy) {
        int low = col[dy] & 0xFF;
        if (low > 0 && low < EMPTY_BASE) any = 1;
      }
    }
  mask[i] = any;
}

// highest solid y of each column, -1 if none
__global__ void top_kernel(const uint8_t* __restrict__ mask, int Z, int X, int Y, int* __restrict__ top) {
  int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= Z * X) return;
  const uint8_t* col = mask + (long long)c * Y;
  int t = -1;
  for (int y = Y - 1; y >= 0; --y)
    if (col[y]) { t = y; break; }
  top[c] = t;
}

// the highest column top within horizontal L∞ radius SKY_R (inside the volume)
__global__ void sky_kernel(const int* __restrict__ top, int Z, int X, int* __restrict__ sky) {
  int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= Z * X) return;
  int z = c / X, x = c % X, m = -1;
  for (int zz = imax(0, z - SKY_R); zz <= imin(Z - 1, z + SKY_R); ++zz)
    for (int xx = imax(0, x - SKY_R); xx <= imin(X - 1, x + SKY_R); ++xx) m = imax(m, top[zz * X + xx]);
  sky[c] = m;
}

__device__ __forceinline__ int any_solid(const uint8_t* col, int lo, int hi) {
  for (int y = imax(lo, 0); y <= hi; ++y)
    if (col[y]) return 1;
  return 0;
}

// the round's start values: byte 0 the 3-D distance field (0 at a solid, else the cap),
// bytes 1-3 the seeds of the three horizontal clearances: 0 where the voxel is in the
// at-or-above / slab-2 / slab-8 set of its column, else the cap.  With ``seeded`` the
// four bytes of out[i] already hold upper bounds (K10u's old words), which take the
// cap's place (capped at it)
__global__ void init_kernel(const uint8_t* __restrict__ mask, const int* __restrict__ top, int Z, int X, int Y,
                            int seeded, uint32_t* __restrict__ out) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)Z * X * Y) return;
  int y = (int)(i % Y);
  long long c = i / Y;
  const uint8_t* col = mask + c * Y;
  int t = top[c];
  uint32_t far = seeded ? out[i] : DIST_CAP * 0x01010101u;
  uint32_t fd = imin(far & 0xFF, DIST_CAP), fu = imin((far >> 8) & 0xFF, DIST_CAP);
  uint32_t f2 = imin((far >> 16) & 0xFF, DIST_CAP), f8 = imin(far >> 24, DIST_CAP);
  uint32_t d = col[y] ? 0u : fd;
  uint32_t up = y <= t ? 0u : fu;
  uint32_t s2 = (y - 2 <= t && any_solid(col, y - 2, y)) ? 0u : f2;
  uint32_t s8 = (y - 8 <= t && any_solid(col, y - 8, y)) ? 0u : f8;
  out[i] = d | (up << 8) | (s2 << 16) | (s8 << 24);
}

__device__ __forceinline__ uint32_t bytes_min(uint32_t a, uint32_t b) {
  return __vminu4(a, b);
}

// one axis of a doubling round's shifted min: out(v) = min(in(v), in(v - s e), in(v + s e))
// per byte, a neighbour outside the volume counting as the cap (brickmap.py:130-137);
// along y (axis 2) only byte 0 shifts (the clearances are horizontal), the others copy
__global__ void shift_min_kernel(const uint32_t* __restrict__ in, int Z, int X, int Y, int axis, int s,
                                 uint32_t* __restrict__ out) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)Z * X * Y) return;
  int pos, n;
  long long stride;
  if (axis == 0) pos = (int)(i / ((long long)X * Y)), n = Z, stride = (long long)X * Y;
  else if (axis == 1) pos = (int)((i / Y) % X), n = X, stride = Y;
  else pos = (int)(i % Y), n = Y, stride = 1;
  const uint32_t cap4 = DIST_CAP * 0x01010101u;
  uint32_t v = in[i];
  uint32_t lo = pos - s >= 0 ? in[i - s * stride] : cap4;
  uint32_t hi = pos + s < n ? in[i + s * stride] : cap4;
  uint32_t m = bytes_min(v, bytes_min(lo, hi));
  if (axis == 2) m = (m & 0xFFu) | (v & 0xFFFFFF00u);
  out[i] = m;
}

// the round's update d = min(d, e + s) per byte (e <= 63, s <= 32: no byte overflows)
__global__ void round_update_kernel(const uint32_t* __restrict__ e, long long n, int s, uint32_t* __restrict__ d) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  d[i] = bytes_min(d[i], e[i] + (uint32_t)s * 0x01010101u);
}

// where the encoding of a [Z, X, Y] level (or window) lands: the words of the volume it
// lies in, that volume's x extent and the window's corner (0, 0 for a whole level)
struct Dest {
  int32_t* words;
  int X, z0, x0;
};

// the packed word from the finished distances: fine (vol != null) or macro; alpha [2][256]:
// the alpha flag and the transparent-texel fraction of each block id; qseed (or null): an
// upper bound of the skyline descent per voxel (K10u's old words)
__global__ void encode_kernel(const uint32_t* __restrict__ dist4, const uint8_t* __restrict__ vol,
                              const uint8_t* __restrict__ mask, const int* __restrict__ sky,
                              const uint8_t* __restrict__ alpha, const uint8_t* __restrict__ qseed,
                              int Z, int X, int Y, Dest dst) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)Z * X * Y) return;
  int y = (int)(i % Y);
  long long c = i / Y;
  uint32_t w = dist4[i];
  uint32_t dist = w & 0xFF, up = (w >> 8) & 0xFF, c2 = (w >> 16) & 0xFF, c8 = w >> 24;
  int q = imin(imax(y - sky[c], 0), 124) / 4;
  if (qseed) q = imin(q, qseed[i]);
  uint32_t solid = mask[i];
  uint32_t low;
  if (vol) low = solid ? (uint32_t)vol[i] : (uint32_t)(EMPTY_BASE - 1) + (dist < 1 ? 1u : dist);
  else low = solid ? 0u : (uint32_t)(EMPTY_BASE - 1) + (dist < 1 ? 1u : dist);
  uint32_t word = low | (up << 8) | (c2 << 14) | (c8 << 20) | ((uint32_t)q << 26);
  if (vol && solid && alpha[vol[i]]) word |= 0x80000000u | ((uint32_t)alpha[256 + vol[i]] << 8);
  long long z = c / X, x = c % X;
  dst.words[((dst.z0 + z) * dst.X + dst.x0 + x) * Y + y] = (int32_t)word;
}

inline unsigned blocks_for(long long n) { return (unsigned)((n + THREADS - 1) / THREADS); }

// one level's (or window's) fields from its solid mask [Z, X, Y] into dst; with qseed the
// four distance seeds are already in a (see init_kernel)
cudaError_t encode_level(const uint8_t* vol, const uint8_t* mask, const uint8_t* alpha, const uint8_t* qseed,
                         int Z, int X, int Y, Dest dst, uint32_t* a, uint32_t* b, int* top, int* sky,
                         cudaStream_t st) {
  long long n = (long long)Z * X * Y;
  unsigned g = blocks_for(n);
  top_kernel<<<blocks_for(Z * X), THREADS, 0, st>>>(mask, Z, X, Y, top);
  sky_kernel<<<blocks_for(Z * X), THREADS, 0, st>>>(top, Z, X, sky);
  init_kernel<<<g, THREADS, 0, st>>>(mask, top, Z, X, Y, qseed != nullptr, a);
  for (int s = 1; s < DIST_CAP; s *= 2) {
    shift_min_kernel<<<g, THREADS, 0, st>>>(a, Z, X, Y, 0, s, b);
    shift_min_kernel<<<g, THREADS, 0, st>>>(b, Z, X, Y, 1, s, b + n);
    shift_min_kernel<<<g, THREADS, 0, st>>>(b + n, Z, X, Y, 2, s, b);
    round_update_kernel<<<g, THREADS, 0, st>>>(b, n, s, a);
  }
  encode_kernel<<<g, THREADS, 0, st>>>(a, vol, mask, sky, alpha, qseed, Z, X, Y, dst);
  return cudaGetLastError();
}

// the macro level of a finished fine field: the any-solid reduction of 4x4x4 cells, encoded
cudaError_t encode_macro(int32_t* flat, const uint8_t* alpha, int Z, int X, int Y, uint32_t* a, uint32_t* b,
                         uint8_t* mask, int* top, int* sky, cudaStream_t st) {
  int zm = Z / MACRO_SCALE, xm = X / MACRO_SCALE, ym = Y / MACRO_SCALE;
  macro_solid_kernel<<<blocks_for((long long)zm * xm * ym), THREADS, 0, st>>>(flat, Z, X, Y, mask);
  Dest dst = {flat + (long long)Z * X * Y, xm, 0, 0};
  return encode_level(nullptr, mask, alpha, nullptr, zm, xm, ym, dst, a, b, top, sky, st);
}

// K10u's window: the old words of the scene where the region does not reach (their low
// byte, solidity and the distance / clearance / skyline bounds they carry), the region's
// chunks from the slot table where it does (seeds at the cap, skyline 31).  The region is
// gz x gx chunks at volume offset (z0, x0); chunk c's blocks are slot rg.slot[c] of
// d_blocks ([C, 16, 16, Y] u8, [z, x, y]), air where the slot is -1.
struct Region {
  int slot[MAX_REGION_CHUNKS];
  int gz, gx, z0, x0;
};

__global__ void window_kernel(const int32_t* __restrict__ field, int X, int Y, const uint8_t* __restrict__ d_blocks,
                              Region rg, int zlo, int xlo, int wz, int wx, uint8_t* __restrict__ wvol,
                              uint8_t* __restrict__ wmask, uint32_t* __restrict__ seed4,
                              uint8_t* __restrict__ qseed) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)wz * wx * Y) return;
  int y = (int)(i % Y), x = (int)((i / Y) % wx), z = (int)(i / ((long long)Y * wx));
  int rz = zlo + z - rg.z0, rx = xlo + x - rg.x0;
  if (rz >= 0 && rz < rg.gz * 16 && rx >= 0 && rx < rg.gx * 16) {
    int s = rg.slot[(rz / 16) * rg.gx + rx / 16];
    uint8_t blk = s >= 0 ? d_blocks[(((long long)s * 16 + rz % 16) * 16 + rx % 16) * Y + y] : 0;
    uint8_t solid = RENDER_SOLID_TAB[blk];
    wvol[i] = solid ? blk : (uint8_t)EMPTY_BASE;
    wmask[i] = solid;
    seed4[i] = DIST_CAP * 0x01010101u;
    qseed[i] = 31;
    return;
  }
  uint32_t old = (uint32_t)field[((long long)(zlo + z) * X + xlo + x) * Y + y];
  int low = (int)(old & 0xFF);
  wvol[i] = (uint8_t)low;
  wmask[i] = low > 0 && low < EMPTY_BASE;
  uint32_t dist = (uint32_t)imax(low - (EMPTY_BASE - 1), 1);
  seed4[i] = dist | (((old >> 8) & 0x3F) << 8) | (((old >> 14) & 0x3F) << 16) | (((old >> 20) & 0x3F) << 24);
  qseed[i] = (uint8_t)((old >> 26) & 0x1F);
}

}  // namespace

// vol [Z, X, Y] u8 -> flat [Z*X*Y + Z*X*Y/64] i32 (fine then macro); alpha [2][256] u8 on
// the device: the flag and the transparent-texel fraction by block id.  Scratch: a
// [Z*X*Y] u32, b [2 * Z*X*Y] u32, mask [Z*X*Y] u8 (the fine mask, then the macro mask in its head),
// top, sky [Z*X] i32.
extern "C" int mmt_scene_fields(const uint8_t* vol, const uint8_t* alpha, int Z, int X, int Y, int32_t* flat,
                                uint32_t* a, uint32_t* b, uint8_t* mask, int* top, int* sky, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  long long n = (long long)Z * X * Y;
  solid_kernel<<<blocks_for(n), THREADS, 0, st>>>(vol, n, mask);
  Dest dst = {flat, X, 0, 0};
  cudaError_t err = encode_level(vol, mask, alpha, nullptr, Z, X, Y, dst, a, b, top, sky, st);
  if (err != cudaSuccess) return (int)err;
  return (int)encode_macro(flat, alpha, Z, X, Y, a, b, mask, top, sky, st);
}

// K10u: the region's chunks written into the scene's flat buffer (in place) and the
// window [zlo, zlo + wz) x [xlo, xlo + wx) re-swept from its seeds, then the whole macro
// level.  slots [gz * gx] host ints (-1: air).  Scratch: wvol, wmask [max(n_w, n_m)] u8,
// a [max(n_w, n_m)] u32, b [2 * max(n_w, n_m)] u32, qseed [n_w] u8, top, sky
// [max(wz * wx, Z * X / 16)] i32, with n_w = wz * wx * Y and n_m = Z * X * Y / 64.
extern "C" int mmt_update_chunks(int32_t* flat, const uint8_t* d_blocks, const int* slots, int gz, int gx, int z0,
                                 int x0, int zlo, int xlo, int wz, int wx, const uint8_t* alpha, int Z, int X,
                                 int Y, uint8_t* wvol, uint8_t* wmask, uint32_t* a, uint32_t* b, uint8_t* qseed,
                                 int* top, int* sky, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (gz * gx > MAX_REGION_CHUNKS) return (int)cudaErrorInvalidValue;
  Region rg;
  for (int c = 0; c < MAX_REGION_CHUNKS; ++c) rg.slot[c] = c < gz * gx ? slots[c] : -1;
  rg.gz = gz, rg.gx = gx, rg.z0 = z0, rg.x0 = x0;
  long long nw = (long long)wz * wx * Y;
  window_kernel<<<blocks_for(nw), THREADS, 0, st>>>(flat, X, Y, d_blocks, rg, zlo, xlo, wz, wx, wvol, wmask, a,
                                                    qseed);
  Dest dst = {flat, X, zlo, xlo};
  cudaError_t err = encode_level(wvol, wmask, alpha, qseed, wz, wx, Y, dst, a, b, top, sky, st);
  if (err != cudaSuccess) return (int)err;
  return (int)encode_macro(flat, alpha, Z, X, Y, a, b, wmask, top, sky, st);
}
