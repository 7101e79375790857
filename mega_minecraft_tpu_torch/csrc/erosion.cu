// K9: zone erosion, one cooperative launch per 24x24-chunk zone grid.
//
// Replaces mega_minecraft_tpu/terrain/erosion.py:59 erode_zone (+ :42 _relax_once, :109
// _wrote_mask, :36 _shift_edge_clamp, :120 gather_zone_layers, :138 scatter_zone_layers)
// and the slot gather / core scatter / backward fix of scheduler.py:105-116
// _stage_erosion, jitted XLA on the TPU.
//
// The JAX program is a while_loop of synchronous Jacobi sweeps per layer, top layer
// first, with no iteration cap.  Its per-column sum of rises (accum) feeds the next
// layer's first sweep, so the sweep order is part of the result: a Gauss-Seidel or tiled
// sweep reaches the same starts but other accum bits.  So the kernel keeps the JAX
// sweeps exactly: every sweep reads one buffer and writes the other, and one grid-wide
// barrier (cooperative_groups grid.sync) separates two sweeps.  The whole zone, loop and
// convergence test included, is one launch: no flag goes back to the host.  The grid is
// as many blocks as fit on the card at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor
// x SMs, at most one thread per column) and each thread walks the 147,456 columns with a
// grid stride.
//
// Buffers: out [9, 384, 384] (layer rel's sweeps alternate between out[rel] and tmp; the
// last sweep of a layer changes nothing, so out[rel] then holds the result, unless a
// -0/+0 flip left it in tmp, which is copied back); acc[2] (a layer's first sweep reads
// the neighbours' sums from one and writes the other; later sweeps touch only their own
// column); three did-change flags, used round robin: sweep k sets flags[k % 3] and clears
// flags[(k + 1) % 3], which no thread reads before the next barrier.  The input grid is
// read either from a gathered [9, 384, 384] tensor or straight from the slot table's rows
// ([24, 24] slots of the [N, 20, 16, 16] layers and [N, 16, 16] heightfields); in the
// second case the eroded 12x12 core is written back into the rows and
// fix_backward_stratified applied to the core, or to all 576 chunks (the area path).
// Each layer's sweep count (top layer first) goes to iters[8].
//
// Bound on the H100: neither bytes (the grid is 5.3 MB and stays in L2) nor operations
// (~40 per column and sweep) but the chain of dependent sweeps, each ending in a
// grid-wide barrier.
//
// K9b (erosion_band_kernel, below) is one sweep of one layer on a row band of the grid, for
// the row-sharded erosion of parallel/sharding.py: the host owns the loop, exchanges the
// bands' halo rows between sweeps and sums their changed flags.  It shares relax_column,
// the arithmetic of a column's sweep, with K9, so the two agree bit for bit.

#include <cooperative_groups.h>

#include "mmt_math.cuh"

namespace cg = cooperative_groups;
using namespace mmt;

#define GRID_BLOCKS 384
#define NCOL (GRID_BLOCKS * GRID_BLOCKS)
#define GRID_CHUNKS 24
#define ZONE 12
#define CORE_LO 6  // first core chunk of the grid, per axis
#define N_ERODED (NUM_MATERIALS - NUM_STRATIFIED_MATERIALS)
#define THREADS 256

struct ZoneArgs {
  const float* grid_in;  // [9, 384, 384] gathered grid, or null: read through the slot table
  float* layers;         // [N, 20, 16, 16] rows (eroded layers read; core written back)
  const float* hf;       // [N, 16, 16] rows
  const int* gslots;     // [24, 24] slots of the zone grid, [cz][cx]
  int fix_all;           // fix every chunk of the grid (else the core only)
  const float* tan_repose;  // [NUM_MATERIALS]
  const int* dirs;          // [8][2] (dx, dz), odd rows diagonal
  float* out;               // [9, 384, 384] eroded grid
  float* tmp;               // [384 * 384]
  float* acc;               // [2][384 * 384]
  int* flags;               // [3]
  int* iters;               // [8]
};

MMT_FN float fmin_nan(float a, float b) { return (a < b || a != a) ? a : b; }
MMT_FN int clampi(int v, int lo, int hi) { return v < lo ? lo : (v > hi ? hi : v); }

// the input grid's layer l (0..7 eroded, 8 heightfield) at block (Z, X)
MMT_FN float gathered(const ZoneArgs& a, int l, int Z, int X) {
  if (a.grid_in) return a.grid_in[(size_t)l * NCOL + Z * GRID_BLOCKS + X];
  int slot = a.gslots[(Z >> 4) * GRID_CHUNKS + (X >> 4)];
  int col = (Z & 15) * 16 + (X & 15);
  if (l == N_ERODED) return a.hf[(size_t)slot * 256 + col];
  return a.layers[((size_t)slot * NUM_MATERIALS + NUM_STRATIFIED_MATERIALS + l) * 256 + col];
}

// the arithmetic of one column's sweep (_relax_once, erosion.py:42-55): start s, end e, and
// nb(i, nbs, nbe) loading the start and end of neighbour i (DIR_VECS_2D order) -> the new
// start; *wrote: whether the 3x3 neighbourhood holds a positive thickness
template <class NB>
MMT_FN float relax_column(float s, float e, const float* offs, NB nb, bool* wrote) {
  float ns = s, mt = e - s;
  for (int i = 0; i < 8; ++i) {
    float nbs, nbe;
    nb(i, nbs, nbe);
    ns = fmax_nan(ns, nbs - offs[i]);
    mt = fmax_nan(mt, nbe - nbs);
  }
  *wrote = mt > 0.f;
  return fmin_nan(ns, e);
}

// one column's sweep of layer rel; returns whether it changed.  FIRST: starts and ends
// read with the sums (start = g[rel] + acc), and a column that is not written keeps the
// raw g[rel]; later sweeps read the layer buffer and the raw end.
template <bool FIRST>
MMT_FN bool sweep_column(const ZoneArgs& a, int rel, int p, const float* src, const float* end,
                         const float* acc_in, float* acc_out, float* dst, const float* offs) {
  int Z = p / GRID_BLOCKS, X = p % GRID_BLOCKS;
  float s = FIRST ? gathered(a, rel, Z, X) + acc_in[p] : src[p];
  float e = FIRST ? end[p] + acc_in[p] : end[p];
  bool wrote;
  float ns = relax_column(s, e, offs, [&](int i, float& nbs, float& nbe) {
    int z = clampi(Z + a.dirs[2 * i + 1], 0, GRID_BLOCKS - 1);
    int x = clampi(X + a.dirs[2 * i], 0, GRID_BLOCKS - 1);
    int q = z * GRID_BLOCKS + x;
    nbs = FIRST ? gathered(a, rel, z, x) + acc_in[q] : src[q];
    nbe = FIRST ? end[q] + acc_in[q] : end[q];
  }, &wrote);
  bool changed = wrote && ns != s;
  acc_out[p] = (FIRST ? acc_in[p] : acc_out[p]) + (changed ? ns - s : 0.f);
  dst[p] = wrote ? ns : (FIRST ? gathered(a, rel, Z, X) : s);
  return changed;
}

MMT_FN bool read_flag(const int* f) { return *(volatile const int*)f != 0; }

__global__ void __launch_bounds__(THREADS) erosion_kernel(ZoneArgs a) {
  cg::grid_group grid = cg::this_grid();
  const int stride = gridDim.x * blockDim.x;
  const int t0 = blockIdx.x * blockDim.x + threadIdx.x;
  float* acc[2] = {a.acc, a.acc + NCOL};

  // zero the sums, copy the heightfield (the top layer's end) and clear the flags
  for (int p = t0; p < NCOL; p += stride) {
    acc[0][p] = 0.f;
    a.out[(size_t)N_ERODED * NCOL + p] = gathered(a, N_ERODED, p / GRID_BLOCKS, p % GRID_BLOCKS);
  }
  if (t0 < 3) a.flags[t0] = 0;
  grid.sync();

  int k = 0;   // sweeps so far over all layers (selects the flag)
  int cur = 0;  // the sums this layer's first sweep reads
  for (int rel = N_ERODED - 1; rel >= 0; --rel) {
    float tan = a.tan_repose[NUM_STRATIFIED_MATERIALS + rel];
    float offs[8];
    for (int i = 0; i < 8; ++i) offs[i] = tan * ((i & 1) ? F(1.41421356237309504880) : 1.f);
    float* layer = a.out + (size_t)rel * NCOL;
    const float* end = a.out + (size_t)(rel + 1) * NCOL;
    float* acc_l = acc[cur ^ 1];

    bool any = false;
    for (int p = t0; p < NCOL; p += stride)
      any |= sweep_column<true>(a, rel, p, nullptr, end, acc[cur], acc_l, layer, offs);
    if (any) a.flags[k % 3] = 1;
    if (t0 == 0) a.flags[(k + 1) % 3] = 0;
    grid.sync();
    bool go = read_flag(&a.flags[k % 3]);
    ++k;
    int sweeps = 1;
    float* src = layer;
    float* dst = a.tmp;
    while (go) {
      any = false;
      for (int p = t0; p < NCOL; p += stride)
        any |= sweep_column<false>(a, rel, p, src, end, nullptr, acc_l, dst, offs);
      if (any) a.flags[k % 3] = 1;
      if (t0 == 0) a.flags[(k + 1) % 3] = 0;
      grid.sync();
      go = read_flag(&a.flags[k % 3]);
      ++k;
      ++sweeps;
      float* t = src;
      src = dst;
      dst = t;
    }
    if (src != layer) {  // the last sweep wrote tmp: equal to out[rel] but for signed zeros
      for (int p = t0; p < NCOL; p += stride) layer[p] = src[p];
      grid.sync();
    }
    if (t0 == 0) a.iters[N_ERODED - 1 - rel] = sweeps;
    cur ^= 1;
  }

  if (a.layers == nullptr) return;
  // write the eroded core back; fix_backward_stratified (layers.py:118) on the written
  // chunks: backward-stratified slots -> starts below the eroded base, layer 12
  int lo = a.fix_all ? 0 : CORE_LO, n = a.fix_all ? GRID_CHUNKS : ZONE;
  for (int q = t0; q < n * n * 256; q += stride) {
    int c = q >> 8, col = q & 255;
    int cz = lo + c / n, cx = lo + c % n;
    float* L = a.layers + (size_t)a.gslots[cz * GRID_CHUNKS + cx] * NUM_MATERIALS * 256 + col;
    if (cz >= CORE_LO && cz < CORE_LO + ZONE && cx >= CORE_LO && cx < CORE_LO + ZONE) {
      int p = (cz * 16 + (col >> 4)) * GRID_BLOCKS + cx * 16 + (col & 15);
      for (int l = 0; l < N_ERODED; ++l)
        L[(NUM_STRATIFIED_MATERIALS + l) * 256] = a.out[(size_t)l * NCOL + p];
    }
    float base = L[NUM_STRATIFIED_MATERIALS * 256];
    for (int l = NUM_FORWARD_MATERIALS; l < NUM_STRATIFIED_MATERIALS; ++l)
      L[l * 256] = base - L[l * 256];
  }
}

extern "C" int mmt_erosion(const float* grid_in, float* layers, const float* hf, const int* gslots,
                           int fix_all, const float* tan_repose, const int* dirs, float* out,
                           float* tmp, float* acc, int* flags, int* iters, void* stream) {
  ZoneArgs a = {grid_in, layers, hf, gslots, fix_all, tan_repose, dirs, out, tmp, acc, flags, iters};
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, erosion_kernel, THREADS, 0);
  if (err != cudaSuccess) return (int)err;
  int blocks = per_sm * sms;
  if (blocks > (NCOL + THREADS - 1) / THREADS) blocks = (NCOL + THREADS - 1) / THREADS;
  if (blocks < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel((void*)erosion_kernel, dim3(blocks), dim3(THREADS), args, 0,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// K9b: one Jacobi sweep of eroded layer rel on a band of `rows` grid rows (replaces
// mega_minecraft_tpu/parallel/sharding.py:124-156,205-225 _relax_sharded and
// _wrote_mask_sharded, the shard body of erode_zone_sharded:159).  Every buffer is
// [rows + 2, 384]: row 0 the halo row above the band, rows 1..rows the band, row rows + 1
// the halo row below; the host fills the halo rows from the neighbouring bands before the
// sweep.  The edge bands clamp to their own border row instead (top / bottom: rows -1 and
// rows map to rows 0 and rows - 1), as the grid's edge does in K9.  FIRST (the layer's first
// sweep, acc_in given): start = raw layer + acc_in and end = end + acc_in, on the halo rows
// too, a column not written keeps the raw layer, and acc_out = acc_in + the rise; later
// sweeps read start and end as they are and add the rise to acc_out in place.  dst and
// acc_out get the band's rows.  A block with a changed column sets flags[k & 1]; thread 0
// clears flags[(k + 1) & 1] for the next sweep (which no thread of this sweep sets).  One
// thread per column.  Bound on the H100 by bytes: each sweep reads the band's start, end
// (and sums) and writes its layer and sums, ~40 operations a column.
template <bool FIRST>
__global__ void __launch_bounds__(THREADS) erosion_band_kernel(
    const float* __restrict__ start, const float* __restrict__ end,
    const float* __restrict__ acc_in, float* __restrict__ acc_out, float* __restrict__ dst,
    int rows, int lo, int hi, int rel, const float* __restrict__ tan_repose,
    const int* __restrict__ dirs, int* __restrict__ flags, int k) {
  int p = blockIdx.x * blockDim.x + threadIdx.x;
  bool changed = false;
  if (p < rows * GRID_BLOCKS) {
    float tan = tan_repose[NUM_STRATIFIED_MATERIALS + rel];
    float offs[8];
    for (int i = 0; i < 8; ++i) offs[i] = tan * ((i & 1) ? F(1.41421356237309504880) : 1.f);
    int R = p / GRID_BLOCKS, X = p % GRID_BLOCKS;
    int q0 = p + GRID_BLOCKS;  // (R + 1) * 384 + X
    float s = FIRST ? start[q0] + acc_in[q0] : start[q0];
    float e = FIRST ? end[q0] + acc_in[q0] : end[q0];
    bool wrote;
    float ns = relax_column(s, e, offs, [&](int i, float& nbs, float& nbe) {
      int r = clampi(R + dirs[2 * i + 1], lo, hi);
      int x = clampi(X + dirs[2 * i], 0, GRID_BLOCKS - 1);
      int q = (r + 1) * GRID_BLOCKS + x;
      nbs = FIRST ? start[q] + acc_in[q] : start[q];
      nbe = FIRST ? end[q] + acc_in[q] : end[q];
    }, &wrote);
    changed = wrote && ns != s;
    acc_out[q0] = (FIRST ? acc_in[q0] : acc_out[q0]) + (changed ? ns - s : 0.f);
    dst[q0] = wrote ? ns : start[q0];  // FIRST: the raw layer; later: s
  }
  if (__syncthreads_or(changed) && threadIdx.x == 0) flags[k & 1] = 1;
  if (p == 0) flags[(k + 1) & 1] = 0;
}

extern "C" int mmt_erosion_band(const float* start, const float* end, const float* acc_in,
                                float* acc_out, float* dst, int rows, int top_edge,
                                int bottom_edge, int rel, const float* tan_repose, const int* dirs,
                                int* flags, int k, void* stream) {
  int lo = top_edge ? 0 : -1, hi = bottom_edge ? rows - 1 : rows;
  int blocks = (rows * GRID_BLOCKS + THREADS - 1) / THREADS;
  cudaStream_t st = (cudaStream_t)stream;
  if (acc_in)
    erosion_band_kernel<true><<<blocks, THREADS, 0, st>>>(start, end, acc_in, acc_out, dst, rows, lo,
                                                          hi, rel, tan_repose, dirs, flags, k);
  else
    erosion_band_kernel<false><<<blocks, THREADS, 0, st>>>(start, end, acc_in, acc_out, dst, rows,
                                                           lo, hi, rel, tan_repose, dirs, flags, k);
  return (int)cudaGetLastError();
}
