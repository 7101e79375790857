// K12: the running-average accumulation of the colour, albedo and normal buffers.
//
// Replaces mega_minecraft_tpu/render/tracer.py:1584 accumulate (also the second half of
// :1595 render_accumulate), jitted XLA on the TPU: out = (x + fid * old) * mult with
// mult = 1 / (fid + 1) rounded in f32 on the host, as the JAX program and the plain
// version write it, so all three agree bit for bit.  New buffers are written (the JAX
// function is pure; a caller may keep the old ones).
//
// Bound on the H100: bytes (six [H, W, 3] f32 inputs read, three written once; 224 MB
// at 1080p); one thread per float of the three buffers.

#include <stdint.h>

#include "mmt_math.cuh"

namespace {

__global__ void accumulate_kernel(const float* __restrict__ c_old, const float* __restrict__ a_old,
                                  const float* __restrict__ n_old, const float* __restrict__ c,
                                  const float* __restrict__ a, const float* __restrict__ n, long long count,
                                  float fid, float mult, float* __restrict__ c_out, float* __restrict__ a_out,
                                  float* __restrict__ n_out) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  c_out[i] = (c[i] + fid * c_old[i]) * mult;
  a_out[i] = (a[i] + fid * a_old[i]) * mult;
  n_out[i] = (n[i] + fid * n_old[i]) * mult;
}

}  // namespace

extern "C" int mmt_accumulate(const float* c_old, const float* a_old, const float* n_old, const float* c,
                              const float* a, const float* n, long long count, float fid, float mult,
                              float* c_out, float* a_out, float* n_out, void* stream) {
  if (count > 0)
    accumulate_kernel<<<(unsigned)((count + 255) / 256), 256, 0, (cudaStream_t)stream>>>(
        c_old, a_old, n_old, c, a, n, count, fid, mult, c_out, a_out, n_out);
  return (int)cudaGetLastError();
}
