// Fractional row shear: out[b, y, x] = img[b, y, x + s_y] sampled linearly
// in x, zero off the canvas, with s_y = shifts[y].
//
// Replaces: kornia_tpu/ops/warp_shear.py::_shear_x, the pass that
//   warp_affine_shear (warp_affine(method="shear")) runs six times per
//   channel: three shears for each of its two rotation passes, every other
//   one on the transpose (_shear_y).
//
// Contract (warp_shear.py:53-122): with i0 = floor(s_y), f = s_y - i0 and
//   slack = c/4 + 192, a row is valid when -slack < i0 < slack - 1; on a
//   valid row out = a*(1-f) + b*f with a = img[y, x+i0] and
//   b = img[y, x+i0+1] (zero outside [0, c)), in that order of separately
//   rounded f32 ops (__fmul_rn/__fadd_rn, built with -fmad=false); an
//   invalid row is zero. Bit-equal to the plain PyTorch version
//   kornia_tpu_torch/ops/cuda_kernels.py::_shear_x_plain, and to the Pallas
//   kernel wherever its 8-lane residual window holds (the in-tile spread
//   of the row starts is <= 7, as for every shift the shear passes make:
//   |slope| <= sin 45 deg).
//
// Bound on H100: memory. Each pass reads and writes the (c, c) f32 canvas
//   once (3072 x 3072 at 1080p: 75.5 MB per channel). Design: one thread
//   per output pixel over a flat (b, y, x) index, so a warp reads 32 (33)
//   neighbouring values of one row and writes 32 neighbouring values: both
//   coalesced. The TPU kernel's aligned slice, roll and 8 shifted selects
//   per 8-row tile are not needed.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void shear_x_kernel(const float* __restrict__ img,
                               const float* __restrict__ shifts,
                               float* __restrict__ out, long long total,
                               int c, int slack) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int x = (int)(i % c);
  const long long row = i / c;              // b * c + y
  const int y = (int)(row % c);
  const float s = shifts[y];
  const float i0 = floorf(s);
  const float f = __fsub_rn(s, i0);
  if (!(i0 > (float)(-slack) && i0 < (float)(slack - 1))) {
    out[i] = 0.f;
    return;
  }
  const int p = (int)i0 + x;
  const float* r = img + row * c;
  const float a = (p >= 0 && p < c) ? r[p] : 0.f;
  const float b = (p + 1 >= 0 && p + 1 < c) ? r[p + 1] : 0.f;
  out[i] = __fadd_rn(__fmul_rn(a, __fsub_rn(1.f, f)), __fmul_rn(b, f));
}

}  // namespace

// img: (b, c, c) f32; shifts: (c,) f32; out: (b, c, c) f32.
extern "C" int kt_shear_x(const void* img, const void* shifts, void* out,
                          int b, int c, int slack, void* stream) {
  const long long total = (long long)b * c * c;
  if (total == 0) return 0;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  shear_x_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)img, (const float*)shifts, (float*)out, total, c, slack);
  return (int)cudaGetLastError();
}
