// Fractional shears of a square canvas, the passes of the shear-decomposed
// affine warp:
//   row mode    (kt_shear_x): out[b, y, x] = img[b, y, x + s_y], linear in x;
//   column mode (kt_shear_y): out[b, y, x] = img[b, y + s_x, x], linear in y;
// zero off the canvas, s = shifts[y] (row) or shifts[x] (column).
//
// Replaces: kornia_tpu/ops/warp_shear.py::_shear_x, the pass that
//   warp_affine_shear (warp_affine(method="shear")) runs six times per
//   channel: three shears for each of its two rotation passes. The JAX
//   package runs the middle one (_shear_y) as _shear_x on the transpose;
//   the column mode reads the canvas in its own layout instead, so no
//   transpose is made.
//
// Contract (warp_shear.py:53-122): with i0 = floor(s), f = s - i0 and
//   slack = c/4 + 192, a row (column) is valid when -slack < i0 < slack - 1;
//   there out = a*(1-f) + b*f with a the value i0 and b the value i0 + 1
//   along the sheared axis (zero outside [0, c)), in that order of
//   separately rounded f32 ops (__fmul_rn/__fadd_rn, built with
//   -fmad=false); an invalid row (column) is zero. Bit-equal to the plain
//   PyTorch versions kornia_tpu_torch/ops/cuda_kernels.py::_shear_x_plain
//   and _shear_y_plain (the row mode on the transpose), for any shifts,
//   and to the Pallas kernel wherever its 8-lane residual window holds
//   (the in-tile spread of the row starts is <= 7, as for every shift the
//   shear passes make: |slope| <= sin 45 deg).
//
// Bound on H100: memory. Each pass reads and writes the (c, c) f32 canvas
//   once (3072 x 3072 at 1080p: 75.5 MB per channel). Design:
// - Row mode: a grid over (x chunk, y, b), so no thread divides a 64-bit
//   index; a row's shift, floor, fraction and validity are computed once
//   per thread and are uniform over the block, so an invalid row is a
//   plain zero fill. Each thread makes 4 consecutive outputs from two
//   aligned 16-byte loads and one 16-byte store: the row's misalignment
//   i0 mod 4 is the same for every thread of the row, so it is resolved in
//   registers without divergence. A canvas whose width is not a multiple
//   of 4, or that is not 16-byte aligned, takes scalar loads and stores.
// - Column mode: a block owns a strip of 64 columns x 64 output rows. It
//   stages the input rows that strip needs, from (its first row + the
//   smallest i0 of its columns) to (its last row + the largest i0 + 1), by
//   coalesced row loads into shared memory; each thread then reads its
//   column at its own offset (consecutive columns fall in consecutive
//   banks whatever their offsets) and stores coalesced rows of output. A
//   strip whose spread of i0 would overflow the staging buffer reads the
//   canvas directly.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;        // threads per block, both modes
constexpr int XV = 4;          // row mode: outputs per thread
constexpr int CW = 64;         // column mode: strip width
constexpr int CT = 64;         // column mode: output rows per block
constexpr int CR = 128;        // column mode: staged rows at most

__device__ __forceinline__ bool shift_valid(float i0, int slack) {
  return i0 > (float)(-slack) && i0 < (float)(slack - 1);
}

__device__ __forceinline__ float blend(float a, float b, float g, float f) {
  return __fadd_rn(__fmul_rn(a, g), __fmul_rn(b, f));
}

template <bool VEC>
__global__ void __launch_bounds__(NT)
shear_x_kernel(const float* __restrict__ img, const float* __restrict__ shifts,
               float* __restrict__ out, int c, int slack) {
  const int y = blockIdx.y;
  const size_t row = ((size_t)blockIdx.z * c + y) * c;
  const float* __restrict__ src = img + row;
  float* __restrict__ dst = out + row;
  const int x = (blockIdx.x * NT + threadIdx.x) * XV;
  if (x >= c) return;
  const float s = __ldg(shifts + y);
  const float i0 = floorf(s);
  const float f = __fsub_rn(s, i0);
  const float g = __fsub_rn(1.f, f);
  const bool valid = shift_valid(i0, slack);
  float v0 = 0.f, v1 = 0.f, v2 = 0.f, v3 = 0.f, v4 = 0.f;
  if (valid) {
    const int p = (int)i0 + x;
    if (VEC) {
      // c % 4 == 0: every aligned quad lies wholly inside or outside the row
      const int q = p & ~3;
      const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 lo = (q >= 0 && q + 4 <= c)
                            ? __ldg(reinterpret_cast<const float4*>(src + q))
                            : zero;
      const float4 hi = (q + 4 >= 0 && q + 8 <= c)
                            ? __ldg(reinterpret_cast<const float4*>(src + q + 4))
                            : zero;
      switch (p - q) {
        case 0: v0 = lo.x; v1 = lo.y; v2 = lo.z; v3 = lo.w; v4 = hi.x; break;
        case 1: v0 = lo.y; v1 = lo.z; v2 = lo.w; v3 = hi.x; v4 = hi.y; break;
        case 2: v0 = lo.z; v1 = lo.w; v2 = hi.x; v3 = hi.y; v4 = hi.z; break;
        default: v0 = lo.w; v1 = hi.x; v2 = hi.y; v3 = hi.z; v4 = hi.w; break;
      }
    } else {
      v0 = (p >= 0 && p < c) ? __ldg(src + p) : 0.f;
      v1 = (p + 1 >= 0 && p + 1 < c) ? __ldg(src + p + 1) : 0.f;
      v2 = (p + 2 >= 0 && p + 2 < c) ? __ldg(src + p + 2) : 0.f;
      v3 = (p + 3 >= 0 && p + 3 < c) ? __ldg(src + p + 3) : 0.f;
      v4 = (p + 4 >= 0 && p + 4 < c) ? __ldg(src + p + 4) : 0.f;
    }
  }
  float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
  if (valid) {
    o.x = blend(v0, v1, g, f);
    o.y = blend(v1, v2, g, f);
    o.z = blend(v2, v3, g, f);
    o.w = blend(v3, v4, g, f);
  }
  if (VEC) {
    *reinterpret_cast<float4*>(dst + x) = o;
  } else {
    dst[x] = o.x;
    if (x + 1 < c) dst[x + 1] = o.y;
    if (x + 2 < c) dst[x + 2] = o.z;
    if (x + 3 < c) dst[x + 3] = o.w;
  }
}

__global__ void __launch_bounds__(NT)
shear_y_kernel(const float* __restrict__ img, const float* __restrict__ shifts,
               float* __restrict__ out, int c, int slack, bool vec) {
  __shared__ __align__(16) float s_tile[CR][CW];
  __shared__ int s_lo[NT / 32], s_hi[NT / 32];

  const int xs0 = blockIdx.x * CW;
  const int y0 = blockIdx.y * CT;
  const size_t plane = (size_t)blockIdx.z * c * c;
  const float* __restrict__ src = img + plane;
  float* __restrict__ dst = out + plane;
  const int tx = threadIdx.x % CW;
  const int ty = threadIdx.x / CW;
  const int x = xs0 + tx;

  float f = 0.f, g = 1.f;
  bool valid = false;
  int i0 = 0;
  if (x < c) {
    const float s = __ldg(shifts + x);
    const float fl = floorf(s);
    f = __fsub_rn(s, fl);
    g = __fsub_rn(1.f, f);
    valid = shift_valid(fl, slack);
    if (valid) i0 = (int)fl;
  }
  // the strip's smallest and largest i0 over its valid columns
  int lo = valid ? i0 : INT_MAX, hi = valid ? i0 : INT_MIN;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  if ((threadIdx.x & 31) == 0) {
    s_lo[threadIdx.x >> 5] = lo;
    s_hi[threadIdx.x >> 5] = hi;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < NT / 32; ++k) {
    lo = min(lo, s_lo[k]);
    hi = max(hi, s_hi[k]);
  }

  if (lo == INT_MAX) {                       // no valid column: zeros
    if (x < c)
      for (int yy = ty; yy < CT && y0 + yy < c; yy += NT / CW)
        dst[(size_t)(y0 + yy) * c + x] = 0.f;
    return;
  }
  const int rows = CT + (hi - lo) + 1;       // input rows y0+lo ...
  if (rows <= CR) {
    const int r0 = y0 + lo;
    if (vec && xs0 + CW <= c) {
      for (int i = threadIdx.x; i < rows * (CW / 4); i += NT) {
        const int rr = i / (CW / 4), cc = (i - rr * (CW / 4)) * 4;
        const int gy = r0 + rr;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (gy >= 0 && gy < c)
          v = __ldg(reinterpret_cast<const float4*>(src + (size_t)gy * c + xs0 + cc));
        *reinterpret_cast<float4*>(&s_tile[rr][cc]) = v;
      }
    } else {
      for (int i = threadIdx.x; i < rows * CW; i += NT) {
        const int rr = i / CW, cc = i - rr * CW;
        const int gy = r0 + rr, gx = xs0 + cc;
        s_tile[rr][cc] = (gy >= 0 && gy < c && gx < c)
                             ? __ldg(src + (size_t)gy * c + gx) : 0.f;
      }
    }
    __syncthreads();
    if (x < c) {
      for (int yy = ty; yy < CT && y0 + yy < c; yy += NT / CW) {
        float o = 0.f;
        if (valid) {
          const int t = yy + i0 - lo;
          o = blend(s_tile[t][tx], s_tile[t + 1][tx], g, f);
        }
        dst[(size_t)(y0 + yy) * c + x] = o;
      }
    }
  } else if (x < c) {                        // spread too wide to stage
    for (int yy = ty; yy < CT && y0 + yy < c; yy += NT / CW) {
      const int p = y0 + yy + i0;
      float o = 0.f;
      if (valid) {
        const float a = (p >= 0 && p < c) ? __ldg(src + (size_t)p * c + x) : 0.f;
        const float b = (p + 1 >= 0 && p + 1 < c)
                            ? __ldg(src + (size_t)(p + 1) * c + x) : 0.f;
        o = blend(a, b, g, f);
      }
      dst[(size_t)(y0 + yy) * c + x] = o;
    }
  }
}

}  // namespace

// img, out: (b, c, c) f32; shifts: (c,) f32; c, b <= 65535 (grid limits).
extern "C" int kt_shear_x(const void* img, const void* shifts, void* out,
                          int b, int c, int slack, void* stream) {
  if (b == 0 || c == 0) return 0;
  if (b > 65535 || c > 65535) return (int)cudaErrorInvalidValue;
  const bool vec = c % 4 == 0 && (uintptr_t)img % 16 == 0 &&
                   (uintptr_t)out % 16 == 0;
  const dim3 grid((c + NT * XV - 1) / (NT * XV), c, b);
  if (vec)
    shear_x_kernel<true><<<grid, NT, 0, (cudaStream_t)stream>>>(
        (const float*)img, (const float*)shifts, (float*)out, c, slack);
  else
    shear_x_kernel<false><<<grid, NT, 0, (cudaStream_t)stream>>>(
        (const float*)img, (const float*)shifts, (float*)out, c, slack);
  return (int)cudaGetLastError();
}

extern "C" int kt_shear_y(const void* img, const void* shifts, void* out,
                          int b, int c, int slack, void* stream) {
  if (b == 0 || c == 0) return 0;
  if (b > 65535 || c > 65535 * CT) return (int)cudaErrorInvalidValue;
  const bool vec = c % 4 == 0 && (uintptr_t)img % 16 == 0;
  const dim3 grid((c + CW - 1) / CW, (c + CT - 1) / CT, b);
  shear_y_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
      (const float*)img, (const float*)shifts, (float*)out, c, slack, vec);
  return (int)cudaGetLastError();
}
