// Exact single-pass bilinear / nearest sampling of an HWC image at a
// per-pixel source coordinate: remap, warp_affine and warp_perspective.
//
// Replaces: kornia_tpu/ops/warp_pallas.py::_make_kernel (launched by
//   _remap_chunks), which remap_exact, warp_affine_exact and
//   warp_perspective_exact run on the TPU.
//
// Contract (the Pallas path's, warp_pallas.py:783-825, 1145-1195), per
//   destination pixel (x, y):
//   - the source coordinate (sx, sy) comes from one of three map forms:
//     FORM_DATA reads it from two (Ho, Wo) f32 maps; FORM_AFFINE computes
//     c0*x + c1*y + c2 and c3*x + c4*y + c5; FORM_PERSP divides those by
//     c6*x + c7*y + c8, whose magnitude is clamped to >= 1e-8;
//   - border padding clips (sx, sy) to [0, w-1] x [0, h-1]; nearest mode
//     rounds with floor(s + 0.5); then both are clipped to
//     [-1.5, w+0.5] x [-1.5, h+0.5] (only fully outside samples move);
//   - bilinear taps at floor(s), weights (1-fx)(1-fy), fx(1-fy),
//     (1-fx)fy, fx*fy, summed in grid_sample's tap order (dy, dx) =
//     (0,0), (0,1), (1,0), (1,1); a tap outside the image reads `fill`;
//   - u8 output is round-half-to-even (__float2int_rn) then clamped to
//     [0, 255]; f32 output is stored as is.
//   Every multiply and add is a separately rounded f32 op
//   (__fmul_rn/__fadd_rn, and the file is built with -fmad=false), so the
//   kernel is bit-equal to the plain PyTorch version
//   (kornia_tpu_torch/ops/cuda_kernels.py::_remap_plain) on the same inputs.
//
// Bound on H100: memory. Per destination pixel it writes C values and, on
//   FORM_DATA, reads 8 bytes of map; the four taps of neighbouring pixels
//   overlap, so a smooth map reads each source value about once (from L2
//   for the repeats). At 1080p RGB u8 that is ~12.4 MB (+16.6 MB of maps).
//   Design: one thread per destination pixel, looping over the channels,
//   32x8 threads per block so a warp covers 32 neighbouring pixels of one
//   row: the map reads and output writes are coalesced, and the taps of a
//   warp fall in a few neighbouring source rows. The TPU kernel's (8, 128)
//   chunks, candidate-row selects, lane rolls, DMA staging, capacity gate
//   and rot90 / integer pre-shear exist only because the TPU gathers at
//   scalar rate; a per-pixel sampler takes every map directly.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int FORM_DATA = 0;
constexpr int FORM_AFFINE = 1;
constexpr int FORM_PERSP = 2;

struct Coefs {
  float c[9];
};

__device__ __forceinline__ float load(const uint8_t* p) { return (float)*p; }
__device__ __forceinline__ float load(const float* p) { return *p; }

__device__ __forceinline__ void store(uint8_t* p, float v) {
  int r = __float2int_rn(v);
  r = r < 0 ? 0 : (r > 255 ? 255 : r);
  *p = (uint8_t)r;
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }

__device__ __forceinline__ float clipf(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

__device__ __forceinline__ float affine(float a, float b, float c, float gx,
                                        float gy) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, gx), __fmul_rn(b, gy)), c);
}

template <typename T, int FORM>
__global__ void remap_kernel(const T* __restrict__ src, int h, int w, int c,
                             T* __restrict__ out, int ho, int wo,
                             const float* __restrict__ mx,
                             const float* __restrict__ my, Coefs k,
                             int nearest, int border, float fill) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= wo || y >= ho) return;
  const size_t o = (size_t)y * wo + x;
  float sx, sy;
  if (FORM == FORM_DATA) {
    sx = mx[o];
    sy = my[o];
  } else {
    const float gx = (float)x, gy = (float)y;
    sx = affine(k.c[0], k.c[1], k.c[2], gx, gy);
    sy = affine(k.c[3], k.c[4], k.c[5], gx, gy);
    if (FORM == FORM_PERSP) {
      float den = affine(k.c[6], k.c[7], k.c[8], gx, gy);
      if (fabsf(den) < 1e-8f) den = 1e-8f;
      sx = __fdiv_rn(sx, den);
      sy = __fdiv_rn(sy, den);
    }
  }
  if (border) {
    sx = clipf(sx, 0.f, (float)(w - 1));
    sy = clipf(sy, 0.f, (float)(h - 1));
  }
  if (nearest) {
    sx = floorf(__fadd_rn(sx, 0.5f));
    sy = floorf(__fadd_rn(sy, 0.5f));
  }
  sx = clipf(sx, -1.5f, (float)w + 0.5f);
  sy = clipf(sy, -1.5f, (float)h + 0.5f);

  const float x0 = floorf(sx), y0 = floorf(sy);
  const float fx = __fsub_rn(sx, x0), fy = __fsub_rn(sy, y0);
  const float gx0 = __fsub_rn(1.f, fx), gy0 = __fsub_rn(1.f, fy);
  const float w00 = __fmul_rn(gx0, gy0), w01 = __fmul_rn(fx, gy0);
  const float w10 = __fmul_rn(gx0, fy), w11 = __fmul_rn(fx, fy);
  const int ix = (int)x0, iy = (int)y0;
  const bool vx0 = ix >= 0 && ix <= w - 1;
  const bool vx1 = ix + 1 >= 0 && ix + 1 <= w - 1;
  const bool vy0 = iy >= 0 && iy <= h - 1;
  const bool vy1 = iy + 1 >= 0 && iy + 1 <= h - 1;
  // signed offsets: a tap outside the image is never read
  const long long i00 = ((long long)iy * w + ix) * c;
  const long long i10 = i00 + (long long)w * c;
  T* dst = out + o * c;
  for (int ch = 0; ch < c; ++ch) {
    const float v00 = (vy0 && vx0) ? load(src + i00 + ch) : fill;
    const float v01 = (vy0 && vx1) ? load(src + i00 + c + ch) : fill;
    const float v10 = (vy1 && vx0) ? load(src + i10 + ch) : fill;
    const float v11 = (vy1 && vx1) ? load(src + i10 + c + ch) : fill;
    float acc = __fmul_rn(v00, w00);
    acc = __fadd_rn(acc, __fmul_rn(v01, w01));
    acc = __fadd_rn(acc, __fmul_rn(v10, w10));
    acc = __fadd_rn(acc, __fmul_rn(v11, w11));
    store(dst + ch, acc);
  }
}

template <typename T>
int launch(const void* src, int h, int w, int c, void* out, int ho, int wo,
           int form, const void* mx, const void* my, Coefs k, int nearest,
           int border, float fill, cudaStream_t stream) {
  dim3 block(32, 8);
  dim3 grid((wo + 31) / 32, (ho + 7) / 8);
  const T* s = (const T*)src;
  T* d = (T*)out;
  const float* fx = (const float*)mx;
  const float* fy = (const float*)my;
  switch (form) {
    case FORM_DATA:
      remap_kernel<T, FORM_DATA><<<grid, block, 0, stream>>>(
          s, h, w, c, d, ho, wo, fx, fy, k, nearest, border, fill);
      break;
    case FORM_AFFINE:
      remap_kernel<T, FORM_AFFINE><<<grid, block, 0, stream>>>(
          s, h, w, c, d, ho, wo, fx, fy, k, nearest, border, fill);
      break;
    case FORM_PERSP:
      remap_kernel<T, FORM_PERSP><<<grid, block, 0, stream>>>(
          s, h, w, c, d, ho, wo, fx, fy, k, nearest, border, fill);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// src: (h, w, c) u8 (is_u8 != 0) or f32; out: (ho, wo, c) of the same type.
// mx/my: (ho, wo) f32 for form 0, unused otherwise; coefs: 9 host floats.
extern "C" int kt_remap(const void* src, int is_u8, int h, int w, int c,
                        void* out, int ho, int wo, int form, const void* mx,
                        const void* my, const float* coefs, int nearest,
                        int border, float fill, void* stream) {
  if (ho == 0 || wo == 0 || c == 0) return 0;
  Coefs k;
  for (int i = 0; i < 9; ++i) k.c[i] = coefs[i];
  cudaStream_t s = (cudaStream_t)stream;
  if (is_u8)
    return launch<uint8_t>(src, h, w, c, out, ho, wo, form, mx, my, k,
                           nearest, border, fill, s);
  return launch<float>(src, h, w, c, out, ho, wo, form, mx, my, k, nearest,
                       border, fill, s);
}
