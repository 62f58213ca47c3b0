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
//     c6*x + c7*y + c8, whose magnitude is clamped to >= 1e-8. The nine
//     coefficients come by value from the host or are read from device
//     memory, so a matrix made on the card never has to be waited for;
//   - border padding clips (sx, sy) to [0, w-1] x [0, h-1]; nearest mode
//     rounds with floor(s + 0.5); then both are clipped to
//     [-1.5, w+0.5] x [-1.5, h+0.5] (only fully outside samples move);
//   - bilinear taps at floor(s), weights (1-fx)(1-fy), fx(1-fy),
//     (1-fx)fy, fx*fy, summed in grid_sample's tap order (dy, dx) =
//     (0,0), (0,1), (1,0), (1,1); a tap outside the image reads `fill`
//     and is never loaded;
//   - u8 output is round-half-to-even (__float2int_rn) then clamped to
//     [0, 255]; f32 output is stored as is.
//   Every multiply and add is a separately rounded f32 op
//   (__fmul_rn/__fadd_rn, and the file is built with -fmad=false), so the
//   kernel is bit-equal to the plain PyTorch version
//   (kornia_tpu_torch/ops/cuda_kernels.py::_remap_plain) on the same inputs.
//
// Bound on H100: memory. Per destination pixel it writes C values and, on
//   FORM_DATA, reads 8 bytes of map; the four taps of neighbouring pixels
//   overlap, so a smooth map needs each source value about once. At 1080p
//   RGB u8 that is ~12.4 MB (+16.6 MB of maps), 0.003-0.008 ms at
//   3.35 TB/s; every image here is under the 50 MB L2.
//
// What the first design lost: one thread per destination pixel, so one
//   dependent chain (map load -> address -> four taps -> store) per thread;
//   a loop over the channels of single-byte stores (a warp's store covered
//   32 bytes of a u8 C=1 row, and u8 C=3 took three strided byte stores
//   per thread); coefficients only from the host.
//
// Design: one warp per destination row of a 128 x 8 tile, 256 threads.
//   Lane l owns the four pixels x0 + l, l + 32, l + 64, l + 96 of its row:
//   four independent chains per thread, and every warp-wide load covers 32
//   neighbouring pixels of one row, so map reads are coalesced and the
//   taps of one load fall in a few neighbouring source rows, under any
//   rotation.
//   - C = 1 and 3: the warp writes its row's results to a shared-memory
//     tile and then copies the row out on consecutive 32-bit words, lane
//     after lane (u8 C=1: 128 bytes a store instead of 32; u8 C=3: no
//     strided byte stores). A u8 row that does not start on a 4-byte
//     boundary and the ragged right edge are copied value by value, other
//     channel counts are stored directly, all in the same kernel.
//   - The taps are read with __ldg. Two other forms were measured on the
//     H100 at 1080p RGB u8 and 480 x 752 u8 and lost, so they are gone:
//     four *consecutive* pixels per thread with packed stores (a warp's
//     load then spans 2 rows x 64 pixels: 0.048 ms against 0.023 ms at a
//     30 degree rotation), and staging the bounding box of a tile's taps
//     in shared memory with 16-byte cp.async (0.021-0.026 ms against
//     0.017-0.031 ms without: slower at nine of the ten shapes, and its
//     32 KB of shared memory a block cost the other path occupancy).
//     PERF.md has the table.
//   The kernel is bound by instruction issue and latency, not bytes: the
//   contract's separately rounded products and sums, twelve u8 loads and
//   conversions and three roundings per RGB pixel are ~60 instructions.
//   The TPU kernel's (8, 128) chunks, candidate-row selects, lane rolls,
//   DMA staging, capacity gate and rot90 / integer pre-shear exist only
//   because the TPU gathers at scalar rate; a per-pixel sampler takes
//   every map directly.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int FORM_DATA = 0;
constexpr int FORM_AFFINE = 1;
constexpr int FORM_PERSP = 2;

// Other counts of pixels a thread and rows a block were tried on the H100
// and were no faster.
constexpr int PPT = 4;                 // destination pixels per thread
constexpr int TILE_W = 32 * PPT;       // lane l owns x = l, l+32, l+64, ...
constexpr int TILE_H = 8;              // one warp per destination row
constexpr int THREADS = 32 * TILE_H;

struct Args {
  int h, w, c, ho, wo;
  const float* mx;
  const float* my;
  float k[9];
  const float* kdev;   // nine coefficients in device memory, or null
  int nearest, border;
  float fill;
};

__device__ __forceinline__ float to_float(uint8_t v) { return (float)v; }
__device__ __forceinline__ float to_float(float v) { return v; }

__device__ __forceinline__ void convert(float v, uint8_t* o) {
  int r = __float2int_rn(v);
  r = r < 0 ? 0 : (r > 255 ? 255 : r);
  *o = (uint8_t)r;
}
__device__ __forceinline__ void convert(float v, float* o) { *o = v; }

__device__ __forceinline__ float clipf(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

__device__ __forceinline__ float affine(float a, float b, float c, float gx,
                                        float gy) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, gx), __fmul_rn(b, gy)), c);
}

// The C channels of the pixel at clamped source coordinate (sx, sy), each
// in the plain version's order of operations; a tap outside the image is
// `fill` and is not loaded. `dst` gets C (or, for C = 0, c) values.
template <typename T, int C>
__device__ __forceinline__ void sample(const T* __restrict__ src, int h,
                                       int w, int c, float sx, float sy,
                                       float fill, T* dst) {
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
#pragma unroll
  for (int ch = 0; ch < (C ? C : c); ++ch) {
    const float v00 = (vy0 && vx0) ? to_float(__ldg(src + i00 + ch)) : fill;
    const float v01 =
        (vy0 && vx1) ? to_float(__ldg(src + i00 + c + ch)) : fill;
    const float v10 = (vy1 && vx0) ? to_float(__ldg(src + i10 + ch)) : fill;
    const float v11 =
        (vy1 && vx1) ? to_float(__ldg(src + i10 + c + ch)) : fill;
    float acc = __fmul_rn(v00, w00);
    acc = __fadd_rn(acc, __fmul_rn(v01, w01));
    acc = __fadd_rn(acc, __fmul_rn(v10, w10));
    acc = __fadd_rn(acc, __fmul_rn(v11, w11));
    convert(acc, dst + ch);
  }
}

// C = 1 or 3 at compile time; C = 0 takes any channel count at run time.
template <typename T, int FORM, int C>
__global__ void __launch_bounds__(THREADS)
remap_kernel(const T* __restrict__ src, T* __restrict__ out, Args a) {
  __shared__ __align__(16) T otile[TILE_H * TILE_W * (C ? C : 1)];
  const int c = C ? C : a.c;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int x0 = blockIdx.x * TILE_W;      // the tile's first column
  const int y = blockIdx.y * TILE_H + warp;
  if (y >= a.ho) return;                   // warps never wait for each other

  float k[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) k[i] = a.k[i];
  if (FORM != FORM_DATA && a.kdev != nullptr) {
#pragma unroll
    for (int i = 0; i < 9; ++i) k[i] = __ldg(a.kdev + i);
  }

  float sx[PPT], sy[PPT];
  bool valid[PPT];
#pragma unroll
  for (int p = 0; p < PPT; ++p) {
    const int x = x0 + lane + 32 * p;
    valid[p] = x < a.wo;
    sx[p] = 0.f;
    sy[p] = 0.f;
    if (FORM == FORM_DATA) {
      if (valid[p]) {
        sx[p] = __ldg(a.mx + (size_t)y * a.wo + x);
        sy[p] = __ldg(a.my + (size_t)y * a.wo + x);
      }
    } else {
      const float gx = (float)x, gy = (float)y;
      sx[p] = affine(k[0], k[1], k[2], gx, gy);
      sy[p] = affine(k[3], k[4], k[5], gx, gy);
      if (FORM == FORM_PERSP) {
        float den = affine(k[6], k[7], k[8], gx, gy);
        if (fabsf(den) < 1e-8f) den = 1e-8f;
        sx[p] = __fdiv_rn(sx[p], den);
        sy[p] = __fdiv_rn(sy[p], den);
      }
    }
    if (a.border) {
      sx[p] = clipf(sx[p], 0.f, (float)(a.w - 1));
      sy[p] = clipf(sy[p], 0.f, (float)(a.h - 1));
    }
    if (a.nearest) {
      sx[p] = floorf(__fadd_rn(sx[p], 0.5f));
      sy[p] = floorf(__fadd_rn(sy[p], 0.5f));
    }
    sx[p] = clipf(sx[p], -1.5f, (float)a.w + 0.5f);
    sy[p] = clipf(sy[p], -1.5f, (float)a.h + 0.5f);
  }

  T* grow = out + ((size_t)y * a.wo + x0) * c;   // this warp's row, global
  if (C == 0) {                                  // any channel count
    for (int p = 0; p < PPT; ++p)
      if (valid[p])
        sample<T, 0>(src, a.h, a.w, c, sx[p], sy[p], a.fill,
                     grow + (size_t)(lane + 32 * p) * c);
    return;
  }
  T* orow = otile + warp * TILE_W * c;           // and in shared memory
#pragma unroll
  for (int p = 0; p < PPT; ++p)
    if (valid[p])
      sample<T, C>(src, a.h, a.w, c, sx[p], sy[p], a.fill,
                   orow + (lane + 32 * p) * c);
  __syncwarp();
  const int n = min(TILE_W, a.wo - x0) * c;      // values of this row
  if (sizeof(T) == 1 && ((uintptr_t)grow & 3) == 0) {
    const uint32_t* o32 = reinterpret_cast<const uint32_t*>(orow);
    uint32_t* g32 = reinterpret_cast<uint32_t*>(grow);
    for (int i = lane; i < n / 4; i += 32) g32[i] = o32[i];
    for (int i = (n & ~3) + lane; i < n; i += 32) grow[i] = orow[i];
  } else {
    for (int i = lane; i < n; i += 32) grow[i] = orow[i];
  }
}

template <typename T, int FORM>
void launch_c(const T* src, T* out, const Args& a, cudaStream_t stream) {
  dim3 block(THREADS);
  dim3 grid((a.wo + TILE_W - 1) / TILE_W, (a.ho + TILE_H - 1) / TILE_H);
  if (a.c == 1)
    remap_kernel<T, FORM, 1><<<grid, block, 0, stream>>>(src, out, a);
  else if (a.c == 3)
    remap_kernel<T, FORM, 3><<<grid, block, 0, stream>>>(src, out, a);
  else
    remap_kernel<T, FORM, 0><<<grid, block, 0, stream>>>(src, out, a);
}

template <typename T>
int launch(const void* src, void* out, const Args& a, int form,
           cudaStream_t stream) {
  const T* s = (const T*)src;
  T* d = (T*)out;
  switch (form) {
    case FORM_DATA:
      launch_c<T, FORM_DATA>(s, d, a, stream);
      break;
    case FORM_AFFINE:
      launch_c<T, FORM_AFFINE>(s, d, a, stream);
      break;
    case FORM_PERSP:
      launch_c<T, FORM_PERSP>(s, d, a, stream);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// src: (h, w, c) u8 (is_u8 != 0) or f32; out: (ho, wo, c) of the same type.
// mx/my: (ho, wo) f32 for form 0, unused otherwise. coefs: 9 host floats;
// coefs_dev: the same nine in device memory, read by the kernel instead
// when it is not null.
extern "C" int kt_remap(const void* src, int is_u8, int h, int w, int c,
                        void* out, int ho, int wo, int form, const void* mx,
                        const void* my, const float* coefs,
                        const void* coefs_dev, int nearest, int border,
                        float fill, void* stream) {
  if (ho == 0 || wo == 0 || c == 0) return 0;
  Args a;
  a.h = h;
  a.w = w;
  a.c = c;
  a.ho = ho;
  a.wo = wo;
  a.mx = (const float*)mx;
  a.my = (const float*)my;
  for (int i = 0; i < 9; ++i) a.k[i] = coefs[i];
  a.kdev = (const float*)coefs_dev;
  a.nearest = nearest;
  a.border = border;
  a.fill = fill;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_u8) return launch<uint8_t>(src, out, a, form, s);
  return launch<float>(src, out, a, form, s);
}
