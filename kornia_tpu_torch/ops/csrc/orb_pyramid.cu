// K12: ORB's image pyramid, every level >= 1 of a frame in one launch
// (kt_orb_pyramid). Level i is the bilinear resize of level i - 1 to
// (round(H / s^i), round(W / s^i)), rounded to u8: ORB-SLAM's chain, each
// level from the one before it.
//
// Replaces: no TPU kernel. The JAX package resizes in XLA einsums
//   (kornia_tpu/ops/resize.py:177-178); the port's plain chain
//   (ops/pyramid.py::scale_pyramid over ops/resize.py::resize) is, per
//   level, a cast to f32, two dense band-matrix products Wy @ img @ Wx^T
//   (cuBLAS), a round, a clamp and a cast back: ~7 launches a level, 49 at
//   KITTI's 8 levels, each 15-20 us of host time, and 2.5 GFLOP of products
//   for under 4 M useful f32 operations. This kernel exists to take those
//   launches off the host.
//
// Contract: byte-equal to that chain on the card. A row of
//   resize._resize_matrix(n_in, n_out, "bilinear", False) has one or two
//   non-zero f32 weights; the wrapper reads them off the matrix
//   (cuda_kernels.py::_resize_taps: (i0, w0) and (i1, w1), i0 < i1, or
//   i1 = i0 and w1 = 0 for a row of one). The library's f32 product sums
//   over k ascending from 0 in one FMA chain, and zero terms leave a chain
//   exact, except where the kernel it picks for the product's shapes
//   splits the sum (split-K slices, a k tile's partial sums, a small-N
//   reduction): where the split falls between an output's two taps it
//   adds their two rounded products. So each pass is, per output,
//     v = fma(w1, x[i1], w0 * x[i0])         (one chain; w1 = 0 adds 0)
//     v = w0 * x[i0] + w1 * x[i1]            (split: the high bit of i1)
//   which of the two the wrapper reads once per frame shape from the
//   chain's own products (features/orb.py::pyramid_sum_order); the rows
//   first (Wy @ img: the source rows y0, y1 at each column), then the
//   columns of those f32 values (@ Wx^T), each product, FMA and sum
//   rounded on its own (__fmul_rn, __fmaf_rn, __fadd_rn; the file is built
//   with -fmad=false), then rintf (half to even, as torch.round) and a
//   clamp to [0, 255].
//
// Bound on H100: bytes, barely. 4 f32 operations an output pixel (977,481
//   at KITTI's 8 levels: 0.12 us at 33.5e12/s); the frame read once and
//   every level written once, 1.44 MB (0.43 us at 3.35 TB/s). What is left
//   is the launch and the dependency chain: level i reads level i - 1
//   after its u8 rounding.
//
// Design: one cooperative launch (cudaLaunchCooperativeKernel), its grid
//   no larger than fits on the card at once and than the largest level
//   needs; a grid-stride loop over each level's output and grid.sync()
//   between levels (n - 2 barriers for n levels). A thread writes 4
//   adjacent bytes of a level (its flat output, rows wrapping) with one
//   4-byte store: each level starts on a 16-byte boundary of the buffer
//   and is padded to it. 4 bytes beat 8 and 16 a thread (on an H100: 23.5
//   against 36.2 and 52.2 us at KITTI's 8 levels): the time is each
//   thread's loads from L2, not the barriers (one level alone 3.5 us). A thread recomputes the two row-pass values each
//   output needs in registers (the same bits every time), so no f32 value
//   goes to memory; the u8 source rows are read through L2 (__ldcg: a
//   level written by other blocks before the barrier is not served from a
//   stale L1), the tap tables through the read-only cache.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_LEVELS = 32;     // a launch's levels, its source included
constexpr int THREADS = 256;
constexpr int CHUNK = 4;           // output bytes a thread writes at once
constexpr int MAX_DEVICES = 64;

struct PyrStep {
  const uint8_t* src;   // level i - 1: (h_prev, sw) u8
  uint8_t* dst;         // level i: (h, w) u8, 4-byte aligned, padded to 4
  const int4* ytab;     // h rows: (y0, y1 | order, bits of wy0, wy1)
  const int4* xtab;     // w columns: (x0, x1 | order, bits of wx0, wx1)
  int h, w, sw;
  int chunks;           // ceil(h * w / CHUNK)
};

struct PyrTable {
  PyrStep s[MAX_LEVELS - 1];
  int n;                // resized levels
};

constexpr int SPLIT = (int)0x80000000u;   // a tap row's order bit, on i1

// one output of a pass from its two taps, in the product's order
__device__ __forceinline__ float two_taps(float x0, float x1, float w0,
                                          float w1, bool split) {
  const float first = __fmul_rn(w0, x0);
  return split ? __fadd_rn(first, __fmul_rn(w1, x1))
               : __fmaf_rn(w1, x1, first);
}

__global__ void __launch_bounds__(THREADS)
orb_pyramid_kernel(const PyrTable t) {
  cg::grid_group grid = cg::this_grid();
  const int stride = gridDim.x * THREADS;
  for (int l = 0; l < t.n; ++l) {
    if (l > 0) grid.sync();
    // the level's fields one by one: a reference to the parameter table
    // could make the compiler copy all of it to local memory
    const uint8_t* src = t.s[l].src;
    uint8_t* dst = t.s[l].dst;
    const int4* ytab = t.s[l].ytab;
    const int4* xtab = t.s[l].xtab;
    const int h = t.s[l].h, w = t.s[l].w, sw = t.s[l].sw;
    const int chunks = t.s[l].chunks;
    for (int c = blockIdx.x * THREADS + threadIdx.x; c < chunks;
         c += stride) {
      const int p = c * CHUNK;
      int oy = p / w;
      int ox = p - oy * w;
      uint32_t word = 0;
#pragma unroll
      for (int k = 0; k < CHUNK; ++k) {
        uint32_t v = 0;
        if (oy < h) {
          const int4 ty = __ldg(ytab + oy);
          const int4 tx = __ldg(xtab + ox);
          const uint8_t* r0 = src + (size_t)ty.x * sw;
          const uint8_t* r1 = src + (size_t)(ty.y & ~SPLIT) * sw;
          const int x0 = tx.x, x1 = tx.y & ~SPLIT;
          const float wy0 = __int_as_float(ty.z), wy1 = __int_as_float(ty.w);
          const bool sy = ty.y & SPLIT;
          // the rows pass at the two source columns, then the columns pass
          const float a = two_taps((float)__ldcg(r0 + x0),
                                   (float)__ldcg(r1 + x0), wy0, wy1, sy);
          const float b = two_taps((float)__ldcg(r0 + x1),
                                   (float)__ldcg(r1 + x1), wy0, wy1, sy);
          const float o = two_taps(a, b, __int_as_float(tx.z),
                                   __int_as_float(tx.w), tx.y & SPLIT);
          v = (uint32_t)fminf(fmaxf(rintf(o), 0.f), 255.f);
        }
        word |= v << (8 * k);
        if (++ox == w) {
          ox = 0;
          ++oy;
        }
      }
      *reinterpret_cast<uint32_t*>(dst + p) = word;
    }
  }
}

}  // namespace

// n levels (2 <= n <= 32): hs[i], ws[i] their shapes, level 0 the source
// `src` (any alignment), level i >= 1 at byte offset offs[i - 1] of `dst`
// (a multiple of 16 from a 16-byte aligned base, padded to 16 bytes);
// taps: int4 rows (i0, i1 with the order bit, w0, w1), level i's row
// table at row ytabs[i - 1] and its column table at xtabs[i - 1]. Every
// level must be non-empty.
extern "C" int kt_orb_pyramid(int n, const int* hs, const int* ws,
                              const long long* offs, const int* ytabs,
                              const int* xtabs, const void* src, void* dst,
                              const void* taps, void* stream) {
  if (n < 2 || n > MAX_LEVELS) return (int)cudaErrorInvalidValue;
  PyrTable t;
  t.n = n - 1;
  int most = 0;
  for (int i = 1; i < n; ++i) {
    if (hs[i - 1] < 1 || ws[i - 1] < 1 || hs[i] < 1 || ws[i] < 1)
      return (int)cudaErrorInvalidValue;
    PyrStep& s = t.s[i - 1];
    s.src = i == 1 ? (const uint8_t*)src : (const uint8_t*)dst + offs[i - 2];
    s.dst = (uint8_t*)dst + offs[i - 1];
    if ((uintptr_t)s.dst % CHUNK) return (int)cudaErrorMisalignedAddress;
    s.ytab = (const int4*)taps + ytabs[i - 1];
    s.xtab = (const int4*)taps + xtabs[i - 1];
    s.h = hs[i];
    s.w = ws[i];
    s.sw = ws[i - 1];
    const long long px = (long long)hs[i] * ws[i];
    s.chunks = (int)((px + CHUNK - 1) / CHUNK);
    most = s.chunks > most ? s.chunks : most;
  }
  // the most blocks that fit on the card at once, read once per device
  static int resident[MAX_DEVICES];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (resident[dev] == 0) {
    int per_sm = 0, sms = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, orb_pyramid_kernel, THREADS, 0);
    if (e != cudaSuccess) return (int)e;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    if (per_sm * sms < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
    resident[dev] = per_sm * sms;
  }
  int blocks = (most + THREADS - 1) / THREADS;
  blocks = blocks < resident[dev] ? blocks : resident[dev];
  void* args[] = {&t};
  e = cudaLaunchCooperativeKernel((const void*)orb_pyramid_kernel,
                                  dim3(blocks), dim3(THREADS), args, 0,
                                  (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
