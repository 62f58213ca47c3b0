// FAST-9 score + threshold + 3-px border kill + 3x3 NMS, and the dense
// Harris map (central gradients, 5-tap Gaussian window), in one pass over
// every level of an image pyramid: one launch per frame (kt_fast_harris).
// The same kernel, without its Harris phases, is the score-only entry
// kt_fast_score: one level, the NMS optional, an optional f32 ROI mask, and
// any arc length n in [1, 16] (FAST-n).
//
// Replaces: kornia_tpu/ops/pallas_kernels.py::fast_score_pallas in every
//   compiled form the JAX package reaches: (nms=True, harris=True), called
//   once per pyramid level by ORB (kornia_tpu/features/orb.py:458), and
//   (nms, border_mask, harris=False), reached through features/fast.py's
//   _score_dispatch, _score_nms_dispatch, fast_detect and _two_tier_select,
//   at every static arc_length (pallas_kernels.py:141-144: each value is its
//   own compiled kernel; the caller maps n to [1, 16], see kt_fast_score).
//
// Mask contract (kt_fast_score): the XLA path's (fast.py:158-162), not the
//   Pallas path's: the score keeps the threshold and the 3-px border kill
//   and is then multiplied by the mask, before the NMS, so the result is
//   bit-equal to nms_maxpool(fast_score(img, thr) * mask) (or the product
//   alone without the NMS) for any finite mask. Outside the image the
//   pool reads -inf, as max_pool2d's padding does, so a negative mask
//   value pools as it does there.
//
// Contract: bit-equal, on every level, to the plain PyTorch composition
//   nms_maxpool(fast_score(img, thr)) and
//   harris_response(img, grad="central", block 5, sigma 1)
//   (kornia_tpu_torch/ops/cuda_kernels.py::_fast_harris_plain), at EVERY
//   pixel: the Harris map uses the reference padding (edge-replicated
//   gradients, reflect-101 window; responses.py:22-25, filters.py:22-27),
//   not the Pallas kernel's zero padding, and every multiply and add is a
//   separately rounded float32 op in the plain version's order (vertical
//   taps ascending, then horizontal, first term assigned; det - (k*tr)*tr).
//   __fmul_rn/__fadd_rn keep nvcc from contracting them into FMAs (the file
//   is also built with -fmad=false). ORB quantizes Harris to 13 bits before
//   ranking, so one ULP could move a keypoint across a bucket.
//
// Bound on H100: integer operations. Per pixel it reads 1 byte and writes
//   8 (two f32 maps), while the FAST function needs 99 integer ops (16
//   ring differences, 80 three-way min/max for the 9-of-16 arcs and their
//   reductions, 3 for the score) and the NMS and Harris ~76 f32 ops;
//   integer ops issue at 64 per SM per clock, half the f32 rate, so the
//   integer count is the bound.
//
// Design.
// - One launch for all levels: the levels' tiles are flattened into one 1-D
//   grid, largest level first (the caller's order), so the 1182 tiles of a
//   480x752 pyramid fill about two waves instead of one partial wave per
//   level. The level table (pointer, output offset, size, first block) goes
//   by value in the kernel parameters: nothing is copied to the device.
// - One 256-thread block per 32x32 output tile (32x16 tiles took more
//   device time: more halo per output). The u8 tile with a 4-px
//   halo (3 for the ring, 1 for the NMS) is staged in shared memory once;
//   the FAST score of the tile plus a 1-px ring, the three gradient
//   products of the tile plus a 2-px ring and the vertical window pass all
//   live in shared memory, so global memory sees one read of the image and
//   one write of each output.
// - The arc test with Hopper's three-way integer min/max (DPX,
//   __vimin3_s32 / __vimax3_s32): the 16 arcs of 3, then the 16 arcs of 9
//   as three arcs of 3, then the best: 39 three-way ops and one two-way
//   op per side, where 16 arcs x 8 two-way ops + 15 were the direct form
//   (a doubling form, min/max of 2, 4, 8 and 9 values, took more device
//   time). Min and max are exact, so the
//   score is the one the plain version computes. (An exact early exit on
//   the compass points, ring 0, 4, 8, 12, with the remaining pixels listed
//   for the arc test or tested in place, was slower on the H100 in every
//   tile shape tried: the arc test costs less than the exit's test and the
//   divergence or the list.)
// - Other arc lengths (score-only entry): the arcs of n are built the same
//   way, three overlapping arcs of c = ceil(n/3) each (arc_reduce below),
//   down to arcs of 1, 2 or 3; n = 9 keeps the form above. Integer ops per
//   pixel: 16 differences; per side 16 min/max ops (one instruction each,
//   two- or three-way) per level of arcs (none for n = 1, one for n = 2-3,
//   two for n = 4-9, three for n = 10-16) and 8 for the best arc; 3 for the
//   score: 35, 67, 99 or 131.
// - Tiles at least 4 px inside their level take a path without the
//   reflect-101 and clamp index arithmetic that the border tiles need.
// - The window passes keep what a thread reuses in registers: 8 rows of a
//   column for the vertical pass, two neighbouring outputs (8-byte shared
//   loads) for the horizontal pass and the NMS.
// The kernel is bound by latency more than by issue: a few hundred
// instructions a pixel in four barrier-separated phases, about two waves.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TW = 32;          // output tile width
constexpr int TH = 32;          // output tile height
constexpr int HALO = 4;         // 3 (ring) + 1 (NMS)
constexpr int IW = TW + 2 * HALO;
constexpr int IH = TH + 2 * HALO;
constexpr int SW = TW + 2;      // score tile with the NMS ring
constexpr int SH = TH + 2;
constexpr int PW = TW + 4;      // gradient products with the window ring
constexpr int PH = TH + 4;
constexpr int NTHR = 256;
constexpr int MAX_LEVELS = 16;

struct Level {
  const uint8_t* img;
  const float* mask;            // (h, w) ROI multiplier, or null
  long long out_off;            // first element of the level in the outputs
  int h, w;
  int first_block;              // first block of the level in the grid
  int tiles_x;
};

struct LevelTable {
  Level lv[MAX_LEVELS];
  int n;
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// reflected about the end pixels as often as needed (numpy's "reflect"):
// levels of 1 and 2 px too
__device__ __forceinline__ int reflect101(int i, int n) {
  if (n == 1) return 0;
  const int period = 2 * (n - 1);
  i %= period;
  if (i < 0) i += period;
  return i > n - 1 ? period - i : i;
}

// min (MIN) or max of three ring values
template <bool MIN>
__device__ __forceinline__ int op3(int a, int b, int c) {
  return MIN ? __vimin3_s32(a, b, c) : __vimax3_s32(a, b, c);
}

// out[k] = min (MIN) or max over the N ring entries k, k+1, ..., k+N-1
// (mod 16) of a[], for 1 <= N <= 16: from the arcs of c = ceil(N/3),
// three of them starting at k, k+s and k+N-c, which cover the N entries
// as s <= c and N-c-s <= c; arcs of 2 and 3 come straight from a[]. Min
// and max are exact, so any cover gives the plain version's value.
template <int N, bool MIN>
__device__ __forceinline__ void arc_reduce(const int a[16], int out[16]) {
  if constexpr (N == 1) {
#pragma unroll
    for (int k = 0; k < 16; ++k) out[k] = a[k];
  } else if constexpr (N == 2) {
#pragma unroll
    for (int k = 0; k < 16; ++k)
      out[k] = MIN ? min(a[k], a[(k + 1) & 15]) : max(a[k], a[(k + 1) & 15]);
  } else if constexpr (N == 3) {
#pragma unroll
    for (int k = 0; k < 16; ++k)
      out[k] = op3<MIN>(a[k], a[(k + 1) & 15], a[(k + 2) & 15]);
  } else {
    constexpr int C = (N + 2) / 3;
    constexpr int S = (N - C) / 2;
    int sub[16];
    arc_reduce<C, MIN>(a, sub);
#pragma unroll
    for (int k = 0; k < 16; ++k)
      out[k] = op3<MIN>(sub[k], sub[(k + S) & 15], sub[(k + N - C) & 15]);
  }
}

// the best (largest for MIN arcs, smallest for MAX arcs) of 16 values
template <bool MIN>
__device__ __forceinline__ int best16(const int v[16]) {
  int t[5];
#pragma unroll
  for (int k = 0; k < 5; ++k)
    t[k] = op3<!MIN>(v[3 * k], v[3 * k + 1], v[3 * k + 2]);
  const int a = op3<!MIN>(t[0], t[1], t[2]);
  const int b = op3<!MIN>(t[3], t[4], v[15]);
  return MIN ? max(a, b) : min(a, b);
}

// FAST-N score of the staged pixel (cy, cx): the best N-arc minimum
// (brighter) or maximum (darker) of the 16 ring differences, 0 unless
// above the threshold
template <int N>
__device__ __forceinline__ float fast_score(const int (*s_img)[IW], int cy,
                                            int cx, float threshold) {
  int ctr = s_img[cy][cx];
  int d[16];
#define RING(j, dy, dx) d[j] = s_img[cy + (dy)][cx + (dx)] - ctr;
  RING(0, -3, 0) RING(1, -3, 1) RING(2, -2, 2) RING(3, -1, 3)
  RING(4, 0, 3) RING(5, 1, 3) RING(6, 2, 2) RING(7, 3, 1)
  RING(8, 3, 0) RING(9, 3, -1) RING(10, 2, -2) RING(11, 1, -3)
  RING(12, 0, -3) RING(13, -1, -3) RING(14, -2, -2) RING(15, -3, -1)
#undef RING
  int bright, darkmin;
  if constexpr (N == 9) {
    // arcs of 3, then of 9 = three arcs of 3, then the best of the 16:
    // Hopper's three-way integer min/max (DPX) do each step in one op
    int n3[16], x3[16], n9[16], x9[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      n3[k] = __vimin3_s32(d[k], d[(k + 1) & 15], d[(k + 2) & 15]);
      x3[k] = __vimax3_s32(d[k], d[(k + 1) & 15], d[(k + 2) & 15]);
    }
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      n9[k] = __vimin3_s32(n3[k], n3[(k + 3) & 15], n3[(k + 6) & 15]);
      x9[k] = __vimax3_s32(x3[k], x3[(k + 3) & 15], x3[(k + 6) & 15]);
    }
    int bt[5], dt[5];
#pragma unroll
    for (int k = 0; k < 5; ++k) {
      bt[k] = __vimax3_s32(n9[3 * k], n9[3 * k + 1], n9[3 * k + 2]);
      dt[k] = __vimin3_s32(x9[3 * k], x9[3 * k + 1], x9[3 * k + 2]);
    }
    // the best arc minimum (brighter) and the lowest arc maximum (darker)
    bright = max(__vimax3_s32(bt[0], bt[1], bt[2]),
                 __vimax3_s32(bt[3], bt[4], n9[15]));
    darkmin = min(__vimin3_s32(dt[0], dt[1], dt[2]),
                  __vimin3_s32(dt[3], dt[4], x9[15]));
  } else {
    int arc[16];
    arc_reduce<N, true>(d, arc);
    bright = best16<true>(arc);
    arc_reduce<N, false>(d, arc);
    darkmin = best16<false>(arc);
  }
  const int sc = bright > -darkmin ? bright : -darkmin;
  const float fs = (float)sc;
  return fs > threshold ? fs : 0.0f;
}

// one 5-tap window sum, first term assigned, taps ascending
__device__ __forceinline__ float window5(float v0, float v1, float v2,
                                         float v3, float v4, float k0,
                                         float k1, float k2, float k3,
                                         float k4) {
  float acc = __fmul_rn(v0, k0);
  acc = __fadd_rn(acc, __fmul_rn(v1, k1));
  acc = __fadd_rn(acc, __fmul_rn(v2, k2));
  acc = __fadd_rn(acc, __fmul_rn(v3, k3));
  return __fadd_rn(acc, __fmul_rn(v4, k4));
}

// det - (k*tr)*tr of the windowed products (xx, yy, xy)
__device__ __forceinline__ float harris(const float s[3], float harris_k) {
  const float det = __fsub_rn(__fmul_rn(s[0], s[1]), __fmul_rn(s[2], s[2]));
  const float tr = __fadd_rn(s[0], s[1]);
  return __fsub_rn(det, __fmul_rn(__fmul_rn(harris_k, tr), tr));
}

// HARRIS: also the Harris map (phases 3-4 and its half of phase 5);
// NMS: the 3x3 pool of the score, else the masked score as it is;
// ARC: the arc length n of the FAST-n score
template <bool HARRIS, bool NMS, int ARC>
__global__ void __launch_bounds__(NTHR)
fast_harris_kernel(const LevelTable tab, float* __restrict__ score_all,
                   float* __restrict__ harris_all, float threshold,
                   float k0, float k1, float k2, float k3, float k4,
                   float harris_k) {
  __shared__ int s_img[IH][IW];
  __shared__ __align__(16) float s_score[SH][SW];
  // the Harris buffers take no shared memory in the score-only forms
  __shared__ float s_p[HARRIS ? 3 : 1][HARRIS ? PH : 1][PW];
  __shared__ __align__(16) float s_v[HARRIS ? 3 : 1][HARRIS ? TH : 1][PW];

  const int tid = threadIdx.x;
  // the block's level: the last one whose first block is <= blockIdx.x;
  // its fields are read from the parameter bank by that index
  int li = 0;
#pragma unroll
  for (int i = 1; i < MAX_LEVELS; ++i)
    li += (i < tab.n) & ((int)blockIdx.x >= tab.lv[i].first_block);
  const Level& lv = tab.lv[li];
  const int h = lv.h, w = lv.w;
  const uint8_t* __restrict__ img = lv.img;
  const int local = (int)blockIdx.x - lv.first_block;
  const int y0 = (local / lv.tiles_x) * TH;
  const int x0 = (local % lv.tiles_x) * TW;
  const float* __restrict__ mask = lv.mask;
  float* __restrict__ score_out = score_all + lv.out_off;
  float* __restrict__ harris_out = HARRIS ? harris_all + lv.out_off
                                          : nullptr;
  const bool inner = x0 >= HALO && y0 >= HALO && x0 + TW + HALO <= w &&
                     y0 + TH + HALO <= h;

  // 1. image tile + 4-px halo, edge-clamped on border tiles (ring reads on
  //    the border are killed below; the gradients are edge-replicated, as
  //    the reference)
  if (inner) {
    const uint8_t* src = img + (size_t)(y0 - HALO) * w + (x0 - HALO);
    for (int i = tid; i < IH * IW; i += NTHR) {
      int r = i / IW, c = i - r * IW;
      s_img[r][c] = src[(size_t)r * w + c];
    }
  } else {
    for (int i = tid; i < IH * IW; i += NTHR) {
      int r = i / IW, c = i - r * IW;
      int gy = clampi(y0 - HALO + r, 0, h - 1);
      int gx = clampi(x0 - HALO + c, 0, w - 1);
      s_img[r][c] = img[(size_t)gy * w + gx];
    }
  }
  __syncthreads();

  // 2. FAST on the tile + 1-px ring: 0 on the 3-px border, times the
  //    mask where there is one, -inf outside the image (the pool padding)
  for (int i = tid; i < SH * SW; i += NTHR) {
    int r = i / SW, c = i - r * SW;
    int gy = y0 - 1 + r, gx = x0 - 1 + c;
    float v = -INFINITY;
    if (gy >= 0 && gy < h && gx >= 0 && gx < w) {
      v = (gy >= 3 && gy < h - 3 && gx >= 3 && gx < w - 3)
              ? fast_score<ARC>(s_img, r + HALO - 1, c + HALO - 1,
                                        threshold)
              : 0.0f;
      if (mask != nullptr) v = __fmul_rn(v, mask[(size_t)gy * w + gx]);
    }
    s_score[r][c] = v;
  }
  if (!HARRIS) __syncthreads();

  // 3. gradient products on the tile + 2-px ring; position (r, c) holds
  //    the product at image pixel reflect101(y0-2+r), reflect101(x0-2+c),
  //    with central gradients over edge-clamped neighbours
  if constexpr (HARRIS) {
  if (inner) {
    for (int i = tid; i < PH * PW; i += NTHR) {
      int r = i / PW, c = i - r * PW;
      int ty = r + 2, tx = c + 2;
      float gx = __fmul_rn(0.5f, (float)(s_img[ty][tx + 1] - s_img[ty][tx - 1]));
      float gy = __fmul_rn(0.5f, (float)(s_img[ty + 1][tx] - s_img[ty - 1][tx]));
      s_p[0][r][c] = __fmul_rn(gx, gx);
      s_p[1][r][c] = __fmul_rn(gy, gy);
      s_p[2][r][c] = __fmul_rn(gx, gy);
    }
  } else {
    for (int i = tid; i < PH * PW; i += NTHR) {
      int r = i / PW, c = i - r * PW;
      int iy = reflect101(y0 - 2 + r, h);
      int ix = reflect101(x0 - 2 + c, w);
      // image rows/cols -> staged tile coordinates (clamped for positions
      // that no written output reads)
      int ty = clampi(iy - (y0 - HALO), 1, IH - 2);
      int tx = clampi(ix - (x0 - HALO), 1, IW - 2);
      int ty_m = clampi(clampi(iy - 1, 0, h - 1) - (y0 - HALO), 0, IH - 1);
      int ty_p = clampi(clampi(iy + 1, 0, h - 1) - (y0 - HALO), 0, IH - 1);
      int tx_m = clampi(clampi(ix - 1, 0, w - 1) - (x0 - HALO), 0, IW - 1);
      int tx_p = clampi(clampi(ix + 1, 0, w - 1) - (x0 - HALO), 0, IW - 1);
      float gx = __fmul_rn(0.5f, (float)(s_img[ty][tx_p] - s_img[ty][tx_m]));
      float gy = __fmul_rn(0.5f, (float)(s_img[ty_p][tx] - s_img[ty_m][tx]));
      s_p[0][r][c] = __fmul_rn(gx, gx);
      s_p[1][r][c] = __fmul_rn(gy, gy);
      s_p[2][r][c] = __fmul_rn(gx, gy);
    }
  }
  __syncthreads();

  // 4. vertical window pass (taps ascending, first term assigned): a
  //    thread takes 8 rows of one column, its 12 products in registers
  for (int i = tid; i < 3 * (TH / 8) * PW; i += NTHR) {
    int m = i / ((TH / 8) * PW);
    int rem = i - m * ((TH / 8) * PW);
    int g = rem / PW, c = rem - g * PW;
    int r0 = g * 8;
    float p[12];
#pragma unroll
    for (int k = 0; k < 12; ++k) p[k] = s_p[m][r0 + k][c];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      s_v[m][r0 + j][c] = window5(p[j], p[j + 1], p[j + 2], p[j + 3],
                                  p[j + 4], k0, k1, k2, k3, k4);
  }
  __syncthreads();
  }  // HARRIS

  // 5. horizontal pass + Harris, and the 3x3 NMS of the score: a thread
  //    takes two neighbouring outputs from 8-byte shared loads
  for (int i = tid; i < TH * (TW / 2); i += NTHR) {
    int r = i / (TW / 2), c = (i - r * (TW / 2)) * 2;
    int gy = y0 + r, gx = x0 + c;
    if (gy >= h || gx >= w) continue;
    const size_t o = (size_t)gy * w + gx;
    if constexpr (HARRIS) {
      float s0[3], s1[3];
#pragma unroll
      for (int m = 0; m < 3; ++m) {
        const float2 a = *reinterpret_cast<const float2*>(&s_v[m][r][c]);
        const float2 b = *reinterpret_cast<const float2*>(&s_v[m][r][c + 2]);
        const float2 d = *reinterpret_cast<const float2*>(&s_v[m][r][c + 4]);
        s0[m] = window5(a.x, a.y, b.x, b.y, d.x, k0, k1, k2, k3, k4);
        s1[m] = window5(a.y, b.x, b.y, d.x, d.y, k0, k1, k2, k3, k4);
      }
      harris_out[o] = harris(s0, harris_k);
      if (gx + 1 < w) harris_out[o + 1] = harris(s1, harris_k);
    }
    const float sc0 = s_score[r + 1][c + 1];
    const float sc1 = s_score[r + 1][c + 2];
    if constexpr (NMS) {
      // 3x3 max of the score (exact, so in any order) around both outputs
      float p0 = -INFINITY, p1 = -INFINITY;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        const float2 a = *reinterpret_cast<const float2*>(&s_score[r + dy][c]);
        const float2 b =
            *reinterpret_cast<const float2*>(&s_score[r + dy][c + 2]);
        p0 = fmaxf(p0, fmaxf(fmaxf(a.x, a.y), b.x));
        p1 = fmaxf(p1, fmaxf(fmaxf(a.y, b.x), b.y));
      }
      score_out[o] = sc0 >= p0 ? sc0 : 0.0f;
      if (gx + 1 < w) score_out[o + 1] = sc1 >= p1 ? sc1 : 0.0f;
    } else {
      score_out[o] = sc0;
      if (gx + 1 < w) score_out[o + 1] = sc1;
    }
  }
}

}  // namespace

// n levels: imgs[i] an (hs[i], ws[i]) u8 image; level i's outputs are the
// hs[i]*ws[i] f32 values of score_out / harris_out after those of levels
// 0..i-1. Returns a cudaError_t (cudaErrorInvalidValue for n outside
// [1, 16]); launches nothing when every level is empty.
extern "C" int kt_fast_harris(int n, const void* const* imgs, const int* hs,
                              const int* ws, void* score_out,
                              void* harris_out, float threshold,
                              const float* window5, float harris_k,
                              void* stream) {
  if (n < 1 || n > MAX_LEVELS) return (int)cudaErrorInvalidValue;
  LevelTable tab = {};
  long long off = 0;
  int blocks = 0;
  for (int i = 0; i < n; ++i) {
    Level& L = tab.lv[i];
    L.img = (const uint8_t*)imgs[i];
    L.mask = nullptr;
    L.h = hs[i];
    L.w = ws[i];
    L.out_off = off;
    L.first_block = blocks;
    L.tiles_x = (ws[i] + TW - 1) / TW;
    if (hs[i] > 0 && ws[i] > 0) blocks += L.tiles_x * ((hs[i] + TH - 1) / TH);
    off += (long long)hs[i] * ws[i];
  }
  tab.n = n;
  if (blocks == 0) return 0;
  fast_harris_kernel<true, true, 9><<<blocks, NTHR, 0, (cudaStream_t)stream>>>(
      tab, (float*)score_out, (float*)harris_out, threshold, window5[0],
      window5[1], window5[2], window5[3], window5[4], harris_k);
  return (int)cudaGetLastError();
}

namespace {

// one launch of the score-only kernel at arc length N
template <int N>
void launch_score(const LevelTable& tab, int blocks, float* out,
                  float threshold, int nms, cudaStream_t stream) {
  if (nms)
    fast_harris_kernel<false, true, N><<<blocks, NTHR, 0, stream>>>(
        tab, out, nullptr, threshold, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f);
  else
    fast_harris_kernel<false, false, N><<<blocks, NTHR, 0, stream>>>(
        tab, out, nullptr, threshold, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f);
}

}  // namespace

// The score-only forms on one (h, w) u8 image: the thresholded,
// border-killed FAST-n score (n = arc_length, in [1, 16]), times the (h, w)
// f32 mask unless mask is null, then the 3x3 NMS if nms != 0, into the
// (h, w) f32 score_out. Returns a cudaError_t (cudaErrorInvalidValue for n
// outside [1, 16]); launches nothing for an empty image.
extern "C" int kt_fast_score(const void* img, int h, int w, const void* mask,
                             void* score_out, float threshold, int nms,
                             int arc_length, void* stream) {
  if (arc_length < 1 || arc_length > 16) return (int)cudaErrorInvalidValue;
  if (h <= 0 || w <= 0) return 0;
  LevelTable tab = {};
  Level& L = tab.lv[0];
  L.img = (const uint8_t*)img;
  L.mask = (const float*)mask;
  L.h = h;
  L.w = w;
  L.out_off = 0;
  L.first_block = 0;
  L.tiles_x = (w + TW - 1) / TW;
  tab.n = 1;
  const int blocks = L.tiles_x * ((h + TH - 1) / TH);
  float* out = (float*)score_out;
  cudaStream_t st = (cudaStream_t)stream;
  switch (arc_length) {
#define ARC(n) \
  case n:      \
    launch_score<n>(tab, blocks, out, threshold, nms, st); \
    break;
    ARC(1) ARC(2) ARC(3) ARC(4) ARC(5) ARC(6) ARC(7) ARC(8)
    ARC(9) ARC(10) ARC(11) ARC(12) ARC(13) ARC(14) ARC(15) ARC(16)
#undef ARC
  }
  return (int)cudaGetLastError();
}
