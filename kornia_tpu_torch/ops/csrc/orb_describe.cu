// K11: ORB's describe stage for every keypoint of every pyramid level in
// one launch (kt_orb_describe): intensity-centroid orientation on the u8
// levels, the 7x7 Gaussian blur, and rotated BRIEF-256.
//
// Replaces: no TPU kernel. It fuses K2 (windows_paired.cu) and K3
//   (brief_sample.cu's brief_rotated) with the work the JAX package leaves
//   to XLA around them (kornia_tpu/features/orb.py: the casts and blurs of
//   every level, the two level-stacked canvases, the centroid moments,
//   atan2, cos and sin). The port ran that composition in eager PyTorch
//   (features/orb.py::_extract_windows_packed_paired,
//   orientation_from_windows_paired, brief_from_windows_paired): ~430
//   launches and 18 blocking uploads a KITTI-size frame, each 15-20 us of
//   host time, for under 1 ms of device work. This kernel exists to take
//   those launches off the host.
//
// Contract: bit-equal to that composition (cuda_kernels.py::
//   _orb_describe_plain), for every keypoint the caller passes:
//   - position: (x, y) = rint of the level coordinates (half to even, as
//     torch.round), placed on the paired canvas of
//     cuda_kernels.py::prepare_window_canvas (level i from canvas row
//     row0[i], padded 20 rows above and below, 64 columns left and right,
//     zero on the right up to the widest level) and clipped to
//     (wimg - 1, hsum - 1) as _clip_pairs clips it;
//   - a window pixel (row r in [0, 40), lane j in [0, 64)) is the canvas
//     value at (min(cy + r, hsum - 1), cx + 32 + j): the level that row
//     falls in, level row clamp(row - row0 - 20, 0, h - 1), level column
//     clamp(cx + j - 32, 0, w - 1), or 0 where the column lies in the
//     canvas' zero padding. Keypoints inside their level never reach the
//     zero padding or another level; the kernel follows the canvas for
//     the others too;
//   - orientation: m10 = sum(v * dx), m01 = sum(v * dy) of the u8 values v
//     over the circle dx^2 + dy^2 <= 225 about (20, 32), in int32. Each
//     term is an integer of magnitude <= 255 * 15 and every partial sum
//     stays below 255 * sum|dx| = 1.2e6 < 2^24, so the f32 torch.sum of
//     the same terms is exact in any order and equals these integers;
//     angle = atan2f(m01, m10), then cosf and sinf of it;
//   - blur: the value at a window pixel is filters.gaussian_blur(level,
//     (7, 7), 2.0) at its level pixel: reflect-101 at the level border,
//     the vertical pass first, then the horizontal, taps ascending, the
//     first product assigned and the rest added, each product and sum a
//     separately rounded f32 op (__fmul_rn, __fadd_rn; the file is built
//     with -fmad=false);
//   - BRIEF: brief_sample.cu's paired arithmetic: tap offsets
//     rint(px*c - py*s), rint(px*s + py*c), the lane clamped to [0, 63]
//     and the row to [0, 39], then A < B as one byte.
//
// Bound on H100: operations. The blur of a keypoint's 40 x 70 window
//   columns (7 multiplies and 6 adds a value, 36,400 f32 ops) and its 512
//   taps (13 a tap) are ~43,000 f32 ops a keypoint: 86 M at 2000
//   keypoints, 2.6 us at 33.5e12/s. Bytes are fewer: the levels are read
//   once (1.44 MB at KITTI's 8 levels) and 257 bytes a keypoint written
//   (0.51 MB): 0.58 us at 3.35 TB/s.
//
// Design: one 256-thread block a keypoint, no global scratch, no atomics.
//   The window's rows fall in at most two levels (a level spans >= 41
//   canvas rows): two segments, each with its own column anchor, which
//   every thread works out from the level table. Threads map the window
//   rows to tile rows and the tile's rows and columns to level rows and
//   columns in parallel (reflect-101 at the level border); the block then
//   copies the u8 values its blur needs (each segment's rows +-3 and the
//   64 lanes +-3; at most 52 x 70 bytes) into shared memory, runs the
//   vertical pass there into a 40 x 70 f32 array, and reduces the moments
//   of the u8 values by warp shuffles. Thread 0 takes atan2f, cosf and
//   sinf; thread j then rotates tap pair j, takes the horizontal pass at
//   its two taps only (7 products each, from the vertical array) and
//   writes bit j: a warp writes 32 contiguous bytes.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAX_LEVELS = 32;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int WIN_H = 40, CY = 20;      // the paired window's rows, keypoint row
constexpr int HALF_W = 64, CX = 32;     // a keypoint's lanes, its centre lane
constexpr int PAD_X = 64;               // canvas columns left of each level
constexpr int TAPS = 7, RAD = 3;        // the 7x7 blur
constexpr int TILE_W = HALF_W + 2 * RAD;         // 70
constexpr int MAX_SEGS = 2;
constexpr int TILE_H = WIN_H + MAX_SEGS * 2 * RAD;   // 52
constexpr int PATCH = 31, HALF = 15;

struct DescLevel {
  const uint8_t* img;   // (h, w) u8
  const float* xy;      // (budget, 2) f32 level coordinates (x, y)
  int h, w;
  int row0;             // the level's first canvas row
  int kp0;              // its first keypoint in the outputs
};

struct DescTable {
  DescLevel lv[MAX_LEVELS];
  int n;
  int hsum;             // canvas rows
  int wimg;             // the widest level
  float taps[TAPS];
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// filters._reflect101_index: reflected about the end pixels as often as
// needed; n = 1 repeats its pixel. Indices inside [0, n) skip the modulo.
__device__ __forceinline__ int reflect101(int i, int n) {
  if (i >= 0 && i < n) return i;
  if (n == 1) return 0;
  const int p = 2 * (n - 1);
  i %= p;
  if (i < 0) i += p;
  return i > n - 1 ? p - i : i;
}

__global__ void __launch_bounds__(THREADS)
orb_describe_kernel(const DescTable t, const int4* __restrict__ pattern,
                    float* __restrict__ angle_out,
                    uint8_t* __restrict__ bits_out) {
  __shared__ uint8_t tile[TILE_H * TILE_W];
  __shared__ float vert[WIN_H * TILE_W];
  __shared__ int row_tile[WIN_H];    // tile row of window row r's first tap
  __shared__ const uint8_t* src_row[TILE_H];   // a tile row's level row
  __shared__ int src_col[MAX_SEGS][TILE_W];    // a tile column's level column
  __shared__ int red[2][WARPS];
  __shared__ float rot[2];           // cos, sin

  const int tid = threadIdx.x;
  const int kp = blockIdx.x;
  int l0 = 0;
  while (l0 + 1 < t.n && t.lv[l0 + 1].kp0 <= kp) ++l0;
  const DescLevel& own = t.lv[l0];
  const float* xy = own.xy + 2 * (size_t)(kp - own.kp0);
  const int cx = clampi((int)rintf(xy[0]), 0, t.wimg - 1);
  const int cy = clampi((int)rintf(xy[1]) + own.row0, 0, t.hsum - 1);

  // Window rows [0, m) lie in level la, rows [m, 40) in level la + 1 (a
  // level spans >= 41 canvas rows, so no window reaches a third): two
  // segments, each with its level rows lo..hi, its tile rows lo-3..hi+3
  // from tile row base, and its column anchor xa. Every thread works them
  // out itself.
  int la = 0;
  while (la + 1 < t.n && t.lv[la + 1].row0 <= cy) ++la;
  const int m = la + 1 < t.n ? min(t.lv[la + 1].row0 - cy, WIN_H) : WIN_H;
  const int lb = m < WIN_H ? la + 1 : la;
  const DescLevel& A = t.lv[la];
  const DescLevel& B = t.lv[lb];
  // level row of window row r in level L: the canvas' edge replication
  const auto level_row = [&](int r, const DescLevel& L) {
    return clampi(min(cy + r, t.hsum - 1) - L.row0 - CY, 0, L.h - 1);
  };
  const int lo0 = level_row(0, A);
  const int base1 = level_row(m - 1, A) - lo0 + TAPS;
  const int lo1 = level_row(m, B);
  const int n_rows = m < WIN_H ? base1 + level_row(WIN_H - 1, B) - lo1 + TAPS
                               : base1;
  const int xa0 = clampi(cx, 0, A.w - 1), xa1 = clampi(cx, 0, B.w - 1);

  // threads [0, 40): window rows; [40, 92): tile rows; [92, 232): tile
  // columns of both segments
  constexpr int ROWS0 = WIN_H, COLS0 = WIN_H + TILE_H;
  static_assert(COLS0 + MAX_SEGS * TILE_W <= THREADS, "one pass of threads");
  if (tid < ROWS0) {
    row_tile[tid] = tid < m ? level_row(tid, A) - lo0
                            : base1 + level_row(tid, B) - lo1;
  } else if (tid < COLS0) {
    const int tr = tid - ROWS0;
    if (tr < n_rows) {
      const bool s1 = m < WIN_H && tr >= base1;
      const DescLevel& L = s1 ? B : A;
      const int y = reflect101((s1 ? lo1 - base1 : lo0) - RAD + tr, L.h);
      src_row[tr] = L.img + (size_t)y * L.w;
    }
  } else if (tid < COLS0 + MAX_SEGS * TILE_W) {
    const int s = (tid - COLS0) / TILE_W, b = tid - COLS0 - s * TILE_W;
    const DescLevel& L = s ? B : A;
    src_col[s][b] = reflect101((s ? xa1 : xa0) - RAD - CX + b, L.w);
  }
  __syncthreads();

  // the u8 rows and columns the blur reads, reflected at the level border
  for (int i = tid; i < n_rows * TILE_W; i += THREADS) {
    const int tr = i / TILE_W, b = i - tr * TILE_W;
    tile[i] = src_row[tr][src_col[m < WIN_H && tr >= base1][b]];
  }
  __syncthreads();

  // vertical pass at every window row and tile column
  for (int i = tid; i < WIN_H * TILE_W; i += THREADS) {
    const int r = i / TILE_W, b = i - r * TILE_W;
    const uint8_t* src = tile + row_tile[r] * TILE_W + b;
    float v = __fmul_rn((float)src[0], t.taps[0]);
#pragma unroll
    for (int k = 1; k < TAPS; ++k)
      v = __fadd_rn(v, __fmul_rn((float)src[k * TILE_W], t.taps[k]));
    vert[i] = v;
  }

  // intensity-centroid moments of the u8 values over the circle
  int m10 = 0, m01 = 0;
  for (int i = tid; i < PATCH * PATCH; i += THREADS) {
    const int dy = i / PATCH - HALF, dx = i - (i / PATCH) * PATCH - HALF;
    if (dx * dx + dy * dy > HALF * HALF) continue;
    const int r = CY + dy;
    const bool s1 = r >= m;
    const int w = s1 ? B.w : A.w;
    if (cx + dx >= w + PAD_X) continue;           // the canvas' zero padding
    const int lc = clampi(cx + dx, 0, w - 1);
    const int v = tile[(row_tile[r] + RAD) * TILE_W + lc - (s1 ? xa1 : xa0)
                       + RAD + CX];
    m10 += v * dx;
    m01 += v * dy;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    m10 += __shfl_down_sync(0xffffffffu, m10, o);
    m01 += __shfl_down_sync(0xffffffffu, m01, o);
  }
  if ((tid & 31) == 0) {
    red[0][tid >> 5] = m10;
    red[1][tid >> 5] = m01;
  }
  __syncthreads();
  if (tid == 0) {
    int a = 0, b = 0;
    for (int w = 0; w < WARPS; ++w) {
      a += red[0][w];
      b += red[1][w];
    }
    const float ang = atan2f((float)b, (float)a);
    angle_out[kp] = ang;
    rot[0] = cosf(ang);
    rot[1] = sinf(ang);
  }
  __syncthreads();

  // tap pair tid, rotated as brief_sample.cu's paired layout rotates it
  const float c = rot[0], sn = rot[1];
  const int4 tap = pattern[tid];
  float val[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const float px = (float)(e ? tap.z : tap.x);
    const float py = (float)(e ? tap.w : tap.y);
    const int ddx = (int)rintf(__fsub_rn(__fmul_rn(px, c), __fmul_rn(py, sn)));
    const int ddy = (int)rintf(__fadd_rn(__fmul_rn(px, sn), __fmul_rn(py, c)));
    const int dx = clampi(CX + ddx, 0, HALF_W - 1) - CX;
    const int r = clampi(CY + ddy, 0, WIN_H - 1);
    const bool s1 = r >= m;
    const int w = s1 ? B.w : A.w;
    if (cx + dx >= w + PAD_X) {
      val[e] = 0.f;
    } else {
      const int lc = clampi(cx + dx, 0, w - 1);
      const float* src = vert + r * TILE_W + lc - (s1 ? xa1 : xa0) + CX;
      float v = __fmul_rn(src[0], t.taps[0]);
#pragma unroll
      for (int k = 1; k < TAPS; ++k) v = __fadd_rn(v, __fmul_rn(src[k], t.taps[k]));
      val[e] = v;
    }
  }
  bits_out[(size_t)kp * 256 + tid] = val[0] < val[1] ? 1 : 0;
}

}  // namespace

// n levels: imgs[i] (hs[i], ws[i]) u8, xys[i] (budgets[i], 2) f32 level
// coordinates; taps: the blur's 7 f32 taps; pattern: (256, 4) int32
// (x1, y1, x2, y2), 16-byte aligned; angle: (K,) f32; bits: (K, 256) u8,
// K = sum(budgets). Levels must be non-empty, n <= 32.
extern "C" int kt_orb_describe(int n, const void* const* imgs,
                               const void* const* xys, const int* hs,
                               const int* ws, const int* budgets,
                               const float* taps, const void* pattern,
                               void* angle, void* bits, void* stream) {
  if (n < 1 || n > MAX_LEVELS) return (int)cudaErrorInvalidValue;
  DescTable t;
  int row0 = 0, kp0 = 0, wimg = 0;
  for (int i = 0; i < n; ++i) {
    if (hs[i] < 1 || ws[i] < 1 || budgets[i] < 0)
      return (int)cudaErrorInvalidValue;
    t.lv[i].img = (const uint8_t*)imgs[i];
    t.lv[i].xy = (const float*)xys[i];
    t.lv[i].h = hs[i];
    t.lv[i].w = ws[i];
    t.lv[i].row0 = row0;
    t.lv[i].kp0 = kp0;
    row0 += hs[i] + WIN_H;
    kp0 += budgets[i];
    wimg = ws[i] > wimg ? ws[i] : wimg;
  }
  t.n = n;
  t.hsum = row0;
  t.wimg = wimg;
  for (int k = 0; k < TAPS; ++k) t.taps[k] = taps[k];
  if (kp0 == 0) return 0;
  orb_describe_kernel<<<kp0, THREADS, 0, (cudaStream_t)stream>>>(
      t, (const int4*)pattern, (float*)angle, (uint8_t*)bits);
  return (int)cudaGetLastError();
}
