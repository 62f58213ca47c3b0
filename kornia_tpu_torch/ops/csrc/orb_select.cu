// K10: ORB's per-level keypoint selection for every level of a frame in at
// most three launches (kt_orb_select): the two-tier cell gate on K1's NMS'd
// FAST score, the 13-bit Harris quantisation over each level's eligible
// range, the per-cell top-k of the packed keys, and the stable top-budget
// of each level's candidates.
//
// Replaces: no TPU kernel. The JAX package selects in dense XLA ops, one
//   program per level inside one jit (kornia_tpu/features/orb.py:522-526),
//   where a launch costs almost nothing. The port ran the same composition
//   in eager PyTorch (features/orb.py::_select_level: features/fast.py's
//   _two_tier_gate, fast_harris_cells or fast_detect_cells with
//   cell_topk_packed, then stable_topk and a gather), 102-130 launches a
//   level and 883 a KITTI-size frame, each 10-15 us of host time: the
//   front end's largest cost. This kernel exists to take those launches
//   off the host.
//
// Contract: bit-equal, on every level, to _select_level(level, budget,
//   cfg, maps) on the same K1 maps (cuda_kernels.py::_orb_select_plain):
//   - the gate on a cell grid anchored top-left: a cell with any score
//     above threshold_high keeps only those, the others keep the low tier;
//   - with harris_rescore, hmin/hmax of the Harris value over the eligible
//     (gated score > 0) pixels of the level, span = max(hmax - hmin,
//     1e-12), q = floor((h - hmin) / span * 8190) + 1 clamped to [1, 8191],
//     each op a separately rounded f32 op and the division a true one (the
//     file is built with -fmad=false and the ops are written as
//     __f*_rn intrinsics); without it the rank is the gated FAST score,
//     an integer in [0, 255] for a u8 level;
//   - the packed key rank * 2048 + (2047 - position in the cell), exact in
//     32-bit integers as in float32, and per_cell = max(2, ceil(2 * budget /
//     cells)) keys a cell, largest first, in cells-major slots;
//   - the slot's score: ((q - 1) / 8190) * span + hmin (true division), or
//     the FAST score; -inf and xy (0, 0) in a slot whose cell ran out;
//   - the stable descending top-budget of the level's slots (on ties the
//     lower slot first, -inf slots included), valid = isfinite, vals 0
//     where not valid.
//   The score map must hold integers in [0, 8191] (K1's FAST scores on u8
//   are in [0, 255]); cell_size^2 <= 2048; at most 32 levels.
//
// Bound on H100: bytes. It reads K1's two f32 maps once (8 bytes a pixel,
//   11.6 MB at KITTI's 8 levels: 3.4 us at 3.35 TB/s) and writes 13 bytes a
//   keypoint; the arithmetic is a few ops a pixel. Launches 1 and 2 read
//   the maps again from L2.
//
// Design: three launches, no atomics, no memset, no host sync; every run
//   gives the same bits.
// - Launch 1 (with harris_rescore only; cell_range_kernel): one 256-thread
//   block per cell of every level, the levels' cells flattened into one
//   grid. It gates its cell and writes the min and max Harris value of its
//   eligible pixels (+inf/-inf without one) to scratch.
// - Launch 2 (cell_topk_kernel): one block per cell. It gates its cell
//   again, reduces its level's per-cell ranges (a few hundred values, the
//   same result in every block: min and max are exact), quantises and
//   packs its pixels (at most 8 a thread, in registers) and takes the top
//   per_cell keys by block-wide rounds of a max (a warp reduction, one
//   barrier) and a suppress by the owning thread; the keys are unique, so
//   a round removes one. A round whose max is 0 ends the cell. It writes
//   each slot's key and score.
// - Launch 3 (level_topk_kernel): one 1024-thread block per level. It
//   sorts the level's slots, ascending on a 64-bit key of the
//   order-reversed score bits and the slot index (a bitonic sort over the
//   next power of two; the pad keys are all ones), takes the first budget,
//   decodes xy from the slot's key and writes (xy, vals, valid) at the
//   level's offset of the outputs. The sort runs in shared memory up to
//   MAX_SORT keys (every level of ORB's configurations: 1,188 slots at
//   KITTI's level 0), else in the level's own part of the scratch in
//   global memory, the same code on another pointer.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAX_LEVELS = 32;
constexpr int CELL_THREADS = 256;
constexpr int CELL_WARPS = CELL_THREADS / 32;
constexpr int ITEMS = 8;              // 256 threads x 8 >= cell_size^2
constexpr int SORT_THREADS = 1024;
constexpr int MAX_SORT = 16384;       // shared: 128 KiB of 8-byte keys
constexpr long long MAX_SLOTS = 1 << 24;   // a level's slots
constexpr int SMEM_WITHOUT_OPT_IN = 48 * 1024;   // dynamic, per block

struct SelLevel {
  const float* score;     // (h, w) K1's NMS'd FAST score at the low tier
  const float* harris;    // (h, w) K1's Harris map
  int h, w;
  int gx;                 // cells across
  int first_cell;         // the level's first block in launches 1 and 2
  int n_cells;
  int per_cell;
  int budget;
  int cand_off;           // the level's first slot in the scratch
  int n_sort;             // the next power of two >= n_cells * per_cell
  int sort_off;           // the level's first key in the global sort
                          // scratch, or -1: sorted in shared memory
  int out_off;            // the level's first keypoint in the outputs
};

struct SelTable {
  SelLevel lv[MAX_LEVELS];
  int n;
  int cs;
  float thr_high;
};

__device__ __forceinline__ int level_of(const SelTable& t, int cell) {
  int l = 0;
  while (l + 1 < t.n && t.lv[l + 1].first_cell <= cell) ++l;
  return l;
}

// This thread's pixels of the block's cell (p = tid + k * 256, row-major in
// the cell) gated as _two_tier_gate gates them: sel[k] is the gated score
// (0 outside the level); hv[k] the Harris value where HARRIS.
template <bool HARRIS>
__device__ __forceinline__ void load_gated(const SelTable& t,
                                           const SelLevel& L, int c,
                                           float (&sel)[ITEMS],
                                           float (&hv)[ITEMS]) {
  const int cs = t.cs;
  const int cy0 = (c / L.gx) * cs;
  const int cx0 = (c % L.gx) * cs;
  bool any_hi = false;
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int p = threadIdx.x + k * CELL_THREADS;
    sel[k] = 0.f;
    hv[k] = 0.f;
    if (p < cs * cs) {
      const int ly = p / cs;
      const int y = cy0 + ly;
      const int x = cx0 + p - ly * cs;
      if (y < L.h && x < L.w) {
        const long long i = (long long)y * L.w + x;
        sel[k] = L.score[i];
        if (HARRIS) hv[k] = L.harris[i];
      }
    }
    const float s_hi = sel[k] > t.thr_high ? sel[k] : 0.f;
    any_hi |= s_hi > 0.f;
  }
  const bool has_hi = __syncthreads_or(any_hi);
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const float s_hi = sel[k] > t.thr_high ? sel[k] : 0.f;
    if (has_hi) sel[k] = s_hi;
  }
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// block-wide (min, max) of (lo, hi); every thread gets the result
__device__ __forceinline__ float2 block_range(float lo, float hi) {
  __shared__ float2 part[CELL_WARPS];
  lo = warp_min(lo);
  hi = warp_max(hi);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) part[warp] = make_float2(lo, hi);
  __syncthreads();
  float2 r = part[0];
#pragma unroll
  for (int i = 1; i < CELL_WARPS; ++i) {
    r.x = fminf(r.x, part[i].x);
    r.y = fmaxf(r.y, part[i].y);
  }
  return r;
}

__global__ void __launch_bounds__(CELL_THREADS)
cell_range_kernel(const SelTable t, float2* __restrict__ cell_range) {
  const int cell = blockIdx.x;
  const SelLevel& L = t.lv[level_of(t, cell)];
  float sel[ITEMS], hv[ITEMS];
  load_gated<true>(t, L, cell - L.first_cell, sel, hv);
  float lo = INFINITY, hi = -INFINITY;
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    if (sel[k] > 0.f) {
      lo = fminf(lo, hv[k]);
      hi = fmaxf(hi, hv[k]);
    }
  }
  const float2 r = block_range(lo, hi);
  if (threadIdx.x == 0) cell_range[cell] = r;
}

template <bool HARRIS>
__global__ void __launch_bounds__(CELL_THREADS)
cell_topk_kernel(const SelTable t, const float2* __restrict__ cell_range,
                 float* __restrict__ cand_score, int* __restrict__ cand_key) {
  __shared__ int wmax[2][CELL_WARPS];
  const int cell = blockIdx.x;
  const SelLevel& L = t.lv[level_of(t, cell)];
  const int c = cell - L.first_cell;
  float sel[ITEMS], hv[ITEMS];
  load_gated<HARRIS>(t, L, c, sel, hv);

  float hmin = 0.f, span = 1.f;
  if (HARRIS) {
    float lo = INFINITY, hi = -INFINITY;
    for (int i = threadIdx.x; i < L.n_cells; i += CELL_THREADS) {
      const float2 r = cell_range[L.first_cell + i];
      lo = fminf(lo, r.x);
      hi = fmaxf(hi, r.y);
    }
    const float2 r = block_range(lo, hi);
    hmin = r.x;
    span = fmaxf(__fsub_rn(r.y, r.x), 1e-12f);
  }

  // packed keys: rank * 2048 + (2047 - p), 0 where not eligible
  int key[ITEMS];
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int p = threadIdx.x + k * CELL_THREADS;
    int rank = 0;
    if (sel[k] > 0.f) {
      if (HARRIS) {
        const float u = __fmul_rn(__fdiv_rn(__fsub_rn(hv[k], hmin), span),
                                  8190.f);
        const float q = __fadd_rn(floorf(u), 1.f);
        rank = (int)fminf(fmaxf(q, 1.f), 8191.f);
      } else {
        rank = (int)sel[k];
      }
    }
    key[k] = rank > 0 ? rank * 2048 + (2047 - p) : 0;
  }

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int base = L.cand_off + c * L.per_cell;
  int r = 0;
  for (; r < L.per_cell; ++r) {
    int m = 0;
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) m = max(m, key[k]);
    m = __reduce_max_sync(0xffffffffu, m);
    if (lane == 0) wmax[r & 1][warp] = m;
    __syncthreads();
    m = wmax[r & 1][0];
#pragma unroll
    for (int i = 1; i < CELL_WARPS; ++i) m = max(m, wmax[r & 1][i]);
    if (m == 0) break;                       // the cell ran out: uniform
#pragma unroll
    for (int k = 0; k < ITEMS; ++k)
      if (key[k] == m) key[k] = 0;
    if (threadIdx.x == 0) {
      const int q = m >> 11;
      cand_key[base + r] = m;
      cand_score[base + r] =
          HARRIS ? __fadd_rn(__fmul_rn(__fdiv_rn((float)(q - 1), 8190.f),
                                       span),
                             hmin)
                 : (float)q;
    }
  }
  for (int s = r + threadIdx.x; s < L.per_cell; s += CELL_THREADS) {
    cand_key[base + s] = 0;
    cand_score[base + s] = -INFINITY;
  }
}

// ascending order of the result = descending order of f, +0 for -0
__device__ __forceinline__ unsigned long long desc_key(float f, int idx) {
  uint32_t b = f == 0.f ? 0u : __float_as_uint(f);
  b = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return ((unsigned long long)(~b) << 32) | (uint32_t)idx;
}

__global__ void __launch_bounds__(SORT_THREADS)
level_topk_kernel(const SelTable t, const float* __restrict__ cand_score,
                  const int* __restrict__ cand_key,
                  unsigned long long* __restrict__ gkeys,
                  float* __restrict__ xy, float* __restrict__ vals,
                  uint8_t* __restrict__ valid) {
  extern __shared__ unsigned long long sk_shared[];
  const SelLevel& L = t.lv[blockIdx.x];
  // __syncthreads orders the block's global accesses as its shared ones
  unsigned long long* sk = L.sort_off < 0 ? sk_shared : gkeys + L.sort_off;
  const int n_cand = L.n_cells * L.per_cell;
  const int n = L.n_sort;
  for (int i = threadIdx.x; i < n; i += SORT_THREADS)
    sk[i] = i < n_cand ? desc_key(cand_score[L.cand_off + i], i) : ~0ull;
  __syncthreads();
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < n / 2; i += SORT_THREADS) {
        const int lo = 2 * i - (i & (j - 1));
        const int hi = lo + j;
        const unsigned long long a = sk[lo], b = sk[hi];
        if ((a > b) == ((lo & k) == 0)) {
          sk[lo] = b;
          sk[hi] = a;
        }
      }
      __syncthreads();
    }
  }
  const int cs = t.cs;
  for (int j = threadIdx.x; j < L.budget; j += SORT_THREADS) {
    const int idx = (int)(uint32_t)sk[j];
    const float f = cand_score[L.cand_off + idx];
    const int key = cand_key[L.cand_off + idx];
    const bool ok = isfinite(f);
    float x = 0.f, y = 0.f;
    if (key > 0) {
      const int c = idx / L.per_cell;
      const int p = 2047 - (key & 2047);
      const int py = p / cs;
      x = (float)((c % L.gx) * cs + p - py * cs);
      y = (float)((c / L.gx) * cs + py);
    }
    const int o = L.out_off + j;
    xy[2 * o] = x;
    xy[2 * o + 1] = y;
    vals[o] = ok ? f : 0.f;
    valid[o] = ok ? 1 : 0;
  }
}

}  // namespace

// n levels (1..32): scores[i], harris[i] the (hs[i], ws[i]) f32 maps of
// level i (harris unread without harris_rescore), budgets[i] its keypoints,
// per_cell[i] its slots a cell. scratch: 8 bytes a cell, then 8 a slot of
// every level, then 8 a sort key (the next power of two over its slots) of
// every level of more than MAX_SORT slots; xy (N, 2) f32, vals (N,) f32,
// valid (N,) u8 for N = sum of budgets, level i at the sum of the budgets
// before it.
extern "C" int kt_orb_select(int n, const void* const* scores,
                             const void* const* harris, const int* hs,
                             const int* ws, const int* budgets,
                             const int* per_cell, int cell_size,
                             float threshold_high, int harris_rescore,
                             void* scratch, void* xy, void* vals, void* valid,
                             void* stream) {
  if (n < 1 || n > MAX_LEVELS || cell_size < 1 ||
      cell_size * cell_size > CELL_THREADS * ITEMS)
    return (int)cudaErrorInvalidValue;
  SelTable tab = {};
  int cells = 0, cands = 0, outs = 0, max_sort = 1, gsorted = 0;
  for (int i = 0; i < n; ++i) {
    SelLevel& L = tab.lv[i];
    L.score = (const float*)scores[i];
    L.harris = (const float*)harris[i];
    L.h = hs[i];
    L.w = ws[i];
    if (L.h < 1 || L.w < 1 || budgets[i] < 0 || per_cell[i] < 1)
      return (int)cudaErrorInvalidValue;
    L.gx = (L.w + cell_size - 1) / cell_size;
    L.n_cells = L.gx * ((L.h + cell_size - 1) / cell_size);
    L.per_cell = per_cell[i];
    L.budget = budgets[i];
    L.first_cell = cells;
    L.cand_off = cands;
    L.out_off = outs;
    const long long n_cand = (long long)L.n_cells * L.per_cell;
    if (n_cand > MAX_SLOTS || L.budget > n_cand)
      return (int)cudaErrorInvalidValue;
    L.n_sort = 1;
    while (L.n_sort < n_cand) L.n_sort <<= 1;
    L.sort_off = -1;
    if (L.n_sort > MAX_SORT) {
      L.sort_off = gsorted;
      gsorted += L.n_sort;
    } else if (L.n_sort > max_sort) {
      max_sort = L.n_sort;
    }
    cells += L.n_cells;
    cands += (int)n_cand;
    outs += L.budget;
  }
  tab.n = n;
  tab.cs = cell_size;
  tab.thr_high = threshold_high;
  float2* cell_range = (float2*)scratch;
  float* cand_score = (float*)(cell_range + cells);
  int* cand_key = (int*)(cand_score + cands);
  unsigned long long* gkeys = (unsigned long long*)(cand_key + cands);
  cudaStream_t s = (cudaStream_t)stream;
  if (harris_rescore) {
    cell_range_kernel<<<cells, CELL_THREADS, 0, s>>>(tab, cell_range);
    cell_topk_kernel<true><<<cells, CELL_THREADS, 0, s>>>(
        tab, cell_range, cand_score, cand_key);
  } else {
    cell_topk_kernel<false><<<cells, CELL_THREADS, 0, s>>>(
        tab, cell_range, cand_score, cand_key);
  }
  const size_t smem = (size_t)max_sort * sizeof(unsigned long long);
  if (smem > SMEM_WITHOUT_OPT_IN) {
    const cudaError_t e = cudaFuncSetAttribute(
        level_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  level_topk_kernel<<<n, SORT_THREADS, smem, s>>>(
      tab, cand_score, cand_key, gkeys, (float*)xy, (float*)vals,
      (uint8_t*)valid);
  return (int)cudaGetLastError();
}
