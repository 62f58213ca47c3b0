// Lane gather: out[i, j] = src[i, clip(idx[i / g, j], 0, 127)] for (N, 128)
// float32 rows and (N / g, 128) int32 indices. g = 1 is the TPU kernel's
// contract; g > 1 is the broadcast-index mode, where one index row serves
// g consecutive source rows.
//
// Replaces: kornia_tpu/ops/pallas_kernels.py::lane_gather (called four times
//   per describe by the lane-gather formulation of rotated BRIEF,
//   kornia_tpu/features/orb.py:239-251, on the (K * 48, 128) flattened
//   windows with each tap column broadcast over the 48 window rows). The
//   port's describe passes the (K, 128) tap columns once with g = 48
//   instead of an expanded (K * 48, 128) copy: the same function on the
//   same values.
//
// Contract: exactly 128 lanes (the wrapper raises otherwise), indices
//   clipped to [0, 127] as pallas_kernels.py:359 clips them; no row padding
//   (the TPU kernel pads N to 512-row tiles); any 4-byte offset of src,
//   idx and out. Bit-equal to torch.gather on the clipped (and, for g > 1,
//   row-repeated) indices:
//   kornia_tpu_torch/ops/cuda_kernels.py::_lane_gather_plain.
//
// Bound on H100: memory. It reads N * 512 bytes of src and N / g * 512 of
//   idx and writes N * 512 (g = 1: 147 MB for N = 96,000, the K = 2000
//   describe, 0.0440 ms at 3.35 TB/s; g = 48: 99.3 MB, 0.0297 ms).
//   Design: a warp owns whole 512-byte rows, RW of them, and moves them in
//   16-byte pieces: each lane loads one float4 of the source row and one
//   int4 of its index row (all loads of the warp's rows issued before any
//   use), serves its four outputs from the row held in shared memory (the
//   row stored as 32 float4s, then four scalar reads at the clipped
//   indices), and stores them as one float4. Where src, idx or out starts
//   off a 16-byte boundary (a view into a larger buffer), the same kernel
//   moves each piece as four scalar loads or stores. The index row of a
//   source row is found by one division per thread, then by counting.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;          // threads per block
constexpr int WARPS = NT / 32;
constexpr int RW = 4;            // rows per warp

__device__ __forceinline__ int clip127(int j) {
  return j < 0 ? 0 : (j > 127 ? 127 : j);
}

// piece `lane` of a 128-value row: 16 bytes at once where aligned
template <bool V, typename T4, typename T>
__device__ __forceinline__ T4 load4(const T* __restrict__ row, int lane) {
  if (V) return __ldg(reinterpret_cast<const T4*>(row) + lane);
  const T* p = row + 4 * lane;
  return T4{__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3)};
}

template <bool V>
__device__ __forceinline__ void store4(float* __restrict__ row, int lane,
                                       float4 v) {
  if (V) {
    reinterpret_cast<float4*>(row)[lane] = v;
  } else {
    float* p = row + 4 * lane;
    p[0] = v.x;
    p[1] = v.y;
    p[2] = v.z;
    p[3] = v.w;
  }
}

template <bool V>
__global__ void __launch_bounds__(NT)
lane_gather_kernel(const float* __restrict__ src,
                   const int32_t* __restrict__ idx, float* __restrict__ out,
                   long long n, int g) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long row0 = ((long long)blockIdx.x * WARPS + warp) * RW;
  long long irow = row0 / g;                  // index row of row0
  int rem = (int)(row0 - irow * g);
  float4 v[RW];
  int4 ix[RW];
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    v[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    ix[i] = make_int4(0, 0, 0, 0);
    if (row0 + i < n) {
      v[i] = load4<V, float4>(src + (row0 + i) * 128, lane);
      ix[i] = load4<V, int4>(idx + irow * 128, lane);
    }
    if (++rem == g) {
      rem = 0;
      ++irow;
    }
  }
  __shared__ float4 rows[WARPS][RW][32];
#pragma unroll
  for (int i = 0; i < RW; ++i) rows[warp][i][lane] = v[i];
  __syncwarp();
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const float* r = reinterpret_cast<const float*>(rows[warp][i]);
    const float4 o = make_float4(r[clip127(ix[i].x)], r[clip127(ix[i].y)],
                                 r[clip127(ix[i].z)], r[clip127(ix[i].w)]);
    if (row0 + i < n) store4<V>(out + (row0 + i) * 128, lane, o);
  }
}

}  // namespace

// src, out: (n, 128) f32; idx: (n / g, 128) int32; g >= 1 divides n.
extern "C" int kt_lane_gather(const void* src, const void* idx, void* out,
                              long long n, int g, void* stream) {
  if (n <= 0) return 0;
  if (g < 1 || n % g) return (int)cudaErrorInvalidValue;
  const long long rows_per_block = (long long)WARPS * RW;
  const long long blocks = (n + rows_per_block - 1) / rows_per_block;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const bool vec = ((uintptr_t)src | (uintptr_t)idx | (uintptr_t)out) % 16
                   == 0;
  const cudaStream_t st = (cudaStream_t)stream;
  if (vec)
    lane_gather_kernel<true><<<(unsigned)blocks, NT, 0, st>>>(
        (const float*)src, (const int32_t*)idx, (float*)out, n, g);
  else
    lane_gather_kernel<false><<<(unsigned)blocks, NT, 0, st>>>(
        (const float*)src, (const int32_t*)idx, (float*)out, n, g);
  return (int)cudaGetLastError();
}
