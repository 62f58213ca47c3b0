// Lane gather: out[i, j] = src[i, clip(idx[i, j], 0, 127)] for (N, 128)
// float32 rows and int32 indices.
//
// Replaces: kornia_tpu/ops/pallas_kernels.py::lane_gather (called four times
//   per describe by the lane-gather formulation of rotated BRIEF,
//   kornia_tpu/features/orb.py:239-251, on the (K * 48, 128) flattened
//   windows with each tap column broadcast over the 48 window rows).
//
// Contract: exactly 128 lanes (the wrapper raises otherwise), indices
//   clipped to [0, 127] as pallas_kernels.py:359 clips them; no row padding
//   (the TPU kernel pads N to 512-row tiles). Bit-equal to torch.gather on
//   the clipped indices.
//
// Bound on H100: memory. It reads 2 * N * 512 bytes (src and idx) and writes
//   N * 512 (147 MB for N = 96,000, the K = 2000 describe). Design: one
//   thread per element, two rows per 256-thread block; index reads and
//   output writes are fully coalesced and the gathered reads stay inside
//   the row's own 512 bytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void lane_gather_kernel(const float* __restrict__ src,
                                   const int32_t* __restrict__ idx,
                                   float* __restrict__ out, size_t total) {
  const size_t o = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= total) return;
  int j = idx[o];
  j = j < 0 ? 0 : (j > 127 ? 127 : j);
  out[o] = src[(o & ~(size_t)127) + j];
}

}  // namespace

extern "C" int kt_lane_gather(const void* src, const void* idx, void* out,
                              long long n, void* stream) {
  if (n <= 0) return 0;
  const size_t total = (size_t)n * 128;
  const unsigned blocks = (unsigned)((total + 255) / 256);
  lane_gather_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(
      (const float*)src, (const int32_t*)idx, (float*)out, total);
  return (int)cudaGetLastError();
}
