// Integer row shift: out[b, r, j] = src[b, r, j - shifts[r]], zero where
// j - shifts[r] falls outside [0, cc).
//
// Replaces: kornia_tpu/ops/warp_pallas.py::_lane_shift_pallas, the integer
//   pre-shear that warp_affine_exact's sheared branch (warp_pallas.py:
//   1027-1030) applies to the transposed, rot90-normalised source so that
//   each (8, 128) destination chunk of K7 reads a few source rows. The
//   port's K7 samples every map directly and needs no pre-shear, so no
//   warp path of the port launches this kernel; it is kept as its own
//   kernel with its contract, held to the Pallas kernel by the CPU tests.
//
// Contract: bit-equal (it only moves values) to the plain PyTorch version
//   kornia_tpu_torch/ops/cuda_kernels.py::_lane_shift_plain, and to
//   _lane_shift_pallas wherever that kernel's 16-lane residual window
//   holds (shifts >= 0 whose spread within 8 consecutive rows is < 16, as
//   floor(kappa * r) with |kappa| <= 1.05 gives).
//
// Bound on H100: memory. It reads the (rr, cc) source once and writes the
//   (rr, out_w) output once (1080p 30 degrees: 1920 x 1920 in, 1920 x 3944
//   out, ~45 MB per channel). Design: one thread per output element, a
//   flat index over (b, r, j), so neighbouring threads write neighbouring
//   lanes of one row and read neighbouring source lanes: both coalesced.
//   The TPU kernel's aligned dynamic writes, rolls and 16 static selects
//   per 8-row tile are not needed.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void lane_shift_kernel(const float* __restrict__ src,
                                  const int32_t* __restrict__ shifts,
                                  float* __restrict__ out, long long total,
                                  int rr, int cc, int out_w) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int j = (int)(i % out_w);
  const long long row = i / out_w;          // b * rr + r
  const int r = (int)(row % rr);
  const long long k = (long long)j - shifts[r];
  out[i] = (k >= 0 && k < cc) ? src[row * cc + k] : 0.f;
}

}  // namespace

// src: (b, rr, cc) f32; shifts: (rr,) int32; out: (b, rr, out_w) f32.
extern "C" int kt_lane_shift(const void* src, const void* shifts, void* out,
                             int b, int rr, int cc, int out_w, void* stream) {
  const long long total = (long long)b * rr * out_w;
  if (total == 0) return 0;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  lane_shift_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)src, (const int32_t*)shifts, (float*)out, total, rr, cc,
      out_w);
  return (int)cudaGetLastError();
}
