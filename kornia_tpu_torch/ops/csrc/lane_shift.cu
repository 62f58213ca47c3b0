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
//   kornia_tpu_torch/ops/cuda_kernels.py::_lane_shift_plain, for any
//   int32 shifts of either sign, any cc and out_w, any batch, and a source
//   at any 4-byte offset; and to _lane_shift_pallas wherever that kernel's
//   16-lane residual window holds (shifts >= 0 whose spread within 8
//   consecutive rows is < 16, as floor(kappa * r) with |kappa| <= 1.05
//   gives).
//
// Bound on H100: memory. It reads the (rr, cc) source once and writes the
//   (rr, out_w) output once (1080p 30 degrees: 3 x 1920 x 1920 in, 3 x 1920
//   x 3944 out, 135 MB, 0.0403 ms at 3.35 TB/s; the output alone is
//   larger than L2). Design: a copy that stores 16-byte pieces.
// - A grid of (row, chunk of output columns): a block owns one row's
//   chunk of NT * XV columns, so the row, its shift and its bases are
//   computed once per block and no thread divides; the shift is one
//   broadcast load per warp.
// - Each thread makes XV = 4 consecutive outputs and stores them as one
//   16-byte store where the output rows are 16-byte aligned (out_w % 4 ==
//   0), else as scalar stores.
// - Outputs whose four sources all lie outside [0, cc) are zeros, written
//   without loads.
// - Four scalar loads, masked, for every source offset: neighbouring
//   threads read neighbouring 16-byte runs, so the warp's loads coalesce
//   whatever the run's misalignment (j - s) mod 4, and L1 serves the
//   sectors two threads share.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;          // threads per block
constexpr int XV = 4;            // consecutive outputs per thread
constexpr int TILE = NT * XV;    // output columns per block and step

__device__ __forceinline__ void put(float* __restrict__ orow, int x,
                                    int out_w, float4 v, bool vstore) {
  if (vstore) {
    *reinterpret_cast<float4*>(orow + x) = v;
  } else {
    orow[x] = v.x;
    if (x + 1 < out_w) orow[x + 1] = v.y;
    if (x + 2 < out_w) orow[x + 2] = v.z;
    if (x + 3 < out_w) orow[x + 3] = v.w;
  }
}

__global__ void __launch_bounds__(NT)
lane_shift_kernel(const float* __restrict__ src,
                  const int32_t* __restrict__ shifts,
                  float* __restrict__ out, int rr, int cc, int out_w,
                  bool vstore) {
  const int row = blockIdx.x;                 // b * rr + r
  const int s = __ldg(shifts + row % rr);
  const float* __restrict__ srow = src + (size_t)row * cc;
  float* __restrict__ orow = out + (size_t)row * out_w;
  for (int x = blockIdx.y * TILE + threadIdx.x * XV; x < out_w;
       x += gridDim.y * TILE) {
    const long long k = (long long)x - s;     // source of output x
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (k > -XV && k < cc) {
      const int kk = (int)k;
      v.x = kk >= 0 ? __ldg(srow + kk) : 0.f;
      v.y = kk + 1 >= 0 && kk + 1 < cc ? __ldg(srow + kk + 1) : 0.f;
      v.z = kk + 2 >= 0 && kk + 2 < cc ? __ldg(srow + kk + 2) : 0.f;
      v.w = kk + 3 >= 0 && kk + 3 < cc ? __ldg(srow + kk + 3) : 0.f;
    }
    put(orow, x, out_w, v, vstore);
  }
}

}  // namespace

// src: (b, rr, cc) f32; shifts: (rr,) int32; out: (b, rr, out_w) f32.
extern "C" int kt_lane_shift(const void* src, const void* shifts, void* out,
                             int b, int rr, int cc, int out_w, void* stream) {
  const long long rows = (long long)b * rr;
  if (rows == 0 || out_w == 0) return 0;
  if (rows > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int steps = (out_w + TILE - 1) / TILE;
  const dim3 grid((unsigned)rows, steps < 65535 ? steps : 65535);
  const bool vstore = out_w % 4 == 0 && (uintptr_t)out % 16 == 0;
  lane_shift_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
      (const float*)src, (const int32_t*)shifts, (float*)out, rr, cc, out_w,
      vstore);
  return (int)cudaGetLastError();
}
