// Rotated-BRIEF tap sampling: out[k, t] = windows[k, rows[k, t], cols[k, t]].
//
// Replaces: kornia_tpu/ops/pallas_kernels.py::brief_sample_pallas (called
//   by kornia_tpu/features/orb.py:420, once per frame on the paired
//   (K/2, 40, 128) blurred windows with 1024 taps per window).
//
// Contract: bit-equal to the take_along_axis branch (orb.py:422-423), i.e.
//   a gather from the flattened window at rows*128 + cols; the tap
//   coordinates are clamped to the window (they already are, by
//   _brief_tap_coords). The A<B compare stays in PyTorch.
//
// Bound on H100: memory. Each call reads the taps' int32 rows and cols and
//   writes the f32 samples (3 x 4 x 1024 bytes per window, 12 MB for 1000
//   windows); the window values it touches (at most 1024 of 5120 per
//   window) come mostly from L2, since the windows were just written.
//   Design: one thread per (window, tap), 256 taps per block along one
//   window row of taps, so the index reads and the output writes are fully
//   coalesced and the gathers from one window stay within 20 KB.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void brief_sample_kernel(const float* __restrict__ windows,
                                    const int32_t* __restrict__ rows,
                                    const int32_t* __restrict__ cols,
                                    float* __restrict__ out, int k, int wh,
                                    int ww, int taps) {
  const int kk = blockIdx.y;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= taps || kk >= k) return;
  const size_t o = (size_t)kk * taps + t;
  int r = rows[o], c = cols[o];
  r = r < 0 ? 0 : (r > wh - 1 ? wh - 1 : r);
  c = c < 0 ? 0 : (c > ww - 1 ? ww - 1 : c);
  out[o] = windows[(size_t)kk * wh * ww + r * ww + c];
}

}  // namespace

extern "C" int kt_brief_sample(const void* windows, const void* rows,
                               const void* cols, void* out, int k, int wh,
                               int ww, int taps, void* stream) {
  if (k == 0 || taps == 0) return 0;
  dim3 block(256);
  dim3 grid((taps + 255) / 256, k);
  brief_sample_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)windows, (const int32_t*)rows, (const int32_t*)cols,
      (float*)out, k, wh, ww, taps);
  return (int)cudaGetLastError();
}
