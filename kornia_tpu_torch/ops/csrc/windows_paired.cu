// Paired keypoint windows: keypoints 2i and 2i+1 share one (40, 128)
// float32 window; keypoint 2i+s fills lanes [64s, 64s+64), centred at lane
// 32 + 64s on row 20.
//
// Replaces: kornia_tpu/ops/pallas_kernels.py::extract_windows_prepared_paired
//   (called by kornia_tpu/features/orb.py:379, twice per frame: gray and
//   blurred levels).
//
// Contract: out[i, r, 64s + j] = canvas[cy + r, cx + 32 + j] with
//   (cx, cy) = clip(xy[2i+s], 0, (wimg-1, hsum-1)) as pallas_kernels.py:473
//   clips, where canvas is the edge-replicated, level-stacked canvas of
//   kornia_tpu_torch/ops/cuda_kernels.py::prepare_window_canvas (each level
//   padded 20 rows above and below, 64 columns left and right) and xy holds
//   canvas coordinates (y offset by the level's first canvas row). Each half
//   reads its own keypoint's rows, so a pair that straddles two pyramid
//   levels reads two levels. Reads are additionally clamped to the canvas,
//   which no valid keypoint reaches. Bit-equal to the plain gather.
//
// Bound on H100: memory. It writes ceil(K/2)*40*128*4 bytes (20.5 MB for
//   K = 2000) and reads as many canvas values, mostly from L2 (the 8-level
//   canvas of a 480x752 frame is 2530x880 f32, 8.9 MB). Design: one block
//   per window, 128 threads per row so every warp writes 512 contiguous
//   bytes and reads two 256-byte runs of one canvas row; the block loops
//   over the 40 rows. No shared memory is needed: each canvas value is read
//   once per window.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__global__ void windows_paired_kernel(const float* __restrict__ canvas,
                                      const int32_t* __restrict__ xy,
                                      float* __restrict__ out, int k,
                                      int canvas_h, int canvas_w, int hsum,
                                      int wimg, int win_h) {
  const int win = blockIdx.x;
  const int lane = threadIdx.x;           // 0..127
  const int s = lane >> 6;                // which keypoint of the pair
  const int j = lane & 63;
  const int kp = 2 * win + s;
  // odd K: the missing last half is keypoint (0, 0), as the Pallas
  // kernel's zero padding of xy gives
  const int cx = kp < k ? clampi(xy[2 * kp], 0, wimg - 1) : 0;
  const int cy = kp < k ? clampi(xy[2 * kp + 1], 0, hsum - 1) : 0;
  const int col = clampi(cx + 32 + j, 0, canvas_w - 1);
  float* dst = out + (size_t)win * win_h * 128 + lane;
  for (int r = 0; r < win_h; ++r) {
    const int row = clampi(cy + r, 0, canvas_h - 1);
    dst[r * 128] = canvas[(size_t)row * canvas_w + col];
  }
}

}  // namespace

extern "C" int kt_windows_paired(const void* canvas, const void* xy,
                                 void* out, int k, int canvas_h,
                                 int canvas_w, int hsum, int wimg, int win_h,
                                 void* stream) {
  const int k2 = (k + 1) / 2;
  if (k2 == 0) return 0;
  windows_paired_kernel<<<k2, 128, 0, (cudaStream_t)stream>>>(
      (const float*)canvas, (const int32_t*)xy, (float*)out, k, canvas_h,
      canvas_w, hsum, wimg, win_h);
  return (int)cudaGetLastError();
}
