// Keypoint windows: one (win_h, 128) float32 window per keypoint,
// edge-replicated at the borders.
//
// Replaces: kornia_tpu/ops/pallas_kernels.py::extract_windows_prepared
//   (with its wrapper extract_windows_pallas and the pad of
//   prepare_window_source), called by the unpaired and quadtree ORB
//   describe stages (kornia_tpu/features/orb.py:153, 327), by
//   features/responses.py::harris_at_windows and by both window
//   formulations of pyramidal Lucas-Kanade (ops/optical_flow.py:166, 318).
//
// Contract: out[k, r, c] = src[clamp(cy + r - oy, 0, src_h - 1),
//                              clamp(cx + c - ox, 0, src_w - 1)]
//   with (cx, cy) = clip(xy[k], 0, (xmax, ymax)), as pallas_kernels.py:409
//   clips. Two call shapes share it:
//   * a single frame: (oy, ox) = (cy_off, cx_off), (xmax, ymax) =
//     (w - 1, h - 1); the clamp of the read is the edge replication, so the
//     frame needs no padding;
//   * a level-stacked canvas of cuda_kernels.prepare_window_canvas:
//     (oy, ox) = (0, 0), xy in canvas coordinates (y offset by the level's
//     first canvas row), (xmax, ymax) = (widest level - 1, canvas rows - 1);
//     each level's replication is baked into its canvas rows.
//   The TPU kernel's 8-window groups, aligned (win_h + 8, 256) loads, rolls
//   and alignment pads have no counterpart here. Bit-equal to the plain
//   gather.
//
// Bound on H100: memory. It writes K * win_h * 128 * 4 bytes (49 MB for
//   K = 2000, win_h = 48) and reads as many source values, mostly from L2
//   (a 480x752 frame is 1.4 MB, its 8-level canvas 11 MB). Design: one block
//   per window, 128 lanes by 4 rows of threads; every warp writes 128
//   contiguous bytes of one window row and reads one contiguous run of a
//   source row; the block strides over the win_h rows. No shared memory:
//   each source value is read once per window.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowsPerBlock = 4;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__global__ void windows_kernel(const float* __restrict__ src,
                               const int32_t* __restrict__ xy,
                               float* __restrict__ out, int src_h, int src_w,
                               int xmax, int ymax, int oy, int ox,
                               int win_h) {
  const int kp = blockIdx.x;
  const int lane = threadIdx.x;           // 0..127
  const int cx = clampi(xy[2 * kp], 0, xmax);
  const int cy = clampi(xy[2 * kp + 1], 0, ymax);
  const int col = clampi(cx + lane - ox, 0, src_w - 1);
  float* dst = out + (size_t)kp * win_h * 128 + lane;
  for (int r = threadIdx.y; r < win_h; r += kRowsPerBlock) {
    const int row = clampi(cy + r - oy, 0, src_h - 1);
    dst[r * 128] = src[(size_t)row * src_w + col];
  }
}

}  // namespace

extern "C" int kt_windows(const void* src, const void* xy, void* out, int k,
                          int src_h, int src_w, int xmax, int ymax, int oy,
                          int ox, int win_h, void* stream) {
  if (k == 0 || win_h == 0) return 0;
  dim3 block(128, kRowsPerBlock);
  windows_kernel<<<k, block, 0, (cudaStream_t)stream>>>(
      (const float*)src, (const int32_t*)xy, (float*)out, src_h, src_w, xmax,
      ymax, oy, ox, win_h);
  return (int)cudaGetLastError();
}
