// Rotated BRIEF from keypoint windows. Two entries:
//
//   kt_brief_rotated: windows + (cos, sin) per keypoint + the pattern ->
//     the 256 descriptor bits (or the 512 samples) of every keypoint. The
//     path of features/orb.py runs this one.
//   kt_brief_sample: out[k, t] = windows[k, rows[k, t], cols[k, t]], the
//     index form with the signature of the TPU kernel, kept beside it.
//
// Replaces: kornia_tpu/ops/pallas_kernels.py::brief_sample_pallas (called
//   by kornia_tpu/features/orb.py:420, once per frame on the paired
//   (K/2, 40, 128) blurred windows with 1024 taps per window). The TPU
//   kernel's point is "read the windows once, keep the rest on chip".
//
// What the index form lost on this card. It reads 8 bytes of int32
//   (row, col) per tap to fetch 4 bytes of window and writes 4 bytes: of
//   the 16 MB a paired call moves, 12 MB are indices and samples. Those
//   exist only because the rotation, the rounding, the clamps and the
//   A < B compare ran as ~20 small PyTorch ops on (2000, 512) tensors
//   around the kernel, each more than 10 us of host time on a path whose
//   device idles; and its gathers are 4-byte reads scattered over a 20 KB
//   window (up to 1024 32-byte sectors to use 4 KB).
//
// kt_brief_rotated, the design. One 256-thread block per window. The
//   block copies its window (20 KB paired, 24 KB unpaired; contiguous and
//   16-byte aligned) into shared memory with 16-byte cp.async, so the
//   window is read once, coalesced. Thread j then computes bit j of each
//   keypoint of the window: it rotates the pattern's tap pair j by the
//   keypoint's (cos, sin), rounds, clamps to the layout, reads A and B
//   from shared memory and stores (A < B) as one byte; a warp's 32 bytes
//   are contiguous. No index tensor and no sample tensor exists.
//   Contract: the arithmetic of features/orb.py::_brief_tap_coords, op for
//   op: dx = rint(px*c - py*s), dy = rint(px*s + py*c), every product,
//   difference and sum a separately rounded f32 op (__fmul_rn, __fsub_rn,
//   __fadd_rn; the file is built with -fmad=false), rintf = half to even
//   as torch.round. cos and sin come from torch.cos / torch.sin, so the
//   kernel is bit-equal to cuda_kernels.py::_brief_rotated_plain.
//   Layouts: paired = two keypoints per (40, 128) window, centres (20, 32)
//   and (20, 96), columns clamped to each half's 64 lanes, rows to
//   [0, 39]; unpaired = one keypoint per (48, 128) window, centre
//   (24, 64), clamps [0, 47] x [0, 127].
//
// Bound on H100: memory. The function needs the window values its taps
//   touch (at most 512 per keypoint, about 3 MB at 2000 keypoints), 16 KB
//   of cos, sin and pattern, and writes 0.5 MB of bits: about 0.001 ms at
//   3.35 TB/s. This design moves more than that bound counts: it stages
//   every window whole, 20.5 MB a paired call (0.0063 ms at the HBM rate),
//   to read it coalesced. The windows were written just before by the
//   window kernel and fit the 50 MB L2, so the copies mostly hit L2.
//   windows and pattern must start on a 16-byte boundary (the wrapper
//   refuses a slice that does not).
//
// kt_brief_sample: bit-equal to the take_along_axis branch
//   (orb.py:422-423), a gather from the flattened window at
//   rows*128 + cols with the coordinates clamped to the window. One thread
//   per (window, tap), 256 taps per block along one window's taps, so the
//   index reads and the output writes are coalesced.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WIN_W = 128;
constexpr int PAIR_H = 40, PAIR_CY = 20;
constexpr int UNP_H = 48, UNP_CY = 24, UNP_CX = 64;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// One block per window, thread j = descriptor bit j. PAIRED: window w
// holds keypoints 2w (lanes [0, 64)) and 2w+1 (lanes [64, 128)).
template <bool PAIRED, bool SAMPLES>
__global__ void __launch_bounds__(256)
brief_rotated_kernel(const float* __restrict__ windows,
                     const float* __restrict__ cosv,
                     const float* __restrict__ sinv,
                     const int4* __restrict__ pattern,
                     void* __restrict__ out, int k) {
  constexpr int WH = PAIRED ? PAIR_H : UNP_H;
  constexpr int CHUNKS = WH * WIN_W / 4;          // 16-byte pieces
  __shared__ __align__(16) float win[WH * WIN_W];
  const int j = threadIdx.x;
  const float4* src =
      reinterpret_cast<const float4*>(windows + (size_t)blockIdx.x * WH * WIN_W);
  float4* dst = reinterpret_cast<float4*>(win);
  for (int i = j; i < CHUNKS; i += 256)
    __pipeline_memcpy_async(dst + i, src + i, 16);
  __pipeline_commit();
  // the pattern and the angles arrive while the window is in flight
  const int4 tap = pattern[j];
  const float ax = (float)tap.x, ay = (float)tap.y;
  const float bx = (float)tap.z, by = (float)tap.w;
  constexpr int PER = PAIRED ? 2 : 1;
  float c[PER], s[PER];
#pragma unroll
  for (int h = 0; h < PER; ++h) {
    const int kp = blockIdx.x * PER + h;
    c[h] = kp < k ? cosv[kp] : 1.f;
    s[h] = kp < k ? sinv[kp] : 0.f;
  }
  __pipeline_wait_prior(0);
  __syncthreads();
#pragma unroll
  for (int h = 0; h < PER; ++h) {
    const int kp = blockIdx.x * PER + h;
    if (kp >= k) break;
    const int adx = (int)rintf(__fsub_rn(__fmul_rn(ax, c[h]), __fmul_rn(ay, s[h])));
    const int ady = (int)rintf(__fadd_rn(__fmul_rn(ax, s[h]), __fmul_rn(ay, c[h])));
    const int bdx = (int)rintf(__fsub_rn(__fmul_rn(bx, c[h]), __fmul_rn(by, s[h])));
    const int bdy = (int)rintf(__fadd_rn(__fmul_rn(bx, s[h]), __fmul_rn(by, c[h])));
    int ac, ar, bc, br;
    if (PAIRED) {
      ac = clampi(32 + adx, 0, 63) + 64 * h;
      bc = clampi(32 + bdx, 0, 63) + 64 * h;
      ar = clampi(PAIR_CY + ady, 0, PAIR_H - 1);
      br = clampi(PAIR_CY + bdy, 0, PAIR_H - 1);
    } else {
      ac = clampi(UNP_CX + adx, 0, WIN_W - 1);
      bc = clampi(UNP_CX + bdx, 0, WIN_W - 1);
      ar = clampi(UNP_CY + ady, 0, UNP_H - 1);
      br = clampi(UNP_CY + bdy, 0, UNP_H - 1);
    }
    const float a = win[ar * WIN_W + ac];
    const float b = win[br * WIN_W + bc];
    if (SAMPLES) {
      float* o = (float*)out + (size_t)kp * 512;
      o[j] = a;
      o[256 + j] = b;
    } else {
      ((uint8_t*)out)[(size_t)kp * 256 + j] = a < b ? 1 : 0;
    }
  }
}

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

// windows: (K/2, 40, 128) f32 (paired != 0) or (K, 48, 128); cosv, sinv:
// (K,) f32; pattern: (256, 4) int32; out: (K, 256) u8 bits, or (K, 512)
// f32 samples when samples != 0.
extern "C" int kt_brief_rotated(const void* windows, const void* cosv,
                                const void* sinv, const void* pattern,
                                void* out, int k, int paired, int samples,
                                void* stream) {
  if (k == 0) return 0;
  const float* w = (const float*)windows;
  const float* c = (const float*)cosv;
  const float* s = (const float*)sinv;
  const int4* p = (const int4*)pattern;
  cudaStream_t st = (cudaStream_t)stream;
  dim3 block(256);
  if (paired) {
    dim3 grid((k + 1) / 2);
    if (samples)
      brief_rotated_kernel<true, true><<<grid, block, 0, st>>>(w, c, s, p, out, k);
    else
      brief_rotated_kernel<true, false><<<grid, block, 0, st>>>(w, c, s, p, out, k);
  } else {
    dim3 grid(k);
    if (samples)
      brief_rotated_kernel<false, true><<<grid, block, 0, st>>>(w, c, s, p, out, k);
    else
      brief_rotated_kernel<false, false><<<grid, block, 0, st>>>(w, c, s, p, out, k);
  }
  return (int)cudaGetLastError();
}

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
