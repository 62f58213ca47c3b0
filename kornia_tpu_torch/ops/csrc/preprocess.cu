// Fused preprocess: (H, W, 3) u8 -> (3, out_h, out_w) f32, bilinear resize,
// per-channel normalisation and the HWC -> CHW transpose in one pass.
//
// Replaces: kornia_tpu/ops/pallas_kernels.py::fused_preprocess_pallas (the
//   one-program variant of kornia_tpu/ops/preprocess.py's
//   resize_normalize_to_tensor).
//
// Contract: out[c, oy, ox] = (sum_y Wy[oy, y] * (sum_x Wx[ox, x] *
//   rgb[y, x, c])) * scale[c] + bias[c], horizontal pass first, then
//   vertical, then the epilogue, the order of the TPU kernel's body
//   (pallas_kernels.py:97-108). The TPU kernel multiplies by the dense band
//   matrices of resize._resize_matrix(..., "bilinear", False); a row of such
//   a matrix has at most two non-zero entries (edge taps clamped and
//   merged), so here each pass is the two-tap sum w0 * v[i0] + w1 * v[i1]
//   with (i0, w0), (i1, w1) read off the matrix rows by the wrapper (i0 < i1;
//   a merged row has w1 = 0). Every product and sum is rounded to float32
//   on its own (no FMA), so the result equals the same formula written in
//   PyTorch ops bit for bit, and the dense float32 matrix products to their
//   summation order.
//
// Bound on H100: memory. It reads the source pixels the taps touch once
//   (at most H * W * 3 bytes, 6.2 MB at 1080p) and writes 3 * out_h * out_w
//   * 4 bytes (4.9 MB at 640 x 640). Design: one thread per output pixel,
//   the three channels in a loop, so each tap is 3 neighbouring bytes and
//   the three plane writes are coalesced along ox; a block is 32 x 8 output
//   pixels, whose taps share source rows in L1. No shared memory: the four
//   taps of neighbouring outputs overlap little at a 3:1 reduction.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Norm {
  float scale[3];
  float bias[3];
};

__global__ void preprocess_kernel(const uint8_t* __restrict__ rgb, int w,
                                  const int32_t* __restrict__ yi,
                                  const float* __restrict__ yw,
                                  const int32_t* __restrict__ xi,
                                  const float* __restrict__ xw, Norm norm,
                                  float* __restrict__ out, int oh, int ow) {
  const int ox = blockIdx.x * blockDim.x + threadIdx.x;
  const int oy = blockIdx.y * blockDim.y + threadIdx.y;
  if (ox >= ow || oy >= oh) return;
  const int x0 = xi[2 * ox], x1 = xi[2 * ox + 1];
  const float wx0 = xw[2 * ox], wx1 = xw[2 * ox + 1];
  const int y0 = yi[2 * oy], y1 = yi[2 * oy + 1];
  const float wy0 = yw[2 * oy], wy1 = yw[2 * oy + 1];
  const uint8_t* r0 = rgb + (size_t)y0 * w * 3;
  const uint8_t* r1 = rgb + (size_t)y1 * w * 3;
  const size_t plane = (size_t)oh * ow;
  float* dst = out + (size_t)oy * ow + ox;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float h0 = __fadd_rn(__fmul_rn((float)r0[3 * x0 + c], wx0),
                               __fmul_rn((float)r0[3 * x1 + c], wx1));
    const float h1 = __fadd_rn(__fmul_rn((float)r1[3 * x0 + c], wx0),
                               __fmul_rn((float)r1[3 * x1 + c], wx1));
    const float v = __fadd_rn(__fmul_rn(h0, wy0), __fmul_rn(h1, wy1));
    dst[c * plane] = __fadd_rn(__fmul_rn(v, norm.scale[c]), norm.bias[c]);
  }
}

}  // namespace

extern "C" int kt_preprocess(const void* rgb, int w, const void* yi,
                             const void* yw, const void* xi, const void* xw,
                             const float* scale, const float* bias, void* out,
                             int oh, int ow, void* stream) {
  if (oh == 0 || ow == 0) return 0;
  Norm norm;
  for (int c = 0; c < 3; ++c) {
    norm.scale[c] = scale[c];
    norm.bias[c] = bias[c];
  }
  dim3 block(32, 8);
  dim3 grid((ow + 31) / 32, (oh + 7) / 8);
  preprocess_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)rgb, w, (const int32_t*)yi, (const float*)yw,
      (const int32_t*)xi, (const float*)xw, norm, (float*)out, oh, ow);
  return (int)cudaGetLastError();
}
