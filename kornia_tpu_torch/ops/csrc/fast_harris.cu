// FAST-9 score + threshold + 3-px border kill + 3x3 NMS, and the dense
// Harris map (central gradients, 5-tap Gaussian window), in one pass.
//
// Replaces: kornia_tpu/ops/pallas_kernels.py::fast_score_pallas
//   (nms=True, harris=True), called once per pyramid level by ORB
//   (kornia_tpu/features/orb.py:458).
//
// Contract: bit-equal to the plain PyTorch composition
//   nms_maxpool(fast_score(img, thr)) and
//   harris_response(img, grad="central", block 5, sigma 1)
//   (kornia_tpu_torch/ops/cuda_kernels.py::_fast_harris_plain), at EVERY
//   pixel: the Harris map uses the reference padding (edge-replicated
//   gradients, reflect-101 window; responses.py:22-25, filters.py:22-27),
//   not the Pallas kernel's zero padding, and every multiply and add is a
//   separately rounded float32 op in the plain version's order (vertical
//   taps ascending, then horizontal, first term assigned; det - (k*tr)*tr).
//   __fmul_rn/__fadd_rn keep nvcc from contracting them into FMAs (the file
//   is also built with -fmad=false). ORB quantizes Harris to 13 bits before
//   ranking, so one ULP could move a keypoint across a bucket.
//
// Bound on H100: operations, narrowly. Per pixel it reads 1 byte and
//   writes 8 (two f32 maps), while FAST (16 ring differences and the
//   9-of-16 arc min/max), the NMS and Harris need about 250 integer and f32
//   ops, so at 3.35 TB/s and 67 T op/s the op count is the larger bound;
//   the min/max chains are integer ops, which issue at a lower rate than
//   f32. Design: one 256-thread block per 32x16
//   output tile. The u8 tile with a 4-px halo (3 for the ring, 1 for the
//   NMS) is staged in shared memory once; the FAST score of the tile plus a
//   1-px ring, the three gradient products of the tile plus a 2-px ring and
//   the vertical window pass all live in shared memory, so global memory
//   sees one read of the image and one write of each output. The ring
//   differences are exact integers (the TPU's bf16 trick is not needed).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TW = 32;          // output tile width
constexpr int TH = 16;          // output tile height
constexpr int HALO = 4;         // 3 (ring) + 1 (NMS)
constexpr int IW = TW + 2 * HALO;
constexpr int IH = TH + 2 * HALO;
constexpr int SW = TW + 2;      // score tile with the NMS ring
constexpr int SH = TH + 2;
constexpr int PW = TW + 4;      // gradient products with the window ring
constexpr int PH = TH + 4;

__constant__ int c_ring_dy[16] = {-3, -3, -2, -1, 0, 1, 2, 3,
                                  3, 3, 2, 1, 0, -1, -2, -3};
__constant__ int c_ring_dx[16] = {0, 1, 2, 3, 3, 3, 2, 1,
                                  0, -1, -2, -3, -3, -3, -2, -1};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ int reflect101(int i, int n) {
  if (n == 1) return 0;
  if (i < 0) i = -i;
  if (i > n - 1) i = 2 * (n - 1) - i;
  return clampi(i, 0, n - 1);
}

__global__ void fast_harris_kernel(const uint8_t* __restrict__ img,
                                   float* __restrict__ score_out,
                                   float* __restrict__ harris_out,
                                   int h, int w, float threshold,
                                   float k0, float k1, float k2, float k3,
                                   float k4, float harris_k) {
  __shared__ int s_img[IH][IW];
  __shared__ float s_score[SH][SW];
  __shared__ float s_p[3][PH][PW];
  __shared__ float s_v[3][TH][PW];

  const int x0 = blockIdx.x * TW;
  const int y0 = blockIdx.y * TH;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthr = blockDim.x * blockDim.y;

  // 1. image tile + 4-px halo, edge-clamped (ring reads on the border are
  //    killed below; the gradients are edge-replicated, as the reference)
  for (int i = tid; i < IH * IW; i += nthr) {
    int r = i / IW, c = i % IW;
    int gy = clampi(y0 - HALO + r, 0, h - 1);
    int gx = clampi(x0 - HALO + c, 0, w - 1);
    s_img[r][c] = img[gy * w + gx];
  }
  __syncthreads();

  // 2. FAST score on the tile + 1-px ring (0 outside the image: scores
  //    are >= 0, so 0 and the reference's -inf pool padding agree)
  for (int i = tid; i < SH * SW; i += nthr) {
    int r = i / SW, c = i % SW;
    int gy = y0 - 1 + r, gx = x0 - 1 + c;
    float s = 0.0f;
    if (gy >= 3 && gy < h - 3 && gx >= 3 && gx < w - 3) {
      int cy = r + HALO - 1, cx = c + HALO - 1;
      int center = s_img[cy][cx];
      int d[16];
#pragma unroll
      for (int j = 0; j < 16; ++j)
        d[j] = s_img[cy + c_ring_dy[j]][cx + c_ring_dx[j]] - center;
      int bright = -1024, darkmin = 1024;
#pragma unroll
      for (int st = 0; st < 16; ++st) {
        int mn = d[st], mx = d[st];
#pragma unroll
        for (int j = 1; j < 9; ++j) {
          int v = d[(st + j) & 15];
          mn = v < mn ? v : mn;
          mx = v > mx ? v : mx;
        }
        bright = mn > bright ? mn : bright;
        darkmin = mx < darkmin ? mx : darkmin;
      }
      int sc = bright > -darkmin ? bright : -darkmin;
      float fs = (float)sc;
      s = fs > threshold ? fs : 0.0f;
    }
    s_score[r][c] = s;
  }

  // 3. gradient products on the tile + 2-px ring; position (r, c) holds
  //    the product at image pixel reflect101(y0-2+r), reflect101(x0-2+c),
  //    with central gradients over edge-clamped neighbours
  for (int i = tid; i < PH * PW; i += nthr) {
    int r = i / PW, c = i % PW;
    int iy = reflect101(y0 - 2 + r, h);
    int ix = reflect101(x0 - 2 + c, w);
    // image rows/cols -> staged tile coordinates (clamped for positions
    // that no written output reads)
    int ty = clampi(iy - (y0 - HALO), 1, IH - 2);
    int tx = clampi(ix - (x0 - HALO), 1, IW - 2);
    int ty_m = clampi(iy - 1, 0, h - 1) - (y0 - HALO);
    int ty_p = clampi(iy + 1, 0, h - 1) - (y0 - HALO);
    int tx_m = clampi(ix - 1, 0, w - 1) - (x0 - HALO);
    int tx_p = clampi(ix + 1, 0, w - 1) - (x0 - HALO);
    ty_m = clampi(ty_m, 0, IH - 1);
    ty_p = clampi(ty_p, 0, IH - 1);
    tx_m = clampi(tx_m, 0, IW - 1);
    tx_p = clampi(tx_p, 0, IW - 1);
    float gx = __fmul_rn(0.5f, (float)(s_img[ty][tx_p] - s_img[ty][tx_m]));
    float gy = __fmul_rn(0.5f, (float)(s_img[ty_p][tx] - s_img[ty_m][tx]));
    s_p[0][r][c] = __fmul_rn(gx, gx);
    s_p[1][r][c] = __fmul_rn(gy, gy);
    s_p[2][r][c] = __fmul_rn(gx, gy);
  }
  __syncthreads();

  // 4. vertical window pass (taps ascending, first term assigned)
  for (int i = tid; i < 3 * TH * PW; i += nthr) {
    int m = i / (TH * PW);
    int rem = i % (TH * PW);
    int r = rem / PW, c = rem % PW;
    float acc = __fmul_rn(s_p[m][r][c], k0);
    acc = __fadd_rn(acc, __fmul_rn(s_p[m][r + 1][c], k1));
    acc = __fadd_rn(acc, __fmul_rn(s_p[m][r + 2][c], k2));
    acc = __fadd_rn(acc, __fmul_rn(s_p[m][r + 3][c], k3));
    acc = __fadd_rn(acc, __fmul_rn(s_p[m][r + 4][c], k4));
    s_v[m][r][c] = acc;
  }
  __syncthreads();

  // 5. horizontal pass + Harris, and the 3x3 NMS of the score
  for (int i = tid; i < TH * TW; i += nthr) {
    int r = i / TW, c = i % TW;
    int gy = y0 + r, gx = x0 + c;
    if (gy >= h || gx >= w) continue;
    float s[3];
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      float acc = __fmul_rn(s_v[m][r][c], k0);
      acc = __fadd_rn(acc, __fmul_rn(s_v[m][r][c + 1], k1));
      acc = __fadd_rn(acc, __fmul_rn(s_v[m][r][c + 2], k2));
      acc = __fadd_rn(acc, __fmul_rn(s_v[m][r][c + 3], k3));
      acc = __fadd_rn(acc, __fmul_rn(s_v[m][r][c + 4], k4));
      s[m] = acc;
    }
    float det = __fsub_rn(__fmul_rn(s[0], s[1]), __fmul_rn(s[2], s[2]));
    float tr = __fadd_rn(s[0], s[1]);
    float hv = __fsub_rn(det, __fmul_rn(__fmul_rn(harris_k, tr), tr));
    harris_out[gy * w + gx] = hv;

    float sc = s_score[r + 1][c + 1];
    float pooled = sc;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
        pooled = fmaxf(pooled, s_score[r + dy][c + dx]);
    score_out[gy * w + gx] = sc >= pooled ? sc : 0.0f;
  }
}

}  // namespace

extern "C" int kt_fast_harris(const void* img, void* score_out,
                              void* harris_out, int h, int w,
                              float threshold, const float* window5,
                              float harris_k, void* stream) {
  dim3 block(32, 8);
  dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH);
  fast_harris_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)img, (float*)score_out, (float*)harris_out, h, w,
      threshold, window5[0], window5[1], window5[2], window5[3], window5[4],
      harris_k);
  return (int)cudaGetLastError();
}
