/* kornia_tpu native C API — C++ binding surface.
 *
 * Parity with the reference's kornia-cpp crate (CXX wrapper exposing the
 * native layer to C++ consumers with CMake find_package; reference:
 * kornia-cpp/include/kornia/, kornia-cpp/src/lib.rs). The native layer
 * of kornia_tpu_torch is this C ABI over the library that
 * kornia_tpu_torch/native/build.py compiles at first use into
 * kornia_tpu_torch/_build/libkornia_native_<hash>.so — link it directly
 * or dlopen it; the same symbols back the Python ctypes bindings.
 *
 * Build the library by hand:
 *   g++ -O3 -shared -fPIC -std=c++17 -o libkornia_native.so \
 *       ccl.cpp apriltag_mid.cpp rvl.cpp image_io.cpp capture.cpp
 * (or let the Python package build it at first use — see build.py.)
 */

#ifndef KORNIA_TPU_NATIVE_H_
#define KORNIA_TPU_NATIVE_H_

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

/* ------------------------------------------------------------------ RVL
 * Run-length + zigzag-delta nibble-VLQ depth compression
 * (Wilson, CVPR'17). Payload only — the RVL1 file header (magic +
 * u32 width/height LE) is the caller's concern. */

/* Compress n u16 depth values into out (capacity out_cap bytes;
 * worst case 2*n + 8). Returns bytes written, or -1 on overflow. */
int64_t kornia_rvl_compress(const uint16_t* in, int64_t n,
                            uint8_t* out, int64_t out_cap);

/* Decompress into exactly n values. Returns 0 on success, -1 on a
 * truncated/malformed stream, -2 on a size mismatch. */
int64_t kornia_rvl_decompress(const uint8_t* in, int64_t in_size,
                              uint16_t* out, int64_t n);

/* ------------------------------------------------------------------ CCL
 * Union-find connected components with path compression. */

/* Label nonzero pixels of mask (h*w u8, row-major) with 4- or
 * 8-connectivity. labels receives 0 for background and 1..K in raster
 * order of each component's first pixel. Returns K. */
int64_t kornia_ccl_label(const uint8_t* mask, int64_t h, int64_t w,
                         int32_t connectivity, int32_t* labels);

/* Label same-valued 4-connected regions of a u8 class image, skipping
 * pixels equal to `skip` (labelled 0). Returns the label count. */
int64_t kornia_ccl_label_classes(const uint8_t* img, int64_t h, int64_t w,
                                 uint8_t skip, int32_t* labels);

/* ------------------------------------------------------------- AprilTag
 * Fused mid-pipeline: CCL + black/white boundary clustering + cluster
 * filtering + quad fitting over a thresholded image (0 black /
 * 255 white / `skip` unknown). Writes up to max_quads quads as 8
 * floats each (CCW xy corners in image coords). Returns the number of
 * quads written, or -1 on bad input. */
int64_t kornia_apriltag_quads(const uint8_t* threshim, int64_t h,
                              int64_t w, uint8_t skip,
                              int32_t min_cluster, int32_t max_cluster,
                              float min_tag_area,
                              float* quads_out, int64_t max_quads);

#ifdef __cplusplus
}  /* extern "C" */
#endif

#endif  /* KORNIA_TPU_NATIVE_H_ */
