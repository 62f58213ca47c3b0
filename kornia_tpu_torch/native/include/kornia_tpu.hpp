// Header-only C++ convenience wrapper over the kornia_tpu native C API
// (parity with kornia-cpp's ergonomic surface: kornia::image::ImageU8C3,
// kornia::io::..., Rust Result -> C++ exceptions; reference
// kornia-cpp/include/kornia/, README.md:1-20).
//
// Link against the library kornia_tpu_torch/native/build.py builds under
// kornia_tpu_torch/_build/ (or add rvl.cpp ccl.cpp image_io.cpp to your
// build) and:
//
//   #include <kornia_tpu.hpp>
//   auto img  = kornia::read_image_pnm("frame.ppm");     // RAII
//   auto gray = kornia::gray_from_rgb(img);
//   auto rvl  = kornia::rvl_compress(depth);             // std::vector
#ifndef KORNIA_TPU_HPP_
#define KORNIA_TPU_HPP_

#include <cstdint>
#include <stdexcept>
#include <string>
#include <vector>

#include "kornia_tpu_native.h"

extern "C" {
uint8_t* kornia_image_read_pnm(const char*, int64_t*, int64_t*, int64_t*);
int64_t kornia_image_write_pnm(const char*, const uint8_t*, int64_t,
                               int64_t, int64_t);
void kornia_image_free(uint8_t*);
void kornia_gray_from_rgb_u8(const uint8_t*, int64_t, int64_t, uint8_t*);
}

namespace kornia {

// Owning HWC u8 image (rows*cols*channels contiguous) — the C++ analogue
// of the Python-side Image wrapper.
struct ImageU8 {
  int64_t rows = 0, cols = 0, channels = 0;
  std::vector<uint8_t> data;

  int64_t size_bytes() const { return rows * cols * channels; }
  uint8_t& at(int64_t y, int64_t x, int64_t ch = 0) {
    return data[(y * cols + x) * channels + ch];
  }
  uint8_t at(int64_t y, int64_t x, int64_t ch = 0) const {
    return data[(y * cols + x) * channels + ch];
  }
};

inline ImageU8 read_image_pnm(const std::string& path) {
  int64_t h, w, c;
  uint8_t* buf = kornia_image_read_pnm(path.c_str(), &h, &w, &c);
  if (!buf) throw std::runtime_error("kornia: cannot read " + path);
  ImageU8 img;
  img.rows = h; img.cols = w; img.channels = c;
  img.data.assign(buf, buf + h * w * c);
  kornia_image_free(buf);
  return img;
}

inline void write_image_pnm(const std::string& path, const ImageU8& img) {
  if (kornia_image_write_pnm(path.c_str(), img.data.data(), img.rows,
                             img.cols, img.channels) != 0)
    throw std::runtime_error("kornia: cannot write " + path);
}

inline ImageU8 gray_from_rgb(const ImageU8& rgb) {
  if (rgb.channels != 3)
    throw std::invalid_argument("kornia: gray_from_rgb needs 3 channels");
  ImageU8 out;
  out.rows = rgb.rows; out.cols = rgb.cols; out.channels = 1;
  out.data.resize(rgb.rows * rgb.cols);
  kornia_gray_from_rgb_u8(rgb.data.data(), rgb.rows, rgb.cols,
                          out.data.data());
  return out;
}

inline std::vector<uint8_t> rvl_compress(const std::vector<uint16_t>& d) {
  std::vector<uint8_t> out(2 * d.size() + 8);
  const int64_t n = kornia_rvl_compress(d.data(), (int64_t)d.size(),
                                        out.data(), (int64_t)out.size());
  if (n < 0) throw std::runtime_error("kornia: rvl_compress overflow");
  out.resize((size_t)n);
  return out;
}

inline std::vector<uint16_t> rvl_decompress(const std::vector<uint8_t>& c,
                                            int64_t n_values) {
  std::vector<uint16_t> out((size_t)n_values);
  if (kornia_rvl_decompress(c.data(), (int64_t)c.size(), out.data(),
                            n_values) != 0)
    throw std::runtime_error("kornia: rvl_decompress failed");
  return out;
}

inline std::vector<int32_t> ccl_label(const ImageU8& mask,
                                      int connectivity, int64_t* n_out) {
  if (mask.channels != 1)
    throw std::invalid_argument("kornia: ccl_label needs 1 channel");
  std::vector<int32_t> labels((size_t)(mask.rows * mask.cols));
  const int64_t k = kornia_ccl_label(mask.data.data(), mask.rows,
                                     mask.cols, connectivity,
                                     labels.data());
  if (n_out) *n_out = k;
  return labels;
}

}  // namespace kornia

#endif  // KORNIA_TPU_HPP_
