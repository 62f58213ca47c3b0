// Minimal dependency-free image codecs for the C++ binding surface
// (reference: kornia-cpp exposes read_image_* + ImageU8C3; the TPU
// build's native layer ships binary PGM/PPM so C++ consumers can
// round-trip frames into the RVL/CCL components without Python).
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

extern "C" {

// Read binary PGM (P5, channels=1) or PPM (P6, channels=3).
// On success fills *h/*w/*c and returns a malloc'd buffer the caller
// frees with kornia_image_free; returns nullptr on failure.
uint8_t* kornia_image_read_pnm(const char* path, int64_t* h, int64_t* w,
                               int64_t* c) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  char magic[3] = {0, 0, 0};
  if (std::fscanf(f, "%2s", magic) != 1) { std::fclose(f); return nullptr; }
  int channels;
  if (std::strcmp(magic, "P5") == 0) channels = 1;
  else if (std::strcmp(magic, "P6") == 0) channels = 3;
  else { std::fclose(f); return nullptr; }

  // skip whitespace + comments, then read width/height/maxval
  long vals[3];
  for (int i = 0; i < 3; ++i) {
    int ch;
    do {
      ch = std::fgetc(f);
      if (ch == '#') { while (ch != '\n' && ch != EOF) ch = std::fgetc(f); }
    } while (ch == ' ' || ch == '\t' || ch == '\n' || ch == '\r');
    if (ch == EOF) { std::fclose(f); return nullptr; }
    std::ungetc(ch, f);
    if (std::fscanf(f, "%ld", &vals[i]) != 1) { std::fclose(f); return nullptr; }
  }
  if (vals[2] != 255 || vals[0] <= 0 || vals[1] <= 0 ||
      vals[0] > 1 << 20 || vals[1] > 1 << 20) {
    std::fclose(f);
    return nullptr;
  }
  std::fgetc(f);  // single whitespace after maxval
  const int64_t W = vals[0], H = vals[1];
  const size_t n = (size_t)W * H * channels;
  uint8_t* buf = (uint8_t*)std::malloc(n);
  if (!buf) { std::fclose(f); return nullptr; }
  if (std::fread(buf, 1, n, f) != n) {
    std::free(buf);
    std::fclose(f);
    return nullptr;
  }
  std::fclose(f);
  *h = H; *w = W; *c = channels;
  return buf;
}

// Write binary PGM/PPM (c must be 1 or 3). Returns 0 on success.
int64_t kornia_image_write_pnm(const char* path, const uint8_t* data,
                               int64_t h, int64_t w, int64_t c) {
  if (c != 1 && c != 3) return -1;
  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  std::fprintf(f, "%s\n%lld %lld\n255\n", c == 1 ? "P5" : "P6",
               (long long)w, (long long)h);
  const size_t n = (size_t)w * h * c;
  const int64_t ok = std::fwrite(data, 1, n, f) == n ? 0 : -1;
  std::fclose(f);
  return ok;
}

void kornia_image_free(uint8_t* buf) { std::free(buf); }

// RGB -> grayscale (BT.601 integer rounding, matches the reference's
// u8 gray path semantics) — a host-side convenience for C++ consumers.
void kornia_gray_from_rgb_u8(const uint8_t* rgb, int64_t h, int64_t w,
                             uint8_t* gray) {
  const int64_t n = h * w;
  for (int64_t i = 0; i < n; ++i) {
    const uint32_t r = rgb[3 * i], g = rgb[3 * i + 1], b = rgb[3 * i + 2];
    gray[i] = (uint8_t)((19595u * r + 38470u * g + 7471u * b + 32768u) >> 16);
  }
}

}  // extern "C"
