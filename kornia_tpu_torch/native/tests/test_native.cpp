// C++ consumer test for the kornia_tpu_torch native C API.
//
// Parity with the reference's kornia-cpp/tests/*.cpp: exercises the
// public header from plain C++ (round-trips + error paths), built and
// run by tests/test_torch_io_codecs.py.

#include "../include/kornia_tpu_native.h"

#include <cassert>
#include <cstdio>
#include <cstring>
#include <algorithm>
#include <random>
#include <vector>

static void test_rvl_roundtrip() {
    std::mt19937 rng(7);
    const int64_t n = 64 * 80;
    std::vector<uint16_t> depth(n);
    for (auto& d : depth) {
        d = (rng() % 10 < 4) ? 0 : static_cast<uint16_t>(500 + rng() % 4000);
    }
    std::vector<uint8_t> blob(2 * n + 16);
    const int64_t nbytes =
        kornia_rvl_compress(depth.data(), n, blob.data(), blob.size());
    assert(nbytes > 0);
    std::vector<uint16_t> back(n, 0xFFFF);
    const int64_t rc =
        kornia_rvl_decompress(blob.data(), nbytes, back.data(), n);
    assert(rc == 0);
    assert(std::memcmp(depth.data(), back.data(), n * 2) == 0);

    // truncated stream must fail cleanly
    std::vector<uint16_t> junk(n);
    assert(kornia_rvl_decompress(blob.data(), nbytes / 2, junk.data(), n)
           != 0);
    std::printf("rvl roundtrip ok (%lld -> %lld bytes)\n",
                static_cast<long long>(n * 2),
                static_cast<long long>(nbytes));
}

static void test_ccl() {
    const int64_t h = 8, w = 8;
    uint8_t mask[64] = {0};
    // two separate 2x2 blobs
    mask[1 * w + 1] = mask[1 * w + 2] = mask[2 * w + 1] = mask[2 * w + 2] = 1;
    mask[5 * w + 5] = mask[5 * w + 6] = mask[6 * w + 5] = mask[6 * w + 6] = 1;
    int32_t labels[64];
    const int64_t k = kornia_ccl_label(mask, h, w, 4, labels);
    assert(k == 2);
    assert(labels[0] == 0);
    assert(labels[1 * w + 1] == 1);
    assert(labels[5 * w + 5] == 2);
    std::printf("ccl ok (%lld components)\n", static_cast<long long>(k));
}

static void test_apriltag_quads() {
    // 64x64: white field with a 24x24 black square at (16,16): its
    // black/white boundary must fit as one quad near those corners
    const int64_t h = 64, w = 64;
    std::vector<uint8_t> thr(h * w, 255);
    for (int64_t y = 16; y < 40; ++y)
        for (int64_t x = 16; x < 40; ++x) thr[y * w + x] = 0;
    float quads[4 * 8];
    const int64_t nq = kornia_apriltag_quads(
        thr.data(), h, w, /*skip=*/127, /*min_cluster=*/24,
        /*max_cluster=*/50000, /*min_tag_area=*/64.f, quads, 4);
    assert(nq == 1);
    float xmin = 1e9f, xmax = -1e9f, ymin = 1e9f, ymax = -1e9f;
    for (int i = 0; i < 4; ++i) {
        xmin = std::min(xmin, quads[2 * i]);
        xmax = std::max(xmax, quads[2 * i]);
        ymin = std::min(ymin, quads[2 * i + 1]);
        ymax = std::max(ymax, quads[2 * i + 1]);
    }
    assert(xmin > 13.f && xmin < 18.f && xmax > 37.f && xmax < 42.f);
    assert(ymin > 13.f && ymin < 18.f && ymax > 37.f && ymax < 42.f);
    std::printf("apriltag quads ok (%lld quad)\n",
                static_cast<long long>(nq));
}

int main() {
    test_rvl_roundtrip();
    test_ccl();
    test_apriltag_quads();
    std::printf("NATIVE CPP TESTS PASSED\n");
    return 0;
}
