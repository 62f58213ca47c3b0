// Connected-component labeling — native C++ core.
//
// Two-pass 4/8-connectivity labeling with union-find path compression
// over a u8 mask, plus a variant over an arbitrary u8 "class" image that
// only merges equal-valued neighbors (the AprilTag threshold image case;
// reference capability: kornia-apriltag/src/{rle_cc,union_find}.rs and
// kornia-imgproc connected_components.rs). Union-find is pointer-chasing
// and branchy — hostile to both TPU and numpy — hence native.

#include <cstdint>
#include <vector>

namespace {

struct UnionFind {
    std::vector<int32_t> parent;

    explicit UnionFind(int64_t n) : parent(n) {
        for (int64_t i = 0; i < n; ++i) parent[i] = static_cast<int32_t>(i);
    }

    int32_t find(int32_t x) {
        int32_t root = x;
        while (parent[root] != root) root = parent[root];
        while (parent[x] != root) {  // path compression
            int32_t next = parent[x];
            parent[x] = root;
            x = next;
        }
        return root;
    }

    void unite(int32_t a, int32_t b) {
        a = find(a); b = find(b);
        if (a == b) return;
        if (a < b) parent[b] = a; else parent[a] = b;
    }
};

}  // namespace

extern "C" {

// Label nonzero pixels of `mask` (h*w u8). Writes labels (0 = background,
// components numbered 1..k in raster order of first pixel). Returns k.
int64_t kornia_ccl_label(const uint8_t* mask, int64_t h, int64_t w,
                         int32_t connectivity, int32_t* labels) {
    const int64_t n = h * w;
    UnionFind uf(n);
    for (int64_t y = 0; y < h; ++y) {
        for (int64_t x = 0; x < w; ++x) {
            const int64_t i = y * w + x;
            if (!mask[i]) continue;
            if (x > 0 && mask[i - 1]) uf.unite((int32_t)i, (int32_t)(i - 1));
            if (y > 0 && mask[i - w]) uf.unite((int32_t)i, (int32_t)(i - w));
            if (connectivity == 8 && y > 0) {
                if (x > 0 && mask[i - w - 1])
                    uf.unite((int32_t)i, (int32_t)(i - w - 1));
                if (x + 1 < w && mask[i - w + 1])
                    uf.unite((int32_t)i, (int32_t)(i - w + 1));
            }
        }
    }
    std::vector<int32_t> remap(n, 0);
    int32_t next_label = 0;
    for (int64_t i = 0; i < n; ++i) {
        if (!mask[i]) { labels[i] = 0; continue; }
        const int32_t root = uf.find((int32_t)i);
        if (remap[root] == 0) remap[root] = ++next_label;
        labels[i] = remap[root];
    }
    return next_label;
}

// Label same-valued regions of a u8 class image (e.g. AprilTag
// black/white/unknown threshold output), skipping pixels whose value is
// `skip` (e.g. 127 = unknown). 4-connectivity merge on equal values;
// WHITE (255) pixels additionally merge across the two top diagonals —
// the apriltag C library's rule (reference segmentation.rs
// cc_strip_phase1: white is 8-connected so a tag's white bit cells
// touching only at corners stay ONE component and its boundary stays
// ONE gradient cluster).
int64_t kornia_ccl_label_classes(const uint8_t* img, int64_t h, int64_t w,
                                 uint8_t skip, int32_t* labels) {
    const int64_t n = h * w;
    UnionFind uf(n);
    for (int64_t y = 0; y < h; ++y) {
        for (int64_t x = 0; x < w; ++x) {
            const int64_t i = y * w + x;
            const uint8_t v = img[i];
            if (v == skip) continue;
            if (x > 0 && img[i - 1] == v)
                uf.unite((int32_t)i, (int32_t)(i - 1));
            if (y > 0 && img[i - w] == v)
                uf.unite((int32_t)i, (int32_t)(i - w));
            if (v == 255 && y > 0) {
                if (x > 0 && img[i - w - 1] == v)
                    uf.unite((int32_t)i, (int32_t)(i - w - 1));
                if (x < w - 1 && img[i - w + 1] == v)
                    uf.unite((int32_t)i, (int32_t)(i - w + 1));
            }
        }
    }
    std::vector<int32_t> remap(n, 0);
    int32_t next_label = 0;
    for (int64_t i = 0; i < n; ++i) {
        if (img[i] == skip) { labels[i] = 0; continue; }
        const int32_t root = uf.find((int32_t)i);
        if (remap[root] == 0) remap[root] = ++next_label;
        labels[i] = remap[root];
    }
    return next_label;
}

}  // extern "C"
