// AprilTag mid-pipeline — native C++ core.
//
// Fuses the irregular stages between the TPU threshold and the (sparse)
// tag decode: union-find CCL over the threshold classes, black/white
// boundary-point extraction, gradient clustering by (black,white) label
// pair, cluster pre-filtering, and quad fitting. One call replaces the
// host-numpy boundary/filter/quad stages (~240 ms/frame at 113 clusters
// in the round-2 trace; reference runs these fused at SIMD rate:
// kornia-apriltag/src/{rle_cc,segmentation,quad}.rs).
//
// The quad-fit algebra mirrors apriltag/detector.py::_fit_quad exactly
// (angular sort, strided farthest-pair diagonal, side extremes, trimmed
// total-least-squares side fits via the closed-form 2x2 covariance
// principal axis, corner intersections, area/convexity gates) so the
// native and numpy paths stay interchangeable to float roundoff.

#include <algorithm>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <vector>

namespace {

// KORNIA_APRILTAG_PROFILE=1 prints per-substage ms to stderr — the
// reference's time_stages.rs discipline for the host-bound chunk.
struct StageClock {
    bool on;
    std::chrono::steady_clock::time_point t;
    StageClock()
        : on(std::getenv("KORNIA_APRILTAG_PROFILE") != nullptr),
          t(std::chrono::steady_clock::now()) {}
    void mark(const char* name) {
        if (!on) return;
        auto now = std::chrono::steady_clock::now();
        std::fprintf(stderr, "# apriltag_mid %s: %.2f ms\n", name,
                     std::chrono::duration<double, std::milli>(now - t)
                         .count());
        t = now;
    }
};

struct UF {
    std::vector<int32_t> parent;
    explicit UF(int64_t n) : parent(n) {
        for (int64_t i = 0; i < n; ++i) parent[i] = (int32_t)i;
    }
    int32_t find(int32_t x) {
        int32_t root = x;
        while (parent[root] != root) root = parent[root];
        while (parent[x] != root) {
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

struct BPoint {
    uint64_t key;
    float x;   // image coords (already halved from the 2x grid)
    float y;
};

// Fit an ordered convex quad to one cluster; returns true and writes
// 4 CCW corners into q (x0,y0,...,x3,y3). Mirrors detector._fit_quad.
bool fit_quad(const std::vector<float>& px, const std::vector<float>& py,
              float min_tag_area, float* q) {
    const int64_t n = (int64_t)px.size();
    if (n < 8 || n >= (1ll << 20)) return false;  // 20-bit sort-key index
    double cx = 0.0, cy = 0.0;
    for (int64_t i = 0; i < n; ++i) { cx += px[i]; cy += py[i]; }
    cx /= (double)n; cy /= (double)n;

    // angular sort around the centroid: same atan2 angles (and so the
    // exact numpy-mirror ORDER), but packed as order-preserving float
    // bits + index into one u64 so the sort runs on contiguous
    // integer keys instead of a comparator-indirected float array
    // (ties — exactly equal angles — break by index instead of
    // std::sort's arbitrary unstable order; all downstream math
    // consumes only the order).
    std::vector<uint64_t> keyed(n);
    for (int64_t i = 0; i < n; ++i) {
        const float a = (float)std::atan2((double)py[i] - cy,
                                          (double)px[i] - cx);
        uint32_t u;
        static_assert(sizeof(float) == 4, "f32");
        std::memcpy(&u, &a, 4);
        u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
        keyed[i] = ((uint64_t)u << 20) | (uint64_t)i;
    }
    std::sort(keyed.begin(), keyed.end());
    std::vector<float> x(n), y(n);
    for (int64_t i = 0; i < n; ++i) {
        const int64_t idx = (int64_t)(keyed[i] & 0xFFFFF);
        x[i] = px[idx];
        y[i] = py[idx];
    }

    // farthest pair on a <=192-point ceil-stride (corners are
    // re-derived from full-resolution line fits, coarse picks
    // suffice; must match detector._fit_quad's stride exactly). The
    // samples are COMPACTED first so the O(ns²) scan runs on
    // contiguous memory — the strided double loop paid a cache miss
    // per access, and this scan was the largest fit_quad substage.
    const int64_t stride = std::max<int64_t>(1, (n + 191) / 192);
    int64_t ia = 0, ib = 0;
    {
        const int64_t ns = (n + stride - 1) / stride;  // all multiples
        std::vector<float> sxp(ns), syp(ns);
        for (int64_t k = 0; k < ns; ++k) {
            sxp[k] = x[k * stride];
            syp[k] = y[k * stride];
        }
        double best = -1.0;
        int64_t bi = 0, bj = 0;
        for (int64_t i = 0; i < ns; ++i) {
            for (int64_t j = i + 1; j < ns; ++j) {
                const double dx = (double)sxp[i] - sxp[j];
                const double dy = (double)syp[i] - syp[j];
                const double d = dx * dx + dy * dy;
                if (d > best) { best = d; bi = i; bj = j; }
            }
        }
        ia = bi * stride; ib = bj * stride;
    }
    const double ax = x[ia], ay = y[ia], bx = x[ib], by = y[ib];
    double smax = -1e30, smin = 1e30;
    int64_t ic = 0, id = 0;
    for (int64_t i = 0; i < n; ++i) {
        const double s = (bx - ax) * ((double)y[i] - ay)
                       - (by - ay) * ((double)x[i] - ax);
        if (s > smax) { smax = s; ic = i; }
        if (s < smin) { smin = s; id = i; }
    }
    if (smax <= 0.0 || smin >= 0.0) return false;
    int64_t picked[4] = {ia, ib, ic, id};
    std::sort(picked, picked + 4);
    if (picked[0] == picked[1] || picked[1] == picked[2] ||
        picked[2] == picked[3]) return false;

    double normals[4][2], offs[4];
    for (int i = 0; i < 4; ++i) {
        const int64_t a = picked[i];
        const int64_t b = picked[(i + 1) % 4];
        const int64_t len = (b > a) ? (b - a + 1) : (b + n - a + 1);
        if (len < 4) return false;
        int64_t trim = std::max<int64_t>(1, len / 8);
        int64_t lo = 0, hi = len;              // [lo, hi) into the arc
        if (len > 2 * trim + 2) { lo = trim; hi = len - trim; }
        // two contiguous ranges instead of a %n per element (the arc
        // [a+lo, a+hi) may wrap once)
        const int64_t w0 = a + lo, w1 = a + hi;
        const int64_t r0a = std::min<int64_t>(w0, n);
        const int64_t r0b = std::min<int64_t>(w1, n);
        double mx = 0.0, my = 0.0;
        for (int64_t t = r0a; t < r0b; ++t) { mx += x[t]; my += y[t]; }
        for (int64_t t = std::max<int64_t>(w0 - n, 0);
             t < w1 - n; ++t) { mx += x[t]; my += y[t]; }
        const double cnt = (double)(hi - lo);
        mx /= cnt; my /= cnt;
        double sxx = 0.0, syy = 0.0, sxy = 0.0;
        for (int64_t t = r0a; t < r0b; ++t) {
            const double dx = x[t] - mx, dy = y[t] - my;
            sxx += dx * dx; syy += dy * dy; sxy += dx * dy;
        }
        for (int64_t t = std::max<int64_t>(w0 - n, 0);
             t < w1 - n; ++t) {
            const double dx = x[t] - mx, dy = y[t] - my;
            sxx += dx * dx; syy += dy * dy; sxy += dx * dy;
        }
        const double theta = 0.5 * std::atan2(2.0 * sxy, sxx - syy);
        const double dirx = std::cos(theta), diry = std::sin(theta);
        normals[i][0] = -diry; normals[i][1] = dirx;
        offs[i] = normals[i][0] * mx + normals[i][1] * my;
    }
    double corners[4][2];
    for (int i = 0; i < 4; ++i) {
        const int j = (i + 3) % 4;             // lines[i-1], lines[i]
        const double a11 = normals[j][0], a12 = normals[j][1];
        const double a21 = normals[i][0], a22 = normals[i][1];
        const double det = a11 * a22 - a12 * a21;
        if (std::fabs(det) < 1e-9) return false;
        corners[i][0] = (offs[j] * a22 - a12 * offs[i]) / det;
        corners[i][1] = (a11 * offs[i] - offs[j] * a21) / det;
    }
    double area = 0.0;
    for (int i = 0; i < 4; ++i) {
        const int j = (i + 1) % 4;
        area += corners[i][0] * corners[j][1]
              - corners[j][0] * corners[i][1];
    }
    area /= 2.0;
    if (std::fabs(area) < min_tag_area) return false;
    if (area < 0.0) {                          // normalize to CCW
        std::swap(corners[0][0], corners[3][0]);
        std::swap(corners[0][1], corners[3][1]);
        std::swap(corners[1][0], corners[2][0]);
        std::swap(corners[1][1], corners[2][1]);
    }
    for (int i = 0; i < 4; ++i) {
        const double v1x = corners[(i + 1) % 4][0] - corners[i][0];
        const double v1y = corners[(i + 1) % 4][1] - corners[i][1];
        const double v2x = corners[(i + 2) % 4][0] - corners[(i + 1) % 4][0];
        const double v2y = corners[(i + 2) % 4][1] - corners[(i + 1) % 4][1];
        if (v1x * v2y - v1y * v2x <= 0.0) return false;
    }
    for (int i = 0; i < 4; ++i) {
        q[2 * i] = (float)corners[i][0];
        q[2 * i + 1] = (float)corners[i][1];
    }
    return true;
}

}  // namespace

extern "C" {

// threshim: h*w u8 (0 black / 255 white / `skip`=unknown). Fits quads
// to black|white gradient-cluster boundaries. Writes up to max_quads
// quads as 8 floats each (CCW xy corners, threshold-image coords).
// Returns the number of quads written (>=0) or -1 on bad input.
int64_t kornia_apriltag_quads(const uint8_t* threshim, int64_t h,
                              int64_t w, uint8_t skip,
                              int32_t min_cluster, int32_t max_cluster,
                              float min_tag_area,
                              float* quads_out, int64_t max_quads) {
    if (h <= 0 || w <= 0 || h * w > (int64_t)1 << 33) return -1;
    const int64_t n = h * w;
    StageClock clk;

    // ---- CCL over equal-valued classes: 4-connectivity, plus top
    // diagonals for WHITE (255) — the apriltag C library's rule
    // (reference segmentation.rs cc_strip_phase1; keeps corner-touching
    // white bit cells one component / one boundary cluster)
    UF uf(n);
    for (int64_t y = 0; y < h; ++y) {
        for (int64_t x = 0; x < w; ++x) {
            const int64_t i = y * w + x;
            const uint8_t v = threshim[i];
            if (v == skip) continue;
            if (x > 0 && threshim[i - 1] == v)
                uf.unite((int32_t)i, (int32_t)(i - 1));
            if (y > 0 && threshim[i - w] == v)
                uf.unite((int32_t)i, (int32_t)(i - w));
            if (v == 255 && y > 0) {
                if (x > 0 && threshim[i - w - 1] == v)
                    uf.unite((int32_t)i, (int32_t)(i - w - 1));
                if (x < w - 1 && threshim[i - w + 1] == v)
                    uf.unite((int32_t)i, (int32_t)(i - w + 1));
            }
        }
    }
    clk.mark("ccl_unite");
    std::vector<int32_t> labels(n, 0);
    {
        std::vector<int32_t> remap(n, 0);
        int32_t next_label = 0;
        for (int64_t i = 0; i < n; ++i) {
            if (threshim[i] == skip) continue;
            const int32_t root = uf.find((int32_t)i);
            if (remap[root] == 0) remap[root] = ++next_label;
            labels[i] = remap[root];
        }
    }
    clk.mark("ccl_relabel");

    // ---- boundary points between black and white components
    std::vector<BPoint> pts;
    pts.reserve(1 << 16);
    static const int OFF[4][2] = {{0, 1}, {1, 0}, {1, 1}, {1, -1}};
    for (int64_t y = 0; y < h; ++y) {
        for (int64_t x = 0; x < w; ++x) {
            const int64_t i = y * w + x;
            const uint8_t a = threshim[i];
            if (a == skip) continue;
            const int32_t la = labels[i];
            if (la <= 0) continue;
            for (int k = 0; k < 4; ++k) {
                const int64_t ny = y + OFF[k][0];
                const int64_t nx = x + OFF[k][1];
                if (ny >= h || nx < 0 || nx >= w) continue;
                const int64_t j = ny * w + nx;
                const uint8_t b = threshim[j];
                if ((int)a + (int)b != 255) continue;
                const int32_t lb = labels[j];
                if (lb <= 0) continue;
                const uint64_t black = (a == 0) ? (uint64_t)la
                                                : (uint64_t)lb;
                const uint64_t white = (a == 0) ? (uint64_t)lb
                                                : (uint64_t)la;
                BPoint p;
                p.key = (black << 32) | white;
                p.x = 0.5f * (float)(2 * x + OFF[k][1]);
                p.y = 0.5f * (float)(2 * y + OFF[k][0]);
                pts.push_back(p);
            }
        }
    }
    clk.mark("boundary_scan");
    if (pts.empty()) return 0;
    std::sort(pts.begin(), pts.end(),
              [](const BPoint& a, const BPoint& b) {
                  return a.key < b.key;
              });
    clk.mark("cluster_sort");

    // ---- per-cluster filter + quad fit
    int64_t nq = 0;
    std::vector<float> cx, cy;
    const int64_t m = (int64_t)pts.size();
    int64_t s = 0;
    while (s < m && nq < max_quads) {
        int64_t e = s + 1;
        while (e < m && pts[e].key == pts[s].key) ++e;
        const int64_t cnt = e - s;
        if (cnt >= min_cluster && cnt <= max_cluster) {
            float xmin = pts[s].x, xmax = pts[s].x;
            float ymin = pts[s].y, ymax = pts[s].y;
            for (int64_t i = s + 1; i < e; ++i) {
                xmin = std::min(xmin, pts[i].x);
                xmax = std::max(xmax, pts[i].x);
                ymin = std::min(ymin, pts[i].y);
                ymax = std::max(ymax, pts[i].y);
            }
            const float bw = xmax - xmin, bh = ymax - ymin;
            if (bw * bh >= min_tag_area &&
                (float)cnt <= 6.0f * (bw + bh) + 16.0f) {
                cx.clear(); cy.clear();
                cx.reserve(cnt); cy.reserve(cnt);
                for (int64_t i = s; i < e; ++i) {
                    cx.push_back(pts[i].x);
                    cy.push_back(pts[i].y);
                }
                if (fit_quad(cx, cy, min_tag_area,
                             quads_out + 8 * nq)) ++nq;
            }
        }
        s = e;
    }
    clk.mark("filter_quadfit");
    return nq;
}

}  // extern "C"
