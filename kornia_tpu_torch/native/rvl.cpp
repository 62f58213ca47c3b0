// RVL depth-map codec — native C++ core.
//
// Implements the run-length + variable-length-quantity depth compression
// scheme of Wilson, "Fast Lossless Depth Image Compression" (CVPR'17),
// matching the capability of the reference's kornia-io/src/rvl.rs
// (delta+zigzag phase, nibble VLQ packing). This is a from-scratch
// implementation of the published algorithm.
//
// Layout: the Python wrapper owns the RVL1 wire header; this core encodes
// and decodes the raw nibble stream for a flat u16 buffer.
//
// Build: g++ -O3 -shared -fPIC (see kornia_tpu/native/build.py).

#include <cstdint>
#include <cstring>

namespace {

struct NibbleWriter {
    uint8_t* out;
    int64_t cap;        // capacity in bytes
    int64_t nibbles;    // nibbles written so far
    bool overflow;

    void put(uint32_t nib) {
        const int64_t byte_idx = nibbles >> 1;
        if (byte_idx >= cap) { overflow = true; return; }
        if ((nibbles & 1) == 0) {
            out[byte_idx] = static_cast<uint8_t>(nib << 4);
        } else {
            out[byte_idx] |= static_cast<uint8_t>(nib & 0xF);
        }
        ++nibbles;
    }

    // VLQ: 3 data bits per nibble, high bit = continuation.
    void put_vlq(uint32_t value) {
        while (value >= 8) {
            put((value & 7) | 8);
            value >>= 3;
        }
        put(value);
    }
};

struct NibbleReader {
    const uint8_t* in;
    int64_t size;       // bytes available
    int64_t nibbles;    // nibbles consumed
    bool truncated;

    uint32_t get() {
        const int64_t byte_idx = nibbles >> 1;
        if (byte_idx >= size) { truncated = true; return 0; }
        const uint8_t b = in[byte_idx];
        const uint32_t nib = ((nibbles & 1) == 0) ? (b >> 4) : (b & 0xF);
        ++nibbles;
        return nib;
    }

    uint32_t get_vlq() {
        uint32_t value = 0;
        int shift = 0;
        for (;;) {
            const uint32_t nib = get();
            if (truncated) return 0;
            value |= (nib & 7) << shift;
            if ((nib & 8) == 0) return value;
            shift += 3;
            if (shift > 30) { truncated = true; return 0; }  // malformed
        }
    }
};

inline uint32_t zigzag(int32_t d) {
    return (static_cast<uint32_t>(d) << 1) ^ static_cast<uint32_t>(d >> 31);
}

inline int32_t unzigzag(uint32_t z) {
    return static_cast<int32_t>(z >> 1) ^ -static_cast<int32_t>(z & 1);
}

}  // namespace

extern "C" {

// Compress n u16 depth values. Returns bytes written, or -1 on overflow
// (out_cap too small; callers size out_cap >= 2*n + 8 which is the
// worst case: every pixel nonzero with 3-nibble deltas).
int64_t kornia_rvl_compress(const uint16_t* in, int64_t n,
                            uint8_t* out, int64_t out_cap) {
    NibbleWriter w{out, out_cap, 0, false};
    int64_t i = 0;
    int32_t prev = 0;
    while (i < n) {
        int64_t zeros = 0;
        while (i < n && in[i] == 0) { ++zeros; ++i; }
        w.put_vlq(static_cast<uint32_t>(zeros));
        int64_t start = i;
        while (i < n && in[i] != 0) { ++i; }
        w.put_vlq(static_cast<uint32_t>(i - start));
        for (int64_t j = start; j < i; ++j) {
            const int32_t cur = in[j];
            w.put_vlq(zigzag(cur - prev));
            prev = cur;
        }
        if (w.overflow) return -1;
    }
    return (w.nibbles + 1) >> 1;  // bytes (round up to whole byte)
}

// Decompress into exactly n u16 values. Returns 0 on success, -1 on a
// truncated/malformed stream, -2 if the stream decodes to != n pixels.
int64_t kornia_rvl_decompress(const uint8_t* in, int64_t in_size,
                              uint16_t* out, int64_t n) {
    NibbleReader r{in, in_size, 0, false};
    int64_t i = 0;
    int32_t prev = 0;
    while (i < n) {
        const uint32_t zeros = r.get_vlq();
        if (r.truncated) return -1;
        if (i + zeros > static_cast<uint64_t>(n)) return -2;
        std::memset(out + i, 0, zeros * sizeof(uint16_t));
        i += zeros;
        const uint32_t nonzeros = r.get_vlq();
        if (r.truncated) return -1;
        if (i + nonzeros > static_cast<uint64_t>(n)) return -2;
        for (uint32_t j = 0; j < nonzeros; ++j) {
            const uint32_t z = r.get_vlq();
            if (r.truncated) return -1;
            prev += unzigzag(z);
            out[i++] = static_cast<uint16_t>(prev);
        }
    }
    return 0;
}

}  // extern "C"
