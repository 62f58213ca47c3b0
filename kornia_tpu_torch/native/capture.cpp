// Native video capture — V4L2 mmap streaming + a directory-backed
// virtual camera sharing the same grab API.
//
// Reference capability: kornia-io's V4lVideoCapture (v4l/mod.rs:184
// mmap streaming, pixel-format negotiation, grab_frame :287,
// MmapBuffer v4l/stream.rs:28). The TPU build's capture layer is this
// C ABI: `v4l2:/dev/videoN` opens a real camera (YUYV / RGB24 / GREY
// negotiated in that order, 4 mmap buffers, STREAMON/DQBUF/QBUF
// cycle, BT.601 integer YUYV->RGB); `dir:/path` loops the .ppm/.pgm
// frames in a directory through the exact same ring discipline so the
// full grab path is testable without hardware (the reference's webcam
// examples fill the same role interactively).

#include <algorithm>
#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#include <dirent.h>
#include <fcntl.h>
#include <sys/ioctl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include <linux/videodev2.h>

extern "C" {
uint8_t* kornia_image_read_pnm(const char*, int64_t*, int64_t*, int64_t*);
void kornia_image_free(uint8_t*);
}

namespace {

thread_local std::string g_error;

void set_error(const std::string& msg) { g_error = msg; }

struct MmapBuf {
    void* start = nullptr;
    size_t length = 0;
};

int xioctl(int fd, unsigned long req, void* arg) {
    int r;
    do {
        r = ioctl(fd, req, arg);
    } while (r == -1 && errno == EINTR);
    return r;
}

// BT.601 limited-range YUYV -> RGB, integer math (matches the
// reference's Q20 yuv kernels' rounding intent).
void yuyv_to_rgb(const uint8_t* src, int64_t w, int64_t h, uint8_t* dst) {
    const int64_t pairs = w * h / 2;
    for (int64_t i = 0; i < pairs; ++i) {
        const int y0 = src[4 * i + 0], u = src[4 * i + 1];
        const int y1 = src[4 * i + 2], v = src[4 * i + 3];
        const int c0 = (y0 - 16) * 298, c1 = (y1 - 16) * 298;
        const int d = u - 128, e = v - 128;
        const int rr = 409 * e + 128, gg = -100 * d - 208 * e + 128,
                  bb = 516 * d + 128;
        auto clamp = [](int x) {
            return (uint8_t)(x < 0 ? 0 : (x > 255 ? 255 : x));
        };
        dst[6 * i + 0] = clamp((c0 + rr) >> 8);
        dst[6 * i + 1] = clamp((c0 + gg) >> 8);
        dst[6 * i + 2] = clamp((c0 + bb) >> 8);
        dst[6 * i + 3] = clamp((c1 + rr) >> 8);
        dst[6 * i + 4] = clamp((c1 + gg) >> 8);
        dst[6 * i + 5] = clamp((c1 + bb) >> 8);
    }
}

}  // namespace

extern "C" {

struct KorniaCapture {
    // v4l2 state
    int fd = -1;
    uint32_t fourcc = 0;
    int64_t width = 0, height = 0;
    std::vector<MmapBuf> bufs;
    bool streaming = false;
    // dir-mode state
    std::vector<std::string> frames;
    size_t next_frame = 0;
    bool is_dir = false;
};

const char* kornia_capture_error(void) { return g_error.c_str(); }

static bool open_v4l2(KorniaCapture* cap, const char* dev,
                      int64_t req_w, int64_t req_h) {
    cap->fd = open(dev, O_RDWR | O_NONBLOCK);
    if (cap->fd < 0) {
        set_error(std::string("cannot open ") + dev + ": "
                  + std::strerror(errno));
        return false;
    }
    v4l2_capability vcap{};
    if (xioctl(cap->fd, VIDIOC_QUERYCAP, &vcap) < 0 ||
        !(vcap.capabilities & V4L2_CAP_VIDEO_CAPTURE) ||
        !(vcap.capabilities & V4L2_CAP_STREAMING)) {
        set_error(std::string(dev) + " is not a streaming capture device");
        return false;
    }
    // format negotiation in preference order (reference
    // v4l/mod.rs pixel-format negotiation)
    const uint32_t prefs[] = {V4L2_PIX_FMT_YUYV, V4L2_PIX_FMT_RGB24,
                              V4L2_PIX_FMT_GREY};
    for (uint32_t want : prefs) {
        v4l2_format fmt{};
        fmt.type = V4L2_BUF_TYPE_VIDEO_CAPTURE;
        fmt.fmt.pix.width = (uint32_t)(req_w > 0 ? req_w : 640);
        fmt.fmt.pix.height = (uint32_t)(req_h > 0 ? req_h : 480);
        fmt.fmt.pix.pixelformat = want;
        fmt.fmt.pix.field = V4L2_FIELD_NONE;
        if (xioctl(cap->fd, VIDIOC_S_FMT, &fmt) == 0 &&
            fmt.fmt.pix.pixelformat == want) {
            cap->fourcc = want;
            cap->width = fmt.fmt.pix.width;
            cap->height = fmt.fmt.pix.height;
            break;
        }
    }
    if (cap->fourcc == 0) {
        set_error("no supported pixel format (tried YUYV, RGB24, GREY)");
        return false;
    }
    v4l2_requestbuffers req{};
    req.count = 4;
    req.type = V4L2_BUF_TYPE_VIDEO_CAPTURE;
    req.memory = V4L2_MEMORY_MMAP;
    if (xioctl(cap->fd, VIDIOC_REQBUFS, &req) < 0 || req.count < 2) {
        set_error("REQBUFS failed");
        return false;
    }
    for (uint32_t i = 0; i < req.count; ++i) {
        v4l2_buffer b{};
        b.type = V4L2_BUF_TYPE_VIDEO_CAPTURE;
        b.memory = V4L2_MEMORY_MMAP;
        b.index = i;
        if (xioctl(cap->fd, VIDIOC_QUERYBUF, &b) < 0) {
            set_error("QUERYBUF failed");
            return false;
        }
        MmapBuf mb;
        mb.length = b.length;
        mb.start = mmap(nullptr, b.length, PROT_READ | PROT_WRITE,
                        MAP_SHARED, cap->fd, b.m.offset);
        if (mb.start == MAP_FAILED) {
            set_error("mmap failed");
            return false;
        }
        cap->bufs.push_back(mb);
        if (xioctl(cap->fd, VIDIOC_QBUF, &b) < 0) {
            set_error("QBUF failed");
            return false;
        }
    }
    v4l2_buf_type t = V4L2_BUF_TYPE_VIDEO_CAPTURE;
    if (xioctl(cap->fd, VIDIOC_STREAMON, &t) < 0) {
        set_error("STREAMON failed");
        return false;
    }
    cap->streaming = true;
    return true;
}

static bool open_dir(KorniaCapture* cap, const char* path) {
    DIR* d = opendir(path);
    if (!d) {
        set_error(std::string("cannot open directory ") + path);
        return false;
    }
    for (dirent* e; (e = readdir(d)) != nullptr;) {
        const std::string name = e->d_name;
        if (name.size() > 4 &&
            (name.substr(name.size() - 4) == ".ppm" ||
             name.substr(name.size() - 4) == ".pgm")) {
            cap->frames.push_back(std::string(path) + "/" + name);
        }
    }
    closedir(d);
    std::sort(cap->frames.begin(), cap->frames.end());
    if (cap->frames.empty()) {
        set_error(std::string("no .ppm/.pgm frames in ") + path);
        return false;
    }
    cap->is_dir = true;
    return true;
}

// uri: "v4l2:/dev/video0" or "dir:/path/to/frames" (also accepts a
// bare /dev/... or directory path). req_w/req_h are hints for the
// v4l2 format negotiation (0 = driver default).
KorniaCapture* kornia_capture_open(const char* uri, int64_t req_w,
                                   int64_t req_h) {
    auto* cap = new KorniaCapture();
    std::string u(uri ? uri : "");
    bool ok = false;
    if (u.rfind("v4l2:", 0) == 0) {
        ok = open_v4l2(cap, u.c_str() + 5, req_w, req_h);
    } else if (u.rfind("dir:", 0) == 0) {
        ok = open_dir(cap, u.c_str() + 4);
    } else if (u.rfind("/dev/", 0) == 0) {
        ok = open_v4l2(cap, u.c_str(), req_w, req_h);
    } else if (!u.empty()) {
        struct stat st{};
        if (stat(u.c_str(), &st) == 0 && S_ISDIR(st.st_mode)) {
            ok = open_dir(cap, u.c_str());
        } else {
            set_error("unrecognized capture uri: " + u);
        }
    } else {
        set_error("empty capture uri");
    }
    if (!ok) {
        extern void kornia_capture_close(KorniaCapture*);
        kornia_capture_close(cap);
        return nullptr;
    }
    return cap;
}

// Grab one frame as RGB24 into rgb_out (capacity cap_bytes). Fills
// *out_h/*out_w. Returns 0 on success, -1 on error, -2 if the buffer
// is too small (fills the needed dims first). dir-mode loops forever.
int64_t kornia_capture_grab(KorniaCapture* cap, uint8_t* rgb_out,
                            int64_t cap_bytes, int64_t* out_h,
                            int64_t* out_w) {
    if (!cap) return -1;
    if (cap->is_dir) {
        int64_t h, w, c;
        const std::string& path = cap->frames[cap->next_frame];
        uint8_t* buf = kornia_image_read_pnm(path.c_str(), &h, &w, &c);
        if (!buf) {
            set_error("cannot decode " + path);
            return -1;
        }
        *out_h = h;
        *out_w = w;
        if (cap_bytes < h * w * 3) {
            // don't advance: the caller regrows and retries this frame
            kornia_image_free(buf);
            return -2;
        }
        cap->next_frame = (cap->next_frame + 1) % cap->frames.size();
        if (c == 3) {
            std::memcpy(rgb_out, buf, (size_t)(h * w * 3));
        } else {
            for (int64_t i = 0; i < h * w; ++i) {
                rgb_out[3 * i] = rgb_out[3 * i + 1] = rgb_out[3 * i + 2]
                    = buf[i];
            }
        }
        kornia_image_free(buf);
        return 0;
    }

    // v4l2: wait for a filled buffer (select + DQBUF)
    for (int attempt = 0; attempt < 200; ++attempt) {
        fd_set fds;
        FD_ZERO(&fds);
        FD_SET(cap->fd, &fds);
        timeval tv{0, 50 * 1000};
        const int r = select(cap->fd + 1, &fds, nullptr, nullptr, &tv);
        if (r < 0 && errno != EINTR) {
            set_error("select failed");
            return -1;
        }
        if (r <= 0) continue;
        v4l2_buffer b{};
        b.type = V4L2_BUF_TYPE_VIDEO_CAPTURE;
        b.memory = V4L2_MEMORY_MMAP;
        if (xioctl(cap->fd, VIDIOC_DQBUF, &b) < 0) {
            if (errno == EAGAIN) continue;
            set_error("DQBUF failed");
            return -1;
        }
        *out_h = cap->height;
        *out_w = cap->width;
        if (cap_bytes < cap->height * cap->width * 3) {
            xioctl(cap->fd, VIDIOC_QBUF, &b);
            return -2;
        }
        const uint8_t* src = (const uint8_t*)cap->bufs[b.index].start;
        if (cap->fourcc == V4L2_PIX_FMT_YUYV) {
            yuyv_to_rgb(src, cap->width, cap->height, rgb_out);
        } else if (cap->fourcc == V4L2_PIX_FMT_RGB24) {
            std::memcpy(rgb_out, src,
                        (size_t)(cap->height * cap->width * 3));
        } else {  // GREY
            for (int64_t i = 0; i < cap->height * cap->width; ++i) {
                rgb_out[3 * i] = rgb_out[3 * i + 1] = rgb_out[3 * i + 2]
                    = src[i];
            }
        }
        xioctl(cap->fd, VIDIOC_QBUF, &b);
        return 0;
    }
    set_error("grab timed out");
    return -1;
}

void kornia_capture_close(KorniaCapture* cap) {
    if (!cap) return;
    if (cap->streaming) {
        v4l2_buf_type t = V4L2_BUF_TYPE_VIDEO_CAPTURE;
        xioctl(cap->fd, VIDIOC_STREAMOFF, &t);
    }
    for (auto& b : cap->bufs) {
        if (b.start && b.start != MAP_FAILED) munmap(b.start, b.length);
    }
    if (cap->fd >= 0) close(cap->fd);
    delete cap;
}

}  // extern "C"
