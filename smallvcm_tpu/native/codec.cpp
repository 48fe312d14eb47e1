// Native image codec for smallvcm_tpu — the host-side runtime component.
//
// The reference renderer's output layer is native C++ (framebuffer.hxx:
// PPM :106-135, PFM :137-146, BMP 24bpp bottom-up + gamma :170-215,
// Radiance RGBE HDR :219-251). This is the equivalent for this build:
// the device side stays XLA-compiled JAX; the host-side encode/IO runs
// native through this small C library (loaded via ctypes — see
// smallvcm_tpu/io/native_codec.py; the numpy writers in io/framebuffer.py
// remain as the portable fallback and the byte-format oracle).
//
// Build: g++ -O3 -shared -fPIC -o libsvcmcodec.so codec.cpp
//
// All functions take rgb as a row-major float array [h][w][3] (top-down,
// RGB) and return 0 on success, negative errno-style codes on failure.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

struct File {
    std::FILE* f;
    explicit File(const char* path, const char* mode)
        : f(std::fopen(path, mode)) {}
    ~File() { if (f) std::fclose(f); }
};

inline uint8_t quant_gamma(float c, float inv_gamma) {
    // Matches framebuffer.hxx:198-209 and the numpy writer:
    // truncate(clip(pow(max(c,0), 1/gamma) * 255, 0, 255)).
    float g = std::pow(std::fmax(c, 0.0f), inv_gamma) * 255.0f;
    if (g < 0.0f) g = 0.0f;
    if (g > 255.0f) g = 255.0f;
    return static_cast<uint8_t>(g);
}

}  // namespace

extern "C" {

// 24bpp bottom-up BMP with gamma (framebuffer.hxx:170-215).
int svcm_save_bmp(const char* path, const float* rgb, int w, int h,
                  float gamma) {
    File fp(path, "wb");
    if (!fp.f) return -1;
    const float inv_g = 1.0f / gamma;

    uint8_t header[54];
    std::memset(header, 0, sizeof header);
    header[0] = 'B'; header[1] = 'M';
    auto put32 = [&](int off, uint32_t v) {
        header[off + 0] = uint8_t(v);
        header[off + 1] = uint8_t(v >> 8);
        header[off + 2] = uint8_t(v >> 16);
        header[off + 3] = uint8_t(v >> 24);
    };
    auto put16 = [&](int off, uint16_t v) {
        header[off + 0] = uint8_t(v);
        header[off + 1] = uint8_t(v >> 8);
    };
    put32(2, 54 + uint32_t(w) * uint32_t(h) * 3);  // file size
    put32(10, 54);                                  // data offset
    put32(14, 40);                                  // info header size
    put32(18, uint32_t(w));
    put32(22, uint32_t(h));
    put16(26, 1);                                   // planes
    put16(28, 24);                                  // bpp
    put32(34, uint32_t(w) * uint32_t(h) * 3);       // image size
    put32(38, 2953);                                // x ppm
    put32(42, 2953);                                // y ppm
    if (std::fwrite(header, 1, 54, fp.f) != 54) return -2;

    std::vector<uint8_t> row(size_t(w) * 3);
    for (int y = h - 1; y >= 0; --y) {              // bottom-up
        const float* src = rgb + size_t(y) * w * 3;
        for (int x = 0; x < w; ++x) {               // BGR order
            row[size_t(x) * 3 + 0] = quant_gamma(src[x * 3 + 2], inv_g);
            row[size_t(x) * 3 + 1] = quant_gamma(src[x * 3 + 1], inv_g);
            row[size_t(x) * 3 + 2] = quant_gamma(src[x * 3 + 0], inv_g);
        }
        if (std::fwrite(row.data(), 1, row.size(), fp.f) != row.size())
            return -2;
    }
    return 0;
}

// Radiance RGBE HDR, flat (non-RLE) scanlines (framebuffer.hxx:219-251).
int svcm_save_hdr(const char* path, const float* rgb, int w, int h) {
    File fp(path, "wb");
    if (!fp.f) return -1;
    std::fprintf(fp.f, "#?RADIANCE\n# SmallVCM\nFORMAT=32-bit_rle_rgbe\n\n");
    std::fprintf(fp.f, "-Y %d +X %d\n", h, w);

    std::vector<uint8_t> row(size_t(w) * 4);
    for (int y = 0; y < h; ++y) {
        const float* src = rgb + size_t(y) * w * 3;
        for (int x = 0; x < w; ++x) {
            float r = src[x * 3 + 0], g = src[x * 3 + 1], b = src[x * 3 + 2];
            float v = std::fmax(r, std::fmax(g, b));
            uint8_t* px = row.data() + size_t(x) * 4;
            if (v >= 1e-32f) {
                int e;
                float m = std::frexp(v, &e);
                float scale = m * 256.0f / v;
                px[0] = uint8_t(r * scale);
                px[1] = uint8_t(g * scale);
                px[2] = uint8_t(b * scale);
                px[3] = uint8_t(e + 128);
            } else {
                px[0] = px[1] = px[2] = px[3] = 0;
            }
        }
        if (std::fwrite(row.data(), 1, row.size(), fp.f) != row.size())
            return -2;
    }
    return 0;
}

// Binary PFM, negative scale = little-endian (framebuffer.hxx:137-146).
int svcm_save_pfm(const char* path, const float* rgb, int w, int h) {
    File fp(path, "wb");
    if (!fp.f) return -1;
    std::fprintf(fp.f, "PF\n%d %d\n-1\n", w, h);
    size_t count = size_t(w) * h * 3;
    if (std::fwrite(rgb, sizeof(float), count, fp.f) != count) return -2;
    return 0;
}

// ASCII PPM with gamma (framebuffer.hxx:106-135); matches the numpy
// writer's formatting: one line per row, space-separated, trailing " \n".
// The reference int-casts BEFORE clamping (framebuffer.hxx:124-130) — on
// x86 an out-of-range float->int cast saturates to INT_MIN, which then
// clamps to 0; reproduce that deterministically instead of relying on UB.
static int ppm_quant(float c, float inv_gamma) {
    float g = std::pow(c, inv_gamma) * 255.0f;
    int v = (g != g || g >= 2147483648.0f || g < -2147483648.0f)
                ? INT32_MIN
                : int(g);
    return std::min(255, std::max(0, v));
}

int svcm_save_ppm(const char* path, const float* rgb, int w, int h,
                  float gamma) {
    File fp(path, "w");
    if (!fp.f) return -1;
    const float inv_g = 1.0f / gamma;
    std::fprintf(fp.f, "P3\n%d %d\n255\n", w, h);
    for (int y = 0; y < h; ++y) {
        const float* src = rgb + size_t(y) * w * 3;
        for (int x = 0; x < w; ++x) {
            std::fprintf(fp.f, x ? " %d %d %d" : "%d %d %d",
                         ppm_quant(src[x * 3 + 0], inv_g),
                         ppm_quant(src[x * 3 + 1], inv_g),
                         ppm_quant(src[x * 3 + 2], inv_g));
        }
        std::fprintf(fp.f, " \n");
    }
    return 0;
}

}  // extern "C"
