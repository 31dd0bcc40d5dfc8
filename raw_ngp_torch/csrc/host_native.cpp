// Native host-side runtime of raw_ngp_torch (a copy of the JAX package's
// native/raw_ngp_native.cpp, the same code, so the two libraries built
// with the same flags give the same bits).
//
// What runs on the HOST is the data pipeline: RAW preprocessing of large
// sensor mosaics and the occupancy-grid bit utilities used by offline
// tooling. This library implements them in C++ (OpenMP-parallel where it
// matters), exposed through a plain C ABI consumed via ctypes.
//
// Build: raw_ngp_torch/native.py builds it at first use into
// build/raw_ngp_torch/ (g++ -O3 -march=native -shared -fPIC [-fopenmp]).

#include <cstdint>
#include <cstring>
#include <cmath>
#include <algorithm>

#if defined(_OPENMP)
#include <omp.h>
#endif

extern "C" {

// ---------------------------------------------------------------------
// Bilinear RGGB demosaic (semantics of raw/raw_utils.py:74-139: R at
// (0,0), wrap-around neighbor handling at the edges).
//   bayer: [H, W] float32 (H, W even)
//   out:   [H, W, 3] float32
// ---------------------------------------------------------------------
void demosaic_rggb(const float* bayer, int64_t H, int64_t W, float* out) {
    auto wrap = [](int64_t i, int64_t n) {
        return (i % n + n) % n;
    };
#if defined(_OPENMP)
#pragma omp parallel for schedule(static)
#endif
    for (int64_t y = 0; y < H; ++y) {
        for (int64_t x = 0; x < W; ++x) {
            const bool ey = (y % 2) == 0, ex = (x % 2) == 0;
            float r, g, b;
            auto at = [&](int64_t yy, int64_t xx) {
                return bayer[wrap(yy, H) * W + wrap(xx, W)];
            };
            if (ey && ex) {              // red site
                r = at(y, x);
                g = 0.25f * (at(y, x - 1) + at(y, x + 1)
                             + at(y - 1, x) + at(y + 1, x));
                b = 0.25f * (at(y - 1, x - 1) + at(y - 1, x + 1)
                             + at(y + 1, x - 1) + at(y + 1, x + 1));
            } else if (ey && !ex) {      // green on red row
                r = 0.5f * (at(y, x - 1) + at(y, x + 1));
                g = at(y, x);
                b = 0.5f * (at(y - 1, x) + at(y + 1, x));
            } else if (!ey && ex) {      // green on blue row
                r = 0.5f * (at(y - 1, x) + at(y + 1, x));
                g = at(y, x);
                b = 0.5f * (at(y, x - 1) + at(y, x + 1));
            } else {                     // blue site
                r = 0.25f * (at(y - 1, x - 1) + at(y - 1, x + 1)
                             + at(y + 1, x - 1) + at(y + 1, x + 1));
                g = 0.25f * (at(y, x - 1) + at(y, x + 1)
                             + at(y - 1, x) + at(y + 1, x));
                b = at(y, x);
            }
            float* px = out + (y * W + x) * 3;
            px[0] = r;
            px[1] = g;
            px[2] = b;
        }
    }
}

// ---------------------------------------------------------------------
// Black/white level normalization + clip (image_utils.py:140-148)
// ---------------------------------------------------------------------
void normalize_levels(float* img, int64_t n, float black, float white,
                      int clip01) {
    const float inv = 1.0f / (white - black);
#if defined(_OPENMP)
#pragma omp parallel for schedule(static)
#endif
    for (int64_t i = 0; i < n; ++i) {
        float v = img[i];
        if (clip01) v = std::min(std::max(v, 0.0f), 1.0f);
        img[i] = (v - black) * inv;
    }
}

// ---------------------------------------------------------------------
// Morton (Z-order) 3D codes (raymarching.cu:56-81 semantics)
// ---------------------------------------------------------------------
static inline uint32_t expand_bits(uint32_t v) {
    v = (v * 0x00010001u) & 0xFF0000FFu;
    v = (v * 0x00000101u) & 0x0F00F00Fu;
    v = (v * 0x00000011u) & 0xC30C30C3u;
    v = (v * 0x00000005u) & 0x49249249u;
    return v;
}

static inline uint32_t compact_bits(uint32_t v) {
    v &= 0x49249249u;
    v = (v ^ (v >> 2)) & 0xC30C30C3u;
    v = (v ^ (v >> 4)) & 0x0F00F00Fu;
    v = (v ^ (v >> 8)) & 0xFF0000FFu;
    v = (v ^ (v >> 16)) & 0x000003FFu;
    return v;
}

void morton3d_encode(const int32_t* coords, int64_t n, uint32_t* codes) {
#if defined(_OPENMP)
#pragma omp parallel for schedule(static)
#endif
    for (int64_t i = 0; i < n; ++i) {
        codes[i] = expand_bits((uint32_t)coords[3 * i])
                 | (expand_bits((uint32_t)coords[3 * i + 1]) << 1)
                 | (expand_bits((uint32_t)coords[3 * i + 2]) << 2);
    }
}

void morton3d_decode(const uint32_t* codes, int64_t n, int32_t* coords) {
#if defined(_OPENMP)
#pragma omp parallel for schedule(static)
#endif
    for (int64_t i = 0; i < n; ++i) {
        coords[3 * i] = (int32_t)compact_bits(codes[i]);
        coords[3 * i + 1] = (int32_t)compact_bits(codes[i] >> 1);
        coords[3 * i + 2] = (int32_t)compact_bits(codes[i] >> 2);
    }
}

// ---------------------------------------------------------------------
// packbits: density grid -> bitfield, 8 cells/byte
// (raymarching.cu:268-289 semantics)
// ---------------------------------------------------------------------
void packbits(const float* grid, int64_t n_cells, float thresh,
              uint8_t* bitfield) {
    const int64_t n_bytes = n_cells / 8;
#if defined(_OPENMP)
#pragma omp parallel for schedule(static)
#endif
    for (int64_t b = 0; b < n_bytes; ++b) {
        uint8_t byte = 0;
        for (int i = 0; i < 8; ++i) {
            if (grid[b * 8 + i] > thresh) byte |= (uint8_t)(1u << i);
        }
        bitfield[b] = byte;
    }
}

// ---------------------------------------------------------------------
// sRGB curve (raw_utils.py:55-62), vectorized for output postprocessing
// ---------------------------------------------------------------------
void linear_to_srgb(float* img, int64_t n) {
#if defined(_OPENMP)
#pragma omp parallel for schedule(static)
#endif
    for (int64_t i = 0; i < n; ++i) {
        const float x = img[i];
        img[i] = (x <= 0.0031308f)
            ? 12.92f * x
            : (211.0f * std::pow(std::max(x, 1e-9f), 5.0f / 12.0f)
               - 11.0f) / 200.0f;
    }
}

int version() { return 1; }

}  // extern "C"
