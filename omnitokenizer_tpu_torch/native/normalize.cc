// Host-side data-path kernels (a copy of the JAX package's
// native/normalize.cc): fused uint8 -> float32 normalize (+ crop) in one
// pass instead of numpy's astype / divide / subtract chain (three
// allocations + passes).
//
// Built by native/build.py with g++ -O3; loaded via ctypes.  All functions
// are plain C ABI.

#include <cstddef>
#include <cstdint>
#include <cstring>

extern "C" {

// dst[i] = src[i] / 255.f - 0.5f   (the [-0.5, 0.5] convention of
// data.py ImageDataset/VideoNorm)
void normalize_u8(const uint8_t* src, float* dst, size_t n) {
    // 256-entry LUT: fastest portable path on one core
    static float lut[256];
    static bool init = false;
    if (!init) {
        for (int i = 0; i < 256; ++i) lut[i] = (float)i / 255.0f - 0.5f;
        init = true;
    }
    for (size_t i = 0; i < n; ++i) dst[i] = lut[src[i]];
}

// crop a (T, H, W, C) uint8 video at (y, x) to (T, ch, cw, C) and normalize
void crop_normalize_u8(const uint8_t* src, float* dst,
                       size_t T, size_t H, size_t W, size_t C,
                       size_t y, size_t x, size_t ch, size_t cw) {
    static float lut[256];
    static bool init = false;
    if (!init) {
        for (int i = 0; i < 256; ++i) lut[i] = (float)i / 255.0f - 0.5f;
        init = true;
    }
    const size_t row = W * C;
    const size_t frame = H * row;
    const size_t crow = cw * C;
    for (size_t t = 0; t < T; ++t) {
        const uint8_t* fsrc = src + t * frame + y * row + x * C;
        float* fdst = dst + t * ch * crow;
        for (size_t r = 0; r < ch; ++r) {
            const uint8_t* p = fsrc + r * row;
            float* q = fdst + r * crow;
            for (size_t i = 0; i < crow; ++i) q[i] = lut[p[i]];
        }
    }
}

// stack B contiguous float32 blocks of `n` elements into dst (collate)
void stack_f32(const float* const* srcs, float* dst, size_t b, size_t n) {
    for (size_t i = 0; i < b; ++i)
        std::memcpy(dst + i * n, srcs[i], n * sizeof(float));
}

}  // extern "C"
