// The counter-based RNG of the path vertex kernels on the card: pcg4d,
// its uniforms and Box–Muller, bit for bit the port's core/rng.py (and so
// the reference's rust_raytracer_tpu/core/rng.py:24 and :60).
//
// core/rng.py carries u32 values in int64 tensors and masks every product
// and sum to 32 bits; here they are uint32_t, whose arithmetic wraps the
// same way.  A draw is keyed by (pixel, sample, bounce * 4096 + stream,
// seed), each taken modulo 2^32 (core/rng.py:Ctx.uniform4).
#pragma once

#include <stdint.h>

namespace rrt {

// core/rng.py:Streams
enum Stream : uint32_t {
    PIXEL_JITTER = 0, APERTURE = 1, MIX_CHOICE = 2, MAT_SAMPLE = 3, LIGHT_PICK = 4,
    LIGHT_SAMPLE = 5, SPECULAR = 6, FRESNEL = 7, VOLUME = 8, RUSSIAN_ROULETTE = 9,
};

constexpr uint32_t STREAM_STRIDE = 4096;

__device__ __forceinline__ uint32_t pcg_lcg(uint32_t x) { return x * 1664525u + 1013904223u; }

__device__ __forceinline__ uint32_t pcg_mix(uint32_t a, uint32_t b, uint32_t c) {
    return a + b * c;
}

// core/rng.py:_pcg4d
__device__ __forceinline__ void pcg4d(uint32_t a, uint32_t b, uint32_t c, uint32_t d,
                                      uint32_t v[4]) {
    uint32_t v0 = pcg_lcg(a), v1 = pcg_lcg(b), v2 = pcg_lcg(c), v3 = pcg_lcg(d);
    v0 = pcg_mix(v0, v1, v3);
    v1 = pcg_mix(v1, v2, v0);
    v2 = pcg_mix(v2, v0, v1);
    v3 = pcg_mix(v3, v1, v2);
    v0 ^= v0 >> 16;
    v1 ^= v1 >> 16;
    v2 ^= v2 >> 16;
    v3 ^= v3 >> 16;
    v0 = pcg_mix(v0, v1, v3);
    v1 = pcg_mix(v1, v2, v0);
    v2 = pcg_mix(v2, v0, v1);
    v3 = pcg_mix(v3, v1, v2);
    v[0] = v0;
    v[1] = v1;
    v[2] = v2;
    v[3] = v3;
}

// core/rng.py:_to_unit: the u32 rounded to the nearest float, times 2^-32
// (draws >= 2^32 - 128 round up to exactly 1.0, as there)
__device__ __forceinline__ float to_unit(uint32_t v) {
    return __uint2float_rn(v) * __int_as_float(0x2f800000);
}

// The RNG key of one lane: core/rng.py:Ctx, each field taken modulo 2^32.
struct Ctx {
    uint32_t pixel, sample, bounce, seed;
};

__device__ __forceinline__ void uniform4(const Ctx& c, uint32_t stream, float u[4]) {
    uint32_t v[4];
    pcg4d(c.pixel, c.sample, c.bounce * STREAM_STRIDE + stream, c.seed, v);
    for (int k = 0; k < 4; ++k) u[k] = to_unit(v[k]);
}

__device__ __forceinline__ float uniform1(const Ctx& c, uint32_t stream) {
    float u[4];
    uniform4(c, stream, u);
    return u[0];
}

// core/rng.py:_box_muller3 on the four uniforms of `stream`
__device__ __forceinline__ void gaussian3(const Ctx& c, uint32_t stream, float g[3]) {
    float u[4];
    uniform4(c, stream, u);
    const float lo = (float)1e-10;
    const float u1 = (u[0] != u[0]) ? u[0] : fmaxf(u[0], lo);
    const float u3 = (u[2] != u[2]) ? u[2] : fmaxf(u[2], lo);
    const float r1 = sqrtf(logf(u1) * -2.0f);
    const float r2 = sqrtf(logf(u3) * -2.0f);
    const float t1 = (float)(2.0 * 3.141592653589793) * u[1];
    const float t2 = (float)(2.0 * 3.141592653589793) * u[3];
    g[0] = r1 * cosf(t1);
    g[1] = r1 * sinf(t1);
    g[2] = r2 * cosf(t2);
}

}  // namespace rrt
