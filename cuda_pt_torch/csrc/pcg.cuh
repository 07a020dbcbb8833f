// pcg2d stream RNG on native uint32_t (core/rng.py; the TPU kernel's _pcg2d
// and _u01, megakernel.py:472/489). One call = one stream advance.
#pragma once

#include "common.cuh"

__device__ __forceinline__ void pcg2d(uint32_t& x, uint32_t& y) {
    const uint32_t c1 = 1664525u;
    const uint32_t c2 = 1013904223u;
    x = x * c1 + c2;
    y = y * c1 + c2;
    x = x + y * c1;
    y = y + x * c2;
    x = x ^ (x >> 16);
    y = y ^ (y >> 16);
    x = x + y * c1;
    y = y + x * c2;
    x = x ^ (x >> 16);
    y = y ^ (y >> 16);
}

// u32 -> [0, 1): round-to-nearest convert, then the exact 2^-32 scale
__device__ __forceinline__ float u01(uint32_t x) {
    return __uint2float_rn(x) * 2.3283064365386963e-10f;
}
