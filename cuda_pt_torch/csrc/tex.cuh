// Texel fetches of kernel K3: the bilinear texture lookup
// (scene/textures.sample_texture) and the lat-long envmap radiance
// (emitters/emitters.env_radiance; the TPU kernel's epilogue
// _env_radiance, ops/pallas/megakernel.py:3643). The TPU has no per-lane
// gathers, so its kernel recorded (bid, uv) per bounce and the miss
// direction and left these lookups to XLA epilogues; a thread here reads
// its four texels directly where the path needs them.
#pragma once

#include "common.cuh"

// Bilinear RGB of texture tid at (u, v), wrap addressing; the weights and
// their sum are taken in the order of the plain version.
__device__ __forceinline__ V3 sample_texture(const Pack& pk, int tid, float u, float v) {
    const int* ti = pk.tinfo + 4 * tid;
    int off = ti[0], w = ti[1], h = ti[2];
    u = u - floorf(u);
    v = v - floorf(v);
    float x = u * (float)w - 0.5f;
    float y = v * (float)h - 0.5f;
    float x0 = floorf(x), y0 = floorf(y);
    float fx = x - x0, fy = y - y0;
    int xa = (int)x0, ya = (int)y0;
    int xs[2] = {((xa % w) + w) % w, (((xa + 1) % w) + w) % w};
    int ys[2] = {((ya % h) + h) % h, (((ya + 1) % h) + h) % h};
    const float4* tx = reinterpret_cast<const float4*>(pk.texels);
    float4 c00 = __ldg(tx + off + ys[0] * w + xs[0]);
    float4 c10 = __ldg(tx + off + ys[0] * w + xs[1]);
    float4 c01 = __ldg(tx + off + ys[1] * w + xs[0]);
    float4 c11 = __ldg(tx + off + ys[1] * w + xs[1]);
    float w00 = (1.0f - fx), w10 = fx;
    V3 r;
    r.x = c00.x * w00 * (1.0f - fy) + c10.x * w10 * (1.0f - fy) + c01.x * w00 * fy + c11.x * w10 * fy;
    r.y = c00.y * w00 * (1.0f - fy) + c10.y * w10 * (1.0f - fy) + c01.y * w00 * fy + c11.y * w10 * fy;
    r.z = c00.z * w00 * (1.0f - fy) + c10.z * w10 * (1.0f - fy) + c01.z * w00 * fy + c11.z * w10 * fy;
    return r;
}

// Diffuse texel of material bid at the hit (b1, b2) of prim; (1, 1, 1)
// when the material has no diffuse texture.
__device__ __forceinline__ V3 diffuse_texel(const Pack& pk, int bid, int prim, float b1, float b2) {
    int tid = pk.tdiff[bid];
    if (tid < 0) return v3(1.0f, 1.0f, 1.0f);
    const float* uv = pk.uvs + (size_t)prim * 8;
    float w0 = 1.0f - b1 - b2;
    float tu = w0 * uv[0] + b1 * uv[2] + b2 * uv[4];
    float tv = w0 * uv[1] + b1 * uv[3] + b2 * uv[5];
    return sample_texture(pk, tid, tu, tv);
}

// Envmap radiance toward unit direction d: zenith tilt about +x, azimuth
// offset, lat-long lookup, times base emission and max(scale, 0).
__device__ __forceinline__ V3 env_radiance(const Pack& pk, V3 d) {
    const float* er = pk.envrow;
    int tid = (int)er[0];
    float cz = cosf(er[3]), sz = sinf(er[3]);
    float dy = d.y * cz - d.z * sz;
    float dz = d.y * sz + d.z * cz;
    float phi = atan2f(dz, d.x) + er[2];
    float theta = acosf(clampf(dy, -1.0f, 1.0f));
    V3 t = v3(1.0f, 1.0f, 1.0f);
    if (tid >= 0) t = sample_texture(pk, tid, phi / TWO_PI + 0.5f, theta / PI_F);
    float s = fmaxf(er[1], 0.0f);
    return v3(t.x * er[4] * s, t.y * er[5] * s, t.z * er[6] * s);
}
