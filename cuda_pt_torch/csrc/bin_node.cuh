// The binary skip-tree node of ops/traverse_kernel.pack_nodes (f32 rows) and
// pack_nodes_bf16 (bf16 rows), decoded for one thread, and its slab test:
// shared by kernel K1 (csrc/traverse.cu, a forest chunk's rows) and by the
// megakernel's binary walks (csrc/walk.cuh, the pack's node table).
//
// f32 rows: node p at nodes[p * SLOT_F + f], f = lo(3) hi(3) skip base count.
// bf16 rows: node p at nodes[p * K1_SLOT_F16 + f], f = lo|hi of x, y, z (the
// lower bound, rounded down, in the high 16 bits; the upper one, rounded
// up, in the low 16 bits), skip, base, count. A bf16 bound is the high half
// of an f32, so the decode is exact and the box only grows.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#define K1_SLOT_F16 8  // f32 fields per bf16 node slot

struct K1Node {
    float lo[3], hi[3];
    int skip, base, cnt;
};

template <bool BF16>
__device__ __forceinline__ K1Node k1_node(const float* __restrict__ nodes, int ptr) {
    K1Node nd;
    if (BF16) {
        const float4* p = reinterpret_cast<const float4*>(nodes + (size_t)ptr * K1_SLOT_F16);
        float4 a = __ldg(p);
        float4 b = __ldg(p + 1);
        float box[3] = {a.x, a.y, a.z};
#pragma unroll
        for (int i = 0; i < 3; ++i) {
            unsigned u = (unsigned)__float_as_int(box[i]);
            nd.lo[i] = __int_as_float((int)(u & 0xFFFF0000u));
            nd.hi[i] = __int_as_float((int)(u << 16));
        }
        nd.skip = (int)a.w;
        nd.base = (int)b.x;
        nd.cnt = (int)b.y;
    } else {
        const float4* p = reinterpret_cast<const float4*>(nodes + (size_t)ptr * SLOT_F);
        float4 a = __ldg(p);
        float4 b = __ldg(p + 1);
        float4 c = __ldg(p + 2);
        nd.lo[0] = a.x; nd.lo[1] = a.y; nd.lo[2] = a.z;
        nd.hi[0] = a.w; nd.hi[1] = b.x; nd.hi[2] = b.y;
        nd.skip = (int)b.z;
        nd.base = (int)b.w;
        nd.cnt = (int)c.x;
    }
    return nd;
}

struct K1Ray {
    float o[3], d[3], inv[3];
};

// safe_inv of the TPU kernel (traverse_kernel.py:339)
__device__ __forceinline__ float k1_safe_inv(float v) {
    return 1.0f / (fabsf(v) < 1e-8f ? (v < 0.0f ? -1e-8f : 1e-8f) : v);
}

// The slab test of a node's box against [HIT_EPS, t_best) (the TPU kernels'
// operation order).
__device__ __forceinline__ bool k1_box(const K1Node& nd, const K1Ray& r, float t_best) {
    float tn = -INFINITY, tf = INFINITY;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
        float t0 = (nd.lo[i] - r.o[i]) * r.inv[i];
        float t1 = (nd.hi[i] - r.o[i]) * r.inv[i];
        tn = fmaxf(tn, fminf(t0, t1));
        tf = fminf(tf, fmaxf(t0, t1));
    }
    return (tn <= tf) && (tf > HIT_EPS) && (tn < t_best);
}
