// Kernel S2: the node-field fetch A/B. A tile of rays walks the binary f32
// node rows (ops/traverse_kernel.pack_nodes) with one pointer shared by the
// whole tile, n_iters steps: fetch the node at the pointer, slab-test its box
// on every lane, vote over the tile whether any lane hit it, go to ptr + 1
// on a hit at an interior node and to the skip otherwise, wrap to 0 at the
// rows' slot count; out sums tn over each lane's box hits. The variants
// differ in how a thread gets the node's 9 fields, and e0-e3 take the step
// apart:
//   e0  the loop and the pointer only (acc += 0.1 * ptr)
//   e1  + one field fetched (acc += lo_x)
//   e2  + all 9 fields (acc += their sum)
//   e3  one field as all three box minima, a vote, ptr + 1 or ptr + 2
//   v0  9 scalar loads per thread (the masked-sum form: one operation per
//       field)
//   v1  one warp stages the slot in shared memory, every thread reads it
//       at static offsets (the "roll once, extract statically" form)
//   v2  3 float4 loads per thread (the node decode of bin_node.cuh)
//   w2  v0 on two slots per fetch: the pointer's and the next slot of the
//       same row, (slot + 1) % 8, whose box only adds hits
//   NPTR > 1 (v0_ilp2, v0_ilp4, v2_ilp2): NPTR pointers per iteration,
//       starting at 7 k, sharing acc, stepped in k order
//
// Replaces the TPU micro-kernel _make_kernel of scripts/exp_extract_ab.py
// (:60; pallas_call in time_variant :232), with its quirks, which decide the
// output: e3 takes lo_x for all three axes; w2's second slot wraps inside
// the row; t_best stays 1e30. The TPU's field extraction (masked-sum
// reductions, lane rolls, static extracts) has no counterpart on the card,
// so each strategy maps to the card's nearest load form above. One block
// walks one tile; a tile wider than 1,024 lanes gives each thread LPT lanes
// (tile / blockDim), and the vote is __syncthreads_or, as K1's packet form
// votes (csrc/traverse.cu). With equal rays v0 is S1's walk
// (csrc/node_bench.cu) bit for bit.
//
// Bound on an H100: the operations (22 per lane and step) against the 24 B
// each lane reads and the 4 B it writes, the rows once; the steps depend on
// the last step's pointer and vote, so the time is the node load's latency
// plus a block barrier per step, which is what the A/B compares.
//
// C entry point:
//   s2_extract_ab(variant, n_ptr, ...) -> out (n,) over n / tile tiles;
//                 returns cudaErrorInvalidValue for a form that is not built
//                 or a tile that is not a multiple of 128 up to 8,192
//                 dividing n, else cudaGetLastError() right after the launch.

#include <cuda_runtime.h>

#include "bin_node.cuh"

#if !defined(HIT_EPS) || !defined(SLOT_F)
#error "build with cuda_pt_torch/ops/cuda_build.py, which passes the shared constants"
#endif

#define S2_SLOTS 8  // slots per 128-float row
#define S2_MAX_THREADS 1024

enum { S2_E0, S2_E1, S2_E2, S2_E3, S2_V0, S2_V1, S2_V2, S2_W2 };

// the 9 fields of slot ptr, one scalar load each
__device__ __forceinline__ void s2_fields_scalar(const float* __restrict__ nodes, int ptr,
                                                 float f[9]) {
#pragma unroll
    for (int i = 0; i < 9; ++i) f[i] = __ldg(nodes + (size_t)ptr * SLOT_F + i);
}

__device__ __forceinline__ void s2_fields_vec4(const float* __restrict__ nodes, int ptr,
                                               float f[9]) {
    K1Node nd = k1_node<false>(nodes, ptr);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
        f[i] = nd.lo[i];
        f[3 + i] = nd.hi[i];
    }
    f[6] = (float)nd.skip;  // exact: the packed fields are integers below 2^24
    f[7] = (float)nd.base;
    f[8] = (float)nd.cnt;
}

// tn of a box on one lane and whether it is hit in [HIT_EPS, 1e30)
__device__ __forceinline__ bool s2_box(const float* lo, const float* hi, const float* o,
                                       const float* inv, float& tn) {
    float tx0 = (lo[0] - o[0]) * inv[0];
    float tx1 = (hi[0] - o[0]) * inv[0];
    float ty0 = (lo[1] - o[1]) * inv[1];
    float ty1 = (hi[1] - o[1]) * inv[1];
    float tz0 = (lo[2] - o[2]) * inv[2];
    float tz1 = (hi[2] - o[2]) * inv[2];
    tn = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)), fminf(tz0, tz1));
    float tf = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)), fmaxf(tz0, tz1));
    return (tn <= tf) && (tf > HIT_EPS) && (tn < 1e30f);
}

// w2's second box: the reference's own order (max of the minima, min of the
// maxima, each taken from lo and hi as they stand)
__device__ __forceinline__ bool s2_box_w2(const float* g, const float* o, const float* inv,
                                          float& tn) {
    float tx = (g[0] - o[0]) * inv[0];
    float ty = (g[1] - o[1]) * inv[1];
    float tz = (g[2] - o[2]) * inv[2];
    tn = fmaxf(fmaxf(tx, ty), tz);
    float tf = fminf(fminf((g[3] - o[0]) * inv[0], (g[4] - o[1]) * inv[1]), (g[5] - o[2]) * inv[2]);
    return (tn <= tf) && (tf > HIT_EPS) && (tn < 1e30f);
}

template <int VARIANT, int NPTR, int LPT>
__global__ void __launch_bounds__(S2_MAX_THREADS) extract_ab_kernel(
    const float* __restrict__ nodes, int m_pad, int n_iters, const float* __restrict__ ray_o,
    const float* __restrict__ ray_d, float* __restrict__ out, int tile) {
    __shared__ float staged[SLOT_F];
    const size_t base = (size_t)blockIdx.x * tile + threadIdx.x;
    float o[LPT][3], inv[LPT][3], acc[LPT];
#pragma unroll
    for (int j = 0; j < LPT; ++j) {
        size_t lane = base + (size_t)j * blockDim.x;
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            o[j][k] = ray_o[3 * lane + k];
            inv[j][k] = k1_safe_inv(ray_d[3 * lane + k]);
        }
        acc[j] = 0.0f;
    }
    int ptr[NPTR];
#pragma unroll
    for (int k = 0; k < NPTR; ++k) ptr[k] = 7 * k;

    for (int it = 0; it < n_iters; ++it) {
        if (VARIANT == S2_E0) {
            float lo_x = 0.1f * (float)ptr[0];
#pragma unroll
            for (int j = 0; j < LPT; ++j) acc[j] = acc[j] + lo_x;
            ptr[0] = ptr[0] + 1 >= m_pad ? 0 : ptr[0] + 1;
            continue;
        }
        // fetch every pointer's fields first: the NPTR loads are independent
        float f[NPTR][9], g[9];
#pragma unroll
        for (int k = 0; k < NPTR; ++k) {
            if (VARIANT == S2_V2) {
                s2_fields_vec4(nodes, ptr[k], f[k]);
            } else if (VARIANT == S2_V1) {
                // the last step's reads of the slot came before its vote
                if (threadIdx.x < SLOT_F)
                    staged[threadIdx.x] = __ldg(nodes + (size_t)ptr[k] * SLOT_F + threadIdx.x);
                __syncthreads();
#pragma unroll
                for (int i = 0; i < 9; ++i) f[k][i] = staged[i];
            } else if (VARIANT == S2_E1 || VARIANT == S2_E3) {
                f[k][0] = __ldg(nodes + (size_t)ptr[k] * SLOT_F);
            } else {
                s2_fields_scalar(nodes, ptr[k], f[k]);
            }
        }
        if (VARIANT == S2_W2) {
            int row = ptr[0] / S2_SLOTS;
            int slot2 = row * S2_SLOTS + (ptr[0] % S2_SLOTS + 1) % S2_SLOTS;
            s2_fields_scalar(nodes, slot2, g);
        }
        if (VARIANT == S2_E1 || VARIANT == S2_E2) {
            float v = f[0][0];
            if (VARIANT == S2_E2) {  // Python's sum(): 0 + f0 + f1 + ... in order
                v = 0.0f;
#pragma unroll
                for (int i = 0; i < 9; ++i) v = v + f[0][i];
            }
#pragma unroll
            for (int j = 0; j < LPT; ++j) acc[j] = acc[j] + v;
            ptr[0] = ptr[0] + 1 >= m_pad ? 0 : ptr[0] + 1;
            continue;
        }
        int any[NPTR];
#pragma unroll
        for (int k = 0; k < NPTR; ++k) {
            any[k] = 0;
#pragma unroll
            for (int j = 0; j < LPT; ++j) {
                float tn;
                bool hit;
                if (VARIANT == S2_E3) {
                    float lo_x = f[k][0];
                    float tx0 = (lo_x - o[j][0]) * inv[j][0];
                    float ty0 = (lo_x - o[j][1]) * inv[j][1];
                    float tz0 = (lo_x - o[j][2]) * inv[j][2];
                    tn = fmaxf(fmaxf(tx0, ty0), tz0);
                    hit = tn < 1e30f;
                } else {
                    hit = s2_box(&f[k][0], &f[k][3], o[j], inv[j], tn);
                }
                if (VARIANT == S2_W2) {
                    float tn2;
                    bool hit2 = s2_box_w2(g, o[j], inv[j], tn2);
                    hit = hit || hit2;
                    acc[j] = acc[j] + (hit2 ? tn2 : 0.0f);
                }
                any[k] |= hit;
                acc[j] = acc[j] + (hit ? tn : 0.0f);
            }
        }
#pragma unroll
        for (int k = 0; k < NPTR; ++k) {
            bool tile_hit = __syncthreads_or(any[k]) != 0;
            int next;
            if (VARIANT == S2_E3)
                next = tile_hit ? ptr[k] + 1 : ptr[k] + 2;
            else
                next = (tile_hit && !(f[k][8] > 0.0f)) ? ptr[k] + 1 : (int)f[k][6];
            ptr[k] = next >= m_pad ? 0 : next;
        }
    }
#pragma unroll
    for (int j = 0; j < LPT; ++j) out[base + (size_t)j * blockDim.x] = acc[j];
}

typedef void (*S2Kernel)(const float*, int, int, const float*, const float*, float*, int);

template <int VARIANT, int NPTR>
static S2Kernel s2_by_lpt(int lpt) {
    switch (lpt) {
        case 1: return extract_ab_kernel<VARIANT, NPTR, 1>;
        case 2: return extract_ab_kernel<VARIANT, NPTR, 2>;
        case 4: return extract_ab_kernel<VARIANT, NPTR, 4>;
        case 8: return extract_ab_kernel<VARIANT, NPTR, 8>;
        default: return nullptr;
    }
}

// the built forms: every variant with one pointer, v0 with 2 and 4, v2 with 2
static S2Kernel s2_kernel(int variant, int n_ptr, int lpt) {
    switch (variant * 10 + n_ptr) {
        case S2_E0 * 10 + 1: return s2_by_lpt<S2_E0, 1>(lpt);
        case S2_E1 * 10 + 1: return s2_by_lpt<S2_E1, 1>(lpt);
        case S2_E2 * 10 + 1: return s2_by_lpt<S2_E2, 1>(lpt);
        case S2_E3 * 10 + 1: return s2_by_lpt<S2_E3, 1>(lpt);
        case S2_V0 * 10 + 1: return s2_by_lpt<S2_V0, 1>(lpt);
        case S2_V1 * 10 + 1: return s2_by_lpt<S2_V1, 1>(lpt);
        case S2_V2 * 10 + 1: return s2_by_lpt<S2_V2, 1>(lpt);
        case S2_W2 * 10 + 1: return s2_by_lpt<S2_W2, 1>(lpt);
        case S2_V0 * 10 + 2: return s2_by_lpt<S2_V0, 2>(lpt);
        case S2_V0 * 10 + 4: return s2_by_lpt<S2_V0, 4>(lpt);
        case S2_V2 * 10 + 2: return s2_by_lpt<S2_V2, 2>(lpt);
        default: return nullptr;
    }
}

extern "C" int s2_extract_ab(int variant, int n_ptr, const float* nodes, int m_pad, int n_iters,
                             const float* o, const float* d, float* out, int n, int tile,
                             void* stream) {
    int lpt = 1;
    while (lpt < 8 && tile > lpt * S2_MAX_THREADS) lpt *= 2;
    S2Kernel kernel = s2_kernel(variant, n_ptr, lpt);
    if (kernel == nullptr || tile <= 0 || tile % 128 != 0 || tile > 8 * S2_MAX_THREADS ||
        n <= 0 || n % tile != 0 || m_pad <= 7 * (n_ptr - 1) || n_iters < 0)
        return (int)cudaErrorInvalidValue;
    kernel<<<n / tile, tile / lpt, 0, (cudaStream_t)stream>>>(nodes, m_pad, n_iters, o, d, out,
                                                              tile);
    return (int)cudaGetLastError();
}
