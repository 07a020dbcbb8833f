// Kernel K1: the walk of a chunked, skip-encoded binary BVH forest, closest
// hit or any hit, in a translation unit of its own.
//
// Replaces the TPU kernel _kernel (cuda_pt_tpu/ops/pallas/traverse_kernel.py
// :316) as driven by traverse_forest (:488, pallas_call :561). The TPU
// kernel walked a (R, 128) tile of rays as one packet: its VPU has no
// per-lane gather, so every step fetched one node for the whole tile and
// extracted its fields by masked reductions, and the chunk blocks streamed
// HBM -> VMEM under the grid's chunk axis. Here a thread walks its own ray
// (the per-ray form): it reads the node and prim rows it needs straight
// from device memory through the read-only path (__ldg, 16-byte loads), and
// the chunks are a loop in the thread, in order, with the best hit carried
// across them. The packet form (PACKET, for count_iters only) keeps the TPU
// kernel's lockstep: one block per tile, the descend decision taken with
// __syncthreads_or over the tile, so its node-fetch count per tile equals
// the TPU kernel's tile_iters.
//
// Arithmetic (the plain version is ops/traverse_kernel.
// traverse_forest_reference): safe_inv, the slab test (tn <= tf) &&
// (tf > HIT_EPS) && (tn < t_best), Moller-Trumbore with the |a| < 1e-12
// guard, the sphere test (radius in e1.x, t0 > HIT_EPS ? t0 : t1), strict
// t < t_best in slot order (k < count and k < max_leaf); any hit starts from
// t_far * SHADOW_T_FACTOR. Built with -fmad=false, it rounds as the plain
// version does.
//
// Bound on an H100: the walk's dependent loads. Per ray it reads 24 B of
// ray (28 B where t_far is passed) and writes 16 B of hit (4 B in any-hit
// mode), and the forest (25 MB
// for full-size kitchen_stress in f32 rows) stays in the 50 MB L2; the
// operations are 22 per node and 45 per prim test. The loads of one step
// depend on the last step's pointer, so a warp waits on L2 latency each
// node; sorting the rays (the wavefront's Morton key) keeps a warp's walks
// close. Staging a chunk's top levels in shared memory is left for later.
//
// Row layouts (ops/traverse_kernel.py): f32 nodes 16 floats (lo(3) hi(3)
// skip base count), bf16 nodes 8 floats (lo|hi bf16 pairs for x y z, the
// lower bound in the high bits; skip base count), prims 16 floats (p0(3)
// e1(3) e2(3) is_sphere gid). A chunk's rows are contiguous, so node i of
// chunk c starts at nodes + (c * rn * 128) + i * slot_width.
//
// C entry point:
//   k1_traverse -> per ray t, prim, b1, b2 (closest; prim -1 = miss) or prim
//                  (any hit: the first occluder, -1 = none); tile > 0 runs
//                  the packet form over n / tile tiles of tile threads and
//                  writes tile_iters. It returns cudaGetLastError() right
//                  after the launch.

#include <cuda_runtime.h>
#include <math.h>

#include "bin_node.cuh"

#if !defined(HIT_EPS) || !defined(SHADOW_T_FACTOR) || !defined(SLOT_F)
#error "build with cuda_pt_torch/ops/cuda_build.py, which passes the shared constants"
#endif

#define K1_ROW 128       // f32 per packed row
#define K1_SLOTS 8       // f32 node / prim slots per row
#define K1_SLOTS16 16    // bf16 node slots per row
#define K1_FAR 1e8f      // t_far when none is given

struct K1Args {
    const float* nodes;   // (C, rn, 128)
    const float* prims;   // (C, rp, 128)
    const int* n_nodes;   // (C,) real nodes per chunk
    int n_chunks, rn, rp;
    const float* o;       // (n, 3)
    const float* d;       // (n, 3)
    const float* t_far;   // (n,), nullptr = K1_FAR
    int n, max_leaf;
    float* t;             // closest hit only
    int* prim;
    float* b1;            // closest hit only
    float* b2;            // closest hit only
    int* tile_iters;      // packet form: (n / tile,) node fetches over the chunks
    int* stats;           // per-ray form, optional: (n, 2) += node fetches, prim tests
};

// Prim row p against the ray (traverse_kernel.py:404-463, in its operation
// order); true on a hit, with t, the barycentrics (0 for a sphere), the id.
__device__ __forceinline__ bool k1_prim(const float* __restrict__ row, const K1Ray& r,
                                        float& t, float& u, float& v, int& gid) {
    const float4* p = reinterpret_cast<const float4*>(row);
    float4 a = __ldg(p);
    float4 b = __ldg(p + 1);
    float4 c = __ldg(p + 2);
    float ax = a.x, ay = a.y, az = a.z;
    float ux = a.w, uy = b.x, uz = b.y;
    float vx = b.z, vy = b.w, vz = c.x;
    gid = (int)c.z;
    float sx = r.o[0] - ax, sy = r.o[1] - ay, sz = r.o[2] - az;
    float dx = r.d[0], dy = r.d[1], dz = r.d[2];
    if (c.y > 0.0f) {  // sphere: centre p0, radius e1.x
        float bh = sx * dx + sy * dy + sz * dz;
        float cc = sx * sx + sy * sy + sz * sz - ux * ux;
        float disc = bh * bh - cc;
        float sq = sqrtf(fmaxf(disc, 0.0f));
        float t0 = -bh - sq;
        float t1 = -bh + sq;
        t = t0 > HIT_EPS ? t0 : t1;
        u = 0.0f;
        v = 0.0f;
        return (disc > 0.0f) && (t > HIT_EPS);
    }
    float hx = dy * vz - dz * vy;
    float hy = dz * vx - dx * vz;
    float hz = dx * vy - dy * vx;
    float det = ux * hx + uy * hy + uz * hz;
    float f = 1.0f / (fabsf(det) < 1e-12f ? 1e-12f : det);
    u = f * (sx * hx + sy * hy + sz * hz);
    float qx = sy * uz - sz * uy;
    float qy = sz * ux - sx * uz;
    float qz = sx * uy - sy * ux;
    v = f * (dx * qx + dy * qy + dz * qz);
    t = f * (vx * qx + vy * qy + vz * qz);
    return (fabsf(det) > 1e-12f) && (u >= 0.0f) && (v >= 0.0f) && (u + v <= 1.0f) &&
           (t > HIT_EPS);
}

struct K1Hit {
    float t;
    int prim;
    float b1, b2;
};

// The prims of a leaf, slot by slot: strict t < t_best keeps the first of
// equal hits. Returns true when ANYHIT found an occluder.
template <bool ANYHIT>
__device__ __forceinline__ bool k1_leaf(const float* __restrict__ prims, const K1Node& nd,
                                        int max_leaf, const K1Ray& r, K1Hit& h, int& n_prims) {
    for (int k = 0; k < nd.cnt && k < max_leaf; ++k) {
        float t, u, v;
        int gid;
        n_prims += 1;
        bool ok = k1_prim(prims + (size_t)(nd.base + k) * SLOT_F, r, t, u, v, gid);
        if (ok && t < h.t) {
            h.t = t;
            h.prim = gid;
            h.b1 = u;
            h.b2 = v;
            if (ANYHIT) return true;
        }
    }
    return false;
}

template <bool ANYHIT, bool BF16, bool PACKET>
__global__ void __launch_bounds__(1024) k1_kernel(K1Args a) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (!PACKET && i >= a.n) return;  // the packet form runs whole tiles
    K1Ray r;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        r.o[k] = a.o[3 * (size_t)i + k];
        r.d[k] = a.d[3 * (size_t)i + k];
        r.inv[k] = k1_safe_inv(r.d[k]);
    }
    float t_lim = a.t_far != nullptr ? a.t_far[i] : K1_FAR;
    K1Hit h{ANYHIT ? t_lim * SHADOW_T_FACTOR : INFINITY, -1, 0.0f, 0.0f};
    const int slots = BF16 ? K1_SLOTS16 : K1_SLOTS;
    int n_nodes = 0, n_prims = 0;
    for (int c = 0; c < a.n_chunks; ++c) {
        const float* nodes = a.nodes + (size_t)c * a.rn * K1_ROW;
        const float* prims = a.prims + (size_t)c * a.rp * K1_ROW;
        int ptr = 0;
        if (PACKET) {
            // the tile walks in lockstep through the padding nodes too, as
            // the TPU kernel's packet does; any hit stops once every ray of
            // the tile has its occluder
            int m_pad = a.rn * slots;
            while (ptr < m_pad) {
                if (ANYHIT && !__syncthreads_or(h.prim < 0)) break;
                K1Node nd = k1_node<BF16>(nodes, ptr);
                bool live = !ANYHIT || h.prim < 0;
                bool any = __syncthreads_or(live && k1_box(nd, r, h.t)) != 0;
                bool leaf = nd.cnt > 0;
                if (any && leaf && live) k1_leaf<false>(prims, nd, a.max_leaf, r, h, n_prims);
                ptr = (any && !leaf) ? ptr + 1 : nd.skip;
                n_nodes += 1;
            }
        } else {
            // the walk past the chunk's real nodes only enters padding
            // nodes, which hold no prims
            int stop = a.n_nodes[c];
            bool found = false;
            while (ptr < stop) {
                K1Node nd = k1_node<BF16>(nodes, ptr);
                n_nodes += 1;
                bool box = k1_box(nd, r, h.t);
                bool leaf = nd.cnt > 0;
                if (box && leaf && k1_leaf<ANYHIT>(prims, nd, a.max_leaf, r, h, n_prims)) {
                    found = true;
                    break;
                }
                ptr = (box && !leaf) ? ptr + 1 : nd.skip;
            }
            if (ANYHIT && found) break;
        }
    }
    if (PACKET) {
        if (threadIdx.x == 0) a.tile_iters[blockIdx.x] = n_nodes;
    } else if (a.stats != nullptr) {
        a.stats[2 * (size_t)i] += n_nodes;
        a.stats[2 * (size_t)i + 1] += n_prims;
    }
    a.prim[i] = h.prim;
    if (!ANYHIT) {
        a.t[i] = h.t;
        a.b1[i] = h.b1;
        a.b2[i] = h.b2;
    }
}

template <bool ANYHIT, bool BF16, bool PACKET>
static void k1_launch(const K1Args& a, int blocks, int threads, cudaStream_t stream) {
    k1_kernel<ANYHIT, BF16, PACKET><<<blocks, threads, 0, stream>>>(a);
}

template <bool ANYHIT, bool BF16>
static void k1_dispatch(const K1Args& a, int tile, cudaStream_t stream) {
    if (tile > 0) {
        k1_launch<ANYHIT, BF16, true>(a, a.n / tile, tile, stream);
    } else {
        k1_launch<ANYHIT, BF16, false>(a, (a.n + 127) / 128, 128, stream);
    }
}

extern "C" int k1_traverse(const float* nodes, const float* prims, const int* n_nodes,
                           int n_chunks, int rn, int rp, const float* o, const float* d,
                           const float* t_far, int n, int max_leaf, int anyhit, int bf16, int tile,
                           float* t, int* prim, float* b1, float* b2, int* tile_iters, int* stats,
                           void* stream) {
    K1Args a{nodes, prims, n_nodes, n_chunks, rn, rp, o, d, t_far, n, max_leaf,
             t, prim, b1, b2, tile_iters, stats};
    cudaStream_t s = (cudaStream_t)stream;
    if (anyhit) {
        if (bf16) {
            k1_dispatch<true, true>(a, tile, s);
        } else {
            k1_dispatch<true, false>(a, tile, s);
        }
    } else if (bf16) {
        k1_dispatch<false, true>(a, tile, s);
    } else {
        k1_dispatch<false, false>(a, tile, s);
    }
    return (int)cudaGetLastError();
}
