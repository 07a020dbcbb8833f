// Kernel S1: the node-cost micro-kernel. N serial steps of the binary skip
// walk's interior node step per thread, on binary f32 node rows: fetch the
// node, run the slab test, take ptr + 1 on a box hit at an interior node and
// the skip otherwise, wrap at m_pad (the rows' slots); out sums tn over the
// box hits. Timed at N and N / 2 it gives the cost of one node step, which
// with the megakernel's count_stats (node fetches) models the kernel's time
// as its irreducible walk work.
//
// Replaces the TPU micro-kernel _node_bench_kernel (scripts/roofline.py:34,
// pallas_call in _time_node_bench :116), which stepped a (R, 128) tile of
// rays through the nodes in lockstep with one tile-shared pointer. Here each
// thread steps its own pointer; with rays that are the same on every thread
// (the reference's 0.1 0.2 0.3 0.5 0.6 0.7 on every lane) the walk is the
// tile's, and out is bit-equal to the plain version
// (ops/node_bench.node_bench_reference; -fmad=false).
//
// Bound on an H100: operations (22 per step) against the 24 B each ray reads
// and the 4 B it writes, the rows once; the steps of a thread depend on the
// last step's pointer, so the time is the dependent load's latency, hidden
// only by the other resident warps.
//
// C entry point:
//   s1_node_bench -> out (n,) for rays o, d (n, 3) over the node rows;
//                    returns cudaGetLastError() right after the launch.

#include <cuda_runtime.h>
#include <math.h>

#include "bin_node.cuh"

#if !defined(HIT_EPS) || !defined(SLOT_F)
#error "build with cuda_pt_torch/ops/cuda_build.py, which passes the shared constants"
#endif

__device__ __forceinline__ float s1_safe_inv(float v) {
    return 1.0f / (fabsf(v) < 1e-8f ? (v < 0.0f ? -1e-8f : 1e-8f) : v);
}

__global__ void __launch_bounds__(128) node_bench_kernel(const float* __restrict__ nodes,
                                                         int m_pad, int n_iters,
                                                         const float* __restrict__ ray_o,
                                                         const float* __restrict__ ray_d,
                                                         float* __restrict__ out, int n) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    float o[3], inv[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        o[k] = ray_o[3 * (size_t)i + k];
        inv[k] = s1_safe_inv(ray_d[3 * (size_t)i + k]);
    }
    int ptr = 0;
    float acc = 0.0f;
    for (int it = 0; it < n_iters; ++it) {
        K1Node nd = k1_node<false>(nodes, ptr);
        float tx0 = (nd.lo[0] - o[0]) * inv[0];
        float tx1 = (nd.hi[0] - o[0]) * inv[0];
        float ty0 = (nd.lo[1] - o[1]) * inv[1];
        float ty1 = (nd.hi[1] - o[1]) * inv[1];
        float tz0 = (nd.lo[2] - o[2]) * inv[2];
        float tz1 = (nd.hi[2] - o[2]) * inv[2];
        float tn = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)), fminf(tz0, tz1));
        float tf = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)), fmaxf(tz0, tz1));
        bool box = (tn <= tf) && (tf > HIT_EPS) && (tn < 1e30f);
        int next = (box && nd.cnt <= 0) ? ptr + 1 : nd.skip;
        ptr = next >= m_pad ? 0 : next;
        acc = acc + (box ? tn : 0.0f);
    }
    out[i] = acc;
}

static void launch_node_bench(const float* nodes, int m_pad, int n_iters, const float* o,
                              const float* d, float* out, int n, cudaStream_t stream) {
    int threads = 128;
    int blocks = (n + threads - 1) / threads;
    node_bench_kernel<<<blocks, threads, 0, stream>>>(nodes, m_pad, n_iters, o, d, out, n);
}

extern "C" int s1_node_bench(const float* nodes, int m_pad, int n_iters, const float* o,
                             const float* d, float* out, int n, void* stream) {
    if (n > 0) launch_node_bench(nodes, m_pad, n_iters, o, d, out, n, (cudaStream_t)stream);
    return (int)cudaGetLastError();
}
