// Kernel S3: the per-lane gather micro-kernel. Every element of x (R, 128)
// runs REPS iterations of one body on its accumulator, inside the kernel:
//   e0    acc = fmaf(acc, 1.000001, 0.5) (the loop's floor; XLA contracts the
//         reference's acc * 1.000001 + 0.5 into one rounding on the CPU)
//   gN    N gathers from the shared 128-float row: acc = acc + row[(idx + i) % 128]
//   wN    N selects: acc = idx == i ? acc + 1 : acc, i = 0 .. N - 1
//   sN    gN with the row in registers (four per lane) and read by warp
//         shuffles: four __shfl_sync and a select per gather, bit-equal to gN
// and the check form ``gather``: out = row[idx], once.
//
// Replaces the TPU micro-kernels of scripts/exp_lanegather.py: the timed
// kernels of make() (pallas_call at :57; bodies base, g_n, w_n) and kern_chk
// (:100). On the TPU the row was broadcast to the (R, 128) tile and gathered
// along the lanes (take_along_axis, Mosaic's dynamic gather); here a timed
// form's block of 128 threads stages the row once in shared memory, and a
// gather is one shared load at a per-thread address. idx must lie in [0,
// 128) (the reference's inputs); the kernel masks it to the row so no
// address leaves it.
//
// Bound on an H100: the bytes (x, idx read, out written, each 4 B per
// element, the row once) against the f32 operations (REPS x 2 for e0, REPS x
// N adds for gN and wN); the gathers are shared-memory loads, which the
// bound does not count, so the gN forms sit far above it by design: the
// kernel measures what a gather costs against a select.
//
// The check gather moves 8 B per element and does no arithmetic: it is
// bound by the bytes, and at the reference's 8,192 elements by the launch.
// A block per 128 elements, each staging the row and meeting a barrier
// before one 4 B load and store, took 4x its bound; so the gather
// (gather_kernel) gives each thread a 16 B chunk (four elements) with the
// row in registers, on ceil(n / 4 / 256) blocks of 256 threads. An empty
// kernel on the same grid (kind 5) gives the launch floor that its time
// sits on.
//
// Built with -fmad=false (ops/cuda_build.py) like every unit; e0's fused
// multiply-add is written out (fmaf), so it rounds once whatever the flag.
//
// C entry point:
//   s3_lanegather(kind, n_ops, ...) -> out (n,); kind 0 e0, 1 gN, 2 wN, 3 sN,
//                 4 gather (idx and out 16 B aligned), 5 the empty kernel on
//                 the gather's grid; n a multiple of 128; returns
//                 cudaErrorInvalidValue for a form that is not built, else
//                 cudaGetLastError() right after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

#define S3_ROW 128
#define S3_CHECK_THREADS 256  // threads per block of the check gather

enum { S3_BASE = 0, S3_GATHER = 1, S3_WHERE = 2, S3_SHUFFLE = 3, S3_CHECK = 4, S3_EMPTY = 5 };

template <int KIND, int N>
__global__ void __launch_bounds__(S3_ROW) lanegather_kernel(const float* __restrict__ x,
                                                            const float* __restrict__ row,
                                                            const int* __restrict__ idx,
                                                            float* __restrict__ out, int reps) {
    __shared__ float srow[S3_ROW];
    int t = threadIdx.x;
    srow[t] = row[t];
    __syncthreads();
    size_t i = (size_t)blockIdx.x * S3_ROW + t;
    int id = idx[i];
    // sN: lane l holds row[l], row[l + 32], row[l + 64], row[l + 96]
    float r0 = srow[t & 31], r1 = srow[(t & 31) + 32], r2 = srow[(t & 31) + 64],
          r3 = srow[(t & 31) + 96];
    float acc = x[i];
    for (int r = 0; r < reps; ++r) {
        if (KIND == S3_BASE) {
            acc = fmaf(acc, 1.000001f, 0.5f);
        } else if (KIND == S3_GATHER) {
#pragma unroll
            for (int k = 0; k < N; ++k) acc = acc + srow[(id + k) & (S3_ROW - 1)];
        } else if (KIND == S3_WHERE) {
#pragma unroll
            for (int k = 0; k < N; ++k) acc = id == k ? acc + 1.0f : acc;
        } else {
#pragma unroll
            for (int k = 0; k < N; ++k) {
                int j = (id + k) & (S3_ROW - 1);
                float v0 = __shfl_sync(0xffffffffu, r0, j & 31);
                float v1 = __shfl_sync(0xffffffffu, r1, j & 31);
                float v2 = __shfl_sync(0xffffffffu, r2, j & 31);
                float v3 = __shfl_sync(0xffffffffu, r3, j & 31);
                int q = j >> 5;
                acc = acc + (q == 0 ? v0 : q == 1 ? v1 : q == 2 ? v2 : v3);
            }
        }
    }
    out[i] = acc;
}

// The check gather: thread c of the grid takes the 16 B chunk c of the n
// elements (n4 = n / 4 chunks): an int4 of idx in, a float4 out. The row
// stays in registers, lane l of each warp holding row[l + 32 k] for k < 4,
// and an element takes its value by four shuffles and a select (the sN
// forms' read, with no barrier; a shared-memory copy of the row gives the
// same bits and measured within 4 % of it either way: PERF.md). Every
// lane of a warp shuffles; lanes past n4 store nothing.
__device__ __forceinline__ float s3_pick(float r0, float r1, float r2, float r3, int j) {
    j &= S3_ROW - 1;
    float v0 = __shfl_sync(0xffffffffu, r0, j & 31);
    float v1 = __shfl_sync(0xffffffffu, r1, j & 31);
    float v2 = __shfl_sync(0xffffffffu, r2, j & 31);
    float v3 = __shfl_sync(0xffffffffu, r3, j & 31);
    int q = j >> 5;
    return q == 0 ? v0 : q == 1 ? v1 : q == 2 ? v2 : v3;
}

__global__ void __launch_bounds__(S3_CHECK_THREADS) gather_kernel(const float* __restrict__ row,
                                                                  const int4* __restrict__ idx,
                                                                  float4* __restrict__ out,
                                                                  int n4) {
    int lane = threadIdx.x & 31;
    float r0 = __ldg(row + lane), r1 = __ldg(row + lane + 32), r2 = __ldg(row + lane + 64),
          r3 = __ldg(row + lane + 96);
    int c = blockIdx.x * S3_CHECK_THREADS + threadIdx.x;
    int4 id = c < n4 ? __ldg(idx + c) : make_int4(0, 0, 0, 0);
    float4 v;
    v.x = s3_pick(r0, r1, r2, r3, id.x);
    v.y = s3_pick(r0, r1, r2, r3, id.y);
    v.z = s3_pick(r0, r1, r2, r3, id.z);
    v.w = s3_pick(r0, r1, r2, r3, id.w);
    if (c < n4) out[c] = v;
}

// The launch floor: an empty kernel on the check gather's grid.
__global__ void empty_kernel() {}

static int launch_gather(bool empty, const float* row, const int* idx, float* out, int n,
                         cudaStream_t stream) {
    if (((uintptr_t)idx | (uintptr_t)out) & 15) return (int)cudaErrorInvalidValue;
    int n4 = n / 4;
    int blocks = (n4 + S3_CHECK_THREADS - 1) / S3_CHECK_THREADS;
    if (empty) {
        empty_kernel<<<blocks, S3_CHECK_THREADS, 0, stream>>>();
    } else {
        gather_kernel<<<blocks, S3_CHECK_THREADS, 0, stream>>>(
            row, reinterpret_cast<const int4*>(idx), reinterpret_cast<float4*>(out), n4);
    }
    return (int)cudaGetLastError();
}

typedef void (*S3Kernel)(const float*, const float*, const int*, float*, int);

// the built forms: kind and operations per iteration
static S3Kernel s3_kernel(int kind, int n_ops) {
    switch (kind * 1000 + n_ops) {
        case S3_BASE * 1000: return lanegather_kernel<S3_BASE, 0>;
        case S3_GATHER * 1000 + 1: return lanegather_kernel<S3_GATHER, 1>;
        case S3_GATHER * 1000 + 4: return lanegather_kernel<S3_GATHER, 4>;
        case S3_GATHER * 1000 + 14: return lanegather_kernel<S3_GATHER, 14>;
        case S3_WHERE * 1000 + 14: return lanegather_kernel<S3_WHERE, 14>;
        case S3_WHERE * 1000 + 112: return lanegather_kernel<S3_WHERE, 112>;
        case S3_SHUFFLE * 1000 + 1: return lanegather_kernel<S3_SHUFFLE, 1>;
        case S3_SHUFFLE * 1000 + 4: return lanegather_kernel<S3_SHUFFLE, 4>;
        case S3_SHUFFLE * 1000 + 14: return lanegather_kernel<S3_SHUFFLE, 14>;
        default: return nullptr;
    }
}

extern "C" int s3_lanegather(int kind, int n_ops, const float* x, const float* row,
                             const int* idx, float* out, int n, int reps, void* stream) {
    if (n <= 0 || n % S3_ROW != 0) return (int)cudaErrorInvalidValue;
    if ((kind == S3_CHECK || kind == S3_EMPTY) && n_ops == 0)
        return launch_gather(kind == S3_EMPTY, row, idx, out, n, (cudaStream_t)stream);
    S3Kernel kernel = s3_kernel(kind, n_ops);
    if (kernel == nullptr || reps < 0) return (int)cudaErrorInvalidValue;
    kernel<<<n / S3_ROW, S3_ROW, 0, (cudaStream_t)stream>>>(x, row, idx, out, reps);
    return (int)cudaGetLastError();
}
