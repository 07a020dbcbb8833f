// The persistent grid of kernels K2-K4 (csrc/trace.cuh): a launch holds as
// many blocks as the card keeps resident, and each lane whose path has
// ended takes the next one from a work counter in device memory, so a warp
// stays full until the work runs out instead of idling on its longest
// path.
//
// A warp takes its indices together: a ballot of the lanes that need work,
// one atomicAdd by the first of them for all, a shuffle of the base, and
// each lane's rank among them (__popc of the lower ballot bits), so the
// lanes of one take get neighbouring indices. The counter resets without a
// host sync: each warp counts itself out once all its lanes have left, and
// the last warp of the grid zeroes the counter for the next launch
// (launches of one kernel on one stream run one after another).
//
// Host build: the shim of tests/test_torch_kernel_host.py defines
// PERSIST_WARP 1 (a warp of one thread) and runs a launch's threads one
// after another, so its first thread takes every index.
//
// Used by the whole-path kernel (csrc/trace.cuh). K1's walk (csrc/
// traverse.cu) was built on it too and lost to its one-thread-per-ray
// form on the card (PERF.md), so it keeps that form.
#pragma once

#include <cuda_runtime.h>

#ifndef PERSIST_WARP
#define PERSIST_WARP 32  // lanes per warp
#endif
// the lanes of a warp, as a mask
#define PERSIST_ALL (PERSIST_WARP == 32 ? 0xffffffffu : ((1u << PERSIST_WARP) - 1u))

struct WorkCounter {
    int next;  // the next index to hand out
    int done;  // warps of the running launch that have left
};

// This lane's index in its warp.
__device__ __forceinline__ int persist_lane() { return (int)(threadIdx.x % PERSIST_WARP); }

// The lanes of the warp for which want has a bit (every lane of the warp
// calls this, converged) take consecutive indices: returns this lane's
// (meaningful where its bit is set) and sets end to the first index past
// the take, the same on every lane.
__device__ __forceinline__ int persist_take(WorkCounter* w, unsigned want, int lane, int& end) {
    int leader = __ffs(want) - 1;
    int base = 0;
    if (lane == leader) base = atomicAdd(&w->next, __popc(want));
    base = __shfl_sync(PERSIST_ALL, base, leader);
    end = base + __popc(want);
    return base + __popc(want & ((1u << lane) - 1u));
}

// Called by every lane of a warp once it has left its loop: the last warp
// of the launch's n_warps resets the counter.
__device__ __forceinline__ void persist_finish(WorkCounter* w, int n_warps, int lane) {
    if (lane != 0) return;
    __threadfence();  // this warp's takes happen before its count
    if (atomicAdd(&w->done, 1) == n_warps - 1) {
        atomicExch(&w->next, 0);
        atomicExch(&w->done, 0);
    }
}

// Blocks of threads threads (smem bytes of dynamic shared memory each) for
// a persistent launch of kernel over n items:
// the blocks the card keeps resident (occupancy per SM x SMs, queried once
// per kernel into *resident), at most one per threads items. Returns the
// runtime's error of a failed query (the launch must not go ahead), or
// cudaErrorInvalidConfiguration where the kernel cannot be resident at all.
template <class Kernel>
static int persist_blocks(Kernel kernel, int threads, int n, int* resident, int* blocks,
                          size_t smem = 0) {
    if (*resident <= 0) {
        int dev = 0, sms = 0, per_sm = 0;
        cudaError_t e = cudaGetDevice(&dev);
        if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        if (e == cudaSuccess) {
            e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
        }
        if (e != cudaSuccess) return (int)e;
        if (per_sm * sms <= 0) return (int)cudaErrorInvalidConfiguration;
        *resident = per_sm * sms;
    }
    int need = (n + threads - 1) / threads;
    *blocks = need < *resident ? need : *resident;
    return 0;
}
