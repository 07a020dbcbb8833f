// Tables copied into a block's shared memory before it walks (the STAGE
// builds of the whole-path kernel, csrc/trace.cuh, and of the traverse
// kernel K6, csrc/megakernel_split.cu): thread 0 starts one
// cp.async.bulk per table, all completing on one mbarrier, and the block
// waits for it; the tables then lie back to back from the block's dynamic
// shared memory. A set of tables stages where each is a multiple of 16
// bytes and together they take at most MK_STAGE_BYTES
// (cuda_build.MK_STAGE_BYTES: eight resident blocks of the whole-path
// kernel keep most of the SM's L1 for its spills). The host build (the
// shim of tests/test_torch_kernel_host.py defines MK_HOST_BUILD) has no
// shared memory or bulk copy and never stages.
#pragma once

#include <cuda_runtime.h>

#ifndef MK_STAGE_BYTES
#error "build with cuda_pt_torch/ops/cuda_build.py, which passes MK_STAGE_BYTES"
#endif

// the bytes to stage of n tables, or 0 where they do not fit
static unsigned stage_fit(const unsigned* bytes, int n) {
#ifdef MK_HOST_BUILD
    return 0;
#else
    unsigned total = 0;
    for (int k = 0; k < n; ++k) {
        if (bytes[k] % 16) return 0;
        total += bytes[k];
    }
    return total <= MK_STAGE_BYTES ? total : 0;
#endif
}

// Copy the N tables src[k] of bytes[k] (0: none) into smem, back to back;
// off[k] is table k's offset there. Every thread of the block calls it and
// returns once the tables have arrived.
template <int N>
__device__ __forceinline__ void stage_tables(unsigned char* smem, const float* const (&src)[N],
                                             const unsigned (&bytes)[N], unsigned (&off)[N + 1]) {
    off[0] = 0;
#pragma unroll
    for (int k = 0; k < N; ++k) off[k + 1] = off[k] + bytes[k];
#ifdef __CUDA_ARCH__
    __shared__ __align__(8) unsigned long long stage_bar;
    uint32_t bar = (uint32_t)__cvta_generic_to_shared(&stage_bar);
    uint32_t dst = (uint32_t)__cvta_generic_to_shared(smem);
    if (threadIdx.x == 0) {
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(bar) : "memory");
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                     :: "r"(bar), "r"(off[N]) : "memory");
#pragma unroll
        for (int k = 0; k < N; ++k) {
            if (bytes[k] == 0) continue;
            asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
                         "[%0], [%1], %2, [%3];"
                         :: "r"(dst + off[k]), "l"(src[k]), "r"(bytes[k]), "r"(bar)
                         : "memory");
        }
    }
    __syncthreads();  // the barrier is initialised
    uint32_t ready = 0;
    while (!ready) {
        asm volatile("{\n.reg .pred p;\n"
                     "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
                     "selp.u32 %0, 1, 0, p;\n}\n"
                     : "=r"(ready) : "r"(bar) : "memory");
    }
#endif
}
