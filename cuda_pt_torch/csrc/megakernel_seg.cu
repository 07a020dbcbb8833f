// Kernel K5's SEG instantiations of w8 packs (csrc/seg.cuh: one bounce per
// launch on carried state, the bounce walking its own closest hit), in a
// translation unit of their own so that the whole-path kernels' module
// stays as it is (csrc/trace.cuh), and the C entry point of every K5
// launch (those of binary packs are built in csrc/megakernel_seg_bin.cu,
// those of w8 packs with t9 prims or bf16 attrs in megakernel_seg_cpt.cu):
//   mk_trace_seg -> the state planes advanced by one bounce in place, for
//                   the first n lanes; writes the instantiation it launched
//                   to *variant (bits: K3 1, ALL 2, MED 4, SEG 8, SHADE 16,
//                   GRID 32, BIN 64, CPT 128)
//   mk_closest_hit_sorted
//                -> (t, prim, b1, b2) of the sorted-lane walk of
//                   csrc/walk.cuh alone (w8 packs only) and, per ray, the
//                   most entries its stack held
// Both take the pack's table formats as fmt (FMT_* bits, csrc/common.cuh)
// and a binary tree's node count as n_nodes, and return cudaGetLastError()
// right after the launch.

#include "seg.cuh"

template <bool CPT>
__global__ void __launch_bounds__(SW_THREADS) sorted_hit_kernel(Pack pk,
                                                                const float* __restrict__ ray_o,
                                                                const float* __restrict__ ray_d,
                                                                float* __restrict__ out_t,
                                                                int* __restrict__ out_prim,
                                                                float* __restrict__ out_b1,
                                                                float* __restrict__ out_b2,
                                                                int* __restrict__ depth, int B) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    unsigned mask = __ballot_sync(0xffffffffu, i < B);
    if (i >= B) return;
    WalkStats st{0, 0};
    ClosestHit h = walk_sw<false, true, CPT, true>(pk, load3(ray_o + 3 * (size_t)i),
                                                   load3(ray_d + 3 * (size_t)i), INFINITY, mask,
                                                   st, depth + i);
    out_t[i] = h.t;
    out_prim[i] = h.prim;
    out_b1[i] = h.b1;
    out_b2[i] = h.b2;
}

extern "C" int mk_closest_hit_sorted(const void* const* tables, const float* ray_o,
                                     const float* ray_d, float* out_t, int* out_prim,
                                     float* out_b1, float* out_b2, int* depth, int B,
                                     int max_leaf, int tri_only, int fmt, int n_nodes,
                                     void* stream) {
    if ((fmt & FMT_BIN) != 0) return (int)cudaErrorInvalidValue;
    Pack pk = make_pack_view(tables, max_leaf, tri_only, fmt, n_nodes, 0, 0, 0);
    cudaStream_t st = (cudaStream_t)stream;
    if (B > 0) {
        int threads = SW_THREADS;
        int blocks = (B + threads - 1) / threads;
        if (fmt & FMT_COMPACT) {
            sorted_hit_kernel<true><<<blocks, threads, 0, st>>>(pk, ray_o, ray_d, out_t, out_prim,
                                                                out_b1, out_b2, depth, B);
        } else {
            sorted_hit_kernel<false><<<blocks, threads, 0, st>>>(pk, ray_o, ray_d, out_t, out_prim,
                                                                 out_b1, out_b2, depth, B);
        }
    }
    return (int)cudaGetLastError();
}

extern "C" int mk_trace_seg(const void* const* tables, int* state, int stride, int n, int bounce,
                            const float* hit, const float* flight, int* stats, int max_leaf,
                            int tri_only, int fmt, int n_nodes, int has_env, int textured,
                            int has_disp, int all_families, int has_media, int has_grid,
                            int ambient_med, int max_depth, int max_diffuse, int max_specular,
                            int max_transmit, int max_volume, int nee_m, int* variant,
                            void* stream) {
    Pack pk = make_pack_view(tables, max_leaf, tri_only, fmt, n_nodes, has_env, textured,
                             has_disp);
    DepthCaps md{max_depth, max_diffuse, max_specular, max_transmit};
    MedArgs ma{(const float*)tables[11], ambient_med, max_volume};
    SegArgs a{bounce, state, stride, n, hit, flight, stats};
    cudaStream_t st = (cudaStream_t)stream;
    bool k3 = has_env || textured || has_disp;
    // a grid pack (always with media) takes the split driver and the SHADE
    // form: grid flight and NEE resolve between launches
    bool grid = has_media && has_grid;
    // MED and SHADE are built with ALL only
    bool all = all_families || has_media;
    // no SHADE form for a binary pack: the split driver needs a w8 pack
    // (ops/megakernel.trace_megakernel_swf raises before a launch)
    if ((fmt & FMT_BIN) != 0 && grid) return (int)cudaErrorInvalidValue;
    bool bin = (fmt & FMT_BIN) != 0;
    bool cpt = !bin && (fmt & FMT_COMPACT) != 0;
    if (variant != nullptr) {
        *variant = (k3 ? 1 : 0) | (all ? 2 : 0) | (has_media ? 4 : 0) | 8 | (grid ? 16 | 32 : 0)
                   | (bin ? 64 : 0) | (cpt ? 128 : 0);
    }
    if (n > 0) {
        if (bin) {
            launch_seg_bin(k3, all, has_media, pk, md, nee_m, a, ma, st);
        } else if (grid) {
            launch_shade(k3, cpt, pk, md, nee_m, a, ma, st);
        } else if (cpt) {
            launch_seg_cpt(k3, all, has_media, pk, md, nee_m, a, ma, st);
        } else if (has_media && k3) {
            launch_seg<true, true, true, false, false>(pk, md, nee_m, a, ma, st);
        } else if (has_media) {
            launch_seg<false, true, true, false, false>(pk, md, nee_m, a, ma, st);
        } else if (k3 && all) {
            launch_seg<true, true, false, false, false>(pk, md, nee_m, a, ma, st);
        } else if (k3) {
            launch_seg<true, false, false, false, false>(pk, md, nee_m, a, ma, st);
        } else if (all) {
            launch_seg<false, true, false, false, false>(pk, md, nee_m, a, ma, st);
        } else {
            launch_seg<false, false, false, false, false>(pk, md, nee_m, a, ma, st);
        }
    }
    return (int)cudaGetLastError();
}
