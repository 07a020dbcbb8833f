// The split form of the sorted-wavefront driver (grid media): kernel K6,
// the closest walk alone on the live lanes, and the SHADE instantiations
// of kernel K5 (csrc/seg.cuh), which take that hit as planes (built only
// with ALL, MED and GRID: a grid pack is the one that takes the split
// form; f32 or CPT tables, w8 nodes), in a translation unit of their own.
//
// K6 replaces the TPU kernel's traverse phase (ops/pallas/megakernel.py
// _kernel with phase="traverse", :525-533, :1174-1183; pallas_call :3390):
// the TPU walk captured (t, gid, u, v) per leaf candidate and left the
// attributes to an XLA row gather (resolve_hit); here a thread walks its
// own ray (walk.cuh, as closest_hit_kernel in megakernel.cu; in the pack's
// node format) and the driver makes the same gather in PyTorch
// (ops/megakernel.resolve_hit).
// Bound on an H100: bytes, counted as 28 B of state read and 16 B of hit
// written per live lane plus the nodes and prims, against the walk's slab
// and triangle tests; the time goes to the walk's dependent loads, as in
// the whole-path kernel, and the driver's sort keeps a warp's rays close.
// C entry point:
//   mk_traverse -> (t, gid, u, v) f32 planes (4, n) of the closest hit of
//                  the first n lanes of the state planes, gid -1 on a miss
//                  or a dead lane (t = inf there); fmt and n_nodes as in
//                  mk_trace_seg
// It returns cudaGetLastError() right after the launch.

#include "seg.cuh"

template <bool BIN, bool CPT>
__global__ void __launch_bounds__(128) traverse_kernel(Pack pk, const int* __restrict__ state,
                                                       int stride, int n, float* __restrict__ out,
                                                       int* __restrict__ stats) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const int* sp = state + i;
    ClosestHit h{INFINITY, -1, 0.0f, 0.0f};
    if (seg_ld(sp, 14, stride) > 0.5f) {
        WalkStats st{0, 0};
        V3 o = v3(seg_ld(sp, 2, stride), seg_ld(sp, 3, stride), seg_ld(sp, 4, stride));
        V3 d = v3(seg_ld(sp, 5, stride), seg_ld(sp, 6, stride), seg_ld(sp, 7, stride));
        h = walk_closest<BIN, CPT>(pk, o, d, st);
        if (stats != nullptr) {
            stats[2 * (size_t)i] += st.nodes;
            stats[2 * (size_t)i + 1] += st.prims;
        }
    }
    out[i] = h.t;
    out[(size_t)n + i] = (float)h.prim;
    out[2 * (size_t)n + i] = h.b1;
    out[3 * (size_t)n + i] = h.b2;
}

void launch_shade(bool k3, bool cpt, const Pack& pk, const DepthCaps& md, int nee_m,
                  const SegArgs& a, const MedArgs& ma, cudaStream_t stream) {
    if (k3 && cpt) {
        launch_seg<true, true, true, true, true, false, true>(pk, md, nee_m, a, ma, stream);
    } else if (k3) {
        launch_seg<true, true, true, true, true>(pk, md, nee_m, a, ma, stream);
    } else if (cpt) {
        launch_seg<false, true, true, true, true, false, true>(pk, md, nee_m, a, ma, stream);
    } else {
        launch_seg<false, true, true, true, true>(pk, md, nee_m, a, ma, stream);
    }
}

template <bool BIN, bool CPT>
static void launch_traverse(const Pack& pk, const int* state, int stride, int n, float* out,
                            int* stats, cudaStream_t stream) {
    int threads = 128;
    int blocks = (n + threads - 1) / threads;
    traverse_kernel<BIN, CPT><<<blocks, threads, 0, stream>>>(pk, state, stride, n, out, stats);
}

extern "C" int mk_traverse(const void* const* tables, const int* state, int stride, int n,
                           float* out, int* stats, int max_leaf, int tri_only, int fmt,
                           int n_nodes, void* stream) {
    Pack pk = make_pack_view(tables, max_leaf, tri_only, fmt, n_nodes, 0, 0, 0);
    cudaStream_t st = (cudaStream_t)stream;
    if (n > 0) {
        if (fmt & FMT_BIN) {
            launch_traverse<true, true>(pk, state, stride, n, out, stats, st);
        } else if (fmt & FMT_COMPACT) {
            launch_traverse<false, true>(pk, state, stride, n, out, stats, st);
        } else {
            launch_traverse<false, false>(pk, state, stride, n, out, stats, st);
        }
    }
    return (int)cudaGetLastError();
}
