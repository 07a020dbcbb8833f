// The split form of the sorted-wavefront driver (grid media): kernel K6,
// the closest walk of the live lanes and its hit resolve, and the SHADE
// instantiations of kernel K5 (csrc/seg.cuh), which take that hit as planes (built only
// with ALL, MED and GRID: a grid pack is the one that takes the split
// form; f32 or CPT tables, w8 nodes), in a translation unit of their own.
//
// K6 replaces the TPU kernel's traverse phase (ops/pallas/megakernel.py
// _kernel with phase="traverse", :525-533, :1174-1183; pallas_call :3390)
// and the row gather that follows it (resolve_hit, :3404-3430): the TPU
// walk captured (t, gid, u, v) per leaf candidate and left the attributes
// to one XLA row gather, since a TPU kernel could not gather rows. Here a
// thread walks its own ray (walk.cuh, as closest_hit_kernel in
// megakernel.cu; in the pack's node format) and then reads its hit's row
// of the pack's g_hit itself and writes the SHADE form's hit planes, with
// ops/megakernel.resolve_hit's operations in its order, (w0 a + u b) + v c
// (FMA contraction off, as in every build): the driver's PyTorch gather,
// some 14 launches per bounce, is gone.
// Bound on an H100: bytes, counted as 28 B of state read and the hit planes
// written per live lane, the g_hit columns read per hit lane, plus the
// nodes and prims, against the walk's slab and triangle tests. On a small
// scene the launch is as long as one thread's chain of dependent loads
// (its state, the node, the leaf's prims, the g_hit row), not as long as
// its bytes take: so where the walk tables of a w8 f32 pack fit
// (stage_fit of csrc/stage.cuh: nodes, prims and g_hit together), each
// block first copies them into shared memory and the walk and the gather
// read them there (the STAGE build);
// those launches are a grid of the blocks the card keeps resident
// (csrc/persist.cuh persist_blocks) striding over the lanes, so a block
// stages once for many lanes. The driver's sort keeps a warp's rays close.
// C entry point:
//   mk_traverse_resolve -> the hit planes (n_hit, n) of the closest hit of
//                  the first n lanes of the state planes (a miss or a dead
//                  lane: resolve_hit's gid -1, row 0 and hit 0, t = inf);
//                  trav (nullable, null on the driver's path): the walk's
//                  (t, gid, u, v) f32 planes (4, n) as well, gid -1 and
//                  u = v = 0 on a miss or a dead lane; stats (nullable):
//                  node and prim counts added per lane; fmt and n_nodes as
//                  in mk_trace_seg
// It returns the error of a refused occupancy query (nothing launched),
// else cudaGetLastError() right after the launch.

#include "persist.cuh"
#include "seg.cuh"

// the traverse kernel's block size (64 and 256 measured slower, PERF.md)
#define K6_THREADS 128

#define G_HIT_F 32  // f32 fields per g_hit row (ops/megakernel.pack_hit_matrix)

// The hit planes' optional members (their first plane, -1 where absent)
// and the count, as ops/megakernel.resolve_hit stacks them.
struct HitPlanes {
    int sph, bid, uv, med, n;
};

static HitPlanes hit_planes(int tri_only, int textured, int has_media) {
    HitPlanes hp;
    int k = 10;  // t, hit, ns(3), ng(3), eid, inv_area
    hp.sph = tri_only ? -1 : k++;
    hp.bid = k++;
    hp.uv = textured ? k : -1;
    k += textured ? 2 : 0;
    hp.med = has_media ? k : -1;
    k += has_media ? 2 : 0;
    hp.n = k;
    return hp;
}

// The bytes a STAGE launch copies: nodes, prims, g_hit.
struct K6Stage {
    unsigned n[3];
};

// Whether a pack runs the STAGE build: w8 nodes and f32 tables whose
// nodes, prims and g_hit fit together (stage_fit); sb the bytes.
static bool k6_stage(const void* const* t, int fmt, unsigned ghit_bytes, K6Stage& sb) {
    sb = K6Stage{{(unsigned)(size_t)t[12], (unsigned)(size_t)t[13], ghit_bytes}};
    // binary nodes, t9 prims or bf16 attrs; or the sizes withheld
    if (fmt != 0 || sb.n[0] == 0 || sb.n[1] == 0) return false;
    return stage_fit(sb.n, 3) > 0;
}

__device__ __forceinline__ void k6_plane(float* out, int k, int n, int i, float v) {
    out[(size_t)k * n + i] = v;
}

// Lane i = first, first + stride, ... below n: walk, then resolve.
template <bool BIN, bool CPT, bool STAGE>
__global__ void __launch_bounds__(K6_THREADS) traverse_kernel(
    Pack pk, const float* ghit, const int* __restrict__ state, int stride, int n, int step,
    float* __restrict__ hit, float* __restrict__ trav, int* __restrict__ stats, HitPlanes hp,
    K6Stage sb) {
#ifdef __CUDA_ARCH__
    if constexpr (STAGE) {
        extern __shared__ __align__(128) unsigned char k6_stage_mem[];
        const float* const src[3] = {pk.nodes, pk.prims, ghit};
        unsigned off[4];
        stage_tables<3>(k6_stage_mem, src, sb.n, off);
        pk.nodes = (const float*)(k6_stage_mem + off[0]);
        pk.prims = (const float*)(k6_stage_mem + off[1]);
        ghit = (const float*)(k6_stage_mem + off[2]);
    }
#endif
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += step) {
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
        if (trav != nullptr) {
            k6_plane(trav, 0, n, i, h.t);
            k6_plane(trav, 1, n, i, (float)h.prim);
            k6_plane(trav, 2, n, i, h.b1);
            k6_plane(trav, 3, n, i, h.b2);
        }
        // resolve_hit: the row of gid clamped to 0 (a miss reads row 0)
        const float* r = ghit + (size_t)G_HIT_F * (h.prim > 0 ? h.prim : 0);
        const float u = h.b1, v = h.b2;
        const float w0 = 1.0f - u - v;
        V3 ns = v3(w0 * r[0] + u * r[3] + v * r[6], w0 * r[1] + u * r[4] + v * r[7],
                   w0 * r[2] + u * r[5] + v * r[8]);
        V3 ng = v3(r[9], r[10], r[11]);
        if (hp.sph >= 0 && r[18] > 0.5f) ns = ng = v3(r[12], r[13], r[14]);  // a sphere's centre
        k6_plane(hit, 0, n, i, h.t);
        k6_plane(hit, 1, n, i, h.prim >= 0 ? 1.0f : 0.0f);
        k6_plane(hit, 2, n, i, ns.x);
        k6_plane(hit, 3, n, i, ns.y);
        k6_plane(hit, 4, n, i, ns.z);
        k6_plane(hit, 5, n, i, ng.x);
        k6_plane(hit, 6, n, i, ng.y);
        k6_plane(hit, 7, n, i, ng.z);
        k6_plane(hit, 8, n, i, r[15]);  // eid
        k6_plane(hit, 9, n, i, r[17]);  // inv_area
        if (hp.sph >= 0) k6_plane(hit, hp.sph, n, i, r[18]);
        k6_plane(hit, hp.bid, n, i, r[16]);
        if (hp.uv >= 0) {
            k6_plane(hit, hp.uv, n, i, w0 * r[21] + u * r[23] + v * r[25]);
            k6_plane(hit, hp.uv + 1, n, i, w0 * r[22] + u * r[24] + v * r[26]);
        }
        if (hp.med >= 0) {
            k6_plane(hit, hp.med, n, i, r[19]);  // medium_in
            k6_plane(hit, hp.med + 1, n, i, r[20]);  // is_null
        }
    }
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

// STAGE: the blocks the card keeps resident with the staged bytes, at
// most one per K6_THREADS lanes; else one lane per thread.
template <bool BIN, bool CPT, bool STAGE>
static int launch_traverse(const Pack& pk, const float* ghit, const int* state, int stride,
                           int n, float* hit, float* trav, int* stats, const HitPlanes& hp,
                           const K6Stage& sb, cudaStream_t stream) {
    static int resident = 0;
    int threads = K6_THREADS;
    int blocks = (n + threads - 1) / threads;
    unsigned smem = STAGE ? sb.n[0] + sb.n[1] + sb.n[2] : 0;
    if constexpr (STAGE) {
        int rc = persist_blocks(traverse_kernel<BIN, CPT, STAGE>, threads, n, &resident, &blocks,
                                MK_STAGE_BYTES);
        if (rc != 0) return rc;
    }
    traverse_kernel<BIN, CPT, STAGE><<<blocks, threads, smem, stream>>>(
        pk, ghit, state, stride, n, blocks * threads, hit, trav, stats, hp, sb);
    return (int)cudaGetLastError();
}

extern "C" int mk_traverse_resolve(const void* const* tables, const float* ghit,
                                   int ghit_bytes, const int* state, int stride, int n,
                                   float* hit, float* trav, int* stats, int max_leaf,
                                   int tri_only, int fmt, int n_nodes, int textured,
                                   int has_media, void* stream) {
    Pack pk = make_pack_view(tables, max_leaf, tri_only, fmt, n_nodes, 0, 0, 0);
    HitPlanes hp = hit_planes(tri_only, textured, has_media);
    K6Stage sb;
    bool stage = k6_stage(tables, fmt, (unsigned)ghit_bytes, sb);
    cudaStream_t st = (cudaStream_t)stream;
    if (n <= 0) return (int)cudaGetLastError();
    if (fmt & FMT_BIN) {
        return launch_traverse<true, true, false>(pk, ghit, state, stride, n, hit, trav, stats, hp,
                                              sb, st);
    } else if (fmt & FMT_COMPACT) {
        return launch_traverse<false, true, false>(pk, ghit, state, stride, n, hit, trav, stats, hp,
                                               sb, st);
    } else if (stage) {
        return launch_traverse<false, false, true>(pk, ghit, state, stride, n, hit, trav, stats,
                                                   hp, sb, st);
    }
    return launch_traverse<false, false, false>(pk, ghit, state, stride, n, hit, trav, stats, hp,
                                            sb, st);
}
