// The trace kernel template and its launcher (csrc/megakernel.cu
// describes the kernel), included by the translation units that
// instantiate it: megakernel.cu (the surface instantiations, K2 and K3)
// and megakernel_med.cu (kernel K4's MED instantiations). One pass of its
// bounce loop is csrc/bounce.inc, which the segment kernel K5 (csrc/seg.cuh,
// units megakernel_seg.cu and megakernel_split.cu, where MK_SEG is defined)
// runs once per launch; this header leaves the whole-path kernel out of
// those units. Each unit is its own device module, so the K4 and K5 code
// does not reach the surface kernels' module.
#pragma once

#include "bsdf.cuh"
#include "common.cuh"
#include "media.cuh"
#include "nee.cuh"
#include "pcg.cuh"
#include "stage.cuh"
#include "tex.cuh"
#include "walk.cuh"

struct DepthCaps {
    int max_depth;
    int max_diffuse;
    int max_specular;
    int max_transmit;
};

// bsdf/spectral.XYZ_LOBES (alpha, mu, sigma below mu, sigma above mu):
// lobes 0-2 sum to xbar, 3-4 to ybar, 5-6 to zbar
#define SPEC_LOBE_ROW(l) {SPEC_LOBE##l##0, SPEC_LOBE##l##1, SPEC_LOBE##l##2, SPEC_LOBE##l##3}
static __constant__ float kXyzLobes[7][4] = {SPEC_LOBE_ROW(0), SPEC_LOBE_ROW(1), SPEC_LOBE_ROW(2),
                                      SPEC_LOBE_ROW(3), SPEC_LOBE_ROW(4), SPEC_LOBE_ROW(5),
                                      SPEC_LOBE_ROW(6)};

__device__ __forceinline__ float gauss_lobe(float x, int l) {
    const float* g = kXyzLobes[l];
    float t = (x - g[1]) / (x < g[1] ? g[2] : g[3]);
    return g[0] * expf(-0.5f * t * t);
}

// bsdf/spectral.wavelength_to_rgb: CIE 1931 Gaussian-lobe fit -> linear
// sRGB, times the mean-one normalization
__device__ __forceinline__ V3 wavelength_to_rgb(float wl) {
    float x = gauss_lobe(wl, 0) + gauss_lobe(wl, 1) + gauss_lobe(wl, 2);
    float y = gauss_lobe(wl, 3) + gauss_lobe(wl, 4);
    float z = gauss_lobe(wl, 5) + gauss_lobe(wl, 6);
    return v3((SPEC_M00 * x + SPEC_M01 * y + SPEC_M02 * z) * SPEC_NORM_R,
              (SPEC_M10 * x + SPEC_M11 * y + SPEC_M12 * z) * SPEC_NORM_G,
              (SPEC_M20 * x + SPEC_M21 * y + SPEC_M22 * z) * SPEC_NORM_B);
}

// The pack's tables in ops/megakernel.PACK_KEYS + K3_KEYS order (the
// media row follows them, MED_KEYS); fmt: the FMT_* bits of the table
// formats, n_nodes: a binary tree's real nodes.
static Pack make_pack_view(const void* const* t, int max_leaf, int tri_only, int fmt,
                           int n_nodes, int has_env, int textured, int has_disp) {
    Pack pk;
    pk.nodes = (const float*)t[0];
    pk.prims = (const float*)t[1];
    pk.attrs = (const float*)t[2];
    pk.erow = (const float*)t[3];
    pk.eprims = (const float*)t[4];
    pk.brows = (const float*)t[5];
    pk.uvs = (const float*)t[6];
    pk.texels = (const float*)t[7];
    pk.tinfo = (const int*)t[8];
    pk.tdiff = (const int*)t[9];
    pk.envrow = (const float*)t[10];
    pk.max_leaf = max_leaf;
    pk.tri_only = tri_only;
    pk.node_bf16 = (fmt & FMT_NODE_BF16) != 0;
    pk.n_nodes = n_nodes;
    pk.prim_t9 = (fmt & FMT_PRIM_T9) != 0;
    pk.attr_bf16 = (fmt & FMT_ATTR_BF16) != 0;
    pk.has_env = has_env;
    pk.textured = textured;
    pk.has_disp = has_disp;
    return pk;
}

#ifndef MK_SEG
#include "persist.cuh"

// The warp takes new paths once fewer than K2_REFILL_BELOW of its lanes
// still hold one: 32, after every bounce that ended a path (probe calls
// on an H100, tools/refill_probe.py: cornell 0.866 ms per spp at 32 against
// 0.890 at 16, PERF.md).
#ifndef K2_REFILL_BELOW
#define K2_REFILL_BELOW 32
#endif

// The tables a STAGE build copies into shared memory (csrc/stage.cuh), in
// order: nodes, prims, attrs, brows, erow, eprims (the walks' and the
// shading's rows), and their bytes (ops/megakernel._tables appends them
// after the table pointers). A w8 pack with f32 tables stages where they
// fit (stage_fit); the binary walk reads through __ldg and the CPT builds'
// packs are larger than 2 MiB, so those builds never stage.
#define STAGE_TABLES 6
struct StageBytes {
    unsigned n[STAGE_TABLES];
};

// the sizes follow the pack's 12 table pointers (make_pack_view, MedArgs)
static StageBytes stage_bytes(const void* const* t) {
    StageBytes sb;
    for (int k = 0; k < STAGE_TABLES; ++k) sb.n[k] = (unsigned)(size_t)t[12 + k];
    return sb;
}

// the work counter of this unit's trace kernels (csrc/persist.cuh)
static __device__ WorkCounter trace_work;

// A persistent grid (csrc/persist.cuh): each lane runs one bounce per pass
// of its loop and, once its path has ended (bounce.inc's `break`, or the
// depth cap), writes L and stats at the path's index and takes the next
// path, whose state starts as a fresh path's. STAGE: the block first
// copies the tables of sb into shared memory (one cp.async.bulk each,
// completing on one mbarrier) and walks and shades from there.
template <bool K3, bool ALL, bool MED, bool BIN, bool CPT, bool STAGE>
__global__ void __launch_bounds__(128, MK_MIN_BLOCKS) trace_kernel(Pack pk, DepthCaps md, int nee_m,
                                                    const float* __restrict__ ray_o,
                                                    const float* __restrict__ ray_d,
                                                    const uint32_t* __restrict__ rng,
                                                    float* __restrict__ out_L,
                                                    int* __restrict__ stats, int B,
                                                    MedArgs ma, int n_warps, StageBytes sb) {
#ifdef __CUDA_ARCH__
    if constexpr (STAGE) {
        extern __shared__ __align__(128) unsigned char mk_stage[];
        const float* const src[STAGE_TABLES] = {pk.nodes, pk.prims, pk.attrs,
                                                pk.brows, pk.erow, pk.eprims};
        unsigned off[STAGE_TABLES + 1];
        stage_tables<STAGE_TABLES>(mk_stage, src, sb.n, off);
        pk.nodes = (const float*)(mk_stage + off[0]);
        pk.prims = (const float*)(mk_stage + off[1]);
        pk.attrs = (const float*)(mk_stage + off[2]);
        pk.brows = (const float*)(mk_stage + off[3]);
        pk.erow = (const float*)(mk_stage + off[4]);
        pk.eprims = (const float*)(mk_stage + off[5]);
    }
#endif
    const int lane = persist_lane();
    int i = B;          // the lane's path
    bool live = false;  // it holds a path
    bool dry = false;   // the counter has passed B (the same on every lane)
    int bounce = 0;
    V3 o = v3(0.0f, 0.0f, 0.0f), d = o, thp = o, L = o, texp = o;
    uint32_t sx = 0, sy = 0;
    float wl = 0.0f, prev_pdf = 1.0f;
    bool prev_delta = true;
    int n_diff = 0, n_spec = 0, n_trans = 0;
    WalkStats st{0, 0};
    int stk0 = -1, stk1 = -1, stk2 = -1, mtop = -1, n_vol = 0;
    while (true) {
        unsigned held = __ballot_sync(PERSIST_ALL, live);
        if (!dry && __popc(held) < K2_REFILL_BELOW) {
            int end;
            int j = persist_take(&trace_work, ~held & PERSIST_ALL, lane, end);
            dry = end >= B;
            if (!live) {
                i = j;
                live = i < B;
                if (live) {
                    // a fresh path: every per-path variable as at bounce 0
                    o = load3(ray_o + 3 * (size_t)i);
                    d = load3(ray_d + 3 * (size_t)i);
                    sx = rng[2 * (size_t)i];
                    sy = rng[2 * (size_t)i + 1];
                    thp = v3(1.0f, 1.0f, 1.0f);
                    L = v3(0.0f, 0.0f, 0.0f);
                    // K3 textured: the product of the diffuse texels so far;
                    // has_disp: the locked wavelength (0 = unset)
                    texp = v3(1.0f, 1.0f, 1.0f);
                    wl = 0.0f;
                    prev_pdf = 1.0f;
                    prev_delta = true;
                    n_diff = n_spec = n_trans = 0;
                    st = WalkStats{0, 0};
                    // K4: the medium stack (slots stk0..2, top index mtop, -1
                    // = empty) and the medium events so far
                    stk0 = stk1 = stk2 = mtop = -1;
                    n_vol = 0;
                    bounce = 0;
                }
            }
        }
        // the vote also brings the warp's lanes back together, so the
        // fresh lanes and the others run the bounce as one (without it
        // probe calls measured K2 at 1.71 against 0.87 ms: PERF.md)
        if (!__any_sync(PERSIST_ALL, live)) break;
        if (!live) continue;
        // one pass of the bounce loop: its `continue` (the path goes on)
        // and its end reach the increment, which sets on; its `break` does not
        bool on = false;
        if (bounce < md.max_depth) {
            for (bool once = true; once; once = false, on = true) {
#include "bounce.inc"
            }
            ++bounce;
        }
        if (!on || bounce >= md.max_depth) {
            out_L[3 * (size_t)i + 0] = L.x;
            out_L[3 * (size_t)i + 1] = L.y;
            out_L[3 * (size_t)i + 2] = L.z;
            if (stats != nullptr) {
                stats[2 * (size_t)i] = st.nodes;
                stats[2 * (size_t)i + 1] = st.prims;
            }
            live = false;
        }
    }
    persist_finish(&trace_work, n_warps, lane);
}

// The persistent launch of one instantiation: as many blocks as the card
// keeps resident (queried once, with the most shared memory a STAGE build
// takes), at most one per 128 paths; a refused query returns its error and
// launches nothing.
template <bool K3, bool ALL, bool MED, bool BIN, bool CPT, bool STAGE>
static int launch_grid(const Pack& pk, const DepthCaps& md, int nee_m, const float* ray_o,
                       const float* ray_d, const uint32_t* rng, float* out_L, int* stats, int B,
                       const MedArgs& ma, const StageBytes& sb, unsigned smem,
                       cudaStream_t stream) {
    static int resident = 0;
    int threads = 128;
    int blocks = 0;
    int rc = persist_blocks(trace_kernel<K3, ALL, MED, BIN, CPT, STAGE>, threads, B, &resident,
                            &blocks, STAGE ? MK_STAGE_BYTES : 0);
    if (rc != 0) return rc;
    int n_warps = blocks * (threads / PERSIST_WARP);
    trace_kernel<K3, ALL, MED, BIN, CPT, STAGE><<<blocks, threads, smem, stream>>>(
        pk, md, nee_m, ray_o, ray_d, rng, out_L, stats, B, ma, n_warps, sb);
    return 0;
}

// The STAGE build where the tables fit (stage_fit), else the plain one.
template <bool K3, bool ALL, bool MED, bool BIN = false, bool CPT = false>
static int launch_trace(const Pack& pk, const DepthCaps& md, int nee_m, const float* ray_o,
                        const float* ray_d, const uint32_t* rng, float* out_L, int* stats, int B,
                        const MedArgs& ma, const StageBytes& sb, cudaStream_t stream) {
    if constexpr (!BIN && !CPT) {
        unsigned smem = stage_fit(sb.n, STAGE_TABLES);
        if (smem > 0) {
            return launch_grid<K3, ALL, MED, BIN, CPT, true>(pk, md, nee_m, ray_o, ray_d, rng,
                                                             out_L, stats, B, ma, sb, smem,
                                                             stream);
        }
    }
    return launch_grid<K3, ALL, MED, BIN, CPT, false>(pk, md, nee_m, ray_o, ray_d, rng, out_L,
                                                      stats, B, ma, sb, 0, stream);
}

// The six instantiations (surface and MED) of one table build: the one
// that covers the pack's flags.
template <bool BIN, bool CPT>
static int launch_trace_fmt(bool k3, bool all, bool med, const Pack& pk, const DepthCaps& md,
                            int nee_m, const float* ray_o, const float* ray_d,
                            const uint32_t* rng, float* out_L, int* stats, int B,
                            const MedArgs& ma, cudaStream_t stream) {
    const StageBytes sb{};  // the BIN and CPT builds never stage
    if (med && k3) {
        return launch_trace<true, true, true, BIN, CPT>(pk, md, nee_m, ray_o, ray_d, rng, out_L,
                                                        stats, B, ma, sb, stream);
    } else if (med) {
        return launch_trace<false, true, true, BIN, CPT>(pk, md, nee_m, ray_o, ray_d, rng, out_L,
                                                         stats, B, ma, sb, stream);
    } else if (k3 && all) {
        return launch_trace<true, true, false, BIN, CPT>(pk, md, nee_m, ray_o, ray_d, rng, out_L,
                                                         stats, B, ma, sb, stream);
    } else if (k3) {
        return launch_trace<true, false, false, BIN, CPT>(pk, md, nee_m, ray_o, ray_d, rng, out_L,
                                                          stats, B, ma, sb, stream);
    } else if (all) {
        return launch_trace<false, true, false, BIN, CPT>(pk, md, nee_m, ray_o, ray_d, rng, out_L,
                                                          stats, B, ma, sb, stream);
    } else {
        return launch_trace<false, false, false, BIN, CPT>(pk, md, nee_m, ray_o, ray_d, rng,
                                                           out_L, stats, B, ma, sb, stream);
    }
}

// The instantiations (surface and MED) of a pack with binary nodes
// (megakernel_bin.cu: BIN, always with the Pack's prim and attr formats)
// and of a w8 pack with t9 prims or bf16 attrs (megakernel_cpt.cu: CPT).
int launch_trace_bin(bool k3, bool all, bool med, const Pack& pk, const DepthCaps& md, int nee_m,
                     const float* ray_o, const float* ray_d, const uint32_t* rng, float* out_L,
                     int* stats, int B, const MedArgs& ma, cudaStream_t stream);
int launch_trace_cpt(bool k3, bool all, bool med, const Pack& pk, const DepthCaps& md, int nee_m,
                     const float* ray_o, const float* ray_d, const uint32_t* rng, float* out_L,
                     int* stats, int B, const MedArgs& ma, cudaStream_t stream);
#endif  // MK_SEG
