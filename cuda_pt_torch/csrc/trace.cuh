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
template <bool K3, bool ALL, bool MED, bool BIN, bool CPT>
__global__ void __launch_bounds__(128, MK_MIN_BLOCKS) trace_kernel(Pack pk, DepthCaps md, int nee_m,
                                                    const float* __restrict__ ray_o,
                                                    const float* __restrict__ ray_d,
                                                    const uint32_t* __restrict__ rng,
                                                    float* __restrict__ out_L,
                                                    int* __restrict__ stats, int B,
                                                    MedArgs ma) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= B) return;
    V3 o = load3(ray_o + 3 * (size_t)i);
    V3 d = load3(ray_d + 3 * (size_t)i);
    uint32_t sx = rng[2 * (size_t)i];
    uint32_t sy = rng[2 * (size_t)i + 1];
    V3 thp = v3(1.0f, 1.0f, 1.0f);
    V3 L = v3(0.0f, 0.0f, 0.0f);
    V3 texp = v3(1.0f, 1.0f, 1.0f);  // K3 textured: product of the diffuse texels so far
    float wl = 0.0f;                 // K3 has_disp: locked wavelength (0 = unset)
    float prev_pdf = 1.0f;
    bool prev_delta = true;
    int n_diff = 0, n_spec = 0, n_trans = 0;
    WalkStats st{0, 0};
    // K4: the medium stack (slots stk0..2, top index mtop, -1 = empty) and
    // the medium events so far
    int stk0 = -1, stk1 = -1, stk2 = -1, mtop = -1, n_vol = 0;

    for (int bounce = 0; bounce < md.max_depth; ++bounce) {
#include "bounce.inc"
    }
    out_L[3 * (size_t)i + 0] = L.x;
    out_L[3 * (size_t)i + 1] = L.y;
    out_L[3 * (size_t)i + 2] = L.z;
    if (stats != nullptr) {
        stats[2 * (size_t)i] = st.nodes;
        stats[2 * (size_t)i + 1] = st.prims;
    }
}

template <bool K3, bool ALL, bool MED, bool BIN = false, bool CPT = false>
static void launch_trace(const Pack& pk, const DepthCaps& md, int nee_m, const float* ray_o,
                         const float* ray_d, const uint32_t* rng, float* out_L, int* stats, int B,
                         const MedArgs& ma, cudaStream_t stream) {
    int threads = 128;
    int blocks = (B + threads - 1) / threads;
    trace_kernel<K3, ALL, MED, BIN, CPT><<<blocks, threads, 0, stream>>>(
        pk, md, nee_m, ray_o, ray_d, rng, out_L, stats, B, ma);
}

// The six instantiations (surface and MED) of one table build: the one
// that covers the pack's flags.
template <bool BIN, bool CPT>
static void launch_trace_fmt(bool k3, bool all, bool med, const Pack& pk, const DepthCaps& md,
                             int nee_m, const float* ray_o, const float* ray_d,
                             const uint32_t* rng, float* out_L, int* stats, int B,
                             const MedArgs& ma, cudaStream_t stream) {
    if (med && k3) {
        launch_trace<true, true, true, BIN, CPT>(pk, md, nee_m, ray_o, ray_d, rng, out_L, stats,
                                                 B, ma, stream);
    } else if (med) {
        launch_trace<false, true, true, BIN, CPT>(pk, md, nee_m, ray_o, ray_d, rng, out_L, stats,
                                                  B, ma, stream);
    } else if (k3 && all) {
        launch_trace<true, true, false, BIN, CPT>(pk, md, nee_m, ray_o, ray_d, rng, out_L, stats,
                                                  B, ma, stream);
    } else if (k3) {
        launch_trace<true, false, false, BIN, CPT>(pk, md, nee_m, ray_o, ray_d, rng, out_L, stats,
                                                   B, ma, stream);
    } else if (all) {
        launch_trace<false, true, false, BIN, CPT>(pk, md, nee_m, ray_o, ray_d, rng, out_L, stats,
                                                   B, ma, stream);
    } else {
        launch_trace<false, false, false, BIN, CPT>(pk, md, nee_m, ray_o, ray_d, rng, out_L,
                                                    stats, B, ma, stream);
    }
}

// The instantiations (surface and MED) of a pack with binary nodes
// (megakernel_bin.cu: BIN, always with the Pack's prim and attr formats)
// and of a w8 pack with t9 prims or bf16 attrs (megakernel_cpt.cu: CPT).
void launch_trace_bin(bool k3, bool all, bool med, const Pack& pk, const DepthCaps& md, int nee_m,
                      const float* ray_o, const float* ray_d, const uint32_t* rng, float* out_L,
                      int* stats, int B, const MedArgs& ma, cudaStream_t stream);
void launch_trace_cpt(bool k3, bool all, bool med, const Pack& pk, const DepthCaps& md, int nee_m,
                      const float* ray_o, const float* ray_d, const uint32_t* rng, float* out_L,
                      int* stats, int B, const MedArgs& ma, cudaStream_t stream);
#endif  // MK_SEG
