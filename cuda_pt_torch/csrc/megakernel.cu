// Whole-path megakernel: one thread traces one path through every bounce.
//
// Replaces the TPU kernel ops/pallas/megakernel.py::_kernel (:500) in its
// whole-path mode (trace_megakernel, :2963, pallas_call at :3083) for the
// surface envelope of that kernel: nine BSDF families, area / area-spot /
// point emitters, and the K3 flags has_env, textured and has_disp (w8
// nodes, f32 attrs and prims, no media). Per bounce, in the pcg draw order
// of models/path_tracer.pt_bounce: closest walk -> [env miss] ->
// emitter-hit MIS -> NEE (power-pmf emitter pick, emitter-prim CDF, RIS
// over nee_m candidates, any-hit shadow walk) -> BSDF sample -> per-lobe
// depth caps -> NaN guard -> RR clip(max_thp, 0.1, 1) after bounce 1.
//
// K3 computes the TPU kernel's estimator, not the composed one:
//   has_env   a miss adds thp * Le(d) with MIS weight 1; the envmap is
//             never NEE-sampled (the TPU kernel recorded the miss and left
//             the lookup to its epilogue _env_radiance, :3643; here the
//             thread reads the texels at the miss);
//   textured  the BSDF traces with the base kd, so RR sees the untextured
//             throughput; the diffuse texels ride in a running product
//             (texp) applied to each contribution as it is added (the TPU
//             kernel's per-bounce groups and prefix products, :3108-3142);
//   has_disp  the wavelength locks at a path's first dispersive event from
//             the bounce's third BSDF draw; Cauchy IoR and CIE tint.
// Two template flags prune code at compile time: K3 (any of the three
// flags set) and ALL (a family beyond Lambertian / Specular / Translucent
// present); a scene runs the smallest of the four instantiations that
// covers it.
//
// Bound on an H100: operations, not bytes. Each ray reads 36 B and writes
// 12 B, while its walks run tens of slab and triangle tests per bounce on
// a pack that stays in L2 (kitchen_stress: 23 MB with uvs and texels,
// inside the 50 MB L2). The walks wait on dependent loads, so the kernel
// is built for 8 resident blocks per SM (MK_MIN_BLOCKS): 64 registers,
// the rest of the path state spills to L1-cached local memory, which
// costs less than the lost warps. It reads node / prim / material rows
// directly by index (no TPU-style masked field extraction or per-BSDF-id
// loops), branches per thread to its own BSDF family, and skips the
// shadow walk where its result cannot matter (invalid light sample or
// zero BSDF value). Divergence between neighbouring paths is the cost
// this version accepts; the caller orders lanes in Z-order screen blocks
// so a warp starts coherent.
//
// Two C entry points, called through ctypes (ops/megakernel.py):
//   mk_trace        -> L (B, 3) for rays (B, 3) x 2 and pcg states (B, 2)
//   mk_closest_hit  -> (t, prim, b1, b2) of the same closest walk alone
// Both return cudaGetLastError() right after the launch.

#include "bsdf.cuh"
#include "common.cuh"
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
__constant__ float kXyzLobes[7][4] = {SPEC_LOBE_ROW(0), SPEC_LOBE_ROW(1), SPEC_LOBE_ROW(2),
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

template <bool K3, bool ALL>
__global__ void __launch_bounds__(128, MK_MIN_BLOCKS) trace_kernel(Pack pk, DepthCaps md, int nee_m,
                                                    const float* __restrict__ ray_o,
                                                    const float* __restrict__ ray_d,
                                                    const uint32_t* __restrict__ rng,
                                                    float* __restrict__ out_L,
                                                    int* __restrict__ stats, int B) {
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

    for (int bounce = 0; bounce < md.max_depth; ++bounce) {
        ClosestHit h = walk_closest(pk, o, d, st);
        if (h.prim < 0) {
            if (K3 && pk.has_env) L = add(L, mul(mul(texp, thp), env_radiance(pk, d)));
            break;
        }

        // ---- surface interaction (ops/intersect.surface_interaction) ----
        float t = h.t;
        V3 p = add(o, scale(d, t));
        const float* pr = pk.prims + (size_t)h.prim * SLOT_F;
        const float* at = pk.attrs + (size_t)h.prim * SLOT_F;
        V3 e1 = load3(pr + 3);
        V3 ns, ng;
        if (!pk.tri_only && pr[9] > 0.0f) {
            float r = fmaxf(e1.x, 1e-8f);
            V3 rel = sub(p, load3(pr + 0));
            ns = normalize(v3(rel.x / r, rel.y / r, rel.z / r));
            ng = ns;
        } else {
            float w = 1.0f - h.b1 - h.b2;
            V3 n0 = load3(at + 0), n1 = load3(at + 3), n2 = load3(at + 6);
            ns = normalize(add(add(scale(n0, w), scale(n1, h.b1)), scale(n2, h.b2)));
            ng = normalize(cross(e1, load3(pr + 6)));
            if (dot(ng, ns) < 0.0f) ng = neg(ng);
        }
        int eid_hit = (int)at[9];
        float inva = at[10];
        int bid = (int)at[11];
        Material m = load_material<ALL>(pk, bid);

        // ---- emitter-hit MIS (area-spot: zero outside the cone) ----------
        float cos_l = -dot(d, ng);
        if (eid_hit > 0 && cos_l > 1e-6f) {
            const float* er = pk.erow + eid_hit * SLOT_F;
            if (cos_l >= er[10]) {
                V3 le = load3(er + 1);
                float pdf_l = er[7] * inva * (t * t) / cos_l;  // cos_l > 1e-6 here
                float w_hit = prev_delta ? 1.0f : power_heuristic(prev_pdf, pdf_l);
                V3 c = scale(mul(thp, le), w_hit);
                L = add(L, K3 ? mul(texp, c) : c);
            }
        }

        // ---- shading frame and this hit's diffuse texel ----------------------
        Shading sh = make_shading(d, ns);
        if (K3 && pk.textured) texp = mul(texp, diffuse_texel(pk, bid, h.prim, h.b1, h.b2));

        // ---- NEE: one candidate, or RIS over nee_m -------------------------
        NeeCand c = nee_one<ALL>(pk, m, sh, p, sx, sy);
        float inv_density;
        if (nee_m <= 1) {
            inv_density = 1.0f / fmaxf(c.pdf, 1e-12f);
        } else {
            float w0 = (c.valid && c.phat > 0.0f) ? c.phat / fmaxf(c.pdf, 1e-12f) : 0.0f;
            float wsum = w0;
            pcg2d(sx, sy);  // the reservoir draw of candidate 0 (unused)
            for (int k = 1; k < nee_m; ++k) {
                NeeCand ck = nee_one<ALL>(pk, m, sh, p, sx, sy);
                float wk = (ck.valid && ck.phat > 0.0f) ? ck.phat / fmaxf(ck.pdf, 1e-12f) : 0.0f;
                wsum = wsum + wk;
                pcg2d(sx, sy);
                float u_r = u01(sx);
                if ((u_r * wsum <= wk) && (wk > 0.0f)) c = ck;
            }
            inv_density = wsum / ((float)nee_m * fmaxf(c.phat, 1e-12f));
        }
        // the NEE contribution if the light is visible; the shadow walk runs
        // after the BSDF sample (it draws nothing), so the material and the
        // shading frame are dead across it
        bool need = c.valid && max3(c.f) > 0.0f;
        float gdir = dot(ng, c.dir);
        V3 p_sh = add(p, scale(scale(ng, signf(gdir)), RAY_OFFSET));
        float dist_sh = c.dist - fabsf(gdir) * RAY_OFFSET;
        bool last_bounce = bounce >= md.max_depth - 1;
        float w_nee = (c.delta || last_bounce) ? 1.0f : power_heuristic(c.pdf, c.bpdf);
        V3 cn = scale(mul(mul(thp, c.f), c.le), w_nee * inv_density);
        if (K3) cn = mul(texp, cn);
        V3 l_dir = c.dir;

        // ---- BSDF sample (u_dir, u_lobe, u_wl: three advances) --------------
        pcg2d(sx, sy);
        float u0 = u01(sx), u1 = u01(sy);
        pcg2d(sx, sy);
        float u_lobe = u01(sx);
        pcg2d(sx, sy);  // u_wl, consumed by the dispersion family only
        float ior_t = m.ior;
        V3 tint = v3(1.0f, 1.0f, 1.0f);
        if (K3 && ALL && pk.has_disp && m.btype == BSDF_DISPERSION) {
            bool first = wl <= 0.0f;
            float wl_use = first ? SPEC_WL_MIN + u01(sx) * (SPEC_WL_MAX - SPEC_WL_MIN) : wl;
            float wl_um = wl_use * 1e-3f;
            ior_t = m.cauchy_a + m.cauchy_b / fmaxf(wl_um * wl_um, 1e-6f);
            if (first) tint = wavelength_to_rgb(wl_use);
            wl = wl_use;
        }
        BsdfSample bs = sample_bsdf<ALL>(m, sh, d, u0, u1, u_lobe, ior_t, tint);
        thp = mul(thp, bs.weight);
        thp.x = isfinite(thp.x) ? thp.x : 0.0f;  // NaN guard
        thp.y = isfinite(thp.y) ? thp.y : 0.0f;
        thp.z = isfinite(thp.z) ? thp.z : 0.0f;
        V3 o_new = add(p, scale(scale(ng, signf(dot(ng, bs.wi))), RAY_OFFSET));

        // ---- per-lobe depth caps -------------------------------------------
        n_diff += bs.lobe == LOBE_DIFFUSE ? 1 : 0;
        n_spec += bs.lobe == LOBE_SPECULAR ? 1 : 0;
        n_trans += bs.lobe == LOBE_TRANSMIT ? 1 : 0;
        bool depth_ok = n_diff <= md.max_diffuse && n_spec <= md.max_specular
                        && n_trans <= md.max_transmit;

        // ---- Russian roulette draw after bounce 1 --------------------------
        float max_thp = max3(thp);
        pcg2d(sx, sy);
        float u_rr = u01(sx);
        float p_surv = bounce >= 1 ? clampf(max_thp, 0.1f, 1.0f) : 1.0f;
        thp = v3(thp.x / p_surv, thp.y / p_surv, thp.z / p_surv);

        // ---- shadow walk of the NEE sample ------------------------------------
        if (need && !walk_anyhit(pk, p_sh, l_dir, dist_sh, st)) L = add(L, cn);

        if (!(depth_ok && u_rr < p_surv && max_thp > 0.0f)) break;
        prev_pdf = bs.pdf;
        prev_delta = bs.is_delta;
        o = o_new;
        d = bs.wi;
    }
    out_L[3 * (size_t)i + 0] = L.x;
    out_L[3 * (size_t)i + 1] = L.y;
    out_L[3 * (size_t)i + 2] = L.z;
    if (stats != nullptr) {
        stats[2 * (size_t)i] = st.nodes;
        stats[2 * (size_t)i + 1] = st.prims;
    }
}

__global__ void __launch_bounds__(128) closest_hit_kernel(Pack pk,
                                                          const float* __restrict__ ray_o,
                                                          const float* __restrict__ ray_d,
                                                          float* __restrict__ out_t,
                                                          int* __restrict__ out_prim,
                                                          float* __restrict__ out_b1,
                                                          float* __restrict__ out_b2, int B) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= B) return;
    WalkStats st{0, 0};
    ClosestHit h = walk_closest(pk, load3(ray_o + 3 * (size_t)i), load3(ray_d + 3 * (size_t)i), st);
    out_t[i] = h.t;
    out_prim[i] = h.prim;
    out_b1[i] = h.b1;
    out_b2[i] = h.b2;
}

// The pack's tables in ops/megakernel.PACK_KEYS + K3_KEYS order.
static Pack make_pack_view(const void* const* t, int max_leaf, int tri_only, int has_env,
                           int textured, int has_disp) {
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
    pk.has_env = has_env;
    pk.textured = textured;
    pk.has_disp = has_disp;
    return pk;
}

template <bool K3, bool ALL>
static void launch_trace(const Pack& pk, const DepthCaps& md, int nee_m, const float* ray_o,
                         const float* ray_d, const uint32_t* rng, float* out_L, int* stats, int B,
                         cudaStream_t stream) {
    int threads = 128;
    int blocks = (B + threads - 1) / threads;
    trace_kernel<K3, ALL><<<blocks, threads, 0, stream>>>(pk, md, nee_m, ray_o, ray_d, rng, out_L,
                                                          stats, B);
}

extern "C" int mk_trace(const void* const* tables, const float* ray_o, const float* ray_d,
                        const uint32_t* rng, float* out_L, int* stats, int B, int max_leaf,
                        int tri_only, int has_env, int textured, int has_disp, int all_families,
                        int max_depth, int max_diffuse, int max_specular, int max_transmit,
                        int nee_m, void* stream) {
    Pack pk = make_pack_view(tables, max_leaf, tri_only, has_env, textured, has_disp);
    DepthCaps md{max_depth, max_diffuse, max_specular, max_transmit};
    cudaStream_t st = (cudaStream_t)stream;
    bool k3 = has_env || textured || has_disp;
    if (B > 0) {
        if (k3 && all_families) {
            launch_trace<true, true>(pk, md, nee_m, ray_o, ray_d, rng, out_L, stats, B, st);
        } else if (k3) {
            launch_trace<true, false>(pk, md, nee_m, ray_o, ray_d, rng, out_L, stats, B, st);
        } else if (all_families) {
            launch_trace<false, true>(pk, md, nee_m, ray_o, ray_d, rng, out_L, stats, B, st);
        } else {
            launch_trace<false, false>(pk, md, nee_m, ray_o, ray_d, rng, out_L, stats, B, st);
        }
    }
    return (int)cudaGetLastError();
}

extern "C" int mk_closest_hit(const void* const* tables, const float* ray_o, const float* ray_d,
                              float* out_t, int* out_prim, float* out_b1, float* out_b2, int B,
                              int max_leaf, int tri_only, void* stream) {
    Pack pk = make_pack_view(tables, max_leaf, tri_only, 0, 0, 0);
    int threads = 128;
    int blocks = (B + threads - 1) / threads;
    if (B > 0) {
        closest_hit_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
            pk, ray_o, ray_d, out_t, out_prim, out_b1, out_b2, B);
    }
    return (int)cudaGetLastError();
}
