// The trace kernel template and its launcher (csrc/megakernel.cu
// describes the kernel), included by the two translation units that
// instantiate it: megakernel.cu (the surface instantiations, K2 and K3)
// and megakernel_med.cu (kernel K4's MED instantiations). Each unit is its
// own device module, so the K4 code does not reach the surface kernels'
// module.
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

template <bool K3, bool ALL, bool MED>
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
        ClosestHit h = walk_closest(pk, o, d, st);
        int cur_med = -1;  // K4: the medium this segment runs through
        // The K4 blocks are compiled only into the MED instantiations (if
        // constexpr), so the surface ones build from the K2 / K3 code alone.
        if constexpr (MED) {
            // ---- K4: free flight through the current medium ----------------
            cur_med = mtop >= 2 ? stk2 : (mtop >= 1 ? stk1 : (mtop >= 0 ? stk0 : ma.ambient_med));
            pcg2d(sx, sy);  // (channel, distance), drawn in vacuum too
            bool med_event = false;
            float t_med = 0.0f;
            if (cur_med >= 0) {
                float u_ch = u01(sx), u_t = u01(sy);
                Medium mm = load_medium(ma, cur_med);
                float st_c = u_ch >= (2.0f / 3.0f) ? mm.st.z
                                                   : (u_ch >= (1.0f / 3.0f) ? mm.st.y : mm.st.x);
                t_med = -logf(fmaxf(1.0f - u_t, 1e-12f)) / fmaxf(st_c, 1e-8f);
                float t_surf = h.prim >= 0 ? h.t : 1e8f;
                med_event = t_med < t_surf;
                float t_ev = med_event ? t_med : t_surf;
                V3 e = v3(expf(-mm.st.x * t_ev), expf(-mm.st.y * t_ev), expf(-mm.st.z * t_ev));
                // channel-MIS weight of the event drawn
                if (med_event) {
                    float pdf_m = fmaxf((mm.st.x * e.x + mm.st.y * e.y + mm.st.z * e.z) / 3.0f, 1e-12f);
                    thp = mul(thp, v3(mm.ss.x * e.x / pdf_m, mm.ss.y * e.y / pdf_m, mm.ss.z * e.z / pdf_m));
                } else {
                    float pdf_s = fmaxf((e.x + e.y + e.z) / 3.0f, 1e-12f);
                    thp = mul(thp, v3(e.x / pdf_s, e.y / pdf_s, e.z / pdf_s));
                }
            }
            if (med_event) {
                // ---- K4: a scattering event in the medium --------------------
                V3 p = add(o, scale(d, t_med));
                Medium mm = load_medium(ma, cur_med);
                // the light sample alone (no surface, no BSDF)
                NeeCand c = nee_one<ALL, false>(pk, Material{}, Shading{}, p, sx, sy);
                float pv = phase_value(mm, dot(d, c.dir));
                bool need = c.valid && pv > 0.0f;
                bool last_bounce = bounce >= md.max_depth - 1;
                float w_nee = (c.delta || last_bounce) ? 1.0f : power_heuristic(c.pdf, pv);
                V3 cn = scale(mul(scale(thp, pv), c.le), w_nee * (1.0f / fmaxf(c.pdf, 1e-12f)));
                V3 l_dir = c.dir;
                float l_dist = c.dist;
                // phase sample (two advances); the BSDF sample's three
                // advances are drawn and unused
                pcg2d(sx, sy);
                float up0 = u01(sx), up1 = u01(sy);
                pcg2d(sx, sy);
                float pdf_ph;
                V3 d_new = phase_sample(mm, d, up0, up1, u01(sx), pdf_ph);
                pcg2d(sx, sy);
                pcg2d(sx, sy);
                pcg2d(sx, sy);
                thp.x = isfinite(thp.x) ? thp.x : 0.0f;  // NaN guard
                thp.y = isfinite(thp.y) ? thp.y : 0.0f;
                thp.z = isfinite(thp.z) ? thp.z : 0.0f;
                n_vol += 1;
                float max_thp = max3(thp);
                pcg2d(sx, sy);
                float u_rr = u01(sx);
                float p_surv = bounce >= 1 ? clampf(max_thp, 0.1f, 1.0f) : 1.0f;
                thp = v3(thp.x / p_surv, thp.y / p_surv, thp.z / p_surv);
                if (need) L = add(L, mul(cn, walk_transmittance(pk, ma, p, l_dir, l_dist, cur_med, st)));
                if (!(n_vol <= ma.max_volume && u_rr < p_surv && max_thp > 0.0f)) break;
                prev_pdf = pdf_ph;
                prev_delta = false;
                o = p;
                d = d_new;
                continue;
            }
        }
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
        if constexpr (MED) {  // K4: the phase sample's two advances, unused here
            pcg2d(sx, sy);
            pcg2d(sx, sy);
        }

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

        // ---- K4: the medium stack on transmission (object-identity toggle)
        if constexpr (MED) {
            int med_obj = (int)at[12];
            if (bs.lobe == LOBE_TRANSMIT && med_obj >= 0) {
                if (cur_med == med_obj) {
                    mtop = max(mtop - 1, -1);
                } else {
                    mtop = min(mtop + 1, 2);
                    if (mtop == 0) stk0 = med_obj;
                    else if (mtop == 1) stk1 = med_obj;
                    else stk2 = med_obj;
                }
            }
        }

        // ---- Russian roulette draw after bounce 1 --------------------------
        float max_thp = max3(thp);
        pcg2d(sx, sy);
        float u_rr = u01(sx);
        float p_surv = bounce >= 1 ? clampf(max_thp, 0.1f, 1.0f) : 1.0f;
        thp = v3(thp.x / p_surv, thp.y / p_surv, thp.z / p_surv);

        // ---- shadow walk of the NEE sample (K4: its transmittance) ------------
        if constexpr (MED) {
            if (need) L = add(L, mul(cn, walk_transmittance(pk, ma, p_sh, l_dir, dist_sh, cur_med, st)));
        } else {
            if (need && !walk_anyhit(pk, p_sh, l_dir, dist_sh, st)) L = add(L, cn);
        }

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

template <bool K3, bool ALL, bool MED>
static void launch_trace(const Pack& pk, const DepthCaps& md, int nee_m, const float* ray_o,
                         const float* ray_d, const uint32_t* rng, float* out_L, int* stats, int B,
                         const MedArgs& ma, cudaStream_t stream) {
    int threads = 128;
    int blocks = (B + threads - 1) / threads;
    trace_kernel<K3, ALL, MED><<<blocks, threads, 0, stream>>>(pk, md, nee_m, ray_o, ray_d, rng,
                                                               out_L, stats, B, ma);
}
