// Whole-path megakernel: one thread traces one path through every bounce.
//
// Replaces the TPU kernel ops/pallas/megakernel.py::_kernel (:500) in its
// whole-path mode (trace_megakernel, :2963, pallas_call at :3083) with
// has_env, textured, has_disp and has_media all False, w8 nodes and f32
// attrs and prims. Per bounce, in the pcg draw order of
// models/path_tracer.pt_bounce: closest walk -> emitter-hit MIS -> NEE
// (power-pmf emitter pick, emitter-prim CDF, RIS over nee_m candidates,
// any-hit shadow walk) -> BSDF sample (lambertian / specular /
// translucent) -> per-lobe depth caps -> NaN guard -> RR
// clip(max_thp, 0.1, 1) after bounce 1.
//
// Bound on an H100: operations, not bytes. Each ray reads 36 B and writes
// 12 B, while its walks run tens of slab and triangle tests per bounce on
// a pack of a few KB that stays in L1/L2. The design therefore keeps all
// path state in registers, reads node / prim / material rows directly by
// index (no TPU-style masked field extraction or per-BSDF-id loops) and
// skips the shadow walk where its result cannot matter (invalid light
// sample or zero BSDF value). Divergence between neighbouring paths is the
// cost this first version accepts; the caller orders lanes in Z-order
// screen blocks so a warp starts coherent.
//
// Two C entry points, called through ctypes (ops/megakernel.py):
//   mk_trace        -> L (B, 3) for rays (B, 3) x 2 and pcg states (B, 2)
//   mk_closest_hit  -> (t, prim, b1, b2) of the same closest walk alone
// Both return cudaGetLastError() right after the launch.

#include "bsdf.cuh"
#include "common.cuh"
#include "nee.cuh"
#include "pcg.cuh"
#include "walk.cuh"

struct DepthCaps {
    int max_depth;
    int max_diffuse;
    int max_specular;
    int max_transmit;
};

__global__ void __launch_bounds__(128) trace_kernel(Pack pk, DepthCaps md, int nee_m,
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
    float prev_pdf = 1.0f;
    bool prev_delta = true;
    int n_diff = 0, n_spec = 0, n_trans = 0;
    WalkStats st{0, 0};

    for (int bounce = 0; bounce < md.max_depth; ++bounce) {
        ClosestHit h = walk_closest(pk, o, d, st);
        if (h.prim < 0) break;  // miss: no environment in this envelope

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
        Material m = load_material(pk, (int)at[11]);

        // ---- emitter-hit MIS --------------------------------------------
        float cos_l = -dot(d, ng);
        if (eid_hit > 0 && cos_l > 1e-6f) {
            const float* er = pk.erow + eid_hit * SLOT_F;
            V3 le = load3(er + 1);
            float pdf_l = er[7] * inva * (t * t) / cos_l;  // cos_l > 1e-6 here
            float w_hit = prev_delta ? 1.0f : power_heuristic(prev_pdf, pdf_l);
            L = add(L, scale(mul(thp, le), w_hit));
        }

        // ---- shading frame: nl = ns flipped toward wo ---------------------
        V3 wo = neg(d);
        float s = signf(dot(ns, wo));
        if (s == 0.0f) s = 1.0f;
        V3 nl = scale(ns, s);

        // ---- NEE: one candidate, or RIS over nee_m -------------------------
        NeeCand c = nee_one(pk, m, p, nl, sx, sy);
        float inv_density;
        if (nee_m <= 1) {
            inv_density = 1.0f / fmaxf(c.pdf, 1e-12f);
        } else {
            float w0 = (c.valid && c.phat > 0.0f) ? c.phat / fmaxf(c.pdf, 1e-12f) : 0.0f;
            float wsum = w0;
            pcg2d(sx, sy);  // the reservoir draw of candidate 0 (unused)
            for (int k = 1; k < nee_m; ++k) {
                NeeCand ck = nee_one(pk, m, p, nl, sx, sy);
                float wk = (ck.valid && ck.phat > 0.0f) ? ck.phat / fmaxf(ck.pdf, 1e-12f) : 0.0f;
                wsum = wsum + wk;
                pcg2d(sx, sy);
                float u_r = u01(sx);
                if ((u_r * wsum <= wk) && (wk > 0.0f)) c = ck;
            }
            inv_density = wsum / ((float)nee_m * fmaxf(c.phat, 1e-12f));
        }
        float f_max = fmaxf(fmaxf(c.f.x, c.f.y), c.f.z);
        if (c.valid && f_max > 0.0f) {
            float gdir = dot(ng, c.dir);
            V3 p_sh = add(p, scale(scale(ng, signf(gdir)), RAY_OFFSET));
            float dist_sh = c.dist - fabsf(gdir) * RAY_OFFSET;
            if (!walk_anyhit(pk, p_sh, c.dir, dist_sh, st)) {
                bool last_bounce = bounce >= md.max_depth - 1;
                float w_nee = (c.delta || last_bounce) ? 1.0f : power_heuristic(c.pdf, c.bpdf);
                L = add(L, scale(mul(mul(thp, c.f), c.le), w_nee * inv_density));
            }
        }

        // ---- BSDF sample (u_dir, u_lobe, u_wl: three advances) --------------
        pcg2d(sx, sy);
        float u0 = u01(sx), u1 = u01(sy);
        pcg2d(sx, sy);
        float u_lobe = u01(sx);
        pcg2d(sx, sy);  // u_wl, consumed by the dispersion family only
        BsdfSample bs = sample_bsdf(m, d, ns, nl, u0, u1, u_lobe);
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

        // ---- Russian roulette after bounce 1 ----------------------------------
        float max_thp = fmaxf(fmaxf(thp.x, thp.y), thp.z);
        pcg2d(sx, sy);
        float u_rr = u01(sx);
        float p_surv = bounce >= 1 ? clampf(max_thp, 0.1f, 1.0f) : 1.0f;
        thp = v3(thp.x / p_surv, thp.y / p_surv, thp.z / p_surv);
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

static Pack make_pack_view(const float* nodes, const float* prims, const float* attrs,
                           const float* erow, const float* eprims, const float* brows,
                           int max_leaf, int tri_only) {
    Pack pk;
    pk.nodes = nodes;
    pk.prims = prims;
    pk.attrs = attrs;
    pk.erow = erow;
    pk.eprims = eprims;
    pk.brows = brows;
    pk.max_leaf = max_leaf;
    pk.tri_only = tri_only;
    return pk;
}

extern "C" int mk_trace(const float* nodes, const float* prims, const float* attrs,
                        const float* erow, const float* eprims, const float* brows,
                        const float* ray_o, const float* ray_d, const uint32_t* rng,
                        float* out_L, int* stats, int B, int max_leaf, int tri_only,
                        int max_depth, int max_diffuse, int max_specular,
                        int max_transmit, int nee_m, void* stream) {
    Pack pk = make_pack_view(nodes, prims, attrs, erow, eprims, brows, max_leaf, tri_only);
    DepthCaps md{max_depth, max_diffuse, max_specular, max_transmit};
    int threads = 128;
    int blocks = (B + threads - 1) / threads;
    if (B > 0) {
        trace_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(pk, md, nee_m, ray_o, ray_d,
                                                                   rng, out_L, stats, B);
    }
    return (int)cudaGetLastError();
}

extern "C" int mk_closest_hit(const float* nodes, const float* prims, const float* attrs,
                              const float* erow, const float* eprims, const float* brows,
                              const float* ray_o, const float* ray_d, float* out_t,
                              int* out_prim, float* out_b1, float* out_b2, int B,
                              int max_leaf, int tri_only, void* stream) {
    Pack pk = make_pack_view(nodes, prims, attrs, erow, eprims, brows, max_leaf, tri_only);
    int threads = 128;
    int blocks = (B + threads - 1) / threads;
    if (B > 0) {
        closest_hit_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
            pk, ray_o, ray_d, out_t, out_prim, out_b1, out_b2, B);
    }
    return (int)cudaGetLastError();
}
