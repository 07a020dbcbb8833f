// Next-event estimation for area and point emitters (emitters/emitters.py
// sample_emitter; the TPU kernel's nee_one, megakernel.py:1697). One
// candidate consumes three pcg advances (u_sel, u_prim, u_pos) in the
// order of pt_bounce, whether or not the candidate is used.
#pragma once

#include "bsdf.cuh"
#include "pcg.cuh"

struct NeeCand {
    V3 dir;
    float dist;
    V3 le;
    float pdf;
    bool valid;
    bool delta;
    V3 f;       // f * |cos| toward dir
    float bpdf; // BSDF pdf toward dir
    float phat; // luminance(f * le), the RIS target
};

__device__ __forceinline__ NeeCand nee_one(const Pack& pk, const Material& m, V3 p, V3 nl,
                                           uint32_t& sx, uint32_t& sy) {
    pcg2d(sx, sy);
    float u_sel = u01(sx);
    pcg2d(sx, sy);
    float u_prim = u01(sx);
    pcg2d(sx, sy);
    float u_pos0 = u01(sx);
    float u_pos1 = u01(sy);

    // power-pmf emitter pick over the sel_cdf (slot 0 = null, padding
    // slots carry cdf 1.0 and are never counted)
    int eid = 0;
    for (int i = 0; i < MAX_EMITTERS; ++i) eid += (pk.erow[i * SLOT_F + 8] < u_sel) ? 1 : 0;
    eid = min(max(eid, 1), MAX_EMITTERS - 1);
    const float* er = pk.erow + eid * SLOT_F;
    int etype = (int)er[0];
    V3 em = load3(er + 1);
    float sel_pdf = fmaxf(er[7], 1e-12f);

    NeeCand c;
    if (etype == EMITTER_POINT) {
        V3 to_p = sub(load3(er + 4), p);
        float dist_p = length(to_p);
        float inv = fmaxf(dist_p, 1e-8f);
        c.dir = v3(to_p.x / inv, to_p.y / inv, to_p.z / inv);
        c.dist = dist_p;
        float r2 = fmaxf(dist_p * dist_p, 1e-8f);
        c.le = v3(em.x / r2, em.y / r2, em.z / r2);
        c.pdf = 1.0f * sel_pdf;
        c.valid = true;
        c.delta = true;
    } else {
        // area: prim by the emitter's area CDF, point by the sqrt warp.
        // make_pack stores the kmax+1 CDF rows of each area emitter one after
        // another, in emitter order, so this emitter's rows start after those
        // of the area emitters before it.
        V3 p0 = v3(0.0f, 0.0f, 0.0f), e1 = p0, e2 = p0;
        float inv_area = 0.0f;
        if (etype == EMITTER_AREA || etype == EMITTER_AREA_SPOT) {
            int kmax = (int)er[9];
            int base = 0;
            for (int i = 1; i < eid; ++i) {
                int et = (int)pk.erow[i * SLOT_F];
                if (et == EMITTER_AREA || et == EMITTER_AREA_SPOT) base += (int)pk.erow[i * SLOT_F + 9] + 1;
            }
            // kidx = #{k : cdf[k] < u_prim}, by binary search on the
            // non-decreasing CDF, clamped to kmax like the plain version
            const float* rows = pk.eprims + (size_t)base * SLOT_F;
            int lo = 0, hi = kmax + 1;
            while (lo < hi) {
                int mid = (lo + hi) >> 1;
                if (rows[mid * SLOT_F + 9] < u_prim) lo = mid + 1;
                else hi = mid;
            }
            const float* sl = rows + (size_t)min(lo, kmax) * SLOT_F;
            p0 = load3(sl + 0);
            e1 = load3(sl + 3);
            e2 = load3(sl + 6);
            inv_area = sl[12];
        }
        float su = sqrtf(fmaxf(u_pos0, 0.0f));
        float b1 = 1.0f - su;
        float b2 = u_pos1 * su;
        V3 pos = add(add(p0, scale(e1, b1)), scale(e2, b2));
        V3 nlight = normalize(cross(e1, e2));
        V3 to_l = sub(pos, p);
        float dist = length(to_l);
        float dd = fmaxf(dist, 1e-8f);
        c.dir = v3(to_l.x / dd, to_l.y / dd, to_l.z / dd);
        c.dist = dist;
        float cos_l = -dot(c.dir, nlight);
        c.pdf = sel_pdf * inv_area * (dist * dist) / fmaxf(cos_l, 1e-6f);
        c.le = em;
        c.valid = (cos_l > 1e-6f) && (etype == EMITTER_AREA);
        c.delta = false;
    }
    c.valid = c.valid && (fmaxf(fmaxf(c.le.x, c.le.y), c.le.z) > 0.0f) && (c.pdf > 1e-12f);
    c.f = eval_bsdf(m, nl, c.dir, c.bpdf);
    c.phat = 0.212671f * (c.f.x * c.le.x) + 0.715160f * (c.f.y * c.le.y)
           + 0.072169f * (c.f.z * c.le.z);
    return c;
}
