// Homogeneous participating media for kernel K4, the fused volume path
// tracer (the TPU kernel's has_media code, ops/pallas/megakernel.py:
// medium_sigma_t :1231, medium_fields :1241, phase_value :1267,
// walk_transmittance :1288, the phase sample :2038-2085). The plain
// version of each is in models/volume_pt.py (fused mode).
//
// The TPU kernel fetched a lane's medium fields with a masked loop over
// the 8 media slots; a thread reads its medium's slot of the media row
// directly by id. The shadow transmittance reuses the closest-hit walk of
// walk.cuh once per null interface crossed and reads the hit prim's
// medium_in / is_null attributes after the walk.
#pragma once

#include "bsdf.cuh"
#include "walk.cuh"

#define PHASE_HG 1
#define PHASE_DUAL_HG 2
#define PHASE_RAYLEIGH 3
#define INV_4PI 0.07957747154594767f
// volume_pt.MAX_CROSSINGS: null interfaces one shadow ray walks through
#define MAX_CROSSINGS 4

// Kernel K4's own inputs, passed as the trace kernel's last parameter so
// that the surface instantiations keep the Pack and the parameter layout
// they have without media.
//   mrow : medium m at mrow[m*16 + f], f = sigma_a(3) sigma_s(3) sigma_t(3)
//          (each times the medium's scale) phase_type g1 g2 w is_grid
struct MedArgs {
    const float* mrow;
    int ambient_med;  // the medium of an empty medium stack (-1 = none)
    int max_volume;   // medium events per path
};

struct Medium {
    V3 ss;  // sigma_s * scale
    V3 st;  // sigma_t * scale
    int ptype;
    float g1, g2, w;
};

__device__ __forceinline__ Medium load_medium(const MedArgs& ma, int m) {
    const float* r = ma.mrow + m * SLOT_F;
    Medium md;
    md.ss = load3(r + 3);
    md.st = load3(r + 6);
    md.ptype = (int)r[9];
    md.g1 = r[10];
    md.g2 = r[11];
    md.w = r[12];
    return md;
}

// forward Henyey-Greenstein, |g| kept >= 1e-3
__device__ __forceinline__ float hg_value(float g, float cos_t) {
    float gs = fabsf(g) < 1e-3f ? (g < 0.0f ? -1e-3f : 1e-3f) : g;
    float den = fmaxf(1.0f + gs * gs - 2.0f * gs * cos_t, 1e-8f);
    return INV_4PI * (1.0f - gs * gs) / (den * sqrtf(den));
}

// phase value (= pdf) at cos_t = d . d_out; SGGX and unknown types are
// isotropic
__device__ __forceinline__ float phase_value(const Medium& m, float cos_t) {
    if (m.ptype == PHASE_HG) return hg_value(m.g1, cos_t);
    if (m.ptype == PHASE_DUAL_HG) return m.w * hg_value(m.g1, cos_t) + (1.0f - m.w) * hg_value(m.g2, cos_t);
    if (m.ptype == PHASE_RAYLEIGH) return 0.75f * INV_4PI * (1.0f + cos_t * cos_t);
    return INV_4PI;
}

// exact HG inverse CDF at up0
__device__ __forceinline__ float hg_cos(float g, float up0) {
    if (fabsf(g) < 1e-3f) return 1.0f - 2.0f * up0;
    float sq = (1.0f - g * g) / (1.0f - g + 2.0f * g * up0);
    return clampf((1.0f + g * g - sq * sq) / (2.0f * g), -1.0f, 1.0f);
}

// Phase sample around the current direction d from (up0, up1) and the
// dual-HG lobe pick upick; returns the new direction, its pdf in pdf. The
// Rayleigh cube root is exp(log(x) / 3), as on the TPU (its argument is
// positive).
__device__ __forceinline__ V3 phase_sample(const Medium& m, V3 d, float up0, float up1,
                                           float upick, float& pdf) {
    float cos_ph = 1.0f - 2.0f * up0;
    if (m.ptype == PHASE_HG) {
        cos_ph = hg_cos(m.g1, up0);
    } else if (m.ptype == PHASE_DUAL_HG) {
        cos_ph = hg_cos(upick < m.w ? m.g1 : m.g2, up0);
    } else if (m.ptype == PHASE_RAYLEIGH) {
        float q = 2.0f * (2.0f * up0 - 1.0f);
        float z = expf(logf(fmaxf(q + sqrtf(q * q + 1.0f), 1e-30f)) * (1.0f / 3.0f));
        cos_ph = clampf(z - 1.0f / z, -1.0f, 1.0f);
    }
    float sin_ph = sqrtf(fmaxf(1.0f - cos_ph * cos_ph, 0.0f));
    float phi = TWO_PI * up1;
    float lx = sin_ph * cosf(phi), ly = sin_ph * sinf(phi);
    V3 t1, t2;
    onb(d, t1, t2);
    pdf = phase_value(m, cos_ph);
    return add(add(scale(t1, lx), scale(t2, ly)), scale(d, cos_ph));
}

// Transmittance of the NEE shadow segment (o, d, dist) starting in medium
// med0: per-segment exp(-sigma_t s) through at most MAX_CROSSINGS null
// interfaces, the medium toggled by object identity at each; an opaque
// hit before the light gives 0. The remaining distance drops by the full
// advance (hit t plus the origin offset), so it stays the distance to the
// light from the advanced origin.
template <bool BIN, bool CPT>
static __device__ V3 walk_transmittance(const Pack& pk, const MedArgs& ma, V3 o, V3 d,
                                        float dist, int med0, WalkStats& st) {
    V3 tr = v3(1.0f, 1.0f, 1.0f);
    int cur = med0;
    float rem = dist;
    for (int k = 0; k < MAX_CROSSINGS; ++k) {
        ClosestHit h = walk_closest<BIN, CPT>(pk, o, d, st);
        bool hit = h.prim >= 0;
        if (cur >= 0) {
            V3 s = load3(ma.mrow + cur * SLOT_F + 6);
            float seg = fminf(hit ? h.t : rem, rem);
            tr = v3(tr.x * expf(-s.x * seg), tr.y * expf(-s.y * seg), tr.z * expf(-s.z * seg));
        }
        if (!(hit && h.t < rem * SHADOW_T_FACTOR)) break;  // the light is reached
        if (!(attr<CPT>(pk, h.prim, 13) > 0.5f)) return v3(0.0f, 0.0f, 0.0f);  // opaque
        int med_obj = (int)attr<CPT>(pk, h.prim, 12);
        if (med_obj >= 0) cur = cur == med_obj ? -1 : med_obj;
        float adv = h.t + RAY_OFFSET;
        o = add(o, scale(d, adv));
        rem = rem - adv;
        if (!(rem > 1e-4f)) break;
    }
    return tr;
}
