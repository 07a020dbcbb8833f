// BSDF evaluation toward a light and BSDF sampling for the nine surface
// families of the fused kernel's envelope: Lambertian, Specular,
// Translucent, Plastic, GGX conductor, Dispersion, Forward, rough GGX
// dielectric and Oren-Nayar (bsdf/eval.py, bsdf/ggx.py, bsdf/fresnel.py;
// the TPU kernel's candidate eval at ops/pallas/megakernel.py:1805-1897,
// its BSDF sample at :2087-2362 and family selects at :1583-1591).
// The TPU kernel resolved materials with a masked loop over every BSDF id
// (:1554) and evaluated every family on every lane; here a thread reads
// its own material row and branches to its own family, with the TPU
// kernel's arithmetic per family. The template flag ALL is false when the
// scene holds only the Lambertian, Specular and Translucent families
// (ops/megakernel.MKPack.all_families): the other families' code and
// material fields then drop out of the kernel at compile time, as absent
// families drop out of the composed path (bsdf/eval.py, present_bsdfs).
#pragma once

#include "common.cuh"

struct Material {
    int btype;
    V3 kd, ks, kg;
    float ior, ax, ay;
    V3 eta, k;
    float thick, cauchy_a, cauchy_b;
};

template <bool ALL>
__device__ __forceinline__ Material load_material(const Pack& pk, int bid) {
    const float* a = pk.brows + (size_t)(2 * bid) * SLOT_F;
    const float* b = a + SLOT_F;
    Material m;
    m.btype = (int)a[0];
    m.kd = load3(a + 1);
    m.ks = load3(a + 4);
    m.ior = a[10];
    if constexpr (ALL) {
        m.kg = load3(a + 7);
        m.ax = a[11];
        m.ay = a[12];
        m.eta = load3(b + 0);
        m.k = load3(b + 3);
        m.thick = b[6];
        m.cauchy_a = b[7];
        m.cauchy_b = b[8];
    }
    return m;
}

// fresnel.fresnel_dielectric: unpolarized reflectance, 1 under TIR
__device__ __forceinline__ float fresnel_dielectric(float cos_i, float eta) {
    cos_i = clampf(cos_i, 0.0f, 1.0f);
    float sin2_t = (1.0f - cos_i * cos_i) / fmaxf(eta * eta, 1e-8f);
    if (sin2_t >= 1.0f) return 1.0f;
    float cos_t = sqrtf(fmaxf(1.0f - sin2_t, 0.0f));
    float r_par = (eta * cos_i - cos_t) / fmaxf(eta * cos_i + cos_t, 1e-8f);
    float r_per = (cos_i - eta * cos_t) / fmaxf(cos_i + eta * cos_t, 1e-8f);
    return clampf(0.5f * (r_par * r_par + r_per * r_per), 0.0f, 1.0f);
}

// fresnel.fresnel_conductor, one channel
__device__ __forceinline__ float fresnel_conductor(float c, float eta, float k) {
    c = clampf(c, 1e-5f, 1.0f);
    float c2 = c * c;
    float s2 = 1.0f - c2;
    float e2 = eta * eta;
    float k2 = k * k;
    float t0 = e2 - k2 - s2;
    float a2b2 = sqrtf(fmaxf(t0 * t0 + 4.0f * e2 * k2, 0.0f));
    float t1 = a2b2 + c2;
    float a = sqrtf(fmaxf(0.5f * (a2b2 + t0), 0.0f));
    float t2 = 2.0f * a * c;
    float rs = (t1 - t2) / fmaxf(t1 + t2, 1e-8f);
    float t3 = c2 * a2b2 + s2 * s2;
    float t4 = t2 * s2;
    float rp = rs * (t3 - t4) / fmaxf(t3 + t4, 1e-8f);
    return clampf(0.5f * (rp + rs), 0.0f, 1.0f);
}

__device__ __forceinline__ V3 fresnel_conductor3(float c, V3 eta, V3 k) {
    return v3(fresnel_conductor(c, eta.x, k.x), fresnel_conductor(c, eta.y, k.y),
              fresnel_conductor(c, eta.z, k.z));
}

// core/math.onb (Duff et al. / Frisvad) of unit normal n
__device__ __forceinline__ void onb(V3 n, V3& t, V3& b) {
    float sign = n.z >= 0.0f ? 1.0f : -1.0f;
    float a = -1.0f / (sign + n.z);
    float bb = n.x * n.y * a;
    t = v3(1.0f + sign * n.x * n.x * a, sign * bb, -sign * n.x);
    b = v3(bb, sign + n.y * n.y * a, -n.y);
}

// ggx._lambda, ggx.ndf
__device__ __forceinline__ float ggx_lambda(float wx, float wy, float wz, float ax, float ay) {
    float cz = fabsf(wz);
    float a2 = (wx * ax) * (wx * ax) + (wy * ay) * (wy * ay);
    float t2 = a2 / fmaxf(cz * cz, 1e-10f);
    return 0.5f * (sqrtf(1.0f + t2) - 1.0f);
}

__device__ __forceinline__ float ggx_ndf(V3 h, float ax, float ay) {
    float x = h.x / fmaxf(ax, 1e-5f);
    float y = h.y / fmaxf(ay, 1e-5f);
    float t = x * x + y * y + h.z * h.z;
    float d = 1.0f / (PI_F * ax * ay * fmaxf(t * t, 1e-12f));
    return h.z > 0.0f ? d : 0.0f;
}

// bsdf/eval._oren_nayar_factor (fast A/B form; sigma rides ax)
__device__ __forceinline__ float oren_nayar(float sig, float wo_lz, float wi_lz, float dot_xy) {
    float s2 = sig * sig;
    float A = 1.0f - 0.5f * s2 / (s2 + 0.33f);
    float Bc = 0.45f * s2 / (s2 + 0.09f);
    float cto = clampf(wo_lz, 1e-6f, 1.0f);
    float cti = clampf(wi_lz, 1e-6f, 1.0f);
    float sto = sqrtf(fmaxf(1.0f - cto * cto, 0.0f));
    float sti = sqrtf(fmaxf(1.0f - cti * cti, 0.0f));
    float cdphi = clampf(dot_xy / fmaxf(sto * sti, 1e-6f), -1.0f, 1.0f);
    float sin_a = fmaxf(sto, sti);
    float tan_b = fminf(sto, sti) / fmaxf(fmaxf(cto, cti), 1e-6f);
    return A + Bc * fmaxf(cdphi, 0.0f) * sin_a * tan_b;
}

// Per-hit shading frame (the TPU kernel's :1593-1615).
struct Shading {
    V3 nl, t1, t2;   // shading normal flipped toward wo, and its ONB
    V3 wo_l;         // wo in that frame (z = wo . nl)
    float wo_dot_n;  // wo . n (signed)
    bool entering;
    float cos_o;     // |wo . n|
};

__device__ __forceinline__ Shading make_shading(V3 d, V3 ns) {
    Shading s;
    s.wo_dot_n = -dot(d, ns);
    float nsign = s.wo_dot_n < 0.0f ? -1.0f : 1.0f;
    s.nl = scale(ns, nsign);
    s.entering = s.wo_dot_n > 0.0f;
    onb(s.nl, s.t1, s.t2);
    V3 wo = neg(d);
    s.wo_l = v3(dot(wo, s.t1), dot(wo, s.t2), dot(wo, s.nl));
    s.cos_o = fabsf(s.wo_dot_n);
    return s;
}

// Candidate-independent constants of the plastic and rough-dielectric
// families (the TPU kernel's :1683-1693), computed in the family's branch.
__device__ __forceinline__ float plastic_fdr(float ior) {
    return clampf(-1.4399f / fmaxf(ior * ior, 1.0f) + 0.7099f / fmaxf(ior, 1.0f + 1e-4f)
                  + 0.6681f + 0.0636f * ior, 0.0f, 0.999f);
}

// Plastic substrate weight kd_c * fac / (max(1 - kd_c fdr, 0.05) ior^2)
__device__ __forceinline__ V3 plastic_diffuse(const Material& m, float fdr, float fac) {
    float ior2 = m.ior * m.ior;
    return v3(m.kd.x * fac / (fmaxf(1.0f - m.kd.x * fdr, 0.05f) * ior2),
              m.kd.y * fac / (fmaxf(1.0f - m.kd.y * fdr, 0.05f) * ior2),
              m.kd.z * fac / (fmaxf(1.0f - m.kd.z * fdr, 0.05f) * ior2));
}

struct RoughFrame {
    float e_rd;    // relative IoR across the surface
    float coso_c;  // max(wo_l.z, 1e-5)
    float g1o;     // Smith G1 of wo at coso_c
};

__device__ __forceinline__ RoughFrame rough_frame(const Material& m, const Shading& s) {
    RoughFrame r;
    r.e_rd = s.entering ? m.ior : 1.0f / fmaxf(m.ior, 1e-4f);
    r.coso_c = fmaxf(s.wo_l.z, 1e-5f);
    r.g1o = 1.0f / (1.0f + ggx_lambda(s.wo_l.x, s.wo_l.y, r.coso_c, m.ax, m.ay));
    return r;
}

// eval_bsdf toward unit direction wi: f*|cos| (returned) and pdf; delta
// families give 0. Smooth lobes, as in the kernel's candidate eval.
template <bool ALL>
__device__ __forceinline__ V3 eval_bsdf(const Material& m, const Shading& s, V3 wi, float& pdf) {
    pdf = 0.0f;
    V3 zero = v3(0.0f, 0.0f, 0.0f);
    float cos_i = dot(wi, s.nl);
    bool same_side = cos_i > 0.0f;
    float cos_ic = fmaxf(cos_i, 0.0f);
    float ffac = INV_PI * cos_ic;
    if (m.btype == BSDF_LAMBERTIAN) {
        if (!same_side) return zero;
        pdf = cos_ic * INV_PI;
        return scale(m.kd, ffac);
    }
    if constexpr (!ALL) return zero;
    V3 wi_l = v3(dot(wi, s.t1), dot(wi, s.t2), cos_i);
    switch (m.btype) {
    case BSDF_OREN_NAYAR: {
        if (!same_side) return zero;
        float on = oren_nayar(m.ax, s.wo_l.z, wi_l.z, s.wo_l.x * wi_l.x + s.wo_l.y * wi_l.y);
        pdf = cos_ic * INV_PI;
        return scale(m.kd, ffac * on);
    }
    case BSDF_PLASTIC: {
        if (!same_side) return zero;
        float f_o = fresnel_dielectric(s.cos_o, m.ior);
        float f_i = fresnel_dielectric(cos_ic, m.ior);
        float absorb = expf(-sqrtf(dot(m.k, m.k)) * m.thick
                            * (1.0f / fmaxf(cos_ic, 1e-4f) + 1.0f / fmaxf(s.cos_o, 1e-4f)));
        float pfac = (1.0f - f_o) * (1.0f - f_i) * INV_PI * cos_ic * absorb;
        pdf = (1.0f - clampf(f_o, 0.1f, 0.9f)) * fmaxf(cos_i, 0.0f) * INV_PI;
        return plastic_diffuse(m, plastic_fdr(m.ior), pfac);
    }
    case BSDF_GGX_CONDUCTOR: {
        if (!same_side) return zero;
        V3 h = normalize_k(add(s.wo_l, wi_l));
        float d_ndf = ggx_ndf(h, m.ax, m.ay);
        float g2 = 1.0f / (1.0f + ggx_lambda(s.wo_l.x, s.wo_l.y, s.wo_l.z, m.ax, m.ay)
                           + ggx_lambda(wi_l.x, wi_l.y, wi_l.z, m.ax, m.ay));
        float doh = fabsf(dot(s.wo_l, h));
        float spec = d_ndf * g2 / fmaxf(4.0f * fabsf(s.wo_l.z), 1e-6f);
        float g1 = 1.0f / (1.0f + ggx_lambda(s.wo_l.x, s.wo_l.y, s.wo_l.z, m.ax, m.ay));
        pdf = g1 * d_ndf * doh / fmaxf(fabsf(s.wo_l.z), 1e-6f) / fmaxf(4.0f * doh, 1e-8f);
        return scale(mul(fresnel_conductor3(doh, m.eta, m.k), m.kg), spec);
    }
    case BSDF_GGX_DIELECTRIC: {
        // Walter et al. 2007; the transmission lobe is smooth, so it joins
        // NEE on both sides of the surface (no same-side gate)
        RoughFrame rf = rough_frame(m, s);
        bool refl = wi_l.z > 0.0f;
        V3 h;
        if (refl) {
            h = normalize_k(v3(s.wo_l.x + wi_l.x, s.wo_l.y + wi_l.y, rf.coso_c + wi_l.z));
        } else {
            V3 ht = v3(-(s.wo_l.x + rf.e_rd * wi_l.x), -(s.wo_l.y + rf.e_rd * wi_l.y),
                       -(rf.coso_c + rf.e_rd * wi_l.z));
            ht = normalize_k(ht);
            h = ht.z < 0.0f ? neg(ht) : ht;
        }
        float coh = s.wo_l.x * h.x + s.wo_l.y * h.y + rf.coso_c * h.z;
        float wih = dot(wi_l, h);
        float d_ndf = ggx_ndf(h, m.ax, m.ay);
        float g2 = 1.0f / (1.0f + ggx_lambda(s.wo_l.x, s.wo_l.y, rf.coso_c, m.ax, m.ay)
                           + ggx_lambda(wi_l.x, wi_l.y, wi_l.z, m.ax, m.ay));
        float F = fresnel_dielectric(fmaxf(coh, 0.0f), rf.e_rd);
        float dv = rf.g1o * d_ndf * fmaxf(coh, 0.0f) / rf.coso_c;
        if (refl && coh > 1e-6f && wih > 1e-6f) {
            pdf = F * dv / fmaxf(4.0f * coh, 1e-8f);
            return scale(m.ks, F * d_ndf * g2 / fmaxf(4.0f * rf.coso_c, 1e-6f));
        }
        if (!refl && coh > 1e-6f && wih < -1e-6f) {
            float den2 = fmaxf((coh + rf.e_rd * wih) * (coh + rf.e_rd * wih), 1e-8f);
            pdf = (1.0f - F) * dv * rf.e_rd * rf.e_rd * fabsf(wih) / den2;
            return scale(m.ks, (1.0f - F) * d_ndf * g2 * fabsf(coh * wih) / (rf.coso_c * den2));
        }
        return zero;
    }
    default:  // delta families: no smooth lobe
        return zero;
    }
}

struct BsdfSample {
    V3 wi;
    V3 weight;
    float pdf;
    bool is_delta;
    int lobe;
};

// sample_bsdf given the drawn uniforms: (u0, u1) = u_dir, u_lobe, and the
// dispersion IoR / tint of this bounce (ior_t replaces m.ior for the
// translucent geometry of the dispersion family; tint is (1, 1, 1) except
// on a path's first dispersive event). d = incoming ray direction.
template <bool ALL>
__device__ __forceinline__ BsdfSample sample_bsdf(const Material& m, const Shading& s, V3 d,
                                                  float u0, float u1, float u_lobe, float ior_t,
                                                  V3 tint) {
    BsdfSample r;
    r.is_delta = false;
    r.lobe = LOBE_DIFFUSE;
    // cosine hemisphere around nl (Lambertian, Oren-Nayar, plastic substrate)
    float phi = TWO_PI * u0;
    float cth = sqrtf(fmaxf(1.0f - u1, 0.0f));
    float sth = sqrtf(fmaxf(u1, 0.0f));
    float lx = sth * cosf(phi);
    float ly = sth * sinf(phi);
    V3 wi_cos = add(add(scale(s.t1, lx), scale(s.t2, ly)), scale(s.nl, cth));
    float pdf_cos = fmaxf(cth, 1e-6f) * INV_PI;
    r.wi = wi_cos;
    r.pdf = pdf_cos;
    r.weight = m.kd;
    int bt = m.btype;
    if (bt == BSDF_LAMBERTIAN) return r;
    if (ALL && bt == BSDF_OREN_NAYAR) {
        r.weight = scale(m.kd, oren_nayar(m.ax, s.wo_l.z, cth, s.wo_l.x * lx + s.wo_l.y * ly));
        return r;
    }
    if (ALL && bt == BSDF_FORWARD) {  // null interface: straight through
        r.wi = d;
        r.weight = v3(1.0f, 1.0f, 1.0f);
        r.is_delta = true;
        r.lobe = LOBE_TRANSMIT;
        return r;
    }
    // mirror: normalize(d - 2 (d . nl) nl)
    float dn = dot(d, s.nl);
    V3 wi_mirror = normalize_k(sub(d, scale(s.nl, 2.0f * dn)));
    if (bt == BSDF_SPECULAR) {
        r.wi = wi_mirror;
        r.is_delta = true;
        r.lobe = LOBE_SPECULAR;
        return r;
    }
    if (bt == BSDF_TRANSLUCENT || (ALL && bt == BSDF_DISPERSION)) {
        // smooth dielectric: Fresnel lobe choice, refraction with 1/eta_rel
        float eta_rel = s.entering ? ior_t : 1.0f / fmaxf(ior_t, 1e-4f);
        float f_die = fresnel_dielectric(s.cos_o, eta_rel);
        r.is_delta = true;
        if (u_lobe < f_die) {
            r.wi = wi_mirror;
            r.weight = mul(m.ks, tint);
            r.lobe = LOBE_SPECULAR;
            return r;
        }
        float etai = 1.0f / fmaxf(eta_rel, 1e-4f);
        float ci = -dn;
        float s2 = etai * etai * fmaxf(0.0f, 1.0f - ci * ci);
        float ct = sqrtf(fmaxf(1.0f - s2, 0.0f));
        r.wi = normalize_k(add(scale(d, etai), scale(s.nl, etai * ci - ct)));
        r.weight = mul(scale(m.ks, 1.0f / fmaxf(eta_rel * eta_rel, 1e-6f)), tint);
        r.lobe = LOBE_TRANSMIT;
        return r;
    }
    if constexpr (!ALL) return r;
    if (bt == BSDF_PLASTIC) {
        // Fresnel-weighted specular coat vs absorbing diffuse substrate
        float f_o = fresnel_dielectric(s.cos_o, m.ior);
        float p_spec = clampf(f_o, 0.1f, 0.9f);
        if (u_lobe < p_spec) {
            r.wi = wi_mirror;
            r.weight = scale(m.ks, f_o / p_spec);
            r.pdf = (1.0f - p_spec) * pdf_cos;
            r.is_delta = true;
            r.lobe = LOBE_SPECULAR;
            return r;
        }
        float cos_i_d = fmaxf(cth, 1e-6f);
        float f_i = fresnel_dielectric(cos_i_d, m.ior);
        float absorb = expf(-sqrtf(dot(m.k, m.k)) * m.thick
                            * (1.0f / cos_i_d + 1.0f / fmaxf(s.cos_o, 1e-4f)));
        float dfac = ((1.0f - f_o) * (1.0f - f_i) / (1.0f - p_spec)) * absorb;
        r.weight = plastic_diffuse(m, plastic_fdr(m.ior), dfac);
        r.pdf = (1.0f - p_spec) * pdf_cos;
        return r;
    }
    // GGX VNDF half-vector (Heitz 2018), shared by both rough families
    RoughFrame rf = rough_frame(m, s);
    float gz = rf.coso_c;
    V3 v = normalize_k(v3(s.wo_l.x * m.ax, s.wo_l.y * m.ay, gz));
    float lensq = v.x * v.x + v.y * v.y;
    float inv_sq = 1.0f / sqrtf(fmaxf(lensq, 1e-8f));
    bool big = lensq > 1e-8f;
    V3 T1 = v3(big ? -v.y * inv_sq : 1.0f, big ? v.x * inv_sq : 0.0f, 0.0f);
    V3 T2 = v3(v.y * T1.z - v.z * T1.y, v.z * T1.x - v.x * T1.z, v.x * T1.y - v.y * T1.x);
    float rr = sqrtf(fmaxf(u0, 0.0f));
    float ph2 = TWO_PI * u1;
    float p1 = rr * cosf(ph2);
    float p2 = rr * sinf(ph2);
    float sfac = 0.5f * (1.0f + v.z);
    p2 = (1.0f - sfac) * sqrtf(fmaxf(1.0f - p1 * p1, 0.0f)) + sfac * p2;
    float p3 = sqrtf(fmaxf(1.0f - p1 * p1 - p2 * p2, 0.0f));
    V3 nh = add(add(scale(T1, p1), scale(T2, p2)), scale(v, p3));
    V3 h = normalize_k(v3(nh.x * m.ax, nh.y * m.ay, fmaxf(nh.z, 1e-6f)));
    float doh = s.wo_l.x * h.x + s.wo_l.y * h.y + gz * h.z;
    V3 wg = v3(2.0f * doh * h.x - s.wo_l.x, 2.0f * doh * h.y - s.wo_l.y, 2.0f * doh * h.z - gz);
    float lam_o = ggx_lambda(s.wo_l.x, s.wo_l.y, gz, m.ax, m.ay);
    float d_ndf = ggx_ndf(h, m.ax, m.ay);
    V3 wl;  // sampled direction in the local frame
    if (bt == BSDF_GGX_CONDUCTOR) {
        bool ok = wg.z > 1e-5f;
        float g2 = 1.0f / (1.0f + lam_o + ggx_lambda(wg.x, wg.y, wg.z, m.ax, m.ay));
        float gfac = ok ? g2 / fmaxf(rf.g1o, 1e-6f) : 0.0f;
        float doh_abs = fabsf(doh);
        r.weight = scale(mul(fresnel_conductor3(doh_abs, m.eta, m.k), m.kg), gfac);
        // the pdf's G1 takes the unclamped wo_l.z, as the TPU kernel's vndf_pdf
        float g1u = 1.0f / (1.0f + ggx_lambda(s.wo_l.x, s.wo_l.y, s.wo_l.z, m.ax, m.ay));
        r.pdf = ok ? g1u * d_ndf * doh_abs / fmaxf(fabsf(s.wo_l.z), 1e-6f)
                         / fmaxf(4.0f * doh_abs, 1e-8f)
                   : 1.0f;
        r.lobe = LOBE_SPECULAR;
        wl = wg;
    } else {  // BSDF_GGX_DIELECTRIC: reflect or refract through the same h
        float f_rd = fresnel_dielectric(fabsf(doh), rf.e_rd);
        float eta_i = 1.0f / fmaxf(rf.e_rd, 1e-4f);
        float s2 = eta_i * eta_i * fmaxf(0.0f, 1.0f - doh * doh);
        bool tir = s2 >= 1.0f;
        float ct = sqrtf(fmaxf(1.0f - s2, 0.0f));
        bool refl = (u_lobe < f_rd) || tir;
        if (refl) {
            wl = wg;
        } else {
            wl = normalize_k(v3(-eta_i * s.wo_l.x + (eta_i * doh - ct) * h.x,
                                -eta_i * s.wo_l.y + (eta_i * doh - ct) * h.y,
                                -eta_i * gz + (eta_i * doh - ct) * h.z));
        }
        bool ok = refl ? (wl.z > 1e-5f) : (wl.z < -1e-5f);
        float g2 = 1.0f / (1.0f + lam_o + ggx_lambda(wl.x, wl.y, wl.z, m.ax, m.ay));
        float rad = refl ? 1.0f : 1.0f / fmaxf(rf.e_rd * rf.e_rd, 1e-6f);
        r.weight = scale(m.ks, ok ? g2 / fmaxf(rf.g1o, 1e-6f) * rad : 0.0f);
        float dv = rf.g1o * d_ndf * fmaxf(doh, 0.0f) / gz;
        float wih = dot(wl, h);
        float den2 = fmaxf((doh + rf.e_rd * wih) * (doh + rf.e_rd * wih), 1e-8f);
        float pdf = refl ? f_rd * dv / fmaxf(4.0f * doh, 1e-8f)
                         : (1.0f - f_rd) * dv * rf.e_rd * rf.e_rd * fabsf(wih) / den2;
        r.pdf = fmaxf(pdf, 1e-12f);
        r.lobe = refl ? LOBE_SPECULAR : LOBE_TRANSMIT;
    }
    V3 n_l = normalize_k(wl);
    r.wi = add(add(scale(s.t1, n_l.x), scale(s.t2, n_l.y)), scale(s.nl, n_l.z));
    return r;
}
