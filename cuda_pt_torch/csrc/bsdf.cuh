// BSDF evaluation and sampling for the Lambertian, Specular and
// Translucent families (bsdf/eval.py, bsdf/fresnel.py; the TPU kernel's
// BSDF sample at megakernel.py:2087 and family selects at :2287). The TPU
// kernel resolved materials with a masked loop over every BSDF id
// (:1540); here a thread reads its own material row.
#pragma once

#include "common.cuh"

struct Material {
    int btype;
    V3 kd;
    V3 ks;
    float ior;
};

__device__ __forceinline__ Material load_material(const Pack& pk, int bid) {
    const float* a = pk.brows + (size_t)(2 * bid) * SLOT_F;
    Material m;
    m.btype = (int)a[0];
    m.kd = load3(a + 1);
    m.ks = load3(a + 4);
    m.ior = a[10];
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

// core/math.onb (Duff et al. / Frisvad) of unit normal n
__device__ __forceinline__ void onb(V3 n, V3& t, V3& b) {
    float sign = n.z >= 0.0f ? 1.0f : -1.0f;
    float a = -1.0f / (sign + n.z);
    float bb = n.x * n.y * a;
    t = v3(1.0f + sign * n.x * n.x * a, sign * bb, -sign * n.x);
    b = v3(bb, sign + n.y * n.y * a, -n.y);
}

// eval_bsdf toward wi: f*|cos| (returned) and pdf; only the Lambertian
// lobe is smooth among the ported families.
__device__ __forceinline__ V3 eval_bsdf(const Material& m, V3 nl, V3 wi, float& pdf) {
    float cos_i = dot(wi, nl);
    pdf = 0.0f;
    if (!(cos_i > 0.0f) || m.btype != BSDF_LAMBERTIAN) return v3(0.0f, 0.0f, 0.0f);
    pdf = fmaxf(cos_i, 0.0f) * INV_PI;
    return scale(m.kd, INV_PI * cos_i);
}

struct BsdfSample {
    V3 wi;
    V3 weight;
    float pdf;
    bool is_delta;
    int lobe;
};

// sample_bsdf given the drawn uniforms (u_dir, u_lobe); d = incoming ray
// direction (= -wo), n = unflipped shading normal, nl = n flipped toward wo.
__device__ __forceinline__ BsdfSample sample_bsdf(const Material& m, V3 d, V3 n, V3 nl,
                                                  float u0, float u1, float u_lobe) {
    BsdfSample s;
    // lambertian base: cosine hemisphere around nl
    float phi = TWO_PI * u0;
    float cth = sqrtf(fmaxf(1.0f - u1, 0.0f));
    float sth = sqrtf(fmaxf(u1, 0.0f));
    float lx = sth * cosf(phi);
    float ly = sth * sinf(phi);
    V3 t, b;
    onb(nl, t, b);
    s.wi = add(add(scale(t, lx), scale(b, ly)), scale(nl, cth));
    s.weight = m.kd;
    s.pdf = fmaxf(fmaxf(cth, 1e-6f), 0.0f) * INV_PI;
    s.is_delta = false;
    s.lobe = LOBE_DIFFUSE;
    if (m.btype == BSDF_LAMBERTIAN) return s;

    // mirror: normalize(reflect(d, nl))
    float dn = dot(d, nl);
    V3 wi_spec = normalize(sub(d, scale(nl, 2.0f * dn)));
    s.is_delta = true;
    if (m.btype == BSDF_SPECULAR) {
        s.wi = wi_spec;
        s.lobe = LOBE_SPECULAR;
        return s;
    }
    // smooth dielectric: Fresnel lobe choice
    V3 wo = neg(d);
    float cos_signed = dot(wo, n);
    bool entering = cos_signed > 0.0f;
    float eta_rel = entering ? m.ior : 1.0f / fmaxf(m.ior, 1e-4f);
    float f_die = fresnel_dielectric(fabsf(cos_signed), eta_rel);
    if (u_lobe < f_die) {
        s.wi = wi_spec;
        s.weight = m.ks;
        s.lobe = LOBE_SPECULAR;
        return s;
    }
    // core/math.refract(d, nl, 1/eta_rel)
    float eta = 1.0f / eta_rel;
    float cos_i = -dot(d, nl);
    float sin2_t = eta * eta * fmaxf(1.0f - cos_i * cos_i, 0.0f);
    float cos_t = sqrtf(fmaxf(1.0f - sin2_t, 0.0f));
    s.wi = normalize(add(scale(d, eta), scale(nl, eta * cos_i - cos_t)));
    s.weight = scale(m.ks, 1.0f / fmaxf(eta_rel * eta_rel, 1e-6f));
    s.lobe = LOBE_TRANSMIT;
    return s;
}
