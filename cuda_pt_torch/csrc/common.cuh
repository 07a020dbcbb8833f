// Shared constants, the scene-pack view and small vector helpers for the
// megakernel (csrc/megakernel.cu). The constants shared with the plain
// PyTorch path come from their one Python definition as nvcc -D flags
// (ops/cuda_build._defines):
//   HIT_EPS, RAY_OFFSET      intersect.HIT_EPS, intersect.RAY_OFFSET: shadow
//                            and continuation rays start RAY_OFFSET off the
//                            surface along the geometric normal
//   SHADOW_T_FACTOR          1 - intersect.SHADOW_T_SCALE: any-hit tests
//                            count hits only before t_far * SHADOW_T_FACTOR
//   SLOT_F, MAX_EMITTERS     megakernel.SLOT_F (f32 fields per packed slot),
//                            megakernel.MAX_EMITTERS (slot 0 = null)
//   MK_MAX_STACK             cuda_build.MK_MAX_STACK, the per-thread
//                            traversal stack (make_pack checks the scene fits)
#pragma once

#include <cstdint>
#include <cuda_runtime.h>
#include <math.h>

#if !defined(HIT_EPS) || !defined(RAY_OFFSET) || !defined(SHADOW_T_FACTOR) || \
    !defined(SLOT_F) || !defined(MAX_EMITTERS) || !defined(MK_MAX_STACK)
#error "build with cuda_pt_torch/ops/cuda_build.py, which passes the shared constants"
#endif

#define INV_PI 0.3183098861837907f
#define TWO_PI 6.283185307179586f
#define W8_ROW 128         // f32 per wide-node row (8 children x 9 fields)

// Scene type ids (scene/types.py)
#define BSDF_LAMBERTIAN 0
#define BSDF_SPECULAR 1
#define BSDF_TRANSLUCENT 2
#define EMITTER_NULL 0
#define EMITTER_POINT 1
#define EMITTER_AREA 2
#define EMITTER_AREA_SPOT 3

#define LOBE_DIFFUSE 0
#define LOBE_SPECULAR 1
#define LOBE_TRANSMIT 2

// Row-packed scene tables built by ops/megakernel.make_pack. Each table is
// a flat f32 array; a slot is 16 consecutive floats.
//   nodes : wide node w, child c at nodes[w*128 + c*9 + f],
//           f = lo(3) hi(3) enc base cnt; enc >= 0 interior, -1 leaf, -2 empty
//   prims : prim p at prims[p*16 + f], f = p0(3) e1(3) e2(3) is_sphere gid
//   attrs : prim p at attrs[p*16 + f], f = n0(3) n1(3) n2(3) eid inv_area bid
//   erow  : emitter i at erow[i*16 + f],
//           f = etype em(3) pos(3) sel_pmf sel_cdf kmax falloff
//   eprims: slot s at eprims[s*16 + f], f = p0(3) e1(3) e2(3) cdf eid k inv_area
//   brows : bsdf b slot A at brows[(2b)*16 + f], f = btype kd(3) ks(3) kg(3) ior ax ay
struct Pack {
    const float* nodes;
    const float* prims;
    const float* attrs;
    const float* erow;
    const float* eprims;
    const float* brows;
    int max_leaf;
    int tri_only;
};

struct V3 {
    float x, y, z;
};

__device__ __forceinline__ V3 v3(float x, float y, float z) { return V3{x, y, z}; }
__device__ __forceinline__ V3 add(V3 a, V3 b) { return v3(a.x + b.x, a.y + b.y, a.z + b.z); }
__device__ __forceinline__ V3 sub(V3 a, V3 b) { return v3(a.x - b.x, a.y - b.y, a.z - b.z); }
__device__ __forceinline__ V3 mul(V3 a, V3 b) { return v3(a.x * b.x, a.y * b.y, a.z * b.z); }
__device__ __forceinline__ V3 scale(V3 a, float s) { return v3(a.x * s, a.y * s, a.z * s); }
__device__ __forceinline__ V3 neg(V3 a) { return v3(-a.x, -a.y, -a.z); }
__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
    return v3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x);
}
// core/math.normalize: v * rsqrt(max(|v|^2, 1e-30))
__device__ __forceinline__ V3 normalize(V3 v) {
    return scale(v, rsqrtf(fmaxf(dot(v, v), 1e-30f)));
}
// core/math.length: sqrt(max(|v|^2, 1e-30))
__device__ __forceinline__ float length(V3 v) { return sqrtf(fmaxf(dot(v, v), 1e-30f)); }
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
    return fminf(fmaxf(x, lo), hi);
}
// torch.sign on finite input
__device__ __forceinline__ float signf(float x) {
    return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}
__device__ __forceinline__ V3 load3(const float* p) { return v3(p[0], p[1], p[2]); }

// core/sampling.power_heuristic, ratio form
__device__ __forceinline__ float power_heuristic(float pdf_a, float pdf_b) {
    float r = pdf_b / fmaxf(pdf_a, 1e-12f);
    float w = 1.0f / (1.0f + r * r);
    return pdf_a > 0.0f ? w : 0.0f;
}
