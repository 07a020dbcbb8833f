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
//   T9_PER_ROW               megakernel.T9_PER_ROW: prims per 128-float row
//                            of the t9 prim table
//   MK_MAX_STACK             cuda_build.MK_MAX_STACK, the per-thread
//                            traversal stack (make_pack checks the scene fits)
//   MK_MIN_BLOCKS            cuda_build.MK_MIN_BLOCKS: resident 128-thread
//                            blocks per SM the trace kernel is built for
//                            (caps its registers)
//   SPEC_WL_MIN, SPEC_WL_MAX bsdf/spectral.WL_MIN, WL_MAX (nm)
//   SPEC_LOBE<l><k>          bsdf/spectral.XYZ_LOBES, lobe l in order, field
//                            k of (alpha, mu, sigma below, sigma above): the
//                            CIE matching-function fit
//   SPEC_M<r><c>, SPEC_NORM_<c>
//                            bsdf/spectral.XYZ_TO_SRGB and NORM: the
//                            dispersion tint's colour matrix and mean-one
//                            normalization
#pragma once

#include <cstdint>
#include <cuda_runtime.h>
#include <math.h>

#if !defined(HIT_EPS) || !defined(RAY_OFFSET) || !defined(SHADOW_T_FACTOR) || \
    !defined(SLOT_F) || !defined(MAX_EMITTERS) || !defined(MK_MAX_STACK) || \
    !defined(MK_MIN_BLOCKS) || !defined(T9_PER_ROW) || \
    !defined(SPEC_WL_MIN) || !defined(SPEC_M00) || !defined(SPEC_NORM_R) || \
    !defined(SPEC_LOBE63)
#error "build with cuda_pt_torch/ops/cuda_build.py, which passes the shared constants"
#endif

#define INV_PI 0.3183098861837907f
#define PI_F 3.141592653589793f
#define TWO_PI 6.283185307179586f
#define W8_ROW 128         // f32 per wide-node row (8 children x 9 fields)

// Scene type ids (scene/types.py)
#define BSDF_LAMBERTIAN 0
#define BSDF_SPECULAR 1
#define BSDF_TRANSLUCENT 2
#define BSDF_PLASTIC 3
#define BSDF_GGX_CONDUCTOR 5
#define BSDF_DISPERSION 6
#define BSDF_FORWARD 7
#define BSDF_GGX_DIELECTRIC 8
#define BSDF_OREN_NAYAR 9
#define EMITTER_NULL 0
#define EMITTER_POINT 1
#define EMITTER_AREA 2
#define EMITTER_AREA_SPOT 3

#define LOBE_DIFFUSE 0
#define LOBE_SPECULAR 1
#define LOBE_TRANSMIT 2

// Row-packed scene tables built by ops/megakernel.make_pack. Each table is
// a flat f32 array; a slot is 16 consecutive floats. The node, prim and
// attr tables come in the formats of the reference's make_pack (the pack's
// fmt bits, FMT_*):
//   nodes : w8: wide node w, child c at nodes[w*128 + c*9 + f],
//           f = lo(3) hi(3) enc base cnt; enc >= 0 interior, -1 leaf, -2 empty;
//           binary (f32 or bf16 rows): the skip tree's nodes (csrc/bin_node.cuh)
//   prims : f32: prim p at prims[p*16 + f], f = p0(3) e1(3) e2(3) is_sphere gid;
//           t9 (all-triangle scenes): prim p at prims[(p / T9_PER_ROW)*128 +
//           (p % T9_PER_ROW)*9 + f], f = p0(3) e1(3) e2(3); its id is p
//   attrs : f32: prim p at attrs[p*16 + f], f = n0(3) n1(3) n2(3) eid inv_area
//           bid medium_in is_null; bf16: prim p at attrs[p*8 + w], w = n0x|n0y
//           n0z|n1x n1y|n1z n2x|n2y n2z|sph eid|bid inv_area(f32) medium_in|is_null,
//           each pair two bf16 (the first in the high 16 bits); attr() reads
//           either by the f32 field number
//   erow  : emitter i at erow[i*16 + f],
//           f = etype em(3) pos(3) sel_pmf sel_cdf kmax falloff
//   eprims: slot s at eprims[s*16 + f], f = p0(3) e1(3) e2(3) cdf eid k inv_area
//   brows : bsdf b slot A at brows[(2b)*16 + f], f = btype kd(3) ks(3) kg(3) ior ax ay;
//           slot B at brows[(2b+1)*16 + f], f = eta(3) k(3) thickness cauchy_a cauchy_b
// Kernel K3's inputs (read only when the matching flag is set):
//   uvs   : prim p at uvs[p*8 + f], f = uv0(2) uv1(2) uv2(2)     (textured)
//   texels: texel i at texels[i*4 + c], RGBA; the texture atlas (textured, has_env)
//   tinfo : texture k at tinfo[k*4 + f], f = offset width height (int32)
//   tdiff : diffuse texture id of bsdf b, -1 = none (int32)      (textured)
//   envrow: tex_id scale azimuth zenith base(3) of the envmap    (has_env)
// Kernel K4 reads attrs fields 12, 13 of prim p: medium_in (-1 = none),
// is_null (forward BSDF or cullable object); its media row is not part of
// the Pack (media.cuh, MedArgs).
// The fmt bits of the C entry points (ops/megakernel.walk_args):
#define FMT_BIN 1        // binary skip-tree nodes (else w8)
#define FMT_NODE_BF16 2  // binary nodes in bf16 rows
#define FMT_PRIM_T9 4    // t9 prims
#define FMT_ATTR_BF16 8  // bf16 attrs
// a compact table: a w8 pack with one runs the CPT build
#define FMT_COMPACT (FMT_PRIM_T9 | FMT_ATTR_BF16)
struct Pack {
    const float* nodes;
    const float* prims;
    const float* attrs;
    const float* erow;
    const float* eprims;
    const float* brows;
    const float* uvs;
    const float* texels;
    const int* tinfo;
    const int* tdiff;
    const float* envrow;
    int max_leaf;
    int tri_only;
    int node_bf16;  // binary nodes: bf16 rows (the walk's template flag BIN picks binary)
    int n_nodes;    // binary nodes: the tree's real nodes (the walk stops there)
    int prim_t9;
    int attr_bf16;
    int has_env;
    int textured;
    int has_disp;
};

struct V3 {
    float x, y, z;
};

// The table accessors take the kernel's template flag CPT: without it the
// build reads f32 prim and attr rows only (the code of the f32 tables, with
// no format branch); with it, the formats of the Pack, branched per fetch
// (the branch is the same for every thread).

// prim p's p0(3) e1(3) e2(3) (f32 rows go on with is_sphere, gid)
template <bool CPT>
__device__ __forceinline__ const float* prim_row(const Pack& pk, int p) {
    if (CPT && pk.prim_t9) {
        return pk.prims + (size_t)(p / T9_PER_ROW) * 128 + (p % T9_PER_ROW) * 9;
    }
    return pk.prims + (size_t)p * SLOT_F;
}

// the global id of prim slot p: the slot itself in t9 rows (make_pack packs
// the prims in id order), field 10 of an f32 row
template <bool CPT>
__device__ __forceinline__ int prim_gid(const Pack& pk, int p) {
    return (CPT && pk.prim_t9) ? p : (int)pk.prims[(size_t)p * SLOT_F + 10];
}

// field f of prim p's attrs, numbered as in the f32 rows; a bf16 field is
// exact as an f32 (its high half)
template <bool CPT>
__device__ __forceinline__ float attr(const Pack& pk, int p, int f) {
    if (!CPT || !pk.attr_bf16) return pk.attrs[(size_t)p * SLOT_F + f];
    const float* a = pk.attrs + (size_t)p * 8;
    if (f == 10) return a[6];  // inv_area stays f32
    // normals 0-8 fill words 0-4 in order; eid|bid word 5; medium|null word 7
    int w = f < 9 ? f >> 1 : (f == 9 || f == 11 ? 5 : 7);
    bool high = f < 9 ? (f & 1) == 0 : (f == 9 || f == 12);
    unsigned u = (unsigned)__float_as_int(a[w]);
    return __int_as_float((int)(high ? (u & 0xFFFF0000u) : (u << 16)));
}

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
__device__ __forceinline__ float max3(V3 a) { return fmaxf(fmaxf(a.x, a.y), a.z); }
// rsqrt(|v|^2 + 1e-20) normalization of the TPU kernel
__device__ __forceinline__ V3 normalize_k(V3 v) { return scale(v, rsqrtf(dot(v, v) + 1e-20f)); }

// core/sampling.power_heuristic, ratio form
__device__ __forceinline__ float power_heuristic(float pdf_a, float pdf_b) {
    float r = pdf_b / fmaxf(pdf_a, 1e-12f);
    float w = 1.0f / (1.0f + r * r);
    return pdf_a > 0.0f ? w : 0.0f;
}
