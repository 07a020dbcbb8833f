// Whole-path megakernel: one thread traces a path through every bounce,
// then the next path, on a persistent grid (csrc/persist.cuh).
//
// Replaces the TPU kernel ops/pallas/megakernel.py::_kernel (:500) in its
// whole-path mode (trace_megakernel, :2963, pallas_call at :3083) for the
// surface envelope of that kernel: nine BSDF families, area / area-spot /
// point emitters, and the K3 flags has_env, textured and has_disp, and for
// a vpt pack the homogeneous media of kernel K4 (below); on every table
// format of the reference's make_pack: w8 or binary nodes (f32 or bf16
// rows; template flag BIN, csrc/walk.cuh), f32 or t9 prims, f32 or bf16
// attrs (runtime fields of the Pack, branched per fetch: the branch is the
// same for every thread). Per bounce, in the pcg draw order
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
// K4 (template flag MED) is the fused volume path tracer with homogeneous
// media, the TPU kernel's has_media mode (:1224-1331, :1386-1439,
// :1900-1991, :2038-2085, :2342-2398; csrc/media.cuh), in the draw order of
// models/volume_pt.vpt_bounce: per bounce one advance for the free flight
// through the current medium (on every lane, in a medium or not), then a
// medium event (phase-weighted NEE, phase sample) or a surface event (the
// K2 bounce), the two phase-sample advances on both kinds, and every NEE
// shadow ray walked through null interfaces with the analytic
// transmittance of each segment. The medium stack (three nested media,
// the pack's ambient medium when empty) toggles by object identity when a
// path transmits through a surface holding a medium.
// Three template flags prune code at compile time: K3 (any of the three
// flags set), ALL (a family beyond Lambertian / Specular / Translucent
// present) and MED (a vpt pack with media; built with ALL only). A scene
// runs the smallest of the six instantiations that covers it, in the build
// of its tables: f32, CPT (a w8 pack with t9 prims or bf16 attrs: the
// formats read from the Pack) or BIN (binary nodes, any prim and attr
// format): eighteen in all.
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
// A path lasts 2.6 bounces on average on cornell, while the longest of a
// 32-lane warp lasts 6.5: launched one thread per path, a warp's lanes sat
// idle for 0.6 of its bounces, waiting for its longest path. So the grid
// is persistent: the launch holds as many blocks as the card keeps
// resident (the occupancy query, once per instantiation), each lane runs
// one bounce per pass of its loop, and a lane whose path has ended (the
// `break` of csrc/bounce.inc, or the depth cap) writes L and stats at its
// path's index and takes the next path from a work counter (a warp takes
// together: csrc/persist.cuh) once fewer than K2_REFILL_BELOW lanes of its
// warp hold a path. A path's arithmetic is the per-path kernel's, so L
// and the walk work are the same bit for bit; the counter resets in the
// kernel (no memset beside the launch). A refused occupancy query returns
// its error, and mk_trace launches nothing.
//
// K4 adds up to MAX_CROSSINGS closest walks per NEE shadow ray and the
// medium state to the same per-thread loop; it is bound by the same walk
// operations.
//
// The kernel template is csrc/trace.cuh (its loop body csrc/bounce.inc);
// this unit instantiates the four surface builds of w8 packs with f32
// tables, csrc/megakernel_med.cu the two MED ones (launch_trace_med),
// csrc/megakernel_cpt.cu the six of w8 packs with t9 prims or bf16 attrs
// (CPT, launch_trace_cpt), csrc/megakernel_bin.cu the six of binary packs
// (BIN, launch_trace_bin). The sorted-wavefront driver's
// kernels, K5 (one bounce per launch, csrc/seg.cuh) and K6, are built in
// csrc/megakernel_seg.cu and csrc/megakernel_split.cu.
//
// Two C entry points, called through ctypes (ops/megakernel.py):
//   mk_trace        -> L (B, 3) for rays (B, 3) x 2 and pcg states (B, 2);
//                      writes the instantiation it launched to *variant
//   mk_closest_hit  -> (t, prim, b1, b2) of the same closest walk alone (the
//                      pack's node format's)
// Both take the pack's table formats as fmt (FMT_* bits, csrc/common.cuh)
// and a binary tree's node count as n_nodes, and return the error of a
// refused occupancy query, else cudaGetLastError() right after the launch.

#include "trace.cuh"

// csrc/megakernel_med.cu: the MED instantiation for k3 (K3+ALL+MED) or not
// (ALL+MED)
int launch_trace_med(bool k3, const Pack& pk, const DepthCaps& md, int nee_m, const float* ray_o,
                     const float* ray_d, const uint32_t* rng, float* out_L, int* stats, int B,
                     const MedArgs& ma, const StageBytes& sb, cudaStream_t stream);

template <bool BIN, bool CPT>
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
    ClosestHit h = walk_closest<BIN, CPT>(pk, load3(ray_o + 3 * (size_t)i),
                                     load3(ray_d + 3 * (size_t)i), st);
    out_t[i] = h.t;
    out_prim[i] = h.prim;
    out_b1[i] = h.b1;
    out_b2[i] = h.b2;
}

template <bool BIN, bool CPT>
static void launch_closest_hit(const Pack& pk, const float* ray_o, const float* ray_d,
                               float* out_t, int* out_prim, float* out_b1, float* out_b2, int B,
                               cudaStream_t stream) {
    int threads = 128;
    int blocks = (B + threads - 1) / threads;
    closest_hit_kernel<BIN, CPT><<<blocks, threads, 0, stream>>>(pk, ray_o, ray_d, out_t,
                                                                 out_prim, out_b1, out_b2, B);
}

extern "C" int mk_trace(const void* const* tables, const float* ray_o, const float* ray_d,
                        const uint32_t* rng, float* out_L, int* stats, int B, int max_leaf,
                        int tri_only, int fmt, int n_nodes, int has_env, int textured,
                        int has_disp, int all_families, int has_media, int ambient_med,
                        int max_depth, int max_diffuse, int max_specular, int max_transmit,
                        int max_volume, int nee_m, int* variant, void* stream) {
    Pack pk = make_pack_view(tables, max_leaf, tri_only, fmt, n_nodes, has_env, textured,
                             has_disp);
    DepthCaps md{max_depth, max_diffuse, max_specular, max_transmit};
    MedArgs ma{(const float*)tables[11], ambient_med, max_volume};
    cudaStream_t st = (cudaStream_t)stream;
    bool k3 = has_env || textured || has_disp;
    bool all = all_families || has_media;  // MED is built with ALL only
    bool bin = (fmt & FMT_BIN) != 0;
    bool cpt = !bin && (fmt & FMT_COMPACT) != 0;
    StageBytes sb = stage_bytes(tables);
    bool stage = !bin && !cpt && stage_fit(sb.n, STAGE_TABLES) > 0;
    // the instantiation launched: bit 0 K3, bit 1 ALL, bit 2 MED, bit 6 BIN,
    // bit 7 CPT, bit 8 STAGE
    if (variant != nullptr) {
        *variant = (k3 ? 1 : 0) | (all ? 2 : 0) | (has_media ? 4 : 0) | (bin ? 64 : 0)
                   | (cpt ? 128 : 0) | (stage ? 256 : 0);
    }
    int rc = 0;
    if (B > 0) {
        if (bin) {
            rc = launch_trace_bin(k3, all, has_media, pk, md, nee_m, ray_o, ray_d, rng, out_L,
                                  stats, B, ma, st);
        } else if (cpt) {
            rc = launch_trace_cpt(k3, all, has_media, pk, md, nee_m, ray_o, ray_d, rng, out_L,
                                  stats, B, ma, st);
        } else if (has_media) {
            rc = launch_trace_med(k3, pk, md, nee_m, ray_o, ray_d, rng, out_L, stats, B, ma, sb,
                                  st);
        } else if (k3 && all_families) {
            rc = launch_trace<true, true, false>(pk, md, nee_m, ray_o, ray_d, rng, out_L, stats, B,
                                                 ma, sb, st);
        } else if (k3) {
            rc = launch_trace<true, false, false>(pk, md, nee_m, ray_o, ray_d, rng, out_L, stats,
                                                  B, ma, sb, st);
        } else if (all_families) {
            rc = launch_trace<false, true, false>(pk, md, nee_m, ray_o, ray_d, rng, out_L, stats,
                                                  B, ma, sb, st);
        } else {
            rc = launch_trace<false, false, false>(pk, md, nee_m, ray_o, ray_d, rng, out_L, stats,
                                                   B, ma, sb, st);
        }
    }
    return rc != 0 ? rc : (int)cudaGetLastError();
}

extern "C" int mk_closest_hit(const void* const* tables, const float* ray_o, const float* ray_d,
                              float* out_t, int* out_prim, float* out_b1, float* out_b2, int B,
                              int max_leaf, int tri_only, int fmt, int n_nodes, void* stream) {
    Pack pk = make_pack_view(tables, max_leaf, tri_only, fmt, n_nodes, 0, 0, 0);
    cudaStream_t st = (cudaStream_t)stream;
    if (B > 0) {
        if (fmt & FMT_BIN) {
            launch_closest_hit<true, true>(pk, ray_o, ray_d, out_t, out_prim, out_b1, out_b2, B,
                                           st);
        } else if (fmt & FMT_COMPACT) {
            launch_closest_hit<false, true>(pk, ray_o, ray_d, out_t, out_prim, out_b1, out_b2, B,
                                            st);
        } else {
            launch_closest_hit<false, false>(pk, ray_o, ray_d, out_t, out_prim, out_b1, out_b2, B,
                                             st);
        }
    }
    return (int)cudaGetLastError();
}
