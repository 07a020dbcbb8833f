// Kernel K5, the segment form of the trace kernel: one bounce per launch
// on per-lane state carried in planes between launches, and its launcher.
// Included by megakernel_seg.cu (SEG: the bounce walks its own closest
// hit) and megakernel_split.cu (SHADE: the closest hit arrives as planes,
// with kernel K6).
//
// Replaces the TPU kernel ops/pallas/megakernel.py::_kernel in its segment
// mode (seg=True, :534-556, :2439-2486) as driven by trace_megakernel_swf
// (:3248, pallas_call :3360). The bounce is csrc/bounce.inc, the loop body
// of the whole-path kernel, run once per launch with MK_SEG defined. The
// driver (ops/megakernel.trace_megakernel_swf) re-sorts the lanes between
// launches and launches only the live prefix the sort leaves.
//
// Bound on an H100: bytes, counted per launch as the planes each live lane
// reads (0-20, the medium stack, in the SHADE form the hit and flight
// planes: 84-172 B) and writes (0-20, the medium stack, the texture and
// grid records, the envmap record only on a miss: 84-140 B) against a walk
// of tens of slab and triangle tests; the time goes to the walks, as in the
// whole-path kernel, and the sort makes neighbouring threads walk the same
// subtrees, so a warp diverges less. Planes (one 4-byte load per thread
// and plane) keep a warp's state loads and stores coalesced.
//
// State planes: int32 (n_state, stride), lane i of plane k at
// state[k * stride + i]; floats as their bits, the pcg state as u32 bits
// (ops/megakernel.seg_layout):
//   0-1 pcg | 2-4 o | 5-7 d | 8-10 thp | 11-13 L | 14 act | 15 prev_pdf
//   16 prev_delta | 17-19 n_diff n_spec n_trans | 20 wl
//   [has_env: 6 env miss record: direction, throughput]
//   [MED: 5 medium stack: stk0 stk1 stk2 mtop n_vol]
//   [textured: 6 texture record: NEE contribution, bid, u, v]
//   [GRID: 9 grid NEE record: contribution, segment start, segment end]
// The records are rewritten on every launch for each lane launched (zero,
// bid -1, where a lane was dead or recorded nothing).
// Hit planes (SHADE), f32 (n_hit, n): t, hit, ns(3), ng(3), eid, inv_area,
// [sphere flag unless tri_only], bid, [u, v if textured], [medium_in,
// is_null if MED]. Flight planes (GRID), f32 (5, n): t, is_medium,
// weight(3).
#pragma once

// The segment forms of csrc/bounce.inc; this also leaves the whole-path
// kernel out of the including unit (csrc/trace.cuh).
#define MK_SEG
#include "trace.cuh"

#define SEG_BASE 21

// Kernel K5's per-bounce inputs beyond the state (SHADE: the resolved
// closest hit; GRID: the delta-tracked flight through a grid medium) and
// its records:
//   env miss   the escape direction and throughput (has_env); the driver
//              adds thp * Le(d) after the last bounce
//   texture    this bounce's NEE contribution before the hit's diffuse
//              texel, the hit's bsdf id and uv (textured); the driver
//              multiplies the texel into it and into the throughput
//   grid NEE   the NEE contribution before the grid transmittance and the
//              shadow segment's two ends (GRID); the driver ratio-tracks
//              the segment and adds contribution * Tr
struct SegIO {
    bool hit;
    float t;
    V3 ns, ng;  // raw interpolated shading normal, raw geometric normal; a sphere's centre
    int eid, bid, med_obj;
    float inva;
    bool sph;
    float u, v;
    bool g_ismed;
    float g_tmed;
    V3 g_w;
    bool missed;
    V3 mdir, mthp;
    V3 nee;
    int bid_rec;
    float u_rec, v_rec;
    V3 gc, gp0, gp1;
};

// The bounce's closest hit: walked (SEG; BIN: the binary tree's walk) or
// resolved from planes (SHADE; prim 0 marks a hit, its attributes come
// from io).
template <bool SHADE, bool BIN, bool CPT>
__device__ __forceinline__ ClosestHit seg_hit(const Pack& pk, V3 o, V3 d, WalkStats& st,
                                              const SegIO& io) {
    if constexpr (SHADE) {
        return ClosestHit{io.t, io.hit ? 0 : -1, 0.0f, 0.0f};
    } else {
        return walk_closest<BIN, CPT>(pk, o, d, st);
    }
}

// SHADE: the hit's normals and attributes from the resolved planes (a
// sphere's shading normal from its centre).
__device__ __forceinline__ void seg_resolved_hit(const SegIO& io, V3 p, V3& ns, V3& ng,
                                                 int& eid, float& inva, int& bid) {
    if (io.sph) {
        ns = normalize(sub(p, io.ns));
        ng = ns;
    } else {
        ns = normalize(io.ns);
        ng = normalize(io.ng);
        if (dot(ng, ns) < 0.0f) ng = neg(ng);
    }
    eid = io.eid;
    inva = io.inva;
    bid = io.bid;
}

__device__ __forceinline__ void seg_miss_record(SegIO& io, V3 d, V3 thp) {
    io.missed = true;
    io.mdir = d;
    io.mthp = thp;
}

// The hit's bsdf id and uv for the driver's texel lookup (the whole-path
// kernel's diffuse_texel does it in place)
template <bool SHADE>
__device__ __forceinline__ void seg_texture_record(const Pack& pk, SegIO& io, int bid,
                                                   const ClosestHit& h) {
    io.bid_rec = bid;
    if constexpr (SHADE) {
        io.u_rec = io.u;
        io.v_rec = io.v;
    } else {
        const float* uv = pk.uvs + (size_t)h.prim * 8;
        float w0 = 1.0f - h.b1 - h.b2;
        io.u_rec = w0 * uv[0] + h.b1 * uv[2] + h.b2 * uv[4];
        io.v_rec = w0 * uv[1] + h.b1 * uv[3] + h.b2 * uv[5];
    }
}

// The NEE contribution times the in-kernel (homogeneous, interface-walked)
// transmittance tr, with its shadow segment, for the driver's grid pass
__device__ __forceinline__ void seg_grid_record(SegIO& io, V3 tr, V3 cn, V3 p, V3 dir,
                                                float dist) {
    io.gc = mul(cn, tr);
    io.gp0 = p;
    io.gp1 = add(p, scale(dir, dist));
}


__device__ __forceinline__ float seg_ld(const int* sp, int k, int stride) {
    return __int_as_float(sp[(size_t)k * stride]);
}
__device__ __forceinline__ void seg_st(int* sp, int k, int stride, float v) {
    sp[(size_t)k * stride] = __float_as_int(v);
}
__device__ __forceinline__ void seg_st3(int* sp, int k, int stride, V3 v) {
    seg_st(sp, k, stride, v.x);
    seg_st(sp, k + 1, stride, v.y);
    seg_st(sp, k + 2, stride, v.z);
}

template <bool K3, bool ALL, bool MED, bool SHADE, bool GRID, bool BIN, bool CPT>
__global__ void __launch_bounds__(128, MK_MIN_BLOCKS) seg_kernel(Pack pk, DepthCaps md, int nee_m,
                                                  int bounce, int* __restrict__ state,
                                                  int stride, int n,
                                                  const float* __restrict__ hit,
                                                  const float* __restrict__ flight,
                                                  int* __restrict__ stats, MedArgs ma) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    int* sp = state + i;
    const int med_base = SEG_BASE + (pk.has_env ? 6 : 0);
    const int rec_base = med_base + (MED ? 5 : 0);
    SegIO io{};
    io.bid_rec = -1;
    if (seg_ld(sp, 14, stride) > 0.5f) {
        // the whole-path kernel's locals, from the planes
        V3 o = v3(seg_ld(sp, 2, stride), seg_ld(sp, 3, stride), seg_ld(sp, 4, stride));
        V3 d = v3(seg_ld(sp, 5, stride), seg_ld(sp, 6, stride), seg_ld(sp, 7, stride));
        uint32_t sx = (uint32_t)sp[0];
        uint32_t sy = (uint32_t)sp[stride];
        V3 thp = v3(seg_ld(sp, 8, stride), seg_ld(sp, 9, stride), seg_ld(sp, 10, stride));
        V3 L = v3(seg_ld(sp, 11, stride), seg_ld(sp, 12, stride), seg_ld(sp, 13, stride));
        V3 texp = v3(1.0f, 1.0f, 1.0f);  // texels resolve between launches
        float wl = seg_ld(sp, 20, stride);
        float prev_pdf = seg_ld(sp, 15, stride);
        bool prev_delta = seg_ld(sp, 16, stride) > 0.5f;
        int n_diff = (int)seg_ld(sp, 17, stride);
        int n_spec = (int)seg_ld(sp, 18, stride);
        int n_trans = (int)seg_ld(sp, 19, stride);
        WalkStats st{0, 0};
        int stk0 = -1, stk1 = -1, stk2 = -1, mtop = -1, n_vol = 0;
        if constexpr (MED) {
            stk0 = (int)seg_ld(sp, med_base, stride);
            stk1 = (int)seg_ld(sp, med_base + 1, stride);
            stk2 = (int)seg_ld(sp, med_base + 2, stride);
            mtop = (int)seg_ld(sp, med_base + 3, stride);
            n_vol = (int)seg_ld(sp, med_base + 4, stride);
        }
        if constexpr (SHADE) {
            const float* hp = hit + i;
            io.t = hp[0];
            io.hit = hp[(size_t)n] > 0.5f;
            io.ns = v3(hp[2 * (size_t)n], hp[3 * (size_t)n], hp[4 * (size_t)n]);
            io.ng = v3(hp[5 * (size_t)n], hp[6 * (size_t)n], hp[7 * (size_t)n]);
            io.eid = (int)hp[8 * (size_t)n];
            io.inva = hp[9 * (size_t)n];
            int k = 10;
            io.sph = false;
            if (!pk.tri_only) io.sph = hp[(size_t)(k++) * n] > 0.5f;
            io.bid = (int)hp[(size_t)(k++) * n];
            if (pk.textured) {
                io.u = hp[(size_t)(k++) * n];
                io.v = hp[(size_t)(k++) * n];
            }
            if (MED) io.med_obj = (int)hp[(size_t)k * n];
        }
        if constexpr (GRID) {
            const float* fp = flight + i;
            io.g_tmed = fp[0];
            io.g_ismed = fp[(size_t)n] > 0.5f;
            io.g_w = v3(fp[2 * (size_t)n], fp[3 * (size_t)n], fp[4 * (size_t)n]);
        }
        // one pass of the loop body: its `continue` (the path goes on) and
        // its end reach the increment, which sets on; its `break` does not
        bool on = false;
        for (bool once = true; once; once = false, on = true) {
#include "bounce.inc"
        }
        if (!on) thp = v3(0.0f, 0.0f, 0.0f);
        sp[0] = (int)sx;
        sp[stride] = (int)sy;
        seg_st3(sp, 2, stride, o);
        seg_st3(sp, 5, stride, d);
        seg_st3(sp, 8, stride, thp);
        seg_st3(sp, 11, stride, L);
        seg_st(sp, 14, stride, on ? 1.0f : 0.0f);
        seg_st(sp, 15, stride, prev_pdf);
        seg_st(sp, 16, stride, prev_delta ? 1.0f : 0.0f);
        seg_st(sp, 17, stride, (float)n_diff);
        seg_st(sp, 18, stride, (float)n_spec);
        seg_st(sp, 19, stride, (float)n_trans);
        seg_st(sp, 20, stride, wl);
        if (K3 && pk.has_env && io.missed) {
            seg_st3(sp, SEG_BASE, stride, io.mdir);
            seg_st3(sp, SEG_BASE + 3, stride, io.mthp);
        }
        if constexpr (MED) {
            seg_st(sp, med_base, stride, (float)stk0);
            seg_st(sp, med_base + 1, stride, (float)stk1);
            seg_st(sp, med_base + 2, stride, (float)stk2);
            seg_st(sp, med_base + 3, stride, (float)mtop);
            seg_st(sp, med_base + 4, stride, (float)n_vol);
        }
        if (stats != nullptr) {
            stats[2 * (size_t)i] += st.nodes;
            stats[2 * (size_t)i + 1] += st.prims;
        }
    }
    // the per-launch records, for every lane launched
    if (K3 && pk.textured) {
        seg_st3(sp, rec_base, stride, io.nee);
        seg_st(sp, rec_base + 3, stride, (float)io.bid_rec);
        seg_st(sp, rec_base + 4, stride, io.u_rec);
        seg_st(sp, rec_base + 5, stride, io.v_rec);
    }
    if constexpr (GRID) {
        seg_st3(sp, rec_base, stride, io.gc);
        seg_st3(sp, rec_base + 3, stride, io.gp0);
        seg_st3(sp, rec_base + 6, stride, io.gp1);
    }
}

// The arguments of one K5 launch.
struct SegArgs {
    int bounce;
    int* state;
    int stride;
    int n;
    const float* hit;
    const float* flight;
    int* stats;
};

template <bool K3, bool ALL, bool MED, bool SHADE, bool GRID, bool BIN = false,
          bool CPT = false>
static void launch_seg(const Pack& pk, const DepthCaps& md, int nee_m, const SegArgs& a,
                       const MedArgs& ma, cudaStream_t stream) {
    int threads = 128;
    int blocks = (a.n + threads - 1) / threads;
    seg_kernel<K3, ALL, MED, SHADE, GRID, BIN, CPT><<<blocks, threads, 0, stream>>>(
        pk, md, nee_m, a.bounce, a.state, a.stride, a.n, a.hit, a.flight, a.stats, ma);
}

// The six SEG instantiations of one table build: the one that covers the
// pack's flags.
template <bool BIN, bool CPT>
static void launch_seg_fmt(bool k3, bool all, bool med, const Pack& pk, const DepthCaps& md,
                           int nee_m, const SegArgs& a, const MedArgs& ma, cudaStream_t stream) {
    if (med && k3) {
        launch_seg<true, true, true, false, false, BIN, CPT>(pk, md, nee_m, a, ma, stream);
    } else if (med) {
        launch_seg<false, true, true, false, false, BIN, CPT>(pk, md, nee_m, a, ma, stream);
    } else if (k3 && all) {
        launch_seg<true, true, false, false, false, BIN, CPT>(pk, md, nee_m, a, ma, stream);
    } else if (k3) {
        launch_seg<true, false, false, false, false, BIN, CPT>(pk, md, nee_m, a, ma, stream);
    } else if (all) {
        launch_seg<false, true, false, false, false, BIN, CPT>(pk, md, nee_m, a, ma, stream);
    } else {
        launch_seg<false, false, false, false, false, BIN, CPT>(pk, md, nee_m, a, ma, stream);
    }
}

// megakernel_split.cu: the SHADE instantiations of a grid pack (ALL, MED
// and GRID; K3 with dispersion; CPT with t9 prims or bf16 attrs)
void launch_shade(bool k3, bool cpt, const Pack& pk, const DepthCaps& md, int nee_m,
                  const SegArgs& a, const MedArgs& ma, cudaStream_t stream);

// The SEG instantiations of a pack with binary nodes (megakernel_seg_bin.cu:
// BIN, with the Pack's formats) and of a w8 pack with t9 prims or bf16
// attrs (megakernel_seg_cpt.cu: CPT)
void launch_seg_bin(bool k3, bool all, bool med, const Pack& pk, const DepthCaps& md, int nee_m,
                    const SegArgs& a, const MedArgs& ma, cudaStream_t stream);
void launch_seg_cpt(bool k3, bool all, bool med, const Pack& pk, const DepthCaps& md, int nee_m,
                    const SegArgs& a, const MedArgs& ma, cudaStream_t stream);
