// The megakernel's BVH walks, one thread per ray: 8-wide ordered-stack
// walks over w8 nodes and stackless skip walks over binary nodes; the
// kernel's template flag BIN picks one (walk_closest<BIN, CPT>,
// walk_anyhit<BIN, CPT>).
//
// w8: port of the TPU kernel's walk_closest_w8 / walk_anyhit_w8 with
// _w8_expand (ops/pallas/megakernel.py:993-1150), leaf_scan_closest (:691)
// and leaf_scan_any (:872). The TPU walked a tile-shared stack ordered by
// the tile-min entry distance; here each thread keeps its own stack in
// local memory and orders children by its own entry distance, so close
// subtrees tighten t_best first. The order only decides which of two
// prims at exactly equal t wins: leaf tests use the strict t < t_best.
// The TPU kernel captured shading attributes per leaf candidate because it
// has no per-lane gathers; a thread reads the winner's attribute row once
// after the walk (megakernel.cu), which computes the same values.
//
// Binary: port of walk_closest (:802) and walk_anyhit (:923) with
// fetch_node (:589) on f32 or bf16 rows (tk.pack_nodes, pack_nodes_bf16).
// The TPU kernel stepped a tile of rays through the nodes in lockstep,
// descending where any ray of the tile hit the box; here a thread steps
// its own pointer: on a box hit at an interior node ptr + 1, else the
// node's skip, a leaf's prims tested when its box is hit. The nodes are
// visited in the tree's fixed DFS order either way, so the hits are the
// TPU kernel's. The thread stops at the tree's real node count: the
// padding nodes after it carry inverted boxes that pass the slab test and
// hold no prims (the TPU walk steps through them to the end of the rows).
// bf16 boxes are rounded outward, so they admit more nodes, never fewer.
// Prims are read in the pack's format (f32 or t9 rows, prim_row; t9 rows
// hold the f32 positions, so they change no hit): the binary walks always,
// the w8 walks in CPT builds (csrc/common.cuh).
#pragma once

#include "bin_node.cuh"
#include "common.cuh"

// Stack entries: interior child = wide node id (>= 0); leaf child =
// -(base * 16 + cnt) - 1 with cnt <= 15 (max_leaf is checked on the host).
struct WalkStats {
    int nodes;  // w8: interior wide nodes expanded (8 slab tests each); binary: node fetches
    int prims;  // prim tests in leaves
};

// safe_inv of the TPU kernel (megakernel.py:585)
__device__ __forceinline__ float safe_inv(float v) {
    return 1.0f / (fabsf(v) < 1e-8f ? (v < 0.0f ? -1e-8f : 1e-8f) : v);
}

// Möller-Trumbore / sphere test of ray (o, d) against prim slot p; the
// arithmetic order is that of ops/intersect.intersect_gather.
// Returns true on a hit with t > HIT_EPS; writes t, b1, b2.
template <bool CPT>
__device__ __forceinline__ bool intersect_prim(const Pack& pk, int p, V3 o, V3 d,
                                               float& t_out, float& b1, float& b2) {
    const float* row = prim_row<CPT>(pk, p);
    V3 p0 = load3(row + 0);
    V3 e1 = load3(row + 3);
    if (!pk.tri_only && row[9] > 0.0f) {
        float r = e1.x;
        V3 oc = sub(o, p0);
        float bh = dot(oc, d);
        float cc = dot(oc, oc) - r * r;
        float disc = bh * bh - cc;
        if (!(disc > 0.0f)) return false;
        float sq = sqrtf(disc);
        float t0 = -bh - sq;
        float t1 = -bh + sq;
        float ts = t0 > HIT_EPS ? t0 : t1;
        b1 = 0.0f;
        b2 = 0.0f;
        t_out = ts;
        return ts > HIT_EPS;
    }
    V3 e2 = load3(row + 6);
    V3 h = cross(d, e2);
    float a = dot(e1, h);
    float f = 1.0f / (fabsf(a) < 1e-12f ? 1e-12f : a);
    V3 s = sub(o, p0);
    float u = f * dot(s, h);
    V3 q = cross(s, e1);
    float v = f * dot(d, q);
    float t = f * dot(e2, q);
    b1 = u;
    b2 = v;
    t_out = t;
    return (fabsf(a) > 1e-12f) && (u >= 0.0f) && (v >= 0.0f) && (u + v <= 1.0f) && (t > HIT_EPS);
}

// 19-exchange sorting network on 8 keys, descending (far first), as in
// _w8_expand's _SORT8.
__device__ __forceinline__ void cmp_swap(float* k, int* e, int i, int j) {
    if (k[i] < k[j]) {
        float tk = k[i]; k[i] = k[j]; k[j] = tk;
        int te = e[i]; e[i] = e[j]; e[j] = te;
    }
}

// Expand wide node w: slab-test its 8 children against [HIT_EPS, t_gate),
// push the hit children far-to-near at stack[sp..]; returns how many.
__device__ __forceinline__ int w8_expand(const Pack& pk, int w, V3 o, V3 inv, float t_gate,
                                         int* stack, int sp) {
    const float* row = pk.nodes + (size_t)w * W8_ROW;
    float key[8];
    int ent[8];
    int nk = 0;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
        const float* ch = row + c * 9;
        float tx0 = (ch[0] - o.x) * inv.x;
        float tx1 = (ch[3] - o.x) * inv.x;
        float ty0 = (ch[1] - o.y) * inv.y;
        float ty1 = (ch[4] - o.y) * inv.y;
        float tz0 = (ch[2] - o.z) * inv.z;
        float tz1 = (ch[5] - o.z) * inv.z;
        float tn = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)), fminf(tz0, tz1));
        float tf = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)), fmaxf(tz0, tz1));
        float enc = ch[6];
        bool keep = (tn <= tf) && (tf > HIT_EPS) && (tn < t_gate) && (enc > -1.5f);
        key[c] = keep ? tn : -INFINITY;
        ent[c] = enc >= -0.5f ? (int)enc : -((int)ch[7] * 16 + (int)ch[8]) - 1;
        nk += keep ? 1 : 0;
    }
    cmp_swap(key, ent, 0, 1); cmp_swap(key, ent, 2, 3); cmp_swap(key, ent, 4, 5);
    cmp_swap(key, ent, 6, 7); cmp_swap(key, ent, 0, 2); cmp_swap(key, ent, 1, 3);
    cmp_swap(key, ent, 4, 6); cmp_swap(key, ent, 5, 7); cmp_swap(key, ent, 1, 2);
    cmp_swap(key, ent, 5, 6); cmp_swap(key, ent, 0, 4); cmp_swap(key, ent, 3, 7);
    cmp_swap(key, ent, 1, 5); cmp_swap(key, ent, 2, 6); cmp_swap(key, ent, 1, 4);
    cmp_swap(key, ent, 3, 6); cmp_swap(key, ent, 2, 4); cmp_swap(key, ent, 3, 5);
    cmp_swap(key, ent, 3, 4);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        if (i < nk) stack[sp + i] = ent[i];
    }
    return nk;
}

struct ClosestHit {
    float t;
    int prim;  // global prim id, -1 = miss
    float b1, b2;
};

// Closest hit over the whole scene (walk_closest_w8 + leaf_scan_closest).
// The non-inline walks are static: several translation units include them
// (csrc/trace.cuh), and each keeps its own copy.
template <bool CPT>
static __device__ ClosestHit walk_closest_w8(const Pack& pk, V3 o, V3 d, WalkStats& st) {
    V3 inv = v3(safe_inv(d.x), safe_inv(d.y), safe_inv(d.z));
    int stack[MK_MAX_STACK];
    ClosestHit h{INFINITY, -1, 0.0f, 0.0f};
    stack[0] = 0;  // root wide node
    int sp = 1;
    while (sp > 0) {
        int e = stack[--sp];
        if (e >= 0) {
            st.nodes += 1;
            sp += w8_expand(pk, e, o, inv, h.t, stack, sp);
            continue;
        }
        int v = -e - 1;
        int base = v >> 4;
        int cnt = v & 15;
        for (int k = 0; k < cnt; ++k) {
            int pid = base + k;
            float t, b1, b2;
            st.prims += 1;
            bool ok = intersect_prim<CPT>(pk, pid, o, d, t, b1, b2);
            if (ok && t < h.t) {
                h.t = t;
                h.prim = prim_gid<CPT>(pk, pid);
                h.b1 = b1;
                h.b2 = b2;
            }
        }
    }
    return h;
}

// Any hit before t_lim * SHADOW_T_FACTOR (walk_anyhit_w8 + leaf_scan_any);
// stops at the first occluder.
template <bool CPT>
static __device__ bool walk_anyhit_w8(const Pack& pk, V3 o, V3 d, float t_lim, WalkStats& st) {
    V3 inv = v3(safe_inv(d.x), safe_inv(d.y), safe_inv(d.z));
    float t_gate = t_lim * SHADOW_T_FACTOR;
    int stack[MK_MAX_STACK];
    stack[0] = 0;
    int sp = 1;
    while (sp > 0) {
        int e = stack[--sp];
        if (e >= 0) {
            st.nodes += 1;
            sp += w8_expand(pk, e, o, inv, t_gate, stack, sp);
            continue;
        }
        int v = -e - 1;
        int base = v >> 4;
        int cnt = v & 15;
        for (int k = 0; k < cnt; ++k) {
            float t, b1, b2;
            st.prims += 1;
            if (intersect_prim<CPT>(pk, base + k, o, d, t, b1, b2) && t < t_gate) return true;
        }
    }
    return false;
}

// The ray as K1's slab test takes it.
__device__ __forceinline__ K1Ray k1_ray(V3 o, V3 d) {
    return K1Ray{{o.x, o.y, o.z}, {d.x, d.y, d.z},
                 {safe_inv(d.x), safe_inv(d.y), safe_inv(d.z)}};
}

// Closest hit over the binary tree in f32 or bf16 rows (BF16; walk_closest
// + leaf_scan_closest).
template <bool BF16>
static __device__ ClosestHit walk_closest_bin(const Pack& pk, V3 o, V3 d, WalkStats& st) {
    K1Ray r = k1_ray(o, d);
    ClosestHit h{INFINITY, -1, 0.0f, 0.0f};
    int ptr = 0;
    while (ptr < pk.n_nodes) {
        K1Node nd = k1_node<BF16>(pk.nodes, ptr);
        st.nodes += 1;
        bool box = k1_box(nd, r, h.t);
        if (box && nd.cnt > 0) {
            for (int k = 0; k < nd.cnt; ++k) {
                int pid = nd.base + k;
                float t, b1, b2;
                st.prims += 1;
                bool ok = intersect_prim<true>(pk, pid, o, d, t, b1, b2);
                if (ok && t < h.t) {
                    h.t = t;
                    h.prim = prim_gid<true>(pk, pid);
                    h.b1 = b1;
                    h.b2 = b2;
                }
            }
        }
        ptr = (box && nd.cnt == 0) ? ptr + 1 : nd.skip;
    }
    return h;
}

// Any hit before t_lim * SHADOW_T_FACTOR over the binary tree (walk_anyhit
// + leaf_scan_any); stops at the first occluder.
template <bool BF16>
static __device__ bool walk_anyhit_bin(const Pack& pk, V3 o, V3 d, float t_lim, WalkStats& st) {
    K1Ray r = k1_ray(o, d);
    float t_gate = t_lim * SHADOW_T_FACTOR;
    int ptr = 0;
    while (ptr < pk.n_nodes) {
        K1Node nd = k1_node<BF16>(pk.nodes, ptr);
        st.nodes += 1;
        bool box = k1_box(nd, r, t_gate);
        if (box && nd.cnt > 0) {
            for (int k = 0; k < nd.cnt; ++k) {
                float t, b1, b2;
                st.prims += 1;
                if (intersect_prim<true>(pk, nd.base + k, o, d, t, b1, b2) && t < t_gate) {
                    return true;
                }
            }
        }
        ptr = (box && nd.cnt == 0) ? ptr + 1 : nd.skip;
    }
    return false;
}

// The walks of the kernel's node format: binary (BIN: f32 or bf16 rows,
// branched once per walk, and the Pack's prim format) or w8 (with CPT the
// Pack's prim format, else f32 prim rows).
template <bool BIN, bool CPT>
__device__ __forceinline__ ClosestHit walk_closest(const Pack& pk, V3 o, V3 d, WalkStats& st) {
    if constexpr (BIN) {
        return pk.node_bf16 ? walk_closest_bin<true>(pk, o, d, st)
                            : walk_closest_bin<false>(pk, o, d, st);
    } else {
        return walk_closest_w8<CPT>(pk, o, d, st);
    }
}

template <bool BIN, bool CPT>
__device__ __forceinline__ bool walk_anyhit(const Pack& pk, V3 o, V3 d, float t_lim,
                                            WalkStats& st) {
    if constexpr (BIN) {
        return pk.node_bf16 ? walk_anyhit_bin<true>(pk, o, d, t_lim, st)
                            : walk_anyhit_bin<false>(pk, o, d, t_lim, st);
    } else {
        return walk_anyhit_w8<CPT>(pk, o, d, t_lim, st);
    }
}

// ---------------------------------------------------------------------------
// The walk for sorted lanes, written for kernel K5 (csrc/seg.cuh), whose
// driver sorts the lanes so that neighbouring threads walk the same
// subtrees. Walked first with the ray alone live, and with the shared
// short stack in the shadow and interface walks too, it made K5 slower on
// the H100 than the w8 walk (PERF.md), so no kernel of a render path takes
// it: mk_closest_hit_sorted (megakernel_seg.cu) runs it alone, for a
// later kernel to measure against. The same visit order and closest-hit
// rule as walk_closest_w8 / walk_anyhit_w8 (children pushed far to near by
// entry t, as w8_expand pushes them; strict t < t_best in leaves), so the
// hits are theirs, ties in t included; three things differ:
//   - the top SW_SS entries of a thread's stack live in shared memory (a
//     ring in the thread's column of the block's array sw_stack, words of
//     neighbouring threads neighbouring: no bank conflicts), older ones
//     spill to a local array, so a walk of the usual depth touches no local
//     memory; the array is indexed directly (32-bit shared addresses, not
//     a generic pointer);
//   - a node's 8 children are read as 18 128-bit read-only loads (two
//     halves of 4 children);
//   - with VOTE, a warp's lanes run one phase at a time (while-while): inner
//     nodes until no lane of the group holds one (__any_sync), then leaves
//     until none holds a leaf; a lane that holds the other kind waits, and
//     takes its own entries in its own order. Vote only where the warp is
//     converged and its group is a ballot; walks inside divergent code run
//     per thread.
#define SW_SS 16        // stack entries a thread keeps in shared memory (a power of two)
#define SW_THREADS 128  // threads per block of the kernels that walk so (the column stride)

// The block's short stacks: thread t's ring slot k at sw_stack[k * SW_THREADS
// + t]. Allocated in the kernels whose code reaches it (walk_sw). It and the
// functions that index it are static: each translation unit has its own.
static __shared__ int sw_stack[SW_SS * SW_THREADS];

// A thread's traversal stack: entries [lo, sp) in its shared ring (entry j
// in slot j % SW_SS), [0, lo) in loc.
struct ShortStack {
    int sp, lo;
    int loc[MK_MAX_STACK];
};

static __device__ __forceinline__ void ss_push(ShortStack& s, int e) {
    if (s.sp - s.lo == SW_SS) {  // the ring is full: its oldest entry goes to local memory
        s.loc[s.lo] = sw_stack[(s.lo & (SW_SS - 1)) * SW_THREADS + threadIdx.x];
        ++s.lo;
    }
    sw_stack[(s.sp & (SW_SS - 1)) * SW_THREADS + threadIdx.x] = e;
    ++s.sp;
}

static __device__ __forceinline__ int ss_pop(ShortStack& s) {
    --s.sp;
    if (s.sp < s.lo) {
        s.lo = s.sp;
        return s.loc[s.sp];
    }
    return sw_stack[(s.sp & (SW_SS - 1)) * SW_THREADS + threadIdx.x];
}

// w8_expand with 128-bit loads: children 0-3 are floats 0-35 of the row and
// 4-7 floats 36-71, each nine float4; the same slab test, keys and sorting
// network, the hit children pushed far to near.
static __device__ __forceinline__ void sw_expand(const Pack& pk, int w, V3 o, V3 inv,
                                                 float t_gate, ShortStack& s) {
    const float4* row = reinterpret_cast<const float4*>(pk.nodes + (size_t)w * W8_ROW);
    float key[8];
    int ent[8];
    int nk = 0;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
        float f[36];
#pragma unroll
        for (int q = 0; q < 9; ++q) {
            float4 v = __ldg(row + 9 * half + q);
            f[4 * q] = v.x;
            f[4 * q + 1] = v.y;
            f[4 * q + 2] = v.z;
            f[4 * q + 3] = v.w;
        }
#pragma unroll
        for (int c4 = 0; c4 < 4; ++c4) {
            const float* ch = f + c4 * 9;
            const int c = 4 * half + c4;
            float tx0 = (ch[0] - o.x) * inv.x;
            float tx1 = (ch[3] - o.x) * inv.x;
            float ty0 = (ch[1] - o.y) * inv.y;
            float ty1 = (ch[4] - o.y) * inv.y;
            float tz0 = (ch[2] - o.z) * inv.z;
            float tz1 = (ch[5] - o.z) * inv.z;
            float tn = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)), fminf(tz0, tz1));
            float tf = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)), fmaxf(tz0, tz1));
            float enc = ch[6];
            bool keep = (tn <= tf) && (tf > HIT_EPS) && (tn < t_gate) && (enc > -1.5f);
            key[c] = keep ? tn : -INFINITY;
            ent[c] = enc >= -0.5f ? (int)enc : -((int)ch[7] * 16 + (int)ch[8]) - 1;
            nk += keep ? 1 : 0;
        }
    }
    cmp_swap(key, ent, 0, 1); cmp_swap(key, ent, 2, 3); cmp_swap(key, ent, 4, 5);
    cmp_swap(key, ent, 6, 7); cmp_swap(key, ent, 0, 2); cmp_swap(key, ent, 1, 3);
    cmp_swap(key, ent, 4, 6); cmp_swap(key, ent, 5, 7); cmp_swap(key, ent, 1, 2);
    cmp_swap(key, ent, 5, 6); cmp_swap(key, ent, 0, 4); cmp_swap(key, ent, 3, 7);
    cmp_swap(key, ent, 1, 5); cmp_swap(key, ent, 2, 6); cmp_swap(key, ent, 1, 4);
    cmp_swap(key, ent, 3, 6); cmp_swap(key, ent, 2, 4); cmp_swap(key, ent, 3, 5);
    cmp_swap(key, ent, 3, 4);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        if (i < nk) ss_push(s, ent[i]);
    }
}

template <bool VOTE>
__device__ __forceinline__ bool sw_any(unsigned mask, bool p) {
    if constexpr (VOTE) {
        return __any_sync(mask, p);
    } else {
        return p;
    }
}

// The walk: ANY, the any hit before t_gate (h.prim >= 0: occluded, the
// first occluder's slot), else the closest hit (t_gate unused); VOTE, the
// lanes of mask (all of which call it) vote on the phase; DEPTH, *depth =
// the most entries the stack held. Kernels that call it run SW_THREADS
// threads a block.
template <bool ANY, bool VOTE, bool CPT, bool DEPTH>
static __device__ ClosestHit walk_sw(const Pack& pk, V3 o, V3 d, float t_gate, unsigned mask,
                                     WalkStats& st, int* depth) {
    V3 inv = v3(safe_inv(d.x), safe_inv(d.y), safe_inv(d.z));
    ShortStack s;
    s.sp = 0;
    s.lo = 0;
    ClosestHit h{INFINITY, -1, 0.0f, 0.0f};
    int cur = 0;  // the entry in hand: the root wide node
    bool have = true;
    int dmax = 1;
    while (sw_any<VOTE>(mask, have)) {
        // inner nodes until no lane of the group holds one
        while (sw_any<VOTE>(mask, have && cur >= 0)) {
            if (have && cur >= 0) {
                st.nodes += 1;
                sw_expand(pk, cur, o, inv, ANY ? t_gate : h.t, s);
                if (DEPTH) dmax = max(dmax, s.sp);
                have = s.sp > 0;
                if (have) cur = ss_pop(s);
            }
        }
        // then leaves until no lane holds one
        while (sw_any<VOTE>(mask, have && cur < 0)) {
            if (have && cur < 0) {
                int v = -cur - 1;
                int base = v >> 4;
                int cnt = v & 15;
                bool found = false;
                for (int k = 0; k < cnt; ++k) {
                    int pid = base + k;
                    float t, b1, b2;
                    st.prims += 1;
                    bool ok = intersect_prim<CPT>(pk, pid, o, d, t, b1, b2);
                    if (ANY) {
                        if (ok && t < t_gate) {
                            h.prim = pid;
                            found = true;
                            break;
                        }
                    } else if (ok && t < h.t) {
                        h.t = t;
                        h.prim = prim_gid<CPT>(pk, pid);
                        h.b1 = b1;
                        h.b2 = b2;
                    }
                }
                have = !found && s.sp > 0;
                if (have) cur = ss_pop(s);
            }
        }
    }
    if (DEPTH) *depth = dmax;
    return h;
}
