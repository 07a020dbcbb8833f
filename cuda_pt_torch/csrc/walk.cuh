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
