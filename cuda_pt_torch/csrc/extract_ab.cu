// Kernel S2: the node-field fetch A/B. A tile of rays walks the binary f32
// node rows (ops/traverse_kernel.pack_nodes) with one pointer shared by the
// whole tile, n_iters steps: fetch the node at the pointer, slab-test its box
// on every lane, vote over the tile whether any lane hit it, go to ptr + 1
// on a hit at an interior node and to the skip otherwise, wrap to 0 at the
// rows' slot count; out sums tn over each lane's box hits. The variants
// differ in how a thread gets the node's 9 fields, and e0-e3 take the step
// apart:
//   e0  the loop and the pointer only (acc += 0.1 * ptr)
//   e1  + one field fetched (acc += lo_x)
//   e2  + all 9 fields (acc += their sum)
//   e3  one field as all three box minima, a vote, ptr + 1 or ptr + 2
//   v0  9 scalar loads per thread (the masked-sum form: one operation per
//       field)
//   v1  one warp stages the slot in shared memory, every thread reads it
//       at static offsets (the "roll once, extract statically" form)
//   v2  3 float4 loads per thread (the node decode of bin_node.cuh)
//   w2  v0 on two slots per fetch: the pointer's and the next slot of the
//       same row, (slot + 1) % 8, whose box only adds hits
//   NPTR > 1 (v0_ilp2, v0_ilp4, v2_ilp2): NPTR pointers per iteration,
//       starting at 7 k, sharing acc, stepped in k order
//
// Replaces the TPU micro-kernel _make_kernel of scripts/exp_extract_ab.py
// (:60; pallas_call in time_variant :232), with its quirks, which decide the
// output: e3 takes lo_x for all three axes; w2's second slot wraps inside
// the row; t_best stays 1e30. The TPU's field extraction (masked-sum
// reductions, lane rolls, static extracts) has no counterpart on the card,
// so each strategy maps to the card's nearest load form above. With equal
// rays v0 is S1's walk (csrc/node_bench.cu) bit for bit.
//
// Bound on an H100: the operations (22 per lane and step) against the 24 B
// each lane reads and the 4 B it writes, the rows once. The steps depend on
// the last step's pointer and vote, and one tile is one chain of them, so
// the time per step is what one step's chain takes: the node's fields, the
// slab tests of the tile's lanes on the SMs that hold them, the vote. The
// design shortens the links:
//   - the tile over a thread-block cluster: where the tiles times the
//     cluster size fit the SMs (s2_cluster_size: 8, 4 or 2, each block at
//     least 128 lanes), a tile is one cluster and each of its blocks holds
//     tile / size lanes (at 8 and 8,192 lanes one lane per thread, so
//     nothing spills and the tests spread over 8 SMs); the vote is each
//     block's __syncthreads_or, sent by st.async into every block's shared
//     memory (distributed shared memory), where it completes that block's
//     mbarrier of the step's parity: a block waits for the votes alone,
//     not for a barrier across the cluster's threads, and one mbarrier per
//     parity serves every second step; every block computes the same
//     pointer.
//     Otherwise one block walks a tile, with LPT = tile / 1,024 lanes per
//     thread;
//   - successor prefetch: the next pointer is ptr + 1 or the node's skip
//     (e3: ptr + 2), both known before the vote ends, so a form may load
//     both candidates' fields while the tests and the vote run and let the
//     vote pick one register set (v1: one of two shared-memory slots,
//     filled by its first warp), or prefetch both lines into L1 and load
//     the chosen one after the vote; e1 and e2 load ptr + 1 ahead. Which
//     (and whether, at 8 lanes per thread, the rays sit in shared memory
//     instead of spilled registers) is chosen per form by measurement
//     (s2_prefetch, s2_rays_smem). The wrap to 0 at m_pad applies to the
//     candidates as to the pointer.
// Per lane the additions and their order, and the tile's pointer sequence,
// are the one-block walk's, so the output does not depend on the form.
//
// C entry points:
//   s2_extract_ab(variant, n_ptr, ...) -> out (n,) over n / tile tiles;
//                 returns cudaErrorInvalidValue for a form that is not built
//                 or a tile that is not a multiple of 128 up to 8,192
//                 dividing n, the error of a refused query or cluster
//                 launch, else cudaGetLastError() right after the launch.
//   s2_cluster_size(tiles, tile) -> the cluster size a launch of that
//                 shape takes (1: one block per tile), or -1 on a refused
//                 query.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "bin_node.cuh"

#if !defined(HIT_EPS) || !defined(SLOT_F)
#error "build with cuda_pt_torch/ops/cuda_build.py, which passes the shared constants"
#endif

#define S2_SLOTS 8  // slots per 128-float row
#define S2_MAX_THREADS 1024
#define S2_MAX_CLUSTER 8  // the largest cluster a tile spreads over, a power of two

namespace cg = cooperative_groups;

enum { S2_E0, S2_E1, S2_E2, S2_E3, S2_V0, S2_V1, S2_V2, S2_W2 };

__device__ __forceinline__ int s2_wrap(int p, int m_pad) { return p >= m_pad ? 0 : p; }

// the 9 fields of slot ptr, one scalar load each
__device__ __forceinline__ void s2_fields_scalar(const float* __restrict__ nodes, int ptr,
                                                 float f[9]) {
#pragma unroll
    for (int i = 0; i < 9; ++i) f[i] = __ldg(nodes + (size_t)ptr * SLOT_F + i);
}

// The fields of slot ptr a register form reads: lo(3) hi(3) skip base
// count; e1 and e3 read lo_x alone, v2 by float4 loads.
template <int VARIANT>
__device__ __forceinline__ void s2_fetch(const float* __restrict__ nodes, int ptr, float f[9]) {
    if (VARIANT == S2_V2) {
        K1Node nd = k1_node<false>(nodes, ptr);
#pragma unroll
        for (int i = 0; i < 3; ++i) {
            f[i] = nd.lo[i];
            f[3 + i] = nd.hi[i];
        }
        f[6] = (float)nd.skip;  // exact: the packed fields are integers below 2^24
        f[7] = (float)nd.base;
        f[8] = (float)nd.cnt;
    } else if (VARIANT == S2_E1 || VARIANT == S2_E3) {
        f[0] = __ldg(nodes + (size_t)ptr * SLOT_F);
#pragma unroll
        for (int i = 1; i < 9; ++i) f[i] = 0.0f;
    } else {
        s2_fields_scalar(nodes, ptr, f);
    }
}

// w2's second slot of ptr: the next slot of the same row
__device__ __forceinline__ int s2_slot2(int ptr) {
    return ptr / S2_SLOTS * S2_SLOTS + (ptr % S2_SLOTS + 1) % S2_SLOTS;
}

// tn of a box on one lane and whether it is hit in [HIT_EPS, 1e30)
__device__ __forceinline__ bool s2_box(const float* lo, const float* hi, const float* o,
                                       const float* inv, float& tn) {
    float tx0 = (lo[0] - o[0]) * inv[0];
    float tx1 = (hi[0] - o[0]) * inv[0];
    float ty0 = (lo[1] - o[1]) * inv[1];
    float ty1 = (hi[1] - o[1]) * inv[1];
    float tz0 = (lo[2] - o[2]) * inv[2];
    float tz1 = (hi[2] - o[2]) * inv[2];
    tn = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)), fminf(tz0, tz1));
    float tf = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)), fmaxf(tz0, tz1));
    return (tn <= tf) && (tf > HIT_EPS) && (tn < 1e30f);
}

// w2's second box: the reference's own order (max of the minima, min of the
// maxima, each taken from lo and hi as they stand)
__device__ __forceinline__ bool s2_box_w2(const float* g, const float* o, const float* inv,
                                          float& tn) {
    float tx = (g[0] - o[0]) * inv[0];
    float ty = (g[1] - o[1]) * inv[1];
    float tz = (g[2] - o[2]) * inv[2];
    tn = fmaxf(fmaxf(tx, ty), tz);
    float tf = fminf(fminf((g[3] - o[0]) * inv[0], (g[4] - o[1]) * inv[1]), (g[5] - o[2]) * inv[2]);
    return (tn <= tf) && (tf > HIT_EPS) && (tn < 1e30f);
}

// The per-form choices, each the fastest in probe calls on an H100
// (tools/split_probe.py, PERF.md).
// Successor prefetch: 0 none (the node loads after the vote), 1 both
// candidates' fields into registers (v1: two of three shared-memory
// slots), 2 both candidates' lines prefetched into L1 and the chosen one
// loaded after the vote (not v1). e1 and e2 load ptr + 1 ahead under 1 and 2.
// With 8 lanes per thread (one block per 8,192-lane tile) registers are
// short and the loads wait on L2; in a cluster's blocks (one lane per
// thread) the vote outlasts most loads, and a load after it beats waiting
// on both.
template <int VARIANT, int NPTR, int LPT>
__host__ __device__ constexpr int s2_prefetch() {
    if (LPT == 8) {
        if (VARIANT == S2_V0 && NPTR == 1) return 2;
        if (VARIANT == S2_E2 || VARIANT == S2_W2 || (VARIANT == S2_V0 && NPTR == 4)) return 1;
        return 0;  // e1, e3, v1, v2, v0_ilp2, v2_ilp2
    }
    return VARIANT == S2_E1 || VARIANT == S2_E2 || VARIANT == S2_E3 || VARIANT == S2_V1 ? 1 : 0;
}

// With 8 lanes per thread, the rays (o, inv) in shared memory instead of
// registers, 192 KB per 8,192 lanes: w2 and v0_ilp4, whose spills cost
// more than the shared-memory reads.
template <int VARIANT, int NPTR>
__host__ __device__ constexpr bool s2_rays_smem() {
    return VARIANT == S2_W2 || (VARIANT == S2_V0 && NPTR == 4);
}

__device__ __forceinline__ uint32_t s2_smem(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void s2_prefetch_l1(const float* p) {
    asm volatile("prefetch.L1 [%0];" :: "l"(p));
}

// the same shared-memory variable in the block of the cluster's rank r
__device__ __forceinline__ uint32_t s2_mapa(uint32_t a, int r) {
    uint32_t out;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(a), "r"(r));
    return out;
}

// arm an mbarrier's phase: one arrival, and bytes still to come by st.async
__device__ __forceinline__ void s2_arm(uint32_t bar, unsigned bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(bar), "r"(bytes) : "memory");
}

// The state of a cluster's vote: the blocks' votes by parity and rank, and
// one mbarrier per parity.
struct S2Votes {
    unsigned v[2][S2_MAX_CLUSTER];
    unsigned long long bar[2];
};

// Before the walk: the barriers initialised and armed for steps 0 and 1,
// then every block of the cluster has started.
__device__ __forceinline__ void s2_votes_init(S2Votes& sv, int csize) {
    if (threadIdx.x == 0) {
#pragma unroll
        for (int p = 0; p < 2; ++p) {
            asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                         :: "r"(s2_smem(&sv.bar[p])) : "memory");
        }
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
#pragma unroll
        for (int p = 0; p < 2; ++p) s2_arm(s2_smem(&sv.bar[p]), 4u * csize);
    }
    cg::this_cluster().sync();
}

// The tile's vote of each pointer k (bit k) at step it: whether any lane
// of the tile hit. CLUSTER: each block's vote goes by st.async into slot
// [parity][rank] of every block's votes and completes that block's
// mbarrier of the parity, which the block waits on (a cluster barrier per
// step instead ran slower on every form, PERF.md); a block sends the next
// vote of a parity only after every block has voted in between, so after
// they all read this one; thread 0 re-arms the barrier for step it + 2.
template <bool CLUSTER, int NPTR>
__device__ __forceinline__ unsigned s2_vote(const int (&any)[NPTR], int it, S2Votes& sv,
                                            int rank, int csize) {
    unsigned m = 0;
#pragma unroll
    for (int k = 0; k < NPTR; ++k) m |= (__syncthreads_or(any[k]) != 0 ? 1u : 0u) << k;
    if constexpr (CLUSTER) {
        const int p = it & 1;
        const uint32_t bar = s2_smem(&sv.bar[p]);
        if ((int)threadIdx.x < csize) {
            asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.u32 "
                         "[%0], %1, [%2];"
                         :: "r"(s2_mapa(s2_smem(&sv.v[p][rank]), threadIdx.x)), "r"(m),
                            "r"(s2_mapa(bar, threadIdx.x))
                         : "memory");
        }
        uint32_t done = 0;
        while (!done) {
            asm volatile("{\n.reg .pred q;\n"
                         "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 q, [%1], %2;\n"
                         "selp.u32 %0, 1, 0, q;\n}\n"
                         : "=r"(done) : "r"(bar), "r"((it >> 1) & 1) : "memory");
        }
        m = 0;
        for (int r = 0; r < csize; ++r) m |= sv.v[p][r];
        if (threadIdx.x == 0) s2_arm(bar, 4u * csize);
    }
    return m;
}

// One tile per block (CLUSTER false) or per cluster of csize blocks, each
// block's tile / csize lanes LPT to a thread; RSMEM: the rays in dynamic
// shared memory (6 planes of the block's lanes).
template <int VARIANT, int NPTR, int LPT, bool CLUSTER, bool RSMEM>
__global__ void __launch_bounds__(S2_MAX_THREADS) extract_ab_kernel(
    const float* __restrict__ nodes, int m_pad, int n_iters, const float* __restrict__ ray_o,
    const float* __restrict__ ray_d, float* __restrict__ out, int tile, int csize) {
    static_assert(VARIANT != S2_V1 || NPTR == 1, "v1 is built with one pointer");
    constexpr int PF = s2_prefetch<VARIANT, NPTR, LPT>();
    static_assert(VARIANT != S2_V1 || PF != 2, "v1 stages its slot, it has no L1 prefetch");
    __shared__ float staged[3][SLOT_F];  // v1: the slots in turn
    __shared__ __align__(8) S2Votes sv;  // CLUSTER
    extern __shared__ float s2_rays[];   // RSMEM
    int group = blockIdx.x, rank = 0;
    if constexpr (CLUSTER) {
        rank = (int)cg::this_cluster().block_rank();
        group = blockIdx.x / csize;
    }
    const int lanes = tile / csize;
    const size_t base = (size_t)group * tile + (size_t)rank * lanes + threadIdx.x;
    constexpr int LR = RSMEM ? 1 : LPT;  // lanes whose rays a thread holds in registers
    float o[LR][3], inv[LR][3], acc[LPT];
#pragma unroll
    for (int j = 0; j < LPT; ++j) {
        size_t lane = base + (size_t)j * blockDim.x;
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            float ok = ray_o[3 * lane + k];
            float ik = k1_safe_inv(ray_d[3 * lane + k]);
            if constexpr (RSMEM) {
                s2_rays[k * lanes + j * blockDim.x + threadIdx.x] = ok;
                s2_rays[(3 + k) * lanes + j * blockDim.x + threadIdx.x] = ik;
            } else {
                o[j][k] = ok;
                inv[j][k] = ik;
            }
        }
        acc[j] = 0.0f;
    }
    int ptr[NPTR];
    float f[NPTR][9], g[9];  // the fields at each pointer; w2's second slot
    // v1: the slot in turn that holds ptr[0]'s fields; its first warp fills
    // the slots, and every thread reads them
    int cur = 0;
    auto stage_v1 = [&](int slot, int at) {
        if (threadIdx.x < SLOT_F) staged[slot][threadIdx.x] = __ldg(nodes + (size_t)at * SLOT_F + threadIdx.x);
        __syncthreads();
#pragma unroll
        for (int i = 0; i < 9; ++i) f[0][i] = staged[slot][i];
    };
    auto fetch = [&](int k) {  // ptr[k]'s fields, loaded now
        if (VARIANT == S2_V1) {
            stage_v1(0, ptr[0]);
        } else {
            s2_fetch<VARIANT>(nodes, ptr[k], f[k]);
        }
        if (VARIANT == S2_W2 && k == 0) s2_fields_scalar(nodes, s2_slot2(ptr[0]), g);
    };
#pragma unroll
    for (int k = 0; k < NPTR; ++k) ptr[k] = 7 * k;
    if (VARIANT != S2_E0 && PF > 0) {
#pragma unroll
        for (int k = 0; k < NPTR; ++k) fetch(k);
    }
    if constexpr (CLUSTER) s2_votes_init(sv, csize);

    for (int it = 0; it < n_iters; ++it) {
        if (VARIANT == S2_E0) {
            float lo_x = 0.1f * (float)ptr[0];
#pragma unroll
            for (int j = 0; j < LPT; ++j) acc[j] = acc[j] + lo_x;
            ptr[0] = s2_wrap(ptr[0] + 1, m_pad);
            continue;
        }
        if (PF == 0) {  // the node of this step, loaded now
#pragma unroll
            for (int k = 0; k < NPTR; ++k) fetch(k);
        }
        if (VARIANT == S2_E1 || VARIANT == S2_E2) {
            // the next slot is ptr + 1: under a prefetch its fields load
            // while this step adds
            int nxt = s2_wrap(ptr[0] + 1, m_pad);
            float fn[9];
            if (PF > 0) s2_fetch<VARIANT>(nodes, nxt, fn);
            float v = f[0][0];
            if (VARIANT == S2_E2) {  // Python's sum(): 0 + f0 + f1 + ... in order
                v = 0.0f;
#pragma unroll
                for (int i = 0; i < 9; ++i) v = v + f[0][i];
            }
#pragma unroll
            for (int j = 0; j < LPT; ++j) acc[j] = acc[j] + v;
            ptr[0] = nxt;
            if (PF > 0) {
#pragma unroll
                for (int i = 0; i < 9; ++i) f[0][i] = fn[i];
            }
            continue;
        }
        // pointer k's next slot: ptr + 1 where take, else the skip (e3: ptr + 2)
        auto next = [&](int k, bool take) {
            return s2_wrap(take ? ptr[k] + 1 : (VARIANT == S2_E3 ? ptr[k] + 2 : (int)f[k][6]),
                           m_pad);
        };
        // PF 1: both candidates' fields, PF 2: their lines, before the tests
        float fa[NPTR][9], fb[NPTR][9], ga[9], gb[9];
#pragma unroll
        for (int k = 0; k < NPTR; ++k) {
            if (PF == 1 && VARIANT != S2_V1) {
                s2_fetch<VARIANT>(nodes, next(k, true), fa[k]);
                s2_fetch<VARIANT>(nodes, next(k, false), fb[k]);
            } else if (PF == 2) {
                s2_prefetch_l1(nodes + (size_t)next(k, true) * SLOT_F);
                s2_prefetch_l1(nodes + (size_t)next(k, false) * SLOT_F);
            }
        }
        if (VARIANT == S2_W2 && PF == 1) {
            s2_fields_scalar(nodes, s2_slot2(next(0, true)), ga);
            s2_fields_scalar(nodes, s2_slot2(next(0, false)), gb);
        } else if (VARIANT == S2_W2 && PF == 2) {
            s2_prefetch_l1(nodes + (size_t)s2_slot2(next(0, true)) * SLOT_F);
            s2_prefetch_l1(nodes + (size_t)s2_slot2(next(0, false)) * SLOT_F);
        }
        float pre = 0.0f;  // v1 under PF 1: the first warp loads both candidates' slots
        if (VARIANT == S2_V1 && PF == 1 && threadIdx.x < 2 * SLOT_F)
            pre = __ldg(nodes + (size_t)next(0, threadIdx.x < SLOT_F) * SLOT_F +
                        threadIdx.x % SLOT_F);
        int any[NPTR];
#pragma unroll
        for (int k = 0; k < NPTR; ++k) {
            any[k] = 0;
#pragma unroll
            for (int j = 0; j < LPT; ++j) {
                float oj[3], ij[3];
#pragma unroll
                for (int q = 0; q < 3; ++q) {
                    if constexpr (RSMEM) {
                        oj[q] = s2_rays[q * lanes + j * blockDim.x + threadIdx.x];
                        ij[q] = s2_rays[(3 + q) * lanes + j * blockDim.x + threadIdx.x];
                    } else {
                        oj[q] = o[j][q];
                        ij[q] = inv[j][q];
                    }
                }
                float tn;
                bool hit;
                if (VARIANT == S2_E3) {
                    float lo_x = f[k][0];
                    float tx0 = (lo_x - oj[0]) * ij[0];
                    float ty0 = (lo_x - oj[1]) * ij[1];
                    float tz0 = (lo_x - oj[2]) * ij[2];
                    tn = fmaxf(fmaxf(tx0, ty0), tz0);
                    hit = tn < 1e30f;
                } else {
                    hit = s2_box(&f[k][0], &f[k][3], oj, ij, tn);
                }
                if (VARIANT == S2_W2) {
                    float tn2;
                    bool hit2 = s2_box_w2(g, oj, ij, tn2);
                    hit = hit || hit2;
                    acc[j] = acc[j] + (hit2 ? tn2 : 0.0f);
                }
                any[k] |= hit;
                acc[j] = acc[j] + (hit ? tn : 0.0f);
            }
        }
        // v1 under PF 1: the loaded slots go in the two slots not in turn
        // (the block read the one in turn before the last vote)
        if (VARIANT == S2_V1 && PF == 1 && threadIdx.x < 2 * SLOT_F)
            staged[(cur + (threadIdx.x < SLOT_F ? 1 : 2)) % 3][threadIdx.x % SLOT_F] = pre;
        unsigned tile_hit = s2_vote<CLUSTER, NPTR>(any, it, sv, rank, csize);
#pragma unroll
        for (int k = 0; k < NPTR; ++k) {
            bool take = (tile_hit >> k) & 1u;  // e3: ptr + 1 on a tile hit
            if (VARIANT != S2_E3) take = take && !(f[k][8] > 0.0f);
            ptr[k] = next(k, take);
            if (PF == 1 && VARIANT == S2_V1) {
                cur = (cur + (take ? 1 : 2)) % 3;
#pragma unroll
                for (int i = 0; i < 9; ++i) f[k][i] = staged[cur][i];
            } else if (PF == 1) {
#pragma unroll
                for (int i = 0; i < 9; ++i) f[k][i] = take ? fa[k][i] : fb[k][i];
                if (VARIANT == S2_W2 && k == 0) {
#pragma unroll
                    for (int i = 0; i < 9; ++i) g[i] = take ? ga[i] : gb[i];
                }
            } else if (PF == 2) {
                fetch(k);  // the chosen node, from L1
            }
        }
    }
#pragma unroll
    for (int j = 0; j < LPT; ++j) out[base + (size_t)j * blockDim.x] = acc[j];
}

typedef void (*S2Kernel)(const float*, int, int, const float*, const float*, float*, int, int);

// a built kernel and whether it keeps the rays in shared memory
struct S2Form {
    S2Kernel fn;
    bool rays_smem;
};

// 8 lanes per thread only in the one-block form (a cluster's blocks hold
// at most 4,096 lanes)
template <int VARIANT, int NPTR, bool CLUSTER>
static S2Form s2_by_lpt(int lpt) {
    constexpr bool RS = s2_rays_smem<VARIANT, NPTR>();
    switch (lpt) {
        case 1: return {extract_ab_kernel<VARIANT, NPTR, 1, CLUSTER, false>, false};
        case 2: return {extract_ab_kernel<VARIANT, NPTR, 2, CLUSTER, false>, false};
        case 4: return {extract_ab_kernel<VARIANT, NPTR, 4, CLUSTER, false>, false};
        case 8:
            if constexpr (CLUSTER) return {nullptr, false};
            else return {extract_ab_kernel<VARIANT, NPTR, 8, false, RS>, RS};
        default: return {nullptr, false};
    }
}

template <int VARIANT, int NPTR>
static S2Form s2_form(int lpt, bool cluster) {
    return cluster ? s2_by_lpt<VARIANT, NPTR, true>(lpt) : s2_by_lpt<VARIANT, NPTR, false>(lpt);
}

// the built forms: every variant with one pointer, v0 with 2 and 4, v2 with 2
static S2Form s2_kernel(int variant, int n_ptr, int lpt, bool cluster) {
    switch (variant * 10 + n_ptr) {
        case S2_E0 * 10 + 1: return s2_form<S2_E0, 1>(lpt, cluster);
        case S2_E1 * 10 + 1: return s2_form<S2_E1, 1>(lpt, cluster);
        case S2_E2 * 10 + 1: return s2_form<S2_E2, 1>(lpt, cluster);
        case S2_E3 * 10 + 1: return s2_form<S2_E3, 1>(lpt, cluster);
        case S2_V0 * 10 + 1: return s2_form<S2_V0, 1>(lpt, cluster);
        case S2_V1 * 10 + 1: return s2_form<S2_V1, 1>(lpt, cluster);
        case S2_V2 * 10 + 1: return s2_form<S2_V2, 1>(lpt, cluster);
        case S2_W2 * 10 + 1: return s2_form<S2_W2, 1>(lpt, cluster);
        case S2_V0 * 10 + 2: return s2_form<S2_V0, 2>(lpt, cluster);
        case S2_V0 * 10 + 4: return s2_form<S2_V0, 4>(lpt, cluster);
        case S2_V2 * 10 + 2: return s2_form<S2_V2, 2>(lpt, cluster);
        default: return {nullptr, false};
    }
}

extern "C" int s2_cluster_size(int tiles, int tile) {
    int dev = 0, sms = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
        return -1;
    for (int c = S2_MAX_CLUSTER; c > 1; c /= 2) {
        if ((long long)tiles * c <= sms && tile % (128 * c) == 0) return c;
    }
    return 1;
}

extern "C" int s2_extract_ab(int variant, int n_ptr, const float* nodes, int m_pad, int n_iters,
                             const float* o, const float* d, float* out, int n, int tile,
                             void* stream) {
    if (tile <= 0 || tile % 128 != 0 || tile > 8 * S2_MAX_THREADS || n <= 0 || n % tile != 0 ||
        m_pad <= 7 * (n_ptr - 1) || n_iters < 0)
        return (int)cudaErrorInvalidValue;
    int csize = s2_cluster_size(n / tile, tile);
    if (csize < 1) return (int)cudaErrorInvalidDevice;
    int lanes = tile / csize;
    int lpt = 1;
    while (lpt < 8 && lanes > lpt * S2_MAX_THREADS) lpt *= 2;
    S2Form form = s2_kernel(variant, n_ptr, lpt, csize > 1);
    S2Kernel kernel = form.fn;
    if (kernel == nullptr) return (int)cudaErrorInvalidValue;
    size_t smem = form.rays_smem ? 6 * sizeof(float) * lanes : 0;
    if (smem > 0) {
        cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = csize;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(n / tile * csize);
    cfg.blockDim = dim3(lanes / lpt);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = (cudaStream_t)stream;
    cfg.attrs = &attr;
    cfg.numAttrs = csize > 1 ? 1 : 0;
    cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, nodes, m_pad, n_iters, o, d, out, tile, csize);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}
