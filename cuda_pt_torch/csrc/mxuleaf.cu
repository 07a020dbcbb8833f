// Kernel S4: the leaf triangle test, scalar and on the tensor cores. Each ray
// tests the 8 triangles of each of nleaf leaves and keeps the least hit t
// (inf where it hits none), in two forms over the same triangles:
//   scalar  Moller-Trumbore per triangle from the leaf's row of 9 fields x 8
//           (a, e1, e2), in the plain version's operation order: bit-equal
//           to it (-fmad=false).
//   mxu     the test written as a product: det, u_num, v_num and t_num of a
//           triangle are dot products of the ray's features
//           f = (o x d, d, o, 1, 0 x 6) with 16 constants of the triangle, so
//           one (rays, 16) x (16, 32) product per leaf gives the 4 numbers of
//           its 8 triangles, and an epilogue tests them.
//
// Replaces the TPU kernels of scripts/exp_r5_mxuleaf.py: kern_scalar (:99)
// and kern_mxu (:139), pallas_call at :176. The TPU's dot_general at
// Precision.HIGHEST becomes Hopper's warpgroup product wgmma.mma_async
// m64n64k8 in TF32, as 3xTF32: each f32 operand x is split into hi =
// tf32(x) (round to nearest, ties away: cvt.rna's rounding) and lo =
// tf32(x - hi), and lo*hi + hi*lo + hi*hi (smallest first, each summed in
// f32 by the tensor core) recovers about the 24-bit significand of f32
// products; the lo*lo term dropped is below f32's rounding. A 1xTF32 build
// (hi*hi alone, 10-bit significands) sits beside it as an A/B.
//
// mxu's design, for what bounds it on an H100 (the tensor cores' TF32 rate
// at the card's scale; latency at the reference's 4,096 rays):
//   - the coefficients are split into hi and lo once per call, by a
//     prologue kernel (s4_split_kernel) that writes them in the layout the
//     product reads, a stage of S4W_LPS leaves (N = 64 coefficient rows) at
//     a time; it also sets every ray's least t to +inf;
//   - the grid is ray tiles x leaf chunks, so that 4,096 rays still fill
//     the card's SMs; the chunks' least t combine by an atomicMin on the
//     int bits of a non-negative float (or +inf), which orders as the float
//     does; a minimum does not depend on the order of its operands, so the
//     result is the reference's per-leaf update;
//   - a block (S4W_WGS warpgroups, 128 rays, S4W_MIN_BLOCKS per SM) streams its
//     chunk's stages into shared memory through a ring of S4W_STAGES
//     buffers, each filled by one bulk copy (cp.async.bulk, completed on an
//     mbarrier), so each leaf is read once per block;
//   - each warpgroup keeps its 64 rays' features, split, in registers (A)
//     and reads the coefficients (B, K-major, as TF32 requires) from shared
//     memory through a matrix descriptor; while it filters a stage, the
//     SM's other warpgroups keep the tensor cores busy;
//   - the epilogue runs a divide-free filter on the accumulators (s4_pass)
//     and the reference's own arithmetic (the divide, the five tests of
//     exp_r5_mxuleaf.py:158-164) only on a candidate that passes it.
// Bound on an H100: operations. scalar: 45 f32 per triangle and ray; mxu:
// 3 x 2 x 32 x 16 tensor-core flops per leaf and ray at the TF32 rate; its
// filter is 14 operations per triangle and ray (3 integer sign folds, 5 f32
// products and sums, 6 compares), with no divide.
//
// C entry points:
//   s4_mxuleaf(form, table, nleaf, o, d, out, n, scratch, stream) -> out
//              (n,); form 0 scalar (table: rows (nleaf, 128)), 1 mxu
//              3xTF32, 2 mxu 1xTF32 (table: (nleaf * 32, 16); scratch:
//              the split stages, s4_mxuleaf_scratch(nleaf) floats; two
//              launches, s4_split_kernel then leaf_mxu_kernel); n a
//              multiple of 128; returns cudaErrorInvalidValue for another
//              form or n, else cudaGetLastError() right after the launches.
//   s4_mxuleaf_scratch(nleaf) -> the floats of the mxu forms' scratch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define S4_NP8 8          // triangles per leaf
#define S4_ROW 128        // floats per scalar leaf row
#define S4_THREADS 128    // threads per block of the scalar form
// the mxu form
#define S4W_WGS 2                        // warpgroups per block, 64 rays each
#define S4W_THREADS (128 * S4W_WGS)
#define S4W_RAYS (64 * S4W_WGS)          // rays per block
#define S4W_LPS 2                        // leaves per stage, a multiple of 2
#define S4W_CB (S4W_LPS / 2)             // wgmma column blocks of N = 64 per stage
#define S4W_N (32 * S4W_LPS)             // coefficient rows per stage
#define S4W_HALF (2 * S4W_N * 8)         // floats of a stage's hi (or lo) half: 2 k steps
#define S4W_STAGE (2 * S4W_HALF)         // floats per stage, hi then lo (8 KB a leaf pair)
#define S4W_STAGES 4                     // shared-memory ring
#define S4W_MIN_BLOCKS 3                 // resident blocks per SM (78 registers)

__device__ __forceinline__ float s4_fdet(float det) {
    return 1.0f / (fabsf(det) < 1e-12f ? 1e-12f : det);
}

__global__ void __launch_bounds__(S4_THREADS) leaf_scalar_kernel(const float* __restrict__ prow,
                                                                  int nleaf,
                                                                  const float* __restrict__ ray_o,
                                                                  const float* __restrict__ ray_d,
                                                                  float* __restrict__ out) {
    size_t i = (size_t)blockIdx.x * S4_THREADS + threadIdx.x;
    float ox = ray_o[3 * i], oy = ray_o[3 * i + 1], oz = ray_o[3 * i + 2];
    float dx = ray_d[3 * i], dy = ray_d[3 * i + 1], dz = ray_d[3 * i + 2];
    float t_best = INFINITY;
    for (int lf = 0; lf < nleaf; ++lf) {
        // the row is the same for every thread: broadcast loads
        const float* row = prow + (size_t)lf * S4_ROW;
#pragma unroll
        for (int k = 0; k < S4_NP8; ++k) {
            const float* p = row + 9 * k;
            float ax = __ldg(p), ay = __ldg(p + 1), az = __ldg(p + 2);
            float ux = __ldg(p + 3), uy = __ldg(p + 4), uz = __ldg(p + 5);
            float vx = __ldg(p + 6), vy = __ldg(p + 7), vz = __ldg(p + 8);
            float hx = dy * vz - dz * vy;
            float hy = dz * vx - dx * vz;
            float hz = dx * vy - dy * vx;
            float aa = ux * hx + uy * hy + uz * hz;
            float fdet = s4_fdet(aa);
            float sx = ox - ax, sy = oy - ay, sz = oz - az;
            float u = fdet * (sx * hx + sy * hy + sz * hz);
            float qx = sy * uz - sz * uy;
            float qy = sz * ux - sx * uz;
            float qz = sx * uy - sy * ux;
            float v = fdet * (dx * qx + dy * qy + dz * qz);
            float t = fdet * (vx * qx + vy * qy + vz * qz);
            bool ok = (fabsf(aa) > 1e-12f) && (u >= 0.0f) && (v >= 0.0f) && (u + v <= 1.0f) &&
                      (t > 1e-4f);
            t_best = (ok && t < t_best) ? t : t_best;
        }
    }
    out[i] = t_best;
}

// feature f of a ray (exp_r5_mxuleaf.py:144-146): o x d, d, o, 1, then 0
__device__ __forceinline__ float s4_feature(int f, const float o[3], const float d[3]) {
    switch (f) {
        case 0: return o[1] * d[2] - o[2] * d[1];
        case 1: return o[2] * d[0] - o[0] * d[2];
        case 2: return o[0] * d[1] - o[1] * d[0];
        case 3: return d[0];
        case 4: return d[1];
        case 5: return d[2];
        case 6: return o[0];
        case 7: return o[1];
        case 8: return o[2];
        case 9: return 1.0f;
        default: return 0.0f;
    }
}

// tf32(x) as f32 bits: the 10-bit significand rounded to nearest, ties
// away from zero (cvt.rna.tf32.f32), by adding half an ulp of TF32 to the
// magnitude and clearing the 13 low bits
__device__ __forceinline__ unsigned s4_tf32_bits(float x) {
    return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// The prologue: coef (nleaf * 32, 16) split into TF32 hi and lo, stage by
// stage, in the product's shared-memory layout. A stage is S4W_LPS leaves:
// hi then lo; each half is two k steps of 8 features; each k step is the
// N = S4W_N coefficient rows in core matrices of 8 rows x 4 features (128
// B; K-major, no swizzle), the two core matrices of a row group along K
// 128 B apart and row groups 256 B apart. Stage column 32 L + 8 q + c8
// holds number q (det, u_num, v_num, t_num) of triangle c8 of the stage's
// leaf L (coefficient row 4 c8 + q), so that the accumulator gives a
// thread, in columns 8 j + 2 (lane % 4) + e, the four numbers of triangles
// 2 (lane % 4) + e. Leaves past nleaf are zero (det 0: no hit). out[i] =
// +inf for the chunks' atomicMin.
__global__ void s4_split_kernel(const float* __restrict__ coef, int nleaf, int nst,
                                float* __restrict__ split, float* __restrict__ out, int n) {
    size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i < (size_t)n) out[i] = INFINITY;
    if (i >= (size_t)nst * S4W_STAGE) return;
    int st = (int)(i / S4W_STAGE), r = (int)(i % S4W_STAGE);
    int hl = r / S4W_HALF;
    r %= S4W_HALF;
    int ks = r / (S4W_N * 8);
    r %= S4W_N * 8;
    int cm = r / 32, w = r % 32;  // core matrix (row group, k chunk), its element
    int col = (cm >> 1) * 8 + w / 4, kk = (cm & 1) * 4 + w % 4;
    int leaf = st * S4W_LPS + col / 32, c = col % 32;
    float x = 0.0f;
    if (leaf < nleaf) x = coef[((size_t)leaf * 32 + 4 * (c % 8) + c / 8) * 16 + ks * 8 + kk];
    unsigned hi = s4_tf32_bits(x);
    split[i] = __uint_as_float(hl == 0 ? hi : s4_tf32_bits(x - __uint_as_float(hi)));
}

__device__ __forceinline__ uint32_t s4_smem(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void s4_mbar_wait(uint32_t bar, unsigned parity) {
    uint32_t done = 0;
    while (!done) {
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    }
}

// one stage (bytes of it) from device memory into shared memory, completed
// on the stage's mbarrier (issued by one thread)
__device__ __forceinline__ void s4_load_stage(uint32_t dst, const float* src, unsigned bytes,
                                              uint32_t bar) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(bar), "r"(bytes) : "memory");
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
                 "[%0], [%1], %2, [%3];"
                 :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// the matrix descriptor of a K-major k step at shared address a: core
// matrices along K 128 B apart (leading byte offset), row groups along N
// 256 B apart (stride byte offset), no swizzle
__device__ __forceinline__ uint64_t s4_desc(uint32_t a) {
    return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
           ((uint64_t)(256 >> 4) << 32);
}

// d (+)= a (64 x 8 TF32, registers) * b (8 x 64 TF32, shared memory); the
// accumulator layout: d[4 j + 2 h + e] = (row 16 warp + lane / 4 + 8 h,
// column 8 j + 2 (lane % 4) + e)
__device__ __forceinline__ void s4_wgmma(float (&d)[32], const unsigned (&a)[4], uint64_t b,
                                         int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// The divide-free filter: false only where the exact test (the script's,
// in the epilogue below) rejects the candidate. With a = |det|, the signs
// of det folded into su = u_num sgn(det), sv, st, eps = 2^-24 and fdet =
// fl(1 / det) normal (a <= 2^125; larger a passes):
//   a > 1e-12    the exact test's own clause;
//   su >= -m, m = a 2^-20 (exact: a power-of-two scale of a normal):
//                u = fl(fdet u_num) >= 0 with su < 0 only where the product
//                rounds to -0, |fdet u_num| <= 2^-150 (2^-126 with
//                flush-to-zero), so |su| <= 2^-126 a / (1 - eps) < m; sv
//                alike;
//   su + sv <= a + m: u, v >= (su / a)(1 - eps)^2 - 2^-149 (relative
//                rounding of fdet and of the product, absolute below the
//                normals), so fl(u + v) <= 1 gives su + sv <= a (1 + 3.01
//                eps) + a 2^-147; fl(su + sv) adds one eps and fl(a + m) =
//                fl(a (1 + 2^-20)) >= a (1 + 14.9 eps);
//   st > a tmin, tmin = fl(1e-4f (1 - 2^-20)): t > 1e-4f is normal, so st
//                / a > 1e-4f / (1 + eps)^2 while fl(a tmin) <= a 1e-4f (1 -
//                2^-20)(1 + eps)^2, which is smaller since (1 - 16 eps)(1 +
//                eps)^4 < 1;
//   st < a tgate, tgate = fl(t_best (1 + 2^-20)) (+inf with t_best):
//                t < t_best gives st / a < t_best / (1 - eps)^2 while
//                fl(a tgate) >= a t_best (1 + 16 eps)(1 - eps)^2, larger
//                since (1 + 16 eps)(1 - eps)^4 > 1 (an overflow gives +inf,
//                which passes; st is finite where t is).
// NaN in det fails a > 1e-12 in both tests. So the filter never rejects a
// triangle the exact test accepts, and every result is the exact test's.
#define S4_TMIN (1e-4f * (1.0f - 0x1p-20f))
__device__ __forceinline__ bool s4_pass(float det, float u_n, float v_n, float t_n,
                                        float tgate) {
    float a = fabsf(det);
    unsigned sg = __float_as_uint(det) & 0x80000000u;
    float su = __uint_as_float(__float_as_uint(u_n) ^ sg);
    float sv = __uint_as_float(__float_as_uint(v_n) ^ sg);
    float st = __uint_as_float(__float_as_uint(t_n) ^ sg);
    float m = a * 0x1p-20f;
    return a > 1e-12f && (a > 0x1p125f || (su >= -m && sv >= -m && su + sv <= a + m &&
                                           st > a * S4_TMIN && st < a * tgate));
}

// One stage's product into acc: per k step, lo*hi, hi*lo, hi*hi (1xTF32:
// hi*hi), the first one overwriting acc; each 64 columns of the stage (two
// leaves) a wgmma of N = 64 into acc[cb], row groups 8 * 256 B apart;
// committed as one group.
template <bool SPLIT3>
__device__ __forceinline__ void s4_issue(float (&acc)[S4W_CB][32], const unsigned (&a_hi)[2][4],
                                         const unsigned (&a_lo)[2][4], uint32_t hi) {
    const uint32_t lo = hi + S4W_HALF * 4;
    __syncwarp();
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
#pragma unroll
        for (int cb = 0; cb < S4W_CB; ++cb) {
            const uint32_t off = ks * S4W_N * 8 * 4 + cb * 64 * 32;
            if (SPLIT3) {
                s4_wgmma(acc[cb], a_lo[ks], s4_desc(hi + off), ks);
                s4_wgmma(acc[cb], a_hi[ks], s4_desc(lo + off), 1);
            }
            s4_wgmma(acc[cb], a_hi[ks], s4_desc(hi + off), SPLIT3 || ks > 0);
        }
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void s4_wait(float (&acc)[S4W_CB][32]) {
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
#pragma unroll
    for (int cb = 0; cb < S4W_CB; ++cb)
#pragma unroll
        for (int j = 0; j < 32; ++j) asm volatile("" : "+f"(acc[cb][j]) :: "memory");
}

// The filter, then the script's epilogue (:158-164) on what passes, for
// the thread's rays g and g + 8 (h) and its triangles 2 (lane % 4) + e of
// the stage's leaves 2 cb + L: acc[cb][16 L + 4 q + 2 h + e] is number q
// (det, u_num, v_num, t_num) of the triangle. The filter's verdicts are
// gathered into a mask first, so that the exact test (its divide above
// all) stays behind one branch that few threads take.
__device__ __forceinline__ void s4_epilogue(const float (&acc)[S4W_CB][32], float (&t_best)[2],
                                            float (&tgate)[2]) {
    unsigned pm = 0;
#pragma unroll
    for (int k = 0; k < 4 * S4W_LPS; ++k) {
        const int cb = k >> 3, c0 = 16 * ((k >> 2) & 1) + (k & 3);
        pm |= (unsigned)s4_pass(acc[cb][c0], acc[cb][c0 + 4], acc[cb][c0 + 8], acc[cb][c0 + 12],
                                tgate[(k >> 1) & 1]) << k;
    }
    if (pm == 0) return;
#pragma unroll
    for (int k = 0; k < 4 * S4W_LPS; ++k) {
        if (!((pm >> k) & 1)) continue;
        const int cb = k >> 3, c0 = 16 * ((k >> 2) & 1) + (k & 3), h = (k >> 1) & 1;
        float det = acc[cb][c0];
        float fdet = s4_fdet(det);
        float u = fdet * acc[cb][c0 + 4], v = fdet * acc[cb][c0 + 8], t = fdet * acc[cb][c0 + 12];
        bool ok = (fabsf(det) > 1e-12f) && (u >= 0.0f) && (v >= 0.0f) && (u + v <= 1.0f) &&
                  (t > 1e-4f);
        if (ok && t < t_best[h]) {
            t_best[h] = t;
            tgate[h] = t * (1.0f + 0x1p-20f);
        }
    }
}

// A block is S4W_WGS warpgroups of 64 rays over the stages [st0, st0 +
// cnt) of its leaf chunk: per stage a warpgroup waits for the stage's
// buffer, runs its product and filters it, while the block's other
// warpgroups (and the SM's other block) keep the tensor cores busy. The
// stages stream through a ring in shared memory; the last warpgroup to
// release a buffer refills it (an atomic count per buffer, so no
// warpgroup waits for another).
template <bool SPLIT3>
__global__ void __launch_bounds__(S4W_THREADS, S4W_MIN_BLOCKS) leaf_mxu_kernel(const float* __restrict__ split,
                                                                   int nst, int spc,
                                                                   const float* __restrict__ ray_o,
                                                                   const float* __restrict__ ray_d,
                                                                   int n, float* __restrict__ out) {
    __shared__ __align__(1024) float buf[S4W_STAGES][S4W_STAGE];
    __shared__ __align__(8) uint64_t full[S4W_STAGES];
    __shared__ unsigned released[S4W_STAGES];
    constexpr unsigned BYTES = (SPLIT3 ? 2 : 1) * S4W_HALF * 4;  // 1xTF32 reads hi alone
    const int tid = threadIdx.x, lane = tid & 31;
    const int g = lane >> 2, tq = lane & 3;
    const int st0 = blockIdx.y * spc;
    const int cnt = min(spc, nst - st0);
    if (tid == 0) {
#pragma unroll
        for (int s = 0; s < S4W_STAGES; ++s) {
            asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(s4_smem(&full[s]))
                         : "memory");
            released[s] = 0;
        }
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
    if (tid == 0) {
        for (int s = 0; s < S4W_STAGES && s < cnt; ++s)
            s4_load_stage(s4_smem(buf[s]), split + (size_t)(st0 + s) * S4W_STAGE, BYTES,
                          s4_smem(&full[s]));
    }
    // A: thread lane of warp w of its warpgroup holds, per k step ks,
    // features 8 ks + tq (+ 4) of rays g (+ 8) of the warp's 16: a[0] = (g,
    // tq), a[1] = (g + 8, tq), a[2] = (g, tq + 4), a[3] = (g + 8, tq + 4),
    // each split into hi and lo
    const size_t ray0 = (size_t)blockIdx.x * S4W_RAYS + (tid >> 5) * 16 + g;
    unsigned a_hi[2][4], a_lo[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        size_t r = ray0 + 8 * h;
        bool valid = r < (size_t)n;
        size_t rr = valid ? r : 0;
        float o[3] = {ray_o[3 * rr], ray_o[3 * rr + 1], ray_o[3 * rr + 2]};
        float d[3] = {ray_d[3 * rr], ray_d[3 * rr + 1], ray_d[3 * rr + 2]};
#pragma unroll
        for (int ks = 0; ks < 2; ++ks)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
                float x = valid ? s4_feature(ks * 8 + tq + 4 * c, o, d) : 0.0f;
                unsigned hi = s4_tf32_bits(x);
                a_hi[ks][h + 2 * c] = hi;
                a_lo[ks][h + 2 * c] = s4_tf32_bits(x - __uint_as_float(hi));
            }
    }
    float t_best[2] = {INFINITY, INFINITY}, tgate[2] = {INFINITY, INFINITY};
    for (int it = 0; it < cnt; ++it) {
        const int b = it % S4W_STAGES;
        float acc[S4W_CB][32];
        s4_mbar_wait(s4_smem(&full[b]), (it / S4W_STAGES) & 1);
        s4_issue<SPLIT3>(acc, a_hi, a_lo, s4_smem(buf[b]));
        s4_wait(acc);
        // this warpgroup has read the buffer: the last to release it loads
        // stage it + S4W_STAGES there
        if ((tid & 127) == 0 && atomicAdd(&released[b], 1u) % S4W_WGS == S4W_WGS - 1 &&
            it + S4W_STAGES < cnt) {
            asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
            s4_load_stage(s4_smem(buf[b]), split + (size_t)(st0 + it + S4W_STAGES) * S4W_STAGE,
                          BYTES, s4_smem(&full[b]));
        }
        s4_epilogue(acc, t_best, tgate);
    }
    // the least t of the quad's 8 triangle slots, then across leaf chunks
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        float tb = t_best[h];
        tb = fminf(tb, __shfl_xor_sync(0xffffffffu, tb, 1));
        tb = fminf(tb, __shfl_xor_sync(0xffffffffu, tb, 2));
        size_t r = ray0 + 8 * h;
        if (tq == 0 && r < (size_t)n && tb < INFINITY) atomicMin((int*)out + r, __float_as_int(tb));
    }
}

static int s4_sm_count() {
    static int sms = 0;
    if (sms == 0) {
        int dev = 0;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        if (sms <= 0) sms = 1;
    }
    return sms;
}

extern "C" long long s4_mxuleaf_scratch(int nleaf) {
    return nleaf < 0 ? 0 : (long long)((nleaf + S4W_LPS - 1) / S4W_LPS) * S4W_STAGE;
}

extern "C" int s4_mxuleaf(int form, const float* table, int nleaf, const float* o,
                          const float* d, float* out, int n, float* scratch, void* stream) {
    if (n <= 0 || n % S4_THREADS != 0 || nleaf < 0 || form < 0 || form > 2)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    if (form == 0) {
        leaf_scalar_kernel<<<n / S4_THREADS, S4_THREADS, 0, s>>>(table, nleaf, o, d, out);
        return (int)cudaGetLastError();
    }
    if (scratch == nullptr) return (int)cudaErrorInvalidValue;
    int nst = (nleaf + S4W_LPS - 1) / S4W_LPS;
    size_t items = (size_t)nst * S4W_STAGE > (size_t)n ? (size_t)nst * S4W_STAGE : (size_t)n;
    s4_split_kernel<<<(unsigned)((items + 255) / 256), 256, 0, s>>>(table, nleaf, nst, scratch,
                                                                      out, n);
    if (nst > 0) {
        // leaf chunks so that the grid is at most one wave of resident
        // blocks where rays are few
        int tiles = (n + S4W_RAYS - 1) / S4W_RAYS;
        int want = S4W_MIN_BLOCKS * s4_sm_count() / tiles;
        int chunks = want < 1 ? 1 : (want > nst ? nst : want);
        int spc = (nst + chunks - 1) / chunks;
        dim3 grid(tiles, (nst + spc - 1) / spc);
        if (form == 1)
            leaf_mxu_kernel<true><<<grid, S4W_THREADS, 0, s>>>(scratch, nst, spc, o, d, n, out);
        else
            leaf_mxu_kernel<false><<<grid, S4W_THREADS, 0, s>>>(scratch, nst, spc, o, d, n, out);
    }
    return (int)cudaGetLastError();
}
