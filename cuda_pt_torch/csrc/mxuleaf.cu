// Kernel S4: the leaf triangle test, scalar and on the tensor cores. Each ray
// tests the 8 triangles of each of nleaf leaves and keeps the least hit t
// (inf where it hits none), in two forms over the same triangles:
//   scalar  Moller-Trumbore per triangle from the leaf's row of 9 fields x 8
//           (a, e1, e2), in the plain version's operation order: bit-equal
//           to it (-fmad=false).
//   mxu     the test written as a product: det, u_num, v_num and t_num of a
//           triangle are dot products of the ray's features
//           f = (o x d, d, o, 1, 0 x 6) with 16 constants of the triangle, so
//           one (32, 16) x (16, rays) product per leaf gives the 4 numbers of
//           its 8 triangles, and an epilogue divides by det and tests.
//
// Replaces the TPU kernels of scripts/exp_r5_mxuleaf.py: kern_scalar (:99)
// and kern_mxu (:139), pallas_call at :176. The TPU's dot_general at
// Precision.HIGHEST becomes warp-level mma.sync.aligned.m16n8k8 TF32 in
// 3xTF32: each f32 operand x is split into hi = tf32(x) (cvt.rna) and lo =
// tf32(x - hi), and hi*hi + hi*lo + lo*hi (the products smallest first, each
// summed in f32 by the tensor core) recovers about the 24-bit significand of
// f32 products; the lo*lo term dropped is below f32's rounding. A 1xTF32
// build (hi*hi alone, 10-bit significands) sits beside it as an A/B.
//
// mxu's layout. A warp takes MXU_NT tiles of 8 rays (n8) and, per leaf, its
// (32, 16) block as two m16 tiles by two k8 steps. B, the (16, 8) features
// of a ray tile, is built once in registers: thread lane holds features
// lane % 4 + {0, 4, 8, 12} of ray lane / 4. A is read from the script's
// coefficient rows (4 k + j: det, u, v, t of triangle k) so that the m16n8
// C fragment puts, in thread lane, rows g, g + 8, g + 16, g + 24 = det, u_num,
// v_num, t_num of triangle g = lane / 4, for rays 2 (lane % 4) and
// 2 (lane % 4) + 1: the epilogue is the script's (:158-164) on registers,
// and a thread keeps the least t of its triangle slot over all leaves. At
// the end three __shfl_xor_sync steps take the least over the 8 slots; a
// minimum does not depend on the order of its operands, so the result is the
// reference's per-leaf update.
//
// Bound on an H100: operations. scalar: 45 f32 per triangle and ray; mxu:
// 3 x 2 x 32 x 16 tensor-core flops per leaf and ray at the TF32 rate and an
// f32 epilogue of 14 per triangle and ray. The coefficients (2 KB a leaf)
// are read by every warp from L1 and L2; the bytes from device memory are
// the tables once, the rays and t.
//
// C entry point:
//   s4_mxuleaf(form, table, nleaf, o, d, out, n, stream) -> out (n,);
//              form 0 scalar (table: rows (nleaf, 128)), 1 mxu 3xTF32, 2 mxu
//              1xTF32 (table: (nleaf * 32, 16)); n a multiple of 128;
//              returns cudaErrorInvalidValue for another form or n, else
//              cudaGetLastError() right after the launch.

#include <cuda_runtime.h>
#include <math.h>

#define S4_NP8 8          // triangles per leaf
#define S4_ROW 128        // floats per scalar leaf row
#define S4_THREADS 128    // threads per block, both forms
#define MXU_NT 4          // ray tiles of 8 per warp
#define MXU_RAYS_PER_WARP (8 * MXU_NT)

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

__device__ __forceinline__ unsigned s4_tf32(float x) {
    unsigned r;
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
    return r;
}

// x = hi + lo to about f32's precision, both TF32
__device__ __forceinline__ void s4_split(float x, unsigned& hi, unsigned& lo) {
    hi = s4_tf32(x);
    lo = s4_tf32(x - __uint_as_float(hi));
}

// c += a (16 x 8, row) * b (8 x 8, col), TF32 in, f32 accumulate
__device__ __forceinline__ void s4_mma(float c[4], const unsigned a[4], const unsigned b[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
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

template <bool SPLIT3>
__global__ void __launch_bounds__(S4_THREADS) leaf_mxu_kernel(const float* __restrict__ coef,
                                                               int nleaf,
                                                               const float* __restrict__ ray_o,
                                                               const float* __restrict__ ray_d,
                                                               float* __restrict__ out) {
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2, tig = lane & 3;
    const size_t warp_ray = ((size_t)blockIdx.x * S4_THREADS + (threadIdx.x & ~31)) / 32 *
                            MXU_RAYS_PER_WARP;
    // B fragments, per ray tile and k step: b[0] = feature ks * 8 + tig, b[1] =
    // feature ks * 8 + tig + 4, of ray g of the tile
    unsigned b_hi[MXU_NT][2][2], b_lo[MXU_NT][2][2];
#pragma unroll
    for (int nt = 0; nt < MXU_NT; ++nt) {
        size_t r = warp_ray + nt * 8 + g;
        float o[3] = {ray_o[3 * r], ray_o[3 * r + 1], ray_o[3 * r + 2]};
        float d[3] = {ray_d[3 * r], ray_d[3 * r + 1], ray_d[3 * r + 2]};
#pragma unroll
        for (int ks = 0; ks < 2; ++ks)
#pragma unroll
            for (int h = 0; h < 2; ++h)
                s4_split(s4_feature(ks * 8 + tig + 4 * h, o, d), b_hi[nt][ks][h], b_lo[nt][ks][h]);
    }
    float t_best[MXU_NT][2];
#pragma unroll
    for (int nt = 0; nt < MXU_NT; ++nt) t_best[nt][0] = t_best[nt][1] = INFINITY;

    for (int lf = 0; lf < nleaf; ++lf) {
        // A fragments of m tile mt, k step ks: a[0] = (row g, col tig),
        // a[1] = (g + 8, tig), a[2] = (g, tig + 4), a[3] = (g + 8, tig + 4);
        // rows g, g + 8 of m tile mt are coefficient rows 4 g + 2 mt, + 1
        const float* blk = coef + ((size_t)lf * 32 + 4 * g) * 16;
        unsigned a_hi[2][2][4], a_lo[2][2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int ks = 0; ks < 2; ++ks)
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                    int row = 2 * mt + (q & 1), col = ks * 8 + tig + 4 * (q >> 1);
                    s4_split(__ldg(blk + row * 16 + col), a_hi[mt][ks][q], a_lo[mt][ks][q]);
                }
#pragma unroll
        for (int nt = 0; nt < MXU_NT; ++nt) {
            float c[2][4];
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
                c[mt][0] = c[mt][1] = c[mt][2] = c[mt][3] = 0.0f;
#pragma unroll
                for (int ks = 0; ks < 2; ++ks) {
                    if (SPLIT3) {
                        s4_mma(c[mt], a_lo[mt][ks], b_hi[nt][ks]);
                        s4_mma(c[mt], a_hi[mt][ks], b_lo[nt][ks]);
                    }
                    s4_mma(c[mt], a_hi[mt][ks], b_hi[nt][ks]);
                }
            }
            // c[0] = det (0, 1), u_num (2, 3); c[1] = v_num, t_num: of
            // triangle g, for rays 2 tig and 2 tig + 1 of tile nt
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                float det = c[0][e], u_n = c[0][2 + e], v_n = c[1][e], t_n = c[1][2 + e];
                float fdet = s4_fdet(det);
                float u = fdet * u_n, v = fdet * v_n, t = fdet * t_n;
                bool ok = (fabsf(det) > 1e-12f) && (u >= 0.0f) && (v >= 0.0f) &&
                          (u + v <= 1.0f) && (t > 1e-4f);
                t_best[nt][e] = (ok && t < t_best[nt][e]) ? t : t_best[nt][e];
            }
        }
    }
#pragma unroll
    for (int nt = 0; nt < MXU_NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            float tb = t_best[nt][e];
#pragma unroll
            for (int m = 4; m < 32; m <<= 1) tb = fminf(tb, __shfl_xor_sync(0xffffffffu, tb, m));
            if (g == 0) out[warp_ray + nt * 8 + 2 * tig + e] = tb;
        }
}

extern "C" int s4_mxuleaf(int form, const float* table, int nleaf, const float* o,
                          const float* d, float* out, int n, void* stream) {
    if (n <= 0 || n % S4_THREADS != 0 || nleaf < 0 || form < 0 || form > 2)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    if (form == 0) {
        leaf_scalar_kernel<<<n / S4_THREADS, S4_THREADS, 0, s>>>(table, nleaf, o, d, out);
    } else {
        int blocks = n / (S4_THREADS / 32 * MXU_RAYS_PER_WARP);
        if (n % (S4_THREADS / 32 * MXU_RAYS_PER_WARP) != 0) return (int)cudaErrorInvalidValue;
        if (form == 1)
            leaf_mxu_kernel<true><<<blocks, S4_THREADS, 0, s>>>(table, nleaf, o, d, out);
        else
            leaf_mxu_kernel<false><<<blocks, S4_THREADS, 0, s>>>(table, nleaf, o, d, out);
    }
    return (int)cudaGetLastError();
}
