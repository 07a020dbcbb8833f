// Native SAH BVH builder (C++17, no deps): the host-side "compile" stage.
// The port's copy of cuda_pt_tpu/accel/cpp/bvh_builder.cpp, unchanged below
// this comment, so that both packages build bit-equal trees.
//
// Re-implements the algorithm of accel/bvh_build.py in C++ for large scenes:
// 16-bin binned SAH over centroid extents with an overlap-area penalty
// (parity with the reference builder, src/impl/bvh.cu:118-272), equal-count
// fallback, primitive reordering into contiguous leaves, and the stackless
// skip-encoded linearization the traversal kernels consume.
//
// Exposed via a C ABI for ctypes; built at first use by accel/native.py
// (utils/host_build.py: g++ -O3 -march=native -std=c++17 -shared -fPIC).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kBins = 16;

struct V3 {
    float x, y, z;
    float operator[](int i) const { return i == 0 ? x : (i == 1 ? y : z); }
};

inline V3 vmin(const V3& a, const V3& b) {
    return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
inline V3 vmax(const V3& a, const V3& b) {
    return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}

struct Box {
    V3 lo{1e30f, 1e30f, 1e30f};
    V3 hi{-1e30f, -1e30f, -1e30f};
    void grow(const Box& b) {
        lo = vmin(lo, b.lo);
        hi = vmax(hi, b.hi);
    }
    float area() const {
        float dx = std::max(hi.x - lo.x, 0.f);
        float dy = std::max(hi.y - lo.y, 0.f);
        float dz = std::max(hi.z - lo.z, 0.f);
        return 2.f * (dx * dy + dy * dz + dz * dx);
    }
};

inline float overlap_area(const Box& a, const Box& b) {
    Box o;
    o.lo = vmax(a.lo, b.lo);
    o.hi = vmin(a.hi, b.hi);
    if (o.hi.x < o.lo.x || o.hi.y < o.lo.y || o.hi.z < o.lo.z) return 0.f;
    return o.area();
}

struct Builder {
    const float* lo;
    const float* hi;
    const float* cent;
    int max_leaf;
    float overlap_w;

    std::vector<float> node_min, node_max;
    std::vector<int32_t> node_child, node_base, node_count;
    std::vector<int64_t> order;
    std::vector<int64_t> scratch;
    int64_t out_pos = 0;

    Box prim_box(int64_t i) const {
        Box b;
        b.lo = {lo[3 * i], lo[3 * i + 1], lo[3 * i + 2]};
        b.hi = {hi[3 * i], hi[3 * i + 1], hi[3 * i + 2]};
        return b;
    }

    // Split idx[b..e) in place; returns mid. (SAH or equal-count fallback.)
    int64_t split(int64_t b, int64_t e) {
        V3 cmin{1e30f, 1e30f, 1e30f}, cmax{-1e30f, -1e30f, -1e30f};
        for (int64_t k = b; k < e; ++k) {
            int64_t i = scratch[k];
            V3 c{cent[3 * i], cent[3 * i + 1], cent[3 * i + 2]};
            cmin = vmin(cmin, c);
            cmax = vmax(cmax, c);
        }
        float best_cost = 1e30f;
        int best_axis = -1, best_bin = -1;
        float best_base = 0.f, best_scale = 0.f;

        for (int axis = 0; axis < 3; ++axis) {
            float ext = cmax[axis] - cmin[axis];
            if (ext < 1e-8f) continue;
            float scale = kBins * (1.f - 1e-6f) / ext;
            Box bins[kBins];
            int64_t counts[kBins] = {0};
            for (int64_t k = b; k < e; ++k) {
                int64_t i = scratch[k];
                int bi = (int)((cent[3 * i + axis] - cmin[axis]) * scale);
                bi = std::min(std::max(bi, 0), kBins - 1);
                bins[bi].grow(prim_box(i));
                counts[bi]++;
            }
            Box lbox[kBins], rbox[kBins];
            int64_t lcnt[kBins], rcnt[kBins];
            Box acc;
            int64_t c = 0;
            for (int k = 0; k < kBins; ++k) {
                acc.grow(bins[k]);
                c += counts[k];
                lbox[k] = acc;
                lcnt[k] = c;
            }
            acc = Box();
            c = 0;
            for (int k = kBins - 1; k >= 0; --k) {
                acc.grow(bins[k]);
                c += counts[k];
                rbox[k] = acc;
                rcnt[k] = c;
            }
            for (int k = 0; k < kBins - 1; ++k) {
                if (lcnt[k] == 0 || rcnt[k + 1] == 0) continue;
                float cost = lbox[k].area() * lcnt[k] +
                             rbox[k + 1].area() * rcnt[k + 1] +
                             overlap_w * overlap_area(lbox[k], rbox[k + 1]) *
                                 std::min(lcnt[k], rcnt[k + 1]);
                if (cost < best_cost) {
                    best_cost = cost;
                    best_axis = axis;
                    best_bin = k;
                    best_base = cmin[axis];
                    best_scale = scale;
                }
            }
        }

        if (best_axis < 0) {
            // equal-count fallback on the longest axis
            int axis = 0;
            float ext = -1.f;
            for (int a = 0; a < 3; ++a) {
                float d = cmax[a] - cmin[a];
                if (d > ext) { ext = d; axis = a; }
            }
            int64_t mid = b + (e - b) / 2;
            std::nth_element(
                scratch.begin() + b, scratch.begin() + mid, scratch.begin() + e,
                [&](int64_t p, int64_t q) {
                    return cent[3 * p + axis] < cent[3 * q + axis];
                });
            return mid;
        }
        auto it = std::partition(
            scratch.begin() + b, scratch.begin() + e, [&](int64_t i) {
                int bi = (int)((cent[3 * i + best_axis] - best_base) * best_scale);
                bi = std::min(std::max(bi, 0), kBins - 1);
                return bi <= best_bin;
            });
        int64_t mid = it - scratch.begin();
        if (mid == b || mid == e) mid = b + (e - b) / 2;  // degenerate guard
        return mid;
    }

    // returns subtree node count
    int32_t emit(int64_t b, int64_t e) {
        size_t slot = node_min.size() / 3;
        Box box;
        for (int64_t k = b; k < e; ++k) box.grow(prim_box(scratch[k]));
        node_min.insert(node_min.end(), {box.lo.x, box.lo.y, box.lo.z});
        node_max.insert(node_max.end(), {box.hi.x, box.hi.y, box.hi.z});
        node_child.push_back(0);
        node_base.push_back(0);
        node_count.push_back(0);

        if (e - b <= max_leaf) {
            node_base[slot] = (int32_t)out_pos;
            node_count[slot] = (int32_t)(e - b);
            for (int64_t k = b; k < e; ++k) order[out_pos++] = scratch[k];
            return 1;
        }
        int64_t mid = split(b, e);
        int32_t sz = 1 + emit(b, mid);
        sz += emit(mid, e);
        node_child[slot] = sz;
        return sz;
    }
};

}  // namespace

extern "C" {

// Returns node count (M). Caller provides output buffers sized for 2n nodes.
// out arrays: nmin/nmax (2n*3 f32), skip/base/count (2n i32), order (n i64).
int64_t bvh_build(const float* lo, const float* hi, const float* cent,
                  int64_t n, int32_t max_leaf, float overlap_w,
                  float* out_min, float* out_max, int32_t* out_skip,
                  int32_t* out_base, int32_t* out_count, int64_t* out_order) {
    if (n <= 0) return 0;
    Builder bd;
    bd.lo = lo; bd.hi = hi; bd.cent = cent;
    bd.max_leaf = std::max(1, (int)max_leaf);
    bd.overlap_w = overlap_w;
    bd.order.resize(n);
    bd.scratch.resize(n);
    for (int64_t i = 0; i < n; ++i) bd.scratch[i] = i;
    size_t cap = 2 * (size_t)n + 8;
    bd.node_min.reserve(cap * 3);
    bd.node_max.reserve(cap * 3);
    bd.node_child.reserve(cap);
    bd.node_base.reserve(cap);
    bd.node_count.reserve(cap);

    bd.emit(0, n);

    int64_t m = (int64_t)bd.node_child.size();
    std::memcpy(out_min, bd.node_min.data(), m * 3 * sizeof(float));
    std::memcpy(out_max, bd.node_max.data(), m * 3 * sizeof(float));
    for (int64_t i = 0; i < m; ++i) {
        int32_t sub = bd.node_child[i] == 0 ? 1 : bd.node_child[i];
        out_skip[i] = (int32_t)i + sub;
        out_base[i] = bd.node_base[i];
        out_count[i] = bd.node_count[i];
    }
    std::memcpy(out_order, bd.order.data(), n * sizeof(int64_t));
    return m;
}

}  // extern "C"
