// Native SBVH builder (Stich et al. 2009 spatial splits), C++17, no deps.
// The port's copy of cuda_pt_tpu/accel/cpp/sbvh_builder.cpp, unchanged below
// this comment, so that both packages build bit-equal trees.
//
// Re-designs the reference SBVH (src/impl/bvh_spatial.cu,
// src/core/bvh_spatial.cuh) for the skip-encoded traversal format:
// - object splits: 16-bin SAH over ref centroids (same as bvh_builder.cpp)
// - spatial splits: chopped binning with exact Sutherland-Hodgman
//   triangle-slab clipping (reference proc_geometry.cu aabb_triangle_clipping)
//   attempted when the best object split's child overlap exceeds
//   alpha * root area (reference bvh_spatial.cu:563-569)
// - reference unsplitting: straddling refs moved wholly left/right when that
//   lowers SAH (reference bvh_spatial.cu:683-693)
// - multithreaded: top subtrees built concurrently with std::async
//   (replaces the reference's lock-free atomic_queue worker pool). The
//   threads share one atomic duplicate budget, so where that budget binds
//   (large scenes) the tree can differ from run to run.
// - output: stackless skip-encoded SoA arrays + a primitive reference list
//   with duplicates (leaves reference contiguous, possibly duplicated prims)
//
// Built at first use by accel/native.py (utils/host_build.py:
// g++ -O3 -march=native -std=c++17 -shared -fPIC -pthread).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <future>
#include <memory>
#include <vector>

namespace {

constexpr int kBins = 16;
constexpr float kAlpha = 1e-5f;  // spatial-split trigger threshold

struct V3 {
    float v[3];
    float& operator[](int i) { return v[i]; }
    float operator[](int i) const { return v[i]; }
};

inline V3 vmin(const V3& a, const V3& b) {
    return {std::min(a[0], b[0]), std::min(a[1], b[1]), std::min(a[2], b[2])};
}
inline V3 vmax(const V3& a, const V3& b) {
    return {std::max(a[0], b[0]), std::max(a[1], b[1]), std::max(a[2], b[2])};
}

struct Box {
    V3 lo{{1e30f, 1e30f, 1e30f}};
    V3 hi{{-1e30f, -1e30f, -1e30f}};
    void grow(const Box& b) { lo = vmin(lo, b.lo); hi = vmax(hi, b.hi); }
    void grow(const V3& p) { lo = vmin(lo, p); hi = vmax(hi, p); }
    bool valid() const { return hi[0] >= lo[0] && hi[1] >= lo[1] && hi[2] >= lo[2]; }
    float area() const {
        if (!valid()) return 0.f;
        float dx = hi[0] - lo[0], dy = hi[1] - lo[1], dz = hi[2] - lo[2];
        return 2.f * (dx * dy + dy * dz + dz * dx);
    }
    Box clipped(int axis, float a, float b) const {
        Box o = *this;
        o.lo[axis] = std::max(o.lo[axis], a);
        o.hi[axis] = std::min(o.hi[axis], b);
        return o;
    }
};

inline float overlap_area(const Box& a, const Box& b) {
    Box o;
    o.lo = vmax(a.lo, b.lo);
    o.hi = vmin(a.hi, b.hi);
    return o.valid() ? o.area() : 0.f;
}

struct Ref {
    int64_t prim;
    Box box;
};

struct BuildNode {
    Box box;
    std::unique_ptr<BuildNode> left, right;
    std::vector<Ref> refs;  // leaf only
    bool is_leaf() const { return !left; }
};

struct Ctx {
    const float* p0;
    const float* e1;
    const float* e2;
    const uint8_t* sphere;
    int max_leaf;
    float overlap_w;
    float root_area;
    std::atomic<int64_t> ref_budget;  // remaining allowed duplications

    V3 vert(int64_t prim, int corner) const {
        V3 a{{p0[3 * prim], p0[3 * prim + 1], p0[3 * prim + 2]}};
        if (corner == 0) return a;
        const float* e = corner == 1 ? e1 : e2;
        return {{a[0] + e[3 * prim], a[1] + e[3 * prim + 1], a[2] + e[3 * prim + 2]}};
    }

    // Exact AABB of the triangle clipped to slab [a, b] on axis
    // (Sutherland-Hodgman against two planes; reference proc_geometry.cu).
    Box clip_tri(int64_t prim, const Box& ref_box, int axis, float a, float b) const {
        if (sphere[prim]) return ref_box.clipped(axis, a, b);
        V3 poly[9];
        int n = 3;
        poly[0] = vert(prim, 0);
        poly[1] = vert(prim, 1);
        poly[2] = vert(prim, 2);
        V3 tmp[9];
        // clip against axis >= a, then axis <= b
        for (int pass = 0; pass < 2; ++pass) {
            float plane = pass == 0 ? a : b;
            float sign = pass == 0 ? 1.f : -1.f;
            int m = 0;
            for (int i = 0; i < n; ++i) {
                const V3& c = poly[i];
                const V3& nx = poly[(i + 1) % n];
                float dc = sign * (c[axis] - plane);
                float dn = sign * (nx[axis] - plane);
                if (dc >= 0.f) tmp[m++] = c;
                if ((dc >= 0.f) != (dn >= 0.f)) {
                    float t = dc / (dc - dn);
                    V3 p;
                    for (int k = 0; k < 3; ++k) p[k] = c[k] + t * (nx[k] - c[k]);
                    tmp[m++] = p;
                }
            }
            n = m;
            std::copy(tmp, tmp + n, poly);
            if (n == 0) break;
        }
        Box out;
        for (int i = 0; i < n; ++i) out.grow(poly[i]);
        if (n == 0) return out;  // empty
        // intersect with the (possibly already clipped) reference box
        out.lo = vmax(out.lo, ref_box.lo);
        out.hi = vmin(out.hi, ref_box.hi);
        return out;
    }
};

struct SplitChoice {
    float cost = 1e30f;
    int axis = -1;
    int bin = -1;
    float base = 0, scale = 0;
    bool spatial = false;
    float plane = 0;  // spatial split plane
};

SplitChoice object_split(const Ctx& cx, const std::vector<Ref>& refs) {
    SplitChoice out;
    V3 cmin{{1e30f, 1e30f, 1e30f}}, cmax{{-1e30f, -1e30f, -1e30f}};
    for (const auto& r : refs) {
        V3 c{{0.5f * (r.box.lo[0] + r.box.hi[0]),
              0.5f * (r.box.lo[1] + r.box.hi[1]),
              0.5f * (r.box.lo[2] + r.box.hi[2])}};
        cmin = vmin(cmin, c);
        cmax = vmax(cmax, c);
    }
    for (int axis = 0; axis < 3; ++axis) {
        float ext = cmax[axis] - cmin[axis];
        if (ext < 1e-8f) continue;
        float scale = kBins * (1.f - 1e-6f) / ext;
        Box bins[kBins];
        int64_t counts[kBins] = {0};
        for (const auto& r : refs) {
            float c = 0.5f * (r.box.lo[axis] + r.box.hi[axis]);
            int bi = std::min(std::max((int)((c - cmin[axis]) * scale), 0), kBins - 1);
            bins[bi].grow(r.box);
            counts[bi]++;
        }
        Box lb[kBins], rb[kBins];
        int64_t lc[kBins], rc[kBins];
        Box acc; int64_t n = 0;
        for (int k = 0; k < kBins; ++k) { acc.grow(bins[k]); n += counts[k]; lb[k] = acc; lc[k] = n; }
        acc = Box(); n = 0;
        for (int k = kBins - 1; k >= 0; --k) { acc.grow(bins[k]); n += counts[k]; rb[k] = acc; rc[k] = n; }
        for (int k = 0; k < kBins - 1; ++k) {
            if (lc[k] == 0 || rc[k + 1] == 0) continue;
            float cost = lb[k].area() * lc[k] + rb[k + 1].area() * rc[k + 1] +
                         cx.overlap_w * overlap_area(lb[k], rb[k + 1]) *
                             std::min(lc[k], rc[k + 1]);
            if (cost < out.cost) {
                out = {cost, axis, k, cmin[axis], scale, false, 0.f};
            }
        }
    }
    return out;
}

SplitChoice spatial_split(const Ctx& cx, const std::vector<Ref>& refs, const Box& nb) {
    SplitChoice out;
    for (int axis = 0; axis < 3; ++axis) {
        float ext = nb.hi[axis] - nb.lo[axis];
        if (ext < 1e-7f) continue;
        float width = ext / kBins;
        Box bins[kBins];
        int64_t enter[kBins] = {0}, exit_[kBins] = {0};
        for (const auto& r : refs) {
            int b0 = std::min(std::max((int)((r.box.lo[axis] - nb.lo[axis]) / width), 0), kBins - 1);
            int b1 = std::min(std::max((int)((r.box.hi[axis] - nb.lo[axis]) / width), 0), kBins - 1);
            enter[b0]++;
            exit_[b1]++;
            if (b0 == b1) {
                bins[b0].grow(r.box);
            } else {
                for (int k = b0; k <= b1; ++k) {
                    Box cb = cx.clip_tri(r.prim, r.box, axis,
                                         nb.lo[axis] + k * width,
                                         nb.lo[axis] + (k + 1) * width);
                    if (cb.valid()) bins[k].grow(cb);
                }
            }
        }
        Box lb[kBins], rb[kBins];
        Box acc;
        for (int k = 0; k < kBins; ++k) { acc.grow(bins[k]); lb[k] = acc; }
        acc = Box();
        for (int k = kBins - 1; k >= 0; --k) { acc.grow(bins[k]); rb[k] = acc; }
        int64_t lcnt = 0, rcnt = (int64_t)refs.size();
        int64_t ent = 0, ext_c = 0;
        for (int k = 0; k < kBins - 1; ++k) {
            ent += enter[k];
            ext_c += exit_[k];
            lcnt = ent;          // refs starting at or before bin k
            rcnt = (int64_t)refs.size() - ext_c;  // refs ending after bin k
            if (lcnt == 0 || rcnt == 0) continue;
            float cost = lb[k].area() * lcnt + rb[k + 1].area() * rcnt;
            if (cost < out.cost) {
                out.cost = cost;
                out.axis = axis;
                out.bin = k;
                out.spatial = true;
                out.plane = nb.lo[axis] + (k + 1) * width;
            }
        }
    }
    return out;
}

std::unique_ptr<BuildNode> build(Ctx& cx, std::vector<Ref> refs, int depth) {
    auto node = std::make_unique<BuildNode>();
    for (const auto& r : refs) node->box.grow(r.box);
    if ((int64_t)refs.size() <= cx.max_leaf) {
        node->refs = std::move(refs);
        return node;
    }

    SplitChoice obj = object_split(cx, refs);
    SplitChoice best = obj;

    // probe spatial split when object-split children overlap significantly
    if (obj.axis >= 0) {
        // rough overlap estimate: redo partition bounds
        Box lbox, rbox;
        for (const auto& r : refs) {
            float c = 0.5f * (r.box.lo[obj.axis] + r.box.hi[obj.axis]);
            int bi = std::min(std::max((int)((c - obj.base) * obj.scale), 0), kBins - 1);
            (bi <= obj.bin ? lbox : rbox).grow(r.box);
        }
        float ov = overlap_area(lbox, rbox);
        if (ov > kAlpha * cx.root_area && cx.ref_budget.load() > 0) {
            SplitChoice sp = spatial_split(cx, refs, node->box);
            if (sp.axis >= 0 && sp.cost < best.cost) best = sp;
        }
    }

    std::vector<Ref> left, right;
    if (best.axis < 0) {
        // fallback: median split on the longest axis
        int axis = 0;
        float ext = -1;
        for (int a = 0; a < 3; ++a) {
            float d = node->box.hi[a] - node->box.lo[a];
            if (d > ext) { ext = d; axis = a; }
        }
        std::sort(refs.begin(), refs.end(), [&](const Ref& a, const Ref& b) {
            return a.box.lo[axis] + a.box.hi[axis] < b.box.lo[axis] + b.box.hi[axis];
        });
        size_t mid = refs.size() / 2;
        left.assign(refs.begin(), refs.begin() + mid);
        right.assign(refs.begin() + mid, refs.end());
    } else if (!best.spatial) {
        for (auto& r : refs) {
            float c = 0.5f * (r.box.lo[best.axis] + r.box.hi[best.axis]);
            int bi = std::min(std::max((int)((c - best.base) * best.scale), 0), kBins - 1);
            (bi <= best.bin ? left : right).push_back(std::move(r));
        }
        if (left.empty() || right.empty()) {
            // degenerate — median fallback
            refs.clear();
            for (auto& r : left) refs.push_back(std::move(r));
            for (auto& r : right) refs.push_back(std::move(r));
            left.clear(); right.clear();
            size_t mid = refs.size() / 2;
            left.assign(refs.begin(), refs.begin() + mid);
            right.assign(refs.begin() + mid, refs.end());
        }
    } else {
        // spatial split at plane: clip straddling refs into both sides,
        // with reference unsplitting when cheaper (bvh_spatial.cu:683-693)
        Box lbox, rbox;
        std::vector<const Ref*> straddle;
        for (auto& r : refs) {
            if (r.box.hi[best.axis] <= best.plane) { lbox.grow(r.box); left.push_back(r); }
            else if (r.box.lo[best.axis] >= best.plane) { rbox.grow(r.box); right.push_back(r); }
            else straddle.push_back(&r);
        }
        for (const Ref* rp : straddle) {
            const Ref& r = *rp;
            Box cl = cx.clip_tri(r.prim, r.box, best.axis, node->box.lo[best.axis], best.plane);
            Box cr = cx.clip_tri(r.prim, r.box, best.axis, best.plane, node->box.hi[best.axis]);
            // unsplitting: cost of duplicating vs hosting whole ref one side
            Box lgrow = lbox; lgrow.grow(r.box);
            Box rgrow = rbox; rgrow.grow(r.box);
            float c_split = (cl.valid() ? cl.area() : 0.f) + (cr.valid() ? cr.area() : 0.f);
            float c_left = lgrow.area() - lbox.area();
            float c_right = rgrow.area() - rbox.area();
            bool can_dup = cx.ref_budget.fetch_sub(1) > 0;
            if (!can_dup || (c_left < c_split && c_left <= c_right)) {
                cx.ref_budget.fetch_add(can_dup ? 1 : 0);
                lbox.grow(r.box);
                left.push_back(r);
            } else if (c_right < c_split) {
                cx.ref_budget.fetch_add(1);
                rbox.grow(r.box);
                right.push_back(r);
            } else {
                if (cl.valid()) { Ref nr{r.prim, cl}; lbox.grow(cl); left.push_back(nr); }
                if (cr.valid()) { Ref nr{r.prim, cr}; rbox.grow(cr); right.push_back(nr); }
            }
        }
        if (left.empty() || right.empty()) {
            refs.clear();
            for (auto& r : left) refs.push_back(r);
            for (auto& r : right) refs.push_back(r);
            left.clear(); right.clear();
            size_t mid = refs.size() / 2;
            left.assign(refs.begin(), refs.begin() + mid);
            right.assign(refs.begin() + mid, refs.end());
        }
    }
    refs.clear();
    refs.shrink_to_fit();

    if (depth < 3 && left.size() > 4096) {
        auto fut = std::async(std::launch::async, [&cx, &left, depth] {
            return build(cx, std::move(left), depth + 1);
        });
        node->right = build(cx, std::move(right), depth + 1);
        node->left = fut.get();
    } else {
        node->left = build(cx, std::move(left), depth + 1);
        node->right = build(cx, std::move(right), depth + 1);
    }
    return node;
}

struct Linearizer {
    std::vector<float> nmin, nmax;
    std::vector<int32_t> child, base, count;
    std::vector<int64_t> order;

    int32_t emit(const BuildNode* n) {
        size_t slot = child.size();
        nmin.insert(nmin.end(), {n->box.lo[0], n->box.lo[1], n->box.lo[2]});
        nmax.insert(nmax.end(), {n->box.hi[0], n->box.hi[1], n->box.hi[2]});
        child.push_back(0);
        base.push_back(0);
        count.push_back(0);
        if (n->is_leaf()) {
            base[slot] = (int32_t)order.size();
            count[slot] = (int32_t)n->refs.size();
            for (const auto& r : n->refs) order.push_back(r.prim);
            return 1;
        }
        int32_t sz = 1 + emit(n->left.get());
        sz += emit(n->right.get());
        child[slot] = sz;
        return sz;
    }
};

}  // namespace

extern "C" {

// Returns the number of output prim references (n_out, with duplicates), or
// -1 on failure. Node count written to *out_m. Buffers: nodes sized for
// 4n, order sized for 3n.
int64_t sbvh_build(const float* p0, const float* e1, const float* e2,
                   const uint8_t* is_sphere, int64_t n, int32_t max_leaf,
                   float overlap_w, float dup_budget_frac,
                   float* out_min, float* out_max, int32_t* out_skip,
                   int32_t* out_base, int32_t* out_count, int64_t* out_order,
                   int64_t* out_m) {
    if (n <= 0) return -1;
    Ctx cx{p0, e1, e2, is_sphere, std::max(1, (int)max_leaf), overlap_w, 0.f,
           {(int64_t)(n * dup_budget_frac)}};

    std::vector<Ref> refs(n);
    Box root;
    for (int64_t i = 0; i < n; ++i) {
        Box b;
        if (is_sphere[i]) {
            float r = std::fabs(e1[3 * i]);
            V3 c{{p0[3 * i], p0[3 * i + 1], p0[3 * i + 2]}};
            V3 clo{{c[0] - r, c[1] - r, c[2] - r}};
            V3 chi{{c[0] + r, c[1] + r, c[2] + r}};
            b.grow(clo);
            b.grow(chi);
        } else {
            b.grow(cx.vert(i, 0));
            b.grow(cx.vert(i, 1));
            b.grow(cx.vert(i, 2));
        }
        refs[i] = {i, b};
        root.grow(b);
    }
    cx.root_area = root.area();

    auto tree = build(cx, std::move(refs), 0);
    Linearizer lin;
    lin.emit(tree.get());

    int64_t m = (int64_t)lin.child.size();
    int64_t n_out = (int64_t)lin.order.size();
    if (m > 4 * n + 8 || n_out > 3 * n) return -1;
    std::memcpy(out_min, lin.nmin.data(), m * 3 * sizeof(float));
    std::memcpy(out_max, lin.nmax.data(), m * 3 * sizeof(float));
    for (int64_t i = 0; i < m; ++i) {
        int32_t sub = lin.child[i] == 0 ? 1 : lin.child[i];
        out_skip[i] = (int32_t)i + sub;
        out_base[i] = lin.base[i];
        out_count[i] = lin.count[i];
    }
    std::memcpy(out_order, lin.order.data(), n_out * sizeof(int64_t));
    *out_m = m;
    return n_out;
}

}  // extern "C"
