// Native Wavefront OBJ parser (C ABI, loaded via ctypes by scene/native_obj.py).
// The port's copy of cuda_pt_tpu/scene/cpp/obj_loader.cpp, unchanged below
// this comment.
//
// The reference loads meshes through tinyobjloader (C++) at
// src/impl/scene.cu:548-660; the Python parser (scene/obj_loader.py) is
// about two orders of magnitude slower. This parser keeps the exact
// semantics of the Python one: fan triangulation, 1-based and negative
// indices, computed face normal when the OBJ has no normals, zero UVs when
// absent, defensive normal normalization; it parses in a single pass over
// one read() of the file.
//
// Usage from Python:
//   h = obj_parse(path); T = obj_num_tris(h);
//   obj_fill(h, p(T,3,3), n(T,3,3), uv(T,3,2)); obj_free(h)

#include <cctype>
#include <charconv>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct Corner {
    int32_t v, t, n;  // raw OBJ indices (1-based, 0 = absent, negative = relative)
};

struct ObjData {
    std::vector<float> v;    // xyz triples
    std::vector<float> vn;   // xyz triples
    std::vector<float> vt;   // uv pairs
    std::vector<Corner> tri; // 3 corners per triangle (fan-triangulated)
};

inline const char* skip_ws(const char* p, const char* end) {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
    return p;
}

inline const char* parse_float(const char* p, const char* end, float* out) {
    p = skip_ws(p, end);
    auto res = std::from_chars(p, end, *out);
    if (res.ec != std::errc()) { *out = 0.0f; return p; }
    return res.ptr;
}

inline const char* parse_int(const char* p, const char* end, int32_t* out) {
    auto res = std::from_chars(p, end, *out);
    if (res.ec != std::errc()) { *out = 0; return p; }
    return res.ptr;
}

// "vi[/ti[/ni]]" — any of ti/ni may be empty ("vi//ni").
inline const char* parse_corner(const char* p, const char* end, Corner* c) {
    c->v = c->t = c->n = 0;
    p = parse_int(p, end, &c->v);
    if (p < end && *p == '/') {
        ++p;
        if (p < end && *p != '/') p = parse_int(p, end, &c->t);
        if (p < end && *p == '/') { ++p; p = parse_int(p, end, &c->n); }
    }
    return p;
}

inline int64_t resolve(int32_t idx, int64_t count) {
    return idx > 0 ? idx - 1 : count + idx;  // caller guarantees idx != 0
}

}  // namespace

extern "C" {

void* obj_parse(const char* path) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return nullptr;
    std::fseek(f, 0, SEEK_END);
    long sz = std::ftell(f);
    std::fseek(f, 0, SEEK_SET);
    std::vector<char> buf(static_cast<size_t>(sz));
    size_t got = sz ? std::fread(buf.data(), 1, static_cast<size_t>(sz), f) : 0;
    std::fclose(f);
    if (got != static_cast<size_t>(sz)) return nullptr;

    auto* d = new ObjData();
    const char* p = buf.data();
    const char* end = p + buf.size();
    std::vector<Corner> poly;  // reused per face
    while (p < end) {
        const char* line_end = static_cast<const char*>(
            std::memchr(p, '\n', static_cast<size_t>(end - p)));
        if (!line_end) line_end = end;
        const char* q = skip_ws(p, line_end);
        if (q + 1 < line_end && q[0] == 'v' &&
            (q[1] == ' ' || q[1] == '\t')) {
            float x, y, z;
            q = parse_float(q + 1, line_end, &x);
            q = parse_float(q, line_end, &y);
            q = parse_float(q, line_end, &z);
            d->v.insert(d->v.end(), {x, y, z});
        } else if (q + 2 < line_end && q[0] == 'v' && q[1] == 'n' &&
                   (q[2] == ' ' || q[2] == '\t')) {
            float x, y, z;
            q = parse_float(q + 2, line_end, &x);
            q = parse_float(q, line_end, &y);
            q = parse_float(q, line_end, &z);
            d->vn.insert(d->vn.end(), {x, y, z});
        } else if (q + 2 < line_end && q[0] == 'v' && q[1] == 't' &&
                   (q[2] == ' ' || q[2] == '\t')) {
            float u, v;
            q = parse_float(q + 2, line_end, &u);
            q = parse_float(q, line_end, &v);
            d->vt.insert(d->vt.end(), {u, v});
        } else if (q + 1 < line_end && q[0] == 'f' &&
                   (q[1] == ' ' || q[1] == '\t')) {
            poly.clear();
            q = skip_ws(q + 1, line_end);
            while (q < line_end && *q != '#') {
                Corner c;
                const char* q2 = parse_corner(q, line_end, &c);
                if (q2 == q) break;  // no progress — malformed token
                poly.push_back(c);
                q = skip_ws(q2, line_end);
            }
            for (size_t k = 1; k + 1 < poly.size(); ++k) {  // triangle fan
                d->tri.push_back(poly[0]);
                d->tri.push_back(poly[k]);
                d->tri.push_back(poly[k + 1]);
            }
        }
        p = line_end + 1;
    }
    return d;
}

int64_t obj_num_tris(void* h) {
    return static_cast<ObjData*>(h)->tri.size() / 3;
}

// p/n: (T,3,3) float32; uv: (T,3,2) float32 — caller-allocated.
void obj_fill(void* h, float* P, float* N, float* UV) {
    const ObjData& d = *static_cast<ObjData*>(h);
    const int64_t T = static_cast<int64_t>(d.tri.size()) / 3;
    const int64_t nv = static_cast<int64_t>(d.v.size()) / 3;
    const int64_t nn = static_cast<int64_t>(d.vn.size()) / 3;
    const int64_t nt = static_cast<int64_t>(d.vt.size()) / 2;

    for (int64_t t = 0; t < T; ++t) {
        float* p = P + t * 9;
        float* n = N + t * 9;
        float* uv = UV + t * 6;
        bool has_n = true;
        for (int c = 0; c < 3; ++c) {
            const Corner& cr = d.tri[static_cast<size_t>(t * 3 + c)];
            int64_t vi = resolve(cr.v, nv);
            if (vi < 0 || vi >= nv) vi = 0;  // clamp malformed index
            std::memcpy(p + c * 3, &d.v[static_cast<size_t>(vi * 3)],
                        3 * sizeof(float));
            if (nt > 0 && cr.t != 0) {
                int64_t ti = resolve(cr.t, nt);
                if (ti >= 0 && ti < nt)
                    std::memcpy(uv + c * 2, &d.vt[static_cast<size_t>(ti * 2)],
                                2 * sizeof(float));
                else
                    uv[c * 2] = uv[c * 2 + 1] = 0.0f;
            } else {
                uv[c * 2] = uv[c * 2 + 1] = 0.0f;
            }
            if (nn > 0 && cr.n != 0) {
                int64_t ni = resolve(cr.n, nn);
                if (ni >= 0 && ni < nn)
                    std::memcpy(n + c * 3, &d.vn[static_cast<size_t>(ni * 3)],
                                3 * sizeof(float));
                else
                    has_n = false;
            } else {
                has_n = false;
            }
        }
        if (!has_n) {
            float e1[3] = {p[3] - p[0], p[4] - p[1], p[5] - p[2]};
            float e2[3] = {p[6] - p[0], p[7] - p[1], p[8] - p[2]};
            float fn[3] = {e1[1] * e2[2] - e1[2] * e2[1],
                           e1[2] * e2[0] - e1[0] * e2[2],
                           e1[0] * e2[1] - e1[1] * e2[0]};
            float len = std::sqrt(fn[0] * fn[0] + fn[1] * fn[1] + fn[2] * fn[2]);
            if (len > 1e-12f) {
                fn[0] /= len; fn[1] /= len; fn[2] /= len;
            } else {
                fn[0] = fn[1] = 0.0f; fn[2] = 1.0f;
            }
            for (int c = 0; c < 3; ++c) std::memcpy(n + c * 3, fn, 3 * sizeof(float));
        } else {
            // defensive normalization (parity with obj_loader.py:79-81)
            for (int c = 0; c < 3; ++c) {
                float* nc = n + c * 3;
                float len = std::sqrt(nc[0] * nc[0] + nc[1] * nc[1] + nc[2] * nc[2]);
                if (len > 1e-12f) { nc[0] /= len; nc[1] /= len; nc[2] /= len; }
            }
        }
    }
}

void obj_free(void* h) { delete static_cast<ObjData*>(h); }

}  // extern "C"
