"""Wavefront OBJ loader (host-side, NumPy; port of
cuda_pt_tpu/scene/obj_loader.py).

Replaces the reference's tinyobjloader dependency (src/impl/scene.cu:548-660)
with a small self-contained parser. Produces per-corner position / normal /
UV arrays (triangulated, fan rule for polygons) with the same fallbacks the
reference applies: computed face normal when the OBJ has no normals
(scene.cu:644-655), zero UVs when absent.
"""

from __future__ import annotations

import numpy as np


def load_obj(path: str, native: bool = True):
    """Parse an OBJ file.

    Returns dict with float32 arrays: ``p`` (T,3,3), ``n`` (T,3,3),
    ``uv`` (T,3,2) — triangle corners in file order.

    Uses the native C++ parser (scene/cpp/obj_loader.cpp, scene/native_obj.py)
    when it builds; ``native=False`` forces this pure-Python path (also the
    fallback when g++ is unavailable)."""
    if native:
        from . import native_obj

        out = native_obj.load_obj_native(path)
        if out is not None:
            return out
    vs: list = []
    vns: list = []
    vts: list = []
    faces: list = []  # list of list[(vi, ti, ni)]
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        for line in f:
            if not line or line[0] in "#\n":
                continue
            if "#" in line:  # strip trailing comment
                line = line.split("#", 1)[0]
            parts = line.split()
            if not parts:
                continue
            tag = parts[0]
            if tag == "v":
                vs.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif tag == "vn":
                vns.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif tag == "vt":
                vts.append([float(parts[1]), float(parts[2])])
            elif tag == "f":
                corners = []
                for tok in parts[1:]:
                    sub = tok.split("/")
                    vi = int(sub[0])
                    ti = int(sub[1]) if len(sub) > 1 and sub[1] else 0
                    ni = int(sub[2]) if len(sub) > 2 and sub[2] else 0
                    corners.append((vi, ti, ni))
                # triangle fan for polygons
                for k in range(1, len(corners) - 1):
                    faces.append([corners[0], corners[k], corners[k + 1]])

    v = np.asarray(vs, np.float32).reshape(-1, 3)
    vn = np.asarray(vns, np.float32).reshape(-1, 3) if vns else None
    vt = np.asarray(vts, np.float32).reshape(-1, 2) if vts else None

    T = len(faces)
    p = np.zeros((T, 3, 3), np.float32)
    n = np.zeros((T, 3, 3), np.float32)
    uv = np.zeros((T, 3, 2), np.float32)

    def resolve(idx, count):
        return idx - 1 if idx > 0 else count + idx

    for t, tri in enumerate(faces):
        has_n = True
        for c, (vi, ti, ni) in enumerate(tri):
            p[t, c] = v[resolve(vi, len(v))]
            if vt is not None and ti != 0:
                uv[t, c] = vt[resolve(ti, len(vt))]
            if vn is not None and ni != 0:
                n[t, c] = vn[resolve(ni, len(vn))]
            else:
                has_n = False
        if not has_n:
            fn = np.cross(p[t, 1] - p[t, 0], p[t, 2] - p[t, 0])
            norm = np.linalg.norm(fn)
            fn = fn / norm if norm > 1e-12 else np.array([0.0, 0.0, 1.0], np.float32)
            n[t, :] = fn
    # Normalize shading normals defensively.
    ln = np.linalg.norm(n, axis=-1, keepdims=True)
    n = np.where(ln > 1e-12, n / np.maximum(ln, 1e-12), n)
    return {"p": p, "n": n, "uv": uv}
