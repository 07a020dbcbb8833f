"""Host-side SAH BVH builder (NumPy) with stackless skip-encoded output.

Port of cuda_pt_tpu/accel/bvh_build.py: build_bvh dispatches to the native
C++ builder (accel/native.py) as the reference does, so the default prim
order is the reference's default; the NumPy path below (use_native=False,
and the fallback where g++ is missing) is kept bit-identical to the
reference's NumPy path:

- 16-bin binned SAH over the centroid extent with an overlap-area penalty
  weight and an equal-count fallback.
- Primitive reordering so every leaf covers a contiguous prim range.
- DFS linearization with *absolute skip* indices: on AABB miss jump to
  ``skip[i]`` (= i + subtree size), on hit fall through to i + 1.
- Leaves are capped at ``max_leaf`` prims.

Pure host code: it runs once per scene compile.
"""

from __future__ import annotations

import numpy as np

_NBINS = 16
_TRAV_COST = 0.25


def prim_bounds(p0: np.ndarray, e1: np.ndarray, e2: np.ndarray, is_sphere: np.ndarray):
    """Per-prim AABB (lo, hi) and centroids."""
    p1 = p0 + e1
    p2 = p0 + e2
    lo = np.minimum(p0, np.minimum(p1, p2))
    hi = np.maximum(p0, np.maximum(p1, p2))
    r = np.abs(e1[:, 0:1])
    lo_s = p0 - r
    hi_s = p0 + r
    sph = is_sphere[:, None]
    lo = np.where(sph, lo_s, lo)
    hi = np.where(sph, hi_s, hi)
    centroid = 0.5 * (lo + hi)
    return lo.astype(np.float32), hi.astype(np.float32), centroid.astype(np.float32)


def _surface_area(lo, hi):
    d = np.maximum(hi - lo, 0.0)
    return 2.0 * (d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2] + d[..., 2] * d[..., 0])


def build_bvh(lo: np.ndarray, hi: np.ndarray, centroid: np.ndarray, max_leaf: int = 4,
              overlap_w: float = 1.0, use_native: bool = True):
    """Build the BVH.

    Returns dict of numpy arrays: node_min/max (M,3), node_skip/base/count
    (M,), and ``order`` (N,) — the primitive permutation (new order -> old
    index) the caller must apply to every per-prim array.

    Dispatches to the native C++ builder (accel/native.py) when available;
    the NumPy path below is the reference implementation and fallback.
    """
    n = lo.shape[0]
    if use_native and n > 0:
        from . import native

        out = native.build_bvh_native(lo, hi, centroid, max_leaf, overlap_w)
        if out is not None:
            return out
    order = np.arange(n, dtype=np.int64)

    # Nodes collected in DFS order during an explicit-stack build.
    node_min: list = []
    node_max: list = []
    node_child: list = []  # subtree size placeholder, patched after build
    node_base: list = []
    node_count: list = []

    out_pos = 0  # next write position in the reordered prim array
    reordered = np.empty(n, dtype=np.int64)

    # Each stack entry: (index array, node slot). We emit nodes in DFS
    # pre-order by processing children immediately via recursion-on-stack
    # with explicit subtree bookkeeping.
    def emit(idx: np.ndarray) -> int:
        """Emit subtree for prims idx, return subtree node count."""
        nonlocal out_pos
        my_slot = len(node_min)
        blo = lo[idx].min(axis=0)
        bhi = hi[idx].max(axis=0)
        node_min.append(blo)
        node_max.append(bhi)
        node_child.append(0)
        node_base.append(0)
        node_count.append(0)

        if idx.size <= max_leaf:
            node_base[my_slot] = out_pos
            node_count[my_slot] = idx.size
            reordered[out_pos : out_pos + idx.size] = idx
            out_pos += idx.size
            return 1

        left_idx, right_idx = _split(idx)
        sz = 1 + emit(left_idx)
        sz += emit(right_idx)
        node_child[my_slot] = sz
        return sz

    def _split(idx: np.ndarray):
        c = centroid[idx]
        cmin = c.min(axis=0)
        cmax = c.max(axis=0)
        ext = cmax - cmin
        best = None  # (cost, axis, bin_edge)
        for axis in range(3):
            if ext[axis] < 1e-8:
                continue
            scale = _NBINS * (1.0 - 1e-6) / ext[axis]
            bin_id = ((c[:, axis] - cmin[axis]) * scale).astype(np.int32)
            bin_id = np.clip(bin_id, 0, _NBINS - 1)
            counts = np.bincount(bin_id, minlength=_NBINS)
            # per-bin AABBs
            blo = np.full((_NBINS, 3), np.inf, np.float32)
            bhi = np.full((_NBINS, 3), -np.inf, np.float32)
            np.minimum.at(blo, bin_id, lo[idx])
            np.maximum.at(bhi, bin_id, hi[idx])
            # prefix/suffix sweeps
            llo = np.minimum.accumulate(blo, axis=0)
            lhi = np.maximum.accumulate(bhi, axis=0)
            rlo = np.minimum.accumulate(blo[::-1], axis=0)[::-1]
            rhi = np.maximum.accumulate(bhi[::-1], axis=0)[::-1]
            lcnt = np.cumsum(counts)
            rcnt = counts.sum() - lcnt
            # split after bin b: left bins [0..b], right [b+1..]
            sa_l = _surface_area(llo, lhi)
            sa_r = np.concatenate([_surface_area(rlo, rhi)[1:], [0.0]])
            # overlap penalty (reference src/impl/bvh.cu:170-186)
            ov_lo = np.maximum(llo, np.concatenate([rlo[1:], rlo[-1:]]))
            ov_hi = np.minimum(lhi, np.concatenate([rhi[1:], rhi[-1:]]))
            sa_ov = _surface_area(ov_lo, np.maximum(ov_hi, ov_lo))
            rcnt_sh = np.concatenate([rcnt[:-1], [0]])
            cost = (
                sa_l * lcnt
                + sa_r * np.concatenate([rcnt[:-1], [0]])
                + overlap_w * sa_ov * np.minimum(lcnt, rcnt_sh)
            )
            valid = (lcnt > 0) & (np.concatenate([rcnt[:-1], [0]]) > 0)
            cost = np.where(valid, cost, np.inf)
            b = int(np.argmin(cost[:-1])) if cost[:-1].size else 0
            if np.isfinite(cost[b]) and (best is None or cost[b] < best[0]):
                best = (cost[b], axis, b, cmin[axis], scale)

        if best is None:
            # Equal-count fallback on the longest axis (or arbitrary for
            # identical centroids) — reference src/impl/bvh.cu:204-234.
            axis = int(np.argmax(ext)) if ext.max() > 0 else 0
            key = c[:, axis]
            half = idx.size // 2
            part = np.argpartition(key, half)
            return idx[part[:half]], idx[part[half:]]

        _, axis, b, base, scale = best
        bin_id = np.clip(((c[:, axis] - base) * scale).astype(np.int32), 0, _NBINS - 1)
        mask = bin_id <= b
        return idx[mask], idx[~mask]

    import sys

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 100000))
    try:
        if n > 0:
            emit(order)
        else:
            # Degenerate empty scene: single empty leaf.
            node_min.append(np.zeros(3, np.float32))
            node_max.append(np.zeros(3, np.float32))
            node_child.append(0)
            node_base.append(0)
            node_count.append(0)
    finally:
        sys.setrecursionlimit(old_limit)

    m = len(node_min)
    child = np.asarray(node_child, np.int32)
    subtree = np.where(child == 0, 1, child)
    skip = np.arange(m, dtype=np.int32) + subtree
    return {
        "node_min": np.asarray(node_min, np.float32),
        "node_max": np.asarray(node_max, np.float32),
        "node_skip": skip,
        "node_base": np.asarray(node_base, np.int32),
        "node_count": np.asarray(node_count, np.int32),
        "order": reordered,
    }


def sah_cost(nodes: dict) -> float:
    """Total SAH cost of the tree, relative to its root's area (the
    reference's diagnostic): interior nodes at _TRAV_COST, leaves at their
    prim count, each weighted by its surface area."""
    sa = _surface_area(nodes["node_min"], nodes["node_max"])
    root = max(sa[0], 1e-12)
    is_leaf = nodes["node_count"] > 0
    cost = np.where(is_leaf, nodes["node_count"].astype(np.float64), _TRAV_COST)
    return float((sa * cost).sum() / root)
