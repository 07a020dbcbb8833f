"""Collapse the binary SAH or SBVH tree into an 8-wide BVH (port of
cuda_pt_tpu/accel/wide_build.py).

Each wide node owns a frontier of binary subtrees grown greedily (expand
the largest-surface-area interior entry until 8 slots are filled). Binary
leaves become leaf children; interior entries become child wide nodes, in
BFS order. The binary tree is recovered from the skip encoding: node i
interior -> left child i+1, right child skip[i+1]; leaf <=> count > 0.
"""

from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np
import torch

from ..scene.types import WideBVHArrays

BRANCH = 8
# Empty child slot sentinel (an inverted box alone does not reject in a
# swap-based slab test, so traversal masks on it explicitly).
EMPTY = np.int32(np.iinfo(np.int32).min)


def _surface_area(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    d = np.maximum(hi - lo, 0.0)
    return 2.0 * (d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2] + d[..., 2] * d[..., 0])


def collapse_wide(nodes: dict, max_leaf: int = 4, box_dtype: str = "f32",
                  device="cpu") -> WideBVHArrays:
    """nodes: the binary builder dict (node_min/max/skip/base/count).

    box_dtype="bf16" stores the child boxes as bfloat16 rounded outward
    (minima down, maxima up: ops/traverse_kernel._bf16_directed), half the
    node bytes for a few extra conservative node visits; hits are never
    lost. The walk (accel/wide_traverse.py) computes in f32 either way."""
    if box_dtype not in ("f32", "bf16"):
        raise ValueError(f"box_dtype must be 'f32' or 'bf16', got {box_dtype!r}")
    nmin = np.asarray(nodes["node_min"], np.float32)
    nmax = np.asarray(nodes["node_max"], np.float32)
    skip = np.asarray(nodes["node_skip"], np.int64)
    base = np.asarray(nodes["node_base"], np.int64)
    cnt = np.asarray(nodes["node_count"], np.int64)
    M = len(cnt)
    is_leaf = cnt > 0
    sa = _surface_area(nmin, nmax)

    cmin_rows: list = []
    cmax_rows: list = []
    cnode_rows: list = []
    leaf_base: list = []
    leaf_count: list = []
    queue: deque = deque()

    def new_row() -> int:
        cmin_rows.append(np.full((BRANCH, 3), np.inf, np.float32))
        cmax_rows.append(np.full((BRANCH, 3), -np.inf, np.float32))
        cnode_rows.append(np.full(BRANCH, EMPTY, np.int32))
        return len(cmin_rows) - 1

    def new_wide(bnode: int) -> int:
        wid = new_row()
        queue.append((wid, bnode))
        return wid

    def new_leaf(bnode: int) -> int:
        lid = len(leaf_base)
        leaf_base.append(int(base[bnode]))
        leaf_count.append(int(cnt[bnode]))
        return -(lid + 1)

    if M == 1 or is_leaf[0]:
        # degenerate: root is a leaf -> one wide node with a single leaf child
        wid = new_row()
        cmin_rows[wid][0] = nmin[0]
        cmax_rows[wid][0] = nmax[0]
        cnode_rows[wid][0] = new_leaf(0)
        return _finish(cmin_rows, cmax_rows, cnode_rows, leaf_base, leaf_count,
                       np.array([1], np.int32), max_leaf, box_dtype, device)

    new_wide(0)
    nchild: list = []
    while queue:
        wid, b = queue.popleft()
        frontier = [b + 1, int(skip[b + 1])]
        while len(frontier) < BRANCH:
            cands = [f for f in frontier if not is_leaf[f]]
            if not cands:
                break
            pick = max(cands, key=lambda f: sa[f])
            frontier.remove(pick)
            frontier.append(pick + 1)
            frontier.append(int(skip[pick + 1]))
        for slot, f in enumerate(frontier):
            cmin_rows[wid][slot] = nmin[f]
            cmax_rows[wid][slot] = nmax[f]
            cnode_rows[wid][slot] = new_leaf(f) if is_leaf[f] else new_wide(f)
        while len(nchild) <= wid:
            nchild.append(0)
        nchild[wid] = len(frontier)

    return _finish(cmin_rows, cmax_rows, cnode_rows, leaf_base, leaf_count,
                   np.asarray(nchild, np.int32), max_leaf, box_dtype, device)


def _finish(cmin_rows, cmax_rows, cnode_rows, leaf_base, leaf_count, nchild,
            max_leaf, box_dtype, device) -> WideBVHArrays:
    cmin = np.stack(cmin_rows)
    cmax = np.stack(cmax_rows)
    cnode = np.stack(cnode_rows)
    box_torch = torch.float32
    if box_dtype == "bf16":
        from ..ops.traverse_kernel import _bf16_directed

        fin = np.isfinite(cmin)  # keep the empty slots' +-inf sentinels
        cmin = np.where(fin, _bf16_directed(cmin, up=False), cmin)
        cmax = np.where(fin, _bf16_directed(cmax, up=True), cmax)
        box_torch = torch.bfloat16  # exact: the values are bf16-representable
    # Safe stack bound: popping a node replaces 1 entry by its c children
    # (net +c-1); g(w) = (c_w - 1) + max over interior children g(child);
    # bound = g(root) + 2. Children have larger ids (BFS order).
    W = cmin.shape[0]
    g = np.zeros(W, np.int64)
    for w in range(W - 1, -1, -1):
        gc = 0
        for e in cnode[w][: nchild[w]]:
            if e >= 0:
                gc = max(gc, int(g[e]))
        g[w] = (int(nchild[w]) - 1) + gc
    max_stack = int(g[0]) + 2 if W else 2

    if not leaf_base:  # keep arrays non-empty for gather safety
        leaf_base, leaf_count = [0], [0]
    return WideBVHArrays(
        child_min=torch.as_tensor(cmin, device=device).to(box_torch),
        child_max=torch.as_tensor(cmax, device=device).to(box_torch),
        child_node=torch.as_tensor(cnode, device=device),
        leaf_base=torch.as_tensor(np.asarray(leaf_base, np.int32), device=device),
        leaf_count=torch.as_tensor(np.asarray(leaf_count, np.int32), device=device),
        max_leaf=max_leaf,
        max_stack=max_stack,
    )


def from_bvharrays(bvh, box_dtype: str = "f32") -> WideBVHArrays:
    """Collapse a BVHArrays (pulls its tensors to the host once); the wide
    tree lands on the BVH's device."""
    nodes = {k: getattr(bvh, k).cpu().numpy() for k in
             ("node_min", "node_max", "node_skip", "node_base", "node_count")}
    return collapse_wide(nodes, max_leaf=bvh.max_leaf, box_dtype=box_dtype,
                         device=bvh.node_min.device)


def with_wide(scene, box_dtype: str = "f32"):
    """A copy of scene with a wide BVH attached and traversal pinned to it."""
    return dataclasses.replace(scene, wide=from_bvharrays(scene.bvh, box_dtype=box_dtype),
                               traversal="wide")
