"""Batched stackless BVH traversal in PyTorch (port of
cuda_pt_tpu/accel/traverse.py): every ray holds its own node pointer into
the skip-encoded binary tree; one loop steps all live rays together
(gather node -> slab test -> fixed-K leaf block -> advance by +1 on an
interior hit, by skip[] on a miss).

This is the plain-PyTorch walk the path tracer uses above
``BRUTE_FORCE_MAX_PRIMS`` and the CPU stand-in of kernel K1. Unlike the
reference's masked loop over the whole batch, each step works on the
lanes that are still walking only, so the tail of a large batch costs
what its few deep rays cost. Ties are broken as the reference breaks
them: strict ``t < t_best`` in DFS order, the lowest slot inside a leaf.
"""

from __future__ import annotations

import math

import torch

from ..ops import intersect as isect
from ..scene.types import BVHArrays, Geometry


def _inv_dir(d: torch.Tensor) -> torch.Tensor:
    safe = torch.where(torch.abs(d) < 1e-8, torch.where(d < 0, -1e-8, 1e-8), d)
    return 1.0 / safe


def _slab(nmin, nmax, o, inv_d, t_best):
    t0 = (nmin - o) * inv_d
    t1 = (nmax - o) * inv_d
    tn = torch.amax(torch.minimum(t0, t1), dim=-1)
    tf = torch.amin(torch.maximum(t0, t1), dim=-1)
    return (tn <= tf) & (tf > isect.HIT_EPS) & (tn < t_best)


def closest_hit_bvh(geom: Geometry, bvh: BVHArrays, o: torch.Tensor, d: torch.Tensor,
                    max_leaf: int | None = None, count_cost: bool = False):
    """Closest hit by the skip walk; the contract of
    ops/intersect.closest_hit_brute: dict(t, prim (int64, -1 = miss), hit,
    b1, b2). max_leaf defaults to the tree's own leaf capacity. count_cost
    adds the reference's cost counts (int32): node_cnt, the steps a lane
    walks, and prim_cnt, the valid leaf slots it tests."""
    max_leaf = bvh.max_leaf if max_leaf is None else max_leaf
    B = o.shape[0]
    M = bvh.num_nodes
    N = geom.num_prims
    dev = o.device
    inv_d = _inv_dir(d)
    karange = torch.arange(max_leaf, device=dev)[None, :]
    t = torch.full((B,), math.inf, device=dev)
    prim = torch.full((B,), -1, dtype=torch.int64, device=dev)
    b1 = torch.zeros(B, device=dev)
    b2 = torch.zeros(B, device=dev)
    ptr = torch.zeros(B, dtype=torch.int64, device=dev)
    if count_cost:
        node_cnt = torch.zeros(B, dtype=torch.int32, device=dev)
        prim_cnt = torch.zeros(B, dtype=torch.int32, device=dev)
    idx = torch.arange(B, device=dev)  # lanes still walking
    while idx.numel() > 0:
        pc = ptr[idx]
        o_i, d_i, t_i = o[idx], d[idx], t[idx]
        box_hit = _slab(bvh.node_min[pc], bvh.node_max[pc], o_i, inv_d[idx], t_i)
        cnt = bvh.node_count[pc].long()
        is_leaf = cnt > 0
        leaf = box_hit & is_leaf
        if count_cost:
            node_cnt[idx] += 1
        if bool(leaf.any()):
            li = torch.nonzero(leaf)[:, 0]
            ids = torch.clamp(bvh.node_base[pc[li]].long()[:, None] + karange, 0, N - 1)
            valid = karange < cnt[li][:, None]
            if count_cost:
                prim_cnt[idx[li]] += valid.sum(-1, dtype=torch.int32)
            t_k, hit_k, b1_k, b2_k = isect.intersect_gather(geom, o_i[li], d_i[li], ids, valid)
            t_k = torch.where(hit_k & (t_k < t_i[li][:, None]), t_k, math.inf)
            k = torch.argmin(t_k, dim=-1, keepdim=True)
            t_new = torch.gather(t_k, 1, k)[:, 0]
            better = torch.isfinite(t_new)
            lanes = idx[li][better]
            t[lanes] = t_new[better]
            prim[lanes] = torch.gather(ids, 1, k)[:, 0][better]
            b1[lanes] = torch.gather(b1_k, 1, k)[:, 0][better]
            b2[lanes] = torch.gather(b2_k, 1, k)[:, 0][better]
        ptr_next = torch.where(box_hit & ~is_leaf, pc + 1, bvh.node_skip[pc].long())
        ptr[idx] = ptr_next
        idx = idx[ptr_next < M]
    out = {"t": t, "prim": prim, "hit": prim >= 0, "b1": b1, "b2": b2}
    if count_cost:
        out.update(node_cnt=node_cnt, prim_cnt=prim_cnt)
    return out


def occlusion_bvh(geom: Geometry, bvh: BVHArrays, o: torch.Tensor, d: torch.Tensor,
                  t_far: torch.Tensor, max_leaf: int | None = None) -> torch.Tensor:
    """Any-hit shadow test before t_far * (1 - SHADOW_T_SCALE); a lane stops
    at its first occluder. True = occluded."""
    max_leaf = bvh.max_leaf if max_leaf is None else max_leaf
    B = o.shape[0]
    M = bvh.num_nodes
    N = geom.num_prims
    dev = o.device
    inv_d = _inv_dir(d)
    karange = torch.arange(max_leaf, device=dev)[None, :]
    t_lim = t_far * (1.0 - isect.SHADOW_T_SCALE)
    occ = torch.zeros(B, dtype=torch.bool, device=dev)
    ptr = torch.zeros(B, dtype=torch.int64, device=dev)
    idx = torch.arange(B, device=dev)
    while idx.numel() > 0:
        pc = ptr[idx]
        o_i, d_i, tl_i = o[idx], d[idx], t_lim[idx]
        box_hit = _slab(bvh.node_min[pc], bvh.node_max[pc], o_i, inv_d[idx], tl_i)
        cnt = bvh.node_count[pc].long()
        is_leaf = cnt > 0
        leaf = box_hit & is_leaf
        found = torch.zeros_like(box_hit)
        if bool(leaf.any()):
            li = torch.nonzero(leaf)[:, 0]
            ids = torch.clamp(bvh.node_base[pc[li]].long()[:, None] + karange, 0, N - 1)
            valid = karange < cnt[li][:, None]
            t_k, hit_k, _, _ = isect.intersect_gather(geom, o_i[li], d_i[li], ids, valid)
            found[li] = torch.any(hit_k & (t_k < tl_i[li][:, None]), dim=-1)
        occ[idx] = found
        ptr_next = torch.where(box_hit & ~is_leaf, pc + 1, bvh.node_skip[pc].long())
        ptr_next = torch.where(found, M, ptr_next)
        ptr[idx] = ptr_next
        idx = idx[ptr_next < M]
    return occ
