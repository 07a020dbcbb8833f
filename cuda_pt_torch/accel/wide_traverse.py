"""Batched 8-wide BVH walks with per-lane ordered stacks in PyTorch (port of
cuda_pt_tpu/accel/wide_traverse.py), the walk of traversal "wide".

Each step pops one stack entry per walking lane: an interior entry
slab-tests its 8 children and pushes the hit ones far to near (a stable
sort of -t_near, so the nearest is popped first), a leaf entry tests its
prims (the skip walk's fixed-K gather), and an entry whose recorded
t_near is not below the lane's best t is dropped at the pop. The any-hit
walk pushes hit children in slot order and stops a lane at its first
occluder. As in the skip walk (accel/traverse.py), each step works on the
lanes that are still walking only; ties go to the lowest slot of the
first leaf that reaches the smallest t, as in the reference.
"""

from __future__ import annotations

import math

import torch

from ..ops import intersect as isect
from ..scene.types import Geometry, WideBVHArrays
from .traverse import _inv_dir
from .wide_build import EMPTY


def _child_slabs(wb: WideBVHArrays, nid, o, inv_d, t_best):
    """(n, 8) t_near and hit mask of the children of wide nodes nid; empty
    slots (inverted boxes pass the slab test) never hit. bf16 boxes
    (rounded outward at build) upcast to f32."""
    t0 = (wb.child_min[nid].float() - o[:, None, :]) * inv_d[:, None, :]
    t1 = (wb.child_max[nid].float() - o[:, None, :]) * inv_d[:, None, :]
    tn = torch.amax(torch.minimum(t0, t1), dim=-1)
    tf = torch.amin(torch.maximum(t0, t1), dim=-1)
    hit = (tn <= tf) & (tf > isect.HIT_EPS) & (tn < t_best[:, None]) \
        & (wb.child_node[nid] != int(EMPTY))
    return tn, hit


def _push(stack, sp, lanes, ent, npush, vals=None, stack_t=None):
    """Push ent[:, :npush] (and vals) onto the stacks of lanes, in order."""
    cap = stack.shape[1] - 1  # the last column takes nothing but overflow
    for r in range(ent.shape[1]):
        m = r < npush
        if not bool(m.any()):
            break
        rows = lanes[m]
        pos = torch.clamp(sp[rows] + r, max=cap)
        stack[rows, pos] = ent[m, r]
        if vals is not None:
            stack_t[rows, pos] = vals[m, r]
    sp[lanes] += npush


def closest_hit_wide(geom: Geometry, wb: WideBVHArrays, o: torch.Tensor, d: torch.Tensor):
    """Closest hit; the contract of accel/traverse.closest_hit_bvh."""
    B = o.shape[0]
    dev = o.device
    N = geom.num_prims
    inv_d = _inv_dir(d)
    karange = torch.arange(wb.max_leaf, device=dev)[None, :]
    stack = torch.zeros((B, wb.max_stack + 1), dtype=torch.int64, device=dev)  # root 0
    stack_t = torch.full((B, wb.max_stack + 1), math.inf, device=dev)
    stack_t[:, 0] = 0.0
    sp = torch.ones(B, dtype=torch.int64, device=dev)
    t = torch.full((B,), math.inf, device=dev)
    prim = torch.full((B,), -1, dtype=torch.int64, device=dev)
    b1 = torch.zeros(B, device=dev)
    b2 = torch.zeros(B, device=dev)
    idx = torch.arange(B, device=dev)  # lanes still walking
    while idx.numel() > 0:
        top = sp[idx] - 1
        e, e_tn = stack[idx, top], stack_t[idx, top]
        sp[idx] = top
        t_i = t[idx]
        act = e_tn < t_i  # ordered descent: drop what a closer hit outran
        is_leaf = e < 0
        leaf = act & is_leaf
        if bool(leaf.any()):
            li = torch.nonzero(leaf)[:, 0]
            lanes = idx[li]
            lid = torch.clamp(-e[li] - 1, 0, wb.num_leaves - 1)
            ids = torch.clamp(wb.leaf_base[lid].long()[:, None] + karange, 0, N - 1)
            valid = karange < wb.leaf_count[lid].long()[:, None]
            t_k, hit_k, b1_k, b2_k = isect.intersect_gather(geom, o[lanes], d[lanes], ids, valid)
            t_k = torch.where(hit_k & (t_k < t_i[li][:, None]), t_k, math.inf)
            k = torch.argmin(t_k, dim=-1, keepdim=True)
            t_new = torch.gather(t_k, 1, k)[:, 0]
            better = torch.isfinite(t_new)
            up = lanes[better]
            t[up] = t_new[better]
            prim[up] = torch.gather(ids, 1, k)[:, 0][better]
            b1[up] = torch.gather(b1_k, 1, k)[:, 0][better]
            b2[up] = torch.gather(b2_k, 1, k)[:, 0][better]
        expand = act & ~is_leaf
        if bool(expand.any()):
            xi = torch.nonzero(expand)[:, 0]
            lanes, nid = idx[xi], e[xi]
            tn_c, hit_c = _child_slabs(wb, nid, o[lanes], inv_d[lanes], t_i[xi])
            order = torch.argsort(torch.where(hit_c, -tn_c, math.inf), dim=-1, stable=True)
            ent = torch.gather(wb.child_node[nid].long(), 1, order)
            etn = torch.gather(tn_c, 1, order)
            _push(stack, sp, lanes, ent, hit_c.sum(dim=-1), etn, stack_t)
        idx = idx[sp[idx] > 0]
    return {"t": t, "prim": prim, "hit": prim >= 0, "b1": b1, "b2": b2}


def occlusion_wide(geom: Geometry, wb: WideBVHArrays, o: torch.Tensor, d: torch.Tensor,
                   t_far: torch.Tensor) -> torch.Tensor:
    """Any-hit shadow test before t_far * (1 - SHADOW_T_SCALE): hit children
    pushed in slot order, a lane stops at its first occluder. True =
    occluded."""
    B = o.shape[0]
    dev = o.device
    N = geom.num_prims
    inv_d = _inv_dir(d)
    karange = torch.arange(wb.max_leaf, device=dev)[None, :]
    t_lim = t_far * (1.0 - isect.SHADOW_T_SCALE)
    stack = torch.zeros((B, wb.max_stack + 1), dtype=torch.int64, device=dev)
    sp = torch.ones(B, dtype=torch.int64, device=dev)
    occ = torch.zeros(B, dtype=torch.bool, device=dev)
    idx = torch.arange(B, device=dev)
    while idx.numel() > 0:
        top = sp[idx] - 1
        e = stack[idx, top]
        sp[idx] = top
        is_leaf = e < 0
        if bool(is_leaf.any()):
            li = torch.nonzero(is_leaf)[:, 0]
            lanes = idx[li]
            lid = torch.clamp(-e[li] - 1, 0, wb.num_leaves - 1)
            ids = torch.clamp(wb.leaf_base[lid].long()[:, None] + karange, 0, N - 1)
            valid = karange < wb.leaf_count[lid].long()[:, None]
            t_k, hit_k, _, _ = isect.intersect_gather(geom, o[lanes], d[lanes], ids, valid)
            found = torch.any(hit_k & (t_k < t_lim[lanes][:, None]), dim=-1)
            occ[lanes[found]] = True
            sp[lanes[found]] = 0  # early out
        expand = ~is_leaf
        if bool(expand.any()):
            xi = torch.nonzero(expand)[:, 0]
            lanes, nid = idx[xi], e[xi]
            _, hit_c = _child_slabs(wb, nid, o[lanes], inv_d[lanes], t_lim[lanes])
            order = torch.argsort((~hit_c).to(torch.int8), dim=-1, stable=True)  # hits first
            ent = torch.gather(wb.child_node[nid].long(), 1, order)
            _push(stack, sp, lanes, ent, hit_c.sum(dim=-1))
        idx = idx[sp[idx] > 0]
    return occ
