"""Batched ray-primitive intersection, brute force (port of
cuda_pt_tpu/ops/intersect.py). Möller-Trumbore on (B, N) ray x prim blocks;
spheres ride in triangle slots (p0 = center, e1.x = radius).

The arithmetic order of the triangle test is the one the CUDA walk in
csrc/walk.cuh uses, so on the same ray both give the same t, b1, b2.
"""

from __future__ import annotations

import math

import torch

from ..core import math as vm
from ..scene.types import Geometry

HIT_EPS = 1e-4
# Shadow and continuation rays start this far off the surface along the
# geometric normal; the shadow test shortens its limit by the same amount.
# Shared by the plain path (models/path_tracer.py) and the CUDA kernel
# (csrc/common.cuh, RAY_OFFSET).
RAY_OFFSET = 1e-3
# Any-hit tests count a hit only before t_far * (1 - SHADOW_T_SCALE).
SHADOW_T_SCALE = 1e-3


def intersect_gather(geom: Geometry, o: torch.Tensor, d: torch.Tensor,
                     prim_ids: torch.Tensor, valid: torch.Tensor):
    """Intersect each ray with K gathered prims. Returns (t, hit, b1, b2),
    all (B, K); t = +inf where there is no hit."""
    p0 = geom.p0[prim_ids]
    e1 = geom.e1[prim_ids]
    e2 = geom.e2[prim_ids]
    sph = geom.is_sphere[prim_ids]
    ob = o[:, None, :]
    db = d[:, None, :].expand(p0.shape)

    h = vm.cross(db, e2)
    a = vm.dot(e1, h)
    f = 1.0 / torch.where(torch.abs(a) < 1e-12, 1e-12, a)
    s = ob - p0
    u = f * vm.dot(s, h)
    q = vm.cross(s, e1)
    v = f * vm.dot(db, q)
    t_tri = f * vm.dot(e2, q)
    tri_ok = (torch.abs(a) > 1e-12) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t_tri > HIT_EPS)

    r = e1[..., 0]
    oc = ob - p0
    b_half = vm.dot(oc, db)
    cc = vm.dot(oc, oc) - r * r
    disc = b_half * b_half - cc
    disc_pos = disc > 0.0
    sq = torch.where(disc_pos, torch.sqrt(torch.where(disc_pos, disc, 1.0)), 0.0)
    t0 = -b_half - sq
    t1 = -b_half + sq
    t_sph = torch.where(t0 > HIT_EPS, t0, t1)
    sph_ok = disc_pos & (t_sph > HIT_EPS)

    t = torch.where(sph, t_sph, t_tri)
    hit = torch.where(sph, sph_ok, tri_ok) & valid
    t = torch.where(hit, t, math.inf)
    b1 = torch.where(sph, 0.0, u)
    b2 = torch.where(sph, 0.0, v)
    return t, hit, b1, b2


def all_prims(geom: Geometry, B: int):
    N = geom.num_prims
    ids = torch.arange(N, device=geom.p0.device).expand(B, N)
    return ids, torch.ones((B, N), dtype=torch.bool, device=geom.p0.device)


def closest_hit_brute(geom: Geometry, o: torch.Tensor, d: torch.Tensor):
    """O(N) closest hit over every prim; the lowest prim id wins exact ties.
    Returns dict(t, prim (int64, -1 = miss), hit, b1, b2)."""
    B = o.shape[0]
    t, hit, b1, b2 = intersect_gather(geom, o, d, *all_prims(geom, B))
    k = torch.argmin(t, dim=-1, keepdim=True)
    hit_k = torch.gather(hit, 1, k)[:, 0]
    return {
        "t": torch.gather(t, 1, k)[:, 0],
        "prim": torch.where(hit_k, k[:, 0], -1),
        "hit": hit_k,
        "b1": torch.gather(b1, 1, k)[:, 0],
        "b2": torch.gather(b2, 1, k)[:, 0],
    }


def occlusion_brute(geom: Geometry, o: torch.Tensor, d: torch.Tensor, t_far: torch.Tensor):
    """Any-hit test up to t_far (shadow rays). True = occluded."""
    B = o.shape[0]
    t, hit, _, _ = intersect_gather(geom, o, d, *all_prims(geom, B))
    occluded = hit & (t < t_far[:, None] * (1.0 - SHADOW_T_SCALE))
    return torch.any(occluded, dim=-1)


def surface_interaction(geom: Geometry, prim: torch.Tensor, b1, b2, p_hit, d):
    """Interpolated hit record: dict(n_s shading normal, n_g geometric
    normal flipped into n_s's hemisphere, uv, obj). prim must be clamped
    to a valid id by the caller."""
    sph = geom.is_sphere[prim]
    w = (1.0 - b1 - b2)[:, None]
    n_tri = vm.normalize(w * geom.n0[prim] + b1[:, None] * geom.n1[prim]
                         + b2[:, None] * geom.n2[prim])
    uv_tri = w * geom.uv0[prim] + b1[:, None] * geom.uv1[prim] + b2[:, None] * geom.uv2[prim]
    e1 = geom.e1[prim]
    ng_tri = vm.normalize(vm.cross(e1, geom.e2[prim]))
    ng_tri = torch.where(vm.dot(ng_tri, n_tri, keepdim=True) < 0.0, -ng_tri, ng_tri)

    r = torch.clamp(e1[..., 0:1], min=1e-8)
    n_sph = vm.normalize((p_hit - geom.p0[prim]) / r)
    u_sph = torch.atan2(n_sph[..., 1], n_sph[..., 0]) / (2.0 * math.pi) + 0.5
    v_sph = torch.acos(torch.clamp(n_sph[..., 2], -1.0, 1.0)) / math.pi
    uv_sph = torch.stack([u_sph, v_sph], dim=-1)

    sphb = sph[:, None]
    return {
        "n_s": torch.where(sphb, n_sph, n_tri),
        "n_g": torch.where(sphb, n_sph, ng_tri),
        "uv": torch.where(sphb, uv_sph, uv_tri),
        "obj": geom.obj_idx[prim].long(),
    }
