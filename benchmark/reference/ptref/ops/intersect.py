"""Batched ray-primitive intersection by brute force, frozen from the
program's plain version (Möller-Trumbore; spheres ride in triangle slots:
p0 = center, e1.x = radius), in the arithmetic order of the program's
triangle test, so both give the same t, b1, b2 on the same ray. The
closest hit and the shadow test run over every prim in blocks of rays
x prims (BLOCK_PAIRS), so that a full scene fits on the card.
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


BLOCK_PAIRS = 1 << 24  # ray x prim pairs per block of the brute force


def _blocks(geom: Geometry, B: int):
    """(lane slice, prim slice) blocks of at most BLOCK_PAIRS pairs."""
    N = geom.num_prims
    pc = min(N, max(1, BLOCK_PAIRS // max(B, 1)))
    lc = max(1, min(B, BLOCK_PAIRS // pc))
    for l0 in range(0, B, lc):
        for p0 in range(0, N, pc):
            yield slice(l0, min(l0 + lc, B)), slice(p0, min(p0 + pc, N))


def _intersect_range(geom: Geometry, o: torch.Tensor, d: torch.Tensor, ps: slice):
    """intersect_gather's test of each ray against the prims ps, broadcast
    instead of gathered: (t, hit, b1, b2), all (B, len(ps))."""
    p0 = geom.p0[ps][None]
    e1 = geom.e1[ps][None]
    e2 = geom.e2[ps][None]
    sph = geom.is_sphere[ps][None]
    ob = o[:, None, :]
    db = d[:, None, :]

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
    hit = torch.where(sph, sph_ok, tri_ok)
    t = torch.where(hit, t, math.inf)
    b1 = torch.where(sph, 0.0, u)
    b2 = torch.where(sph, 0.0, v)
    return t, hit, b1, b2


def closest_hit_brute(geom: Geometry, o: torch.Tensor, d: torch.Tensor):
    """O(N) closest hit over every prim; the lowest prim id wins exact ties.
    Returns dict(t, prim (int64, -1 = miss), hit, b1, b2)."""
    B = o.shape[0]
    dev = o.device
    best_t = torch.full((B,), math.inf, device=dev)
    best_k = torch.full((B,), -1, dtype=torch.int64, device=dev)
    best_b1 = torch.zeros(B, device=dev)
    best_b2 = torch.zeros(B, device=dev)
    for ls, ps in _blocks(geom, B):
        t, hit, b1, b2 = _intersect_range(geom, o[ls], d[ls], ps)
        k = torch.argmin(t, dim=-1, keepdim=True)
        tk = torch.gather(t, 1, k)[:, 0]
        hk = torch.gather(hit, 1, k)[:, 0]
        # strictly nearer only: an earlier block holds the lower prim ids
        take = hk & (tk < best_t[ls])
        best_t[ls] = torch.where(take, tk, best_t[ls])
        best_k[ls] = torch.where(take, k[:, 0] + ps.start, best_k[ls])
        best_b1[ls] = torch.where(take, torch.gather(b1, 1, k)[:, 0], best_b1[ls])
        best_b2[ls] = torch.where(take, torch.gather(b2, 1, k)[:, 0], best_b2[ls])
    hit = best_k >= 0
    return {"t": best_t, "prim": best_k, "hit": hit, "b1": best_b1, "b2": best_b2}


def occlusion_brute(geom: Geometry, o: torch.Tensor, d: torch.Tensor, t_far: torch.Tensor):
    """Any-hit test up to t_far (shadow rays). True = occluded."""
    B = o.shape[0]
    occ = torch.zeros(B, dtype=torch.bool, device=o.device)
    for ls, ps in _blocks(geom, B):
        t, hit, _, _ = _intersect_range(geom, o[ls], d[ls], ps)
        blocked = hit & (t < t_far[ls][:, None] * (1.0 - SHADOW_T_SCALE))
        occ[ls] |= torch.any(blocked, dim=-1)
    return occ


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
