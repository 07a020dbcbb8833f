"""Emitter sampling and evaluation (port of cuda_pt_tpu/emitters/emitters.py
for area and point emitters; envmap and area-spot emitters wait for their
ROADMAP item and raise).

NEE strategy pdf: power-weighted emitter pick (sel_pmf), area-weighted
prim pick and uniform point on the prim for area emitters (solid-angle
pdf), delta for point sources.
"""

from __future__ import annotations

import torch

from ..core import math as vm
from ..core import rng as prng
from ..core import sampling
from ..scene import types as T

PORTED_EMITTERS = (T.EMITTER_NULL, T.EMITTER_POINT, T.EMITTER_AREA)


def check_supported(scene: T.Scene):
    etypes = {int(x) for x in scene.emitters.etype.tolist()}
    missing = etypes - set(PORTED_EMITTERS)
    if missing or scene.env_emitter > 0:
        raise NotImplementedError(
            f"emitter types {sorted(missing)} (envmap / area-spot) wait for "
            "ROADMAP Queue 1 item 2 (ported: area, point)")
    if bool((scene.emitters.tex_id >= 0).any()):
        raise NotImplementedError("textured emitters wait for ROADMAP Queue 1 item 2")


def emitter_radiance(scene: T.Scene, eid: torch.Tensor) -> torch.Tensor:
    """Le of emitter eid (untextured)."""
    e = scene.emitters
    return e.emission[eid] * e.scaler[eid][:, None]


def emitter_radiance_hit(scene: T.Scene, eid: torch.Tensor, cos_l: torch.Tensor) -> torch.Tensor:
    """Le toward the viewer for a hit on emitter eid. cos_l is accepted for
    parity with the reference, whose area-spot gate uses it."""
    return emitter_radiance(scene, eid)


def sample_emitter(scene: T.Scene, p: torch.Tensor, n: torch.Tensor, rng_state: torch.Tensor):
    """One NEE candidate per ray. Draw order (three pcg advances): u_sel,
    u_prim (1d each), u_pos (2d).

    Returns ({dir, dist, le, pdf, valid, delta, prim, eid}, rng_state)."""
    e = scene.emitters
    g = scene.geom

    u_sel, rng_state = prng.next1d(rng_state)
    u_prim, rng_state = prng.next1d(rng_state)
    u_pos, rng_state = prng.next2d(rng_state)

    eid = torch.sum((e.sel_cdf[None, :] < u_sel[:, None]).to(torch.int64), -1)
    eid = torch.clamp(eid, 1, e.etype.shape[0] - 1)
    etype = e.etype[eid]
    sel_pdf = torch.clamp(e.sel_pmf[eid], min=1e-12)

    # area: pick a prim by the emitter's CDF, a point by the sqrt warp
    cdf = e.prim_cdf[eid]
    kidx = torch.sum((cdf < u_prim[:, None]).to(torch.int64), -1)
    kidx = torch.clamp(kidx, max=cdf.shape[1] - 1)
    prim = e.prim_sel[eid, kidx].long()

    sph = g.is_sphere[prim]
    bary = sampling.uniform_triangle(u_pos)
    b1, b2 = bary[..., 0], bary[..., 1]
    pos_tri = g.p0[prim] + b1[:, None] * g.e1[prim] + b2[:, None] * g.e2[prim]
    n_tri = vm.normalize(vm.cross(g.e1[prim], g.e2[prim]))
    sdir, _ = sampling.uniform_sphere(u_pos)
    pos_sph = g.p0[prim] + sdir * g.e1[prim][:, 0:1]
    pos_l = torch.where(sph[:, None], pos_sph, pos_tri)
    n_l = torch.where(sph[:, None], sdir, n_tri)

    to_l = pos_l - p
    dist = vm.length(to_l)
    dirn = to_l / torch.clamp(dist, min=1e-8)[:, None]
    cos_l = -vm.dot(dirn, n_l)
    front = cos_l > 1e-6  # area lights emit from the front face only
    inv_area = scene.objects.inv_area[torch.clamp(e.obj_id[eid], min=0).long()]
    pdf_area = sel_pdf * inv_area * (dist * dist) / torch.clamp(cos_l, min=1e-6)
    le = emitter_radiance(scene, eid)

    # point source
    to_p = e.pos[eid] - p
    dist_p = vm.length(to_p)
    dir_p = to_p / torch.clamp(dist_p, min=1e-8)[:, None]
    le_point = le / torch.clamp(dist_p * dist_p, min=1e-8)[:, None]
    pdf_point = torch.ones_like(dist_p) * sel_pdf

    is_area = etype == T.EMITTER_AREA
    is_point = etype == T.EMITTER_POINT
    dirn_out = torch.where(is_point[:, None], dir_p, dirn)
    dist_out = torch.where(is_point, dist_p, dist)
    le_out = torch.where(is_point[:, None], le_point, le)
    pdf = torch.where(is_point, pdf_point, pdf_area)
    valid = torch.where(is_area, front, True) & (etype != T.EMITTER_NULL)
    valid = valid & (torch.amax(le_out, dim=-1) > 0.0) & (pdf > 1e-12)
    return {"dir": dirn_out, "dist": dist_out, "le": le_out, "pdf": pdf, "valid": valid,
            "delta": is_point, "prim": prim, "eid": eid}, rng_state


def hit_emitter_pdf(scene: T.Scene, obj: torch.Tensor, t: torch.Tensor, cos_l: torch.Tensor):
    """Solid-angle pdf that NEE would have generated a BSDF-sampled hit on
    an area emitter (MIS weight at emitter hits)."""
    obj = torch.clamp(obj, min=0).long()
    eid = scene.objects.emitter_id[obj].long()
    sel = scene.emitters.sel_pmf[torch.clamp(eid, 0, scene.emitters.sel_pmf.shape[0] - 1)]
    inv_area = scene.objects.inv_area[obj]
    return sel * inv_area * (t * t) / torch.clamp(cos_l, min=1e-6)
