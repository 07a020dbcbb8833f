"""Emitter sampling and evaluation: point, area, area-spot and envmap
(port of cuda_pt_tpu/emitters/emitters.py), and ``sample_le``, the light
tracer's emission sampling (models/light_tracer.py).

NEE strategy pdf: power-weighted emitter pick (sel_pmf), area-weighted
prim pick and uniform point on the prim for area emitters (solid-angle
pdf), delta for point sources, and for the envmap either the luminance
importance tables (when the builder made them) or a cosine hemisphere.
"""

from __future__ import annotations

import math

import torch

from ..core import math as vm
from ..core import rng as prng
from ..core import sampling
from ..scene import textures as tex
from ..scene import types as T

MAX_DIST = 1e7  # core/math.MAX_DIST of the reference: envmap shadow rays


def emitter_radiance(scene: T.Scene, eid: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Le of emitter eid, texture-modulated at surface uv."""
    e = scene.emitters
    base = e.emission[eid] * e.scaler[eid][:, None]
    return tex.scaled_rgb(scene.textures, e.tex_id[eid], uv, base)


def emitter_radiance_hit(scene: T.Scene, eid: torch.Tensor, uv: torch.Tensor,
                         cos_l: torch.Tensor) -> torch.Tensor:
    """Le toward the viewer for a hit on emitter eid, zero outside an
    area-spot emitter's cone (the NEE side gates the same way)."""
    le = emitter_radiance(scene, eid, uv)
    in_cone = cos_l >= scene.emitters.extra[eid, 0]
    gate = (scene.emitters.etype[eid] != T.EMITTER_AREA_SPOT) | in_cone
    return torch.where(gate[..., None], le, 0.0)


def _rot_x(d: torch.Tensor, ang) -> torch.Tensor:
    """Rotate direction(s) about +x by ang radians (the envmap zenith tilt)."""
    c, s = torch.cos(ang), torch.sin(ang)
    y = c * d[..., 1] - s * d[..., 2]
    z = s * d[..., 1] + c * d[..., 2]
    return torch.stack([d[..., 0], y, z], dim=-1)


def env_uv(extra: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Lat-long texture coordinates of direction d under the envmap's
    runtime azimuth (extra[1]) and zenith tilt (extra[2])."""
    dz = _rot_x(d, extra[2])
    phi = torch.atan2(dz[..., 2], dz[..., 0]) + extra[1]
    theta = torch.acos(torch.clamp(dz[..., 1], -1.0, 1.0))
    return torch.stack([phi / (2.0 * math.pi) + 0.5, theta / math.pi], dim=-1)


def env_radiance(scene: T.Scene, d: torch.Tensor) -> torch.Tensor:
    """Environment radiance (B, 3) toward direction d (lat-long HDRI with
    runtime scale, azimuth and zenith rotation); zero without an envmap."""
    eid = scene.env_emitter
    if eid <= 0:
        return torch.zeros_like(d)
    e = scene.emitters
    uv = env_uv(e.extra[eid], d)
    tid = torch.broadcast_to(e.tex_id[eid], d.shape[:-1])
    texv = tex.sample_texture(scene.textures, tid, uv)[..., :3]
    base = e.emission[eid] * e.scaler[eid]
    return texv * base * torch.clamp(e.extra[eid, 0], min=0.0)


def sample_emitter(scene: T.Scene, p: torch.Tensor, n: torch.Tensor, rng_state: torch.Tensor):
    """One NEE candidate per ray. Draw order: u_sel, u_prim (1d each),
    u_pos (2d), and u_tex (2d) when the scene has envmap importance tables.

    Returns ({dir, dist, le, pdf, valid, delta, prim, eid}, rng_state)."""
    B = p.shape[0]
    e = scene.emitters
    g = scene.geom

    u_sel, rng_state = prng.next1d(rng_state)
    u_prim, rng_state = prng.next1d(rng_state)
    u_pos, rng_state = prng.next2d(rng_state)

    eid = torch.sum((e.sel_cdf[None, :] < u_sel[:, None]).to(torch.int64), -1)
    eid = torch.clamp(eid, 1, e.etype.shape[0] - 1)
    etype = e.etype[eid]
    sel_pdf = torch.clamp(e.sel_pmf[eid], min=1e-12)

    # area / area-spot: a prim by the emitter's CDF, a point by the sqrt warp
    cdf = e.prim_cdf[eid]
    kidx = torch.sum((cdf < u_prim[:, None]).to(torch.int64), -1)
    kidx = torch.clamp(kidx, max=cdf.shape[1] - 1)
    prim = e.prim_sel[eid, kidx].long()
    sph = g.is_sphere[prim]
    bary = sampling.uniform_triangle(u_pos)
    b1, b2 = bary[..., 0], bary[..., 1]
    pos_tri = g.p0[prim] + b1[:, None] * g.e1[prim] + b2[:, None] * g.e2[prim]
    n_tri = vm.normalize(vm.cross(g.e1[prim], g.e2[prim]))
    uv_tri = ((1.0 - b1 - b2)[:, None] * g.uv0[prim] + b1[:, None] * g.uv1[prim]
              + b2[:, None] * g.uv2[prim])
    sdir, _ = sampling.uniform_sphere(u_pos)
    pos_sph = g.p0[prim] + sdir * g.e1[prim][:, 0:1]
    pos_l = torch.where(sph[:, None], pos_sph, pos_tri)
    n_l = torch.where(sph[:, None], sdir, n_tri)
    uv_l = torch.where(sph[:, None], torch.zeros_like(uv_tri), uv_tri)

    to_l = pos_l - p
    dist = vm.length(to_l)
    dirn = to_l / torch.clamp(dist, min=1e-8)[:, None]
    cos_l = -vm.dot(dirn, n_l)
    front = cos_l > 1e-6  # area lights emit from the front face only
    inv_area = scene.objects.inv_area[torch.clamp(e.obj_id[eid], min=0).long()]
    pdf_area = sel_pdf * inv_area * (dist * dist) / torch.clamp(cos_l, min=1e-6)
    in_cone = cos_l >= e.extra[eid, 0]
    le_area = torch.where(((etype != T.EMITTER_AREA_SPOT) | in_cone)[:, None],
                          emitter_radiance(scene, eid, uv_l), 0.0)

    # point source
    to_p = e.pos[eid] - p
    dist_p = vm.length(to_p)
    dir_p = to_p / torch.clamp(dist_p, min=1e-8)[:, None]
    le_point = (emitter_radiance(scene, eid, torch.zeros_like(uv_l))
                / torch.clamp(dist_p * dist_p, min=1e-8)[:, None])
    pdf_point = torch.ones_like(dist_p) * sel_pdf

    # envmap
    imp = scene.env_importance
    if imp is not None and imp.enabled:
        # luminance-CDF importance sampling over texels
        u_tex, rng_state = prng.next2d(rng_state)
        Hh, Ww = imp.pmf.shape
        row = torch.sum((imp.row_cdf[None, :] < u_pos[:, 0:1]).to(torch.int64), -1)
        row = torch.clamp(row, max=Hh - 1)
        col = torch.sum((imp.col_cdf[row] < u_pos[:, 1:2]).to(torch.int64), -1)
        col = torch.clamp(col, max=Ww - 1)
        v = (row.to(torch.float32) + u_tex[:, 0]) / Hh
        u_ = (col.to(torch.float32) + u_tex[:, 1]) / Ww
        theta = v * math.pi
        extra = e.extra[scene.env_emitter]
        phi = (u_ - 0.5) * (2.0 * math.pi) - extra[1]
        st = torch.sin(theta)
        dir_env = torch.stack([st * torch.cos(phi), torch.cos(theta), st * torch.sin(phi)], dim=-1)
        dir_env = _rot_x(dir_env, -extra[2])  # texel frame -> world
        le_env = env_radiance(scene, dir_env)
        pdf_env = sel_pdf * imp.pmf[row, col] * (Hh * Ww) / torch.clamp(
            2.0 * math.pi * math.pi * st, min=1e-6)
    else:
        d_loc, pdf_loc = sampling.cosine_hemisphere(u_pos)
        dir_env = vm.to_world(d_loc, n)
        le_env = env_radiance(scene, dir_env)
        pdf_env = sel_pdf * pdf_loc

    is_area = (etype == T.EMITTER_AREA) | (etype == T.EMITTER_AREA_SPOT)
    is_point = etype == T.EMITTER_POINT
    is_env = etype == T.EMITTER_ENVMAP
    dirn_out = torch.where(is_point[:, None], dir_p, torch.where(is_env[:, None], dir_env, dirn))
    dist_out = torch.where(is_point, dist_p, torch.where(is_env, MAX_DIST, dist))
    le = torch.where(is_point[:, None], le_point, torch.where(is_env[:, None], le_env, le_area))
    pdf = torch.where(is_point, pdf_point, torch.where(is_env, pdf_env, pdf_area))
    valid = torch.where(is_area, front, True) & (etype != T.EMITTER_NULL)
    valid = valid & (torch.amax(le, dim=-1) > 0.0) & (pdf > 1e-12)
    return {"dir": dirn_out, "dist": dist_out, "le": le, "pdf": pdf, "valid": valid,
            "delta": is_point, "prim": prim, "eid": eid}, rng_state


def sample_le(scene: T.Scene, rng_state: torch.Tensor, n_lanes: int):
    """Emission position and direction for light tracing (reference
    emitters.py:227). Draw order: u_sel, u_prim (1d each), u_pos, u_dir
    (2d each). The emitter by sel_cdf, then for area and area-spot
    emitters a prim by its prim_cdf, a point on it and a cosine-hemisphere
    direction; point sources a uniform-sphere direction. An envmap's (or
    the null emitter's) draws are invalid.

    Returns ({pos, dir, n, thp0, thp_pos, valid, is_point, cos_gate},
    rng_state): thp0 is the path's initial throughput Le cos / (p_sel p_A
    p_w), zero for an area-spot direction outside the cone; thp_pos the
    positional throughput Le A / p_sel of the vertex-0 camera connection
    (zero for point sources); cos_gate the area-spot cone's cosine (-1 for
    every other type). pos, dir and n are detached, as in the reference."""
    e = scene.emitters
    g = scene.geom
    B = n_lanes
    u_sel, rng_state = prng.next1d(rng_state)
    u_prim, rng_state = prng.next1d(rng_state)
    u_pos, rng_state = prng.next2d(rng_state)
    u_dir, rng_state = prng.next2d(rng_state)

    eid = torch.sum((e.sel_cdf[None, :] < u_sel[:, None]).to(torch.int64), -1)
    eid = torch.clamp(eid, 1, e.etype.shape[0] - 1)
    etype = e.etype[eid]
    sel_pdf = torch.clamp(e.sel_pmf[eid], min=1e-12)

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

    # cosine-weighted emission: Le cos / (p_A p_w) = Le pi / p_A
    d_loc, _ = sampling.cosine_hemisphere(u_dir)
    dir_area = vm.to_world(d_loc, n_l)
    area = 1.0 / torch.clamp(scene.objects.inv_area[torch.clamp(e.obj_id[eid], min=0).long()],
                             min=1e-12)
    le = emitter_radiance(scene, eid, torch.zeros((B, 2), device=u_sel.device))
    # an area-spot emitter emits inside its cone only (NEE's gate)
    in_cone = d_loc[..., 2] >= e.extra[eid, 0]
    spot_gate = torch.where((etype == T.EMITTER_AREA_SPOT) & ~in_cone, 0.0, 1.0)
    thp_area = le * (math.pi * area * spot_gate / sel_pdf)[..., None]

    dir_pnt, _ = sampling.uniform_sphere(u_dir)
    thp_pnt = le * (4.0 * math.pi / sel_pdf)[..., None]

    is_point = etype == T.EMITTER_POINT
    is_area = (etype == T.EMITTER_AREA) | (etype == T.EMITTER_AREA_SPOT)
    pos = torch.where(is_point[:, None], e.pos[eid], pos_l)
    dirn = torch.where(is_point[:, None], dir_pnt, dir_area)
    nrm = torch.where(is_point[:, None], dirn, n_l)
    out = {
        "pos": pos.detach(),
        "dir": dirn.detach(),
        "n": nrm.detach(),
        "thp0": torch.where(is_point[:, None], thp_pnt, thp_area),
        "thp_pos": torch.where(is_area[:, None], le * (area / sel_pdf)[..., None],
                               torch.zeros_like(le)),
        "valid": is_point | is_area,
        "is_point": is_point,
        "cos_gate": torch.where(etype == T.EMITTER_AREA_SPOT, e.extra[eid, 0], -1.0),
    }
    return out, rng_state


def hit_emitter_pdf(scene: T.Scene, obj: torch.Tensor, t: torch.Tensor, cos_l: torch.Tensor):
    """Solid-angle pdf that NEE would have generated a BSDF-sampled hit on
    an area emitter (MIS weight at emitter hits)."""
    obj = torch.clamp(obj, min=0).long()
    return hit_emitter_pdf_of(scene, scene.objects.emitter_id[obj].long(),
                              scene.objects.inv_area[obj], t, cos_l)


def hit_emitter_pdf_of(scene: T.Scene, eid: torch.Tensor, inv_area: torch.Tensor, t: torch.Tensor,
                       cos_l: torch.Tensor):
    """hit_emitter_pdf from the hit object's emitter id and 1 / area."""
    sel = scene.emitters.sel_pmf[torch.clamp(eid, 0, scene.emitters.sel_pmf.shape[0] - 1)]
    return sel * inv_area * (t * t) / torch.clamp(cos_l, min=1e-6)


def env_nee_pdf(scene: T.Scene, n_prev: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Solid-angle pdf that envmap NEE at the previous vertex picks
    direction d (for envmap MIS); matches sample_emitter's strategy."""
    eid = scene.env_emitter
    if eid <= 0:
        return torch.zeros_like(d[..., 0])
    sel = scene.emitters.sel_pmf[eid]
    imp = scene.env_importance
    if imp is not None and imp.enabled:
        Hh, Ww = imp.pmf.shape
        extra = scene.emitters.extra[eid]
        dz = _rot_x(d, extra[2])
        phi = torch.atan2(dz[..., 2], dz[..., 0]) + extra[1]
        theta = torch.acos(torch.clamp(dz[..., 1], -1.0, 1.0))
        u = phi / (2.0 * math.pi) + 0.5
        v = theta / math.pi
        col = torch.clamp((u - torch.floor(u)) * Ww, 0, Ww - 1).to(torch.int64)
        row = torch.clamp(v * Hh, 0, Hh - 1).to(torch.int64)
        st = torch.clamp(torch.sin(theta), min=1e-6)
        return imp.pmf[row, col] * (Hh * Ww) / (2.0 * math.pi * math.pi * st) * sel
    cos_t = torch.clamp(vm.dot(d, n_prev), min=0.0)
    return cos_t * sampling.INV_PI * sel
