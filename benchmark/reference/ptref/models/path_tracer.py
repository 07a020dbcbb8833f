"""One bounce of the path tracer with NEE + MIS, in the segment form that
kernel K5 runs under the sorted-wavefront driver (ops/megakernel.
trace_megakernel_swf): the fused kernel's estimator, whose emitter table
never NEE-samples the envmap (the caller hands it that table).

Per bounce: closest hit -> emitter-hit MIS -> NEE with a shadow ray and
light MIS -> BSDF sampling -> per-lobe depth caps -> NaN guard -> Russian
roulette after bounce 1 (survival clip(max_thp, 0.1, 1)). The pcg draw
order is kept exactly: 3 NEE advances, 3 BSDF advances, 1 RR advance. The
bounce records what the driver resolves between bounces (the state's
``rec``):
- envmap: a miss records its direction and throughput (``miss_d``,
  ``miss_thp``, carried); the driver adds thp * Le after the last bounce;
- diffuse textures (inline texturing): the NEE contribution is recorded
  before the hit's texel (``nee``) with the hit's bsdf id and uv (``bid``,
  ``uv``); the driver multiplies the texel into it and into the
  throughput, so Russian roulette sees the texels of the earlier bounces.
The BSDF traces with the base kd and the dispersion wavelength comes from
the in-stream draw, as in the kernel.

Intersection is the brute force over every prim (ops/intersect): the
reference walks no tree. Frozen from the program's plain version for the
benchmark's reference, cut to the segment form that the cells run.
"""

from __future__ import annotations

import dataclasses

import torch

from ..bsdf import eval as bsdf_eval
from ..core import math as vm
from ..core import rng as prng
from ..core import sampling
from ..core.config import MaxDepthParams
from ..emitters import emitters
from ..ops import intersect as isect
from ..scene import textures as tex
from ..scene import types as T



@dataclasses.dataclass
class PTState:
    o: torch.Tensor
    d: torch.Tensor
    thp: torch.Tensor
    L: torch.Tensor
    rng: torch.Tensor
    active: torch.Tensor
    prev_pdf: torch.Tensor
    prev_delta: torch.Tensor
    n_diff: torch.Tensor
    n_spec: torch.Tensor
    n_trans: torch.Tensor
    wl: torch.Tensor  # locked dispersion wavelength (0 = unset)
    bounce: int
    rec: dict | None = None  # the bounce's records (module docstring)


def _on_lanes(fn, mask: torch.Tensor, fill: dict, *args):
    """fn(*args[mask]) scattered into full-batch outputs initialised from fill."""
    B = mask.shape[0]
    idx = torch.nonzero(mask)[:, 0]
    res = fn(*[a[idx] for a in args])
    if not isinstance(res, dict):
        out = torch.full((B,), fill, dtype=res.dtype, device=res.device)
        out[idx] = res
        return out
    out = {}
    for k, v in res.items():
        full = torch.full((B,) + v.shape[1:], fill[k], dtype=v.dtype, device=v.device)
        full[idx] = v
        out[k] = full
    return out


_MISS = {"t": float("inf"), "prim": -1, "hit": False, "b1": 0.0, "b2": 0.0}


def closest_hit(scene: T.Scene, o, d, live: torch.Tensor):
    """Closest hit for the lanes where ``live`` (misses elsewhere), by the
    brute force over every prim (ops/intersect), whatever the prim count:
    the reference walks no tree, so nothing of a BVH walk is shared with
    the program."""
    return _on_lanes(lambda o_, d_: isect.closest_hit_brute(scene.geom, o_, d_), live, _MISS,
                     o, d)


def occluded(scene: T.Scene, o, d, t_far, need: torch.Tensor):
    """Any-hit shadow test for the lanes where ``need`` (False elsewhere),
    by the brute force."""
    return _on_lanes(lambda o_, d_, t_: isect.occlusion_brute(scene.geom, o_, d_, t_), need,
                     False, o, d, t_far)


def scene_textured(scene: T.Scene) -> bool:
    """A material has a diffuse texture (the fused kernel's textured flag)."""
    return bool((scene.bsdfs.tex_ids[:, T.TEX_DIFFUSE] >= 0).any())


def env_record(s, miss: torch.Tensor, thp: torch.Tensor) -> dict:
    """The carried envmap miss record with this bounce's misses."""
    rec = s.rec or {}
    md_ = rec.get("miss_d", torch.zeros_like(s.d))
    mt_ = rec.get("miss_thp", torch.zeros_like(s.d))
    return {"miss_d": torch.where(miss[:, None], s.d, md_),
            "miss_thp": torch.where(miss[:, None], thp, mt_)}


def surface_record(scene: T.Scene, hit: dict, p, d) -> dict:
    """The hit's shading record from the walk's (prim, b1, b2): n_s, n_g,
    uv, bid, eid, inv_area, med_obj."""
    prim = torch.clamp(hit["prim"], min=0)
    inter = isect.surface_interaction(scene.geom, prim, hit["b1"], hit["b2"], p, d)
    obj = inter["obj"]
    return {"n_s": inter["n_s"], "n_g": inter["n_g"], "uv": inter["uv"],
            "bid": torch.clamp(scene.objects.bsdf_id[obj], min=0).long(),
            "eid": scene.objects.emitter_id[obj].long(),
            "inv_area": scene.objects.inv_area[obj],
            "med_obj": scene.objects.medium_in[obj]}


def survival(bounce: int, thp: torch.Tensor):
    """(max_thp, p_survive) of the Russian roulette after bounce 1, from the
    throughput."""
    max_thp = torch.amax(thp, dim=-1)
    if bounce < 1:
        return max_thp, torch.ones_like(max_thp)
    return max_thp, torch.clamp(max_thp, 0.1, 1.0)


def pt_bounce(scene: T.Scene, md: MaxDepthParams, s: PTState) -> PTState:
    """One bounce of every lane: closest hit, emitter MIS, NEE, BSDF
    scatter and RR (module docstring)."""
    hit = closest_hit(scene, s.o, s.d, s.active)
    t = hit["t"]
    hit_ok = hit["hit"] & s.active
    miss = s.active & ~hit["hit"]
    inline_tex = scene_textured(scene)
    rec = {}

    # ---- miss: the envmap's record ----------------------------------------
    if scene.env_emitter > 0:
        rec.update(env_record(s, miss, s.thp))
    L = s.L

    # ---- surface interaction -------------------------------------------
    t_safe = torch.where(hit_ok, t, 1.0)
    p = s.o + t_safe[:, None] * s.d
    sf = surface_record(scene, hit, p, s.d)
    bid, eid = sf["bid"], sf["eid"]

    # ---- emitter hit MIS -------------------------------------------------
    cos_l = -vm.dot(s.d, sf["n_g"])
    le_hit = emitters.emitter_radiance_hit(scene, torch.clamp(eid, min=0), sf["uv"], cos_l)
    pdf_l = emitters.hit_emitter_pdf_of(scene, eid, sf["inv_area"], t_safe,
                                        torch.clamp(cos_l, min=1e-6))
    w_hit = torch.where(s.prev_delta, 1.0, sampling.power_heuristic(s.prev_pdf, pdf_l))
    emit_mask = hit_ok & (eid > 0) & (cos_l > 1e-6)
    L = L + torch.where(emit_mask[:, None], s.thp * le_hit * w_hit[:, None], 0.0)

    # ---- material; the diffuse texel kept apart ---------------------------
    ctx = bsdf_eval.make_ctx(scene, bid, sf["uv"], sf["n_s"], textured=False)
    if inline_tex:
        tex_here = 1.0
        rec["bid"] = torch.where(hit_ok, bid, -1)
        rec["uv"] = torch.where(hit_ok[:, None], sf["uv"], 0.0)
    else:
        tex_here = tex.sample_texture(scene.textures, scene.bsdfs.tex_ids[bid, T.TEX_DIFFUSE],
                                      sf["uv"])[:, :3]
    wo = -s.d

    # ---- NEE -------------------------------------------------------------
    es, rng = emitters.sample_emitter(scene, p, ctx["n"], s.rng)
    f_cos, bpdf = bsdf_eval.eval_bsdf(ctx, wo, es["dir"])
    inv_density = 1.0 / torch.clamp(es["pdf"], min=1e-12)
    off_sign = torch.sign(vm.dot(sf["n_g"], es["dir"], keepdim=True))
    p_shadow = p + sf["n_g"] * off_sign * isect.RAY_OFFSET
    # the origin offset shortens the true segment: subtract its projection
    dist_shadow = es["dist"] - torch.abs(vm.dot(sf["n_g"], es["dir"])) * isect.RAY_OFFSET
    need = hit_ok & es["valid"] & (torch.amax(f_cos, dim=-1) > 0.0)
    occ = occluded(scene, p_shadow, es["dir"], dist_shadow, need)
    # at the last bounce the BSDF continuation is never traced, so NEE
    # takes the full MIS weight
    last_bounce = s.bounce >= (md.max_depth - 1)
    w_nee = torch.where(es["delta"] | last_bounce, 1.0, sampling.power_heuristic(es["pdf"], bpdf))
    nee_ok = need & ~occ
    contrib = s.thp * tex_here * f_cos * es["le"] * (w_nee * inv_density)[:, None]
    if inline_tex:
        rec["nee"] = torch.where(nee_ok[:, None], contrib, 0.0)
    else:
        L = L + torch.where(nee_ok[:, None], contrib, 0.0)

    # ---- BSDF sampling -----------------------------------------------------
    bs, rng = bsdf_eval.sample_bsdf(ctx, wo, rng, wl=s.wl)
    thp = s.thp * bs["weight"]
    thp = torch.where(torch.isfinite(thp), thp, 0.0)  # NaN guard
    off2 = torch.sign(vm.dot(sf["n_g"], bs["wi"], keepdim=True))
    o_new = p + sf["n_g"] * off2 * isect.RAY_OFFSET

    # ---- per-lobe depth caps -------------------------------------------
    n_diff = s.n_diff + (hit_ok & (bs["lobe"] == bsdf_eval.LOBE_DIFFUSE)).to(torch.int32)
    n_spec = s.n_spec + (hit_ok & (bs["lobe"] == bsdf_eval.LOBE_SPECULAR)).to(torch.int32)
    n_trans = s.n_trans + (hit_ok & (bs["lobe"] == bsdf_eval.LOBE_TRANSMIT)).to(torch.int32)
    depth_ok = ((n_diff <= md.max_diffuse) & (n_spec <= md.max_specular)
                & (n_trans <= md.max_transmit))

    # ---- Russian roulette after bounce 1 -------------------------------
    max_thp, p_survive = survival(s.bounce, thp)
    u_rr, rng = prng.next1d(rng)
    survive = u_rr < p_survive
    thp = thp / p_survive[:, None]

    active = hit_ok & depth_ok & survive & (max_thp > 0.0)
    return PTState(
        o=o_new,
        d=bs["wi"],
        thp=torch.where(active[:, None], thp, 0.0),
        L=L,
        rng=rng,
        active=active,
        prev_pdf=torch.where(active, bs["pdf"], s.prev_pdf),
        prev_delta=torch.where(active, bs["is_delta"], s.prev_delta),
        n_diff=n_diff,
        n_spec=n_spec,
        n_trans=n_trans,
        wl=torch.where(active, bs["wl"], s.wl),
        bounce=s.bounce + 1,
        rec=rec,
    )
