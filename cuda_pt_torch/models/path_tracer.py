"""Unidirectional path tracer with NEE + MIS (port of
cuda_pt_tpu/models/path_tracer.py, forward mode).

Per bounce: closest hit -> emitter-hit MIS -> NEE with a shadow ray and
light MIS (RIS over ``nee_candidates`` when > 1) -> BSDF sampling ->
per-lobe depth caps -> NaN guard -> Russian roulette after bounce 1
(survival clip(max_thp, 0.1, 1)). The pcg draw order of ``pt_bounce`` is
kept exactly: per bounce, 3 NEE advances per candidate (+1 reservoir draw
per candidate when RIS is on), 3 BSDF advances, 1 RR advance.

Intersection is brute force over every prim, so the result does not
depend on the BVH. This module is the plain PyTorch version of the CUDA
megakernel (ops/megakernel.py). The differentiable mode, ToF gating,
dispersion strata and envmap accumulation wait for ROADMAP Queue 1 item 4.
"""

from __future__ import annotations

import dataclasses

import torch

from ..bsdf import eval as bsdf_eval
from ..core import camera as cam_mod
from ..core import math as vm
from ..core import qmc
from ..core import rng as prng
from ..core import sampling
from ..core.config import MaxDepthParams
from ..emitters import emitters
from ..ops import intersect as isect
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
    bounce: int


def check_supported(scene: T.Scene, md: MaxDepthParams):
    """Raise for scene features this slice does not port."""
    bsdf_eval.check_supported(scene)
    emitters.check_supported(scene)
    if md.max_time > 0.0:
        raise NotImplementedError("ToF gating waits for ROADMAP Queue 1 item 4")
    if int(scene.objects.medium_in.max()) >= 0 or scene.cam_medium >= 0:
        raise NotImplementedError("participating media wait for ROADMAP Queue 1 item 8")


def shade_stage(scene: T.Scene, md: MaxDepthParams, s: PTState, hit,
                nee_candidates: int = 1) -> PTState:
    B = s.o.shape[0]
    t = hit["t"]
    hit_ok = hit["hit"] & s.active

    # ---- surface interaction -------------------------------------------
    prim = torch.clamp(hit["prim"], min=0)
    t_safe = torch.where(hit_ok, t, 1.0)
    p = s.o + t_safe[:, None] * s.d
    inter = isect.surface_interaction(scene.geom, prim, hit["b1"], hit["b2"], p, s.d)
    obj = inter["obj"]
    bid = torch.clamp(scene.objects.bsdf_id[obj], min=0)
    eid = scene.objects.emitter_id[obj].long()

    # ---- emitter hit MIS -------------------------------------------------
    cos_l = -vm.dot(s.d, inter["n_g"])
    le_hit = emitters.emitter_radiance_hit(scene, torch.clamp(eid, min=0), cos_l)
    pdf_l = emitters.hit_emitter_pdf(scene, obj, t_safe, torch.clamp(cos_l, min=1e-6))
    w_hit = torch.where(s.prev_delta, 1.0, sampling.power_heuristic(s.prev_pdf, pdf_l))
    emit_mask = hit_ok & (eid > 0) & (cos_l > 1e-6)
    L = s.L + torch.where(emit_mask[:, None], s.thp * le_hit * w_hit[:, None], 0.0)

    # ---- NEE -------------------------------------------------------------
    ctx = bsdf_eval.make_ctx(scene, bid, inter["uv"], inter["n_s"])
    wo = -s.d
    if nee_candidates <= 1:
        es, rng = emitters.sample_emitter(scene, p, ctx["n"], s.rng)
        f_cos, bpdf = bsdf_eval.eval_bsdf(ctx, wo, es["dir"])
        inv_density = 1.0 / torch.clamp(es["pdf"], min=1e-12)
    else:
        # RIS: weighted reservoir over M candidates with target
        # p_hat = lum(f * Le); one shadow ray for the survivor.
        rng = s.rng
        wsum = torch.zeros(B, device=p.device)
        res = None
        for _ in range(nee_candidates):
            es_k, rng = emitters.sample_emitter(scene, p, ctx["n"], rng)
            f_k, bp_k = bsdf_eval.eval_bsdf(ctx, wo, es_k["dir"])
            phat_k = vm.luminance(f_k * es_k["le"])
            w_k = torch.where(es_k["valid"] & (phat_k > 0.0),
                              phat_k / torch.clamp(es_k["pdf"], min=1e-12), 0.0)
            wsum = wsum + w_k
            u_r, rng = prng.next1d(rng)
            cand = {**es_k, "f_cos": f_k, "bpdf": bp_k, "phat": phat_k}
            if res is None:
                res = cand
            else:
                take = (u_r * wsum <= w_k) & (w_k > 0.0)
                res = {k: torch.where(take[:, None] if v.dim() == 2 else take, v, res[k])
                       for k, v in cand.items()}
        es, f_cos, bpdf = res, res["f_cos"], res["bpdf"]
        inv_density = wsum / (nee_candidates * torch.clamp(res["phat"], min=1e-12))
    off_sign = torch.sign(vm.dot(inter["n_g"], es["dir"], keepdim=True))
    p_shadow = p + inter["n_g"] * off_sign * isect.RAY_OFFSET
    # the origin offset shortens the true segment: subtract its projection
    dist_shadow = es["dist"] - torch.abs(vm.dot(inter["n_g"], es["dir"])) * isect.RAY_OFFSET
    occ = isect.occlusion_brute(scene.geom, p_shadow, es["dir"], dist_shadow)
    # at the last bounce the BSDF continuation is never traced, so NEE
    # takes the full MIS weight
    last_bounce = s.bounce >= (md.max_depth - 1)
    w_nee = torch.where(es["delta"] | last_bounce, 1.0,
                        sampling.power_heuristic(es["pdf"], bpdf))
    nee_ok = hit_ok & es["valid"] & ~occ & (torch.amax(f_cos, dim=-1) > 0.0)
    contrib = s.thp * f_cos * es["le"] * (w_nee * inv_density)[:, None]
    L = L + torch.where(nee_ok[:, None], contrib, 0.0)

    # ---- BSDF sampling -----------------------------------------------------
    bs, rng = bsdf_eval.sample_bsdf(ctx, wo, rng)
    thp = s.thp * bs["weight"]
    thp = torch.where(torch.isfinite(thp), thp, 0.0)  # NaN guard
    off2 = torch.sign(vm.dot(inter["n_g"], bs["wi"], keepdim=True))
    o_new = p + inter["n_g"] * off2 * isect.RAY_OFFSET

    # ---- per-lobe depth caps -------------------------------------------
    n_diff = s.n_diff + (hit_ok & (bs["lobe"] == bsdf_eval.LOBE_DIFFUSE)).to(torch.int32)
    n_spec = s.n_spec + (hit_ok & (bs["lobe"] == bsdf_eval.LOBE_SPECULAR)).to(torch.int32)
    n_trans = s.n_trans + (hit_ok & (bs["lobe"] == bsdf_eval.LOBE_TRANSMIT)).to(torch.int32)
    depth_ok = ((n_diff <= md.max_diffuse) & (n_spec <= md.max_specular)
                & (n_trans <= md.max_transmit))

    # ---- Russian roulette after bounce 1 -------------------------------
    max_thp = torch.amax(thp, dim=-1)
    u_rr, rng = prng.next1d(rng)
    if s.bounce >= 1:
        p_survive = torch.clamp(max_thp, 0.1, 1.0)
    else:
        p_survive = torch.ones_like(max_thp)
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
        bounce=s.bounce + 1,
    )


def pt_bounce(scene: T.Scene, md: MaxDepthParams, s: PTState, nee_candidates: int = 1) -> PTState:
    """One full bounce: brute-force closest hit, then shading."""
    hit = isect.closest_hit_brute(scene.geom, s.o, s.d)
    return shade_stage(scene, md, s, hit, nee_candidates)


def init_state(o: torch.Tensor, d: torch.Tensor, rng: torch.Tensor) -> PTState:
    B = o.shape[0]
    dev = o.device
    zi = torch.zeros(B, dtype=torch.int32, device=dev)
    return PTState(
        o=o, d=d, thp=torch.ones_like(o), L=torch.zeros_like(o), rng=rng,
        active=torch.ones(B, dtype=torch.bool, device=dev),
        prev_pdf=torch.ones(B, device=dev),
        prev_delta=torch.ones(B, dtype=torch.bool, device=dev),
        n_diff=zi, n_spec=zi, n_trans=zi, bounce=0)


def trace_paths_final(scene: T.Scene, md: MaxDepthParams, o, d, rng,
                      nee_candidates: int = 1) -> PTState:
    """Run the bounce loop until every lane is done or max_depth is hit."""
    check_supported(scene, md)
    s = init_state(o, d, rng)
    while s.bounce < md.max_depth and bool(s.active.any()):
        s = pt_bounce(scene, md, s, nee_candidates)
    return s


def trace_paths(scene: T.Scene, md: MaxDepthParams, o, d, rng, nee_candidates: int = 1):
    """Radiance (B, 3) for a batch of rays with pcg states (B, 2)."""
    return trace_paths_final(scene, md, o, d, rng, nee_candidates).L


def render_band(scene: T.Scene, cam: cam_mod.Camera, md: MaxDepthParams, seed, sample_idx,
                band_start: int, band_count: int, nee_candidates: int = 1):
    """One 1-spp pass over lanes [band_start, band_start + band_count) ->
    (band_count, 3). Streams key off the absolute lane, so bands are
    bit-identical to the whole-frame pass."""
    lane = band_start + torch.arange(band_count, device=scene.device)
    rng = qmc.make_state("pcg", seed, lane, sample_idx)
    o, d, rng = cam_mod.generate_rays(cam, lane, rng)
    return trace_paths(scene, md, o, d, rng, nee_candidates)


def render_sample(scene: T.Scene, cam: cam_mod.Camera, md: MaxDepthParams, seed, sample_idx,
                  nee_candidates: int = 1):
    """One 1-spp pass over all pixels -> (H, W, 3)."""
    L = render_band(scene, cam, md, seed, sample_idx, 0, cam.width * cam.height,
                    nee_candidates)
    return L.reshape(cam.height, cam.width, 3)


def render(scene: T.Scene, cam: cam_mod.Camera, md: MaxDepthParams, spp: int, seed: int = 0,
           nee_candidates: int = 1):
    """Multi-spp render -> (H, W, 3) mean."""
    acc = torch.zeros((cam.height, cam.width, 3), device=scene.device)
    for i in range(spp):
        acc = acc + render_sample(scene, cam, md, seed, i, nee_candidates)
    return acc / spp
