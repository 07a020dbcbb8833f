"""Unidirectional path tracer with NEE + MIS (port of
cuda_pt_tpu/models/path_tracer.py, forward mode).

Per bounce: closest hit -> envmap miss accumulation (MIS against the
cached envmap NEE pdf) -> emitter-hit MIS -> NEE with a shadow ray and
light MIS (RIS over ``nee_candidates`` when > 1) -> BSDF sampling ->
per-lobe depth caps -> NaN guard -> Russian roulette after bounce 1
(survival clip(max_thp, 0.1, 1)). The pcg draw order of ``pt_bounce`` is
kept exactly: per bounce, 3 NEE advances per candidate (+1 with envmap
importance tables, +1 reservoir draw per candidate when RIS is on), 3
BSDF advances, 1 RR advance. The renderers pass the dispersion wavelength
stratum ``wl_stratum_u``.

Intersection is brute force up to ``BRUTE_FORCE_MAX_PRIMS`` prims; above,
the walk of ``scene.traversal`` (or ``TRAVERSAL_IMPL``), as in the
reference: "xla" the skip walk of accel/traverse.py, "pallas" kernel K1
(ops/traverse_kernel.py; the CUDA kernel on CUDA tensors, its plain
version on CPU ones) over the scene's forest, or over the scene's BVH as
one chunk (on the CPU only where scene_fits_vmem holds, else the skip
walk, as the reference routes it), "wide" the
8-wide walk of accel/wide_traverse.py over ``scene.wide``.

``fused=True`` computes the estimator of the fused TPU kernel instead,
which has the same expectation and differs per lane in two places (the
caller also hands it the kernel's emitter table, in which the envmap is
never NEE-sampled; ops/megakernel.kernel_scene):
- envmap: a miss adds thp * Le with MIS weight 1;
- diffuse textures: the BSDF traces with the base kd, so Russian roulette
  sees the untextured throughput; the texel factors ride in a separate
  running product that multiplies each contribution as it is added.
The dispersion wavelength then comes from the in-stream draw (no
stratum), as in the kernel. This is the plain version of the CUDA
megakernel (ops/megakernel.trace_megakernel_reference).

``seg=True`` (with ``fused``) is one bounce of the fused estimator as the
segment kernel K5 runs it under the sorted-wavefront driver
(ops/megakernel.trace_megakernel_swf), which resolves what the bounce
records between bounces (the state's ``rec``):
- envmap: a miss records its direction and throughput (``miss_d``,
  ``miss_thp``, carried); the driver adds thp * Le after the last bounce;
- diffuse textures (inline texturing): the NEE contribution is recorded
  before the hit's texel (``nee``) with the hit's bsdf id and uv (``bid``,
  ``uv``); the driver multiplies the texel into it and into the
  throughput, so Russian roulette sees the texels of the earlier bounces.

Still narrowed: the differentiable mode and ToF gating (ROADMAP Queue 1
item 4). Participating media render with models/volume_pt.py.
"""

from __future__ import annotations

import dataclasses

import torch

from ..accel import traverse
from ..bsdf import eval as bsdf_eval
from ..core import camera as cam_mod
from ..core import math as vm
from ..core import qmc
from ..core import rng as prng
from ..core import sampling
from ..core.config import MaxDepthParams
from ..emitters import emitters
from ..ops import intersect as isect
from ..ops import traverse_kernel as tk
from ..scene import textures as tex
from ..scene import types as T

# At or below this prim count intersection is brute force (the reference's
# rule; the result does not depend on the choice beyond exact-t ties).
BRUTE_FORCE_MAX_PRIMS = 64
# The walk backend where scene.traversal is "" (module docstring).
TRAVERSAL_IMPL = "xla"
TRAVERSALS = ("xla", "pallas", "wide")
# Golden-ratio conjugate in u32 fixed point: round((sqrt(5) - 1) / 2 * 2^32).
_WL_PHI_U32 = 0x9E3779B9


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
    env_pdf: torch.Tensor
    n_diff: torch.Tensor
    n_spec: torch.Tensor
    n_trans: torch.Tensor
    wl: torch.Tensor  # locked dispersion wavelength (0 = unset)
    bounce: int
    wl_u: torch.Tensor | None = None  # per-lane wavelength stratum (None = drawn)
    tex: torch.Tensor | None = None  # fused: running product of diffuse texels
    rec: dict | None = None  # seg: the bounce's records (module docstring)


def wl_stratum_u(seed, s_idx, lane: torch.Tensor) -> torch.Tensor:
    """Per-lane low-discrepancy uniform for the dispersion wavelength:
    frac(u0 + s * phi) with a per-pixel offset u0 hashed off its own stream
    (so it shifts no other draw), in u32 fixed point."""
    st = prng.seed((int(seed) & prng.MASK32) ^ 0xA511E9B3, prng.as_u32(lane))
    u0 = prng.next2d(st)[1][..., 0]
    s = prng.as_u32(int(s_idx), lane.device)
    return prng.u01((u0 + prng.mul32(s.expand_as(u0), _WL_PHI_U32)) & prng.MASK32)


def check_supported(scene: T.Scene, md: MaxDepthParams):
    """Raise for scene features this slice does not port."""
    if md.max_time > 0.0:
        raise NotImplementedError("ToF gating waits for ROADMAP Queue 1 item 4")
    if int(scene.objects.medium_in.max()) >= 0 or scene.cam_medium >= 0:
        raise NotImplementedError("participating media render with models/volume_pt.py "
                                  "(RendererType.VOLUME_PT)")


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


def _use_bvh(scene: T.Scene) -> bool:
    return scene.geom.num_prims > BRUTE_FORCE_MAX_PRIMS


def pallas_forest(scene: T.Scene):
    """K1's forest for traversal "pallas": the scene's own (the Renderer
    packs the BVH into it as one chunk when none was compiled), else the
    BVH packed as one chunk here, per call as in the reference. On CPU
    tensors the reference's routing holds: None (the skip walk) where
    scene_fits_vmem fails. On CUDA tensors K1 always runs: it reads its
    rows from global memory, and the VMEM limit is the TPU's."""
    if scene.forest is not None:
        return scene.forest
    if scene.device.type == "cpu" and not tk.scene_fits_vmem(scene.geom, scene.bvh):
        return None
    return tk.single_chunk_forest(scene.geom, scene.bvh)


def _walks(scene: T.Scene, use_bvh: bool | None = None):
    """(closest, any hit) of the scene's walk backend as functions of
    (o, d) and (o, d, t_far); None for the brute force: where use_bvh is
    False, or None with the scene at or below the brute-force bound. An
    explicit True walks the tree at any prim count, as the reference's
    closest_hit(..., use_bvh) does."""
    impl = scene.traversal or TRAVERSAL_IMPL
    if impl == "mxu":  # the reference takes it at any prim count
        raise NotImplementedError("the matmul brute force (traversal 'mxu') waits for ROADMAP "
                                  "Queue 1 item 13")
    if not (_use_bvh(scene) if use_bvh is None else use_bvh):
        return None
    ml = scene.bvh.max_leaf  # the tree's leaf capacity, as the reference passes it
    forest = pallas_forest(scene) if impl == "pallas" else None
    if forest is not None:
        return (lambda o, d: tk.traverse_forest(forest, o, d, max_leaf=ml),
                lambda o, d, t: tk.traverse_forest(forest, o, d, t, max_leaf=ml,
                                                   occlusion=True)["occluded"])
    if impl == "wide" and scene.wide is not None:
        from ..accel import wide_traverse

        return (lambda o, d: wide_traverse.closest_hit_wide(scene.geom, scene.wide, o, d),
                lambda o, d, t: wide_traverse.occlusion_wide(scene.geom, scene.wide, o, d, t))
    return (lambda o, d: traverse.closest_hit_bvh(scene.geom, scene.bvh, o, d),
            lambda o, d, t: traverse.occlusion_bvh(scene.geom, scene.bvh, o, d, t))


def closest_hit(scene: T.Scene, o, d, live: torch.Tensor, use_bvh: bool | None = None):
    """Closest hit for the lanes where ``live`` (misses elsewhere); use_bvh
    as in _walks."""
    walks = _walks(scene, use_bvh)
    if walks is None:
        return isect.closest_hit_brute(scene.geom, o, d)
    return _on_lanes(walks[0], live, _MISS, o, d)


def occluded(scene: T.Scene, o, d, t_far, need: torch.Tensor, use_bvh: bool | None = None):
    """Any-hit shadow test for the lanes where ``need`` (False elsewhere);
    use_bvh as in _walks."""
    walks = _walks(scene, use_bvh)
    if walks is None:
        return isect.occlusion_brute(scene.geom, o, d, t_far)
    return _on_lanes(walks[1], need, False, o, d, t_far)


def scene_textured(scene: T.Scene) -> bool:
    """A material has a diffuse texture (the fused kernel's textured flag)."""
    return bool((scene.bsdfs.tex_ids[:, T.TEX_DIFFUSE] >= 0).any())


def env_record(s, miss: torch.Tensor, thp: torch.Tensor) -> dict:
    """seg: the carried envmap miss record with this bounce's misses."""
    rec = s.rec or {}
    md_ = rec.get("miss_d", torch.zeros_like(s.d))
    mt_ = rec.get("miss_thp", torch.zeros_like(s.d))
    return {"miss_d": torch.where(miss[:, None], s.d, md_),
            "miss_thp": torch.where(miss[:, None], thp, mt_)}


def surface_record(scene: T.Scene, hit: dict, p, d) -> dict:
    """The hit's shading record: n_s, n_g, uv, bid, eid, inv_area, med_obj;
    from the walk's (prim, b1, b2), or from resolved hit planes
    (ops/megakernel.resolve_hit: raw normals, a sphere's centre, the
    attributes)."""
    if "ns" not in hit:
        prim = torch.clamp(hit["prim"], min=0)
        inter = isect.surface_interaction(scene.geom, prim, hit["b1"], hit["b2"], p, d)
        obj = inter["obj"]
        return {"n_s": inter["n_s"], "n_g": inter["n_g"], "uv": inter["uv"],
                "bid": torch.clamp(scene.objects.bsdf_id[obj], min=0).long(),
                "eid": scene.objects.emitter_id[obj].long(),
                "inv_area": scene.objects.inv_area[obj],
                "med_obj": scene.objects.medium_in[obj]}
    n_sph = vm.normalize(p - hit["ns"])
    n_s = vm.normalize(hit["ns"])
    n_g = vm.normalize(hit["ng"])
    n_g = torch.where(vm.dot(n_g, n_s, keepdim=True) < 0.0, -n_g, n_g)
    sph = hit["sph"][:, None]
    return {"n_s": torch.where(sph, n_sph, n_s), "n_g": torch.where(sph, n_sph, n_g),
            "uv": hit["uv"], "bid": hit["bid"], "eid": hit["eid"], "inv_area": hit["inva"],
            "med_obj": hit["med_obj"]}


def shade_stage(scene: T.Scene, md: MaxDepthParams, s: PTState, hit,
                nee_candidates: int = 1, fused: bool = False, seg: bool = False) -> PTState:
    B = s.o.shape[0]
    t = hit["t"]
    hit_ok = hit["hit"] & s.active
    miss = s.active & ~hit["hit"]
    inline_tex = seg and scene_textured(scene)
    tex_p = s.tex if (fused and not seg) else 1.0
    rec = {}

    # ---- miss: environment (MIS against the cached envmap NEE pdf) -------
    if scene.env_emitter > 0 and seg:
        rec.update(env_record(s, miss, s.thp))
        L = s.L
    elif scene.env_emitter > 0:
        env_le = emitters.env_radiance(scene, s.d)
        w_env = 1.0 if fused else torch.where(
            s.prev_delta, 1.0, sampling.power_heuristic(s.prev_pdf, s.env_pdf))[:, None]
        L = s.L + torch.where(miss[:, None], s.thp * tex_p * env_le * w_env, 0.0)
    else:
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
    L = L + torch.where(emit_mask[:, None], s.thp * tex_p * le_hit * w_hit[:, None], 0.0)

    # ---- material; the fused estimator keeps the diffuse texel apart ----
    ctx = bsdf_eval.make_ctx(scene, bid, sf["uv"], sf["n_s"], textured=not fused)
    if inline_tex:
        tex_here = 1.0
        rec["bid"] = torch.where(hit_ok, bid, -1)
        rec["uv"] = torch.where(hit_ok[:, None], sf["uv"], 0.0)
    elif fused:
        texel = tex.sample_texture(scene.textures, scene.bsdfs.tex_ids[bid, T.TEX_DIFFUSE],
                                   sf["uv"])[:, :3]
        tex_here = tex_p * texel
    else:
        tex_here = 1.0
    wo = -s.d

    # ---- NEE -------------------------------------------------------------
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
    bs, rng = bsdf_eval.sample_bsdf(ctx, wo, rng, wl=s.wl, u_wl=s.wl_u)
    thp = s.thp * bs["weight"]
    thp = torch.where(torch.isfinite(thp), thp, 0.0)  # NaN guard
    off2 = torch.sign(vm.dot(sf["n_g"], bs["wi"], keepdim=True))
    o_new = p + sf["n_g"] * off2 * isect.RAY_OFFSET
    env_pdf = emitters.env_nee_pdf(scene, ctx["n"], bs["wi"])

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
        env_pdf=torch.where(active, env_pdf, s.env_pdf),
        n_diff=n_diff,
        n_spec=n_spec,
        n_trans=n_trans,
        wl=torch.where(active, bs["wl"], s.wl),
        bounce=s.bounce + 1,
        wl_u=s.wl_u,
        tex=torch.where(hit_ok[:, None], tex_here, s.tex) if (fused and not seg) else None,
        rec=rec if seg else None,
    )


def intersect_stage(scene: T.Scene, s: PTState) -> dict:
    """Wavefront stage 1: the closest hit of every live lane."""
    return closest_hit(scene, s.o, s.d, s.active)


def pt_bounce(scene: T.Scene, md: MaxDepthParams, s: PTState, nee_candidates: int = 1,
              fused: bool = False, seg: bool = False) -> PTState:
    """One full bounce: closest hit, then shading. seg (with fused): the
    segment kernel's bounce (module docstring)."""
    return shade_stage(scene, md, s, intersect_stage(scene, s), nee_candidates, fused, seg)


def init_state(o: torch.Tensor, d: torch.Tensor, rng: torch.Tensor, wl_u=None,
               fused: bool = False) -> PTState:
    B = o.shape[0]
    dev = o.device
    zi = torch.zeros(B, dtype=torch.int32, device=dev)
    zf = torch.zeros(B, device=dev)
    return PTState(
        o=o, d=d, thp=torch.ones_like(o), L=torch.zeros_like(o), rng=rng,
        active=torch.ones(B, dtype=torch.bool, device=dev),
        prev_pdf=torch.ones(B, device=dev),
        prev_delta=torch.ones(B, dtype=torch.bool, device=dev),
        env_pdf=zf, n_diff=zi, n_spec=zi, n_trans=zi, wl=zf, bounce=0, wl_u=wl_u,
        tex=torch.ones_like(o) if fused else None)


def trace_paths_final(scene: T.Scene, md: MaxDepthParams, o, d, rng, nee_candidates: int = 1,
                      wl_u=None, fused: bool = False) -> PTState:
    """Run the bounce loop until every lane is done or max_depth is hit."""
    check_supported(scene, md)
    s = init_state(o, d, rng, wl_u, fused)
    while s.bounce < md.max_depth and bool(s.active.any()):
        s = pt_bounce(scene, md, s, nee_candidates, fused)
    return s


def trace_paths(scene: T.Scene, md: MaxDepthParams, o, d, rng, nee_candidates: int = 1,
                wl_u=None, fused: bool = False):
    """Radiance (B, 3) for a batch of rays with pcg states (B, 2)."""
    return trace_paths_final(scene, md, o, d, rng, nee_candidates, wl_u, fused).L


def render_band(scene: T.Scene, cam: cam_mod.Camera, md: MaxDepthParams, seed, sample_idx,
                band_start: int, band_count: int, nee_candidates: int = 1):
    """One 1-spp pass over lanes [band_start, band_start + band_count) ->
    (band_count, 3). Streams key off the absolute lane, so bands are
    bit-identical to the whole-frame pass."""
    lane = band_start + torch.arange(band_count, device=scene.device)
    rng = qmc.make_state("pcg", seed, lane, sample_idx)
    o, d, rng = cam_mod.generate_rays(cam, lane, rng)
    return trace_paths(scene, md, o, d, rng, nee_candidates,
                       wl_u=wl_stratum_u(seed, sample_idx, lane))


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
