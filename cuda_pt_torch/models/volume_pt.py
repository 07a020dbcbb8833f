"""Volumetric path tracer with homogeneous media: nested media, free-flight
distance sampling, transmittance NEE (port of
cuda_pt_tpu/models/volume_pt.py, forward mode, homogeneous media).

Per bounce: closest hit -> free flight through the current medium (the top
of a per-lane stack of at most MAX_NESTED media, the scene's ``cam_medium``
when it is empty; channel-MIS homogeneous sampling) -> a medium event or a
surface event -> environment on an escape, emitter-hit MIS on a surface ->
NEE from either event kind, its shadow ray walked through null interfaces
(forward BSDFs and cullable objects, at most MAX_CROSSINGS of them) with
the analytic transmittance of each segment -> phase sampling (medium) or
BSDF sampling (surface) -> the medium stack toggled by object identity on
transmission -> per-lobe and volume depth caps -> RR. pcg draw order per
bounce: flight (1 advance), NEE (3, +1 with envmap importance tables),
phase sample (2), BSDF sample (3), RR (1), on every lane.

``fused=True`` computes the estimator of the fused TPU kernel with
``has_media`` (ops/pallas/megakernel.py:1224-1331, :1386-1439,
:1900-1991, :2038-2085, :2342-2398) lane for lane; it is the plain
version of the CUDA kernel K4 (ops/megakernel.trace_megakernel_reference,
which also hands it the kernel's emitter table). It differs from the
composed estimator in:
- the phase function: forward HG ``1 + g^2 - 2 g cos`` (|g| >= 1e-3) for
  both NEE and the sampled pdf, where the composed one evaluates the
  reference's ``+ 2 g cos`` (media/phase.py; ROADMAP Queue 3);
- the flight's channel pick by comparison with 1/3 and 2/3, t_surf = 1e8
  on a miss (the composed path: 1e7), the Rayleigh cube root as
  exp(log(x) / 3);
- the shadow walk's advance ``o + (t + offset) d`` and ``rem - (t + offset)``;
- an escape adds thp * Le with MIS weight 1 (K3's envmap rule); the
  dispersion wavelength comes from the in-stream draw.

``seg=True`` (with ``fused``) is one bounce as the segment kernel K5 runs
it under the sorted-wavefront driver (ops/megakernel.trace_megakernel_swf):
an escape records its direction and throughput (path_tracer's ``seg``).
Grid media ride only the driver's split form, around this bounce: the
closest hit arrives resolved (``hit`` planes, from kernel K6 and a row
gather), the flight through a grid medium arrives delta-tracked
(``flight``, media/grid.py), and the NEE contribution is recorded with its
shadow segment (``rec``: ``gc``, ``gp0``, ``gp1``) for the driver's ratio
tracking. The kernel's media row holds zero sigmas for a grid medium, so
every analytic factor of a grid lane is 1.

Still narrowed: the composed estimator's grid route (ROADMAP Queue 1 item
8), ToF gating and the differentiable mode (Queue 1 item 4), compaction
(item 7).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..bsdf import eval as bsdf_eval
from ..core import camera as cam_mod
from ..core import math as vm
from ..core import qmc
from ..core import rng as prng
from ..core import sampling
from ..core.config import MaxDepthParams
from ..emitters import emitters
from ..media import homogeneous as homo
from ..media import phase as phase_mod
from ..ops import intersect as isect
from ..scene import types as T
from . import path_tracer as pt

MAX_NESTED = 3  # medium stack depth (the reference's BankStack)
MAX_CROSSINGS = 4  # null interfaces one shadow ray walks through
# t_surf of a miss: the composed estimator's (core/math.MAX_DIST of the
# reference) and the fused kernel's
T_MISS, T_MISS_FUSED = emitters.MAX_DIST, 1e8
_INV_4PI = 0.07957747154594767
_TWO_PI = 2.0 * math.pi


@dataclasses.dataclass
class VPTState:
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
    n_vol: torch.Tensor
    wl: torch.Tensor
    med_stack: torch.Tensor  # (B, MAX_NESTED) int32
    med_top: torch.Tensor  # (B,) int32, -1 = empty (the ambient medium)
    bounce: int
    wl_u: torch.Tensor | None = None
    rec: dict | None = None  # seg: the bounce's records (module docstring)


def _peek(s: VPTState, ambient: int) -> torch.Tensor:
    idx = torch.clamp(s.med_top, 0, MAX_NESTED - 1).long()
    top = torch.gather(s.med_stack, 1, idx[:, None])[:, 0]
    return torch.where(s.med_top >= 0, top, ambient)


def _push(stack, top, m, do):
    top_new = torch.where(do, torch.clamp(top + 1, max=MAX_NESTED - 1), top)
    slot = (torch.arange(MAX_NESTED, device=top.device)[None, :] == top_new[:, None]) & do[:, None]
    return torch.where(slot, m[:, None], stack), top_new


def _pop(top, do):
    return torch.where(do, torch.clamp(top - 1, min=-1), top)


def check_supported(scene: T.Scene, md: MaxDepthParams, differentiable=False, compact=False,
                    fused=False):
    """Raise for what this slice does not port. Grid media render only on
    the fused path, through the split sorted-wavefront driver."""
    if md.max_time > 0.0:
        raise NotImplementedError("ToF gating waits for ROADMAP Queue 1 item 4")
    if differentiable:
        raise NotImplementedError(
            "the differentiable mode (fixed RR schedule) waits for ROADMAP Queue 1 item 4")
    if compact:
        raise NotImplementedError(
            "live-lane compaction waits for ROADMAP Queue 1 item 7 (models/wavefront.py)")
    if bool((scene.media.mtype == T.MEDIUM_GRID).any()):
        if not fused:
            raise NotImplementedError(
                "the composed volume path tracer's grid route waits for ROADMAP Queue 1 item 8; "
                "grid media render fused (RendererType.VOLUME_PT)")
        raise NotImplementedError(
            "grid media ride the split sorted-wavefront driver (kernels K6 and K5's shade "
            "phase, ops/megakernel.trace_megakernel_swf), not the whole-path loop")


# ---------------------------------------------------------------------------
# the fused kernel's phase function (forward HG) and flight
# ---------------------------------------------------------------------------


def _medium_params(scene: T.Scene, mid: torch.Tensor) -> dict:
    """Per-lane medium fields as the kernel's media row gives them; lanes
    outside any medium (mid < 0) read the row's padding: zero sigmas,
    isotropic, w = 1."""
    m = torch.clamp(mid, min=0).long()
    md_ = scene.media
    grid = (mid >= 0) & (md_.mtype[m] == T.MEDIUM_GRID)
    inm = ((mid >= 0) & ~grid)[:, None]  # a grid medium's row holds zero sigmas
    _, ss, st = homo.sigma_at(scene.media, mid)
    return {
        "grid": grid,
        "ss": torch.where(inm, ss, 0.0), "st": torch.where(inm, st, 0.0),
        "ptype": torch.where(mid >= 0, md_.phase_type[m], T.PHASE_ISOTROPIC),
        "g1": torch.where(mid >= 0, md_.phase_g[m, 0], 0.0),
        "g2": torch.where(mid >= 0, md_.phase_g[m, 1], 0.0),
        "w": torch.where(mid >= 0, md_.phase_w[m], 1.0),
    }


def phase_value_fused(mp: dict, cos_t: torch.Tensor) -> torch.Tensor:
    """The fused kernel's phase value (= pdf) at cos_t = d . d_out
    (megakernel.py:1267-1286): forward HG with |g| >= 1e-3."""

    def hg(g):
        g_safe = torch.where(torch.abs(g) < 1e-3, torch.where(g < 0, -1e-3, 1e-3), g)
        den = torch.clamp(1.0 + g_safe * g_safe - 2.0 * g_safe * cos_t, min=1e-8)
        return _INV_4PI * (1.0 - g_safe * g_safe) / (den * torch.sqrt(den))

    pty = mp["ptype"]
    out = torch.full_like(cos_t, _INV_4PI)
    out = torch.where(pty == T.PHASE_HG, hg(mp["g1"]), out)
    out = torch.where(pty == T.PHASE_DUAL_HG,
                      mp["w"] * hg(mp["g1"]) + (1.0 - mp["w"]) * hg(mp["g2"]), out)
    return torch.where(pty == T.PHASE_RAYLEIGH, 0.75 * _INV_4PI * (1.0 + cos_t * cos_t), out)


def phase_sample_fused(mp: dict, d: torch.Tensor, up0, up1, upick):
    """The fused kernel's phase sample around d (megakernel.py:2046-2085)
    -> (d_out, pdf); the Rayleigh cube root as exp(log(x) / 3)."""

    def hg_cos(g):
        small = torch.abs(g) < 1e-3
        g_safe = torch.where(small, 1e-3, g)
        sq = (1.0 - g_safe * g_safe) / (1.0 - g_safe + 2.0 * g_safe * up0)
        ch = (1.0 + g_safe * g_safe - sq * sq) / (2.0 * g_safe)
        return torch.where(small, 1.0 - 2.0 * up0, torch.clamp(ch, -1.0, 1.0))

    qray = 2.0 * (2.0 * up0 - 1.0)
    cb_arg = torch.clamp(qray + torch.sqrt(qray * qray + 1.0), min=1e-30)
    zray = torch.exp(torch.log(cb_arg) * (1.0 / 3.0))
    cos_ray = torch.clamp(zray - 1.0 / zray, -1.0, 1.0)
    pty = mp["ptype"]
    g_pick = torch.where(upick < mp["w"], mp["g1"], mp["g2"])
    cos_ph = 1.0 - 2.0 * up0
    cos_ph = torch.where(pty == T.PHASE_HG, hg_cos(mp["g1"]), cos_ph)
    cos_ph = torch.where(pty == T.PHASE_DUAL_HG, hg_cos(g_pick), cos_ph)
    cos_ph = torch.where(pty == T.PHASE_RAYLEIGH, cos_ray, cos_ph)
    sin_ph = torch.sqrt(torch.clamp(1.0 - cos_ph * cos_ph, min=0.0))
    phi = _TWO_PI * up1
    local = torch.stack([sin_ph * torch.cos(phi), sin_ph * torch.sin(phi), cos_ph], dim=-1)
    return vm.to_world(local, d), phase_value_fused(mp, cos_ph)


def _flight_fused(mp: dict, in_med, hit_ok, t_hit, u, flight=None):
    """The kernel's free flight (megakernel.py:1398-1439) -> (med_event,
    t_evt, weight (B, 3)). flight: the delta-tracked flight of grid lanes
    (dict t, is_medium, weight), which replaces the analytic one there
    (:1408-1436)."""
    u_ch, u_t = u[..., 0], u[..., 1]
    st = mp["st"]
    st_c = torch.where(u_ch >= 2.0 / 3.0, st[:, 2], torch.where(u_ch >= 1.0 / 3.0, st[:, 1],
                                                                 st[:, 0]))
    st_c = torch.clamp(st_c, min=1e-8)
    t_med = -torch.log(torch.clamp(1.0 - u_t, min=1e-12)) / st_c
    t_surf = torch.where(hit_ok, t_hit, T_MISS_FUSED)
    med_event = in_med & (t_med < t_surf)
    if flight is not None:
        in_grid = in_med & mp["grid"]
        med_event = torch.where(in_grid, flight["is_medium"] & (flight["t"] < t_surf), med_event)
        t_med = torch.where(in_grid, flight["t"], t_med)
    t_evt = torch.where(med_event, t_med, t_surf)
    e = torch.exp(-st * t_evt[:, None])
    pdf_m = (st[:, 0] * e[:, 0] + st[:, 1] * e[:, 1] + st[:, 2] * e[:, 2]) / 3.0
    pdf_s = (e[:, 0] + e[:, 1] + e[:, 2]) / 3.0
    w = torch.where(med_event[:, None], mp["ss"] * e / torch.clamp(pdf_m, min=1e-12)[:, None],
                    e / torch.clamp(pdf_s, min=1e-12)[:, None])
    if flight is not None:
        w = torch.where(in_grid[:, None], flight["weight"], w)
    return med_event, t_evt, w


# ---------------------------------------------------------------------------
# free flight and shadow transmittance
# ---------------------------------------------------------------------------


# Every medium here is homogeneous (check_supported refuses grid media), so
# a lane is in one exactly when its medium id is >= 0.


def sample_medium_distance(scene: T.Scene, mid, t_surf, rng, active):
    """Homogeneous free flight (one 2d draw on every lane); vacuum lanes
    pass with weight 1."""
    u, rng = prng.next2d(rng)
    is_homo = mid >= 0
    hs = homo.sample_distance(scene.media, mid, t_surf, u)
    t = torch.where(is_homo, hs["t"], t_surf)
    weight = torch.where(is_homo[:, None], hs["weight"], 1.0)
    return {"t": t, "is_medium": is_homo & hs["is_medium"] & active, "weight": weight}, rng


def segment_transmittance(scene: T.Scene, mid, dist):
    """Transmittance of one medium segment (no interfaces)."""
    return torch.where((mid >= 0)[:, None], homo.transmittance(scene.media, mid, dist), 1.0)


def _null_hit(scene: T.Scene, hit):
    """(medium_in, is_null) of each hit's object: null = forward BSDF or
    cullable object."""
    obj = scene.geom.obj_idx[torch.clamp(hit["prim"], min=0)].long()
    bid = torch.clamp(scene.objects.bsdf_id[obj], min=0).long()
    is_null = (scene.bsdfs.btype[bid] == T.BSDF_FORWARD) | scene.objects.cullable[obj]
    return scene.objects.medium_in[obj], is_null


def transmittance_estimate(scene: T.Scene, p, dirn, dist, mid0, active, fused: bool = False):
    """Walk the shadow ray through at most MAX_CROSSINGS null interfaces,
    multiplying per-segment transmittance; an opaque hit gives 0. The
    medium toggles by object identity at each crossing, and the remaining
    distance drops by the full advance (hit t plus the origin offset)."""
    tr = torch.ones_like(p)
    cur_p, cur_med, remaining, alive = p, mid0, dist, active
    for _ in range(MAX_CROSSINGS):
        hit = pt.closest_hit(scene, cur_p, dirn, alive)
        if fused:
            seg = torch.minimum(torch.where(hit["hit"], hit["t"], remaining), remaining)
            st = _medium_params(scene, cur_med)["st"]
            tr = tr * torch.where(((cur_med >= 0) & alive)[:, None], torch.exp(-st * seg[:, None]),
                                  1.0)
        else:
            t_hit = torch.minimum(hit["t"], remaining)
            seg = torch.where(torch.isfinite(t_hit), t_hit, remaining)
            tr = torch.where(alive[:, None], tr * segment_transmittance(scene, cur_med, seg), tr)
        hit_surface = hit["hit"] & (hit["t"] < remaining * (1.0 - 1e-3)) & alive
        t_step = torch.where(hit["hit"], hit["t"], remaining)
        med_obj, is_null = _null_hit(scene, hit)
        tr = torch.where((hit_surface & ~is_null)[:, None], 0.0, tr)
        crossed = hit_surface & is_null
        toggled = torch.where(cur_med == med_obj, T.MEDIUM_NONE, med_obj)
        cur_med = torch.where(crossed & (med_obj >= 0), toggled, cur_med)
        if fused:
            adv = t_step + isect.RAY_OFFSET
            cur_p = torch.where(crossed[:, None], cur_p + adv[:, None] * dirn, cur_p)
            remaining = torch.where(crossed, remaining - adv, remaining)
        else:
            p_hit = cur_p + t_step[:, None] * dirn
            remaining = torch.where(crossed, remaining - t_step - isect.RAY_OFFSET, remaining)
            cur_p = torch.where(crossed[:, None], p_hit + dirn * isect.RAY_OFFSET, cur_p)
        alive = alive & crossed & (remaining > 1e-4)
    return tr


# ---------------------------------------------------------------------------
# one bounce
# ---------------------------------------------------------------------------


def vpt_bounce(scene: T.Scene, md: MaxDepthParams, s: VPTState, fused: bool = False,
               seg: bool = False, hit: dict | None = None, flight: dict | None = None) -> VPTState:
    """One bounce. seg (with fused): the segment kernel's bounce; hit: the
    closest hit resolved from planes instead of walked; flight: the
    delta-tracked flight of grid lanes (module docstring)."""
    cur_med = _peek(s, scene.cam_medium)
    if hit is None:
        hit = pt.closest_hit(scene, s.o, s.d, s.active)
    mp = _medium_params(scene, cur_med)
    grid_rec = seg and bool((scene.media.mtype == T.MEDIUM_GRID).any())

    # ---- free flight through the current medium ---------------------------
    if fused:
        u, rng = prng.next2d(s.rng)
        in_med = (cur_med >= 0) & s.active
        med_event, t_evt, w_flight = _flight_fused(mp, in_med, hit["hit"] & s.active, hit["t"], u,
                                                   flight)
        thp = torch.where(in_med[:, None], s.thp * w_flight, s.thp)
    else:
        t_surf = torch.where(hit["hit"], hit["t"], T_MISS)
        ms, rng = sample_medium_distance(scene, cur_med, t_surf, s.rng, s.active)
        thp = torch.where(s.active[:, None], s.thp * ms["weight"], s.thp)
        med_event, t_evt = ms["is_medium"], ms["t"]
    srf_event = s.active & hit["hit"] & ~med_event
    p_evt = s.o + t_evt[:, None] * s.d

    # ---- escape: environment --------------------------------------------------
    esc = s.active & ~hit["hit"] & ~med_event
    L = s.L
    rec = {}
    if scene.env_emitter > 0 and seg:
        rec.update(pt.env_record(s, esc, thp))
    elif scene.env_emitter > 0:
        w_env = 1.0 if fused else torch.where(
            s.prev_delta, 1.0, sampling.power_heuristic(s.prev_pdf, s.env_pdf))[:, None]
        L = L + torch.where(esc[:, None], thp * emitters.env_radiance(scene, s.d) * w_env, 0.0)

    # ---- surface interaction and emitter-hit MIS ---------------------------
    sf = pt.surface_record(scene, hit, p_evt, s.d)
    bid, eid = sf["bid"], sf["eid"]
    cos_l = -vm.dot(s.d, sf["n_g"])
    le_hit = emitters.emitter_radiance_hit(scene, torch.clamp(eid, min=0), sf["uv"], cos_l)
    pdf_l = emitters.hit_emitter_pdf_of(scene, eid, sf["inv_area"], t_evt,
                                        torch.clamp(cos_l, min=1e-6))
    w_hit = torch.where(s.prev_delta, 1.0, sampling.power_heuristic(s.prev_pdf, pdf_l))
    emit_mask = srf_event & (eid > 0) & (cos_l > 1e-6)
    L = L + torch.where(emit_mask[:, None], thp * le_hit * w_hit[:, None], 0.0)

    # ---- NEE from either event kind, through the media ------------------------
    ctx = bsdf_eval.make_ctx(scene, bid, sf["uv"], sf["n_s"])
    wo = -s.d
    es, rng = emitters.sample_emitter(scene, p_evt, ctx["n"], rng)
    f_srf, bpdf_srf = bsdf_eval.eval_bsdf(ctx, wo, es["dir"])
    if fused:
        pv = phase_value_fused(mp, vm.dot(s.d, es["dir"]))
    else:
        pv = phase_mod.phase_eval(mp["ptype"], mp["g1"], mp["g2"], mp["w"], s.d, es["dir"])
    f_evt = torch.where(med_event[:, None], pv[:, None], f_srf)
    pdf_evt = torch.where(med_event, pv, bpdf_srf)
    gdir = vm.dot(sf["n_g"], es["dir"])
    off_sign = torch.where(med_event, 0.0, torch.sign(gdir))
    p_shadow = p_evt + sf["n_g"] * off_sign[:, None] * isect.RAY_OFFSET
    dist_shadow = es["dist"] - torch.abs(off_sign * gdir) * isect.RAY_OFFSET
    nee_try = (med_event | srf_event) & es["valid"] & (torch.amax(f_evt, dim=-1) > 0.0)
    tr_nee = transmittance_estimate(scene, p_shadow, es["dir"], dist_shadow, cur_med, nee_try,
                                    fused)
    last_bounce = s.bounce >= (md.max_depth - 1)
    w_nee = torch.where(es["delta"] | last_bounce, 1.0,
                        sampling.power_heuristic(es["pdf"], pdf_evt))
    if fused:  # the kernel's order: the transmittance rides the emitted radiance
        contrib = thp * f_evt * (es["le"] * tr_nee) * (
            w_nee * (1.0 / torch.clamp(es["pdf"], min=1e-12)))[:, None]
    else:
        contrib = thp * f_evt * es["le"] * tr_nee * (
            w_nee / torch.clamp(es["pdf"], min=1e-12))[:, None]
    if grid_rec:  # the driver ratio-tracks the segment through the grids
        rec["gc"] = torch.where(nee_try[:, None], contrib, 0.0)
        rec["gp0"] = p_shadow
        rec["gp1"] = p_shadow + es["dir"] * dist_shadow[:, None]
    else:
        L = L + torch.where(nee_try[:, None], contrib, 0.0)

    # ---- scatter: phase sample (medium) or BSDF sample (surface) -------------
    u2, rng = prng.next2d(rng)
    u1, rng = prng.next1d(rng)
    if fused:
        d_phase, pdf_phase = phase_sample_fused(mp, s.d, u2[:, 0], u2[:, 1], u1)
    else:
        d_phase, pdf_phase = phase_mod.phase_sample(mp["ptype"], mp["g1"], mp["g2"], mp["w"],
                                                    s.d, u2, u1)
    bs, rng = bsdf_eval.sample_bsdf(ctx, wo, rng, wl=s.wl, u_wl=s.wl_u)
    d_new = torch.where(med_event[:, None], d_phase, bs["wi"])
    w_new = torch.where(med_event[:, None], 1.0, bs["weight"])  # phase: f / pdf = 1
    thp = thp * torch.where((med_event | srf_event)[:, None], w_new, 1.0)
    thp = torch.where(torch.isfinite(thp), thp, 0.0)  # NaN guard
    off2 = torch.where(med_event, 0.0, torch.sign(vm.dot(sf["n_g"], d_new)))
    o_new = p_evt + sf["n_g"] * off2[:, None] * isect.RAY_OFFSET
    env_pdf = s.env_pdf if fused else emitters.env_nee_pdf(scene, ctx["n"], d_new)

    # ---- medium stack on transmission: object-identity toggle --------------
    med_obj = sf["med_obj"]
    transmitted = srf_event & (bs["lobe"] == bsdf_eval.LOBE_TRANSMIT) & (med_obj >= 0)
    do_pop = transmitted & (cur_med == med_obj)
    med_stack, med_top = _push(s.med_stack, s.med_top, med_obj, transmitted & ~do_pop)
    med_top = _pop(med_top, do_pop)

    # ---- depth caps and RR ------------------------------------------------------
    def count(n, lobe):
        return n + (srf_event & (bs["lobe"] == lobe)).to(torch.int32)

    n_diff = count(s.n_diff, bsdf_eval.LOBE_DIFFUSE)
    n_spec = count(s.n_spec, bsdf_eval.LOBE_SPECULAR)
    n_trans = count(s.n_trans, bsdf_eval.LOBE_TRANSMIT)
    n_vol = s.n_vol + med_event.to(torch.int32)
    depth_ok = ((n_diff <= md.max_diffuse) & (n_spec <= md.max_specular)
                & (n_trans <= md.max_transmit) & (n_vol <= md.max_volume))
    max_thp = torch.amax(thp, dim=-1)
    u_rr, rng = prng.next1d(rng)
    p_survive = torch.clamp(max_thp, 0.1, 1.0) if s.bounce >= 1 else torch.ones_like(max_thp)
    thp = thp / p_survive[:, None]
    active = (med_event | srf_event) & depth_ok & (u_rr < p_survive) & (max_thp > 0.0)
    return VPTState(
        o=o_new, d=d_new, thp=torch.where(active[:, None], thp, 0.0), L=L, rng=rng,
        active=active,
        prev_pdf=torch.where(active, torch.where(med_event, pdf_phase, bs["pdf"]), s.prev_pdf),
        prev_delta=torch.where(active, bs["is_delta"] & ~med_event, s.prev_delta),
        env_pdf=torch.where(active, env_pdf, s.env_pdf),
        n_diff=n_diff, n_spec=n_spec, n_trans=n_trans, n_vol=n_vol,
        wl=torch.where(active & srf_event, bs["wl"], s.wl),
        med_stack=med_stack, med_top=med_top, bounce=s.bounce + 1, wl_u=s.wl_u,
        rec=rec if seg else None)


def init_state(o: torch.Tensor, d: torch.Tensor, rng: torch.Tensor, wl_u=None) -> VPTState:
    B = o.shape[0]
    dev = o.device
    zi = torch.zeros(B, dtype=torch.int32, device=dev)
    zf = torch.zeros(B, device=dev)
    return VPTState(
        o=o, d=d, thp=torch.ones_like(o), L=torch.zeros_like(o), rng=rng,
        active=torch.ones(B, dtype=torch.bool, device=dev), prev_pdf=torch.ones(B, device=dev),
        prev_delta=torch.ones(B, dtype=torch.bool, device=dev), env_pdf=zf,
        n_diff=zi, n_spec=zi, n_trans=zi, n_vol=zi, wl=zf,
        med_stack=torch.full((B, MAX_NESTED), T.MEDIUM_NONE, dtype=torch.int32, device=dev),
        med_top=zi - 1, bounce=0, wl_u=wl_u)


def trace_paths(scene: T.Scene, md: MaxDepthParams, o, d, rng, wl_u=None, fused: bool = False,
                differentiable: bool = False, compact: bool = False) -> torch.Tensor:
    """Radiance (B, 3) of rays (B, 3) with pcg states (B, 2): the bounce
    loop until every lane is done or max_depth is reached."""
    check_supported(scene, md, differentiable, compact, fused)
    s = init_state(o, d, rng, wl_u)
    while s.bounce < md.max_depth and bool(s.active.any()):
        s = vpt_bounce(scene, md, s, fused)
    return s.L


def render(scene: T.Scene, cam: cam_mod.Camera, md: MaxDepthParams, spp: int, seed: int = 0,
           differentiable: bool = False, compact: bool = False, sampler: str = "pcg"):
    """Multi-spp render -> (H, W, 3) mean, with the per-(pixel, sample)
    streams and wavelength strata of models/path_tracer.render."""
    check_supported(scene, md, differentiable, compact)
    B = cam.width * cam.height
    lane = torch.arange(B, device=scene.device)
    acc = torch.zeros((B, 3), device=scene.device)
    for i in range(spp):
        rng = qmc.make_state(sampler, seed, lane, i)
        o, d, rng = cam_mod.generate_rays(cam, lane, rng)
        acc = acc + trace_paths(scene, md, o, d, rng, wl_u=pt.wl_stratum_u(seed, i, lane))
    return (acc / spp).reshape(cam.height, cam.width, 3)
