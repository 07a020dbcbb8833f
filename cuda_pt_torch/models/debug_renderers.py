"""Depth renderer, BVH traversal-cost heatmap and the first-hit AOV pass
(port of cuda_pt_tpu/models/debug_renderers.py).

render_depth and render_bvh_cost walk the skip walk (accel/traverse.py)
or the brute force directly, never the scene's traversal, as the
reference does; their min / max normalisations are plain reductions.
render_aovs finds its first hits through path_tracer.closest_hit, so
traversal "pallas" walks them on kernel K1. The buffers (textured albedo,
normal-mapped shading normal, emission, linear depth, coverage) are the
denoiser's inputs (models/denoise.py).
"""

from __future__ import annotations

import math

import torch

from ..accel import traverse
from ..bsdf import eval as bsdf_eval
from ..core import camera as cam_mod
from ..core import math as vm
from ..core import rng as prng
from ..emitters import emitters
from ..ops import intersect as isect
from ..scene import types as T
from ..utils import colormap
from . import path_tracer as pt


def _primary_rays(cam: cam_mod.Camera, seed: int = 0):
    lane = torch.arange(cam.width * cam.height, device=cam.t.device)
    o, d, _ = cam_mod.generate_rays(cam, lane, prng.seed(seed, lane))
    return o, d


def render_depth(scene: T.Scene, cam: cam_mod.Camera, map_id: int = 0, log_scale: bool = False,
                 use_bvh: bool = True, seed: int = 0):
    """Primary-hit depth through a colormap -> ((H, W, 3) image, {depth
    (H, W) with 0 on a miss, t_min, t_max}): t normalised by the hits'
    min and max, log2(1 + x) with log_scale, misses at 1."""
    o, d = _primary_rays(cam, seed)
    if use_bvh:
        hit = traverse.closest_hit_bvh(scene.geom, scene.bvh, o, d, max_leaf=scene.bvh.max_leaf)
    else:
        hit = isect.closest_hit_brute(scene.geom, o, d)
    t = torch.where(hit["hit"], hit["t"], math.nan)
    # nan-min / nan-max: nan where nothing is hit, as in the reference
    none = ~hit["hit"].any()
    tmin = torch.where(none, math.nan, torch.where(hit["hit"], t, math.inf).amin())
    tmax = torch.where(none, math.nan, torch.where(hit["hit"], t, -math.inf).amax())
    x = (t - tmin) / torch.clamp(tmax - tmin, min=1e-8)
    if log_scale:
        x = torch.log2(1.0 + x) / math.log2(2.0)
    x = torch.where(torch.isnan(x), 1.0, x)
    img = colormap.apply_colormap(torch.clamp(x, 0.0, 1.0), map_id)
    return img.reshape(cam.height, cam.width, 3), {
        "depth": torch.where(torch.isnan(t), 0.0, t).reshape(cam.height, cam.width),
        "t_min": tmin,
        "t_max": tmax,
    }


def _aov_sample(scene: T.Scene, cam: cam_mod.Camera, lane, seed: int, use_bvh: bool):
    """One jittered camera sample's first-hit buffers: albedo, normal,
    emission, depth, coverage."""
    rng = prng.seed(seed & prng.MASK32, lane)
    o, d, rng = cam_mod.generate_rays(cam, lane, rng)
    hit = pt.closest_hit(scene, o, d, torch.ones_like(lane, dtype=torch.bool), use_bvh)
    ok = hit["hit"]
    t_safe = torch.where(ok, hit["t"], 1.0)
    p = o + t_safe[:, None] * d
    inter = isect.surface_interaction(scene.geom, torch.clamp(hit["prim"], min=0), hit["b1"],
                                      hit["b2"], p, d)
    obj = inter["obj"]
    bid = torch.clamp(scene.objects.bsdf_id[obj], min=0)
    eid = torch.clamp(scene.objects.emitter_id[obj], min=0).long()
    ctx = bsdf_eval.make_ctx(scene, bid, inter["uv"], inter["n_s"])
    env = emitters.env_radiance(scene, d)
    # the slot each family tints with (bsdf/eval.py): Lambertian and mirror
    # kd; translucent, dispersion and rough dielectric ks; conductor kg;
    # plastic's coat kd + ks; Forward (null) white
    bt = ctx["btype"][:, None]
    base = ctx["kd"]
    base = torch.where((bt == T.BSDF_TRANSLUCENT) | (bt == T.BSDF_DISPERSION)
                       | (bt == T.BSDF_GGX_DIELECTRIC), ctx["ks"], base)
    base = torch.where((bt == T.BSDF_PLASTIC) | (bt == T.BSDF_PLASTIC_FORWARD),
                       ctx["kd"] + ctx["ks"], base)
    base = torch.where(bt == T.BSDF_GGX_CONDUCTOR, ctx["kg"], base)
    base = torch.where(bt == T.BSDF_FORWARD, 1.0, base)
    base = torch.clamp(base, 0.0, 1.0)
    albedo = torch.where(ok[:, None], base, torch.clamp(env, 0.0, 1.0))
    normal = torch.where(ok[:, None], ctx["n"], 0.0)
    le = emitters.emitter_radiance_hit(scene, eid, inter["uv"], -vm.dot(d, inter["n_g"]))
    # emitter slot 0 is the null emitter: other surfaces emit nothing
    emission = torch.where((ok & (eid > 0))[:, None], le, torch.where(ok[:, None], 0.0, env))
    depth = torch.where(ok, hit["t"], 0.0)
    return albedo, normal, emission, depth, ok.to(torch.float32)


def render_aovs(scene: T.Scene, cam: cam_mod.Camera, spp: int = 1, seed: int = 0,
                use_bvh: bool = True) -> dict:
    """First-hit AOV buffers averaged over spp jittered camera samples
    (sample i seeded seed + i * 9781, the path tracer's per-sample
    streams). Returns (H, W, ...) tensors: albedo (textured base colour
    clipped to [0, 1]; the env radiance, clipped, on a miss), normal (the
    normal-mapped shading normal, the mean renormalised; 0 on a miss),
    emission (Le of emitter hits, cone-gated for spots; the env on a
    miss), depth (hit distance; 0 on a miss) and coverage (the fraction of
    samples that hit)."""
    H, W = cam.height, cam.width
    lane = torch.arange(H * W, device=scene.device)
    acc = None
    for i in range(spp):
        bufs = _aov_sample(scene, cam, lane, int(seed) + i * 9781, use_bvh)
        acc = bufs if acc is None else tuple(a + b for a, b in zip(acc, bufs))
    a, n, e, t, c = acc
    n_mean = n / spp
    n_len = torch.linalg.vector_norm(n_mean, dim=-1, keepdim=True)
    n_unit = torch.where(n_len > 1e-6, n_mean / torch.clamp(n_len, min=1e-6), 0.0)
    return {
        "albedo": (a / spp).reshape(H, W, 3),
        "normal": n_unit.reshape(H, W, 3),
        "emission": (e / spp).reshape(H, W, 3),
        "depth": (t / spp).reshape(H, W),
        "coverage": (c / spp).reshape(H, W),
    }


def render_bvh_cost(scene: T.Scene, cam: cam_mod.Camera, mode: str = "total", map_id: int = 2,
                    max_cost: float = 0.0, seed: int = 0):
    """Traversal-cost heatmap of the skip walk's primary rays -> ((H, W, 3)
    image, {mean_cost, max_cost}). mode: "node" (steps walked), "prim"
    (leaf slots tested) or anything else for their sum; max_cost 0 scales
    by the observed maximum."""
    o, d = _primary_rays(cam, seed)
    out = traverse.closest_hit_bvh(scene.geom, scene.bvh, o, d, max_leaf=scene.bvh.max_leaf,
                                   count_cost=True)
    node = out["node_cnt"].to(torch.float32)
    prim = out["prim_cnt"].to(torch.float32)
    cost = {"node": node, "prim": prim}.get(mode, node + prim)
    peak = cost.amax()
    denom = peak if max_cost <= 0 else torch.tensor(float(max_cost), device=cost.device)
    x = torch.clamp(cost / torch.clamp(denom, min=1e-8), 0.0, 1.0)
    img = colormap.apply_colormap(x, map_id)
    return img.reshape(cam.height, cam.width, 3), {"mean_cost": cost.mean(), "max_cost": peak}
