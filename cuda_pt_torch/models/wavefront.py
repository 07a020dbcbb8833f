"""Wavefront path tracer: per-bounce sorting of the ray pool (port of
cuda_pt_tpu/models/wavefront.py).

The lanes of a pass live in one PTState (structure of arrays); each bounce
finds every live lane's closest hit (path_tracer.intersect_stage, which
takes the scene's walk backend: kernel K1 under traversal "pallas"), sorts
the lanes by (dead last, material type, Morton code of the hit point), and
shades them in that order (path_tracer.shade_stage, with a path-guiding
``guide`` where one is given: models/guiding.py). ``compact=True`` first
moves the live lanes to the front and runs the bounce only on the smallest
power-of-two prefix that holds them (128 lanes at least), so dead lanes
stop costing work. Radiance goes back to the pixels at the end by
index_add_, the lanes carrying their pixel ids through the sorts.

A lane's pcg state travels with it, so each lane's radiance equals the
composed path_tracer.trace_paths on the same ray and stream; the pass
equals path_tracer.render_sample pixel for pixel. The reference's one
lax.while_loop becomes a Python loop that ends when no lane is live.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core import camera as cam_mod
from ..core import qmc
from ..core.config import MaxDepthParams
from ..ops import morton
from ..scene import types as T
from . import path_tracer as pt

_DEAD_KEY = 0xFFFFFFFF  # sorts after every live key (held in int64)


def lane_fields(s, B: int) -> dict:
    """The per-lane fields of a B-lane state (a path tracer's or a volume
    path tracer's)."""
    return {f.name: getattr(s, f.name) for f in dataclasses.fields(s)
            if torch.is_tensor(getattr(s, f.name)) and getattr(s, f.name).shape[:1] == (B,)}


def permute_lanes(s, idx: torch.Tensor):
    """The lanes idx of s, in that order."""
    return dataclasses.replace(s, **{k: v[idx] for k, v in lane_fields(s, s.o.shape[0]).items()})


def _sort_key(scene: T.Scene, s: pt.PTState, hit: dict, spatial: bool = True) -> torch.Tensor:
    """Sort key (int64 holding the reference's uint32): dead lanes last,
    the material type in bits 31..27, the Morton code of the hit point in
    the 27 bits below."""
    prim = torch.clamp(hit["prim"], min=0)
    obj = scene.geom.obj_idx[prim].long()
    bid = torch.clamp(scene.objects.bsdf_id[obj], min=0).long()
    key = scene.bsdfs.btype[bid].long() << 27
    live = s.active & hit["hit"]
    if spatial:
        t_safe = torch.where(live, torch.clamp(hit["t"], max=1e7), 0.0)
        p = s.o + t_safe[:, None] * s.d
        code = morton.morton3d(p, scene.bvh.node_min[0], scene.bvh.node_max[0])
        key = key | ((code >> 3) & 0x07FFFFFF)
    return torch.where(live, key, _DEAD_KEY)


def _bounce(scene: T.Scene, md: MaxDepthParams, s: pt.PTState, pix: torch.Tensor,
            sort_rays: bool, nee_candidates: int, guide=None):
    hit = pt.intersect_stage(scene, s)
    if sort_rays:
        perm = torch.argsort(_sort_key(scene, s, hit), stable=True)
        s = permute_lanes(s, perm)
        hit = {k: v[perm] for k, v in hit.items()}
        pix = pix[perm]
    return pt.shade_stage(scene, md, s, hit, nee_candidates, guide=guide), pix


def compact_sizes(B: int, compact_levels: int = 7) -> list:
    """The prefix ladder B, B/2, ... with a floor of 128 lanes (or B)."""
    sizes = [B]
    for k in range(1, max(compact_levels, 1)):
        sz = max(B >> k, min(128, B))
        if sz < sizes[-1]:
            sizes.append(sz)
    return sizes


def compacted_bounce(s, pix: torch.Tensor, sizes: list, bounce):
    """One bounce on the live prefix: the live lanes moved to the front
    (stable: the last sort's coherence stays), then bounce(sub, pix_sub) ->
    (sub, pix_sub) on the smallest prefix of the ladder sizes that holds
    them; the lanes past it are carried as they are. Returns (s, pix)."""
    B = pix.shape[0]
    perm = torch.argsort((~s.active).to(torch.int8), stable=True)
    s = permute_lanes(s, perm)
    pix = pix[perm]
    n_live = int(s.active.sum())
    size = min(sz for sz in sizes if sz >= n_live)
    sub, pix_sub = bounce(permute_lanes(s, torch.arange(size, device=pix.device)), pix[:size])
    s = dataclasses.replace(sub, **{k: torch.cat([getattr(sub, k), v[size:]])
                                    for k, v in lane_fields(s, B).items()})
    return s, torch.cat([pix_sub, pix[size:]])


def trace_paths_wavefront(scene: T.Scene, md: MaxDepthParams, o: torch.Tensor,
                          d: torch.Tensor, rng: torch.Tensor, sort_rays: bool = True,
                          compact: bool = False, compact_levels: int = 7, guide=None,
                          wl_u=None, nee_candidates: int = 1):
    """The bounce loop with a sort per bounce -> (L, pix): L[i] belongs to
    the original lane pix[i]. compact: the live-prefix ladder of
    compact_sizes (module docstring). guide: path guiding
    (models/guiding.py, path_tracer.shade_stage)."""
    pt.check_supported(scene)
    B = o.shape[0]
    s = pt.init_state(o, d, rng, wl_u)
    pix = torch.arange(B, device=o.device)
    sizes = compact_sizes(B, compact_levels)

    def bounce(st, px):
        return _bounce(scene, md, st, px, sort_rays, nee_candidates, guide)

    while s.bounce < md.max_depth and bool(s.active.any()):
        s, pix = compacted_bounce(s, pix, sizes, bounce) if compact else bounce(s, pix)
    return s.L, pix


def render_sample(scene: T.Scene, cam: cam_mod.Camera, md: MaxDepthParams, seed, sample_idx,
                  sort_rays: bool = True, compact: bool = False, guide=None,
                  sampler: str = "pcg", nee_candidates: int = 1) -> torch.Tensor:
    """One 1-spp wavefront pass -> (H, W, 3); guide: path guiding."""
    B = cam.width * cam.height
    lane = torch.arange(B, device=scene.device)
    rng = qmc.make_state(sampler, seed, lane, sample_idx)
    o, d, rng = cam_mod.generate_rays(cam, lane, rng)
    L, pix = trace_paths_wavefront(scene, md, o, d, rng, sort_rays, compact, guide=guide,
                                   wl_u=pt.wl_stratum_u(seed, sample_idx, lane),
                                   nee_candidates=nee_candidates)
    img = torch.zeros((B, 3), device=scene.device).index_add_(0, pix, L)
    return img.reshape(cam.height, cam.width, 3)


def render(scene: T.Scene, cam: cam_mod.Camera, md: MaxDepthParams, spp: int, seed: int = 0,
           sort_rays: bool = True, compact: bool = False, guide=None, sampler: str = "pcg",
           nee_candidates: int = 1) -> torch.Tensor:
    """Multi-spp wavefront render -> (H, W, 3) mean; guide: path guiding
    (models/guiding.train_guide or make_guide), on the scene's device."""
    acc = torch.zeros((cam.height, cam.width, 3), device=scene.device)
    for i in range(spp):
        acc = acc + render_sample(scene, cam, md, seed, i, sort_rays, compact, guide=guide,
                                  sampler=sampler, nee_candidates=nee_candidates)
    return acc / spp
