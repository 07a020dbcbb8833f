"""Light tracer: emitter-to-camera paths splatted onto the film (port of
cuda_pt_tpu/models/light_tracer.py).

Paths start at the emitters (emitters.sample_le), bounce by BSDF sampling,
and at every vertex connect to the pinhole camera: project with
camera.splat_pixel, shadow-test the segment, and add the contribution with
the pinhole importance W_e = f^2 / cos^3 theta into the flat film. The
splat is an ``index_add_`` (the reference's scatter-add); on the card its
float atomics do not fix the order of the adds, so two runs agree per
pixel to rounding, not bit for bit. The specular-constraint gate (a
connection counts once the path has passed that many non-diffuse
bounces) and the caustic scaling carry over; render_bidirectional sums a
path-traced and a light-traced image.

The walks are path_tracer.closest_hit / occluded on the lanes that need
them, so the scene's traversal applies: "pallas" walks on kernel K1 (one
closest walk and one connection walk per bounce, plus the vertex-0
connection); no kernel of its own.
"""

from __future__ import annotations

import torch

from ..bsdf import eval as bsdf_eval
from ..core import camera as cam_mod
from ..core import math as vm
from ..core import qmc
from ..core import rng as prng
from ..core.config import MaxDepthParams
from ..emitters import emitters
from ..ops import intersect as isect
from ..scene import types as T
from . import path_tracer as pt


def _connect_camera(scene: T.Scene, cam: cam_mod.Camera, p, f_cos_over_cosy, thp, active,
                    use_bvh: bool, img: torch.Tensor, n_spec_ok) -> torch.Tensor:
    """Connect vertices p to the camera and splat into img (H*W, 3) in
    place: the segment shortened by 1e-3 at the vertex end and tested for
    occlusion on the lanes that could splat."""
    to_cam = cam.t - p
    dist = vm.length(to_cam)
    dirn = to_cam / torch.clamp(dist, min=1e-8)[:, None]
    px, py, in_film = cam_mod.splat_pixel(cam, p)
    want = active & in_film & n_spec_ok
    occ = pt.occluded(scene, p + dirn * 1e-3, dirn, dist - 1e-3, want, use_bvh)
    # pinhole importance against the optical axis
    cos_axis = torch.clamp(vm.dot(dirn, -cam.R[:, 2]), 1e-3, 1.0)
    we = (cam.focal * cam.focal) / (cos_axis ** 3)
    contrib = thp * f_cos_over_cosy * (we / torch.clamp(dist * dist, min=1e-8))[:, None]
    ok = want & ~occ
    xi = torch.clamp(px.to(torch.int64), 0, cam.width - 1)
    yi = torch.clamp(py.to(torch.int64), 0, cam.height - 1)
    return img.index_add_(0, yi * cam.width + xi, torch.where(ok[:, None], contrib, 0.0))


def render_pass(scene: T.Scene, cam: cam_mod.Camera, md: MaxDepthParams, seed, pass_idx,
                use_bvh: bool, specular_constraint: int = 0, caustic_scale: float = 1.0,
                n_paths: int = 0, sampler: str = "pcg") -> torch.Tensor:
    """One light-tracing pass of n_paths paths (default one per pixel) ->
    the (H*W, 3) splat sum over n_paths."""
    qmc.check_sampler(sampler)
    B = n_paths or cam.width * cam.height
    dev = scene.device
    lane = torch.arange(B, device=dev)
    rng = prng.seed((int(seed) + int(pass_idx) * 7919 + 0x5BD1E995) & prng.MASK32, lane)
    le, rng = emitters.sample_le(scene, rng, B)
    img = torch.zeros((cam.width * cam.height, 3), device=dev)

    # vertex 0: the emission point seen by the camera, front face only and
    # inside an area-spot emitter's cone
    to_cam0 = cam.t - le["pos"]
    d0 = to_cam0 / torch.clamp(vm.length(to_cam0), min=1e-8)[:, None]
    cos_e = vm.dot(le["n"], d0)
    f0 = le["thp_pos"] * torch.clamp(cos_e, min=0.0)[:, None]
    gate0 = torch.full((B,), specular_constraint <= 0, device=dev)
    _connect_camera(scene, cam, le["pos"] + le["n"] * 1e-3, f0, torch.ones((B, 3), device=dev),
                    le["valid"] & (cos_e > 0.0) & (cos_e >= le["cos_gate"]), use_bvh, img,
                    gate0)

    o = le["pos"] + le["n"] * 1e-3
    d = le["dir"]
    thp = le["thp0"]
    active = le["valid"]
    n_spec = torch.zeros(B, dtype=torch.int32, device=dev)
    bounce = 0
    while bounce < md.max_depth and bool(active.any()):
        hit = pt.closest_hit(scene, o, d, active, use_bvh)
        hit_ok = hit["hit"] & active
        t_safe = torch.where(hit_ok, hit["t"], 1.0)
        p = o + t_safe[:, None] * d
        inter = isect.surface_interaction(scene.geom, torch.clamp(hit["prim"], min=0), hit["b1"],
                                          hit["b2"], p, d)
        bid = torch.clamp(scene.objects.bsdf_id[inter["obj"]], min=0)
        ctx = bsdf_eval.make_ctx(scene, bid, inter["uv"], inter["n_s"])
        wo = -d

        # the camera connection before scattering
        to_cam = cam.t - p
        dirn = to_cam / torch.clamp(vm.length(to_cam), min=1e-8)[:, None]
        f_cos, _ = bsdf_eval.eval_bsdf(ctx, wo, dirn)
        _connect_camera(scene, cam, p, f_cos * caustic_scale, thp, hit_ok, use_bvh, img,
                        n_spec >= specular_constraint)

        bs, rng = bsdf_eval.sample_bsdf(ctx, wo, rng)
        thp_new = thp * bs["weight"]
        thp_new = torch.where(torch.isfinite(thp_new), thp_new, 0.0)
        off = torch.sign(vm.dot(inter["n_g"], bs["wi"], keepdim=True))
        o = p + inter["n_g"] * off * 1e-3
        n_spec = n_spec + (hit_ok & (bs["lobe"] != bsdf_eval.LOBE_DIFFUSE)).to(torch.int32)

        # Russian roulette on the bounce weight from bounce 1 (the initial
        # throughput is in flux units, far above 1)
        w_mx = torch.amax(bs["weight"], dim=-1)
        mx = torch.amax(thp_new, dim=-1)
        u_rr, rng = prng.next1d(rng)
        p_srv = torch.clamp(w_mx, 0.1, 1.0) if bounce >= 1 else torch.ones_like(w_mx)
        thp_new = thp_new / p_srv[:, None]
        active = hit_ok & (u_rr < p_srv) & (mx > 0.0)
        d = bs["wi"]
        thp = torch.where(active[:, None], thp_new, 0.0)
        bounce += 1
    return img / B


def render(scene: T.Scene, cam: cam_mod.Camera, md: MaxDepthParams, spp: int, seed: int = 0,
           use_bvh=None, specular_constraint: int = 0, caustic_scale: float = 1.0,
           sampler: str = "pcg") -> torch.Tensor:
    """Light-traced image averaged over spp passes -> (H, W, 3)."""
    if use_bvh is None:
        use_bvh = scene.geom.num_prims > pt.BRUTE_FORCE_MAX_PRIMS
    acc = torch.zeros((cam.width * cam.height, 3), device=scene.device)
    for i in range(spp):
        acc = acc + render_pass(scene, cam, md, seed, i, use_bvh, specular_constraint,
                                caustic_scale, sampler=sampler)
    return (acc / spp).reshape(cam.height, cam.width, 3)


def render_bidirectional(scene: T.Scene, cam: cam_mod.Camera, md: MaxDepthParams, spp: int,
                         seed: int = 0, use_bvh=None, specular_constraint: int = 1,
                         caustic_scale: float = 1.0) -> torch.Tensor:
    """The reference's ``bidirectional`` mode: a path-traced image plus a
    light-traced caustic image (seed + 1). The path-traced half picks its
    walk by the scene's prim count (path_tracer.render takes no use_bvh
    yet, ROADMAP Queue 1 item 4); the hits do not depend on the choice
    beyond exact-t ties."""
    img_pt = pt.render(scene, cam, md, spp, seed=seed)
    img_lt = render(scene, cam, md, spp, seed=seed + 1, use_bvh=use_bvh,
                    specular_constraint=specular_constraint, caustic_scale=caustic_scale)
    return img_pt + img_lt
