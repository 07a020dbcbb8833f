"""Multi-process rendering over torch.distributed (port of
cuda_pt_tpu/parallel/distributed.py).

One process per rank, over a 2-axis DeviceMesh in the reference's layout:

  "sp" - sample parallelism: every sp-rank renders the whole pixel set on
         its own window of sample indices, and the images are averaged over
         "sp";
  "dp" - pixel parallelism: the lanes are split into dp bands, one per
         dp-rank, each rank holding the whole scene.

The image is assembled from the dp bands and replicated on every rank. The
reference's shard_map body becomes this rank's part of the work, and its
psum over "sp" and the band gather become the collectives below.

Gradients: the assembled image of a differentiable render is attached to
this rank's own samples only (_Assemble): the collectives carry values, and
the backward pass hands each rank the gradient of its own lanes. A loss
computed alike on every rank (the image is replicated) thus gives each
rank its share of the gradient, and the shares summed over the world are
the gradient of the global loss: render_train_step all-reduces them after
backward, so every rank gets the same loss and the same gradients.

Collectives under gloo: gloo reduces and gathers CUDA tensors only in some
builds, so under a gloo group a CUDA tensor is staged through the host
inside the collective helpers (_all_reduce, _all_gather). That is a
transport choice: the rendering stays on the card. NCCL takes the CUDA
tensors as they are; it refuses two ranks on one device.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..core import camera as cam_mod
from ..core import qmc
from ..core.config import MaxDepthParams
from ..models import path_tracer as pt
from ..models import volume_pt, wavefront
from ..scene import types as T

RENDERERS = ("pt", "wfpt", "fused", "vpt")


def make_mesh(sp: int = 1, dp: int | None = None, device_type: str | None = None) -> DeviceMesh:
    """An (sp, dp) DeviceMesh, dims ("sp", "dp"), over the initialised
    default process group (dp defaults to world // sp). device_type None
    means CUDA, which raises where CUDA is absent: pass "cpu" to render on
    the CPU."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised default process group "
                           "(torch.distributed.init_process_group)")
    if device_type is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh(device_type=None) renders on CUDA, which is not "
                               "available; pass device_type='cpu' to render on the CPU")
        device_type = "cuda"
    n = dist.get_world_size()
    dp = n // sp if dp is None else dp
    if sp * dp != n:
        raise ValueError(f"mesh {sp}x{dp} != {n} ranks")
    return init_device_mesh(device_type, (sp, dp), mesh_dim_names=("sp", "dp"))


def _staged(x: torch.Tensor, group) -> bool:
    return x.is_cuda and dist.get_backend(group) == "gloo"


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of x over group, on every rank of it (staged through the
    host for a CUDA tensor under gloo: module docstring)."""
    y = x.detach().cpu() if _staged(x, group) else x.detach().clone()
    dist.all_reduce(y, group=group)
    return y.to(x.device)


def _all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """The x of every rank of group, concatenated along dim 0 in rank
    order (staged through the host for a CUDA tensor under gloo)."""
    y = x.detach().cpu().contiguous() if _staged(x, group) else x.detach().contiguous()
    parts = [torch.empty_like(y) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, y, group=group)
    return torch.cat(parts).to(x.device)


class _Assemble(torch.autograd.Function):
    """This rank's band partial sum (lanes, 3) -> the (B, 3) image: summed
    over "sp", divided by n (the world's samples per pixel), gathered over
    "dp" and cut to B lanes. Backward: the gradient of this rank's own
    lanes only (module docstring)."""

    @staticmethod
    def forward(ctx, acc, mesh, n: int, B: int):
        band = _all_reduce(acc, mesh.get_group("sp")) / n
        ctx.n, ctx.lanes, ctx.start = n, acc.shape[0], mesh.get_local_rank("dp") * acc.shape[0]
        return _all_gather(band, mesh.get_group("dp"))[:B]

    @staticmethod
    def backward(ctx, grad):
        g = torch.zeros((ctx.lanes, 3), dtype=grad.dtype, device=grad.device)
        got = grad[ctx.start:ctx.start + ctx.lanes]
        g[:got.shape[0]] = got / ctx.n
        return g, None, None, None


def _render_tile_lanes(scene: T.Scene, cam: cam_mod.Camera, md: MaxDepthParams, seed: int,
                       sample_base: int, lane_ids: torch.Tensor, use_bvh, n_samples: int,
                       differentiable=False, renderer: str = "pt", sampler: str = "pcg",
                       fused_pack=None) -> torch.Tensor:
    """n_samples passes over the pixel ids lane_ids from sample index
    sample_base on -> their (lanes, 3) sum."""
    acc = torch.zeros((lane_ids.shape[0], 3), device=lane_ids.device)
    for i in range(n_samples):
        s_idx = sample_base + i
        rng = qmc.make_state(sampler, seed, lane_ids, s_idx)
        o, d, rng = cam_mod.generate_rays(cam, lane_ids, rng)
        wl_u = pt.wl_stratum_u(seed, s_idx, lane_ids)
        if renderer == "wfpt" and not differentiable:
            Lw, pix = wavefront.trace_paths_wavefront(scene, md, o, d, rng, sort_rays=True,
                                                      compact=True, wl_u=wl_u)
            L = torch.zeros_like(Lw).index_add_(0, pix, Lw)
        elif renderer == "fused":
            from ..ops import megakernel as mk

            L = mk.trace_megakernel(fused_pack, md, o, d, rng)
        elif renderer == "vpt" and differentiable:
            L = volume_pt.trace_paths(scene, md, o, d, rng, use_bvh, differentiable, wl_u=wl_u)
        elif renderer == "vpt":
            Lv, pix = volume_pt.trace_paths(scene, md, o, d, rng, use_bvh, compact=True,
                                            wl_u=wl_u)
            L = torch.zeros_like(Lv).index_add_(0, pix, Lv)
        else:
            L = pt.trace_paths(scene, md, o, d, rng, use_bvh, differentiable, wl_u=wl_u)
        acc = acc + L
    return acc


def render_distributed(scene: T.Scene, cam: cam_mod.Camera, md: MaxDepthParams, spp: int,
                       mesh: DeviceMesh, seed: int = 0, use_bvh=None,
                       differentiable: bool | str = False, renderer: str = "pt",
                       sampler: str = "pcg", sample_base0: int = 0, fused_pack=None,
                       fused_max_leaf: int = 4) -> torch.Tensor:
    """Render pixels split over "dp" and samples over "sp" -> the (H, W, 3)
    mean image, replicated on every rank.

    The lanes are padded to a multiple of dp, the padding re-rendering the
    last pixel; sp-rank r renders sample indices r * spp / sp +
    sample_base0 on (a driver that accumulates calls passes pass * spp, so
    that the indices advance). renderer: "pt" (the composed path tracer),
    "wfpt" (the compacted wavefront), "vpt" (the volume path tracer,
    compacted; a differentiable render runs it uncompacted) or "fused"
    (ops/megakernel.trace_megakernel on the caller's fused_pack: kernel K2
    on a surface pack, on the card; pcg streams only). fused_max_leaf is
    the reference's: the port's pack carries its leaf size. A
    differentiable image is attached to this rank's samples (module
    docstring)."""
    if renderer not in RENDERERS:
        raise ValueError(f"unknown renderer {renderer!r}; one of {RENDERERS}")
    if renderer == "fused" and sampler != "pcg":
        # the kernel would read a (B, 4) Sobol state's first two columns as
        # pcg states, alike across lanes
        raise ValueError("renderer='fused' supports sampler='pcg' only")
    sp, dp = mesh.size(0), mesh.size(1)
    if spp % sp != 0:
        raise ValueError(f"spp={spp} must divide evenly over the sp axis (sp={sp}); pad spp "
                         "or resize the mesh so the requested sample count is honored")
    spp_per = spp // sp
    B = cam.width * cam.height
    per = (B + (-B) % dp) // dp
    start = mesh.get_local_rank("dp") * per
    lanes = torch.clamp(torch.arange(start, start + per, device=scene.device), max=B - 1)
    sample_base = mesh.get_local_rank("sp") * spp_per + int(sample_base0)

    def run():
        return _render_tile_lanes(scene, cam, md, seed, sample_base, lanes, use_bvh, spp_per,
                                  differentiable, renderer, sampler, fused_pack)

    if differentiable:
        acc = run()
    else:
        with torch.no_grad():
            acc = run()
    return _Assemble.apply(acc, mesh, sp * spp_per, B).reshape(cam.height, cam.width, 3)


def diff_params(scene: T.Scene) -> dict:
    """The float-valued differentiable parameter set of a scene."""
    return {
        "k_d": scene.bsdfs.k_d,
        "k_s": scene.bsdfs.k_s,
        "k_g": scene.bsdfs.k_g,
        "eta": scene.bsdfs.eta,
        "k": scene.bsdfs.k,
        "bsdf_params": scene.bsdfs.params,
        "emission": scene.emitters.emission,
        "scaler": scene.emitters.scaler,
        "sigma_a": scene.media.sigma_a,
        "sigma_s": scene.media.sigma_s,
        "med_scale": scene.media.scale,
    }


def with_params(scene: T.Scene, p: dict) -> T.Scene:
    """The scene with diff_params' tables replaced by p's."""
    rp = dataclasses.replace
    return rp(scene,
              bsdfs=rp(scene.bsdfs, k_d=p["k_d"], k_s=p["k_s"], k_g=p["k_g"], eta=p["eta"],
                       k=p["k"], params=p["bsdf_params"]),
              emitters=rp(scene.emitters, emission=p["emission"], scaler=p["scaler"]),
              media=rp(scene.media, sigma_a=p["sigma_a"], sigma_s=p["sigma_s"],
                       scale=p["med_scale"]))


def render_train_step(scene: T.Scene, cam: cam_mod.Camera, md: MaxDepthParams,
                      target: torch.Tensor, mesh: DeviceMesh, spp: int = 1, seed: int = 0,
                      remat: bool = False):
    """One differentiable-render training step: loss = MSE(render, target)
    -> (loss, grads), grads by diff_params' keys, those of the global loss
    and the same on every rank: each rank's backward gives its share, and
    the shares are all-reduced (module docstring). remat recomputes each
    bounce in the backward pass instead of keeping its activations: the
    same gradients in less memory."""
    params = {k: v.detach().clone().requires_grad_(True) for k, v in diff_params(scene).items()}
    img = render_distributed(with_params(scene, params), cam, md, spp, mesh, seed=seed,
                             differentiable="remat" if remat else True)
    loss = torch.mean((img - target) ** 2)
    loss.backward()
    grads = {k: _all_reduce(p.grad if p.grad is not None else torch.zeros_like(p),
                            dist.group.WORLD)
             for k, p in params.items()}
    return loss.detach(), grads
