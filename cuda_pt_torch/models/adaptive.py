"""Adaptive sampling: variance-driven per-tile sample allocation (port of
cuda_pt_tpu/models/adaptive.py).

After a uniform warm-up, each round gives one more sample to every pixel
of the K tiles whose estimated error of the mean (pixel variance / n,
pooled over the tile) is highest. Pooling over 8x8 tiles makes the
estimate steady enough to rank, and a picked tile is a contiguous block of
pixels, so a round's rays stay coherent.

A pixel's sample index is its own count, so adaptive and uniform
rendering draw from the same (pixel, sample) streams, and under
sampler="sobol" every pixel keeps its low-discrepancy prefix. The
reference's fixed-trip fori_loops are Python loops over device tensors:
a round picks its tiles by a stable descending sort (equal errors keep
the lower tile first, as jax.lax.top_k does), renders their pixels as one
flat batch and folds the samples into the per-pixel Welford state by
index; the round itself reads nothing back to the host.

Allocation driven by the empirical variance makes the mean stopping-rule
biased (counts correlate with values), the usual production trade-off.
"""

from __future__ import annotations

import torch

from ..core import camera as cam_mod
from ..core import math as vm
from ..core import qmc
from ..core.config import MaxDepthParams
from ..scene import types as T
from . import path_tracer as pt


def tile_pixels(height: int, width: int, tile: int, device="cpu") -> torch.Tensor:
    """Flat pixel ids of each tile, tiles and their pixels row-major:
    (ntiles, tile * tile) int64."""
    ty, tx = torch.meshgrid(torch.arange(height // tile, device=device),
                            torch.arange(width // tile, device=device), indexing="ij")
    py, px = torch.meshgrid(torch.arange(tile, device=device), torch.arange(tile, device=device),
                            indexing="ij")
    return ((ty.reshape(-1, 1) * tile + py.reshape(1, -1)) * width
            + tx.reshape(-1, 1) * tile + px.reshape(1, -1))


def pick_tiles(tile_err: torch.Tensor, k: int) -> torch.Tensor:
    """The k tiles of highest error, equal errors lower index first
    (jax.lax.top_k's order; torch.topk leaves it unspecified)."""
    return torch.sort(tile_err, descending=True, stable=True)[1][:k]


def mean_error(m2: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Per-pixel variance of the mean from the Welford state."""
    return m2 / (torch.clamp(n - 1.0, min=1.0) * torch.clamp(n, min=1.0))


def welford_add(state: tuple, pixel_ids: torch.Tensor, radiance: torch.Tensor) -> tuple:
    """Fold one sample per pixel of pixel_ids (distinct) into (mean (B, 3),
    m2 (B,), n (B,))."""
    mean, m2, n = state
    n = n.clone()
    n[pixel_ids] += 1.0
    n_sel = n[pixel_ids]
    old = mean[pixel_ids]
    delta_lum = vm.luminance(radiance) - vm.luminance(old)
    mean = mean.clone()
    mean[pixel_ids] = old + (radiance - old) / n_sel[:, None]
    m2 = m2.clone()
    m2[pixel_ids] += delta_lum * (delta_lum - delta_lum / n_sel)
    return mean, m2, n


def render_adaptive(scene: T.Scene, cam: cam_mod.Camera, md: MaxDepthParams, spp_budget: int,
                    base_spp: int | None = None, tile: int = 8, tile_frac: float = 0.25,
                    seed: int = 0, use_bvh=None, sampler: str = "pcg",
                    return_variance: bool = False, tracer: str = "pt", fused_pack=None):
    """Render with a total budget of spp_budget x W x H samples.

    base_spp uniform warm-up passes (default half the budget, and at
    least one pass fewer than it), then rounds that each give one more
    sample to every pixel of the tile_frac highest-error tiles until the
    budget is spent. tracer: "pt" (path_tracer.trace_paths) or "vpt"
    (volume_pt.trace_paths). fused_pack (an ops/megakernel pack, pcg
    only): each sample batch runs mk.auto_trace, the kernels on a CUDA
    device and their plain versions on the CPU.

    Returns (image (H, W, 3), n per pixel (H, W)), n averaging about
    spp_budget; return_variance appends the per-pixel variance of the
    mean (H, W)."""
    if base_spp is None:
        base_spp = max(min(spp_budget // 2, spp_budget - 1), 1)
    if spp_budget <= base_spp:
        raise ValueError(f"spp_budget {spp_budget} must exceed base_spp {base_spp}")
    if fused_pack is not None and sampler != "pcg":
        raise ValueError("fused adaptive takes sampler='pcg', as in the reference")
    qmc.check_sampler(sampler)
    if use_bvh is None:
        use_bvh = scene.geom.num_prims > pt.BRUTE_FORCE_MAX_PRIMS
    H, W = cam.height, cam.width
    while tile > 1 and (H % tile or W % tile):  # the largest tile that divides the frame
        tile //= 2
    B = W * H
    dev = scene.device
    ntiles = (H // tile) * (W // tile)
    lane = torch.arange(B, device=dev)
    K = max(int(ntiles * tile_frac), 1)
    rounds = max(((spp_budget - base_spp) * B) // (K * tile * tile), 1)
    tile_pix = tile_pixels(H, W, tile, dev)

    def sample_pixels(pixel_ids, n_of_pixel):
        """One sample per pixel at sample index n_of_pixel (its count)."""
        s_idx = n_of_pixel.to(torch.int64)
        rng = qmc.make_state(sampler, seed, pixel_ids, s_idx)
        o, d, rng = cam_mod.generate_rays(cam, pixel_ids, rng)
        if fused_pack is not None:
            from ..ops import megakernel as mk

            return mk.auto_trace(fused_pack, md, o, d, rng)
        wl_u = pt.wl_stratum_u(seed, s_idx, pixel_ids)
        if tracer == "vpt":
            from . import volume_pt

            return volume_pt.trace_paths(scene, md, o, d, rng, use_bvh, wl_u=wl_u)
        return pt.trace_paths(scene, md, o, d, rng, use_bvh, wl_u=wl_u)

    st = (torch.zeros((B, 3), device=dev), torch.zeros(B, device=dev),
          torch.zeros(B, device=dev))
    for _ in range(base_spp):
        st = welford_add(st, lane, sample_pixels(lane, st[2]))
    for _ in range(rounds):
        mean, m2, n = st
        tile_err = mean_error(m2, n)[tile_pix].mean(dim=1)
        sel = tile_pix[pick_tiles(tile_err, K)].reshape(-1)
        st = welford_add(st, sel, sample_pixels(sel, n[sel]))
    mean, m2, n = st
    out = (mean.reshape(H, W, 3), n.reshape(H, W))
    if return_variance:
        return (*out, mean_error(m2, n).reshape(H, W))
    return out
