"""Texture atlas sampling, bilinear with wrap addressing (port of
cuda_pt_tpu/scene/textures.py). Normal maps are stored raw in [0, 1] and
remapped to [-1, 1] at evaluation. The CUDA kernel's texel fetch
(csrc/tex.cuh) computes the same bilinear weights in the same order."""

from __future__ import annotations

import torch

from ..core import math as vm
from .types import TextureAtlas


def sample_texture(atlas: TextureAtlas, tex_id: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Bilinear RGBA fetch (B, 4). tex_id (B,) int (-1 returns ones so
    callers can multiply unconditionally); uv (B, 2), wrapped into [0, 1)."""
    tid = torch.clamp(tex_id, min=0).long()
    wi = atlas.width[tid].long()
    hi = atlas.height[tid].long()
    off = atlas.offset[tid].long()
    u = uv[..., 0] - torch.floor(uv[..., 0])
    v = uv[..., 1] - torch.floor(uv[..., 1])
    x = u * wi.to(torch.float32) - 0.5
    y = v * hi.to(torch.float32) - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0i = x0.long()
    y0i = y0.long()

    def fetch(xi, yi):
        return atlas.texels[off + torch.remainder(yi, hi) * wi + torch.remainder(xi, wi)]

    c = (fetch(x0i, y0i) * (1 - fx) * (1 - fy)
         + fetch(x0i + 1, y0i) * fx * (1 - fy)
         + fetch(x0i, y0i + 1) * (1 - fx) * fy
         + fetch(x0i + 1, y0i + 1) * fx * fy)
    return torch.where((tex_id >= 0)[..., None], c, torch.ones_like(c))


def scaled_rgb(atlas: TextureAtlas, tex_id: torch.Tensor, uv: torch.Tensor,
               base: torch.Tensor) -> torch.Tensor:
    """base colour modulated by an optional texture (identity when tex_id < 0)."""
    return base * sample_texture(atlas, tex_id, uv)[..., :3]


def eval_normal_map(atlas: TextureAtlas, tex_id: torch.Tensor, uv: torch.Tensor,
                    n_s: torch.Tensor) -> torch.Tensor:
    """Shading normal perturbed by a tangent-space normal map (TBN rotate)."""
    texn = sample_texture(atlas, tex_id, uv)[..., :3] * 2.0 - 1.0
    t, b = vm.onb(n_s)
    n_pert = vm.normalize(texn[..., 0:1] * t + texn[..., 1:2] * b
                          + torch.clamp(texn[..., 2:3], min=0.1) * n_s)
    return torch.where((tex_id >= 0)[..., None], n_pert, n_s)
