"""Low-level sampling routines with pdfs (port of core/sampling.py).

All functions take pre-drawn uniforms so the RNG stays with the caller.
"""

from __future__ import annotations

import math

import torch

from . import math as vm

INV_PI = 0.3183098861837907
TWO_PI = 6.283185307179586


def cosine_hemisphere(u: torch.Tensor):
    """Cosine-weighted hemisphere around +z. u: (..., 2). Returns (dir, pdf)."""
    phi = TWO_PI * u[..., 0]
    cos_theta = torch.sqrt(torch.clamp(1.0 - u[..., 1], min=0.0))
    sin_theta = torch.sqrt(torch.clamp(u[..., 1], min=0.0))
    d = torch.stack(
        [sin_theta * torch.cos(phi), sin_theta * torch.sin(phi), cos_theta], dim=-1)
    return d, cos_theta * INV_PI


def cosine_hemisphere_pdf(cos_theta: torch.Tensor) -> torch.Tensor:
    return torch.clamp(cos_theta, min=0.0) * INV_PI


def uniform_sphere(u: torch.Tensor):
    """Uniform direction on the sphere. Returns (dir, pdf=1/4pi)."""
    z = 1.0 - 2.0 * u[..., 0]
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = TWO_PI * u[..., 1]
    d = torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)
    return d, torch.full(u.shape[:-1], 1.0 / (2.0 * TWO_PI), device=u.device)


def uniform_hemisphere(u: torch.Tensor):
    """Uniform direction on the +z hemisphere. Returns (dir, pdf=1/2pi)."""
    z = u[..., 0]
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = TWO_PI * u[..., 1]
    d = torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)
    return d, torch.full(u.shape[:-1], 1.0 / TWO_PI, device=u.device)


def uniform_cone(u: torch.Tensor, cos_max):
    """Uniform direction in a cone of half-angle acos(cos_max) around +z.
    Returns (dir, pdf)."""
    cos_theta = 1.0 - u[..., 0] * (1.0 - cos_max)
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    phi = TWO_PI * u[..., 1]
    d = torch.stack([sin_theta * torch.cos(phi), sin_theta * torch.sin(phi), cos_theta], dim=-1)
    pdf = 1.0 / (TWO_PI * torch.clamp(torch.as_tensor(1.0 - cos_max, device=u.device), min=1e-8))
    return d, pdf


def concentric_disk(u: torch.Tensor) -> torch.Tensor:
    """Concentric map of [0,1)^2 to the unit disk (thin-lens DoF)."""
    ox = 2.0 * u[..., 0] - 1.0
    oy = 2.0 * u[..., 1] - 1.0
    use_x = torch.abs(ox) > torch.abs(oy)
    r = torch.where(use_x, ox, oy)
    theta = torch.where(
        use_x,
        (math.pi / 4.0) * vm.safe_div(oy, ox),
        (math.pi / 2.0) - (math.pi / 4.0) * vm.safe_div(ox, oy),
    )
    zero = (torch.abs(ox) < 1e-12) & (torch.abs(oy) < 1e-12)
    x = torch.where(zero, 0.0, r * torch.cos(theta))
    y = torch.where(zero, 0.0, r * torch.sin(theta))
    return torch.stack([x, y], dim=-1)


def uniform_triangle(u: torch.Tensor) -> torch.Tensor:
    """Uniform barycentrics (b1, b2) by the sqrt warp. u: (..., 2)."""
    su = torch.sqrt(torch.clamp(u[..., 0], min=0.0))
    b1 = 1.0 - su
    b2 = u[..., 1] * su
    return torch.stack([b1, b2], dim=-1)


def power_heuristic(pdf_a: torch.Tensor, pdf_b: torch.Tensor) -> torch.Tensor:
    """Power heuristic (beta=2) MIS weight for strategy a, ratio form."""
    r = pdf_b / torch.clamp(pdf_a, min=1e-12)
    w = 1.0 / (1.0 + r * r)
    return torch.where(pdf_a > 0.0, w, 0.0)


def balance_heuristic(pdf_a: torch.Tensor, pdf_b: torch.Tensor) -> torch.Tensor:
    """Balance heuristic MIS weight for strategy a, ratio form."""
    r = pdf_b / torch.clamp(pdf_a, min=1e-12)
    return torch.where(pdf_a > 0.0, 1.0 / (1.0 + r), 0.0)
