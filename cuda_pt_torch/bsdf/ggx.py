"""Anisotropic GGX microfacet distribution with visible-NDF sampling (port
of cuda_pt_tpu/bsdf/ggx.py): Trowbridge-Reitz NDF, height-correlated Smith
masking and Heitz's stretched-slope VNDF sampling, in the local frame
where +z is the shading normal, batched over rays."""

from __future__ import annotations

import math

import torch


def ndf(h_local: torch.Tensor, ax, ay) -> torch.Tensor:
    """Anisotropic GGX NDF D(h). h_local: (..., 3) in the shading frame."""
    x = h_local[..., 0] / torch.clamp(ax, min=1e-5)
    y = h_local[..., 1] / torch.clamp(ay, min=1e-5)
    z = h_local[..., 2]
    t = x * x + y * y + z * z
    d = 1.0 / (math.pi * ax * ay * torch.clamp(t * t, min=1e-12))
    return torch.where(z > 0.0, d, 0.0)


def _lambda(w: torch.Tensor, ax, ay) -> torch.Tensor:
    """Smith Lambda for GGX."""
    cz = torch.abs(w[..., 2])
    a2 = (w[..., 0] * ax) ** 2 + (w[..., 1] * ay) ** 2
    t2 = a2 / torch.clamp(cz * cz, min=1e-10)
    return 0.5 * (torch.sqrt(1.0 + t2) - 1.0)


def g1(w: torch.Tensor, ax, ay) -> torch.Tensor:
    return 1.0 / (1.0 + _lambda(w, ax, ay))


def g2(wo: torch.Tensor, wi: torch.Tensor, ax, ay) -> torch.Tensor:
    """Height-correlated Smith masking-shadowing."""
    return 1.0 / (1.0 + _lambda(wo, ax, ay) + _lambda(wi, ax, ay))


def sample_vndf(wo_local: torch.Tensor, ax, ay, u: torch.Tensor) -> torch.Tensor:
    """Visible half-vector (Heitz 2018). wo_local (..., 3) with z > 0,
    u (..., 2) uniforms -> h (..., 3)."""
    ax_ = torch.broadcast_to(torch.as_tensor(ax), wo_local.shape[:-1])
    ay_ = torch.broadcast_to(torch.as_tensor(ay), wo_local.shape[:-1])
    v = torch.stack([wo_local[..., 0] * ax_, wo_local[..., 1] * ay_, wo_local[..., 2]], dim=-1)
    v = v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=1e-8)
    lensq = v[..., 0] ** 2 + v[..., 1] ** 2
    t1_big = (torch.stack([-v[..., 1], v[..., 0], torch.zeros_like(lensq)], dim=-1)
              / torch.sqrt(torch.clamp(lensq, min=1e-8))[..., None])
    t1_def = torch.zeros_like(v)
    t1_def[..., 0] = 1.0
    t1 = torch.where((lensq > 1e-8)[..., None], t1_big, t1_def)
    t2 = torch.linalg.cross(v, t1, dim=-1)
    r = torch.sqrt(torch.clamp(u[..., 0], min=0.0))
    phi = 2.0 * math.pi * u[..., 1]
    p1 = r * torch.cos(phi)
    p2 = r * torch.sin(phi)
    s = 0.5 * (1.0 + v[..., 2])
    p2 = (1.0 - s) * torch.sqrt(torch.clamp(1.0 - p1 * p1, min=0.0)) + s * p2
    p3 = torch.sqrt(torch.clamp(1.0 - p1 * p1 - p2 * p2, min=0.0))
    nh = p1[..., None] * t1 + p2[..., None] * t2 + p3[..., None] * v
    h = torch.stack([nh[..., 0] * ax_, nh[..., 1] * ay_, torch.clamp(nh[..., 2], min=1e-6)],
                    dim=-1)
    return h / torch.clamp(torch.linalg.norm(h, dim=-1, keepdim=True), min=1e-8)


def vndf_pdf(wo_local: torch.Tensor, h_local: torch.Tensor, ax, ay) -> torch.Tensor:
    """pdf (per wi solid angle) of VNDF sampling followed by reflection."""
    cos_o = torch.abs(wo_local[..., 2])
    doh = torch.abs(torch.sum(wo_local * h_local, dim=-1))
    d = ndf(h_local, ax, ay)
    g = g1(wo_local, ax, ay)
    return g * d * doh / torch.clamp(cos_o, min=1e-6) / torch.clamp(4.0 * doh, min=1e-8)
