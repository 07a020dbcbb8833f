"""Vector math on batched (..., 3) float32 tensors (port of core/math.py).

Dot products are written out as x*x' + y*y' + z*z' in that order, so the
summation order is fixed on every device and matches the CUDA kernel.
"""

from __future__ import annotations

import torch

EPS = 1e-5
MAX_DIST = 1e7  # the reference's src/core/constants.cuh MAX_DIST


def dot(a: torch.Tensor, b: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    out = a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]
    return out.unsqueeze(-1) if keepdim else out


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack(
        [
            a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
        ],
        dim=-1,
    )


def length(v: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    return torch.sqrt(torch.clamp(dot(v, v, keepdim=keepdim), min=1e-30))


def normalize(v: torch.Tensor) -> torch.Tensor:
    return v * torch.rsqrt(torch.clamp(dot(v, v, keepdim=True), min=1e-30))


def normalize_rounded(v: torch.Tensor) -> torch.Tensor:
    """normalize computed in float64 and rounded once to float32: the
    float32 unit vector nearest the exact one, on every device. float32
    rsqrt approximations differ between devices and libraries by an ulp,
    which the product with v can widen to two; camera rays use this so they
    stay within 1 ulp of any reference that is itself within 1 ulp."""
    v64 = v.double()
    return (v64 * torch.rsqrt(torch.clamp(dot(v64, v64, keepdim=True), min=1e-30))).to(v.dtype)


def reflect(d: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Reflect d (pointing toward the surface) about n."""
    return d - 2.0 * dot(d, n, keepdim=True) * n


def refract(d: torch.Tensor, n: torch.Tensor, eta: torch.Tensor):
    """Refract d through n with relative IoR eta = n_i/n_t, (..., 1).
    Returns (wt, total_internal_reflection_mask)."""
    cos_i = -dot(d, n, keepdim=True)
    sin2_t = eta * eta * torch.clamp(1.0 - cos_i * cos_i, min=0.0)
    tir = (sin2_t >= 1.0)[..., 0]
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
    wt = eta * d + (eta * cos_i - cos_t) * n
    return normalize(wt), tir


def onb(n: torch.Tensor):
    """Orthonormal basis (t, b) of unit normal n (Duff et al. / Frisvad)."""
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    sign = torch.where(nz >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + nz)
    b = nx * ny * a
    t = torch.stack([1.0 + sign * nx * nx * a, sign * b, -sign * nx], dim=-1)
    bt = torch.stack([b, sign + ny * ny * a, -ny], dim=-1)
    return t, bt


def to_world(local: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    t, b = onb(n)
    return local[..., 0:1] * t + local[..., 1:2] * b + local[..., 2:3] * n


def safe_div(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    small = torch.where(b < 0, -eps, eps)
    return a / torch.where(torch.abs(b) < eps, small, b)

