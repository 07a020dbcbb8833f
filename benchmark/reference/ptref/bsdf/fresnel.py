"""Fresnel terms (port of cuda_pt_tpu/bsdf/fresnel.py)."""

from __future__ import annotations

import torch


def fresnel_dielectric(cos_i: torch.Tensor, eta: torch.Tensor) -> torch.Tensor:
    """Unpolarized dielectric reflectance. cos_i >= 0; eta = n_t / n_i.
    Returns 1 under total internal reflection."""
    cos_i = torch.clamp(cos_i, 0.0, 1.0)
    sin2_t = (1.0 - cos_i * cos_i) / torch.clamp(eta * eta, min=1e-8)
    tir = sin2_t >= 1.0
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
    r_par = (eta * cos_i - cos_t) / torch.clamp(eta * cos_i + cos_t, min=1e-8)
    r_per = (cos_i - eta * cos_t) / torch.clamp(cos_i + eta * cos_t, min=1e-8)
    f = 0.5 * (r_par * r_par + r_per * r_per)
    return torch.where(tir, 1.0, torch.clamp(f, 0.0, 1.0))


def fresnel_conductor(cos_i: torch.Tensor, eta: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Spectral conductor Fresnel per RGB channel. cos_i (...,); eta, k (..., 3)."""
    c = torch.clamp(cos_i, 1e-5, 1.0)[..., None]
    c2 = c * c
    s2 = 1.0 - c2
    e2 = eta * eta
    k2 = k * k
    t0 = e2 - k2 - s2
    a2b2 = torch.sqrt(torch.clamp(t0 * t0 + 4.0 * e2 * k2, min=0.0))
    t1 = a2b2 + c2
    a = torch.sqrt(torch.clamp(0.5 * (a2b2 + t0), min=0.0))
    t2 = 2.0 * a * c
    rs = (t1 - t2) / torch.clamp(t1 + t2, min=1e-8)
    t3 = c2 * a2b2 + s2 * s2
    t4 = t2 * s2
    rp = rs * (t3 - t4) / torch.clamp(t3 + t4, min=1e-8)
    return torch.clamp(0.5 * (rp + rs), 0.0, 1.0)


def diffuse_fresnel(eta: torch.Tensor) -> torch.Tensor:
    """Hemispherically-integrated internal Fresnel reflectance (polynomial fit)."""
    inv = 1.0 / torch.clamp(eta, min=1.0 + 1e-4)
    return torch.clamp(-1.4399 * inv * inv + 0.7099 * inv + 0.6681 + 0.0636 * eta, 0.0, 0.999)
