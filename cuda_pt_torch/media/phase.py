"""Phase functions: isotropic, Henyey-Greenstein, dual-lobe HG, Rayleigh
(port of cuda_pt_tpu/media/phase.py; SGGX falls back to isotropic as
there). Evaluated batched and selected by type id.

The reference's conventions are kept as they are: ``phase_eval`` evaluates
HG with ``1 + g^2 + 2 g cos`` at ``cos = d_in . d_out``, while
``phase_sample`` draws a forward-peaked lobe around ``d_in`` (ROADMAP
Queue 3 records the disagreement). The fused kernel's own forward-HG
phase lives with its estimator (models/volume_pt.py, fused mode).
"""

from __future__ import annotations

import math

import torch

from ..core import math as vm
from ..scene import types as T

_INV_4PI = 1.0 / (4.0 * math.pi)


def _hg(cos_t: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    g2 = g * g
    denom = 1.0 + g2 + 2.0 * g * cos_t
    return _INV_4PI * (1.0 - g2) / torch.clamp(
        denom * torch.sqrt(torch.clamp(denom, min=1e-8)), min=1e-8)


def _rayleigh(cos_t: torch.Tensor) -> torch.Tensor:
    return (3.0 / (16.0 * math.pi)) * (1.0 + cos_t * cos_t)


def phase_eval(ptype, g, g2, w, d_in: torch.Tensor, d_out: torch.Tensor) -> torch.Tensor:
    """Phase value (= pdf) for scattering d_in -> d_out, all (B,)-batched."""
    cos_t = vm.dot(d_in, d_out)
    out = torch.full_like(cos_t, _INV_4PI)
    out = torch.where(ptype == T.PHASE_HG, _hg(cos_t, g), out)
    out = torch.where(ptype == T.PHASE_DUAL_HG, w * _hg(cos_t, g) + (1.0 - w) * _hg(cos_t, g2), out)
    return torch.where(ptype == T.PHASE_RAYLEIGH, _rayleigh(cos_t), out)


def _sample_hg_cos(g: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Exact HG inverse CDF."""
    small = torch.abs(g) < 1e-3
    g_safe = torch.where(small, 1e-3, g)
    sq = (1.0 - g_safe * g_safe) / (1.0 - g_safe + 2.0 * g_safe * u)
    cos_hg = (1.0 + g_safe * g_safe - sq * sq) / (2.0 * g_safe)
    return torch.where(small, 1.0 - 2.0 * u, torch.clamp(cos_hg, -1.0, 1.0))


def _sample_rayleigh_cos(u: torch.Tensor) -> torch.Tensor:
    """Exact Rayleigh inversion by Cardano. The cube root's argument is
    positive; torch has no cbrt, so it is pow(x, 1/3) in float32, which is
    how XLA lowers the reference's jnp.cbrt."""
    q = 2.0 * (2.0 * u - 1.0)
    z = torch.pow(q + torch.sqrt(q * q + 1.0), 1.0 / 3.0)
    return torch.clamp(z - 1.0 / z, -1.0, 1.0)


def phase_sample(ptype, g, g2, w, d_in: torch.Tensor, u2: torch.Tensor, u1: torch.Tensor):
    """Sample d_out around d_in -> (d_out, pdf). u2: (B, 2) for (cos, phi),
    u1: (B,) for the dual-HG lobe pick; the pdf is the mixture's."""
    u0 = u2[..., 0]
    g_pick = torch.where(u1 < w, g, g2)
    cos_t = 1.0 - 2.0 * u0
    cos_t = torch.where(ptype == T.PHASE_HG, _sample_hg_cos(g, u0), cos_t)
    cos_t = torch.where(ptype == T.PHASE_DUAL_HG, _sample_hg_cos(g_pick, u0), cos_t)
    cos_t = torch.where(ptype == T.PHASE_RAYLEIGH, _sample_rayleigh_cos(u0), cos_t)
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    phi = 2.0 * math.pi * u2[..., 1]
    local = torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi), cos_t], dim=-1)
    d_out = vm.to_world(local, d_in)
    return d_out, phase_eval(ptype, g, g2, w, d_in, d_out)
