"""Homogeneous medium: RGB channel-MIS free-flight sampling and analytic
transmittance (port of cuda_pt_tpu/media/homogeneous.py). The sampled
distance and the sigma_t it is drawn from are detached; the weights keep
the attached sigmas.
"""

from __future__ import annotations

import torch

from ..scene import types as T


def sigma_at(media: T.MediumTable, mid: torch.Tensor):
    """(sigma_a, sigma_s, sigma_t) of medium ids mid (clamped >= 0), (B, 3) each."""
    m = torch.clamp(mid, min=0).long()
    scale = media.scale[m][:, None]
    sa = media.sigma_a[m] * scale
    ss = media.sigma_s[m] * scale
    return sa, ss, sa + ss


def sample_distance(media: T.MediumTable, mid: torch.Tensor, t_surf: torch.Tensor,
                    u: torch.Tensor) -> dict:
    """Free flight against the surface at t_surf: a channel picked uniformly
    by u[:, 0], a distance by u[:, 1] (the draw order of the reference).
    Returns dict(t, is_medium, weight (B, 3)) with the channel-MIS weights
      medium event:  sigma_s exp(-sigma_t t) / mean_c(sigma_t,c exp(-sigma_t,c t))
      surface event: exp(-sigma_t t_surf) / mean_c(exp(-sigma_t,c t_surf))."""
    _, ss, st = sigma_at(media, mid)
    st_d = st.detach()
    c = torch.clamp((u[..., 0] * 3.0).to(torch.int64), max=2)
    st_c = torch.clamp(torch.gather(st_d, 1, c[:, None])[:, 0], min=1e-8)
    t = (-torch.log(torch.clamp(1.0 - u[..., 1], min=1e-12)) / st_c).detach()
    is_med = t < t_surf

    tr_med = torch.exp(-st * t[:, None])
    pdf_med = torch.mean(st_d * torch.exp(-st_d * t[:, None]), dim=-1)
    w_med = ss * tr_med / torch.clamp(pdf_med, min=1e-12)[:, None]

    tr_srf = torch.exp(-st * t_surf[:, None])
    pdf_srf = torch.mean(torch.exp(-st_d * t_surf[:, None]), dim=-1)
    w_srf = tr_srf / torch.clamp(pdf_srf, min=1e-12)[:, None]
    return {"t": torch.where(is_med, t, t_surf), "is_medium": is_med,
            "weight": torch.where(is_med[:, None], w_med, w_srf)}


def transmittance(media: T.MediumTable, mid: torch.Tensor, dist: torch.Tensor) -> torch.Tensor:
    """Analytic transmittance over dist (B,) -> (B, 3)."""
    _, _, st = sigma_at(media, mid)
    return torch.exp(-st * torch.clamp(dist, min=0.0)[:, None])
