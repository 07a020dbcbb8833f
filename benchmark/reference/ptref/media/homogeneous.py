"""Homogeneous medium: the per-lane sigmas of the kernel's media row
(port of cuda_pt_tpu/media/homogeneous.py's sigma_at).
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

