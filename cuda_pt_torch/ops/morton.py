"""Morton (Z-order) codes for ray-coherence sorting (port of
cuda_pt_tpu/ops/morton.py).

The wavefront path tracer's sort key appends a Morton code of the hit
point (scene-normalized) to the material key, so that neighbouring lanes
walk the same part of the tree. Codes are int64 tensors holding the
reference's uint32 values.
"""

from __future__ import annotations

import torch


def _expand_bits(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of v so there are 2 zero bits between each."""
    v = v & 0x3FF
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def morton3d(p: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """30-bit Morton code of points p (B, 3) within bounds [lo, hi]."""
    q = (p - lo) / torch.clamp(hi - lo, min=1e-8)
    q = torch.clamp(q, 0.0, 1.0 - 1e-7)
    xi = (q * 1024.0).to(torch.int64)
    return (_expand_bits(xi[..., 0]) << 2) | (_expand_bits(xi[..., 1]) << 1) \
        | _expand_bits(xi[..., 2])


def direction_octant(d: torch.Tensor) -> torch.Tensor:
    """3-bit sign octant of directions (B, 3), int64."""
    return ((d[..., 0] >= 0).to(torch.int64) * 4 + (d[..., 1] >= 0).to(torch.int64) * 2
            + (d[..., 2] >= 0).to(torch.int64))
