"""Colormap lookup tables of the depth and BVH-cost renderers (port of
cuda_pt_tpu/utils/colormap.py).

The reference samples plasma, jet and viridis from matplotlib at import
and falls back to grey where matplotlib is missing. The port keeps the
three tables as data (colormap_tables.npy, 3 x 256 x 3 float32, written
by tools/make_colormap_tables.py) and imports no matplotlib, so every
machine renders the reference's colours.
"""

from __future__ import annotations

import os

import numpy as np
import torch

_N = 256
# ids match the reference's enum order: 0 plasma, 1 jet, 2 viridis
COLOR_MAPS = torch.from_numpy(
    np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)), "colormap_tables.npy")))
NUM_MAPS = 3


def apply_colormap(x: torch.Tensor, map_id: int) -> torch.Tensor:
    """Map values (...,) in [0, 1] through colormap map_id -> (..., 3)."""
    idx = torch.clamp((x * (_N - 1)).to(torch.int64), 0, _N - 1)
    return COLOR_MAPS.to(x.device)[map_id][idx]
