"""The bounce caps of a render (port of cuda_pt_tpu/core/config.py's
MaxDepthParams; the program's other configuration dataclasses are cut).
The fields, their order and their defaults are the reference's.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MaxDepthParams:
    max_depth: int = 16  # total bounce cap
    max_diffuse: int = 8
    max_specular: int = 8
    max_transmit: int = 12
    max_volume: int = 8
    # Time-of-flight gating window; <= 0 disables it (the segment form takes none)
    min_time: float = 0.0
    max_time: float = 0.0
