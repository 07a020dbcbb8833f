"""Render configuration dataclasses (port of cuda_pt_tpu/core/config.py).

Static host-side configs: they select bounce caps and resolution, never
tensors. The fields, their order and their defaults are the reference's.
"""

from __future__ import annotations

import dataclasses
import enum


class RendererType(str, enum.Enum):
    MEGAKERNEL_PT = "pt"
    WAVEFRONT_PT = "wfpt"
    MEGAKERNEL_LT = "lt"
    VOLUME_PT = "vpt"
    DEPTH = "depth"
    BVH_COST = "bvh-cost"


@dataclasses.dataclass(frozen=True)
class MaxDepthParams:
    max_depth: int = 16  # total bounce cap
    max_diffuse: int = 8
    max_specular: int = 8
    max_transmit: int = 12
    max_volume: int = 8
    # Time-of-flight gating window; <= 0 disables it (ToF waits in the port).
    min_time: float = 0.0
    max_time: float = 0.0


@dataclasses.dataclass(frozen=True)
class BVHConfig:
    max_prims_per_leaf: int = 4  # the reference's max_node_num (the XML path caps it at 8)
    # carried from the XML and read by nothing, as in the reference
    cache_level: int = 5
    overlap_w: float = 1.0  # SAH overlap-area penalty weight
    use_sbvh: bool = False  # spatial splits (accel/native.build_sbvh_native)
    use_ref_unsplit: bool = False
    # the SBVH's duplicate-reference budget as a fraction of the prim count;
    # None = 0.5 with reference unsplitting, 1.0 without
    dup_budget_frac: float | None = None


@dataclasses.dataclass(frozen=True)
class RenderingConfig:
    renderer: RendererType = RendererType.MEGAKERNEL_PT
    spp: int = 64
    width: int = 512
    height: int = 512
    md: MaxDepthParams = dataclasses.field(default_factory=MaxDepthParams)
    bvh: BVHConfig = dataclasses.field(default_factory=BVHConfig)
    gamma: bool = True
    # Light-tracer knobs (the reference's config.h:37-41). The Renderer's
    # MEGAKERNEL_LT route reads the last two; ``bidirectional`` is read by
    # no route, as in the reference (light_tracer.render_bidirectional is a
    # module function).
    bidirectional: bool = False
    specular_constraint: int = 0
    caustic_scaling: float = 1.0
    seed: int = 0
