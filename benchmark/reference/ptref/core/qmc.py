"""The sampler-state entry of the benchmark's configurations, which use
the pcg stream alone (port of cuda_pt_tpu/core/qmc.py's make_state; the
program's Owen-scrambled Sobol sampler is cut).

The u32 arithmetic runs in int64 masked with 0xFFFFFFFF (core/rng.py).
"""

from __future__ import annotations

import torch

from . import rng as prng


def make_state(sampler: str, base_seed, lane_idx: torch.Tensor, sample_idx) -> torch.Tensor:
    """The pcg stream state with the sample index folded into the seed as
    base_seed + sample_idx * 9781 (mod 2^32). sample_idx: an int or a
    per-lane tensor."""
    if sampler != "pcg":
        raise NotImplementedError(f"sampler {sampler!r}: the reference draws from pcg alone")
    dev = lane_idx.device
    s = (prng.as_u32(base_seed, dev) + prng.mul32(prng.as_u32(sample_idx, dev), 9781)) & prng.MASK32
    return prng.seed(s, lane_idx)
