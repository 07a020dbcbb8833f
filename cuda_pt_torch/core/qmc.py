"""Sampler-state entry (port of cuda_pt_tpu/core/qmc.py:make_state).

Only the pcg stream sampler is ported; the Owen-scrambled Sobol sampler
waits for its ROADMAP item.
"""

from __future__ import annotations

import torch

from . import rng as prng


def check_sampler(sampler: str) -> None:
    """Raise for a sampler the port does not draw from (all but "pcg")."""
    if sampler != "pcg":
        raise NotImplementedError(
            f"sampler {sampler!r}: only 'pcg' is ported (Sobol waits, ROADMAP Queue 1 item 1)")


def make_state(sampler: str, base_seed, lane_idx: torch.Tensor, sample_idx) -> torch.Tensor:
    """pcg state for (scene seed, lane, sample index): the sample index is
    folded into the seed as base_seed + sample_idx * 9781 (mod 2^32)."""
    check_sampler(sampler)
    dev = lane_idx.device
    s = (prng.as_u32(base_seed, dev) + prng.mul32(prng.as_u32(sample_idx, dev), 9781)) & prng.MASK32
    return prng.seed(s, lane_idx)
