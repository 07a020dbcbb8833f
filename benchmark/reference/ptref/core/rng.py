"""pcg2d stream RNG (port of cuda_pt_tpu/core/rng.py), bit-exact on u32.

State is a (..., 2) int64 tensor holding u32 values in [0, 2^32): torch
has no add or shift on uint32 tensors, so the u32 arithmetic runs in int64
masked with 0xFFFFFFFF. Multiplications by constants below 2^31 cannot
overflow int64; wider constants go through ``mul32``, which multiplies by
the constant less 2^32 (the same low 32 bits, and no overflow). The u32 ->
f32 convert rounds to nearest even like JAX's astype, and the scale by
2^-32 is exact.

The streams are counter-based (seeded from (seed, lane, sample)), so no
torch.Generator is involved on the render path.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
_C1 = 1664525
_C2 = 1013904223
# 1/2^32 — maps u32 to [0, 1)
INV_U32 = 2.3283064365386963e-10


def as_u32(x, device=None) -> torch.Tensor:
    """Python int or integer tensor -> int64 tensor of its low 32 bits."""
    if not torch.is_tensor(x):
        return torch.tensor(int(x) & MASK32, dtype=torch.int64, device=device)
    return x.to(torch.int64) & MASK32


def mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for x in [0, 2^32) and a constant c in [0, 2^32).
    A c at or above 2^31 multiplies as c - 2^32: |x * (c - 2^32)| < 2^63,
    and the two products agree mod 2^32."""
    c &= MASK32
    return (x * (c - (1 << 32) if c >> 31 else c)) & MASK32


def pcg2d(v: torch.Tensor) -> torch.Tensor:
    """One pcg2d mixing round on a (..., 2) u32-in-int64 tensor."""
    x = v[..., 0]
    y = v[..., 1]
    x = (x * _C1 + _C2) & MASK32
    y = (y * _C1 + _C2) & MASK32
    x = (x + y * _C1) & MASK32
    y = (y + x * _C2) & MASK32
    x = x ^ (x >> 16)
    y = y ^ (y >> 16)
    x = (x + y * _C1) & MASK32
    y = (y + x * _C2) & MASK32
    x = x ^ (x >> 16)
    y = y ^ (y >> 16)
    return torch.stack([x, y], dim=-1)


def seed(base_seed, lane_idx: torch.Tensor) -> torch.Tensor:
    """Per-lane state from a scalar (or per-lane) seed and lane indices."""
    s = as_u32(base_seed, lane_idx.device)
    idx = as_u32(lane_idx)
    a = idx ^ mul32(s, 0x9E3779B9)
    b = (s + mul32(idx, 0x85EBCA6B)) & MASK32
    v = torch.stack(torch.broadcast_tensors(a, b), dim=-1)
    return pcg2d(pcg2d(v))


def u01(bits: torch.Tensor) -> torch.Tensor:
    """u32 (in int64) -> float32 in [0, 1), rounding like a u32->f32 cast."""
    return bits.to(torch.float32) * INV_U32


def next2d(state: torch.Tensor):
    """Two uniforms in [0,1): ((..., 2) float32, new_state)."""
    new_state = pcg2d(state)
    return u01(new_state), new_state


def next1d(state: torch.Tensor):
    """One uniform in [0,1): ((...,) float32, new_state)."""
    u, new_state = next2d(state)
    return u[..., 0], new_state

