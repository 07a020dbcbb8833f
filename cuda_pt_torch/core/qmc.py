"""Owen-scrambled Sobol (0,2)-sequence sampler and the sampler-state entry
(port of cuda_pt_tpu/core/qmc.py), bit-exact on u32.

Every consecutive pair of path dimensions draws from the same base-2 Sobol
(0,2) sequence: dimension A is van der Corput (bit reversal), dimension B
the second Sobol dimension (direction numbers v ^= v >> 1), with a
per-(pixel, pair) index shuffle (a Laine-Karras hash on reversed bits) and
a per-(pixel, pair, component) Owen scramble of the value (Burley,
"Practical Hash-based Owen Scrambling", JCGT 2020). A pixel's samples
0..2^m-1 of any pair are stratified on every 2^a x 2^b grid with a+b=m.

State is (..., 4) u32 held in int64: [sample_index, dim, key_hi, key_lo].
core.rng.next1d / next2d / discrete1d dispatch on the trailing size (2 =
pcg2d stream, 4 = this sampler), so every draw site takes either sampler.
Each lane carries its own dim counter; at and past MAX_DIMS a draw is the
hash of (index, dim, key): uniform, not stratified.

The u32 arithmetic runs in int64 masked with 0xFFFFFFFF (core/rng.py);
constants at or above 2^31 multiply through rng.mul32. The second Sobol
dimension is four 256-entry byte tables (one gather per byte, three XORs)
in place of the reference's 32-term XOR fold: the same bits in a tenth of
the elementwise launches.
"""

from __future__ import annotations

import torch

from . import rng as prng

_M = prng.MASK32

# Stratified dimensions per path before falling back to hash draws.
MAX_DIMS = 64

SAMPLERS = ("pcg", "sobol")

# Direction numbers of the second Sobol dimension: v_0 = 1 << 31,
# v_{k+1} = v_k ^ (v_k >> 1).
_V2 = []
_v = 1 << 31
for _k in range(32):
    _V2.append(_v)
    _v ^= _v >> 1
del _v, _k

# _SOBOL2_BYTES[j][b]: the XOR of the direction numbers of the set bits of
# byte value b placed at byte j of the index.
_SOBOL2_BYTES = []
for _j in range(4):
    _row = []
    for _b in range(256):
        _x = 0
        for _k in range(8):
            if _b >> _k & 1:
                _x ^= _V2[8 * _j + _k]
        _row.append(_x)
    _SOBOL2_BYTES.append(_row)
del _j, _row, _b, _x, _k

_TABLES = {}  # device -> (4, 256) int64 byte tables


def _byte_tables(device) -> torch.Tensor:
    key = torch.device(device)
    if key not in _TABLES:
        _TABLES[key] = torch.tensor(_SOBOL2_BYTES, dtype=torch.int64, device=key)
    return _TABLES[key]


def check_sampler(sampler: str) -> None:
    """Raise for a sampler name other than "pcg" and "sobol" (the
    reference asserts)."""
    if sampler not in SAMPLERS:
        raise NotImplementedError(f"sampler {sampler!r}: the samplers are 'pcg' and 'sobol'")


def _reverse_bits(x: torch.Tensor) -> torch.Tensor:
    # each masked half moves inside 32 bits; only the last swap needs a mask
    x = ((x & 0x55555555) << 1) | ((x >> 1) & 0x55555555)
    x = ((x & 0x33333333) << 2) | ((x >> 2) & 0x33333333)
    x = ((x & 0x0F0F0F0F) << 4) | ((x >> 4) & 0x0F0F0F0F)
    x = ((x & 0x00FF00FF) << 8) | ((x >> 8) & 0x00FF00FF)
    return ((x << 16) & _M) | (x >> 16)


def _lk_hash(x: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """Laine-Karras-style hash: output bit k depends only on input bits
    <= k (Burley's constants)."""
    x = (x + seed) & _M
    x = x ^ ((x * 0x6C50B47C) & _M)
    x = x ^ prng.mul32(x, 0xB82F1E52)
    x = x ^ prng.mul32(x, 0xC7AFE638)
    return x ^ prng.mul32(x, 0x8D22F6E6)


def _owen_scramble(x: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """Owen scramble of a [0,1)-as-u32 value: bit k of the output depends
    only on the bits above k, so every elementary interval is kept."""
    return _reverse_bits(_lk_hash(_reverse_bits(x), seed))


def _sobol2(idx: torch.Tensor) -> torch.Tensor:
    """Second Sobol dimension at index idx: the XOR of the direction
    numbers of idx's set bits, a byte at a time."""
    t = _byte_tables(idx.device)
    return (t[0][idx & 0xFF] ^ t[1][(idx >> 8) & 0xFF]
            ^ t[2][(idx >> 16) & 0xFF] ^ t[3][idx >> 24])


def _mix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One-round integer mix for key derivation (finalizer-style)."""
    h = a ^ prng.mul32(b, 0x9E3779B9)
    h = h ^ (h >> 16)
    h = prng.mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = prng.mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def seed(base_seed, lane_idx: torch.Tensor, sample_idx) -> torch.Tensor:
    """Sampler state for (scene seed, pixel lane, sample index). The sample
    index is kept apart from the seed: folding it in would give every
    sample an unrelated scramble. sample_idx: an int or a per-lane tensor."""
    dev = lane_idx.device
    s = prng.as_u32(base_seed, dev)
    lane = prng.as_u32(lane_idx)
    idx = prng.as_u32(sample_idx, dev).expand(lane.shape)
    key_hi = _mix(lane, s)
    key_lo = _mix(lane ^ 0xDEADBEEF, (s + 0x632BE59B) & _M)
    return torch.stack([idx, torch.zeros_like(lane), key_hi, key_lo], dim=-1)


def _shuffled(idx, pair, key_hi):
    """The pair's shuffled sample index (Laine-Karras on reversed bits)."""
    return _reverse_bits(_lk_hash(_reverse_bits(idx), _mix(key_hi, pair)))


def _finish(rev_base, idx, dim, key_hi, key_lo):
    """Owen-scramble a component whose reversed base value is rev_base;
    at and past MAX_DIMS the hash draw. (pair << 1) | comp is dim."""
    scrambled = _reverse_bits(_lk_hash(rev_base, _mix(key_lo, dim)))
    fallback = _mix(_mix(key_hi ^ key_lo, dim), idx)
    return torch.where(dim < MAX_DIMS, scrambled, fallback)


def _component(idx, dim, key_hi, key_lo):
    """One scrambled Sobol component: pair = dim >> 1, component = dim & 1.
    Component 0's base is reverse(shuffled), so its reversed base is the
    shuffled index itself."""
    sh = _shuffled(idx, dim >> 1, key_hi)
    rev_base = torch.where((dim & 1) == 0, sh, _reverse_bits(_sobol2(sh)))
    return _finish(rev_base, idx, dim, key_hi, key_lo)


def next2d(state: torch.Tensor):
    """Two uniforms of one dimension pair: ((..., 2) float32, new_state).
    The draw first aligns dim up to a pair boundary (a draw straddling two
    pairs would get two unrelated components), so component 0 and 1 share
    the pair's shuffled index."""
    idx, dim, key_hi, key_lo = state.unbind(-1)
    dim = (dim + 1) & 0xFFFFFFFE
    sh = _shuffled(idx, dim >> 1, key_hi)
    a = _finish(sh, idx, dim, key_hi, key_lo)
    b = _finish(_reverse_bits(_sobol2(sh)), idx, dim + 1, key_hi, key_lo)
    new_state = torch.stack([idx, (dim + 2) & _M, key_hi, key_lo], dim=-1)
    return prng.u01(torch.stack([a, b], dim=-1)), new_state


def next1d(state: torch.Tensor):
    """One uniform: ((...,) float32, new_state)."""
    idx, dim, key_hi, key_lo = state.unbind(-1)
    a = _component(idx, dim, key_hi, key_lo)
    new_state = torch.stack([idx, (dim + 1) & _M, key_hi, key_lo], dim=-1)
    return prng.u01(a), new_state


def discrete1d(state: torch.Tensor, n):
    """An integer in [0, n): (int32, new_state)."""
    u, new_state = next1d(state)
    return prng.to_index(u, n), new_state


def make_state(sampler: str, base_seed, lane_idx: torch.Tensor, sample_idx) -> torch.Tensor:
    """Renderer entry: "sobol" -> seed(); "pcg" -> the stream state with the
    sample index folded into the seed as base_seed + sample_idx * 9781
    (mod 2^32). sample_idx: an int or a per-lane tensor."""
    check_sampler(sampler)
    if sampler == "sobol":
        return seed(base_seed, lane_idx, sample_idx)
    dev = lane_idx.device
    s = (prng.as_u32(base_seed, dev) + prng.mul32(prng.as_u32(sample_idx, dev), 9781)) & _M
    return prng.seed(s, lane_idx)
