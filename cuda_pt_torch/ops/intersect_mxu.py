"""Matmul-form brute-force intersection (port of
cuda_pt_tpu/ops/intersect_mxu.py): traversal="mxu".

Every Moller-Trumbore numerator is a triple product, linear in per-ray
features once the per-prim part is factored out:

    a     = e1 . (d x e2)            =  d . (e2 x e1)
    u . a = (o - p0) . (d x e2)      =  w . e2  -  d . (e2 x p0)
    v . a = d . ((o - p0) x e1)      = -w . e1  -  d . (p0 x e1)
    t . a = e2 . ((o - p0) x e1)     =  o . n   -  p0 . n,   n = e1 x e2

with w = o x d. The ray features F = [o, d, w, 1, o.d, |o|^2] (B, 12) and
per-prim coefficients G (12, 4) turn every ray x prim test into one
(B, 12) @ (12, 4P) product. Analytic spheres (centre p0, radius e1.x) ride
the same product in the slots [b_half, 0, 0, cc]:

    b_half = (o . d) - d . c,   cc = |o|^2 - o . 2c + (|c|^2 - r^2)

The product is torch.matmul, not a hand-written kernel: the reference
computes it in XLA outside any Pallas kernel. It asks for
Precision.HIGHEST, so the product is full f32 whatever the process's
matmul settings are: _full_f32 turns TF32 off around the call (torch's
allow_tf32, or fp32_precision "ieee" where the process uses that switch)
and restores the setting after it. The setting is process-wide; a thread
that runs its own matmuls while a walk is in flight sees it too.

Prims go in chunks of ``chunk`` (the reference's scan): each ray keeps the
first minimum of a chunk and replaces its best hit only on a strictly
smaller t, so the result does not depend on the chunk. The lanes go in
bands so that one band's (lanes, chunk) f32 intermediates stay within
BAND_BYTES; the result does not depend on the band either.

Differentiable: G is built from the geometry inside the call, so vertex
gradients flow through autograd (the sphere's square root takes the
reference's safe substitution under its mask).
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

from ..core import math as vm
from ..scene.types import Geometry

HIT_EPS = 1e-4
_DET_EPS = 1e-12
DEFAULT_CHUNK = 1024
# bytes of one band's (lanes, chunk) f32 intermediates: _LIVE_PLANES planes
# alive at once in _chunk_tests (the product's four, the decode's)
BAND_BYTES = 1 << 30
_LIVE_PLANES = 16


@contextlib.contextmanager
def _full_f32():
    """f32 matmuls without TF32 inside the block (module docstring). torch
    refuses to mix its two switches in one process, so the block flips the
    one the process uses: the legacy allow_tf32 (which
    set_float32_matmul_precision sets too), else the newer fp32_precision."""
    m = torch.backends.cuda.matmul
    try:
        old, key, off = m.allow_tf32, "allow_tf32", False
    except RuntimeError:  # the process set fp32_precision
        old, key, off = m.fp32_precision, "fp32_precision", "ieee"
    setattr(m, key, off)
    try:
        yield
    finally:
        setattr(m, key, old)


def _ray_features(o: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """(B, 12): [o, d, o x d, 1, o.d, |o|^2]."""
    w = vm.cross(o, d)
    one = torch.ones_like(o[..., :1])
    od = torch.sum(o * d, dim=-1, keepdim=True)
    oo = torch.sum(o * o, dim=-1, keepdim=True)
    return torch.cat([o, d, w, one, od, oo], dim=-1)


def prim_matrix(geom: Geometry) -> tuple:
    """Per-prim coefficients G (P, 12, 4) and the sphere mask (P,).

    Feature rows: o 0:3, d 3:6, w 6:9, const 9, o.d 10, |o|^2 11. Output
    columns: a triangle's [a, u*a, v*a, t*a], a sphere's [b_half, 0, 0, cc]."""
    p0, e1, e2 = geom.p0, geom.e1, geom.e2
    z3 = torch.zeros_like(p0)
    z1 = z3[:, :1]
    n = vm.cross(e1, e2)
    tri = [torch.cat([z3, vm.cross(e2, e1), z3, z1, z1, z1], dim=-1),
           torch.cat([z3, -vm.cross(e2, p0), e2, z1, z1, z1], dim=-1),
           torch.cat([z3, -vm.cross(p0, e1), -e1, z1, z1, z1], dim=-1),
           torch.cat([n, z3, z3, -torch.sum(p0 * n, dim=-1, keepdim=True), z1, z1], dim=-1)]
    c, r = p0, e1[:, :1]
    zero12 = torch.zeros_like(tri[0])
    sph_cols = [torch.cat([z3, -c, z3, z1, torch.ones_like(z1), z1], dim=-1), zero12, zero12,
                torch.cat([-2.0 * c, z3, z3, torch.sum(c * c, dim=-1, keepdim=True) - r * r, z1,
                           torch.ones_like(z1)], dim=-1)]
    sph = geom.is_sphere
    G = torch.where(sph[:, None, None], torch.stack(sph_cols, dim=-1), torch.stack(tri, dim=-1))
    return G, sph


def _chunk_tests(F, Gc, sph_c, t_clip):
    """One chunk: (B, 12) @ (12, 4K) -> per pair (t, ok, u, v), (B, K) each."""
    K = Gc.shape[0]
    with _full_f32():
        out = torch.matmul(F, Gc.permute(1, 2, 0).reshape(12, 4 * K)).reshape(F.shape[0], 4, K)
    o0, o1, o2, o3 = out[:, 0], out[:, 1], out[:, 2], out[:, 3]

    # triangle decode
    a = o0
    f = 1.0 / torch.where(torch.abs(a) < _DET_EPS, _DET_EPS, a)
    u = o1 * f
    v = o2 * f
    t_tri = o3 * f
    tri_ok = ((torch.abs(a) > _DET_EPS) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
              & (t_tri > HIT_EPS))

    # sphere decode; the square root's gradient at a clamp would be inf (and
    # inf * 0 = NaN through the selects), so 1.0 stands in under the mask
    bh, cc = o0, o3
    disc = bh * bh - cc
    disc_pos = disc > 0.0
    sq = torch.where(disc_pos, torch.sqrt(torch.where(disc_pos, disc, 1.0)), 0.0)
    t0 = -bh - sq
    t1 = -bh + sq
    t_sph = torch.where(t0 > HIT_EPS, t0, t1)
    sph_ok = disc_pos & (t_sph > HIT_EPS)

    sph_b = sph_c[None, :]
    t = torch.where(sph_b, t_sph, t_tri)
    ok = ((sph_b & sph_ok) | (~sph_b & tri_ok)) & (t < t_clip)
    b1 = torch.where(sph_b, 0.0, u)
    b2 = torch.where(sph_b, 0.0, v)
    return t, ok, b1, b2


def _centroid(geom: Geometry) -> torch.Tensor:
    """The centre of the prims' p0 box, detached: rays and prims re-centred
    on it keep the features O(scene size), where the expanded quadratic and
    w = o x d would cancel in f32 far from the origin. The test is
    translation-invariant, so the detach drops a zero gradient only."""
    lo = torch.amin(geom.p0, dim=0)
    hi = torch.amax(geom.p0, dim=0)
    return (0.5 * (lo + hi)).detach()


def _padded(geom: Geometry, chunk: int):
    """G and the sphere mask padded to a chunk multiple, as (C, chunk, ...);
    padding prims have G = 0, so a = 0 and the det test rejects them.
    Returns (G, sph, chunk, padded prim count)."""
    G, sph = prim_matrix(geom)
    P = G.shape[0]
    chunk = min(chunk, max(P, 1))
    Pp = -(-P // chunk) * chunk
    G = torch.cat([G, G.new_zeros((Pp - P, 12, 4))])
    sph = torch.cat([sph, sph.new_zeros(Pp - P)])
    return G.reshape(Pp // chunk, chunk, 12, 4), sph.reshape(Pp // chunk, chunk), chunk, Pp


def band_lanes(chunk: int) -> int:
    """Lanes per band: _LIVE_PLANES (lanes, chunk) f32 planes in BAND_BYTES."""
    return max(1, BAND_BYTES // (_LIVE_PLANES * 4 * max(chunk, 1)))


def _prepared(geom: Geometry, o: torch.Tensor, d: torch.Tensor, chunk: int):
    c0 = _centroid(geom)
    Gc, sphc, chunk, _ = _padded(dataclasses.replace(geom, p0=geom.p0 - c0), chunk)
    return Gc, sphc, chunk, _ray_features(o - c0, d)


def _closest_band(Gc, sphc, chunk: int, F, t_clip):
    B = F.shape[0]
    t_best = torch.full((B,), float("inf"), device=F.device)
    prim = torch.full((B,), -1, dtype=torch.int32, device=F.device)
    b1 = torch.zeros(B, device=F.device)
    b2 = torch.zeros(B, device=F.device)
    for c in range(Gc.shape[0]):
        t, ok, u, v = _chunk_tests(F, Gc[c], sphc[c], t_clip)
        t = torch.where(ok, t, float("inf"))
        k = torch.argmin(t, dim=-1, keepdim=True)  # the first minimum, as jnp.argmin
        t_k = t.gather(1, k)[:, 0]
        better = ok.gather(1, k)[:, 0] & (t_k < t_best)
        t_best = torch.where(better, t_k, t_best)
        prim = torch.where(better, c * chunk + k[:, 0].to(torch.int32), prim)
        b1 = torch.where(better, u.gather(1, k)[:, 0], b1)
        b2 = torch.where(better, v.gather(1, k)[:, 0], b2)
    return t_best, prim, b1, b2


def closest_hit_mxu(geom: Geometry, o: torch.Tensor, d: torch.Tensor, t_max=None,
                    chunk: int = DEFAULT_CHUNK) -> dict:
    """Closest hit over every primitive by the matmul form: dict(t, prim,
    hit, b1, b2), the contract of intersect.closest_hit_brute."""
    Gc, sphc, chunk, F = _prepared(geom, o, d, chunk)
    band = band_lanes(chunk)
    parts = []
    for s in range(0, max(o.shape[0], 1), band):
        clip = float("inf") if t_max is None else t_max[s:s + band, None]
        parts.append(_closest_band(Gc, sphc, chunk, F[s:s + band], clip))
    t, prim, b1, b2 = (torch.cat(x) for x in zip(*parts))
    return {"t": t, "prim": prim, "hit": prim >= 0, "b1": b1, "b2": b2}


def occlusion_mxu(geom: Geometry, o: torch.Tensor, d: torch.Tensor, t_far: torch.Tensor,
                  chunk: int = DEFAULT_CHUNK) -> torch.Tensor:
    """Any hit up to t_far (shadow rays); True = occluded."""
    Gc, sphc, chunk, F = _prepared(geom, o, d, chunk)
    band = band_lanes(chunk)
    t_clip = t_far[:, None] * (1.0 - 1e-3)
    parts = []
    for s in range(0, max(o.shape[0], 1), band):
        occ = torch.zeros(F[s:s + band].shape[0], dtype=torch.bool, device=o.device)
        for c in range(Gc.shape[0]):
            occ = occ | _chunk_tests(F[s:s + band], Gc[c], sphc[c], t_clip[s:s + band])[1].any(-1)
        parts.append(occ)
    return torch.cat(parts)
