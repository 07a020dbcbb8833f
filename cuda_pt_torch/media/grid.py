"""Grid (heterogeneous) medium: delta-tracking free flight, ratio-tracking
transmittance, blackbody emission (port of cuda_pt_tpu/media/grid.py,
forward mode).

Grids are dense (G, D, H, W) tensors with trilinear lookups. The tracking
loops run a fixed MAX_TRACK_STEPS steps with masked termination, each step
one ``next2d`` draw on every lane (the reference's draw order), so a lane's
result does not depend on how the batch is grouped.
"""

from __future__ import annotations

import torch

from ..core import rng as prng
from ..scene import types as T

MAX_TRACK_STEPS = 64


def density_lookup(grids: T.GridMediumData, gid: torch.Tensor, p: torch.Tensor,
                   field: str = "density") -> torch.Tensor:
    """Trilinear value of ``field`` at world positions p (B, 3) in grids gid
    (B,); zero outside the grid's box."""
    g = torch.clamp(gid, min=0).long()
    vol = getattr(grids, field)  # (G, D, H, W)
    bmin = grids.bbox_min[g]
    bmax = grids.bbox_max[g]
    ext = torch.clamp(bmax - bmin, min=1e-8)
    q = (p - bmin) / ext  # normalized [0, 1] -> voxel coords (x -> W, y -> H, z -> D)
    D, H, W = vol.shape[1], vol.shape[2], vol.shape[3]
    fx = q[:, 0] * (W - 1)
    fy = q[:, 1] * (H - 1)
    fz = q[:, 2] * (D - 1)
    inside = ((q[:, 0] >= 0.0) & (q[:, 0] <= 1.0) & (q[:, 1] >= 0.0) & (q[:, 1] <= 1.0)
              & (q[:, 2] >= 0.0) & (q[:, 2] <= 1.0))
    x0 = torch.clamp(torch.floor(fx).to(torch.int32), 0, W - 1).long()
    y0 = torch.clamp(torch.floor(fy).to(torch.int32), 0, H - 1).long()
    z0 = torch.clamp(torch.floor(fz).to(torch.int32), 0, D - 1).long()
    x1 = torch.clamp(x0 + 1, max=W - 1)
    y1 = torch.clamp(y0 + 1, max=H - 1)
    z1 = torch.clamp(z0 + 1, max=D - 1)
    tx = torch.clamp(fx - x0, 0.0, 1.0)
    ty = torch.clamp(fy - y0, 0.0, 1.0)
    tz = torch.clamp(fz - z0, 0.0, 1.0)

    def at(z, y, x):
        return vol[g, z, y, x]

    c00 = at(z0, y0, x0) * (1 - tx) + at(z0, y0, x1) * tx
    c01 = at(z0, y1, x0) * (1 - tx) + at(z0, y1, x1) * tx
    c10 = at(z1, y0, x0) * (1 - tx) + at(z1, y0, x1) * tx
    c11 = at(z1, y1, x0) * (1 - tx) + at(z1, y1, x1) * tx
    c0 = c00 * (1 - ty) + c01 * ty
    c1 = c10 * (1 - ty) + c11 * ty
    val = c0 * (1 - tz) + c1 * tz
    return torch.where(inside, val, 0.0)


def blackbody_rgb(temp: torch.Tensor) -> torch.Tensor:
    """Planck spectrum at R/G/B wavelengths (615, 535, 465 nm) for
    temperatures in Kelvin, normalized so 6500 K is about white."""
    wl = torch.tensor([615e-9, 535e-9, 465e-9], dtype=torch.float32, device=temp.device)
    h, c, kb = 6.626e-34, 2.998e8, 1.381e-23
    t = torch.clamp(temp, min=1.0)[:, None]
    x = (h * c) / (wl * kb * t)
    rad = 1.0 / (wl ** 5 * torch.expm1(torch.clamp(x, 1e-4, 80.0)))
    x_ref = (h * c) / (wl * kb * 6500.0)
    ref = 1.0 / (wl ** 5 * torch.expm1(x_ref))
    return rad / ref


def _grid_params(scene: T.Scene, mid: torch.Tensor):
    m = torch.clamp(mid, min=0).long()
    gid = torch.clamp(scene.media.grid_id[m], min=0)
    scale = scene.media.scale[m]
    maj = torch.clamp(scene.grids.majorant[gid.long()] * scale, min=1e-6)
    albedo = scene.media.sigma_s[m]  # a grid medium keeps its albedo in sigma_s
    return gid, scale, maj, albedo


def sample_distance_grid(scene: T.Scene, mid, o, d, t_surf, rng, active):
    """Delta-tracking free flight through the grid medium mid -> (dict(t,
    is_medium, weight (B, 3)), rng)."""
    gid, scale, maj, albedo = _grid_params(scene, mid)
    return sample_distance_arrays(scene.grids, gid, scale, maj, albedo, o, d, t_surf, rng,
                                  active)


def sample_distance_arrays(grids: T.GridMediumData, gid, scale, maj, albedo, o, d, t_surf, rng,
                           active):
    """sample_distance_grid on raw per-lane arrays (grid id, density scale,
    majorant, albedo): also the split driver's flight pre-pass
    (ops/megakernel.grid_flight)."""
    B = o.shape[0]
    inv_maj = 1.0 / maj
    t = torch.zeros(B, device=o.device)
    done = ~active
    is_med = torch.zeros(B, dtype=torch.bool, device=o.device)
    w = torch.ones(B, device=o.device)
    for _ in range(MAX_TRACK_STEPS):
        u, rng = prng.next2d(rng)
        step = -torch.log(torch.clamp(1.0 - u[..., 0], min=1e-12)) * inv_maj
        t_new = t + step
        pass_srf = t_new >= t_surf
        p = o + t_new[:, None] * d
        dens = density_lookup(grids, gid, p) * scale
        ratio = torch.clamp(dens * inv_maj, 0.0, 1.0)
        real = u[..., 1] < ratio
        w_real = ratio / torch.clamp(ratio, min=1e-8)
        w_null = (1.0 - ratio) / torch.clamp(1.0 - ratio, min=1e-8)
        upd = ~done
        w = torch.where(upd & ~pass_srf, w * torch.where(real, w_real, w_null), w)
        t = torch.where(upd, torch.where(pass_srf, t_surf, t_new), t)
        is_med = is_med | (upd & ~pass_srf & real)
        done = done | (upd & pass_srf) | (upd & ~pass_srf & real)
    t = torch.where(done, t, t_surf)  # lanes that never ended reach the surface
    weight = w[:, None] * torch.where(is_med[:, None], albedo, 1.0)
    return {"t": t, "is_medium": is_med & active, "weight": weight}, rng


def transmittance_grid(scene: T.Scene, mid, o, d, dist, rng, active):
    """Ratio tracking with Russian roulette on low transmittance -> (Tr (B,)
    in [0, 1], rng)."""
    B = o.shape[0]
    gid, scale, maj, _ = _grid_params(scene, mid)
    inv_maj = 1.0 / maj
    t = torch.zeros(B, device=o.device)
    tr = torch.ones(B, device=o.device)
    done = ~active
    for _ in range(MAX_TRACK_STEPS):
        u, rng = prng.next2d(rng)
        step = -torch.log(torch.clamp(1.0 - u[..., 0], min=1e-12)) * inv_maj
        t_new = t + step
        out = t_new >= dist
        p = o + t_new[:, None] * d
        dens = density_lookup(scene.grids, gid, p) * scale
        ratio = torch.clamp(dens * inv_maj, 0.0, 1.0)
        upd = ~done & ~out
        tr = torch.where(upd, tr * (1.0 - ratio), tr)
        low = upd & (tr < 1e-3)
        rr_kill = low & (u[..., 1] > 0.5)
        tr = torch.where(rr_kill, 0.0, torch.where(low, tr * 2.0, tr))
        done = done | out | rr_kill | (tr <= 0.0)
        t = torch.where(upd, t_new, t)
    return torch.clamp(tr, 0.0, 1.0), rng


def transmittance_grid_residual(scene: T.Scene, mid, o, d, dist, rng, active):
    """Residual ratio tracking with the average density as control variate
    -> (Tr (B,), rng)."""
    gid, scale, maj, _ = _grid_params(scene, mid)
    return transmittance_residual_arrays(scene.grids, gid, scale, maj, o, d, dist, rng, active)


def transmittance_residual_arrays(grids: T.GridMediumData, gid, scale, maj, o, d, dist, rng,
                                  active):
    """transmittance_grid_residual on raw per-lane arrays: also the split
    driver's NEE pass (ops/megakernel.grid_nee_resolve).
    Tr = exp(-sigma_c dist) E[prod (1 - (sigma(x_i) - sigma_c) / sigma_r)],
    sigma_c = scale * avg_density, sigma_r = max(sigma_c, maj - sigma_c)."""
    B = o.shape[0]
    sigma_c = grids.avg_density[torch.clamp(gid, min=0).long()] * scale
    sigma_r = torch.clamp(torch.maximum(sigma_c, maj - sigma_c), min=1e-6)
    inv_maj = 1.0 / sigma_r
    t = torch.zeros(B, device=o.device)
    tr = torch.ones(B, device=o.device)
    done = ~active
    for _ in range(MAX_TRACK_STEPS):
        u, rng = prng.next2d(rng)
        step = -torch.log(torch.clamp(1.0 - u[..., 0], min=1e-12)) * inv_maj
        t_new = t + step
        out = t_new >= dist
        p = o + t_new[:, None] * d
        dens = density_lookup(grids, gid, p) * scale
        upd = ~done & ~out
        # signed residual factor: above 1 where sigma < sigma_c, unbiased
        tr = torch.where(upd, tr * (1.0 - (dens - sigma_c) * inv_maj), tr)
        trd = torch.abs(tr)
        rr = upd & (trd < 0.1)
        kill = rr & (u[..., 1] >= trd)
        tr = torch.where(kill, 0.0, torch.where(rr, tr / torch.clamp(trd, min=1e-12), tr))
        done = done | out | kill
        t = torch.where(upd, t_new, t)
    ctrl = torch.exp(-sigma_c * torch.clamp(dist, min=0.0))
    return tr * ctrl, rng


def query_emission(scene: T.Scene, mid: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Blackbody emission (B, 3) at medium points p: the emission grid holds
    a normalized temperature, mapped to 800-3800 K."""
    m = torch.clamp(mid, min=0).long()
    gid = torch.clamp(scene.media.grid_id[m], min=0)
    emis_scale = scene.media.emission_scale[m]
    temp = density_lookup(scene.grids, gid, p, field="emission")
    rgb = blackbody_rgb(temp * 3000.0 + 800.0)
    return rgb * (emis_scale * torch.clamp(temp, min=0.0))[:, None]
