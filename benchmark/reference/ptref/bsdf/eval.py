"""BSDF evaluation / sampling over the dense material table (port of
cuda_pt_tpu/bsdf/eval.py): every family is evaluated over the whole ray
batch and the per-ray result selected by the material's type id.

Families (type ids in scene.types): Lambertian, Specular mirror,
Translucent (smooth dielectric), Plastic, Plastic-forward, GGX conductor,
Dispersion (wavelength-locked Cauchy dielectric) and Forward (null): the
families of the benchmark's scenes (the program's rough GGX dielectric
and Oren-Nayar are cut; reference.plain_render refuses a scene with them).
Families absent from the scene's static ``present_bsdfs`` are skipped.

Conventions: wo points away from the surface (= -ray dir); wi is the
continuation direction. ``eval_bsdf`` returns f(wo, wi) * |cos(wi, n)| for
smooth lobes only (delta lobes contribute 0 to NEE/MIS).
"""

from __future__ import annotations

import torch

from ..core import math as vm
from ..core import rng as prng
from ..core import sampling
from ..scene import textures as tex
from ..scene import types as T
from . import fresnel, ggx, spectral

LOBE_DIFFUSE = 0
LOBE_SPECULAR = 1
LOBE_TRANSMIT = 2

_INV_PI = sampling.INV_PI


def make_ctx(scene: T.Scene, bid: torch.Tensor, uv: torch.Tensor, n_s: torch.Tensor,
             textured: bool = True):
    """Gather per-ray material parameters, apply textures and the normal
    map. bid: (B,) material ids (clamped by the caller). textured=False
    keeps the base kd of the diffuse slot (the fused kernel's estimator
    applies that texel separately; see models/path_tracer.py)."""
    b = scene.bsdfs
    bid = bid.long()
    tids = b.tex_ids[bid]
    atlas = scene.textures
    tid_d = tids[:, T.TEX_DIFFUSE] if textured else torch.full_like(tids[:, 0], -1)
    p = b.params[bid]
    rough_tex = tex.sample_texture(atlas, tids[:, T.TEX_ROUGHNESS], uv)
    return {
        "present": tuple(scene.present_bsdfs),
        "btype": b.btype[bid],
        "kd": tex.scaled_rgb(atlas, tid_d, uv, b.k_d[bid]),
        "ks": tex.scaled_rgb(atlas, tids[:, T.TEX_SPECULAR], uv, b.k_s[bid]),
        "kg": tex.scaled_rgb(atlas, tids[:, T.TEX_GLOSSY], uv, b.k_g[bid]),
        "eta": b.eta[bid],
        "k": b.k[bid],
        "ior": p[:, T.P_IOR],
        "ax": torch.clamp(p[:, T.P_ROUGH_X] * rough_tex[:, 0], min=1e-4),
        "ay": torch.clamp(p[:, T.P_ROUGH_Y] * rough_tex[:, 1], min=1e-4),
        "thickness": p[:, T.P_THICKNESS],
        "cauchy_a": p[:, T.P_CAUCHY_A],
        "cauchy_b": p[:, T.P_CAUCHY_B],
        "n": tex.eval_normal_map(atlas, tids[:, T.TEX_NORMAL], uv, n_s),
    }


def to_local(world: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """A world direction in the z-up frame of unit normal n."""
    t, b = vm.onb(n)
    return torch.stack([vm.dot(world, t), vm.dot(world, b), vm.dot(world, n)], dim=-1)


def _flip_to(n: torch.Tensor, wo: torch.Tensor):
    """Normal flipped into wo's hemisphere, plus the sign."""
    s = torch.sign(vm.dot(n, wo, keepdim=True))
    s = torch.where(s == 0.0, 1.0, s)
    return n * s, s[..., 0]


def _sel(bt, typ, val, out):
    m = bt == typ
    return torch.where(m[:, None] if val.dim() == 2 else m, val, out)


def eval_bsdf(ctx, wo: torch.Tensor, wi: torch.Tensor):
    """(f_cos (B, 3), pdf (B,)) toward wi for NEE / MIS."""
    present = set(ctx["present"])
    n = ctx["n"]
    nl, _ = _flip_to(n, wo)
    cos_i = vm.dot(wi, nl)
    same_side = cos_i > 0.0
    cos_ic = torch.clamp(cos_i, min=0.0)
    bt = ctx["btype"]
    f = torch.zeros_like(wo)
    pdf = torch.zeros_like(cos_i)

    if T.BSDF_LAMBERTIAN in present:
        f = _sel(bt, T.BSDF_LAMBERTIAN, ctx["kd"] * (_INV_PI * cos_ic)[:, None], f)
        pdf = _sel(bt, T.BSDF_LAMBERTIAN, sampling.cosine_hemisphere_pdf(cos_i), pdf)

    if T.BSDF_PLASTIC in present:
        cos_o = torch.abs(vm.dot(wo, nl))
        ior = ctx["ior"]
        f_o = fresnel.fresnel_dielectric(cos_o, ior)
        f_i = fresnel.fresnel_dielectric(cos_ic, ior)
        fdr = fresnel.diffuse_fresnel(ior)
        kd = ctx["kd"]
        absorb = torch.exp(
            -vm.length(ctx["k"], keepdim=True) * ctx["thickness"][:, None]
            * (1.0 / torch.clamp(cos_ic, min=1e-4) + 1.0 / torch.clamp(cos_o, min=1e-4))[:, None])
        denom = torch.clamp(1.0 - kd * fdr[:, None], min=0.05) * (ior * ior)[:, None]
        f_pla = kd * ((1.0 - f_o) * (1.0 - f_i) * _INV_PI * cos_ic)[:, None] * absorb / denom
        p_spec = torch.clamp(f_o, 0.1, 0.9)
        f = _sel(bt, T.BSDF_PLASTIC, f_pla, f)
        pdf = _sel(bt, T.BSDF_PLASTIC, (1.0 - p_spec) * sampling.cosine_hemisphere_pdf(cos_i), pdf)

    if T.BSDF_GGX_CONDUCTOR in present:
        wo_l = to_local(wo, nl)
        wi_l = to_local(wi, nl)
        h_l = vm.normalize(wo_l + wi_l)
        ax, ay = ctx["ax"], ctx["ay"]
        f_c = fresnel.fresnel_conductor(torch.abs(torch.sum(wo_l * h_l, dim=-1)), ctx["eta"],
                                        ctx["k"])
        spec = f_c * ctx["kg"] * (ggx.ndf(h_l, ax, ay) * ggx.g2(wo_l, wi_l, ax, ay)
                                  / torch.clamp(4.0 * torch.abs(wo_l[..., 2]), min=1e-6))[:, None]
        f = _sel(bt, T.BSDF_GGX_CONDUCTOR, torch.where(same_side[:, None], spec, 0.0), f)
        pdf = _sel(bt, T.BSDF_GGX_CONDUCTOR,
                   torch.where(same_side, ggx.vndf_pdf(wo_l, h_l, ax, ay), 0.0), pdf)

    f = torch.where(same_side[:, None], f, 0.0)
    pdf = torch.where(same_side, pdf, 0.0)
    return f, pdf


def sample_bsdf(ctx, wo: torch.Tensor, rng_state: torch.Tensor, wl: torch.Tensor | None = None,
                u_wl: torch.Tensor | None = None):
    """Sample a continuation direction for every ray. Draw order (three
    pcg advances): u_dir (2d), u_lobe (1d), u_wl (1d, consumed only by the
    dispersion family; drawn always so the stream never shifts). ``wl`` is
    the path's locked dispersion wavelength (0 = none yet); ``u_wl``
    optionally replaces the drawn wavelength uniform (the renderers' per-
    sample stratum, models/path_tracer.wl_stratum_u).
    Returns ({wi, weight (= f cos / pdf), pdf, is_delta, lobe, wl}, rng)."""
    u_dir, rng_state = prng.next2d(rng_state)
    u_lobe, rng_state = prng.next1d(rng_state)
    u_wl_drawn, rng_state = prng.next1d(rng_state)
    u_wl = u_wl_drawn if u_wl is None else u_wl
    B = wo.shape[0]
    dev = wo.device
    if wl is None:
        wl = torch.zeros(B, device=dev)

    present = set(ctx["present"])
    n = ctx["n"]
    nl, _ = _flip_to(n, wo)
    bt = ctx["btype"]
    ones_b = torch.ones(B, dtype=torch.bool, device=dev)
    wi_p, w_p, pdf_p, delta_p, lobe_p = [], [], [], [], []

    # lambertian base: cosine hemisphere around nl (also the plastic substrate)
    d_loc, _ = sampling.cosine_hemisphere(u_dir)
    wi_lam = vm.to_world(d_loc, nl)
    w_lam = ctx["kd"]
    pdf_lam = sampling.cosine_hemisphere_pdf(torch.clamp(d_loc[..., 2], min=1e-6))

    wi_spec = vm.normalize(vm.reflect(-wo, nl))
    cos_signed = vm.dot(wo, n)
    entering = cos_signed > 0.0
    ior = ctx["ior"]

    if T.BSDF_SPECULAR in present:
        wi_p.append((T.BSDF_SPECULAR, wi_spec))
        w_p.append((T.BSDF_SPECULAR, ctx["kd"]))
        delta_p.append((T.BSDF_SPECULAR, ones_b))
        lobe_p.append((T.BSDF_SPECULAR, torch.full((B,), LOBE_SPECULAR, device=dev)))

    if T.BSDF_TRANSLUCENT in present:
        eta_rel = torch.where(entering, ior, 1.0 / torch.clamp(ior, min=1e-4))
        refl = u_lobe < fresnel.fresnel_dielectric(torch.abs(cos_signed), eta_rel)
        wt, _ = vm.refract(-wo, nl, (1.0 / eta_rel)[:, None])
        rad_scale = 1.0 / torch.clamp(eta_rel * eta_rel, min=1e-6)
        tint = ctx["ks"]
        wi_p.append((T.BSDF_TRANSLUCENT, torch.where(refl[:, None], wi_spec, wt)))
        w_p.append((T.BSDF_TRANSLUCENT,
                    torch.where(refl[:, None], tint, tint * rad_scale[:, None])))
        delta_p.append((T.BSDF_TRANSLUCENT, ones_b))
        lobe_p.append((T.BSDF_TRANSLUCENT,
                       torch.where(refl, LOBE_SPECULAR, LOBE_TRANSMIT)))

    if T.BSDF_PLASTIC in present or T.BSDF_PLASTIC_FORWARD in present:
        cos_o = torch.abs(cos_signed)
        f_o = fresnel.fresnel_dielectric(cos_o, ior)
        p_spec = torch.clamp(f_o, 0.1, 0.9)
        take_spec = u_lobe < p_spec
        w_spec = ctx["ks"] * (f_o / p_spec)[:, None]
        if T.BSDF_PLASTIC in present:
            cos_i_d = torch.clamp(d_loc[..., 2], min=1e-6)
            f_i = fresnel.fresnel_dielectric(cos_i_d, ior)
            fdr = fresnel.diffuse_fresnel(ior)
            absorb = torch.exp(-vm.length(ctx["k"], keepdim=True) * ctx["thickness"][:, None]
                               * (1.0 / cos_i_d + 1.0 / torch.clamp(cos_o, min=1e-4))[:, None])
            denom = torch.clamp(1.0 - ctx["kd"] * fdr[:, None], min=0.05) * (ior * ior)[:, None]
            w_diff = (ctx["kd"] * ((1.0 - f_o) * (1.0 - f_i) / (1.0 - p_spec))[:, None]
                      * absorb / denom)
            wi_p.append((T.BSDF_PLASTIC, torch.where(take_spec[:, None], wi_spec, wi_lam)))
            w_p.append((T.BSDF_PLASTIC, torch.where(take_spec[:, None], w_spec, w_diff)))
            pdf_p.append((T.BSDF_PLASTIC, (1.0 - p_spec) * pdf_lam))
            delta_p.append((T.BSDF_PLASTIC, take_spec))
            lobe_p.append((T.BSDF_PLASTIC, torch.where(take_spec, LOBE_SPECULAR, LOBE_DIFFUSE)))
        if T.BSDF_PLASTIC_FORWARD in present:
            w_fwd = ctx["kd"] * ((1.0 - f_o) / (1.0 - p_spec))[:, None]
            wi_p.append((T.BSDF_PLASTIC_FORWARD, torch.where(take_spec[:, None], wi_spec, -wo)))
            w_p.append((T.BSDF_PLASTIC_FORWARD, torch.where(take_spec[:, None], w_spec, w_fwd)))
            delta_p.append((T.BSDF_PLASTIC_FORWARD, ones_b))
            lobe_p.append((T.BSDF_PLASTIC_FORWARD,
                           torch.where(take_spec, LOBE_SPECULAR, LOBE_TRANSMIT)))

    if T.BSDF_GGX_CONDUCTOR in present:
        wo_l = to_local(wo, nl)
        wo_l = torch.cat([wo_l[..., :2], torch.clamp(wo_l[..., 2:3], min=1e-5)], dim=-1)
        ax, ay = ctx["ax"], ctx["ay"]
        h_l = ggx.sample_vndf(wo_l, ax, ay, u_dir)
        g1v = ggx.g1(wo_l, ax, ay)

    if T.BSDF_GGX_CONDUCTOR in present:
        wi_l = 2.0 * torch.sum(wo_l * h_l, dim=-1, keepdim=True) * h_l - wo_l
        ggx_ok = wi_l[..., 2] > 1e-5
        f_c = fresnel.fresnel_conductor(torch.abs(torch.sum(wo_l * h_l, dim=-1)), ctx["eta"],
                                        ctx["k"])
        g2v = ggx.g2(wo_l, wi_l, ax, ay)
        wi_p.append((T.BSDF_GGX_CONDUCTOR, vm.to_world(vm.normalize(wi_l), nl)))
        w_p.append((T.BSDF_GGX_CONDUCTOR,
                    torch.where(ggx_ok[:, None],
                                f_c * ctx["kg"] * (g2v / torch.clamp(g1v, min=1e-6))[:, None],
                                0.0)))
        pdf_p.append((T.BSDF_GGX_CONDUCTOR,
                      torch.where(ggx_ok, ggx.vndf_pdf(wo_l, h_l, ax, ay), 1.0)))
        lobe_p.append((T.BSDF_GGX_CONDUCTOR, torch.full((B,), LOBE_SPECULAR, device=dev)))

    wl_out = wl
    if T.BSDF_DISPERSION in present:
        # wavelength locked at the first dispersive event of the path
        wl_fresh = spectral.WL_MIN + u_wl * (spectral.WL_MAX - spectral.WL_MIN)
        first = wl <= 0.0
        wl_use = torch.where(first, wl_fresh, wl)
        ior_wl = ctx["cauchy_a"] + ctx["cauchy_b"] / torch.clamp((wl_use * 1e-3) ** 2, min=1e-6)
        eta_wl = torch.where(entering, ior_wl, 1.0 / torch.clamp(ior_wl, min=1e-4))
        refl = u_lobe < fresnel.fresnel_dielectric(torch.abs(cos_signed), eta_wl)
        wt, _ = vm.refract(-wo, nl, (1.0 / eta_wl)[:, None])
        rgb = torch.where(first[:, None], spectral.wavelength_to_rgb(wl_use), 1.0)
        rad = 1.0 / torch.clamp(eta_wl * eta_wl, min=1e-6)
        wi_p.append((T.BSDF_DISPERSION, torch.where(refl[:, None], wi_spec, wt)))
        w_p.append((T.BSDF_DISPERSION,
                    torch.where(refl[:, None], rgb, rgb * rad[:, None]) * ctx["ks"]))
        delta_p.append((T.BSDF_DISPERSION, ones_b))
        lobe_p.append((T.BSDF_DISPERSION, torch.where(refl, LOBE_SPECULAR, LOBE_TRANSMIT)))
        wl_out = torch.where(bt == T.BSDF_DISPERSION, wl_use.detach(), wl)

    if T.BSDF_FORWARD in present:
        wi_p.append((T.BSDF_FORWARD, -wo))
        w_p.append((T.BSDF_FORWARD, torch.ones_like(w_lam)))
        delta_p.append((T.BSDF_FORWARD, ones_b))
        lobe_p.append((T.BSDF_FORWARD, torch.full((B,), LOBE_TRANSMIT, device=dev)))

    def select(pairs, out):
        for typ, val in pairs:
            out = _sel(bt, typ, val, out)
        return out

    out = {  # the sampled direction and its pdf are detached, the weight attached
        "wi": select(wi_p, wi_lam).detach(),
        "weight": select(w_p, w_lam),
        "pdf": select(pdf_p, pdf_lam).detach(),
        "is_delta": select(delta_p, torch.zeros(B, dtype=torch.bool, device=dev)),
        "lobe": select(lobe_p, torch.full((B,), LOBE_DIFFUSE, device=dev)),
        "wl": wl_out,
    }
    return out, rng_state
