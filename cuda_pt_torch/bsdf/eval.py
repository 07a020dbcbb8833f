"""BSDF evaluation / sampling over the dense material table (port of
cuda_pt_tpu/bsdf/eval.py for the Lambertian, Specular and Translucent
families; the other families and textured slots raise until their ROADMAP
item lands).

Conventions: wo points away from the surface (= -ray dir); wi is the
continuation direction. ``eval_bsdf`` returns f(wo, wi) * |cos(wi, n)| for
smooth lobes only (delta lobes contribute 0 to NEE/MIS).
"""

from __future__ import annotations

import torch

from ..core import math as vm
from ..core import rng as prng
from ..core import sampling
from ..scene import types as T
from . import fresnel

LOBE_DIFFUSE = 0
LOBE_SPECULAR = 1
LOBE_TRANSMIT = 2

PORTED_BSDFS = (T.BSDF_LAMBERTIAN, T.BSDF_SPECULAR, T.BSDF_TRANSLUCENT)
_INV_PI = sampling.INV_PI


def check_supported(scene: T.Scene):
    """Raise for BSDF families and texture slots this slice does not port."""
    missing = set(scene.present_bsdfs) - set(PORTED_BSDFS)
    if missing:
        raise NotImplementedError(
            f"BSDF families {sorted(missing)} wait for ROADMAP Queue 1 item 2 "
            "(ported: lambertian, specular, translucent)")
    if bool((scene.bsdfs.tex_ids >= 0).any()):
        raise NotImplementedError("textured BSDF slots wait for ROADMAP Queue 1 item 2")


def make_ctx(scene: T.Scene, bid: torch.Tensor, uv: torch.Tensor, n_s: torch.Tensor):
    """Gather per-ray material parameters. bid: (B,) material ids (clamped
    by the caller); uv is accepted for parity and unused (no textures)."""
    check_supported(scene)
    b = scene.bsdfs
    bid = bid.long()
    return {
        "present": tuple(scene.present_bsdfs),
        "btype": b.btype[bid],
        "kd": b.k_d[bid],
        "ks": b.k_s[bid],
        "ior": b.params[bid, T.P_IOR],
        "n": n_s,
    }


def _flip_to(n: torch.Tensor, wo: torch.Tensor):
    """Normal flipped into wo's hemisphere, plus the sign."""
    s = torch.sign(vm.dot(n, wo, keepdim=True))
    s = torch.where(s == 0.0, 1.0, s)
    return n * s, s[..., 0]


def eval_bsdf(ctx, wo: torch.Tensor, wi: torch.Tensor):
    """(f_cos (B, 3), pdf (B,)) toward wi for NEE / MIS."""
    present = set(ctx["present"])
    nl, _ = _flip_to(ctx["n"], wo)
    cos_i = vm.dot(wi, nl)
    same_side = cos_i > 0.0
    cos_ic = torch.clamp(cos_i, min=0.0)
    bt = ctx["btype"]
    f = torch.zeros_like(wo)
    pdf = torch.zeros_like(cos_i)
    if T.BSDF_LAMBERTIAN in present:
        is_lam = bt == T.BSDF_LAMBERTIAN
        f_lam = ctx["kd"] * (_INV_PI * cos_ic)[:, None]
        f = torch.where(is_lam[:, None], f_lam, f)
        pdf = torch.where(is_lam, sampling.cosine_hemisphere_pdf(cos_i), pdf)
    f = torch.where(same_side[:, None], f, 0.0)
    pdf = torch.where(same_side, pdf, 0.0)
    return f, pdf


def sample_bsdf(ctx, wo: torch.Tensor, rng_state: torch.Tensor):
    """Sample a continuation direction for every ray. Draw order (three
    pcg advances): u_dir (2d), u_lobe (1d), u_wl (1d, consumed only by the
    dispersion family, drawn always so the stream never shifts).
    Returns ({wi, weight (= f cos / pdf), pdf, is_delta, lobe}, rng)."""
    u_dir, rng_state = prng.next2d(rng_state)
    u_lobe, rng_state = prng.next1d(rng_state)
    _u_wl, rng_state = prng.next1d(rng_state)

    present = set(ctx["present"])
    n = ctx["n"]
    nl, _ = _flip_to(n, wo)
    bt = ctx["btype"]
    B = wo.shape[0]
    dev = wo.device

    # lambertian base: cosine hemisphere around nl
    d_loc, _ = sampling.cosine_hemisphere(u_dir)
    wi = vm.to_world(d_loc, nl)
    weight = ctx["kd"]
    pdf = sampling.cosine_hemisphere_pdf(torch.clamp(d_loc[..., 2], min=1e-6))
    is_delta = torch.zeros(B, dtype=torch.bool, device=dev)
    lobe = torch.full((B,), LOBE_DIFFUSE, dtype=torch.int64, device=dev)

    wi_spec = vm.normalize(vm.reflect(-wo, nl))
    cos_signed = vm.dot(wo, n)
    entering = cos_signed > 0.0
    ior = ctx["ior"]

    if T.BSDF_SPECULAR in present:
        m = bt == T.BSDF_SPECULAR
        wi = torch.where(m[:, None], wi_spec, wi)
        weight = torch.where(m[:, None], ctx["kd"], weight)
        is_delta = is_delta | m
        lobe = torch.where(m, LOBE_SPECULAR, lobe)

    if T.BSDF_TRANSLUCENT in present:
        m = bt == T.BSDF_TRANSLUCENT
        eta_rel = torch.where(entering, ior, 1.0 / torch.clamp(ior, min=1e-4))
        f_die = fresnel.fresnel_dielectric(torch.abs(cos_signed), eta_rel)
        refl = u_lobe < f_die
        wt, _tir = vm.refract(-wo, nl, (1.0 / eta_rel)[:, None])
        rad_scale = 1.0 / torch.clamp(eta_rel * eta_rel, min=1e-6)
        tint = ctx["ks"]
        wi = torch.where(m[:, None], torch.where(refl[:, None], wi_spec, wt), wi)
        weight = torch.where(
            m[:, None], torch.where(refl[:, None], tint, tint * rad_scale[:, None]), weight)
        is_delta = is_delta | m
        lobe = torch.where(m, torch.where(refl, LOBE_SPECULAR, LOBE_TRANSMIT), lobe)

    return {"wi": wi, "weight": weight, "pdf": pdf, "is_delta": is_delta,
            "lobe": lobe}, rng_state
