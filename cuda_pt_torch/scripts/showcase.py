"""Showcase render: every round-2 feature in one frame (port of
scripts/showcase.py).

A Cornell-style room with a dispersive Diamond sphere, a frosted
(rough-dielectric) pane, a gold GGX conductor sphere and an Oren-Nayar
clay sphere, rendered with the Owen-Sobol sampler under tile-adaptive
allocation (models/adaptive.render_adaptive), then variance-guided
denoised (models/denoise.atrous_denoise). Writes one PNG: raw and
denoised side by side, by default showcase_torch.png in the current
directory.

  python -m cuda_pt_torch.scripts.showcase [--width 160] [--budget 64]
      [--out showcase_torch.png] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses

from ..utils.timing import device_of
from . import add_device_arg


def build_scene(device="cpu"):
    """(scene, camera) of the showcase room at 160 x 160, on device."""
    from ..core import camera as cam_mod
    from ..scene import testscenes
    from ..scene import types as T
    from ..scene.builder import BSDFSpec, EmitterSpec, SceneBuilder
    from ..scene.presets import CONDUCTORS, DISPERSION

    b = SceneBuilder()
    q = testscenes.quad
    white = b.add_bsdf(BSDFSpec(k_d=(0.73, 0.73, 0.73)))
    red = b.add_bsdf(BSDFSpec(k_d=(0.65, 0.05, 0.05)))
    green = b.add_bsdf(BSDFSpec(k_d=(0.12, 0.45, 0.15)))
    clay = b.add_bsdf(BSDFSpec(btype=T.BSDF_OREN_NAYAR, k_d=(0.65, 0.45, 0.3),
                               roughness_x=0.7, roughness_y=0.7))
    a_d, b_d = DISPERSION["Diamond"]
    diamond = b.add_bsdf(BSDFSpec(btype=T.BSDF_DISPERSION, k_s=(1, 1, 1), cauchy_a=a_d,
                                  cauchy_b=b_d))
    eta, kk = CONDUCTORS["Au"]
    gold = b.add_bsdf(BSDFSpec(btype=T.BSDF_GGX_CONDUCTOR, k_g=(1, 1, 1), eta=eta, k=kk,
                               roughness_x=0.15, roughness_y=0.35))
    frost = b.add_bsdf(BSDFSpec(btype=T.BSDF_GGX_DIELECTRIC, k_s=(1, 1, 1), ior=1.5,
                                roughness_x=0.12, roughness_y=0.12))
    dark = b.add_bsdf(BSDFSpec(k_d=(0, 0, 0)))
    em = b.add_emitter(EmitterSpec(emission=(1.0, 0.9, 0.75), scaler=18.0))

    s = 1.0  # room half-size
    b.add_mesh(q([-s, 0, -s], [-s, 0, s], [s, 0, s], [s, 0, -s]), white)  # floor
    b.add_mesh(q([-s, 2 * s, -s], [s, 2 * s, -s], [s, 2 * s, s], [-s, 2 * s, s]), white)  # ceiling
    b.add_mesh(q([-s, 0, s], [-s, 2 * s, s], [s, 2 * s, s], [s, 0, s]), white)  # back
    b.add_mesh(q([-s, 0, -s], [-s, 2 * s, -s], [-s, 2 * s, s], [-s, 0, s]), red)  # left
    b.add_mesh(q([s, 0, s], [s, 2 * s, s], [s, 2 * s, -s], [s, 0, -s]), green)  # right
    b.add_mesh(q([-0.3, 1.98, -0.3], [0.3, 1.98, -0.3], [0.3, 1.98, 0.3], [-0.3, 1.98, 0.3]),
               dark, emitter_id=em)  # light (faces down)
    b.add_sphere((-0.45, 0.32, 0.3), 0.32, diamond)
    b.add_sphere((0.5, 0.3, -0.1), 0.3, gold)
    b.add_sphere((0.0, 0.22, -0.45), 0.22, clay)
    # frosted pane standing mid-room
    b.add_mesh(q([-0.75, 0.0, -0.15], [-0.75, 0.9, -0.15], [-0.05, 0.9, -0.35],
                 [-0.05, 0.0, -0.35]), frost)
    scene = b.compile(device=device)
    cam = cam_mod.make_camera((0, 1.0, -2.9), (0, 0.75, 0), fov=42, width=160, height=160,
                              device=device)
    return scene, cam


def render(width: int, budget: int, device=None):
    """(raw, denoised, n): the adaptive Sobol render at width x width with
    budget samples per pixel, its denoised image (both (H, W, 3)) and the
    per-pixel sample counts."""
    from ..core.config import MaxDepthParams
    from ..models import adaptive, debug_renderers, denoise
    from ..models import path_tracer as ptm

    scene, cam = build_scene(device or "cpu")
    if width != cam.width:
        cam = dataclasses.replace(cam, width=width, height=width)
    md = MaxDepthParams(max_depth=8, max_transmit=10, max_specular=10)
    img, n, var = adaptive.render_adaptive(scene, cam, md, budget, seed=3, sampler="sobol",
                                           return_variance=True)
    aovs = debug_renderers.render_aovs(scene, cam, spp=8, seed=7919,
                                       use_bvh=scene.geom.num_prims > ptm.BRUTE_FORCE_MAX_PRIMS)
    return img, denoise.atrous_denoise(img, aovs, variance=var), n


def main(argv=None) -> int:
    import numpy as np

    from ..core import film as film_mod
    from ..utils.image import save_png

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--width", type=int, default=160)
    ap.add_argument("--budget", type=int, default=64)
    ap.add_argument("--out", default="showcase_torch.png")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = device_of(args.device)
    img, dn, n = render(args.width, args.budget, dev)
    raw8 = (film_mod.to_srgb(img) * 255 + 0.5).cpu().numpy().astype(np.uint8)
    dn8 = (film_mod.to_srgb(dn) * 255 + 0.5).cpu().numpy().astype(np.uint8)
    save_png(args.out, np.concatenate([raw8, dn8], axis=1))
    print(f"wrote {args.out} (left raw adaptive+sobol {args.budget} budget, right denoised); "
          f"n range [{float(n.min()):.0f}, {float(n.max()):.0f}]")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
