"""Worked inverse-rendering example: recover scene parameters by gradient
descent through the differentiable path tracer (port of
scripts/inverse_render.py).

Render a ground-truth image, perturb one parameter family, then optimize
it back with Adam on the Monte-Carlo image loss:
  albedo    diffuse k_d of every BSDF       (detached-sampling gradients)
  emitter   emission RGB x scale            (linear -> fast convergence)
  sigma     homogeneous medium sigma_t      (volumetric transmittance grads)

Runs on CUDA unless ``--device cpu`` is passed (without a GPU it raises, as
the Renderer does). Usage:

  python -m cuda_pt_torch.inverse_render --param albedo --steps 60 --out DIR

Prints one JSON line of settings, one per logged step and one of results;
exits 0 when the parameter error fell below half its initial value.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time
from typing import Callable

import numpy as np
import torch

from .core import film as film_mod
from .core.config import MaxDepthParams
from .models import path_tracer as pt
from .models import volume_pt as vpt
from .scene import testscenes
from .scene.builder import MediumSpec
from .utils.image import save_png

# per-family (steps, spp) defaults of the reference (all three recover)
DEFAULTS = {"albedo": (60, 8), "emitter": (30, 8), "sigma": (200, 16)}
TARGET_SEED, EVAL_SEED = 1234, 7


@dataclasses.dataclass
class Problem:
    """One parameter family on the cornell box: theta's true value and its
    perturbed start, apply(scene, theta) -> scene, render(scene, seed, spp,
    differentiable) -> (H, W, 3), the learning rate and the rows of theta
    the error metric covers (albedo: the walls' materials, the only ones
    the render constrains)."""
    scene: object
    apply: Callable
    render: Callable
    theta_true: torch.Tensor
    theta0: torch.Tensor
    lr: float
    err_rows: slice = slice(None)


def make_problem(param: str, res: int, device) -> Problem:
    scene, cam, bld = testscenes.cornell_box(width=res, height=res, device=device)
    md = MaxDepthParams(max_depth=3)

    def render_pt(s, seed, spp, diff):
        return pt.render(s, cam, md, spp, seed=seed, use_bvh=False, differentiable=diff)

    if param == "albedo":
        theta_true = scene.bsdfs.k_d.clone()

        def apply(s, th):
            return dataclasses.replace(s, bsdfs=dataclasses.replace(
                s.bsdfs, k_d=torch.clamp(th, 0.0, 1.0)))

        return Problem(scene, apply, render_pt, theta_true,
                       torch.clamp(theta_true * 0.3 + 0.35, 0.0, 1.0), 0.05, slice(0, 3))
    if param == "emitter":
        theta_true = scene.emitters.emission * scene.emitters.scaler[:, None]

        def apply(s, th):  # dim the area light
            return dataclasses.replace(s, emitters=dataclasses.replace(
                s.emitters, emission=torch.clamp(th, min=0.0),
                scaler=torch.ones_like(s.emitters.scaler)))

        dim = torch.tensor([[1.0], [0.25]], device=scene.device)
        return Problem(scene, apply, render_pt, theta_true, theta_true * dim, 0.5)
    if param != "sigma":
        raise ValueError(f"unknown parameter family {param!r}")
    # sigma: fill the box with a homogeneous medium and recover sigma_t at
    # a fixed single-scattering albedo
    mid = bld.add_medium(MediumSpec(sigma_a=(0.3, 0.3, 0.3), sigma_s=(0.4, 0.4, 0.4)))
    bld.cam_medium = mid
    scene = bld.compile(device=device)
    md_v = MaxDepthParams(max_depth=3, max_volume=3)
    theta_true = scene.media.sigma_a[mid] + scene.media.sigma_s[mid]
    alb = 4.0 / 7.0

    def apply(s, th):
        sig_t = torch.clamp(th, min=1e-4)
        sa, ss = s.media.sigma_a.clone(), s.media.sigma_s.clone()
        sa[mid], ss[mid] = sig_t * (1 - alb), sig_t * alb
        return dataclasses.replace(s, media=dataclasses.replace(s.media, sigma_a=sa,
                                                                sigma_s=ss))

    def render_vpt(s, seed, spp, diff):
        return vpt.render(s, cam, md_v, spp, seed=seed, use_bvh=False, differentiable=diff)

    return Problem(scene, apply, render_vpt, theta_true, theta_true * 0.3, 0.04)


def _png(path: str, img: torch.Tensor) -> None:
    srgb = film_mod.to_srgb(img.detach()).cpu().numpy()
    save_png(path, (srgb * 255.0 + 0.5).astype(np.uint8))


def main(argv=None, on_step: Callable | None = None) -> int:
    """The command line's entry. on_step, when given, is called after each
    Adam step with {step, loss, param_err, elapsed_s, grad}."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--param", choices=sorted(DEFAULTS), default="albedo")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--res", type=int, default=24)
    ap.add_argument("--spp", type=int, default=None)
    ap.add_argument("--lr", type=float, default=None)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "inverse_render"))
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    d_steps, d_spp = DEFAULTS[args.param]
    steps = d_steps if args.steps is None else args.steps
    spp = d_spp if args.spp is None else args.spp
    device = torch.device("cuda" if args.device is None else args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("inverse_render runs on CUDA, which is not available; pass "
                           "--device cpu to run on the CPU")

    os.makedirs(args.out, exist_ok=True)
    prob = make_problem(args.param, args.res, device)
    lr = args.lr or prob.lr
    print(json.dumps({"param": args.param, "backend": device.type, "res": args.res,
                      "steps": steps}), flush=True)
    target = prob.render(prob.apply(prob.scene, prob.theta_true), TARGET_SEED, max(4 * spp, 32),
                         False)

    def err(th):
        return float(torch.abs((th.detach() - prob.theta_true)[prob.err_rows]).mean())

    theta = prob.theta0.clone().requires_grad_(True)
    opt = torch.optim.Adam([theta], lr=lr)  # optax.adam's update and defaults
    t0 = time.time()
    for i in range(steps):
        opt.zero_grad()
        # "remat": the reference's gradient (plain mode's, bit for bit) with
        # each pass recomputed in the backward pass, so memory stays flat in spp
        img = prob.render(prob.apply(prob.scene, theta), i + 1, spp, "remat")
        loss = torch.mean((img - target) ** 2)
        loss.backward()
        opt.step()
        rec = {"step": i, "loss": float(loss.detach()), "param_err": err(theta),
               "elapsed_s": time.time() - t0}
        if on_step is not None:
            on_step({**rec, "grad": theta.grad})
        if i % 10 == 0 or i == steps - 1:
            print(json.dumps({"step": i, "loss": round(rec["loss"], 6),
                              "param_err": round(rec["param_err"], 5),
                              "elapsed_s": round(rec["elapsed_s"], 1)}), flush=True)

    # report: clean renders above the MC noise floor
    spp_eval = max(4 * spp, 32)
    img0 = prob.render(prob.apply(prob.scene, prob.theta0), EVAL_SEED, spp_eval, False)
    img1 = prob.render(prob.apply(prob.scene, theta.detach()), EVAL_SEED, spp_eval, False)
    err0, err1 = err(prob.theta0), err(theta)
    for name, im in (("target", target), ("init", img0), ("final", img1)):
        _png(os.path.join(args.out, f"{name}.png"), im)
    recovered = err1 < 0.5 * err0
    print(json.dumps({"param_err_init": round(err0, 5), "param_err_final": round(err1, 5),
                      "image_l1_init": round(float(torch.mean(torch.abs(img0 - target))), 5),
                      "image_l1_final": round(float(torch.mean(torch.abs(img1 - target))), 5),
                      "recovered": recovered, "out": args.out}), flush=True)
    return 0 if recovered else 1


if __name__ == "__main__":
    sys.exit(main())
