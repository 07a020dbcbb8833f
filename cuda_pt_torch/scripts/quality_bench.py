"""Equal-budget quality benchmark: sampler x allocation x denoise (port of
scripts/quality_bench.py).

Measures error per sample: MSE against a 1,024-spp reference render
(models/path_tracer.render, brute-force walk, in batched passes) of seven configurations per
budget (uniform and tile-adaptive allocation, pcg and Owen-Sobol streams,
variance-guided a-trous denoise), then the samples and seconds each of
three configurations needs to reach a target MSE (time to quality).

Writes QUALITY_BENCH_torch.json (QUALITY_BENCH_slot_torch.json for the
slot scene) in the current directory unless --out says otherwise, and
prints one JSON row per configuration.

  python -m cuda_pt_torch.scripts.quality_bench [--scene cornell|slot]
      [--width 64] [--budgets 4 8 16] [--target-mse X] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path


from ..utils.timing import device_of
from . import add_device_arg

DEFAULT_OUT = "QUALITY_BENCH_torch.json"
REF_SPP = 1024
REF_LANES = 1 << 18  # lanes of one batched pass of the reference render


def ref_samples_per_pass(pixels: int) -> int:
    """Samples per batched pass of the reference render: the largest power
    of two dividing REF_SPP whose pass holds at most REF_LANES lanes."""
    k = REF_SPP
    while k > 1 and k * pixels > REF_LANES:
        k //= 2
    return k


def reference(scene, cam, md, samples_per_pass: int | None = None):
    """The REF_SPP reference render (seed 991, the brute force) in batched
    passes of ref_samples_per_pass samples, or samples_per_pass
    (path_tracer.render's): the estimates of REF_SPP sequential passes, in
    fewer calls."""
    from ..models import path_tracer as pt

    k = samples_per_pass or ref_samples_per_pass(int(cam.width) * int(cam.height))
    return pt.render(scene, cam, md, spp=REF_SPP, seed=991, use_bvh=False, samples_per_pass=k)


def run(scene_name: str, w: int, budgets: list, target_mse=None, device=None) -> dict:
    """The rows, the time-to-quality rows and the header of the output."""
    import torch

    from ..core import film as film_mod
    from ..core.config import MaxDepthParams
    from ..models import adaptive, debug_renderers, denoise
    from ..models import path_tracer as pt
    from ..scene import testscenes

    dev = torch.device(device or "cpu")
    if scene_name == "slot":
        from ..core import camera as cam_mod
        from .scenes import slot_scene

        scene, _ = slot_scene(device=dev)
        cam = cam_mod.make_camera((0, 0.7, -2.6), (0, 0.3, 0), fov=35, width=w, height=w,
                                  device=dev)
    else:
        scene, cam, _ = testscenes.cornell_box(width=w, height=w, device=dev)
    md = MaxDepthParams(max_depth=5)
    with torch.no_grad():
        ref = reference(scene, cam, md).cpu().numpy()
        aovs = debug_renderers.render_aovs(scene, cam, spp=4, seed=7919, use_bvh=False)

    def mse(img):
        return float(((img.cpu().numpy() - ref) ** 2).mean())

    def uniform(budget, sampler):
        return pt.render(scene, cam, md, spp=budget, seed=0, use_bvh=False, sampler=sampler)

    def adapt(budget, sampler):
        img, _ = adaptive.render_adaptive(scene, cam, md, budget, seed=0, use_bvh=False,
                                          sampler=sampler)
        return img

    def denoised_adaptive(budget, sampler):
        """Everything on: adaptive + QMC + variance-guided denoise, the
        denoiser fed adaptive's own per-pixel variance."""
        img, _, var = adaptive.render_adaptive(scene, cam, md, budget, seed=0, use_bvh=False,
                                               sampler=sampler, return_variance=True)
        return denoise.atrous_denoise(img, aovs, variance=var)

    def denoised_uniform(budget, sampler):
        """Film-accumulated render -> variance-guided a-trous denoise."""
        film = film_mod.make_film(w, w, dev)
        for i in range(budget):
            film = film_mod.accumulate(film, pt.render_sample(scene, cam, md, 0, i, False,
                                                              sampler=sampler))
        var = film_mod.variance(film) / max(film.count, 1)
        return denoise.atrous_denoise(film.mean, aovs, variance=var)

    rows = []
    with torch.no_grad():
        for budget in budgets:
            configs = {
                "uniform_pcg": lambda: uniform(budget, "pcg"),
                "uniform_sobol": lambda: uniform(budget, "sobol"),
                "adaptive_pcg": lambda: adapt(budget, "pcg"),
                "adaptive_sobol": lambda: adapt(budget, "sobol"),
                "uniform_pcg_denoised_vg": lambda: denoised_uniform(budget, "pcg"),
                "uniform_sobol_denoised_vg": lambda: denoised_uniform(budget, "sobol"),
                "adaptive_sobol_denoised_vg": lambda: denoised_adaptive(budget, "sobol"),
            }
            base = None
            for name, fn in configs.items():
                m = mse(fn())
                if base is None:
                    base = m
                rows.append({"budget_spp": budget, "config": name, "mse": m,
                             "vs_uniform_pcg": round(m / base, 4)})
                print(json.dumps(rows[-1]), flush=True)

        # time to quality: samples and wall time to reach a target MSE (the
        # user-facing metric)
        target = target_mse
        if target is None:
            target = next(r["mse"] for r in rows
                          if r["budget_spp"] == max(budgets) and r["config"] == "uniform_pcg")
        tt_rows = []
        for name, fn in [("uniform_pcg", lambda b: uniform(b, "pcg")),
                         ("uniform_sobol", lambda b: uniform(b, "sobol")),
                         ("adaptive_sobol", lambda b: adapt(b, "sobol"))]:
            # adaptive needs >= 2 warm-up passes below its budget
            budget, m, dt = (4 if name.startswith("adaptive") else 2), float("inf"), 0.0
            while budget <= 512:
                t0 = time.perf_counter()
                img = fn(budget).cpu()
                dt = time.perf_counter() - t0
                m = mse(img)
                if m <= target:
                    break
                budget *= 2
            tt_rows.append({"config": name, "target_mse": target,
                            "spp_to_target": budget if m <= target else None, "mse": m,
                            "seconds": round(dt, 3)})
            print(json.dumps(tt_rows[-1]), flush=True)
    return {"scene": f"{scene_name} {w}x{w} depth5", "reference_spp": REF_SPP,
            "metric": "MSE vs reference", "rows": rows, "time_to_quality": tt_rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scene", choices=["cornell", "slot"], default="cornell",
                    help="slot = light through a narrow slot (concentrated variance; the "
                         "adaptive sampler's best case)")
    ap.add_argument("--width", type=int, default=64)
    ap.add_argument("--budgets", type=int, nargs="+", default=[4, 8, 16])
    ap.add_argument("--target-mse", type=float, default=None,
                    help="time-to-quality target (default: uniform_pcg's MSE at the largest "
                         "budget)")
    ap.add_argument("--out", default=DEFAULT_OUT)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = device_of(args.device)
    res = run(args.scene, args.width, args.budgets, args.target_mse, dev)
    out = args.out
    if args.scene != "cornell" and out == DEFAULT_OUT:
        out = f"QUALITY_BENCH_{args.scene}_torch.json"
    Path(out).write_text(json.dumps(res, indent=1))
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
