"""Guided-sampling quality study (port of scripts/guiding_study.py).

Measures the equal-spp error of the guided wavefront estimator
(models/wavefront.render with a models/guiding.train_guide guide) on the
slot scene (scenes.slot_scene: a bright light visible only through a
narrow slot) as a function of the online fit schedule: training spp and
Adam steps. Error metric: the mean per-pixel seed-to-seed variance across
N seeds at equal render spp, plus the mean-image drift against the
unguided mean (an unbiasedness check); the equal-time win charges the
guided estimator its fit time.

Writes GUIDING_STUDY_torch.json in the current directory unless --out
says otherwise, and prints one JSON row per configuration.

  python -m cuda_pt_torch.scripts.guiding_study [--seeds 10] [--spp 6]
      [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np

from ..utils.timing import device_of, force
from . import add_device_arg

# the fit schedules: (training spp, Adam steps)
SCHEDULES = ((2, 50), (6, 50), (6, 150), (6, 400), (12, 150))
# the kill threshold: below this equal-time win guiding stays off by default
THRESHOLD = 1.3


def study(scene, cam, md, seeds: int, spp: int, schedules=SCHEDULES) -> tuple:
    """(rows, best equal-time win, verdict) of the unguided estimator and
    each fit schedule."""
    import torch

    from ..models import guiding, wavefront

    def stats(guide):
        t0 = time.perf_counter()
        with torch.no_grad():
            imgs = np.stack([wavefront.render(scene, cam, md, spp=spp, seed=50 + s,
                                              guide=guide).cpu().numpy() for s in range(seeds)])
        render_s = (time.perf_counter() - t0) / seeds
        return float(imgs.mean()), float(imgs.var(axis=0).mean()), render_s

    rows = []
    m0, v0, t_r0 = stats(None)
    # second timing pass: the first pays the one-off costs
    _, _, t_r0 = stats(None)
    rows.append({"config": "unguided", "mean": m0, "var": v0, "vs_unguided": 1.0,
                 "render_seconds": round(t_r0, 2)})
    print(json.dumps(rows[-1]), flush=True)

    best_equal_time = 0.0
    for fit_spp, steps in schedules:
        force(scene)
        t0 = time.perf_counter()
        guide, loss = guiding.train_guide(scene, cam, md, seed=3, use_bvh=False, spp=fit_spp,
                                          steps=steps)
        force(scene)
        fit_s = time.perf_counter() - t0
        m, v, t_rg = stats(guide)
        # equal-time win: the variance of the mean scales as var / spp, so
        # var * t; the guided estimator is charged its fit time over one
        # frame (et_1) and over 100 frames that reuse the guide (et_100)
        et_1 = (v0 / max(v, 1e-12)) * (t_r0 / max(t_rg + fit_s, 1e-9))
        et_100 = (v0 / max(v, 1e-12)) * (t_r0 / max(t_rg + fit_s / 100, 1e-9))
        best_equal_time = max(best_equal_time, et_1)
        rows.append({
            "config": f"fit_spp{fit_spp}_steps{steps}",
            "mean": m, "var": v, "vs_unguided": v / v0,
            "mean_drift": abs(m - m0) / max(m0, 1e-9),
            "fit_loss": loss, "fit_seconds": round(fit_s, 2),
            "render_seconds": round(t_rg, 2),
            "equal_time_win": round(et_1, 3),
            "equal_time_win_amortized100": round(et_100, 3),
        })
        print(json.dumps(rows[-1]), flush=True)
    verdict = ("pays" if best_equal_time >= THRESHOLD else
               f"experimental-off-by-default (<{THRESHOLD}x equal-time win)")
    return rows, best_equal_time, verdict


def main(argv=None) -> int:
    from ..core.config import MaxDepthParams
    from .scenes import slot_scene

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, default=10)
    ap.add_argument("--spp", type=int, default=6)
    ap.add_argument("--out", default="GUIDING_STUDY_torch.json")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = device_of(args.device)
    scene, cam = slot_scene(device=dev)
    rows, best, verdict = study(scene, cam, MaxDepthParams(max_depth=3), args.seeds, args.spp,
                                SCHEDULES)
    Path(args.out).write_text(json.dumps(
        {"scene": "slot", "render_spp": args.spp, "n_seeds": args.seeds,
         "metric": "mean per-pixel seed-to-seed variance",
         "equal_time_threshold": THRESHOLD, "best_equal_time_win": best,
         "verdict": verdict, "rows": rows}, indent=1))
    print(json.dumps({"verdict": verdict, "best_equal_time_win": round(best, 3)}))
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
