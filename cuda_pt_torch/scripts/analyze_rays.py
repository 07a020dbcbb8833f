"""Measure the active-ray fraction per bounce (port of
scripts/analyze_rays.py; the reference plots hardcoded measurements,
scripts/valid_ray_ratio.py:23-55).

Steps the path tracer's bounce (models/path_tracer.pt_bounce, the scene's
walk: the skip walk above 64 prims, else the brute force) eagerly over
camera rays and counts live lanes after each bounce; prints the table and,
with --plot, a matplotlib plot (imported only then).

  python -m cuda_pt_torch.scripts.analyze_rays --xml scene.xml [--res 128]
      [--spp 4] [--max-depth 16] [--plot decay.png] [--device cpu]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..utils.timing import device_of
from . import add_device_arg


def measure(xml: str, res: int, spp: int, max_depth: int, seed: int = 0,
            device=None) -> np.ndarray:
    """Mean active fraction after each of max_depth bounces, over spp
    passes of res x res camera rays (pass s on pcg streams seeded
    seed + 9781 * s)."""
    from ..core import camera as cam_mod
    from ..core import rng as prng
    from ..core.config import MaxDepthParams
    from ..models import path_tracer as pt
    from ..scene import types as T
    from ..scene.xml_parser import load_xml

    ps = load_xml(xml, override_res=(res, res))
    dev = torch.device(device or "cpu")
    scene = T.to_device(ps.scene, dev)
    cam = ps.camera.to(dev)
    md = MaxDepthParams(max_depth=max_depth, max_diffuse=max_depth, max_specular=max_depth,
                        max_transmit=max_depth)
    use_bvh = scene.geom.num_prims > pt.BRUTE_FORCE_MAX_PRIMS
    lane = torch.arange(cam.width * cam.height, device=dev)
    fractions = []
    with torch.no_grad():
        for s_idx in range(spp):
            rng = prng.seed(seed + 9781 * s_idx, lane)
            o, d, rng = cam_mod.generate_rays(cam, lane, rng)
            state = pt.init_state(o, d, rng)
            fr = []
            for _ in range(max_depth):
                state = pt.pt_bounce(scene, md, state, use_bvh=use_bvh)
                fr.append(float(state.active.float().mean()))
            fractions.append(fr)
    return np.asarray(fractions).mean(axis=0)


def _pyplot():
    try:
        import matplotlib
    except ImportError as e:
        raise SystemExit(f"--plot needs matplotlib, which is not installed ({e})") from None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--xml", required=True)
    ap.add_argument("--res", type=int, default=128)
    ap.add_argument("--spp", type=int, default=4)
    ap.add_argument("--max-depth", type=int, default=16)
    ap.add_argument("--plot", default="")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = device_of(args.device)
    plt = _pyplot() if args.plot else None
    fr = measure(args.xml, args.res, args.spp, args.max_depth, device=dev)
    print(json.dumps({"active_fraction_per_bounce": [round(float(x), 4) for x in fr]}))
    if plt is not None:
        plt.plot(range(1, len(fr) + 1), fr, marker="o")
        plt.xlabel("bounce")
        plt.ylabel("active-ray fraction")
        plt.grid(True)
        plt.savefig(args.plot, dpi=120)
        print(f"wrote {args.plot}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
