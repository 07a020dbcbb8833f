"""Measure the deep-bounce compaction win (port of
scripts/compaction_sweep.py).

Times the wavefront path tracer (models/wavefront.render) at high depth
under three policies, no sort, sorted, and sorted plus live-prefix
compacted, and the volume path tracer (models/volume_pt.render) plain and
compacted, on cornell and on the reference's medium-cbox.xml (cornell where
that file is absent; REFERENCE_XML_DIR in scripts/__init__.py), where
Russian roulette makes the live fraction collapse (analyze_rays). Times are
the best of a few fenced calls after a warm one.

Prints one line per config and a summary dict; --json FILE writes it.

  python -m cuda_pt_torch.scripts.compaction_sweep [--res 128] [--spp 2]
      [--wf-depth 12] [--vpt-depth 10] [--json out.json] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import time

from ..utils.timing import device_of, force
from . import add_device_arg, reference_xml


def _time(fn, *args, repeats: int = 2) -> tuple:
    """(best seconds of fn(*args) over repeats fenced calls after one
    warm-up call, the last call's output)."""
    out = fn(*args)
    force(out)
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = fn(*args)
        force(out)
        best = min(best, time.perf_counter() - t0)
    return best, out


def sweep(res: int, spp: int, wf_depth: int, vpt_depth: int, device=None,
          images: dict | None = None) -> dict:
    """{config: best seconds} of the five configurations; images (a dict):
    filled with each configuration's image."""
    import torch

    from ..core.config import MaxDepthParams
    from ..models import volume_pt, wavefront
    from ..scene import testscenes

    dev = torch.device(device or "cpu")
    scene, cam, _ = testscenes.cornell_box(width=res, height=res, device=dev)
    md = MaxDepthParams(max_depth=wf_depth)
    results = {}
    images = {} if images is None else images

    def timed(key, fn, arg):
        best, images[key] = _time(fn, arg)
        results[key] = round(best, 3)

    def wf(key, sort_rays, compact):
        timed(key, lambda s: wavefront.render(s, cam, md, spp=spp, seed=0, sort_rays=sort_rays,
                                              compact=compact), scene)

    with torch.no_grad():
        wf(f"wf_depth{wf_depth}_nosort", False, False)
        wf(f"wf_depth{wf_depth}_sorted", True, False)
        wf(f"wf_depth{wf_depth}_compact", True, True)

        ref_xml = reference_xml("medium-cbox.xml", required=False)
        if ref_xml is not None:
            from ..scene import types as T
            from ..scene.xml_parser import load_xml

            ps = load_xml(ref_xml, override_res=(res, res))
            vscene, vcam = T.to_device(ps.scene, dev), ps.camera.to(dev)
        else:  # the built-in cornell box (a surface-only VPT run)
            vscene, vcam, _ = testscenes.cornell_box(width=res, height=res, device=dev)
        vmd = MaxDepthParams(max_depth=vpt_depth, max_volume=vpt_depth)

        def vpt(key, compact):
            timed(key, lambda s: volume_pt.render(s, vcam, vmd, spp=spp, seed=0,
                                                  compact=compact), vscene)

        vpt(f"vpt_depth{vpt_depth}_plain", False)
        vpt(f"vpt_depth{vpt_depth}_compact", True)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--res", type=int, default=128)
    ap.add_argument("--spp", type=int, default=2)
    ap.add_argument("--wf-depth", type=int, default=12)
    ap.add_argument("--vpt-depth", type=int, default=10)
    ap.add_argument("--json", default=None)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = device_of(args.device)
    results = sweep(args.res, args.spp, args.wf_depth, args.vpt_depth, dev)
    for k, v in results.items():
        print(k, v)
    print(json.dumps(results))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
