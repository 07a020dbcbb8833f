"""SBVH duplicate-reference budget sweep (port of
scripts/sbvh_budget_sweep.py).

The spatial-split builder (the native SBVH, accel/native.py) takes a dup
budget: extra prim references as a fraction of the original count. More
duplication buys tighter leaves at the cost of memory and a larger
prim-test pool. Per scene and per budget this measures the emitted refs
and nodes, the SAH cost, the mean per-ray node and prim tests on 128x128
camera primaries (accel/traverse.closest_hit_bvh(count_cost=True), the
skip walk) and the walk's best wall ms of three fenced calls.

  python -m cuda_pt_torch.scripts.sbvh_budget_sweep [--device cpu] [xml ...]

Without XMLs it sweeps the reference's whiskey.xml and bunny.xml
(REFERENCE_XML_DIR in scripts/__init__.py), stopping where one is absent.
Writes SBVH_BUDGET_torch.json in the current directory.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import torch

from ..utils.timing import device_of, force
from . import add_device_arg, reference_xml

BUDGETS = [0.0, 0.1, 0.3, 0.5, 1.0, 2.0]
DEFAULT_XMLS = ["whiskey.xml", "bunny.xml"]
OUT = "SBVH_BUDGET_torch.json"


def measure(xml_path: str, device=None, budgets=BUDGETS) -> list:
    """One row per budget; each row is printed as it is made."""
    from ..accel import bvh_build, traverse
    from ..core import camera as cam_mod
    from ..core import rng as prng
    from ..scene.xml_parser import load_xml

    dev = torch.device(device or "cpu")
    rows = []
    for budget in budgets:
        ps = load_xml(xml_path, override_res=(128, 128))
        cfg = dataclasses.replace(ps.config.bvh, use_sbvh=True, dup_budget_frac=budget)
        scene = ps.builder.compile(bvh_cfg=cfg, device=dev)
        bvh = scene.bvh
        nodes = {k: getattr(bvh, k).cpu().numpy()
                 for k in ("node_min", "node_max", "node_skip", "node_base", "node_count")}
        sah = float(bvh_build.sah_cost(nodes))
        lane = torch.arange(128 * 128, device=dev)
        o, d, _ = cam_mod.generate_rays(ps.camera.to(dev), lane, prng.seed(3, lane))

        def walk():
            return traverse.closest_hit_bvh(scene.geom, bvh, o, d, count_cost=True)

        with torch.no_grad():
            r = walk()
            force(r)
            ts = []
            for _ in range(3):
                t0 = time.perf_counter()
                force(walk())
                ts.append(time.perf_counter() - t0)
        rows.append({
            "budget": budget,
            "refs": int(scene.geom.num_prims),
            "nodes": int(bvh.num_nodes),
            "sah": round(sah, 2),
            "mean_node_tests": round(float(r["node_cnt"].float().mean()), 1),
            "mean_prim_tests": round(float(r["prim_cnt"].float().mean()), 2),
            "ms": round(min(ts) * 1e3, 1),
        })
        print(json.dumps({"scene": os.path.basename(xml_path), **rows[-1]}), flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("xmls", nargs="*")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = device_of(args.device)
    xmls = args.xmls or [reference_xml(x) for x in DEFAULT_XMLS]
    out = {os.path.basename(x): measure(x, dev) for x in xmls}
    with open(OUT, "w") as fh:
        json.dump(out, fh, indent=1)
    print(f"wrote {OUT}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
