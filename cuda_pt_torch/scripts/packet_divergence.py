"""Measure packet-traversal divergence economics (port of
scripts/packet_divergence.py).

Kernel K1's packet form (ops/traverse_kernel.traverse_forest with
count_iters=True: one block per tile of TILE = 512 rays) descends into a
node when ANY of its rays hits the node's box, so an incoherent packet
devolves toward a full-tree walk. The sort-before-trace design (the
wavefront's Morton keys, ops/morton.py) rests on this being worth paying
for; this tool measures it.

Work metrics (algorithmic, the same on every device):
  packet:  the sum over ray tiles of node fetches (K1's tile_iters); each
           fetch slab-tests one node against all TILE lanes, so lane work
           = fetches * TILE.
  per-ray: the sum over rays of per-lane node tests of the skip walk
           (accel/traverse.closest_hit_bvh(count_cost=True)).
Ray populations: jittered camera primaries and one-bounce cosine-scattered
secondaries, each traced in lane orders scanline, shuffled, Morton-sorted
after the shuffle, and Morton with the direction octant above it, and at
tiles of 256 and 128 in the last order.

  python -m cuda_pt_torch.scripts.packet_divergence
      [--scene cornell|whiskey|both] [--res 64] [--json out.json] [--device cpu]

whiskey is the reference's whiskey.xml (REFERENCE_XML_DIR in
scripts/__init__.py); the tool stops naming the path where it is absent.
On the card K1's packet form runs; on the CPU its plain version.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..ops.traverse_kernel import TILE
from ..utils.timing import device_of
from . import add_device_arg, reference_xml


def make_rays(scene, cam, seed: int):
    """((primary o, d), (secondary o, d) at the primary hit points)."""
    from ..accel.traverse import closest_hit_bvh
    from ..core import camera as cam_mod
    from ..core import rng as prng
    from ..core import sampling
    from ..core.math import normalize, to_world
    from ..ops import intersect as isect

    dev = scene.device
    lane = torch.arange(int(cam.width) * int(cam.height), device=dev)
    state = prng.seed(seed, lane)
    o, d, state = cam_mod.generate_rays(cam, lane, state)
    hit = closest_hit_bvh(scene.geom, scene.bvh, o, d, max_leaf=int(scene.bvh.max_leaf))
    prim = torch.clamp(hit["prim"], 0, scene.geom.num_prims - 1)
    t = torch.where(hit["hit"], hit["t"], 1.0)
    p_hit = o + t[:, None] * d
    inter = isect.surface_interaction(scene.geom, prim, hit["b1"], hit["b2"], p_hit, d)
    n = inter["n_s"]
    n = torch.where(torch.sum(n * d, dim=-1, keepdim=True) > 0, -n, n)
    u, state = prng.next2d(state)
    local, _ = sampling.cosine_hemisphere(u)
    d2 = normalize(to_world(local, n))
    o2 = p_hit + 1e-3 * n
    # lanes that missed: re-aimed into the scene so that every lane traces
    o2 = torch.where(hit["hit"][:, None], o2, o)
    d2 = torch.where(hit["hit"][:, None], d2, d)
    return (o, d), (o2, d2)


def packet_fetches(forest, o, d, order, tile=None) -> int:
    from ..ops import traverse_kernel as tk

    res = tk.traverse_forest(forest, o[order], d[order], count_iters=True, tile=tile or TILE)
    return int(res["tile_iters"].sum())


def perlane_tests(scene, o, d):
    """(total per-lane node tests, lockstep loop iterations): the skip walk
    runs until every lane ends and gathers node data for every lane each
    iteration, so its work is max(per-lane visits) * B gathers."""
    from ..accel.traverse import closest_hit_bvh

    res = closest_hit_bvh(scene.geom, scene.bvh, o, d, max_leaf=int(scene.bvh.max_leaf),
                          count_cost=True)
    return int(res["node_cnt"].sum()), int(res["node_cnt"].max())


def lane_orders(scene, o, d, rng: np.random.Generator) -> dict:
    """The lane orders (index tensors): scanline, shuffled, Morton-sorted
    after the shuffle, and Morton under a 3-bit direction octant."""
    from ..ops import morton

    B = o.shape[0]
    dev = o.device
    shuf = torch.as_tensor(rng.permutation(B), device=dev)
    code = morton.morton3d(o[shuf], scene.bvh.node_min[0], scene.bvh.node_max[0])
    # direction-aware key: packets agree on both footprint and heading; the
    # 3-bit octant above the top 29 Morton bits fits 32 bits
    octant = ((d[shuf, 0] > 0).to(torch.int64) << 2 | (d[shuf, 1] > 0).to(torch.int64) << 1
              | (d[shuf, 2] > 0).to(torch.int64))
    code_od = (octant << 29) | (code >> 1)
    return {"scanline": torch.arange(B, device=dev), "shuffled": shuf,
            "morton": shuf[torch.argsort(code, stable=True)],
            "morton_octant": shuf[torch.argsort(code_od, stable=True)]}


def measure(name, scene, cam, forest, rays, rng: np.random.Generator) -> dict:
    o, d = rays
    B = o.shape[0]
    orders = lane_orders(scene, o, d, rng)
    with torch.no_grad():
        fetches = {k: packet_fetches(forest, o, d, idx) for k, idx in orders.items()}
        # the packet-size lever at the best ordering
        for tile in (256, 128):
            fetches[f"morton_octant_tile{tile}"] = packet_fetches(
                forest, o, d, orders["morton_octant"], tile=tile)
        lane_tests, loop_iters = perlane_tests(scene, o, d)
    row = {
        "case": name,
        "rays": int(B),
        "tiles": -(-int(B) // TILE),
        "packet_node_fetches": fetches,
        "packet_lane_work": {
            k: v * (128 if k.endswith("tile128") else 256 if k.endswith("tile256") else TILE)
            for k, v in fetches.items()},
        "xla_perlane_node_tests": lane_tests,
        "xla_loop_iters": loop_iters,
        "xla_lane_gather_work": loop_iters * int(B),
        "shuffle_blowup": round(fetches["shuffled"] / max(fetches["scanline"], 1), 2),
        "morton_recovery": round(fetches["morton"] / max(fetches["shuffled"], 1), 3),
    }
    print(json.dumps(row), flush=True)
    return row


def load_scene(which: str, res: int, device=None):
    """(scene, camera, K1 forest) of cornell or the reference's whiskey."""
    from ..ops import traverse_kernel as tk

    dev = torch.device(device or "cpu")
    if which == "cornell":
        from ..scene import testscenes

        scene, cam, _ = testscenes.cornell_box(width=res, height=res, device=dev)
        chunk = 65536
    else:
        from ..scene import types as T
        from ..scene.xml_parser import load_xml

        ps = load_xml(reference_xml("whiskey.xml"), override_res=(res, res))
        scene, cam = T.to_device(ps.scene, dev), ps.camera.to(dev)
        chunk = 32768
    forest = tk.build_forest(scene.geom, chunk_prims=chunk, device=dev)
    return scene, cam, forest


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scene", default="both", choices=["cornell", "whiskey", "both"])
    ap.add_argument("--res", type=int, default=64)
    ap.add_argument("--json", default=None)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = device_of(args.device)
    names = ["cornell", "whiskey"] if args.scene == "both" else [args.scene]
    rng = np.random.default_rng(7)
    rows = []
    for nm in names:
        scene, cam, forest = load_scene(nm, args.res, dev)
        with torch.no_grad():
            primary, secondary = make_rays(scene, cam, seed=3)
        rows.append(measure(f"{nm}_primary", scene, cam, forest, primary, rng))
        rows.append(measure(f"{nm}_secondary", scene, cam, forest, secondary, rng))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
