"""Probe the refill policy of the persistent whole-path kernel (K2) and
its staged tables on one CUDA card, against another tree's kernels.

    python3 tools/refill_probe.py [--parent TREE] [--variants 32:1,16:1,32:0]

Builds, all nvcc started at once, one library per variant BELOW:STAGE
(csrc/trace.cuh: a warp hands out new paths once fewer than BELOW of its
lanes hold one, ``K2_REFILL_BELOW``; STAGE 0 builds with
``MK_STAGE_BYTES`` 0, so no pack stages its tables in shared memory) and,
with ``--parent``, the library of another checkout (a git archive of the
parent commit unpacked under the git-ignored build/). Then, for each
library in turns (forward, then backward):

- K2 on cornell_box 1024x1024, one spp of Z-order camera rays, w8 nodes
  with f32 tables (the Renderer's pack; K2, staged where STAGE is 1) and
  binary f32 nodes (make_pack's; K2+BIN, never staged): ms per launch
  (utils/timing.events_ms, the median of 10);
- K1 (csrc/traverse.cu) on full-size kitchen_stress's two-chunk f32
  forest: closest and any hit on its 1,048,576 camera rays (row order),
  and the summed time of the K1 calls of one WAVEFRONT_PT spp (traversal
  "pallas"), captured once from wavefront.render_sample and replayed,
  each call after a device sleep.

Every library's outputs are compared bit for bit with the first one's (L,
hits, occlusion): the lanes that differ are printed and must be 0. Before
the timings it prints, from the stats planes, per-warp figures of the walk
work: for each launch, the mean over 32-lane groups (in launch order) of
the group's largest and mean node fetches per lane, and their ratio (the
lane use a warp that waits for its longest walk reaches). Prints one JSON
line at the end.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from cuda_pt_torch.core import camera as cam_mod  # noqa: E402
from cuda_pt_torch.core import qmc  # noqa: E402
from cuda_pt_torch.core.config import MaxDepthParams  # noqa: E402
from cuda_pt_torch.ops import cuda_build as cb  # noqa: E402
from cuda_pt_torch.ops import megakernel as mk  # noqa: E402
from cuda_pt_torch.ops import traverse_kernel as tk  # noqa: E402
from cuda_pt_torch.scene import testscenes as tts  # noqa: E402
from cuda_pt_torch.utils import timing  # noqa: E402

SIZE = 1024
FOREST_CHUNK = 65536


def log(msg):
    print(msg, flush=True)


def build_libraries(variants, parent):
    """{name: library path}: every build started before any is waited on."""
    started = {}
    for v in variants:
        below, stage = v.split(":")
        flags = [f for f in cb._flags() if not f.startswith("-DMK_STAGE_BYTES=")]
        flags += [f"-DK2_REFILL_BELOW={below}",
                  f"-DMK_STAGE_BYTES={cb.MK_STAGE_BYTES if stage == '1' else 0}"]
        started[f"below{below}_stage{stage}"] = cb.start_build(flags)
    tree = cb.start_tree_build(parent) if parent else None
    t0 = time.perf_counter()
    libs = {}
    if tree is not None:
        libs["parent"] = cb.finish_tree_build(tree)
    for name, (proc, path) in started.items():
        libs[name] = cb.finish_build(proc, path)
    log(f"built {len(libs)} libraries in {time.perf_counter() - t0:.1f} s")
    from tools import sass_ops

    for name, path in libs.items():
        for kname, regs, st, ld in cb.ptxas_report(cb.build_log(path)):
            if kname.startswith(("trace_kernel<0,0,0,", "k1_kernel<0,0")):
                log(f"  {name} {kname}: {regs} registers, spill stores {st} B, loads {ld} B")
        # the loads of the pruned K2 builds (K2 on cornell), by kind
        for fn, ops in sass_ops.opcodes(path, ["trace_kernelILb0ELb0ELb0ELb0ELb0E"]).items():
            log(f"  {name} {fn} loads: " + ", ".join(
                f"{op} {n}" for op, n in sorted(ops.items()) if op.startswith("LD")))
    return libs


def warp_figures(stats: torch.Tensor) -> dict:
    """Per 32-lane group of a launch's stats plane (node fetches per lane):
    the mean of the groups' largest and mean fetches, and their ratio."""
    f = stats[:, 0].double()
    pad = (-f.numel()) % 32
    g = torch.cat([f, f.new_zeros(pad)]).view(-1, 32)
    n = torch.cat([torch.ones_like(f), f.new_zeros(pad)]).view(-1, 32).sum(1)
    mx, mean = g.max(1).values, g.sum(1) / n
    return {"warp_max": float(mx.mean()), "warp_mean": float(mean.mean()),
            "lane_use": float(mean.sum() / mx.sum())}


def capture_wavefront(scene, cam, md):
    """The K1 calls of one WAVEFRONT_PT spp: (forest, o, d, t_far,
    occlusion, max_leaf) each, cloned as they were passed."""
    from cuda_pt_torch.models import wavefront

    real, calls = tk.traverse_forest, []

    def rec(forest, o, d, t_far=None, max_leaf=4, occlusion=False, **kw):
        calls.append((forest, o.clone(), d.clone(), None if t_far is None else t_far.clone(),
                      occlusion, max_leaf))
        return real(forest, o, d, t_far, max_leaf, occlusion, **kw)

    tk.traverse_forest = rec
    try:
        wavefront.render_sample(scene, cam, md, 0, 0, compact=True)
    finally:
        tk.traverse_forest = real
    return [c for c in calls if c[1].shape[0]]


def wavefront_ms(calls) -> float:
    """Summed device ms of the captured K1 calls, each after a device sleep."""
    evs = []
    for forest, o, d, t_far, occl, ml in calls:
        torch.cuda._sleep(timing.SETTLE_CYCLES)
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        tk.traverse_forest(forest, o, d, t_far, ml, occl)
        e1.record()
        evs.append((e0, e1))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in evs)


def bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", default=None)
    ap.add_argument("--variants", default="32:1,16:1,32:0")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("refill_probe: CUDA is not available")
    dev = torch.device("cuda")
    libs = build_libraries(args.variants.split(","), args.parent)
    names = list(libs)
    md = MaxDepthParams()

    # K2 inputs: cornell, one spp of Z-order camera rays
    cscene, ccam, _ = tts.cornell_box(SIZE, SIZE, device=dev)
    packs = {"K2": mk.make_pack(cscene, node_fmt="w8"), "K2+BIN": mk.make_pack(cscene)}
    perm, _ = mk.tile_swizzle(SIZE, SIZE, dev)
    o, d, rng = cam_mod.generate_rays(ccam, perm, qmc.make_state("pcg", 0, perm, 0))
    rng = mk.rng_bits(rng)
    # K1 inputs: kitchen's forest, its camera rays, the wavefront's calls
    t0 = time.perf_counter()
    kscene, kcam, _ = tts.kitchen_stress(SIZE, SIZE, device=dev)
    forest = tk.build_forest(kscene.geom, chunk_prims=FOREST_CHUNK)
    kscene = dataclasses.replace(kscene, forest=forest, traversal="pallas")
    lane = torch.arange(SIZE * SIZE, device=dev)
    ko, kd, _ = cam_mod.generate_rays(kcam, lane, qmc.make_state("pcg", 0, lane, 0))
    ko, kd = ko.contiguous(), kd.contiguous()
    t_cam = tk.traverse_forest(forest, ko, kd)["t"]
    rs = np.random.default_rng(13)
    u = torch.as_tensor(rs.uniform(0.5, 1.5, SIZE * SIZE).astype(np.float32), device=dev)
    tf_cam = torch.where(torch.isfinite(t_cam), t_cam * u, 1e8).contiguous()
    calls = capture_wavefront(kscene, kcam, md)
    log(f"kitchen scene, forest and {len(calls)} wavefront K1 calls in "
        f"{time.perf_counter() - t0:.1f} s; lanes {[c[1].shape[0] for c in calls]}")

    # walk work per warp (the stats are the same for every library)
    figs = {}
    for label, pack in packs.items():
        _, st = mk.trace_megakernel(pack, md, o, d, rng, count_stats=True)
        figs[f"{label} cornell paths"] = warp_figures(st)
    for label, tf_, occl in (("closest", None, False), ("anyhit", tf_cam, True)):
        st = torch.zeros((SIZE * SIZE, 2), dtype=torch.int32, device=dev)
        tk.traverse_forest(forest, ko, kd, tf_, occlusion=occl, stats=st)
        figs[f"K1 camera {label}"] = warp_figures(st)
    wf = [0.0, 0.0, 0.0]
    for forest_, co, cd, ct, occl, ml in calls:
        st = torch.zeros((co.shape[0], 2), dtype=torch.int32, device=dev)
        tk.traverse_forest(forest_, co, cd, ct, ml, occl, stats=st)
        f = warp_figures(st)
        n_w = -(-co.shape[0] // 32)
        wf = [wf[0] + f["warp_max"] * n_w, wf[1] + f["warp_mean"] * n_w, wf[2] + n_w]
    figs["K1 wavefront calls"] = {"warp_max": wf[0] / wf[2], "warp_mean": wf[1] / wf[2],
                                  "lane_use": wf[1] / wf[0]}
    for k, v in figs.items():
        log(f"per warp, {k}: node fetches max {v['warp_max']:.2f}, mean {v['warp_mean']:.2f}, "
            f"lane use {v['lane_use']:.4f}")

    def run_all():
        out = {}
        for label, pack in packs.items():
            out[label] = timing.events_ms(lambda: mk.trace_megakernel(pack, md, o, d, rng), 10)
        out["K1 camera closest"] = timing.events_ms(lambda: tk.traverse_forest(forest, ko, kd), 10)
        out["K1 camera anyhit"] = timing.events_ms(
            lambda: tk.traverse_forest(forest, ko, kd, tf_cam, occlusion=True), 10)
        out["K1 wavefront"] = float(np.median([wavefront_ms(calls) for _ in range(3)]))
        return out

    def outputs():
        res = {label: mk.trace_megakernel(pack, md, o, d, rng) for label, pack in packs.items()}
        k = tk.traverse_forest(forest, ko, kd)
        res.update({f"k1_{key}": k[key] for key in ("t", "prim", "b1", "b2")})
        res["k1_occ"] = tk.traverse_forest(forest, ko, kd, tf_cam, occlusion=True)["occluded"]
        for j, (forest_, co, cd, ct, occl, ml) in enumerate(calls):
            r = tk.traverse_forest(forest_, co, cd, ct, ml, occl)
            res[f"wf{j}"] = r["occluded"] if occl else torch.stack([bits(r["t"]),
                                                                    r["prim"].int()], 1)
        torch.cuda.synchronize()
        return res

    first, times, differ = None, {n: [] for n in names}, {}
    order = names + names[::-1]
    for name in order:
        cb.use_library(libs[name])
        outs = outputs()
        if first is None:
            first = outs
        differ[name] = {}
        for key, v in outs.items():
            a, b = bits(v), bits(first[key])
            differ[name][key] = int((a != b).reshape(a.shape[0], -1).any(dim=1).sum())
        times[name].append(run_all())
        log(f"{name}: {json.dumps(times[name][-1])}; lanes differing from {order[0]}: "
            f"{sum(differ[name].values())}")
    summary = {n: {k: float(np.mean([t[k] for t in times[n]])) for k in times[n][0]}
               for n in names}
    for n in names:
        log(f"{n} mean of 2: " + ", ".join(f"{k} {v:.4f} ms" for k, v in summary[n].items()))
    print(json.dumps({"figures": figs, "times": times, "mean": summary, "differ": differ,
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    if any(sum(v.values()) for v in differ.values()):
        raise SystemExit("outputs differ between libraries")


if __name__ == "__main__":
    main()
