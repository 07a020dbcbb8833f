"""Probe kernel K6 (the split driver's closest walk and hit resolve) and
kernel S2 (the tile-vote node walk) on one CUDA card, for this tree's
library, build variants of it and another tree's library.

    python3 tools/split_probe.py [--parent TREE] [--variants K6_THREADS=256,S2_PREFETCH=2]
                                 [--s2] [--no-k6] [--grid-n 256]

Builds, all nvcc started at once, this tree's library, one library per
variant and, with ``--parent``, the library of another checkout (a git
archive unpacked under the git-ignored build/). A variant is a list of
NAME=VALUE joined by "+", each a change to a copy of ``cuda_pt_torch/``
under build/split_probe/ (PATCHES): ``K6_THREADS`` the traverse kernel's
block size, ``S2_MAX_CLUSTER`` the largest cluster an S2 tile spreads
over, ``S2_PREFETCH`` S2's successor prefetch for every form (v1 keeps
its own under 2), ``S2_RAYS_SMEM`` 1 / 0 S2's rays in shared memory or in
registers at 8 lanes per thread for every form (see csrc/extract_ab.cu).
Prints each library's ptxas registers and spills of the traverse and S2
kernels.

K6: one spp of grid_smoke 1024x1024 (a GRID_N^3 density grid) runs through
the split driver's loop on this tree's kernels and records each bounce's
live state planes (chip_smoke.split_states). Then, for each library in
turns (forward, then backward), per bounce: the walk and resolve of the
library's K6 entry, the parent's form (chip_smoke.parent_k6: its walk,
then ``ops/megakernel.resolve_hit`` in PyTorch) or this tree's
(``mk_traverse_resolve``, the resolve in the kernel), timed between CUDA
events after a device sleep (the median of REPS), the walk alone for the
parent's form; the hit planes of every library compared bit for bit with
the first one's. For the parent's form, torch.profiler's device time and
launches of resolve_hit over the spp; the pack's bytes of nodes, prims
and g_hit.

S2 (``--s2``): every tag through ``ops/extract_ab.main`` at 1 tile and 128
tiles on kitchen_stress's binary f32 rows, each library in turns, outputs
compared bit for bit. Prints one JSON line at the end.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from cuda_pt_torch.core import camera as cam_mod  # noqa: E402
from cuda_pt_torch.core import qmc  # noqa: E402
from cuda_pt_torch.core.config import MaxDepthParams  # noqa: E402
from cuda_pt_torch.ops import cuda_build as cb  # noqa: E402
from cuda_pt_torch.ops import megakernel as mk  # noqa: E402
from cuda_pt_torch.ops import node_bench as nb  # noqa: E402
from cuda_pt_torch.scene import testscenes as tts  # noqa: E402
from cuda_pt_torch.utils import timing  # noqa: E402

SIZE = 1024
REPS = 7
VARIANT_DIR = os.path.join(REPO, "build", "split_probe")
# a variant's changes: NAME -> (source under csrc/, the text it replaces,
# the new text with {v} for the value)
PATCHES = {
    "K6_THREADS": ("megakernel_split.cu", "#define K6_THREADS 128\n",
                   "#define K6_THREADS {v}\n"),
    "S2_MAX_CLUSTER": ("extract_ab.cu", "#define S2_MAX_CLUSTER 8 ", "#define S2_MAX_CLUSTER {v} "),
    "S2_PREFETCH": ("extract_ab.cu", "constexpr int s2_prefetch() {\n",
                    "constexpr int s2_prefetch() {\n    if (VARIANT != S2_V1 || {v} != 2) return {v};\n"),
    "S2_RAYS_SMEM": ("extract_ab.cu", "constexpr bool s2_rays_smem() {\n",
                     "constexpr bool s2_rays_smem() {\n    return {v} != 0;\n"),
}


def log(msg):
    print(msg, flush=True)


def variant_tree(variant: str) -> str:
    """A copy of cuda_pt_torch/ with the variant's PATCHES applied."""
    tree = os.path.join(VARIANT_DIR, variant.replace("=", "_"))
    shutil.rmtree(tree, ignore_errors=True)
    shutil.copytree(os.path.join(REPO, "cuda_pt_torch"), os.path.join(tree, "cuda_pt_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    for change in variant.split("+"):
        name, value = change.split("=")
        src, old, new = PATCHES[name]
        path = os.path.join(tree, "cuda_pt_torch", "csrc", src)
        with open(path) as f:
            text = f.read()
        if text.count(old) != 1:
            raise SystemExit(f"split_probe: {name}: {src} no longer holds {old.strip()!r}")
        with open(path, "w") as f:
            f.write(text.replace(old, new.replace("{v}", value)))
    return tree


def build_libraries(variants, parent):
    """{name: library path}, every build started before any is waited on."""
    started = {"this": cb.start_build()}
    trees = {v: cb.start_tree_build(variant_tree(v)) for v in variants}
    if parent:
        trees["parent"] = cb.start_tree_build(parent)
    libs = {name: cb.finish_tree_build(proc) for name, proc in trees.items()}
    libs["this"] = cb.finish_build(*started["this"])
    for name, path in libs.items():
        for kname, regs, st, ld in cb.ptxas_report(cb.build_log(path)):
            if kname.startswith(("traverse_kernel", "extract_ab_kernel<4,1,", "extract_ab_kernel<7,1,",
                                 "extract_ab_kernel<4,4,")):
                log(f"  {name} {kname}: {regs} registers, spill stores {st} B, loads {ld} B")
    return libs


def k6_forms(pack):
    """(walk + resolve, walk alone or None) of the loaded library's K6 entry,
    each taking a bounce's state planes."""
    if hasattr(cb.load(), "mk_traverse_resolve"):
        return (lambda st: mk.traverse_resolve(pack, st, st.shape[1])), None
    return (lambda st: cs.parent_k6(mk, pack, st, st.shape[1])), \
        (lambda st: cs.parent_walk(mk, pack, st, st.shape[1]))


def resolve_profile(pack, walk, states) -> dict:
    """Device ms and launches of resolve_hit over the recorded bounces."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    outs = [walk(st) for st in states]
    for _ in range(2):  # the first profile pays CUPTI's start-up; keep the second
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for out in outs:
                mk.resolve_hit(pack, out)
            torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return {"device_ms": sum(e.self_device_time_total for e in ev) / 1e3,
            "launches": sum(e.count for e in ev),
            "kernels": {e.key[:60]: e.count for e in ev}}


def probe_k6(libs, grid_n: int) -> dict:
    dev = torch.device("cuda")
    scene, cam, _ = tts.grid_smoke(SIZE, SIZE, n=grid_n, device=dev)
    pack = mk.make_pack(scene, node_fmt="w8", vpt=True)
    md = MaxDepthParams()
    perm, _ = mk.tile_swizzle(SIZE, SIZE, dev)
    o, d, rng = cam_mod.generate_rays(cam, perm, qmc.make_state("pcg", 0, perm, 0))
    cb.use_library(libs["this"])
    states = cs.split_states(mk, pack, md, o, d, rng)
    lanes = [st.shape[1] for st in states]
    sizes = {k: pack[k].numel() * 4 for k in ("nodes", "prims", "g_hit")}
    log(f"K6: grid_smoke, {len(states)} bounces, live lanes {lanes}; table bytes {sizes}")
    names = list(libs)
    first, times, differ, prof = None, {n: [] for n in names}, {}, {}
    for name in names + names[::-1]:
        cb.use_library(libs[name])
        full, walk = k6_forms(pack)
        outs = [full(st) for st in states]
        torch.cuda.synchronize()
        if first is None:
            first = outs
        differ[name] = sum(int((a.view(torch.int32) != b.view(torch.int32)).any(0).sum())
                           for a, b in zip(outs, first))
        row = {"full": [timing.events_ms(lambda: full(st), REPS) for st in states]}
        if walk is not None:
            row["walk"] = [timing.events_ms(lambda: walk(st), REPS) for st in states]
            if name not in prof:
                prof[name] = resolve_profile(pack, walk, states)
                log(f"  {name} resolve_hit over the spp: {prof[name]['device_ms']:.4f} ms of "
                    f"device time, {prof[name]['launches']} launches")
        times[name].append(row)
        log(f"  {name}: walk+resolve per spp {sum(row['full']):.4f} ms"
            + (f", walk alone {sum(row['walk']):.4f} ms" if walk else "")
            + f"; per launch {[round(x, 4) for x in row['full']]}; lanes differing from "
              f"{names[0]}: {differ[name]}")
    mean = {n: {k: float(np.mean([sum(r[k]) for r in times[n]])) for k in times[n][0]}
            for n in names}
    return {"lanes": lanes, "table_bytes": sizes, "times": times, "mean_per_spp": mean,
            "differ": differ, "resolve_profile": prof}


@contextlib.contextmanager
def one_block_tiles(ab):
    """ab.cluster_size 1 while a library without s2_cluster_size (built
    before the cluster form: a block per tile) is loaded."""
    real = ab.cluster_size
    if not hasattr(cb.load(), "s2_cluster_size"):
        ab.cluster_size = lambda tiles, tile=ab.TILE: 1
    try:
        yield
    finally:
        ab.cluster_size = real


def probe_s2(libs) -> dict:
    from cuda_pt_torch.ops import extract_ab as ab

    dev = torch.device("cuda")
    nodes = {"kitchen": ab.scene_nodes("kitchen", dev)}
    names = list(libs)
    res = {n: [] for n in names}
    first, differ = {}, {n: 0 for n in names}
    for name in names + names[::-1]:
        cb.use_library(libs[name])
        row = {}
        for tiles in (1, 128):
            with one_block_tiles(ab):
                rows = ab.main(["--tiles", str(tiles), "--reps", "3"], nodes=nodes)
            for r in rows:
                if "variant" in r:
                    row[f"{r['variant']}@{tiles}"] = r["c_node_ns"]
            o, d = nb.reference_rays(tiles * ab.TILE, dev)
            for tag in ab.TAGS:
                out = ab.extract_ab(tag, nodes["kitchen"], o, d, 1000)
                key = (tag, tiles)
                if key not in first:
                    first[key] = out
                differ[name] += int((out.view(torch.int32) != first[key].view(torch.int32)).sum())
        res[name].append(row)
        log(f"  S2 {name} c_node ns per step: {json.dumps({k: round(v, 1) for k, v in row.items()})}"
            f"; lanes differing from {names[0]}: {differ[name]}")
    return {"c_node_ns": res, "differ": differ}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", default=None)
    ap.add_argument("--variants", default="")
    ap.add_argument("--s2", action="store_true", help="also probe S2")
    ap.add_argument("--no-k6", action="store_true", help="leave K6 out")
    ap.add_argument("--grid-n", type=int, default=256)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("split_probe: CUDA is not available")
    log(timing.card(torch.device("cuda")))
    t0 = time.perf_counter()
    libs = build_libraries([v for v in args.variants.split(",") if v], args.parent)
    log(f"built {len(libs)} libraries in {time.perf_counter() - t0:.1f} s")
    out = {"device": torch.cuda.get_device_name(0)}
    if not args.no_k6:
        out["k6"] = probe_k6(libs, args.grid_n)
    if args.s2:
        out["s2"] = probe_s2(libs)
    print(json.dumps(out), flush=True)
    if any(out.get("k6", {}).get("differ", {}).values()) \
            or any(out.get("s2", {}).get("differ", {}).values()):
        raise SystemExit("outputs differ between libraries")


if __name__ == "__main__":
    main()
