"""Probe kernel K6 (the split driver's closest walk and hit resolve),
kernel S2 (the tile-vote node walk), kernel S1 (the node step) and kernel
S3's gather on one CUDA card, for this tree's library, build variants of
it and another tree's library.

    python3 tools/split_probe.py [--parent TREE] [--variants K6_THREADS=256,S2_PREFETCH=2]
                                 [--s2] [--s1] [--s3] [--no-k6] [--grid-n 256]

Builds, all nvcc started at once, this tree's library, one library per
variant and, with ``--parent``, the library of another checkout (a git
archive unpacked under the git-ignored build/). A variant is a list of
NAME=VALUE joined by "+", each a change to a copy of ``cuda_pt_torch/``
under build/split_probe/ (PATCHES): ``K6_THREADS`` the traverse kernel's
block size, ``S2_MAX_CLUSTER`` the largest cluster an S2 tile spreads
over, ``S2_PREFETCH`` S2's successor prefetch for every form (v1 keeps
its own under 2), ``S2_RAYS_SMEM`` 1 / 0 S2's rays in shared memory or in
registers at 8 lanes per thread for every form (see csrc/extract_ab.cu).
S1's step is written out from its parts (S1_PARTS, the defaults giving
csrc/node_bench.cu's step): ``S1_LOADS`` 3 / 2 (2: no count load, the move
ptr + 1 on any box hit, the walk's where each leaf's skip is its slot + 1
as in pack_nodes' rows), ``S1_LEAF`` int / f32 (the leaf test on the
converted count or on the float), ``S1_SKIP`` int / add (the skip by a
conversion or by adding 2^23 and taking the bits), ``S1_ACC`` select /
pred (acc += tn under the box predicate), ``S1_MINMAX`` both / axis (a
diagnostic: each axis' near and far times taken as if the direction were
positive, not the walk, so its outputs are not compared); ``S1_THREADS``
its block size, ``S1_UNROLL`` an unroll pragma on its step loop;
``S3_ROW`` smem stages the row in shared memory for S3's gather (the
kernel keeps it in registers). A variant's library holds only the
translation units its changes touch. Prints each library's ptxas
registers and spills of the traverse, S2, S1 and S3 gather kernels.

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
compared bit for bit.

S1 (``--s1``): on kitchen_stress's and cornell's binary f32 rows,
chip_smoke's S1_RAYS equal rays x S1_ITERS steps and BLOCK random rays,
outputs compared bit for bit; ms and c_node (chip_smoke.s1_c_node) per
library, in turns. S3 (``--s3``): the gather at (64, 128) and (8192, 128),
outputs compared bit for bit, warm and cold (L2 flushed) per library in
turns, and the empty kernel on the gather's grid where the library has
it. Each mode runs on the libraries that hold its kernel. Prints one JSON
line at the end.
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


# S1's loop body in csrc/node_bench.cu, replaced by S1_STEP with the parts
S1_BODY = """\
        K1Node nd = k1_node<false>(nodes, ptr);
        float tx0 = (nd.lo[0] - o[0]) * inv[0];
        float tx1 = (nd.hi[0] - o[0]) * inv[0];
        float ty0 = (nd.lo[1] - o[1]) * inv[1];
        float ty1 = (nd.hi[1] - o[1]) * inv[1];
        float tz0 = (nd.lo[2] - o[2]) * inv[2];
        float tz1 = (nd.hi[2] - o[2]) * inv[2];
        float tn = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)), fminf(tz0, tz1));
        float tf = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)), fmaxf(tz0, tz1));
        bool box = (tn <= tf) && (tf > HIT_EPS) && (tn < 1e30f);
        int next = (box && nd.cnt <= 0) ? ptr + 1 : nd.skip;
        ptr = next >= m_pad ? 0 : next;
        acc = acc + (box ? tn : 0.0f);
"""
S1_STEP = """\
        const float4* p = reinterpret_cast<const float4*>(nodes + (size_t)ptr * SLOT_F);
        float4 a = __ldg(p);
        float4 b = __ldg(p + 1);
{load_c}        float tx0 = (a.x - o[0]) * inv[0];
        float tx1 = (a.w - o[0]) * inv[0];
        float ty0 = (a.y - o[1]) * inv[1];
        float ty1 = (b.x - o[1]) * inv[1];
        float tz0 = (a.z - o[2]) * inv[2];
        float tz1 = (b.y - o[2]) * inv[2];
{minmax}
        bool box = (tn <= tf) && (tf > HIT_EPS) && (tn < 1e30f);
        int next = {move};
        ptr = next >= m_pad ? 0 : next;
        {acc}
"""
S1_PARTS = {"S1_LOADS": ("3", "2"), "S1_LEAF": ("int", "f32"), "S1_SKIP": ("int", "add"),
            "S1_ACC": ("select", "pred"), "S1_MINMAX": ("both", "axis")}
# changes whose outputs are not the walk's: timed, not compared
DIAGNOSTIC = {"S1_MINMAX=axis"}
PATCHES.update({
    "S1_THREADS": [("node_bench.cu", "__launch_bounds__(128)", "__launch_bounds__({v})"),
                   ("node_bench.cu", "int threads = 128;", "int threads = {v};")],
    "S1_UNROLL": ("node_bench.cu", "    for (int it = 0; it < n_iters; ++it) {\n",
                  "#pragma unroll {v}\n    for (int it = 0; it < n_iters; ++it) {\n"),
    "S3_ROW": [("lanegather.cu", """\
    int lane = threadIdx.x & 31;
    float r0 = __ldg(row + lane), r1 = __ldg(row + lane + 32), r2 = __ldg(row + lane + 64),
          r3 = __ldg(row + lane + 96);
""", """\
    __shared__ float srow[S3_ROW];
    if (threadIdx.x < S3_ROW) srow[threadIdx.x] = __ldg(row + threadIdx.x);
    __syncthreads();
"""), ("lanegather.cu", """\
    v.x = s3_pick(r0, r1, r2, r3, id.x);
    v.y = s3_pick(r0, r1, r2, r3, id.y);
    v.z = s3_pick(r0, r1, r2, r3, id.z);
    v.w = s3_pick(r0, r1, r2, r3, id.w);
""", """\
    v.x = srow[id.x & (S3_ROW - 1)];
    v.y = srow[id.y & (S3_ROW - 1)];
    v.z = srow[id.z & (S3_ROW - 1)];
    v.w = srow[id.w & (S3_ROW - 1)];
""")],
})


def s1_step(parts: dict) -> str:
    """S1's loop body from its parts (S1_PARTS; the first value of each is
    csrc/node_bench.cu's)."""
    skip = "(int)b.z" if parts["S1_SKIP"] == "int" else \
        "(__float_as_int(b.z + 8388608.0f) - 0x4B000000)"
    leaf = "(int)c.x <= 0" if parts["S1_LEAF"] == "int" else "c.x <= 0.0f"
    three = parts["S1_LOADS"] == "3"
    minmax = ("        float tn = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)), fminf(tz0, tz1));\n"
              "        float tf = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)), fmaxf(tz0, tz1));")
    if parts["S1_MINMAX"] == "axis":
        minmax = ("        float tn = fmaxf(fmaxf(tx0, ty0), tz0);\n"
                  "        float tf = fminf(fminf(tx1, ty1), tz1);")
    return S1_STEP.format(
        load_c="        float4 c = __ldg(p + 2);\n" if three else "", minmax=minmax,
        move=f"(box && {leaf}) ? ptr + 1 : {skip}" if three else f"box ? ptr + 1 : {skip}",
        acc="acc = acc + (box ? tn : 0.0f);" if parts["S1_ACC"] == "select" else
            "if (box) acc += tn;")


def log(msg):
    print(msg, flush=True)


def variant_tree(variant: str) -> str:
    """A copy of cuda_pt_torch/ with the variant's changes applied and only
    the translation units they touch."""
    tree = os.path.join(VARIANT_DIR, variant.replace("=", "_").replace("+", "-"))
    shutil.rmtree(tree, ignore_errors=True)
    shutil.copytree(os.path.join(REPO, "cuda_pt_torch"), os.path.join(tree, "cuda_pt_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    changes, parts = [], {}
    for change in variant.split("+"):
        name, value = change.split("=")
        if name in S1_PARTS:
            if value not in S1_PARTS[name]:
                raise SystemExit(f"split_probe: {name} takes {S1_PARTS[name]}")
            parts[name] = value
            continue
        patch = PATCHES[name]
        changes += [(name, src, old, new.replace("{v}", value))
                    for src, old, new in (patch if isinstance(patch, list) else [patch])]
    if parts:
        full = {k: parts.get(k, v[0]) for k, v in S1_PARTS.items()}
        changes.append(("S1 step", "node_bench.cu", S1_BODY, s1_step(full)))
    csrc = os.path.join(tree, "cuda_pt_torch", "csrc")
    for name, src, old, new in changes:
        path = os.path.join(csrc, src)
        with open(path) as f:
            text = f.read()
        if text.count(old) != 1:
            raise SystemExit(f"split_probe: {name}: {src} no longer holds {old.strip()!r}")
        with open(path, "w") as f:
            f.write(text.replace(old, new))
    touched = {src for _, src, _, _ in changes}
    for unit in os.listdir(csrc):
        if unit.endswith(".cu") and unit not in touched:
            os.remove(os.path.join(csrc, unit))
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
                                 "extract_ab_kernel<4,4,", "node_bench_kernel",
                                 "gather_kernel")):
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


def diagnostic(variant: str) -> bool:
    return any(change in variant.split("+") for change in DIAGNOSTIC)


def rounded(row: dict, digits: int) -> dict:
    return {str(k): {q: round(x, digits) for q, x in v.items()} for k, v in row.items()}


def holding(libs, entry: str) -> list:
    """The names of the libraries that export a C entry."""
    return [n for n, path in libs.items() if hasattr(cb.open_library(path), entry)]


def probe_s1(libs) -> dict:
    """S1 on both scenes' rows, each library in turns: outputs against the
    first library's (DIAGNOSTIC variants timed only), ms and c_node."""
    from cuda_pt_torch.ops import extract_ab as ab

    dev = torch.device("cuda")
    names = holding(libs, "s1_node_bench")
    o, d = nb.reference_rays(cs.S1_RAYS, dev)
    rows = {}
    for label in ("kitchen", "cornell"):
        nodes = ab.scene_nodes(label, dev)
        rs = np.random.default_rng(29)
        lo = nodes[0, 0:3].cpu().numpy()
        hi = nodes[0, 3:6].cpu().numpy()
        o_r = torch.as_tensor(rs.uniform(lo, hi, (cs.BLOCK, 3)).astype(np.float32), device=dev)
        d_r = torch.nn.functional.normalize(torch.as_tensor(
            rs.normal(size=(cs.BLOCK, 3)).astype(np.float32), device=dev), dim=1).contiguous()
        rows[label] = (nodes, o_r, d_r)
    first, differ = {}, {n: 0 for n in names}
    res = {n: [] for n in names}
    for name in names + names[::-1]:
        cb.use_library(libs[name])
        row = {}
        for label, (nodes, o_r, d_r) in rows.items():
            outs = (nb.node_bench(nodes, o, d, cs.S1_ITERS),
                    nb.node_bench(nodes, o_r, d_r, cs.S1_ITERS))
            first.setdefault(label, outs)
            if not diagnostic(name):
                differ[name] += sum(cs.bit_differ(a, b) for a, b in zip(outs, first[label]))
            run = lambda: nb.node_bench(nodes, o, d, cs.S1_ITERS)  # noqa: E731
            row[label] = {"ms": timing.events_ms(run, REPS),
                          "c_node_us": cs.s1_c_node(nb, nodes, o, d)}
        res[name].append(row)
        log(f"  S1 {name}: {json.dumps(rounded(row, 4))}; "
            + ("a diagnostic, not compared" if diagnostic(name) else
               f"rays differing from {names[0]}: {differ[name]}"))
    mean = {n: {label: float(np.mean([r[label]["ms"] for r in res[n]])) for label in rows}
            for n in names}
    return {"runs": res, "mean_ms": mean, "differ": differ}


def probe_s3(libs) -> dict:
    """S3's gather at (64, 128) and (8192, 128), each library in turns:
    outputs against the first library's, warm and cold ms, and the empty
    kernel on the gather's grid where the library has it (kind 5)."""
    from cuda_pt_torch.ops import lanegather as lg

    dev = torch.device("cuda")
    names = holding(libs, "s3_lanegather")
    flush = timing.flush_buffer(dev)
    inputs = {rows: lg.make_inputs(0, rows, dev)[1:] for rows in (lg.ROWS, 8192)}
    first, differ = {}, {n: 0 for n in names}
    res = {n: [] for n in names}
    for name in names + names[::-1]:
        cb.use_library(libs[name])
        row = {}
        for rows, (r, idx) in inputs.items():
            g = lg.gather(r, idx)
            first.setdefault(rows, g)
            differ[name] += cs.bit_differ(g, first[rows])
            gather = lambda: lg.gather(r, idx)  # noqa: E731
            row[rows] = {"warm": timing.events_ms(gather, REPS),
                         "cold": timing.events_ms(gather, REPS, flush=flush)}
            if name != "parent":
                row[rows]["floor"] = timing.events_ms(lambda: lg.empty_launch(r, idx), REPS)
        res[name].append(row)
        log(f"  S3 {name}: {json.dumps(rounded(row, 6))}"
            f"; lanes differing from {names[0]}: {differ[name]}")
    return {"runs": res, "differ": differ}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", default=None)
    ap.add_argument("--variants", default="")
    ap.add_argument("--s2", action="store_true", help="also probe S2")
    ap.add_argument("--s1", action="store_true", help="also probe S1")
    ap.add_argument("--s3", action="store_true", help="also probe S3's gather")
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
    if args.s1:
        out["s1"] = probe_s1(libs)
    if args.s3:
        out["s3"] = probe_s3(libs)
    print(json.dumps(out), flush=True)
    if any(any(out.get(k, {}).get("differ", {}).values()) for k in ("k6", "s2", "s1", "s3")):
        raise SystemExit("outputs differ between libraries")


if __name__ == "__main__":
    main()
