"""Kernel S2: the node-field fetch A/B (port of the TPU micro-kernel
_make_kernel of scripts/exp_extract_ab.py, :60; pallas_call in
time_variant :232).

A tile of rays walks the binary f32 node rows (ops/traverse_kernel.
pack_nodes) with one pointer for the whole tile: per step, fetch the node,
slab-test its box on every lane (t_best fixed at 1e30), go to ptr + 1 where
any lane of the tile hit the box of an interior node and to the skip
otherwise, wrap to 0 at the rows' slot count; each lane sums tn over its box
hits. Tags (the reference's, plus v1, which its main() does not time):
  e0 e1 e2 e3      the step taken apart: the loop and pointer only; + one
                   field; + all 9 fields summed; one field as the box's three
                   minima with a vote, ptr + 1 or ptr + 2
  v0 v1 v2         the walk, with the fields fetched three ways (the
                   kernel's load forms: scalar loads, a slot staged in
                   shared memory, float4 loads); the same output per lane
  w2               v0 plus the next slot of the same row, (slot + 1) % 8,
                   whose box only adds hits
  v0_ilp2 v0_ilp4 v2_ilp2
                   2 or 4 pointers per iteration, starting at 7 k and
                   sharing acc, stepped in k order
Timed at N and N / 2 steps, (t(N) - t(N / 2)) / (N - N / 2) is the cost of
one step of the launch (c_node). On the card a tile is one block, or, where
the tiles times the cluster size fit the SMs, one thread-block cluster of
up to 8 blocks (``cluster_size``; the reference's one tile spreads over
8); the output is the same either way.

On CUDA tensors ``extract_ab`` launches the kernel (csrc/extract_ab.cu) or
raises; on CPU tensors it runs the plain version, and only there. Each
launch adds one to ``LAUNCHES["extract_ab"]`` (the package's one launch
dict, ops/traverse_kernel.LAUNCHES).

    python -m cuda_pt_torch.ops.extract_ab [--device cpu] [--scene cornell]
        [--tiles 128] [--iters N]

prints the reference's rows (c_node_ns, checksum, match_v0 per tag, and
the cluster size the launches took) on the reference's equal rays
(ops/node_bench.REF_O, REF_D) over kitchen_stress's
and cornell's rows (the reference read bunny.xml, which the repository does
not hold); the times are the card's (CUDA events), None on the CPU.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ..utils import timing
from . import cuda_build
from . import intersect as isect
from . import node_bench as nb
from . import traverse_kernel as tk

LAUNCHES = tk.LAUNCHES
LAUNCHES.setdefault("extract_ab", 0)
TILE = 8192  # the reference's tile: (1, 64, 128) lanes
ITERS = 30000  # the reference's steps per timed launch (and ITERS // 2)
T_BEST = 1e30
VARIANTS = ("e0", "e1", "e2", "e3", "v0", "v1", "v2", "w2")  # the C entry's numbering
TAGS = {**{v: (v, 1) for v in VARIANTS},
        "v0_ilp2": ("v0", 2), "v0_ilp4": ("v0", 4), "v2_ilp2": ("v2", 2)}
# the reference main()'s order, with v1 after v0
MAIN_TAGS = ("e0", "e1", "e2", "e3", "v0", "v1", "w2", "v0_ilp2", "v0_ilp4", "v2", "v2_ilp2")


def _tag(tag: str) -> tuple:
    if tag not in TAGS:
        raise ValueError(f"unknown tag {tag!r}: one of {list(TAGS)}")
    return TAGS[tag]


def _check(nodes: torch.Tensor, o: torch.Tensor, d: torch.Tensor, tile: int, n_ptr: int):
    if nodes.dtype != torch.float32 or nodes.dim() != 2 or nodes.shape[1] != 128:
        raise ValueError("expected binary f32 node rows (R, 128) float32")
    if o.dtype != torch.float32 or o.shape != d.shape or o.dim() != 2 or o.shape[1] != 3:
        raise ValueError("expected o, d (n, 3) float32")
    if tile <= 0 or tile % 128 or tile > TILE or o.shape[0] % tile or o.shape[0] == 0:
        raise ValueError(f"the tile must be a multiple of 128 up to {TILE} that divides "
                         f"the {o.shape[0]} lanes")
    if nodes.shape[0] * tk.SLOTS <= 7 * (n_ptr - 1):
        raise ValueError("too few node slots for the pointers' starts")


def _slab(lo, hi, o, inv):
    """(tn, tf) of boxes lo, hi (T, 1, 3) on lanes o, inv (T, tile, 3), in
    the kernel's order."""
    t0 = (lo - o) * inv
    t1 = (hi - o) * inv
    a, b = torch.minimum(t0, t1), torch.maximum(t0, t1)
    tn = torch.maximum(torch.maximum(a[..., 0], a[..., 1]), a[..., 2])
    tf = torch.minimum(torch.minimum(b[..., 0], b[..., 1]), b[..., 2])
    return tn, tf


def extract_ab_reference(tag: str, nodes: torch.Tensor, o: torch.Tensor, d: torch.Tensor,
                         n_iters: int, tile: int = TILE) -> torch.Tensor:
    """Plain version: every tile's steps at once, one pointer per tile and
    pointer, in the kernel's operation order -> (n,) float32."""
    variant, n_ptr = _tag(tag)
    _check(nodes, o, d, tile, n_ptr)
    slots = nodes.reshape(-1, tk.SLOT_F)
    m_pad = slots.shape[0]
    nt = o.shape[0] // tile
    o = o.reshape(nt, tile, 3)
    d = d.reshape(nt, tile, 3)
    inv = 1.0 / torch.where(torch.abs(d) < 1e-8, torch.where(d < 0, -1e-8, 1e-8), d)
    acc = torch.zeros((nt, tile), dtype=torch.float32, device=o.device)
    ptrs = [torch.full((nt,), 7 * k, dtype=torch.int64, device=o.device) for k in range(n_ptr)]

    def wrap(p):
        return torch.where(p >= m_pad, 0, p)

    for _ in range(n_iters):
        if variant == "e0":
            acc = acc + (ptrs[0].to(torch.float32) * 0.1)[:, None]
            ptrs[0] = wrap(ptrs[0] + 1)
            continue
        if variant in ("e1", "e2"):
            f = slots[ptrs[0]]
            v = f[:, 0]
            if variant == "e2":  # Python's sum(): 0 + f0 + f1 + ... in order
                v = torch.zeros_like(v)
                for i in range(9):
                    v = v + f[:, i]
            acc = acc + v[:, None]
            ptrs[0] = wrap(ptrs[0] + 1)
            continue
        for k in range(n_ptr):
            f = slots[ptrs[k]][:, None, :]  # (T, 1, 16): one node per tile
            if variant == "e3":
                t = (f[..., 0:1] - o) * inv  # lo_x on all three axes
                tn = torch.maximum(torch.maximum(t[..., 0], t[..., 1]), t[..., 2])
                hit = tn < T_BEST
            else:
                tn, tf = _slab(f[..., 0:3], f[..., 3:6], o, inv)
                hit = (tn <= tf) & (tf > isect.HIT_EPS) & (tn < T_BEST)
            if variant == "w2":
                p = ptrs[0]
                g = slots[(p // tk.SLOTS) * tk.SLOTS + (p % tk.SLOTS + 1) % tk.SLOTS][:, None, :]
                t2 = (g[..., 0:3] - o) * inv
                tn2 = torch.maximum(torch.maximum(t2[..., 0], t2[..., 1]), t2[..., 2])
                u2 = (g[..., 3:6] - o) * inv
                tf2 = torch.minimum(torch.minimum(u2[..., 0], u2[..., 1]), u2[..., 2])
                hit2 = (tn2 <= tf2) & (tf2 > isect.HIT_EPS) & (tn2 < T_BEST)
                hit = hit | hit2
                acc = acc + torch.where(hit2, tn2, 0.0)
            tile_hit = hit.any(dim=1)
            f = f[:, 0, :]
            if variant == "e3":
                nxt = torch.where(tile_hit, ptrs[k] + 1, ptrs[k] + 2)
            else:
                nxt = torch.where(tile_hit & ~(f[:, 8] > 0.0), ptrs[k] + 1,
                                  f[:, 6].to(torch.int64))
            ptrs[k] = wrap(nxt)
            acc = acc + torch.where(hit, tn, 0.0)
    return acc.reshape(-1)


def extract_ab(tag: str, nodes: torch.Tensor, o: torch.Tensor, d: torch.Tensor, n_iters: int,
               tile: int = TILE) -> torch.Tensor:
    """n_iters steps of the tag's walk per tile of rays o, d (n, 3) over
    binary f32 node rows (R, 128) -> (n,) float32: the plain version on CPU
    tensors, kernel S2 on CUDA ones."""
    if o.device.type == "cpu":
        return extract_ab_reference(tag, nodes, o, d, n_iters, tile)
    variant, n_ptr = _tag(tag)
    _check(nodes, o, d, tile, n_ptr)
    cuda_build.check_inputs(o, d, nodes)
    out = torch.empty(o.shape[0], dtype=torch.float32, device=o.device)
    rc = cuda_build.load().s2_extract_ab(
        VARIANTS.index(variant), n_ptr, nodes.data_ptr(), nodes.shape[0] * tk.SLOTS,
        int(n_iters), o.data_ptr(), d.data_ptr(), out.data_ptr(), o.shape[0], int(tile),
        torch.cuda.current_stream(o.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"s2_extract_ab launch failed: cudaError {rc}")
    LAUNCHES["extract_ab"] += 1
    return out


def cluster_size(tiles: int, tile: int = TILE) -> int:
    """The blocks of the thread-block cluster that walks one tile in a
    launch of tiles tiles on the current card (1: a block per tile)."""
    size = cuda_build.load().s2_cluster_size(int(tiles), int(tile))
    if size < 1:
        raise RuntimeError("s2_cluster_size: the card's SM count could not be read")
    return size


def checksum(out: torch.Tensor) -> float:
    """The reference's checksum, the sum of |out|, taken in f64: a walk that
    runs into the rows' padding slots counts their inverted boxes (the slab
    test is symmetric in lo and hi) at tn near -1e30, and over kitchen's
    lanes the reference's f32 sum overflows to inf."""
    return float(np.abs(out.cpu().numpy()).sum(dtype=np.float64))


def scene_nodes(name: str, device="cpu") -> torch.Tensor:
    """Binary f32 node rows of an in-repo scene: kitchen_stress (full size)
    or cornell."""
    from ..scene import testscenes as tts

    scene = {"kitchen": tts.kitchen_stress, "cornell": tts.cornell_box}[name]()[0]
    return torch.as_tensor(tk.pack_nodes(scene.bvh), device=device)


def main(argv=None, nodes: dict | None = None) -> list:
    """The reference's main() on kitchen_stress's and cornell's rows (or the
    rows given, by scene name): per tag c_node_ns (the card's; ms and
    half_ms, a launch at the steps and at half of them), the checksum and,
    for the one-pointer tags after v0, match_v0; returns the rows."""
    ap = timing.entry_parser(__doc__.split("\n")[0])
    ap.add_argument("--scene", action="append", choices=("kitchen", "cornell"),
                    help="scene rows to walk (default: kitchen and cornell)")
    ap.add_argument("--tiles", type=int, default=1,
                    help=f"tiles of {TILE} lanes (1: the reference's; 128: 1,048,576 lanes)")
    ap.add_argument("--iters", type=int, default=ITERS, help="steps per timed launch")
    args = ap.parse_args(argv)
    dev = timing.device_of(args.device)
    rows = []

    def emit(r):
        rows.append(r)
        print(json.dumps(r), flush=True)

    emit({"event": "device", "device": args.device, "card": timing.card(dev),
          "tiles": args.tiles, "lanes": args.tiles * TILE, "iters": args.iters})
    o, d = nb.reference_rays(args.tiles * TILE, dev)
    cluster = cluster_size(args.tiles) if dev.type == "cuda" else None
    given = nodes or {}
    for name in args.scene or list(given) or ["kitchen", "cornell"]:
        rows_ = given[name] if name in given else scene_nodes(name, dev)
        emit({"event": "tree", "scene": name, "node_rows": int(rows_.shape[0])})
        base_sum = None
        for tag in MAIN_TAGS:
            chk = checksum(extract_ab(tag, rows_, o, d, args.iters))
            t_n = t_h = per = None
            if dev.type == "cuda":
                t_n = timing.events_ms(lambda: extract_ab(tag, rows_, o, d, args.iters), args.reps)
                t_h = timing.events_ms(lambda: extract_ab(tag, rows_, o, d, args.iters // 2),
                                       args.reps)
                per = (t_n - t_h) / (args.iters - args.iters // 2) * 1e6
            row = {"scene": name, "tile": TILE, "variant": tag, "c_node_ns": per,
                   "checksum": chk, "ms": t_n, "half_ms": t_h, "cluster": cluster}
            if TAGS[tag][1] == 1:
                if tag == "v0":
                    base_sum = chk
                elif base_sum is not None:
                    row["match_v0"] = bool(abs(chk - base_sum) < 1e-3 * max(1.0, base_sum))
            emit(row)
    return rows


if __name__ == "__main__":
    main()
